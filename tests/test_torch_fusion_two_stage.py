"""The fusion two-stage detector (`FusionTwoStageVoxelNet`: the camera-fused
stage 1 and the dual-crop refine) in the port against the JAX package, on
the CPU, on the tiny sparse pipeline with the 48 x 96 camera image, from
JAX's weights carried across with `convert.py`: the forward (stage 1, the
proposals exactly, both crops, the refine head), the loss, predict, the
eval step, a train step (fp64 against JAX's fp64 step), the converter's
tree, the builder's precision and the `Trainer` and CLI with
`model_type="fusion_two_stage"`. The JAX side runs jitted."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.models import detector_fusion_two_stage as jf2
from second_tpu.models.second_stage import crop_rois as jax_crop_rois
from second_tpu.testing import TINY_SPARSE_PIPELINE
from second_tpu.train.steps_multistage import \
    make_fusion_two_stage_steps as jax_make_steps
from second_tpu_torch.convert import state_dict_from_jax
from second_tpu_torch.models import (build_fusion_two_stage_voxelnet,
                                     compute_fusion_two_stage_loss,
                                     predict_fusion_two_stage)
from second_tpu_torch.models.second_stage import crop_rois
from second_tpu_torch.ops.voxelize import VoxelizeSpec
from second_tpu_torch.train.state import TrainState
from second_tpu_torch.train.steps_multistage import \
    make_fusion_two_stage_steps

from test_torch_fusion import (CAMERA_KEYS, MAX_VOXELS, TOL, VOX_KEYS, _nhwc,
                               _t, check_step32, check_step64, check_tree,
                               cli_train_and_evaluate, fusion_batch,
                               jax_step64, jax_vox, port_step, port_vox,
                               train_and_evaluate, trainer, variables_of)
from test_torch_temporal import one_thread
from test_torch_train import SGD_PATCH, _config

NUM_PROPOSALS = 16
CROP_TOL = 1e-5
DET_TOL = 1e-5


def models(optimizer=None):
    jcfg, cfg = jax_loads(TINY_SPARSE_PIPELINE), _config(optimizer)
    jcfg.train_config.optimizer = cfg.train_config.optimizer
    jmod, jspec, info, assigner, _ = jf2.build_fusion_two_stage_voxelnet(
        jcfg.model, num_proposals=NUM_PROPOSALS)
    net, spec = build_fusion_two_stage_voxelnet(cfg.model, NUM_PROPOSALS,
                                                device="cpu")[:2]
    return jcfg, cfg, jmod, jspec, net, spec, info, assigner


def _args(jcfg, batch):
    jv = jax_vox(jcfg, batch["points"], batch["points_mask"])
    return [jv[k] for k in VOX_KEYS] + \
        [jnp.asarray(batch[k]) for k in CAMERA_KEYS] + \
        [jnp.asarray(batch["anchors"])]


def _port_args(cfg, batch):
    tv = port_vox(cfg, batch["points"], batch["points_mask"])
    return [tv[k] for k in VOX_KEYS] + [_t(batch[k]) for k in CAMERA_KEYS] + \
        [_t(batch["anchors"])]


@pytest.fixture(scope="module")
@torch.no_grad()
def fwd_run():
    """Both detectors' eval forward from the same random variables on two
    camera scenes, with JAX's predict and loss (jitted)."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = models()
    batch = fusion_batch(jcfg, info, assigner)
    args = _args(jcfg, batch)
    variables = variables_of(jmod, *args)
    jpreds = jax.device_get(jax.jit(lambda v, *a: jmod.apply(v, *a))(
        variables, *args))
    anchors = jnp.asarray(batch["anchors"])
    jdet = jax.device_get(jax.jit(
        lambda p, a: jf2.predict_fusion_two_stage(jspec, p, a))(
            jpreds, anchors))
    jloss = jax.device_get(jax.jit(
        lambda p: jf2.compute_fusion_two_stage_loss(
            jspec, p, jnp.asarray(batch["labels"]),
            jnp.asarray(batch["reg_targets"]), anchors))(jpreds))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tpreds = net(*_port_args(cfg, batch))
    tdet = predict_fusion_two_stage(spec, tpreds, batch["anchors"])
    tloss = compute_fusion_two_stage_loss(
        spec, tpreds, _t(batch["labels"]), _t(batch["reg_targets"]),
        _t(batch["anchors"]))
    return dict(jcfg=jcfg, cfg=cfg, variables=variables, jpreds=jpreds,
                jdet=jdet, jloss=jloss, tpreds=tpreds, tdet=tdet,
                tloss=tloss, net=net, spec=spec, batch=batch)


def test_fusion_two_stage_forward_matches_jax(fwd_run):
    """Stage 1 (its box, cls and direction predictions, the trunk and the
    fused map) within TOL; the proposals' indices and valid exactly JAX's,
    their boxes within TOL; the refined predictions within TOL."""
    r = fwd_run
    jp, tp = r["jpreds"], r["tpreds"]
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(
            tp[k].numpy(), np.asarray(jp[k]).reshape(tp[k].shape), **TOL,
            err_msg=k)
    for k in ("gated_bev_feat", "gated_concat_feat"):
        np.testing.assert_allclose(_nhwc(tp[k]), np.asarray(jp[k]), **TOL,
                                   err_msg=k)
    for k in ("indices", "valid"):
        np.testing.assert_array_equal(tp["proposals"][k].numpy(),
                                      np.asarray(jp["proposals"][k]))
    assert tp["proposals"]["valid"].sum() > 0
    np.testing.assert_allclose(tp["proposals"]["boxes"].numpy(),
                               np.asarray(jp["proposals"]["boxes"]), **TOL)
    for k in ("second_box_preds", "second_cls_preds", "second_dir_preds"):
        assert tp[k].shape == (2, NUM_PROPOSALS, jp[k].shape[-1])
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL,
                                   err_msg=k)


def test_fusion_two_stage_crops_both_maps(fwd_run):
    """The refine head's two crops: `crop_rois` of JAX's trunk (into the
    regression tower, 32 channels) and of JAX's fused map (into the
    classification tower, 128 channels) at JAX's proposal boxes, each
    within CROP_TOL of JAX's crops; the port's head on them gives JAX's
    refined predictions within TOL."""
    r = fwd_run
    jp, net = r["jpreds"], r["net"]
    roi = net.roi
    boxes = np.asarray(jp["proposals"]["boxes"])
    B, N = boxes.shape[:2]
    crops = {}
    for key in ("gated_bev_feat", "gated_concat_feat"):
        fmap = np.asarray(jp[key])
        want = np.asarray(jax.jit(lambda t, b: jax_crop_rois(
            t, b, roi.pc_range, roi.voxel_size, roi.out_stride,
            roi.crop_size, roi.samples))(jnp.asarray(fmap),
                                         jnp.asarray(boxes)))
        got = crop_rois(_t(fmap.transpose(0, 3, 1, 2)), _t(boxes),
                        roi.pc_range, roi.voxel_size, roi.out_stride,
                        roi.crop_size, roi.samples)
        np.testing.assert_allclose(
            _nhwc(got), want.reshape(B * N, *want.shape[2:]), rtol=0,
            atol=CROP_TOL, err_msg=key)
        crops[key] = got
    assert crops["gated_bev_feat"].shape[1] == 32
    assert crops["gated_concat_feat"].shape[1] == 128
    with torch.no_grad():
        out = net.second_rpn(crops["gated_bev_feat"],
                             crops["gated_concat_feat"])
    np.testing.assert_allclose(
        out["cls_preds"].reshape(B, N, -1).numpy(),
        np.asarray(jp["second_cls_preds"]), **TOL)
    enc = out["box_preds"].reshape(B, N, -1).numpy() + \
        np.asarray(jp["proposals"]["box_enc"])
    np.testing.assert_allclose(enc, np.asarray(jp["second_box_preds"]),
                               **TOL)


def test_fusion_two_stage_loss_matches_jax(fwd_run):
    """(stage 1 + stage 2) / 2 on each side's predictions: the loss and its
    parts within TOL of JAX's, the positives of both stages equal."""
    r = fwd_run
    jl, tl = r["jloss"], r["tloss"]
    assert int(tl["num_pos"]) == int(jl["num_pos"]) > 0
    assert int(tl["second_num_pos"]) == int(jl["second_num_pos"])
    for k in ("loss", "cls_loss_reduced", "loc_loss_reduced",
              "second_cls_loss_reduced", "second_loc_loss_reduced"):
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), **TOL,
                                   err_msg=k)


def test_predict_fusion_two_stage_matches_jax(fwd_run):
    """`predict_fusion_two_stage` on JAX's predictions: valid and labels
    exactly JAX's, boxes within DET_TOL, scores within 1e-6; the port's own
    forward keeps JAX's set."""
    r = fwd_run
    jp, jdet = r["jpreds"], r["jdet"]
    preds = {k: _t(v) for k, v in jp.items() if k.startswith("second_")}
    preds["proposals"] = {k: _t(v) for k, v in jp["proposals"].items()}
    with torch.no_grad():
        det = predict_fusion_two_stage(r["spec"], preds,
                                       r["batch"]["anchors"])
    valid = np.asarray(jdet["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    np.testing.assert_array_equal(det["labels"].numpy(),
                                  np.asarray(jdet["labels"]))
    np.testing.assert_allclose(det["boxes"].numpy()[valid],
                               np.asarray(jdet["boxes"])[valid], rtol=0,
                               atol=DET_TOL)
    np.testing.assert_allclose(det["scores"].numpy(),
                               np.asarray(jdet["scores"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(r["tdet"]["valid"].numpy(), valid)


def test_fusion_two_stage_eval_step_matches_jax(fwd_run):
    """`make_fusion_two_stage_steps`' eval step: valid exactly JAX's
    predict's, boxes within TOL."""
    r = fwd_run
    vspec = VoxelizeSpec.from_config(r["cfg"].model.voxel_generator,
                                     MAX_VOXELS)
    _, eval_step = make_fusion_two_stage_steps(r["spec"], vspec)
    det = eval_step(TrainState(r["net"], None),
                    {k: _t(v) for k, v in r["batch"].items()})
    valid = np.asarray(r["jdet"]["valid"])
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    np.testing.assert_allclose(det["boxes"].numpy()[valid],
                               np.asarray(r["jdet"]["boxes"])[valid], **TOL)


def test_convert_fusion_two_stage_tree(fwd_run):
    """JAX's tree (`stage1/{vfe,middle,rpn}` with the camera RPN, and
    `second_rpn` with a 128-channel classification tower) maps onto the
    port's names whole: every leaf, nothing left over, shapes equal."""
    r = fwd_run
    fresh = build_fusion_two_stage_voxelnet(r["cfg"].model, NUM_PROPOSALS,
                                            device="cpu", seed=3)[0]
    sd = check_tree(r["net"], r["variables"], fresh)
    assert sd["second_rpn.cls_tower.convs.0.weight"].shape[1] == 128
    assert sd["second_rpn.reg_tower.convs.0.weight"].shape[1] == 32


def test_fusion_two_stage_steps_match_jax():
    """One train step on two camera scenes, the proposals' NMS allowed the
    positive anchors and a tenth of the others (some positive among the
    proposals): the port's fp64 step against JAX's fp64 step (metrics,
    every gradient, the batch statistics; the refine head's, the FPN's and
    the gates' gradients nonzero), and its fp32 step's loss against JAX's
    and gradients against one fp32 backward."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = models(SGD_PATCH)
    batch = fusion_batch(jcfg, info, assigner, seed=1)
    rng = np.random.default_rng(2)
    batch["anchors_mask"] = (batch["labels"] > 0) | \
        (rng.uniform(size=batch["labels"].shape) < 0.1)
    variables = variables_of(jmod, *_args(jcfg, batch))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with one_thread():
        ref = copy.deepcopy(net).train()
        b = {k: _t(v) for k, v in batch.items()}
        preds = ref(*_port_args(cfg, batch),
                    anchors_mask=b["anchors_mask"])
        compute_fusion_two_stage_loss(
            spec, preds, b["labels"], b["reg_targets"],
            b["anchors"])["loss"].backward()
        port = {str(d)[6:]: port_step(make_fusion_two_stage_steps, net,
                                      spec, cfg, batch, d)
                for d in (torch.float64, torch.float32)}
    jrun = jax_step64(jax_make_steps, jmod, jspec, jcfg, variables, batch)
    extra = ("second_dir_loss", "voxel_overflow", "stage_overflow")
    grads = check_step64(jrun, port["float64"], extra)
    assert int(port["float64"][0]["second_num_pos"]) > 0
    for name in ("second_rpn.cls_tower.convs.0.weight",
                 "second_rpn.conv_box_second.weight",
                 "stage1.rpn.fpn18.stem.weight",
                 "stage1.rpn.crop_gate.conv.weight",
                 "stage1.middle.subm.0.weight"):
        assert grads[name].abs().max() > 0, name
    check_step32(jrun, port["float32"],
                 {n: p.grad for n, p in ref.named_parameters()})


def test_fusion_two_stage_builder_is_fp32_as_jax():
    """On a config that asks for mixed precision JAX's builder drops the
    RPN's `dtype`, and the port's model is fp32 throughout."""
    jcfg = jax_loads(TINY_SPARSE_PIPELINE)
    jcfg.train_config.enable_mixed_precision = True
    jmod = jf2.build_fusion_two_stage_voxelnet(jcfg.model)[0]
    assert "dtype" not in dict(jmod.rpn_kwargs)
    net = build_fusion_two_stage_voxelnet(jcfg.model, device="cpu")[0]
    assert net.stage1.rpn.trunk.dtype is None
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_trainer_fusion_two_stage_trains_and_evaluates(tmp_path):
    """`Trainer(model_type="fusion_two_stage", device="cpu")` on synthetic
    scans with camera images (`few_proposals`): two steps with finite
    stage-1 and stage-2 losses, then `evaluate` on 2 frames."""
    tr = trainer(tmp_path, "fusion_two_stage")
    train_and_evaluate(tr, tmp_path, loss_key="train.second_cls_loss")


def test_cli_fusion_two_stage_trains_and_evaluates(tmp_path):
    """The CLI with `--model_type fusion_two_stage --image_hw 48 96`."""
    cli_train_and_evaluate(tmp_path, "fusion_two_stage")
