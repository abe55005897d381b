"""The temporal-fusion detector (`TemporalFusionVoxelNet`: the complete
reference spatio model, two LiDAR frames through one backbone call, the
gated BEV fusion, the z-slice camera RPN and the dual-crop refine) in the
port against the JAX package, on the CPU, on the tiny sparse pipeline with
the 48 x 96 camera image and 4 z-slices, from JAX's weights carried across
with `convert.py`: `ZSliceFusionRPN`, the forward (the proposals exactly,
the 128-channel BEV crops and the 256-channel z-slice crops), the loss,
predict, the eval step, a train step (fp64 against JAX's fp64 step; no
gradient reaches the FPN, whose weights still decay), the converter's tree
and the `Trainer` and CLI with `model_type="temporal_fusion"`, on
synthetic pairs and on a fake KITTI-tracking tree with camera frames. The
JAX side runs jitted."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.models import fusion as jfusion
from second_tpu.models import temporal as jtemporal
from second_tpu.models.second_stage import crop_rois as jax_crop_rois
from second_tpu.testing import TINY_SPARSE_PIPELINE
from second_tpu.train.steps_multistage import \
    make_temporal_fusion_steps as jax_make_steps
from second_tpu_torch.convert import state_dict_from_jax
from second_tpu_torch.data.fake_tracking import write_tracking_tree
from second_tpu_torch.models import (build_temporal_fusion_voxelnet,
                                     compute_temporal_loss, fusion,
                                     predict_temporal)
from second_tpu_torch.models.second_stage import crop_rois
from second_tpu_torch.ops.voxelize import VoxelizeSpec
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.state import TrainState
from second_tpu_torch.train.steps_multistage import \
    make_temporal_fusion_steps

from test_torch_fusion import (MAX_VOXELS, TOL, VOX_KEYS, _nchw, _nhwc, _t,
                               check_step32, check_step64, check_tree,
                               cli_train_and_evaluate, fusion_batch,
                               jax_step64, jax_vox, port_step, port_vox,
                               train_and_evaluate, trainer, variables_of)
from test_torch_temporal import one_thread
from test_torch_train import SGD_PATCH, _config

NUM_PROPOSALS = 16
ZSLICE_KEYS = ("image", "idxs_norm", "idxs_valid")
CROP_TOL = 1e-5
DET_TOL = 1e-5


def models(optimizer=None):
    jcfg, cfg = jax_loads(TINY_SPARSE_PIPELINE), _config(optimizer)
    jcfg.train_config.optimizer = cfg.train_config.optimizer
    jmod, jspec, info, assigner, _ = \
        jtemporal.build_temporal_fusion_voxelnet(
            jcfg.model, num_proposals=NUM_PROPOSALS)
    net, spec = build_temporal_fusion_voxelnet(cfg.model, NUM_PROPOSALS,
                                               device="cpu")[:2]
    return jcfg, cfg, jmod, jspec, net, spec, info, assigner


def _args(jcfg, batch):
    frames = [jax_vox(jcfg, batch[p], batch[f"{p}_mask"])
              for p in ("points", "p_points")]
    return frames + [jnp.asarray(batch[k]) for k in ZSLICE_KEYS] + \
        [jnp.asarray(batch["anchors"])]


def _port_args(cfg, batch):
    frames = [port_vox(cfg, batch[p], batch[f"{p}_mask"])
              for p in ("points", "p_points")]
    return frames + [_t(batch[k]) for k in ZSLICE_KEYS] + \
        [_t(batch["anchors"])]


def test_zslice_fusion_rpn_matches_flax():
    """`ZSliceFusionRPN` alone (the builder's RPN: the tiny pipeline's
    widths, 4 z-slices compressed from 1024 to 256 channels) on the same
    BEV map and camera inputs: every output within TOL of flax's, every
    head on the trunk; `jax.grad` gives the FPN no gradient, and no
    gradient reaches the port's FPN."""
    cfg = jax_loads(TINY_SPARSE_PIPELINE)
    jmod, _, info, assigner, _ = jtemporal.build_temporal_fusion_voxelnet(
        cfg.model)
    kw = dict(jmod.rpn_kwargs)
    jrpn = jfusion.ZSliceFusionRPN(**kw)
    batch = fusion_batch(cfg, info, assigner, seed=9, pairs=True)
    assert batch["idxs_norm"].shape == (2, 4, 8, 8, 2)
    assert batch["idxs_valid"].any()
    rng = np.random.default_rng(10)
    bev = rng.normal(size=(2, 8, 8, 128)).astype(np.float32)
    args = [jnp.asarray(bev)] + [jnp.asarray(batch[k]) for k in ZSLICE_KEYS]
    variables = variables_of(jrpn, *args)
    want = jax.device_get(jax.jit(lambda v, *a: jrpn.apply(v, *a))(
        variables, *args))
    jgrad = jax.jit(jax.grad(lambda p, *a: jrpn.apply(
        {"params": p, "batch_stats": variables["batch_stats"]},
        *a)["gated_concat_feat"].sum()))(variables["params"], *args)
    assert all(not np.asarray(g).any()
               for g in jax.tree.leaves(jgrad["fpn18"]))
    rpn = fusion.ZSliceFusionRPN(128, **kw)
    sd = state_dict_from_jax({"params": {"rpn": variables["params"]},
                              "batch_stats": {"rpn": variables["batch_stats"]}
                              })
    rpn.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)
    got = rpn.eval()(_nchw(bev), *[_t(batch[k]) for k in ZSLICE_KEYS])
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]).reshape(got[k].shape),
                                   **TOL, err_msg=k)
    for k in ("trunk", "gated_concat_feat"):
        np.testing.assert_allclose(_nhwc(got[k].detach()),
                                   np.asarray(want[k]), **TOL, err_msg=k)
    assert got["gated_concat_feat"].shape[1] == 256
    got["gated_concat_feat"].sum().backward()
    assert all(p.grad is None for p in rpn.fpn18.parameters())
    assert rpn.concat_compress.weight.grad.abs().max() > 0


@pytest.fixture(scope="module")
@torch.no_grad()
def fwd_run():
    """Both detectors' eval forward from the same random variables on two
    camera pairs, with JAX's predict and loss (jitted)."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = models()
    batch = fusion_batch(jcfg, info, assigner, pairs=True)
    args = _args(jcfg, batch)
    variables = variables_of(jmod, *args)
    jpreds = jax.device_get(jax.jit(lambda v, *a: jmod.apply(v, *a))(
        variables, *args))
    anchors = jnp.asarray(batch["anchors"])
    jdet = jax.device_get(jax.jit(
        lambda p, a: jtemporal.predict_temporal(jspec, p, a))(
            jpreds, anchors))
    jloss = jax.device_get(jax.jit(
        lambda p: jtemporal.compute_temporal_loss(
            jspec, p, jnp.asarray(batch["labels"]),
            jnp.asarray(batch["reg_targets"]), anchors))(jpreds))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tpreds = net(*_port_args(cfg, batch))
    tdet = predict_temporal(spec, tpreds, batch["anchors"])
    tloss = compute_temporal_loss(spec, tpreds, _t(batch["labels"]),
                                  _t(batch["reg_targets"]),
                                  _t(batch["anchors"]))
    return dict(jcfg=jcfg, cfg=cfg, variables=variables, jpreds=jpreds,
                jdet=jdet, jloss=jloss, tpreds=tpreds, tdet=tdet,
                tloss=tloss, net=net, spec=spec, batch=batch)


def test_temporal_fusion_forward_matches_jax(fwd_run):
    """Stage 1 (predictions from the trunk of the RPN over the gated
    pair, the trunk, the z-slice map) within TOL; the proposals' indices
    and valid exactly JAX's; the refined predictions within TOL."""
    jp, tp = fwd_run["jpreds"], fwd_run["tpreds"]
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
    for k in ("second_box_preds", "second_cls_preds", "second_dir_preds"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL,
                                   err_msg=k)


def test_temporal_fusion_crops_both_maps(fwd_run):
    """The refine head's crops: of JAX's RPN trunk (32 channels, the
    regression tower) and of its z-slice map (256 channels, the
    classification tower: the first 256-channel crop of the port's
    detectors) at JAX's proposal boxes, within CROP_TOL of JAX's crops; the
    port's head on them gives JAX's refined predictions within TOL."""
    jp, net = fwd_run["jpreds"], fwd_run["net"]
    roi = net.roi
    boxes = np.asarray(jp["proposals"]["boxes"])
    B, N = boxes.shape[:2]
    crops = {}
    for key, channels in (("gated_bev_feat", 32), ("gated_concat_feat", 256)):
        fmap = np.asarray(jp[key])
        want = np.asarray(jax.jit(lambda t, b: jax_crop_rois(
            t, b, roi.pc_range, roi.voxel_size, roi.out_stride,
            roi.crop_size, roi.samples))(jnp.asarray(fmap),
                                         jnp.asarray(boxes)))
        got = crop_rois(_nchw(fmap), _t(boxes), roi.pc_range,
                        roi.voxel_size, roi.out_stride, roi.crop_size,
                        roi.samples)
        assert got.shape[1] == channels
        np.testing.assert_allclose(
            _nhwc(got), want.reshape(B * N, *want.shape[2:]), rtol=0,
            atol=CROP_TOL, err_msg=key)
        crops[key] = got
    with torch.no_grad():
        out = net.second_rpn(crops["gated_bev_feat"],
                             crops["gated_concat_feat"])
    np.testing.assert_allclose(
        out["cls_preds"].reshape(B, N, -1).numpy(),
        np.asarray(jp["second_cls_preds"]), **TOL)


def test_temporal_fusion_loss_matches_jax(fwd_run):
    """(stage 1 + stage 2) / 2 on each side's predictions: within TOL, the
    positives equal."""
    jl, tl = fwd_run["jloss"], fwd_run["tloss"]
    assert int(tl["num_pos"]) == int(jl["num_pos"]) > 0
    assert int(tl["second_num_pos"]) == int(jl["second_num_pos"])
    for k in ("loss", "cls_loss_reduced", "loc_loss_reduced",
              "second_cls_loss_reduced", "second_loc_loss_reduced",
              "second_dir_loss_reduced"):
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), **TOL,
                                   err_msg=k)


def test_predict_temporal_fusion_matches_jax(fwd_run):
    """`predict_temporal` on JAX's predictions: valid and labels exactly
    JAX's, boxes within DET_TOL, scores within 1e-6; the port's own
    forward keeps JAX's set; the eval step too."""
    jp, jdet = fwd_run["jpreds"], fwd_run["jdet"]
    preds = {k: _t(v) for k, v in jp.items() if k.startswith("second_")}
    preds["proposals"] = {k: _t(v) for k, v in jp["proposals"].items()}
    with torch.no_grad():
        det = predict_temporal(fwd_run["spec"], preds,
                               fwd_run["batch"]["anchors"])
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
    np.testing.assert_array_equal(fwd_run["tdet"]["valid"].numpy(), valid)
    vspec = VoxelizeSpec.from_config(fwd_run["cfg"].model.voxel_generator,
                                     MAX_VOXELS)
    _, eval_step = make_temporal_fusion_steps(fwd_run["spec"], vspec)
    edet = eval_step(TrainState(fwd_run["net"], None),
                     {k: _t(v) for k, v in fwd_run["batch"].items()})
    np.testing.assert_array_equal(edet["valid"].numpy(), valid)


def test_convert_temporal_fusion_tree(fwd_run):
    """JAX's tree (`vfe`, `middle`, `bev_fusion`, `rpn` with `fpn18` and
    `concat_compress`, `second_rpn` with a 256-channel classification
    tower) maps onto the port's names whole."""
    fresh = build_temporal_fusion_voxelnet(fwd_run["cfg"].model,
                                           NUM_PROPOSALS, device="cpu",
                                           seed=3)[0]
    sd = check_tree(fwd_run["net"], fwd_run["variables"], fresh)
    assert sd["rpn.concat_compress.weight"].shape == (256, 1024, 1, 1)
    assert sd["second_rpn.cls_tower.convs.0.weight"].shape[1] == 256
    assert sd["bev_fusion.conv_gating_bev.weight"].shape[1] == 256


def test_temporal_fusion_steps_match_jax():
    """One train step on two camera pairs, the proposals' NMS allowed the
    positive anchors and a tenth of the others: the port's fp64 step
    against JAX's fp64 step (metrics, every gradient, the batch statistics
    of the backbone that pools both frames and of the FPN, which still
    runs in train mode; the FPN's gradients zero on both sides, the gate's
    and the compress conv's nonzero), and its fp32 step's loss against
    JAX's and gradients against one fp32 backward."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = models(SGD_PATCH)
    batch = fusion_batch(jcfg, info, assigner, seed=1, pairs=True)
    rng = np.random.default_rng(2)
    batch["anchors_mask"] = (batch["labels"] > 0) | \
        (rng.uniform(size=batch["labels"].shape) < 0.1)
    variables = variables_of(jmod, *_args(jcfg, batch))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with one_thread():
        ref = copy.deepcopy(net).train()
        b = {k: _t(v) for k, v in batch.items()}
        preds = ref(*_port_args(cfg, batch), anchors_mask=b["anchors_mask"])
        compute_temporal_loss(spec, preds, b["labels"], b["reg_targets"],
                              b["anchors"])["loss"].backward()
        port = {str(d)[6:]: port_step(make_temporal_fusion_steps, net, spec,
                                      cfg, batch, d)
                for d in (torch.float64, torch.float32)}
    jrun = jax_step64(jax_make_steps, jmod, jspec, jcfg, variables, batch)
    grads = check_step64(jrun, port["float64"],
                         ("voxel_overflow", "stage_overflow"))
    assert int(port["float64"][0]["second_num_pos"]) > 0
    fpn = [n for n in grads if n.startswith("rpn.fpn18.")]
    assert fpn and all(not grads[n].any() for n in fpn)
    for name in ("bev_fusion.conv_gating_bev.weight",
                 "rpn.concat_compress.weight",
                 "second_rpn.cls_tower.convs.0.weight",
                 "middle.subm.0.weight"):
        assert grads[name].abs().max() > 0, name
    backward = {n: torch.zeros_like(p) if p.grad is None else p.grad
                for n, p in ref.named_parameters()}
    check_step32(jrun, port["float32"], backward)


def test_temporal_fusion_fpn_weights_decay(fwd_run):
    """Under the tiny config's AdamW (decoupled weight decay 0.01) one
    train step moves every FPN weight by the decay alone, w (1 - lr wd)
    (the optimizer fills the missing gradient with zeros, as optax
    updates every leaf), and updates the FPN's running statistics."""
    cfg, spec = fwd_run["cfg"], fwd_run["spec"]
    net = copy.deepcopy(fwd_run["net"])
    before = {k: v.clone() for k, v in net.state_dict().items()}
    ocfg = cfg.train_config.optimizer
    opt, lr_sched = build_optimizer(ocfg, cfg.train_config.steps,
                                    net.parameters())
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    step = make_temporal_fusion_steps(spec, vspec)[0]
    with one_thread():
        step(TrainState(net, opt, 0, lr_sched),
             {k: _t(v) for k, v in fwd_run["batch"].items()})
    after = net.state_dict()
    decay = 1 - lr_sched(0) * ocfg.weight_decay
    for name, p in net.rpn.fpn18.named_parameters():
        w = before[f"rpn.fpn18.{name}"]
        torch.testing.assert_close(p.detach(), w * decay, rtol=1e-6,
                                   atol=1e-9)
        assert not torch.equal(p.detach(), w), name
    stats = [k for k in after if k.startswith("rpn.fpn18.")
             and k.endswith("running_mean")]
    assert stats and all(not torch.equal(after[k], before[k])
                         for k in stats)


def test_trainer_temporal_fusion_on_synthetic_pairs(tmp_path):
    """`Trainer(model_type="temporal_fusion", device="cpu")` on synthetic
    pairs with the current frame's camera image (`few_proposals`): the
    examples carry the previous frame and the z-slice grids; two steps
    with finite losses, then `evaluate` on 2 pairs."""
    tr = trainer(tmp_path, "temporal_fusion")
    assert tr.use_zslice
    ex = tr.prep(tr.train_ds[0], np.random.default_rng(0))
    assert ex["idxs_norm"].shape[0] == 4 and ex["idxs_valid"].any()
    assert "p_points" in ex and ex["image"].shape == (48, 96, 3)
    train_and_evaluate(tr, tmp_path, loss_key="train.second_cls_loss")


def test_trainer_temporal_fusion_on_tracking_tree(tmp_path):
    """The same on a KITTI-tracking tree with camera frames
    (`data/fake_tracking.py` with `image_shape`: 375 x 1242 PNGs, which the
    reader loads with PIL) on the KITTI canvas: the readers' root is the
    split directory; evaluate reports the /3d keys."""
    root = write_tracking_tree(tmp_path / "training",
                               np.random.default_rng(0),
                               image_shape=(375, 1242))
    tr = trainer(tmp_path, "temporal_fusion",
                 [f"train_input_reader.kitti_root_path='{root}'",
                  f"eval_input_reader.kitti_root_path='{root}'"],
                 synthetic=False, image_hw=None)
    assert tr.image_shape == (384, 1248)
    ex = tr.train_ds[1]
    assert ex["image"].shape == (375, 1242, 3) and ex["image"].max() > 0
    detail = train_and_evaluate(tr, tmp_path,
                                loss_key="train.second_cls_loss")
    assert any("/3d" in k for k in detail)


def test_cli_temporal_fusion_trains_and_evaluates(tmp_path):
    """The CLI with `--model_type temporal_fusion --image_hw 48 96`."""
    cli_train_and_evaluate(tmp_path, "temporal_fusion")
