"""The two-stage detector in the port against the JAX package, on the CPU
(the kernels' plain versions), from JAX's weights carried across with
`convert.py`: the forward of two stage-1s (the tiny PointPillars pipeline
with the direction classifier, and the tiny SECOND fhd pipeline),
proposals, crops, refine head and `predict_two_stage`; the loss and
gradients against JAX's fp64 step (with the Part-A² soft targets and the
stage-2 direction loss), the port's in fp64 and in fp32; the train and
eval steps against JAX's; the converter's two-stage tree; and
`Trainer(model_type="two_stage")`."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.data import ExamplePrep as JExamplePrep
from second_tpu.data import PrepConfig as JPrepConfig
from second_tpu.models.detector_two_stage import \
    build_two_stage_voxelnet as jax_build_two_stage
from second_tpu.models.detector_two_stage import \
    compute_two_stage_loss as jax_two_stage_loss
from second_tpu.models.detector_two_stage import \
    predict_two_stage as jax_predict_two_stage
from second_tpu.models.second_stage import SecondStageHead as JHead
from second_tpu.models.second_stage import crop_rois as jax_crop_rois
from second_tpu.models.second_stage import \
    select_proposals as jax_select_proposals
from second_tpu.testing import TINY_PIPELINE, TINY_SPARSE_PIPELINE
from second_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from second_tpu.train.state import TrainState as JTrainState
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu.train.steps_multistage import \
    make_two_stage_steps as jax_make_two_stage_steps
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.models import (build_two_stage_voxelnet,
                                     compute_two_stage_loss,
                                     predict_two_stage)
from second_tpu_torch.models import second_stage
from second_tpu_torch.models.second_stage import crop_rois, select_proposals
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.run import Trainer
from second_tpu_torch.train.state import TrainState
from second_tpu_torch.train.steps_multistage import make_two_stage_steps

from test_torch_model import _random_variables
from test_torch_multiclass import GRAD64_TOL, ReluTap, _rel_err
from test_torch_train import (GRAD_TOL, LOSS_RTOL, SGD_PATCH, _config,
                              _tiny_batch)

PIPELINES = {"pointpillars": TINY_PIPELINE, "sparse": TINY_SPARSE_PIPELINE}
NUM_PROPOSALS = 16
MAX_VOXELS = 2048
# fp32, port against JAX: stage 1 and the refine head (fp32 sums in another
# order), the crops of the same trunk and boxes (the sample coordinates'
# sin and cos an ulp apart), the decoded detections
TOL = dict(rtol=1e-4, atol=1e-4)
CROP_TOL = 1e-5
DET_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(pipeline, partaa=False, optimizer=None):
    """(JAX config, port config, JAX module and spec, port module and
    spec, info, assigner), the two-stage detector at NUM_PROPOSALS."""
    jcfg, cfg = jax_loads(pipeline), _config(optimizer, pipeline)
    for c in (jcfg, cfg):
        c.model.target_assigner.use_iou_param_partaa = partaa
    jcfg.train_config.optimizer = cfg.train_config.optimizer
    jmod, jspec, info, assigner, _ = jax_build_two_stage(
        jcfg.model, num_proposals=NUM_PROPOSALS)
    net, spec = build_two_stage_voxelnet(cfg.model, NUM_PROPOSALS,
                                         device="cpu")[:2]
    return jcfg, cfg, jmod, jspec, net, spec, info, assigner


def _batch(info, assigner, seed=0):
    prep = JExamplePrep(assigner, info.feature_map_size,
                        JPrepConfig(max_points=3000, training=True))
    return {k: v for k, v in _tiny_batch(prep, seed=seed).items()
            if k != "image_idx"}


def _jax_args(jcfg, batch):
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS)
    vox = jax_device_voxelize(vspec, jnp.asarray(batch["points"]),
                              jnp.asarray(batch["points_mask"]))
    return vspec, (vox["voxels"], vox["num_points"], vox["coordinates"],
                   vox["voxel_valid"], jnp.asarray(batch["anchors"]))


def _port_preds(net, cfg, batch, train=False, dtype=torch.float32):
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    b = {k: _t(v) for k, v in batch.items()}
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
    vox = device_voxelize(vspec, b["points"], b["points_mask"], "cpu")
    net.train(train)
    return net(vox["voxels"], vox["num_points"], vox["coordinates"],
               vox["voxel_valid"], b["anchors"],
               anchors_mask=b.get("anchors_mask")), b


def _calibrated(jmod, variables, args):
    """The variables with every norm's running statistics set to the batch
    statistics of a train-mode forward on `args` (as
    `test_torch_pointpillars._calibrated`, jitted): JAX's pillar encoder
    feeds its norm offsets of some 1e4-1e5, so under `_random_variables`'
    statistics the eval predictions overflow."""
    zero = jax.tree.map(np.zeros_like, variables["batch_stats"])
    _, mut = jax.jit(lambda v, *a: jmod.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
        {"params": variables["params"], "batch_stats": zero}, *args)
    return {"params": variables["params"],
            "batch_stats": jax.tree.map(lambda s: np.asarray(s) * 100.0,
                                        mut["batch_stats"])}


@pytest.fixture(scope="module", params=sorted(PIPELINES))
def fwd_run(request):
    """The eval forward of both detectors from the same `_random_variables`
    (PointPillars' norm statistics calibrated on the batch), and JAX's
    predict."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = _models(
        PIPELINES[request.param])
    batch = _batch(info, assigner)
    _, args = _jax_args(jcfg, batch)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = _random_variables(shapes, np.random.default_rng(1))
    if request.param == "pointpillars":
        variables = _calibrated(jmod, variables, args)
    jpreds = jax.jit(lambda v, *a: jmod.apply(v, *a))(variables, *args)
    jdet = jax.device_get(jax.jit(lambda p, a: jax_predict_two_stage(
        jspec, p, a))(jpreds, args[-1]))
    jpreds = jax.device_get(jpreds)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        tpreds, _ = _port_preds(net, cfg, batch)
        tdet = predict_two_stage(spec, tpreds, batch["anchors"])
    return dict(name=request.param, variables=variables, jpreds=jpreds,
                jdet=jdet, tpreds=tpreds, tdet=tdet, net=net, spec=spec,
                jspec=jspec, batch=batch, cfg=cfg)


def test_two_stage_forward_matches_jax(fwd_run):
    """Stage 1 within TOL; the proposals' indices and valid exactly JAX's,
    their boxes (decoded from stage 1) within TOL; the second-stage predictions (the residual
    encodings, the logits and, with the direction classifier, the
    direction logits) within TOL."""
    jp, tp = fwd_run["jpreds"], fwd_run["tpreds"]
    for k in ("box_preds", "cls_preds"):
        np.testing.assert_allclose(
            tp[k].numpy(), np.asarray(jp[k]).reshape(tp[k].shape), **TOL,
            err_msg=k)
    np.testing.assert_allclose(tp["trunk"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jp["trunk"]), **TOL)
    for k in ("indices", "valid"):
        np.testing.assert_array_equal(tp["proposals"][k].numpy(),
                                      np.asarray(jp["proposals"][k]))
    assert tp["proposals"]["valid"].sum() > 0
    np.testing.assert_allclose(tp["proposals"]["boxes"].numpy(),
                               np.asarray(jp["proposals"]["boxes"]), **TOL)
    keys = ["second_box_preds", "second_cls_preds"]
    if fwd_run["spec"].use_direction_classifier:
        keys.append("second_dir_preds")
    assert set(keys) <= set(tp)
    for k in keys:
        assert tp[k].shape == (2, NUM_PROPOSALS, jp[k].shape[-1])
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL,
                                   err_msg=k)


def test_proposals_crops_and_head_on_jax_inputs(fwd_run):
    """Each piece on JAX's own inputs: `select_proposals` on JAX's stage-1
    outputs gives JAX's indices and valid exactly and its boxes,
    encodings and logits within 1e-6 (relative and absolute: XLA fuses the
    decode); `crop_rois` of JAX's trunk at JAX's
    proposal boxes within CROP_TOL of JAX's crops; the refine head on
    JAX's crops within TOL of JAX's head."""
    jp, net, spec = fwd_run["jpreds"], fwd_run["net"], fwd_run["spec"]
    anchors = fwd_run["batch"]["anchors"]
    stage1 = {k: _t(jp[k]) for k in ("box_preds", "cls_preds")}
    got = select_proposals(net.pspec, spec, stage1, _t(anchors))
    want = jax.device_get(jax.jit(lambda p, a: jax_select_proposals(
        net.pspec, fwd_run["jspec"], p, a))(
            {k: jnp.asarray(v) for k, v in stage1.items()},
            jnp.asarray(anchors)))
    for k in ("indices", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("boxes", "box_enc", "cls_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    roi = net.roi
    trunk, boxes = np.asarray(jp["trunk"]), np.asarray(want["boxes"])
    jcrops = np.asarray(jax.jit(lambda t, b: jax_crop_rois(
        t, b, roi.pc_range, roi.voxel_size, roi.out_stride, roi.crop_size,
        roi.samples))(jnp.asarray(trunk), jnp.asarray(boxes)))
    B, N = boxes.shape[:2]
    jcrops = jcrops.reshape(B * N, *jcrops.shape[2:])
    crops = crop_rois(_t(trunk.transpose(0, 3, 1, 2)), _t(boxes),
                      roi.pc_range, roi.voxel_size, roi.out_stride,
                      roi.crop_size, roi.samples)
    np.testing.assert_allclose(crops.permute(0, 2, 3, 1).numpy(), jcrops,
                               rtol=0, atol=CROP_TOL)
    assert (np.abs(jcrops) > 0).mean() > 0.3
    head = JHead(spec.num_class, spec.box_code_size, crop_size=roi.crop_size,
                 use_direction_classifier=spec.use_direction_classifier)
    jout = jax.jit(head.apply)(
        {"params": fwd_run["variables"]["params"]["second_rpn"]},
        jnp.asarray(jcrops))
    with torch.no_grad():
        tout = net.second_rpn(_t(jcrops.transpose(0, 3, 1, 2)))
    assert set(tout) == set(jout)
    for k in tout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   **TOL, err_msg=k)


def test_predict_two_stage_matches_jax(fwd_run):
    """`predict_two_stage` (decode, the stage-2 direction flip, the score
    threshold, rotated NMS over the refined proposals, the center limit)
    on JAX's predictions: valid and labels exactly JAX's, boxes within
    DET_TOL, scores within 1e-6; and on the port's own forward the same
    keep set as JAX's."""
    jp, jdet = fwd_run["jpreds"], fwd_run["jdet"]
    preds = {k: _t(v) for k, v in jp.items()
             if k.startswith("second_")}
    preds["proposals"] = {k: _t(v) for k, v in jp["proposals"].items()}
    with torch.no_grad():
        det = predict_two_stage(fwd_run["spec"], preds,
                                fwd_run["batch"]["anchors"])
    valid = np.asarray(jdet["valid"])
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    np.testing.assert_array_equal(det["labels"].numpy(),
                                  np.asarray(jdet["labels"]))
    np.testing.assert_allclose(det["boxes"].numpy()[valid],
                               np.asarray(jdet["boxes"])[valid], rtol=0,
                               atol=DET_TOL)
    np.testing.assert_allclose(det["scores"].numpy(),
                               np.asarray(jdet["scores"]), rtol=0, atol=1e-6)
    assert valid.sum() > 0
    np.testing.assert_array_equal(fwd_run["tdet"]["valid"].numpy(), valid)


# ----------------------------------------------------- loss and gradients


def _jax_grads64(jmod, jspec, jcfg, variables, batch):
    """JAX's loss parts, proposal indices and parameter gradients of a
    train-mode forward in fp64 (x64 on, and `jnp.float32` read as fp64 while
    the step is traced, as `test_torch_multiclass.jax_grads64` does: the
    JAX package pins fp32 in its norms and sums), jitted: in fp64 XLA's
    fusion moves nothing a 1e-6 tolerance could see."""
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS)

    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f"
                           else a)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jnp, "float32", jnp.float64)
        v = jax.tree.map(f64, variables)
        b = {k: f64(x) for k, x in batch.items()}

        def loss(params, b):
            vox = jax_device_voxelize(vspec, b["points"], b["points_mask"])
            preds, _ = jmod.apply(
                {"params": params, "batch_stats": v["batch_stats"]},
                vox["voxels"], vox["num_points"], vox["coordinates"],
                vox["voxel_valid"], b["anchors"], train=True,
                anchors_mask=b["anchors_mask"], mutable=["batch_stats"])
            out = jax_two_stage_loss(jspec, preds, b["labels"],
                                     b["reg_targets"], b["anchors"],
                                     b["gt_boxes_padded"], b["gt_valid"])
            return out["loss"], (out, preds["proposals"]["indices"])
        (_, (aux, idx)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"], b)
        assert jax.tree.leaves(grads)[0].dtype == jnp.float64
        return (jax.device_get(aux), np.asarray(idx),
                grads_from_jax(jax.device_get(grads)))


def _port_grads(net, spec, cfg, batch, dtype, tap):
    """The port's loss parts, proposal indices and gradients of one
    train-mode forward and backward in `dtype` (on a copy of `net`), with
    a `ReluTap` standing in for the refine head's ReLUs."""
    net = copy.deepcopy(net).to(dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(second_stage, "torch", tap)
        preds, b = _port_preds(net, cfg, batch, train=True, dtype=dtype)
        aux = compute_two_stage_loss(spec, preds, b["labels"],
                                     b["reg_targets"], b["anchors"],
                                     b["gt_boxes_padded"], b["gt_valid"])
        aux["loss"].backward()
    return aux, preds["proposals"]["indices"], \
        {n: p.grad for n, p in net.named_parameters()}


@pytest.fixture(scope="module")
def grad_runs():
    """The tiny PointPillars two-stage detector with the Part-A² soft
    targets and the direction classifier, one batch, random weights:
    JAX's loss and gradients in fp64, the port's in fp64 and fp32."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = _models(
        TINY_PIPELINE, partaa=True)
    assert spec.use_iou_param_partaa and spec.use_direction_classifier
    batch = _batch(info, assigner)
    # the proposals' NMS may take the positive anchors and a tenth of the
    # others: random stage-1 scores would seldom rank a positive among the
    # NUM_PROPOSALS proposals, and the stage-2 losses need some
    rng = np.random.default_rng(2)
    batch["anchors_mask"] = (batch["labels"] > 0) | \
        (rng.uniform(size=batch["labels"].shape) < 0.1)
    _, args = _jax_args(jcfg, batch)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = _random_variables(shapes, np.random.default_rng(1))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tap64, pre32 = ReluTap(), ReluTap()
    run64 = _port_grads(net, spec, cfg, batch, torch.float64, tap64)
    _port_grads(net, spec, cfg, batch, torch.float32, pre32)
    return dict(jax64=_jax_grads64(jmod, jspec, jcfg, variables, batch),
                float64=run64, pre64=tap64.pre, pre32=pre32.pre,
                float32=_port_grads(net, spec, cfg, batch, torch.float32,
                                    ReluTap(masks=tap64.pre)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_two_stage_loss_and_grads_match_jax(grad_runs, dtype):
    """Against JAX's fp64 step: the same proposals; every loss part (the
    stage-2 direction loss and the soft-target classification loss among
    them) within 1e-10 (the port in fp64) or LOSS_RTOL (in fp32) of the
    loss; every gradient, the refine head's and stage 1's (through the
    crops and the proposal boxes as well as stage 1's own loss), within
    GRAD64_TOL (fp64, F4's rule) or GRAD_TOL (fp32) of its scale. The fp32
    step runs with the fp64 step's ReLU masks replayed in the refine head
    (F4's method): its ten unnormalised convs put some of their millions
    of ReLU inputs within fp32 rounding of zero on every batch tried (12-24
    on five seeds at 32 proposals), and each flipped sign moves the head's
    gradients by up to 4% of their scale; the flips themselves are held
    to lie within that rounding (`test_two_stage_fp32_flips_are_rounding`)."""
    jaux, jidx, jgrads = grad_runs["jax64"]
    aux, idx, grads = grad_runs[str(dtype)[6:]]
    np.testing.assert_array_equal(idx.numpy(), jidx)
    loss = float(jaux["loss"])
    rtol = 1e-10 if dtype == torch.float64 else LOSS_RTOL
    assert "second_dir_loss_reduced" in aux and \
        float(aux["second_num_pos"]) > 0
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=0,
                                   atol=rtol * loss, err_msg=k)
    assert set(grads) == set(jgrads)
    tol = GRAD64_TOL if dtype == torch.float64 else GRAD_TOL
    for name, g in grads.items():
        assert g.dtype == dtype
        assert _rel_err(g, jgrads[name]) < tol, name
    assert grads["second_rpn.conv_dir_second.weight"].abs().max() > 0
    assert grads["stage1.rpn.head.box.weight"].abs().max() > 0


def test_two_stage_fp32_flips_are_rounding(grad_runs):
    """The refine head's ReLU inputs whose sign differs between the port's
    fp32 and fp64 steps: there are some, and each one's fp64 value lies
    within that layer's largest fp32 rounding (the fp32 step is otherwise
    the fp64 one: `test_two_stage_loss_and_grads_match_jax`)."""
    flips = 0
    for a, b in zip(grad_runs["pre32"], grad_runs["pre64"]):
        flip = (a > 0) != (b > 0)
        if flip.any():
            assert b[flip].abs().max() <= (a.double() - b).abs().max()
            flips += int(flip.sum())
    assert len(grad_runs["pre32"]) == 10 and flips > 0


def test_two_stage_steps_match_jax():
    """`make_two_stage_steps` on the tiny PointPillars pipeline against
    JAX's (jitted) from the same weights, one momentum-SGD step and one
    eval step: the train metrics are JAX's keys plus the stage-2 direction
    loss and the overflow counts, the loss and its parts within LOSS_RTOL
    of the loss and the counts exact; the gradients the optimizer receives
    are those of one backward of `compute_two_stage_loss` (within 1e-6 of
    their scale: the CPU's conv backward sums in threads), and grad_norm
    is their global norm; the eval step's valid exactly JAX's, its boxes
    within TOL."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = _models(
        TINY_PIPELINE, optimizer=SGD_PATCH)
    batch = _batch(info, assigner)
    vspec, args = _jax_args(jcfg, batch)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    variables = _calibrated(jmod, _random_variables(
        shapes, np.random.default_rng(1)), args)
    tx, _ = jax_build_optimizer(jcfg.train_config.optimizer,
                                jcfg.train_config.steps)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=jmod.apply)
    jtrain, jeval = jax_make_two_stage_steps(jspec, vspec)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax.device_get(jeval(state, jbatch))
    jm = jax.device_get(jtrain(state, jbatch)[1])

    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    want = _port_grads(net, spec, cfg, batch, torch.float32, torch)[2]
    opt, lr_sched = build_optimizer(cfg.train_config.optimizer,
                                    cfg.train_config.steps, net.parameters())
    tgrads = []
    step_opt = opt.step

    def recording_step(count):
        tgrads.append({n: p.grad.clone() for n, p in net.named_parameters()})
        return step_opt(count)
    opt.step = recording_step
    tvspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    train_step, eval_step = make_two_stage_steps(spec, tvspec)
    tbatch = {k: _t(v) for k, v in batch.items()}
    tstate = TrainState(net, opt, 0, lr_sched)
    det = eval_step(tstate, tbatch)
    _, tm = train_step(tstate, tbatch)

    assert set(tm) == set(jm) | {"second_dir_loss", "voxel_overflow",
                                 "stage_overflow"}
    loss = float(jm["loss"])
    for k in jm:
        if k in ("num_pos", "second_num_pos"):
            assert int(tm[k]) == int(jm[k]), k
        elif k != "grad_norm":
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                       atol=LOSS_RTOL * loss, err_msg=k)
    for name, g in tgrads[0].items():
        assert _rel_err(g, want[name]) < 1e-6, name
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in want.values()))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(norm),
                               rtol=1e-6)
    valid = np.asarray(jdet["valid"])
    np.testing.assert_array_equal(det["valid"].numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(det["boxes"].numpy()[valid],
                               np.asarray(jdet["boxes"])[valid], **TOL)
    assert int(det["voxel_overflow"]) == 0


# ------------------------------------------------ converter and trainer


def test_convert_two_stage_tree(fwd_run):
    """Every leaf of JAX's two-stage variables lands in the port's state
    dict: stage 1's under `stage1.` as the one-stage converter maps them,
    the refine head's convs HWIO → OIHW; nothing else, and the gradient
    tree maps onto every parameter name."""
    v = fwd_run["variables"]
    sd = state_dict_from_jax(v)
    one = state_dict_from_jax({"params": v["params"]["stage1"],
                               "batch_stats": v["batch_stats"]["stage1"]})
    hp = v["params"]["second_rpn"]
    expect = {f"stage1.{k}": w for k, w in one.items()}
    for tower in ("reg_tower", "cls_tower"):
        assert sorted(hp[tower]) == [f"Conv_{i}" for i in range(5)]
        for i in range(5):
            c = hp[tower][f"Conv_{i}"]
            expect[f"second_rpn.{tower}.convs.{i}.weight"] = \
                np.asarray(c["kernel"]).transpose(3, 2, 0, 1)
            expect[f"second_rpn.{tower}.convs.{i}.bias"] = c["bias"]
    for name in ("conv_box_second", "conv_cls_second", "conv_dir_second"):
        if name in hp:
            expect[f"second_rpn.{name}.weight"] = \
                np.asarray(hp[name]["kernel"]).transpose(3, 2, 0, 1)
            expect[f"second_rpn.{name}.bias"] = hp[name]["bias"]
    assert ("second_rpn.conv_dir_second.weight" in expect) == \
        fwd_run["spec"].use_direction_classifier
    assert set(sd) == set(expect) == set(fwd_run["net"].state_dict())
    for k, want in expect.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(want),
                                      err_msg=k)
    assert set(grads_from_jax(v["params"])) == \
        {n for n, _ in fwd_run["net"].named_parameters()}


def test_trainer_two_stage_trains_and_evaluates(tmp_path):
    """`Trainer(model_type="two_stage", device="cpu")` on the tiny sparse
    pipeline: two steps on synthetic scans with finite stage-1 and stage-2
    losses, then `evaluate` (the anchors mask computed from the voxels)
    writes result.pkl and one KITTI txt file a frame."""
    path = tmp_path / "tiny_sparse.config"
    path.write_text(TINY_SPARSE_PIPELINE)
    tr = Trainer(str(path), tmp_path / "run", synthetic=True, dataset_size=4,
                 max_points=3000, total_steps=2, model_type="two_stage",
                 patches=["train_config.steps_per_eval=0",
                          "train_config.save_summary_steps=1",
                          "train_input_reader.num_workers=1",
                          "eval_input_reader.num_workers=1"],
                 device="cpu")
    try:
        state = tr.train(2)
        assert state.step == 2
        tr.evaluate(state, max_frames=4)
    finally:
        tr.logger.close()
    log = [json.loads(line) for line in
           (tmp_path / "run" / "log.json").read_text().splitlines()]
    steps = [r for r in log if "train.second_loc_loss" in r]
    assert len(steps) == 2
    assert all(np.isfinite(r["train.loss"]) and
               np.isfinite(r["train.second_cls_loss"]) for r in steps)
    out = tmp_path / "run" / "eval_results" / "step_2"
    assert (out / "result.pkl").exists()
    assert len(list((out / "txt").iterdir())) == 4
