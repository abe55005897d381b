"""The IoU-prediction branch in the port against the JAX package, on the
CPU: `d3_iou_matrix` (the 3-D rotated IoU behind the branch's targets; its
kernel's plain version here) on disjoint, identical, nested, z-disjoint
and zero-size boxes, `_iou_targets` with and without Part-A² soft labels,
`compute_loss` with the IoU loss, one train step of the tiny sparse model
with the branch against JAX's eager step, `predict` ranked by the
predicted IoU, and the weight converter carrying `params["iou"]`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.data import ExamplePrep as JExamplePrep
from second_tpu.data import PrepConfig as JPrepConfig
from second_tpu.data.synthetic import sample_scene
from second_tpu.models import build_voxelnet as jax_build_voxelnet
from second_tpu.models.detector import _iou_targets as jax_iou_targets
from second_tpu.models.detector import compute_loss as jax_compute_loss
from second_tpu.models.detector import predict as jax_predict
from second_tpu.ops.rotated_iou import d3_iou_matrix as jax_d3_iou
from second_tpu.testing import TINY_SPARSE_PIPELINE, tiny_scene_kwargs
from second_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from second_tpu.train.state import TrainState as JTrainState
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu.train.state import make_train_step as jax_make_train_step
from second_tpu_torch.config import loads_pipeline_config
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.models import build_voxelnet, compute_loss, predict
from second_tpu_torch.models.detector import _iou_targets
from second_tpu_torch.ops.cuda import riou
from second_tpu_torch.ops.rotated_iou import d3_iou_matrix
from second_tpu_torch.ops.voxelize import VoxelizeSpec
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.state import TrainState, make_train_step

from test_torch_model import _random_variables
from test_torch_multiclass import (GRAD64_TOL, REPLAYED_TOL, ReluTap,
                                  _port_grads, _rel_err, jax_grads64)
from test_torch_train import (GRAD_TOL, LOSS_RTOL, SGD_PATCH, _config,
                              _recording, eager_compile_cache)

D3_TOL = 1e-5
MAX_VOXELS = 2048
IOU_PIPELINE = TINY_SPARSE_PIPELINE.replace(
    "use_rotate_nms: true", "use_rotate_nms: true\n    use_iou_branch: true")
assert IOU_PIPELINE != TINY_SPARSE_PIPELINE


def _random_boxes(rng, n):
    return np.concatenate([
        rng.uniform([0, -6, -2], [12, 6, -1], (n, 3)),
        rng.uniform([0.5, 1.0, 1.0], [2.0, 4.5, 2.0], (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


def _case(name, rng):
    """(boxes1 [2, N, 7], boxes2 [2, K, 7]) for one geometric case."""
    a = np.stack([_random_boxes(rng, 40) for _ in range(2)])
    b = np.stack([_random_boxes(rng, 9) for _ in range(2)])
    if name == "identical":
        a[:, :9] = b
    elif name == "nested":                     # b inside a, shrunk
        a[:, :9] = b
        b = b.copy()
        b[..., 3:6] *= 0.5
        b[..., 2] += 0.25 * a[:, :9, 5]
    elif name == "z_disjoint":                 # same BEV, stacked in z
        a[:, :9] = b
        a[:, :9, 2] = b[..., 2] + b[..., 5] + 0.1
    elif name == "bev_disjoint":
        b = b.copy()
        b[..., 0] += 100.0
    elif name == "zero_size":
        a[:, :9] = b
        a[:, :5, 3] = 0.0
        b = b.copy()
        b[:, :3, 5] = 0.0
    return a, b


@pytest.mark.parametrize("case", ["random", "identical", "nested",
                                  "z_disjoint", "bev_disjoint", "zero_size"])
def test_d3_iou_matrix_matches_jax(case):
    """The batched [B, N, 7] x [B, K, 7] 3-D IoU within D3_TOL of JAX's
    per-example `d3_iou_matrix`, and its expected values: 1 for identical
    boxes, the volume ratio for nested ones, 0 for z- or BEV-disjoint
    ones and for zero-size ones."""
    a, b = _case(case, np.random.default_rng(50))
    got = d3_iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.stack([np.asarray(jax_d3_iou(jnp.asarray(x), jnp.asarray(y)))
                     for x, y in zip(a, b)])
    assert got.shape == (2, 40, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=D3_TOL)
    diag = got[:, np.arange(9), np.arange(9)]
    if case == "identical":
        np.testing.assert_allclose(diag, 1.0, atol=D3_TOL)
    elif case == "nested":
        np.testing.assert_allclose(diag, 0.125, atol=D3_TOL)
    elif case in ("z_disjoint", "bev_disjoint"):
        assert (diag == 0).all()
    elif case == "zero_size":
        assert (diag[:, :5] == 0).all() and (got[:, :, :3] == 0).all()
    else:
        assert (got > 0).sum() > 10
    one = d3_iou_matrix(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_d3_iou_non_finite_boxes():
    """Boxes decoded from a random model can hold inf (an overflowed exp):
    the plain version gives non-finite entries only in their rows, the
    wrapper on a CPU tensor is the plain version, and a wrapper call under
    grad refuses boxes that require grad."""
    a, b = _case("identical", np.random.default_rng(51))
    # an overflowed height decodes to h = inf at z = -inf; a width to w = inf
    a[0, 3, 5], a[0, 3, 2] = np.inf, -np.inf
    a[1, 7, 3] = np.inf
    got = riou.d3_iou(torch.from_numpy(a), torch.from_numpy(b))
    plain = riou.d3_iou_plain(torch.from_numpy(a), torch.from_numpy(b))
    torch.testing.assert_close(got, plain, equal_nan=True, rtol=0, atol=0)
    finite = torch.isfinite(got)
    assert not finite[0, 3].any()
    assert (got[1, 7] == 0).all()         # inter / inf
    finite[0, 3] = True
    assert finite.all()
    with pytest.raises(RuntimeError, match="no backward"):
        riou.d3_iou(torch.from_numpy(a).requires_grad_(),
                    torch.from_numpy(b))


def _targets_inputs(seed=52):
    """Decodable predictions [2, 200, 7] near anchors that sit on gt boxes,
    labels with positives, gt boxes padded to 6 (4 and 5 valid)."""
    rng = np.random.default_rng(seed)
    gt = np.stack([_random_boxes(rng, 6) for _ in range(2)])
    gt_valid = np.zeros((2, 6), bool)
    gt_valid[0, :4] = gt_valid[1, :5] = True
    anchors = np.repeat(gt, 34, axis=1)[:, :200] + rng.normal(
        0, 0.2, (2, 200, 7)).astype(np.float32)
    box_preds = rng.normal(0, 0.3, (2, 200, 7)).astype(np.float32)
    labels = (rng.uniform(size=(2, 200)) < 0.5).astype(np.int32)
    return box_preds, labels, anchors.astype(np.float32), gt, gt_valid


@pytest.mark.parametrize("partaa", [False, True])
def test_iou_targets_match_jax(partaa):
    """`_iou_targets` (decode, 3-D IoU against the valid gt, best gt an
    anchor, Part-A² soft labels) within D3_TOL of JAX's; 0 off the
    positives; the soft labels saturate at 0 and 1."""
    cfg = loads_pipeline_config(IOU_PIPELINE)
    cfg.model.target_assigner.use_iou_param_partaa = partaa
    jcfg = jax_loads(IOU_PIPELINE)
    jcfg.model.target_assigner.use_iou_param_partaa = partaa
    _, jspec, _, _, _ = jax_build_voxelnet(jcfg.model)
    _, tspec, _, _, _ = build_voxelnet(cfg.model, device="cpu")
    assert tspec.use_iou_param_partaa == partaa
    args = _targets_inputs()
    want = np.asarray(jax.jit(lambda *a: jax_iou_targets(jspec, *a))(
        *map(jnp.asarray, args)))
    got = _iou_targets(tspec, *map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=D3_TOL)
    assert (got[args[1] == 0] == 0).all()
    assert (got > 0.05).sum() > 20
    if partaa:
        assert ((got == 0) | (got == 1) | ((got >= 0) & (got <= 1))).all()


@pytest.mark.parametrize("branch,partaa", [(True, False), (True, True),
                                           (False, True)])
def test_compute_loss_with_iou_matches_jax(branch, partaa):
    """`compute_loss` on random predictions (iou_preds among them) and real
    targets with the gt boxes: every output within 1e-6 relative of JAX's,
    the IoU loss present with the branch, the Part-A² soft labels in the
    classification loss."""
    cfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    jcfg = jax_loads(TINY_SPARSE_PIPELINE)
    for c in (cfg, jcfg):
        c.model.use_iou_branch = branch
        c.model.target_assigner.use_iou_param_partaa = partaa
    _, jspec, info, assigner, _ = jax_build_voxelnet(jcfg.model)
    _, tspec, _, _, _ = build_voxelnet(cfg.model, device="cpu")
    prep = JExamplePrep(assigner, info.feature_map_size,
                        JPrepConfig(max_points=3000, training=True))
    rng = np.random.default_rng(53)
    exs = []
    for _ in range(2):
        p, b, n = sample_scene(rng, **tiny_scene_kwargs())
        exs.append(prep({"points": p, "gt_boxes": b, "gt_names": n}, rng))
    batch = prep.collate(exs)
    B, A = batch["labels"].shape
    preds = {"box_preds": rng.normal(0, 0.3, (B, A, 7)).astype(np.float32),
             "cls_preds": rng.normal(-2, 1, (B, A, 1)).astype(np.float32),
             "dir_cls_preds": rng.normal(0, 1, (B, A, 2)).astype(np.float32),
             "iou_preds": rng.normal(0, 1, (B, A, 1)).astype(np.float32)}
    args = [batch[k] for k in ("labels", "reg_targets", "anchors",
                               "gt_boxes_padded", "gt_valid")]
    want = jax.jit(lambda p, *a: jax_compute_loss(jspec, p, *a))(
        {k: jnp.asarray(v) for k, v in preds.items()},
        *map(jnp.asarray, args))
    got = compute_loss(tspec, {k: torch.from_numpy(v)
                               for k, v in preds.items()},
                       *map(torch.from_numpy, args))
    assert set(got) == set(want)
    assert ("iou_loss_reduced" in got) == branch
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    if branch:
        assert float(got["iou_loss_reduced"]) > 0


def iou_inputs():
    """The batch of two tiny scenes (numpy, drawn from seed 0) and the
    random variables (`_random_variables`, seed 1) of the JAX model with
    the IoU branch."""
    module, _, info, assigner, _ = jax_build_voxelnet(
        jax_loads(IOU_PIPELINE).model)
    prep = JExamplePrep(assigner, info.feature_map_size,
                        JPrepConfig(max_points=3000, training=True))
    rng = np.random.default_rng(0)
    exs = []
    for _ in range(2):
        p, b, n = sample_scene(rng, **tiny_scene_kwargs())
        exs.append(prep({"points": p, "gt_boxes": b, "gt_names": n}, rng))
    batch = {k: v for k, v in prep.collate(exs).items() if k != "image_idx"}
    vspec = JVoxelizeSpec.from_config(
        jax_loads(IOU_PIPELINE).model.voxel_generator, MAX_VOXELS,
        shuffle_overflow=True)
    vox = jax_device_voxelize(vspec, jnp.asarray(batch["points"]),
                              jnp.asarray(batch["points_mask"]))
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return batch, _random_variables(shapes, np.random.default_rng(1))


@pytest.fixture(scope="module")
def iou_train_runs():
    """One momentum-SGD step of the tiny sparse model with the IoU branch,
    JAX eagerly and the port from the same converted weights: metrics and
    gradients, the fp64 gradients of both (JAX's jitted, `jax_grads64`),
    and the batch."""
    cfg = _config(SGD_PATCH, IOU_PIPELINE)
    jcfg = jax_loads(IOU_PIPELINE)
    jcfg.train_config.optimizer = cfg.train_config.optimizer
    module, jspec, _, _, _ = jax_build_voxelnet(jcfg.model)
    assert jspec.use_iou_branch
    batch, variables = iou_inputs()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS,
                                      shuffle_overflow=True)
    vox = jax_device_voxelize(vspec, jbatch["points"], jbatch["points_mask"])
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    grads = []
    tx, _ = jax_build_optimizer(jcfg.train_config.optimizer,
                                jcfg.train_config.steps)
    tx = _recording(tx, grads)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=module.apply)
    with jax.disable_jit(), eager_compile_cache():
        _, jm = jax_make_train_step(jspec, vspec)(state, jbatch)
        # the IoU loss of the same forward, which JAX's metrics leave out,
        # op by op as the step (its operations compiled once already)
        jpreds, _ = module.apply(variables, *args, train=True,
                                 mutable=["batch_stats", "intermediates"])
        jloss = jax_compute_loss(jspec, jpreds, *[jbatch[k] for k in (
            "labels", "reg_targets", "anchors", "gt_boxes_padded",
            "gt_valid")])

    net, spec, _, _, _ = build_voxelnet(cfg.model, device="cpu")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt, lr_sched = build_optimizer(cfg.train_config.optimizer,
                                    cfg.train_config.steps, net.parameters())
    tgrads = []
    step_opt = opt.step

    def recording_step(count):
        tgrads.append({n: p.grad.clone() for n, p in net.named_parameters()})
        return step_opt(count)
    opt.step = recording_step
    tvspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS,
                                      shuffle_overflow=True)
    tap64 = ReluTap()
    grads64 = _port_grads(net, spec, tvspec, batch, torch.float64, tap64)
    replayed32 = _port_grads(net, spec, tvspec, batch, torch.float32,
                             ReluTap(masks=tap64.pre))
    pre32 = ReluTap()
    _port_grads(net, spec, tvspec, batch, torch.float32, pre32)
    _, tm = make_train_step(spec, tvspec)(
        TrainState(net, opt, 0, lr_sched),
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    return dict(jm=jax.device_get(jm), jgrads=grads[0], tm=tm,
                tgrads=tgrads[0], grads64=grads64, replayed32=replayed32,
                pre64=tap64.pre, pre32=pre32.pre,
                jgrads64=jax_grads64(IOU_PIPELINE, variables, batch,
                                     MAX_VOXELS),
                variables=variables, batch=batch,
                jloss=jax.device_get(jloss))


def test_iou_train_step_matches_jax(iou_train_runs):
    """The loss (the IoU loss in it) within LOSS_RTOL relative, each part
    within LOSS_RTOL of it, the counts exact, the gradient norm within
    1e-4; the port's metrics add the IoU loss, nonzero."""
    jm, tm = iou_train_runs["jm"], iou_train_runs["tm"]
    assert set(tm) == set(jm) | {"iou_loss"}
    loss = float(jm["loss"])
    np.testing.assert_allclose(float(tm["loss"]), loss, rtol=LOSS_RTOL)
    for k in ("cls_loss", "loc_loss", "cls_pos_loss", "cls_neg_loss",
              "dir_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                   atol=LOSS_RTOL * loss, err_msg=k)
    np.testing.assert_allclose(
        float(tm["iou_loss"]),
        float(iou_train_runs["jloss"]["iou_loss_reduced"]), rtol=0,
        atol=LOSS_RTOL * loss)
    assert float(tm["iou_loss"]) > 0
    for k in ("num_pos", "voxel_overflow", "stage_overflow"):
        assert int(tm[k]) == int(jm[k]), k
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)


def test_iou_train_step_grads_match_jax(iou_train_runs):
    """The port's fp64 gradients within GRAD64_TOL of JAX's fp64 ones
    (jitted, `jax_grads64`), every tensor (the IoU head's among them, not zero). In fp32,
    every gradient from the RPN on within GRAD_TOL of JAX's fp32 ones. The
    sparse middle's fp32 gradients, with the port's fp64 ReLU masks
    replayed, within REPLAYED_TOL of its fp64 ones: on these weights the
    port's fp32 forward flips one ReLU input that lies within its fp32
    rounding of zero, and the middle's fp32 gradients move by up to 5e-2
    of a tensor's scale (fault F4, a ReLU kink: ROADMAP §3,
    `test_torch_multiclass.py::
    test_f4_sparse_middle_fp32_grads_are_ill_conditioned`)."""
    want = grads_from_jax(iou_train_runs["jgrads"])
    want64 = iou_train_runs["jgrads64"]
    got = iou_train_runs["tgrads"]
    assert set(want) == set(got) == set(want64)
    assert {"iou.convs.0.weight", "iou.out.bias"} <= set(got)
    for name, w in want.items():
        ref = iou_train_runs["grads64"][name]
        assert _rel_err(ref, want64[name]) < GRAD64_TOL, name
        if name.startswith("middle."):
            assert _rel_err(iou_train_runs["replayed32"][name], ref) < \
                REPLAYED_TOL, name
            continue
        scale = max(np.abs(w.numpy()).max(), 1e-12)
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
    assert got["iou.out.weight"].abs().max() > 0


def test_convert_round_trip_with_iou_params(iou_train_runs):
    """The converter carries `params["iou"]`: the port's state dict from
    JAX's variables loads strictly, the IoU head's convs are JAX's kernels
    in OIHW, and the gradient tree maps onto every parameter name."""
    variables = iou_train_runs["variables"]
    sd = state_dict_from_jax(variables)
    ip = variables["params"]["iou"]
    assert sorted(ip) == ["Conv_0", "Conv_1", "Conv_2"]
    np.testing.assert_array_equal(
        sd["iou.convs.1.weight"].numpy(),
        np.asarray(ip["Conv_1"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["iou.out.bias"].numpy(),
                                  np.asarray(ip["Conv_2"]["bias"]))
    net, _, _, _, _ = build_voxelnet(
        loads_pipeline_config(IOU_PIPELINE).model, device="cpu")
    net.load_state_dict(sd, strict=True)
    assert set(grads_from_jax(variables["params"])) == \
        {n for n, _ in net.named_parameters()}


def test_iou_ranked_predict_matches_jax():
    """Single-class `predict` ranked by the predicted IoU (threshold and
    NMS order on sigmoid(iou_preds), reported scores the classification
    scores): valid, labels exact, boxes within 1e-5, scores within 1e-6;
    the ranking differs from the classification ranking."""
    cfg = loads_pipeline_config(IOU_PIPELINE)
    jcfg = jax_loads(IOU_PIPELINE)
    _, jspec, info, assigner, _ = jax_build_voxelnet(jcfg.model)
    _, tspec, _, _, _ = build_voxelnet(cfg.model, device="cpu")
    A = info.num_anchors
    anchors = np.broadcast_to(
        assigner.generate_anchors(info.feature_map_size)["anchors"].reshape(
            1, A, 7), (2, A, 7)).astype(np.float32)
    rng = np.random.default_rng(54)
    preds = {"box_preds": rng.normal(0, 0.3, (2, A, 7)).astype(np.float32),
             "cls_preds": rng.normal(-2, 1.5, (2, A, 1)).astype(np.float32),
             "dir_cls_preds": rng.normal(0, 1, (2, A, 2)).astype(np.float32),
             "iou_preds": rng.normal(-1, 1.5, (2, A, 1)).astype(np.float32)}
    want = jax.jit(lambda p, a: jax_predict(jspec, p, a))(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(anchors))
    got = predict(tspec, {k: torch.from_numpy(v) for k, v in preds.items()},
                  anchors)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    np.testing.assert_allclose(got["boxes"].numpy()[valid],
                               np.asarray(want["boxes"])[valid], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-6)
    assert valid.sum() > 0
    plain = predict(tspec, {k: torch.from_numpy(v) for k, v in preds.items()
                            if k != "iou_preds"}, anchors)
    assert not torch.equal(plain["boxes"], got["boxes"])
