"""The joint detector + tracker (`models/joint_track.py`, `JointTrainer`
and `run_tracking --with_detector`) in the port against the JAX package's,
on the CPU (the kernels' plain versions), on the tiny sparse pipeline.

The pieces against JAX's on hand-made and random inputs:
`select_detections` with tied invalid proposals (`lax.top_k`'s lowest
index first), `gather_box_points` with tied distances, `match_dets_to_gt`
against `jax.vmap` of JAX's. Then the whole module from JAX's weights
carried across with `convert.py`: its forward in train mode, the joint
loss and every gradient in fp64 against JAX's jitted fp64
`value_and_grad` (x64 on, `jnp.float32` read as fp64 while it is traced,
as `test_torch_multiclass.jax_grads64`; one compile), the tracking loss's link
part on detections placed at the gt, the tracking loss's gradient into the
second stage, `JointTrainer`, the `--detector_dir` graft of a port
temporal checkpoint and the CLI."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.config import loads_pipeline_config as jax_loads
from second_tpu.models import joint_track as jjoint
from second_tpu.testing import TINY_SPARSE_PIPELINE
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu_torch import convert
from second_tpu_torch.config import loads_pipeline_config
from second_tpu_torch.convert import state_dict_from_jax
from second_tpu_torch.models import joint_track
from second_tpu_torch.models.temporal import _FRAME_KEYS
from second_tpu_torch.train import run_tracking
from second_tpu_torch.train.run import Trainer
from second_tpu_torch.models import build_voxelnet
from second_tpu_torch.train.checkpoint import CheckpointManager
from second_tpu_torch.train.run_tracking import JointTrainer
from second_tpu_torch.train.state import create_state

from test_torch_model import _random_variables
from test_torch_multiclass import GRAD64_TOL, _rel_err
from test_torch_temporal import one_thread

NUM_PROPOSALS, NUM_DETS, NUM_FRAMES = 16, 6, 3
MAX_POINTS = 3000
# fp64, port against JAX: the forward's outputs (some inputs, the voxel
# size among them, are fp32 constants on both sides)
FORWARD64_TOL = dict(rtol=1e-7, atol=1e-7)
# fp64, port against JAX: the loss relative, each gradient of its tensor's
# largest entry (GRAD64_TOL, the one-stage fp64 step's bound)
LOSS64_RTOL = 1e-9


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """The port's side on one thread: beside the other test workers its
    small ops gain nothing from threads (`test_torch_temporal.one_thread`)."""
    with one_thread():
        yield


# ------------------------------------------------------------- the pieces


def _preds(seed, T=3, N=12, A=40, invalid=7):
    """A stage-2 output of T frames: N proposals of which `invalid` are not
    valid (they all score -1.0), two valid ones with one score."""
    rng = np.random.default_rng(seed)
    valid = np.ones((T, N), bool)
    for t in range(T):
        valid[t, rng.permutation(N)[:invalid]] = False
    cls = rng.normal(0, 1, (T, N, 1)).astype(np.float32)
    first = np.flatnonzero(valid[0])
    cls[0, first[1]] = cls[0, first[0]]                 # a tie among valid
    anchors = np.concatenate([rng.uniform(0, 16, (T, A, 3)),
                              rng.uniform(1, 4, (T, A, 3)),
                              rng.uniform(-3, 3, (T, A, 1))],
                             -1).astype(np.float32)
    return {"proposals": {"indices": rng.integers(0, A, (T, N)),
                          "valid": valid},
            "second_box_preds": rng.normal(0, 0.2, (T, N, 7)).astype(
                np.float32),
            "second_cls_preds": cls}, anchors


@pytest.mark.parametrize("seed", [0, 1])
def test_select_detections_matches_jax(seed):
    """More detections asked for than valid proposals: the invalid ones,
    all at -1.0, fill the rest in index order as `lax.top_k` takes them
    (their boxes differ, so the order shows); a tie among valid scores
    too. Boxes and scores within 1e-6 (the sigmoid an ulp apart), valid
    exactly."""
    preds, anchors = _preds(seed)
    jp = jax.tree.map(jnp.asarray, preds)
    want = jjoint.select_detections(None, jp, jnp.asarray(anchors), 8)
    tp = {"proposals": {k: _t(v) for k, v in preds["proposals"].items()},
          "second_box_preds": _t(preds["second_box_preds"]),
          "second_cls_preds": _t(preds["second_cls_preds"])}
    got = joint_track.select_detections(None, tp, _t(anchors), 8)
    assert (~preds["proposals"]["valid"]).sum(1).min() > 2
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not got[2].all() and got[2].any()


def test_gather_box_points_matches_jax():
    """JAX's own case (8 points in each box, the rest far or masked), then
    random clouds around random boxes with points at exactly equal
    distances from a box's center (yaw 0, dyadic offsets): the same points
    in the same order as JAX's top-k, the masks exactly, the values within
    1e-6; batched over frames as `jax.vmap` of JAX's."""
    pts = np.zeros((64, 4), np.float32)
    pts[:8, :3] = [5.0, 2.0, -1.0]
    pts[8:16, :3] = [12.0, -3.0, -1.2]
    pts[16:, 0] = 100.0
    mask = np.ones(64, bool)
    mask[60:] = False
    boxes = np.array([[5.0, 2.0, -1.6, 1.6, 3.9, 1.56, 0.3],
                      [12.0, -3.0, -1.7, 1.6, 3.9, 1.56, -0.5]], np.float32)
    sel, m = joint_track.gather_box_points(_t(pts), _t(mask), _t(boxes), 16)
    assert tuple(sel.shape) == (2, 16, 3)
    assert m.sum(1).tolist() == [8, 8]
    want = jjoint.gather_box_points(jnp.asarray(pts), jnp.asarray(mask),
                                    jnp.asarray(boxes), 16)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(sel.numpy(), np.asarray(want[0]), atol=1e-6)

    rng = np.random.default_rng(4)
    T, P, D = 2, 400, 5
    boxes = np.concatenate([rng.uniform([2, -6, -2], [14, 6, -1], (T, D, 3)),
                            rng.uniform(1.5, 4, (T, D, 3)),
                            rng.uniform(-np.pi, np.pi, (T, D, 1))],
                           -1).astype(np.float32)
    boxes[:, 0, :3] = [5.0, 2.0, -1.5]
    boxes[:, 0, 6] = 0.0
    pts = np.concatenate([rng.uniform([0, -8, -3], [16, 8, 1], (T, P, 3)),
                          rng.uniform(0, 1, (T, P, 1))], -1).astype(np.float32)
    # ties: (±1, ±0.5) and (±0.5, ±1) from box 0's center, one height
    ties = [[1.0, 0.5], [0.5, 1.0], [-1.0, 0.5], [0.5, -1.0], [-0.5, -1.0]]
    pts[:, 10:15, :2] = boxes[0, 0, :2] + np.array(ties, np.float32)
    pts[:, 10:15, 2] = -1.0
    mask = rng.uniform(size=(T, P)) < 0.9
    mask[:, 10:15] = True
    got = joint_track.gather_box_points(_t(pts), _t(mask), _t(boxes), 32)
    want = jax.vmap(jjoint.gather_box_points, in_axes=(0, 0, 0, None))(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(boxes), 32)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    assert got[1][:, 0].sum(-1).min() >= 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_dets_to_gt_matches_jax(seed):
    """JAX's own one-frame case, then T frames of dets jittered off the gt
    (some matched, some not, some invalid, some gt slots padded): det_cls
    and det_id exactly `jax.vmap` of JAX's, from one rotated-IoU matrix of
    the whole window."""
    gt = np.array([[5.0, 2.0, -1.6, 1.6, 3.9, 1.56, 0.0],
                   [12.0, -3.0, -1.7, 1.6, 3.9, 1.56, 0.0]], np.float32)
    dets = np.array([[5.1, 2.05, -1.6, 1.6, 3.9, 1.56, 0.0],
                     [30.0, 10.0, -1.6, 1.6, 3.9, 1.56, 0.0],
                     [12.0, -3.0, -1.7, 1.6, 3.9, 1.56, 0.0]], np.float32)
    cls, ids = joint_track.match_dets_to_gt(
        _t(dets), torch.ones(3, dtype=torch.bool), _t(gt),
        torch.tensor([7, 9]), torch.ones(2, dtype=torch.bool))
    assert cls.tolist() == [1, 0, 1] and ids.tolist() == [7, -1, 9]

    rng = np.random.default_rng(seed)
    T, D, G = 4, 10, 6
    gt = np.concatenate([rng.uniform([0, -8, -2], [16, 8, -1], (T, G, 3)),
                         rng.uniform(1.5, 4, (T, G, 3)),
                         rng.uniform(-np.pi, np.pi, (T, G, 1))],
                        -1).astype(np.float32)
    src = rng.integers(0, G, (T, D))
    dets = np.take_along_axis(gt, src[..., None], 1) + np.concatenate(
        [rng.normal(0, 0.4, (T, D, 2)), np.zeros((T, D, 4)),
         rng.normal(0, 0.2, (T, D, 1))], -1).astype(np.float32)
    det_valid = rng.uniform(size=(T, D)) < 0.8
    gt_valid = rng.uniform(size=(T, G)) < 0.8
    gt_ids = rng.integers(0, 50, (T, G))
    cls, ids = joint_track.match_dets_to_gt(
        _t(dets), _t(det_valid), _t(gt), _t(gt_ids), _t(gt_valid))
    wcls, wids = jax.vmap(jjoint.match_dets_to_gt,
                          in_axes=(0, 0, 0, 0, 0, None))(
        *map(jnp.asarray, (dets, det_valid, gt, gt_ids, gt_valid)), 0.5)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(wcls))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
    assert 0 < int(cls.sum()) < T * D


# ------------------------------------------------------------ the module


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    """The port's `JointTrainer` on the tiny sparse pipeline (its window 0,
    the batch) and JAX's module and spec, with `_random_variables` drawn
    for JAX's tree."""
    tmp = tmp_path_factory.mktemp("joint")
    cfg_path = tmp / "tiny.config"
    cfg_path.write_text(TINY_SPARSE_PIPELINE)
    jt = JointTrainer(tmp / "j", cfg_path, num_frames=NUM_FRAMES,
                      num_dets=NUM_DETS, dataset_size=4,
                      max_points=MAX_POINTS, device="cpu")
    batch = {k: v.numpy() for k, v in jt._window(1).items()}
    jcfg = jax_loads(TINY_SPARSE_PIPELINE)
    jmod, jspec = jjoint.build_joint_det_track(
        jcfg.model, num_dets=NUM_DETS, num_proposals=NUM_PROPOSALS)[:2]
    jframes = _jax_frames(jcfg, batch)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jframes, jnp.asarray(batch["anchors"])))
    variables = _random_variables(shapes, np.random.default_rng(2))
    net, spec = joint_track.build_joint_det_track(
        loads_pipeline_config(TINY_SPARSE_PIPELINE).model,
        num_dets=NUM_DETS, num_proposals=NUM_PROPOSALS, device="cpu")[:2]
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return dict(tmp=tmp, cfg_path=cfg_path, jt=jt, batch=batch, jmod=jmod,
                jspec=jspec, variables=variables, net=net, spec=spec,
                jframes=jframes)


def _jax_frames(jcfg, batch):
    """JAX's voxelized window at the train reader's capacity, with the raw
    clouds (JAX `JointTrainer`'s `_frames`)."""
    vspec = JVoxelizeSpec.from_config(
        jcfg.model.voxel_generator,
        jcfg.train_input_reader.max_number_of_voxels)
    vox = jax_device_voxelize(vspec, jnp.asarray(batch["points"]),
                              jnp.asarray(batch["points_mask"]))
    out = {k: vox[k] for k in _FRAME_KEYS}
    out["points"] = jnp.asarray(batch["points"])
    out["points_mask"] = jnp.asarray(batch["points_mask"])
    return out


def test_converter_carries_the_joint_tree(joint):
    """The joint tree maps onto every parameter and statistic of the port's
    `JointDetTrack` (strict load), the detector's under `detector.` and the
    heads' beside it; the gradient tree onto its parameters."""
    sd = state_dict_from_jax(joint["variables"])
    names = set(joint["net"].state_dict())
    assert set(sd) == names
    assert {n.split(".")[0] for n in names} == {
        "detector", "appearance", "point_net", "fusion", "w_det", "w_link"}
    grads = convert.grads_from_jax(joint["variables"]["params"])
    assert set(grads) == {n for n, _ in joint["net"].named_parameters()}


# the forward's outputs compared, beside the proposals' and detections'
# masks compared exactly
FORWARD_KEYS = ("det_boxes", "det_scores", "track_feats", "det_logits",
                "link_logits", "end_logits", "new_logits", "gated_bev_feat")


def _jax_loss_grads64(joint, batch):
    """JAX's joint loss and its gradient in fp64, jitted: the module in
    train mode, `compute_joint_loss`; with the forward's outputs (one
    compile serves the forward, the loss and the gradients)."""
    jmod, jspec = joint["jmod"], joint["jspec"]

    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f"
                           else a)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jnp, "float32", jnp.float64)
        v = jax.tree.map(f64, joint["variables"])
        b = {k: f64(x) for k, x in batch.items()}

        def loss_fn(params):
            frames = {k: f64(x) for k, x in joint["jframes"].items()}
            preds, _ = jmod.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, frames,
                b["anchors"], train=True, mutable=["batch_stats"])
            losses = jjoint.compute_joint_loss(jspec, preds, b)
            out = {k: preds[k] for k in FORWARD_KEYS + ("det_valid",)}
            out["proposals"] = preds["proposals"]
            return losses["loss"], (losses, out)
        (_, (losses, preds)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"])
        losses, grads, preds = jax.device_get((losses, grads, preds))
        assert jax.tree.leaves(grads)[0].dtype == np.float64
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "_t", lambda a: torch.from_numpy(
            np.array(a, dtype=np.float64)))
        grads = convert.grads_from_jax(grads)
    return losses, grads, preds


def _port_loss(joint, dtype):
    """The port's joint loss in `dtype` on a copy of the module in train
    mode, its parameters' gradients, the module and the forward's
    outputs."""
    net = copy.deepcopy(joint["net"]).to(dtype).train()
    b = {k: _t(v) for k, v in joint["batch"].items()}
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
    frames = joint["jt"].frames(b)
    preds = net(frames, b["anchors"])
    losses = joint_track.compute_joint_loss(joint["spec"], preds, b)
    losses["loss"].backward()
    return losses, {n: p.grad for n, p in net.named_parameters()}, net, \
        preds


@pytest.fixture(scope="module")
def loss64_run(joint):
    return _jax_loss_grads64(joint, joint["batch"]), \
        _port_loss(joint, torch.float64)


def test_joint_forward_matches_jax(loss64_run):
    """The window's forward in train mode, fp64 (prev = the window shifted
    by one, frame 0 with itself): the proposals and the detections' valid
    exactly JAX's, their boxes, scores, track features, det / link / end /
    new logits and the gated map within FORWARD64_TOL."""
    (_, _, want), (_, _, _, got) = loss64_run
    for k in ("indices", "valid"):
        np.testing.assert_array_equal(got["proposals"][k].numpy(),
                                      want["proposals"][k])
    np.testing.assert_array_equal(got["det_valid"].numpy(),
                                  want["det_valid"])
    assert got["det_valid"].any()
    for k in FORWARD_KEYS:
        g = got[k].detach().numpy()
        if k == "gated_bev_feat":
            g = g.transpose(0, 2, 3, 1)
        assert g.shape == want[k].shape, k
        np.testing.assert_allclose(g, want[k], **FORWARD64_TOL, err_msg=k)
    T = got["det_boxes"].shape[0]
    assert tuple(got["link_logits"].shape) == (T - 1, NUM_DETS, NUM_DETS)


def test_joint_loss_and_grads_match_jax_fp64(loss64_run):
    """fp64, port against JAX: every loss term within LOSS64_RTOL, every
    parameter's gradient (the detector's, the tracking heads') within
    GRAD64_TOL of its tensor's largest entry."""
    (jlosses, jgrads, _), (losses, grads, _, _) = loss64_run
    assert set(jlosses) <= set(losses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k].detach()), float(v),
                                   rtol=LOSS64_RTOL, atol=1e-12, err_msg=k)
    assert float(losses["tracking_loss"].detach()) > 0
    assert set(jgrads) == set(grads)
    worst = max(_rel_err(grads[n].numpy(), jgrads[n].numpy())
                for n in grads)
    assert worst < GRAD64_TOL, worst
    assert grads["detector.second_rpn.conv_box_second.weight"].abs().max() > 0


def test_tracking_loss_reaches_the_second_stage(joint):
    """The tracking loss alone, backward through the fp32 module: nonzero
    gradients into the detector's second stage (through the crops and the
    point sets at its boxes), its backbone and w_det (JAX's
    `test_tracking_grads_reach_second_stage`)."""
    net = copy.deepcopy(joint["net"]).train()
    b = {k: _t(v) for k, v in joint["batch"].items()}
    preds = net(joint["jt"].frames(b), b["anchors"])
    losses = joint_track.compute_joint_loss(joint["spec"], preds, b)
    losses["tracking_loss"].backward()
    params = dict(net.named_parameters())
    second = sum(float(p.grad.abs().sum()) for n, p in params.items()
                 if n.startswith("detector.second_rpn.") and
                 p.grad is not None)
    assert second > 0
    for name in ("w_det.Dense_0.weight", "appearance.Conv_0.weight",
                 "detector.middle.subm.0.weight",
                 "detector.bev_fusion.conv_gating_bev.weight"):
        assert params[name].grad is not None and \
            params[name].grad.abs().max() > 0, name


def test_tracking_link_loss_matches_jax_fp64(joint, loss64_run):
    """`compute_joint_loss` on detections placed at the gt boxes (so they
    match and the link loss counts), from the forward's logits, in fp64:
    the tracking terms within LOSS64_RTOL of JAX's, the link loss nonzero,
    and the gradients of the logits within GRAD64_TOL."""
    got = loss64_run[1][3]
    batch = joint["batch"]
    T, D = got["det_boxes"].shape[:2]
    gtb, gtv = batch["gt_boxes_padded"], batch["gt_valid"]
    det_boxes = np.zeros((T, D, 7))
    det_valid = np.zeros((T, D), bool)
    for t in range(T):
        n = min(int(gtv[t].sum()), D - 1)
        det_boxes[t, :n] = gtb[t][gtv[t]][:n] + [0.05, 0, 0, 0, 0, 0, 0]
        det_valid[t, :n + 1] = True
        det_boxes[t, n] = [40.0, 30.0, -1.0, 1.6, 3.9, 1.5, 0.0]
    logits = {k: got[k].detach().numpy() for k in (
        "det_logits", "link_logits", "end_logits", "new_logits")}

    def jloss(lg):
        valid = jnp.asarray(det_valid)
        cls, ids = jax.vmap(jjoint.match_dets_to_gt,
                            in_axes=(0, 0, 0, 0, 0, None))(
            jnp.asarray(det_boxes), valid, jnp.asarray(gtb),
            jnp.asarray(batch["gt_ids"]), jnp.asarray(gtv), 0.5)
        g = jjoint.generate_gt(cls, ids, valid)
        tr = jjoint.tracking_loss(lg["link_logits"], lg["end_logits"],
                                  lg["new_logits"], lg["det_logits"], g,
                                  cls, valid)
        return tr["loss"], tr
    with jax.enable_x64(True):
        (_, jtr), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            {k: jnp.asarray(v) for k, v in logits.items()})
        jtr, jg = jax.device_get((jtr, jg))
    lg = {k: _t(v).requires_grad_() for k, v in logits.items()}
    b = {k: _t(v) for k, v in batch.items()}
    preds = {**lg, "det_boxes": _t(det_boxes), "det_valid": _t(det_valid)}
    with torch.no_grad():
        cls, ids = joint_track.match_dets_to_gt(
            preds["det_boxes"], preds["det_valid"], b["gt_boxes_padded"],
            b["gt_ids"], b["gt_valid"])
    from second_tpu_torch.models.tracking_train import (generate_gt,
                                                        tracking_loss)
    tr = tracking_loss(lg["link_logits"], lg["end_logits"],
                       lg["new_logits"], lg["det_logits"],
                       generate_gt(cls, ids, preds["det_valid"]), cls,
                       preds["det_valid"])
    tr["loss"].backward()
    assert float(tr["link_loss"].detach()) > 0 and int(cls.sum()) > 0
    for k in ("loss", "det_loss", "link_loss"):
        np.testing.assert_allclose(float(tr[k].detach()), float(jtr[k]),
                                   rtol=LOSS64_RTOL, err_msg=k)
    for k, v in lg.items():
        assert _rel_err(v.grad.numpy(), jg[k]) < GRAD64_TOL, k


# ------------------------------------------------------------- training


def test_joint_trainer_trains(joint):
    """Three Adam steps of `JointTrainer` on synthetic windows: every loss
    finite, the step counted, the checkpoint `joint-3.pt` written and
    restorable."""
    jt = joint["jt"]
    res = jt.train(3, log_every=1)
    assert np.isfinite(res["first_loss"]) and np.isfinite(res["last_loss"])
    assert jt.step == 3 and (jt.model_dir / "joint-3.pt").exists()
    raw = jt.ckpt.restore_raw()
    assert raw["step"] == 3
    for k, v in jt.module.state_dict().items():
        assert torch.equal(raw["model"][k], v), k


@pytest.fixture(scope="module")
def checkpoints(joint):
    """A port `Trainer --model_type temporal` checkpoint (one synthetic
    step) of the tiny sparse pipeline, and a one-stage one (the state a
    one-stage `Trainer` saves, at step 0)."""
    d = joint["tmp"] / "temporal"
    tr = Trainer(joint["cfg_path"], d, synthetic=True, dataset_size=4,
                 max_points=MAX_POINTS, total_steps=1, model_type="temporal",
                 patches=["train_config.steps_per_eval=0"], device="cpu")
    try:
        tr.train(1)
    finally:
        tr.logger.close()
    cfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    one = create_state(build_voxelnet(cfg.model, device="cpu")[0],
                       cfg.train_config.optimizer, 1)
    CheckpointManager(joint["tmp"] / "one_stage").save(one, 0)
    return {"temporal": d, "one_stage": joint["tmp"] / "one_stage"}


def test_detector_dir_grafts_a_temporal_checkpoint(joint, checkpoints):
    """`detector_dir` loads the temporal checkpoint into the detector
    exactly (strict); the heads keep their initialisers."""
    jt = JointTrainer(joint["tmp"] / "graft", joint["cfg_path"],
                      detector_dir=checkpoints["temporal"],
                      num_frames=2, num_dets=NUM_DETS, dataset_size=2,
                      max_points=MAX_POINTS, device="cpu")
    assert jt.restored_detector
    raw = CheckpointManager(checkpoints["temporal"]).restore_raw()
    det = jt.module.detector.state_dict()
    assert set(det) == set(raw["model"])
    for k, v in raw["model"].items():
        assert torch.equal(det[k], v), k
    fresh = JointTrainer(joint["tmp"] / "fresh", joint["cfg_path"],
                         num_frames=2, num_dets=NUM_DETS, dataset_size=2,
                         max_points=MAX_POINTS, device="cpu")
    assert not fresh.restored_detector
    assert torch.equal(fresh.module.w_link.Dense_0.weight,
                       jt.module.w_link.Dense_0.weight)


def test_detector_dir_refuses_another_models_checkpoint(joint, checkpoints):
    """A one-stage checkpoint's names are not the temporal detector's: the
    graft raises, naming the keys."""
    with pytest.raises(RuntimeError, match="Missing key"):
        JointTrainer(joint["tmp"] / "bad", joint["cfg_path"],
                     detector_dir=checkpoints["one_stage"], num_frames=2,
                     num_dets=NUM_DETS, dataset_size=2, max_points=MAX_POINTS,
                     device="cpu")


def test_with_detector_cli(joint, checkpoints, tmp_path):
    """`run_tracking train --with_detector` on the CPU from the temporal
    checkpoint writes the joint checkpoint; without --detector_config, or
    with evaluate, the CLI refuses."""
    args = ["--model_dir", str(tmp_path), "--device", "cpu", "--steps", "1",
            "--num_frames", "2", "--max_dets", str(NUM_DETS), "--detector_config",
            str(joint["cfg_path"])]
    res = run_tracking.main(["train", "--with_detector", *args,
                             "--detector_dir", str(checkpoints["temporal"])])
    assert np.isfinite(res["last_loss"])
    assert (tmp_path / "joint-1.pt").exists()
    with pytest.raises(SystemExit):
        run_tracking.main(["train", "--with_detector", "--model_dir",
                           str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit):
        run_tracking.main(["evaluate", "--with_detector", *args])
