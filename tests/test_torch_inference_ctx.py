"""The port's `InferenceContext` (`core/inference_ctx.py`), the 3-D and
camera box helpers of `ops/box_ops.py` and the detector-driven tracking
path (`TrackingTrainer(detector_config=...)`) against the JAX package's, on
the CPU (the kernels' plain versions).

The contexts are built on the tiny PointPillars pipeline with the eval
reader's anchor-area threshold at 1 (the anchors mask computed from the
voxelizer's coords, JAX's `device_anchors_mask`), JAX's weights drawn by
`_random_variables` with the norm statistics calibrated on a batch (a
random pillar model's boxes overflow otherwise:
`test_torch_pointpillars._calibrated`) and carried across with
`convert.py`. The JAX side runs jitted, as its `InferenceContext` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.core.inference_ctx import InferenceContext as JContext
from second_tpu.data import tracking as jtracking
from second_tpu.ops import box_ops as jbox
from second_tpu.testing import TINY_PIPELINE, TINY_SPARSE_PIPELINE
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu_torch.convert import state_dict_from_jax
from second_tpu_torch.core.inference_ctx import InferenceContext
from second_tpu_torch.ops import box_ops
from second_tpu_torch.train.run import Trainer
from second_tpu_torch.train.run_tracking import TrackingTrainer

from test_torch_model import _random_variables
from test_torch_pointpillars import _calibrated
from test_torch_temporal import one_thread

MAX_POINTS = 3000
# fp32, port against JAX: the pillar encoder's and the RPN's sums in
# another order (oneDNN against XLA), and the boxes decoded from them
TOL = dict(rtol=1e-4, atol=1e-4)
# the box helpers: elementwise as JAX's, the matrix products summed in
# another order
BOX_TOL = dict(rtol=1e-5, atol=1e-5)


def tiny_config(tmp_path, pipeline=TINY_PIPELINE, name="tiny.config"):
    """The pipeline with the eval reader's anchor_area_threshold at 1,
    written to tmp_path."""
    path = tmp_path / name
    path.write_text(pipeline.replace(
        "eval_input_reader: {",
        "eval_input_reader: {\n  anchor_area_threshold: 1"))
    return path


def clouds(seed, n=3, sizes=(2000, 700, 1500)):
    """n random clouds [P, 4] inside the tiny pipelines' range."""
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.uniform([0, -8, -3], [16, 8, 1], (p, 3)),
                            rng.uniform(0, 1, (p, 1))], 1).astype(np.float32)
            for p in sizes[:n]]


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """The port's side on one thread: beside the other test workers its
    small ops gain nothing from threads (`test_torch_temporal.one_thread`)."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def contexts(tmp_path_factory):
    """JAX's and the port's contexts on the tiny PointPillars config from
    the same calibrated random weights."""
    cfg_path = tiny_config(tmp_path_factory.mktemp("ctx"))
    jctx = JContext(cfg_path).build(max_points=MAX_POINTS)
    assert jctx.prep.sat_mask_info() is not None
    batch = jctx.get_inference_input_dict(clouds(5)[0])
    vox = jax_device_voxelize(jctx.vspec, jnp.asarray(batch["points"]),
                              jnp.asarray(batch["points_mask"]))
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    shapes = jax.eval_shape(lambda: jctx.module.init(jax.random.PRNGKey(0),
                                                     *args))
    variables = _calibrated(jctx.module, _random_variables(
        shapes, np.random.default_rng(1)), args)
    jctx.state = jctx.state.replace(params=variables["params"],
                                    batch_stats=variables["batch_stats"])
    ctx = InferenceContext(cfg_path).build(max_points=MAX_POINTS,
                                           device="cpu")
    ctx.module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return cfg_path, jctx, ctx


def assert_detections_match(got, want):
    """Counts, labels and class names exact; boxes and scores within TOL."""
    assert len(got["scores"]) == len(want["scores"])
    np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))
    assert got["class_names"] == want["class_names"]
    np.testing.assert_allclose(got["boxes"], np.asarray(want["boxes"]),
                               **TOL)
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_inference_matches_jax(contexts, seed):
    """A batch of three clouds, and the first alone on the port's side:
    JAX's keep sets and labels exactly, boxes and scores within TOL; some
    detections kept, finite. (JAX's side runs one batch size: each new
    one is a compile.)"""
    _, jctx, ctx = contexts
    pcs = clouds(seed)
    want = jctx.inference_batch(pcs)
    for g, w in zip(ctx.inference_batch(pcs), want):
        assert_detections_match(g, w)
    got = ctx.inference(pcs[0])
    assert_detections_match(got, want[0])
    assert len(got["scores"]) > 0 and np.isfinite(got["boxes"]).all()
    assert got["boxes"].dtype == np.float32 and got["boxes"].shape[1] == 7


def test_inference_batch_is_one_copy_and_per_frame(contexts, monkeypatch):
    """`inference_batch` copies its detections to the host once a batch,
    and a cloud's detections in a batch equal its detections alone within
    TOL with the same keep set."""
    _, _, ctx = contexts
    pcs = clouds(3)
    copies = []
    cpu = torch.Tensor.cpu

    def counting(t, *a, **k):
        copies.append(tuple(t.shape))
        return cpu(t, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    batch = ctx.inference_batch(pcs)
    monkeypatch.undo()
    assert copies == [(3, ctx.spec.nms_post_max_size, 10)]
    for p, got in zip(pcs, batch):
        assert_detections_match(got, ctx.inference(p))


def test_inference_input_dict_matches_jax(contexts):
    """The single-example input (padded points, mask, anchors): JAX's
    exactly, with no host anchors mask (it is computed on the device)."""
    _, jctx, ctx = contexts
    p = clouds(2)[0]
    got, want = ctx.get_inference_input_dict(p), \
        jctx.get_inference_input_dict(p)
    assert set(got) == set(want) and "anchors_mask" not in got
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port `Trainer` on the tiny sparse pipeline after one synthetic
    step, its state and its checkpoint's directory."""
    tmp = tmp_path_factory.mktemp("trained")
    cfg_path = tiny_config(tmp, TINY_SPARSE_PIPELINE)
    tr = Trainer(cfg_path, tmp / "model", synthetic=True, dataset_size=4,
                 max_points=MAX_POINTS, total_steps=1,
                 patches=["train_config.steps_per_eval=0"], device="cpu")
    try:
        state = tr.train(1)
    finally:
        tr.logger.close()
    return cfg_path, tmp / "model", tr, state


def test_build_restores_the_trainers_checkpoint(trained):
    """A port `Trainer`'s checkpoint (one synthetic step on the tiny sparse
    pipeline) restored by `build(model_dir)`: the step restored, every
    parameter and statistic the trainer's, and the detections of a batch
    bitwise the trainer's own eval step's on the same prepared batch."""
    cfg_path, model_dir, tr, state = trained
    ctx = InferenceContext(cfg_path).build(model_dir,
                                           max_points=MAX_POINTS,
                                           device="cpu")
    assert ctx.restored_step == 1
    want_sd = state.module.state_dict()
    for k, v in ctx.module.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    pcs = clouds(4)
    batch = ctx.prep.collate([ctx._example(p, i) for i, p in enumerate(pcs)])
    with torch.no_grad():
        det = tr.eval_step(state, tr._to_device(batch, {}))
    for b, got in enumerate(ctx.inference_batch(pcs)):
        keep = det["valid"][b].numpy()
        np.testing.assert_array_equal(got["boxes"],
                                      det["boxes"][b].numpy()[keep])
        np.testing.assert_array_equal(got["scores"],
                                      det["scores"][b].numpy()[keep])
        np.testing.assert_array_equal(got["labels"],
                                      det["labels"][b].numpy()[keep])


def test_build_without_a_checkpoint(tmp_path):
    """An empty model_dir restores nothing and keeps flax's initialisers;
    the module is fp32 on a config that asks for mixed precision, as
    JAX's `build_voxelnet(cfg.model)` builds it."""
    cfg_path = tmp_path / "mixed.config"
    cfg_path.write_text(TINY_SPARSE_PIPELINE.replace(
        "train_config: {", "train_config: {\n  enable_mixed_precision: true"))
    ctx = InferenceContext(cfg_path).build(tmp_path / "none",
                                           max_points=MAX_POINTS,
                                           device="cpu")
    assert ctx.cfg.train_config.enable_mixed_precision
    assert ctx.restored_step is None and ctx.state.step == 0
    assert ctx.module.middle.dtype is None
    assert all(p.dtype == torch.float32 for p in ctx.module.parameters())
    det = ctx.inference(clouds(6)[0])
    assert np.isfinite(det["scores"]).all()


# ------------------------------------------------------------ box helpers


def _boxes(rng, n, lead=()):
    return np.concatenate([
        rng.uniform(-20, 20, lead + (n, 3)), rng.uniform(0.5, 4, lead + (n, 3)),
        rng.uniform(-np.pi, np.pi, lead + (n, 1))], -1).astype(np.float32)


def _calib(rng):
    """A KITTI-like rect, velo→cam and P2 (the synthetic calib's, jittered)."""
    from second_tpu_torch.data.synthetic import synthetic_calib
    rect, velo2cam, P2 = synthetic_calib((375, 1242))
    velo2cam = velo2cam.copy()
    velo2cam[:3, 3] += rng.normal(0, 0.1, 3)
    return [a.astype(np.float32) for a in (rect, velo2cam, P2)]


def _both(fn, *arrays, **kw):
    """fn of the port and of JAX on the same arrays → (port, JAX) numpy."""
    got = getattr(box_ops, fn)(*map(torch.from_numpy, arrays), **kw)
    want = getattr(jbox, fn)(*map(jnp.asarray, arrays), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rotation_3d_in_axis_matches_jax(axis):
    rng = np.random.default_rng(axis)
    pts = rng.normal(0, 5, (6, 8, 3)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    np.testing.assert_allclose(*_both("rotation_3d_in_axis", pts, ang,
                                      axis=axis), **BOX_TOL)


@pytest.mark.parametrize("origin,axis", [((0.5, 1.0, 0.5), 1),
                                         ((0.5, 0.5, 0.0), 2)])
def test_center_to_corner_box3d_and_standup_match_jax(origin, axis):
    """The 8 corners (3-D `corners_nd` and the rotation) and their standup
    boxes, in the camera and the lidar convention."""
    b = _boxes(np.random.default_rng(3), 10, (2,))
    got, want = _both("center_to_corner_box3d", b[..., :3], b[..., 3:6],
                      b[..., 6], origin=origin, axis=axis)
    assert got.shape == (2, 10, 8, 3)
    np.testing.assert_allclose(got, want, **BOX_TOL)
    np.testing.assert_allclose(*_both("corner_to_standup_nd", got),
                               **BOX_TOL)
    np.testing.assert_allclose(*_both("corners_nd", b[..., 3:6]), **BOX_TOL)
    np.testing.assert_allclose(*_both("corners_nd", b[..., 3:5]), **BOX_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_lidar_projection_matches_jax(seed):
    """lidar → camera → lidar, the image projection, the boxes to the
    camera frame and their image boxes: JAX's within BOX_TOL (of the
    values' scale for the pixels)."""
    rng = np.random.default_rng(seed)
    rect, velo2cam, P2 = _calib(rng)
    pts = np.concatenate([rng.uniform(5, 40, (50, 1)),
                          rng.uniform(-10, 10, (50, 1)),
                          rng.uniform(-2, 1, (50, 1))], 1).astype(np.float32)
    cam, jcam = _both("lidar_to_camera", pts, rect, velo2cam)
    np.testing.assert_allclose(cam, jcam, **BOX_TOL)
    back, jback = _both("camera_to_lidar", cam, rect, velo2cam)
    np.testing.assert_allclose(back, jback, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(back, pts, rtol=1e-4, atol=1e-4)
    uv, juv = _both("project_to_image", cam, P2)
    np.testing.assert_allclose(uv, juv, rtol=1e-5, atol=1e-3)
    boxes = _boxes(rng, 12)
    boxes[:, 0] = np.abs(boxes[:, 0]) + 8.0      # in front of the camera
    cb, jcb = _both("box_lidar_to_camera", boxes, rect, velo2cam)
    np.testing.assert_allclose(cb, jcb, **BOX_TOL)
    bb, jbb = _both("boxes3d_to_image_bbox", cb, P2)
    assert bb.shape == (12, 4)
    np.testing.assert_allclose(bb, jbb, rtol=1e-5, atol=1e-3)


def test_corners_nd_refuses_other_ranks():
    with pytest.raises(ValueError, match="2-D or 3-D"):
        box_ops.corners_nd(torch.ones(3, 4))


# ---------------------------------------------- tracking a detector's output


def test_tracking_detections_match_jax(contexts, tmp_path):
    """`TrackingTrainer._detections` with the tiny detector: one
    `inference_batch` a sequence through `nms_vid`, equal to JAX's
    `nms_vid(InferenceContext.inference_batch(...))` from the same weights
    (kept counts exact, boxes and scores within TOL); the trainer's
    prepared sequence carries those detections."""
    cfg_path, jctx, ctx = contexts
    tr = TrackingTrainer(tmp_path / "trk", num_frames=3, max_dets=6,
                         feature_dim=8, dataset_size=2,
                         detector_config=cfg_path,
                         detector_max_points=MAX_POINTS, device="cpu")
    tr.det_ctx.module.load_state_dict(ctx.module.state_dict())
    for s in range(2):
        frames = tr._sequence(s)
        for f in frames:
            # the tiny detector's range
            keep = (f["points"][:, 0] < 16) & (np.abs(f["points"][:, 1]) < 8)
            f["points"] = f["points"][keep]
        got = tr._detections(frames)
        want = [jtracking.nms_vid(d["boxes"], d["scores"])
                for d in jctx.inference_batch([f["points"] for f in frames])]
        assert len(got) == len(frames)
        assert sum(len(gs) for _, gs in got) > 0
        for (gb, gs), (wb, ws) in zip(got, want):
            assert len(gs) == len(ws)
            np.testing.assert_allclose(gb, wb, **TOL)
            np.testing.assert_allclose(gs, ws, **TOL)
        arrays = tr.prep(frames, np.random.default_rng(0), detections=got)
        n = arrays["det_valid"].sum(1)
        np.testing.assert_array_equal(n, [min(len(s_), 6) for _, s_ in got])


def test_tracking_trainer_with_a_detector_checkpoint(trained, tmp_path):
    """`run_tracking train` and `evaluate` with `--detector_config` and
    `--detector_dir` (a port `Trainer` checkpoint of the tiny sparse
    pipeline) on the CPU: the detector restored, finite losses, CLEAR-MOT
    with a finite MOTA."""
    from second_tpu_torch.train import run_tracking
    cfg_path, model_dir = trained[:2]
    args = ["--model_dir", str(tmp_path / "trk"), "--device", "cpu",
            "--num_frames", "3", "--max_dets", "6", "--feature_dim", "8",
            "--num_sequences", "1", "--detector_config", str(cfg_path),
            "--detector_dir", str(model_dir)]
    run_tracking.main(["train", *args, "--steps", "2"])
    summary = run_tracking.main(["evaluate", *args])
    assert np.isfinite(summary["mota"])
    trk = TrackingTrainer(tmp_path / "trk2", num_frames=3, max_dets=6,
                          feature_dim=8, dataset_size=1,
                          detector_config=cfg_path,
                          detector_dir=model_dir, device="cpu")
    assert trk.det_ctx.restored_step == 1


def test_new_entry_points_default_to_the_card(tmp_path):
    """With no CUDA card, the entry points of serving and joint tracking
    called without a device raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from second_tpu_torch.config import loads_pipeline_config
    from second_tpu_torch.models.joint_track import build_joint_det_track
    from second_tpu_torch.serve import build_server
    from second_tpu_torch.train.run_tracking import JointTrainer
    cfg_path = tiny_config(tmp_path, TINY_SPARSE_PIPELINE)
    for build in (lambda: InferenceContext(cfg_path).build(),
                  lambda: build_server(cfg_path, port=0),
                  lambda: JointTrainer(tmp_path / "j", cfg_path),
                  lambda: TrackingTrainer(tmp_path / "t",
                                          detector_config=cfg_path),
                  lambda: build_joint_det_track(
                      loads_pipeline_config(TINY_SPARSE_PIPELINE).model)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
