"""The tracking-by-detection branch in the port against the JAX package, on
the CPU: the host copies (`utils/assignment.py`, `utils/mot_metrics.py`,
`core/nms_np.py`, `data/tracking.py`'s prep) exactly equal to JAX's on
seeded inputs; the nets against flax with converted weights;
`generate_gt`, `tracking_loss` and its gradient against `jax.grad`;
`nms_vid` against JAX's; the id managers (`Tracker`, `MemoryTracker`,
`SequenceStitcher`) against JAX's on one synthetic sequence; the
`TrackingTrainer` against JAX's from the same converted parameters; and
the CLI's refused flags."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from second_tpu.core import nms_np as jnms_np
from second_tpu.data import tracking as jtracking
from second_tpu.models import tracking as jtrk
from second_tpu.models import tracking_train as jtt
from second_tpu.train.run_tracking import TrackingTrainer as JTrainer
from second_tpu.utils import assignment as jassignment
from second_tpu.utils import mot_metrics as jmot
from second_tpu_torch.convert import tracking_state_dict_from_jax
from second_tpu_torch.core import nms_np
from second_tpu_torch.data import tracking
from second_tpu_torch.models import tracking as trk
from second_tpu_torch.models import tracking_train as tt
from second_tpu_torch.train import run_tracking
from second_tpu_torch.utils import assignment, mot_metrics

# the nets in fp32 against flax's: the same dense layers and convs, sums in
# another order
NET_TOL = dict(rtol=1e-5, atol=1e-5)
# the loss and its gradient, fp32
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)


def _equal(a, b, path=""):
    """Nested dicts / lists / arrays equal in value, dtype and shape."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# ------------------------------------------------------------ host copies


@pytest.mark.parametrize("case", ["plain", "det_scores", "mask", "greedy"])
def test_assignment_matches_jax(case):
    """`solve_frame_pair` (with and without the det keep rewards, with a
    link mask) and `greedy_solve` on seeded scores: JAX's outputs
    exactly."""
    rng = np.random.default_rng(10)
    for n1, n2 in ((4, 5), (6, 3), (1, 1), (0, 3)):
        link = rng.normal(size=(n1, n2))
        end, new = rng.normal(size=n1), rng.normal(size=n2)
        if case == "greedy":
            _equal(assignment.greedy_solve(link, 0.1),
                   jassignment.greedy_solve(link, 0.1))
            continue
        kw = {}
        if case == "det_scores":
            kw = dict(det_scores_prev=rng.normal(size=n1),
                      det_scores_cur=rng.normal(size=n2))
        elif case == "mask":
            kw = dict(link_mask=rng.uniform(size=(n1, n2)) < 0.6)
        _equal(assignment.solve_frame_pair(link, end, new, **kw),
               jassignment.solve_frame_pair(link, end, new, **kw))


def test_mot_metrics_match_jax():
    """`MOTAccumulator` over a sequence with misses, false positives and an
    id switch, and `iou_distance`: JAX's numbers exactly."""
    rng = np.random.default_rng(11)
    acc, jacc = mot_metrics.MOTAccumulator(), jmot.MOTAccumulator()
    centers = rng.uniform(0, 40, (5, 2))
    for t in range(6):
        centers = centers + rng.normal(0, 0.3, centers.shape)
        gt = np.concatenate([centers - 1, centers + 1], 1)
        keep = rng.uniform(size=5) < 0.8
        dt = gt[keep] + rng.normal(0, 0.2, (keep.sum(), 4))
        ids = list(np.flatnonzero(keep))
        if t == 3 and len(ids) > 1:
            ids[0], ids[1] = ids[1], ids[0]
        dt = np.concatenate([dt, rng.uniform(0, 40, (1, 4))])
        ids.append(100 + t)
        for a in (acc, jacc):
            a.update(list(range(5)), gt, ids, dt)
        _equal(mot_metrics.iou_distance(gt, dt), jmot.iou_distance(gt, dt))
    assert acc.summary() == jacc.summary()
    assert acc.summary()["id_switches"] > 0


def test_nms_np_matches_jax():
    """The host NMS (`greedy_nms` rotated and standup, `soft_nms` Gaussian
    and linear) and `data/tracking.nms_vid`: JAX's keeps and scores
    exactly."""
    rng = np.random.default_rng(12)
    ctr = rng.uniform(0, 20, (40, 2))
    boxes = np.concatenate([ctr, rng.uniform(1, 4, (40, 2)),
                            rng.uniform(-np.pi, np.pi, (40, 1))], 1)
    scores = rng.uniform(size=40)
    xyxy = np.concatenate([ctr - 1.5, ctr + 1.5], 1)
    for rotated, b in ((True, boxes), (False, xyxy)):
        _equal(nms_np.greedy_nms(b, scores, 0.2, rotated, max_out=9),
               jnms_np.greedy_nms(b, scores, 0.2, rotated, max_out=9))
    for method in ("gaussian", "linear"):
        _equal(nms_np.soft_nms(xyxy, scores, method=method),
               jnms_np.soft_nms(xyxy, scores, method=method))
    boxes7 = np.concatenate([ctr, np.full((40, 1), -1.7),
                             rng.uniform(1, 4, (40, 3)),
                             rng.uniform(-np.pi, np.pi, (40, 1))],
                            1).astype(np.float32)
    _equal(tracking.nms_vid(boxes7, scores.astype(np.float32)),
           jtracking.nms_vid(boxes7, scores.astype(np.float32)))


@pytest.mark.parametrize("camera", [False, True])
def test_tracking_prep_matches_jax(camera):
    """`SyntheticTrackingDataset` sequences (with the synthetic camera and
    without) and `TrackingPrep` on them, given generators of the same
    seed: every frame and every prepared array exactly JAX's, the det↔gt
    matching and the simulated detections among them."""
    kw = dict(size=2, seed=3, num_frames=3, with_image=camera,
              num_cars=(3, 6), num_ground=2000)
    ds, jds = tracking.SyntheticTrackingDataset(**kw), \
        jtracking.SyntheticTrackingDataset(**kw)
    prep = tracking.TrackingPrep(tracking.TrackingPrepConfig(max_dets=8))
    jprep = jtracking.TrackingPrep(jtracking.TrackingPrepConfig(max_dets=8))
    for i in range(2):
        frames, jframes = ds[i], jds[i]
        _equal(frames, jframes, f"seq {i}")
        got = prep(frames, np.random.default_rng(i))
        want = jprep(jframes, np.random.default_rng(i))
        _equal(got, want, f"prep {i}")
        assert got["det_valid"].any() and (got["det_cls"] == 1).any()


# ------------------------------------------------------------------- nets


def _track_inputs(T=3, D=4, P=16, seed=13):
    rng = np.random.default_rng(seed)
    crops = rng.normal(size=(T, D, 24, 24, 3)).astype(np.float32)
    points = rng.normal(size=(T, D, P, 3)).astype(np.float32)
    pmask = rng.uniform(size=(T, D, P)) < 0.7
    pmask[0, 1] = False              # a detection with no points
    return crops, points, pmask


@pytest.fixture(scope="module")
def seq_nets():
    """JAX's `SequenceTrackNet` (feature dim 32) from flax's initialisers,
    the port's with the converted weights, and their outputs on seeded
    inputs."""
    crops, points, pmask = _track_inputs()
    jnet = jtrk.SequenceTrackNet(feature_dim=32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), crops, points,
                                pmask)["params"]
    jout = jax.device_get(jax.jit(lambda p, *a: jnet.apply(
        {"params": p}, *a))(params, crops, points, pmask))
    net = trk.SequenceTrackNet(feature_dim=32)
    net.load_state_dict(tracking_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out = net(torch.from_numpy(crops), torch.from_numpy(points),
                  torch.from_numpy(pmask))
    return dict(params=params, jout=jout, out=out, net=net, jnet=jnet,
                inputs=(crops, points, pmask))


def test_sequence_track_net_matches_flax(seq_nets):
    """Every output of the sequence net (embeddings, det, link, end and new
    logits) within NET_TOL of flax's; a detection with no points embeds
    the point branch as 0 (the masked max's -inf → 0)."""
    out, jout = seq_nets["out"], seq_nets["jout"]
    assert set(out) == set(jout)
    for k in out:
        assert out[k].shape == jout[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   **NET_TOL, err_msg=k)
    crops, points, pmask = seq_nets["inputs"]
    with torch.no_grad():
        feat = seq_nets["net"].point_net(torch.from_numpy(points[0]),
                                         torch.from_numpy(pmask[0]))
    assert (feat[1] == 0).all() and (feat[0] != 0).any()


def test_pair_track_net_matches_flax(seq_nets):
    """The pairwise `TrackNet` from the same parameters (the submodule
    names are the sequence net's) on frames 0 and 1: within NET_TOL of
    flax's, and its affinities those of the sequence net's first pair."""
    crops, points, pmask = seq_nets["inputs"]
    args = (crops[0], points[0], pmask[0], crops[1], points[1], pmask[1])
    jnet = jtrk.TrackNet(feature_dim=32)
    jout = jax.device_get(jax.jit(lambda p, *a: jnet.apply(
        {"params": p}, *a))(seq_nets["params"], *args))
    net = trk.TrackNet(feature_dim=32)
    net.load_state_dict(seq_nets["net"].state_dict(), strict=True)
    with torch.no_grad():
        out = net(*map(torch.from_numpy, args))
    assert set(out) == set(jout)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   **NET_TOL, err_msg=k)
    np.testing.assert_allclose(out["link_scores"].numpy(),
                               seq_nets["out"]["link_logits"][0].numpy(),
                               **NET_TOL)


def test_appearance_pools_to_one_cell():
    """flax's VALID 2x2 max pool floors 24 → 12 → 6 → 3 → 1; the port's
    does too: a 24-pixel crop reaches the global pool as one cell, and a
    25-pixel one as well (25 → 12 → ...)."""
    net = trk.AppearanceNet(16)
    for size in (24, 25):
        x = torch.zeros(2, size, size, 3)
        seen = []
        h = net.Conv_7.register_forward_hook(
            lambda m, i, o: seen.append(o.shape[-2:]))
        with torch.no_grad():
            assert net(x).shape == (2, 16)
        h.remove()
        assert tuple(seen[0]) == (3, 3)


# ---------------------------------------------------------- training loss


def _sequence_gt(T=4, D=6, seed=14):
    rng = np.random.default_rng(seed)
    det_id = rng.integers(-1, 4, (T, D))
    det_cls = rng.choice([-1, 0, 1, 1, 1], (T, D)).astype(np.int8)
    det_valid = rng.uniform(size=(T, D)) < 0.85
    logits = [rng.normal(size=s).astype(np.float32)
              for s in ((T - 1, D, D), (T - 1, D), (T - 1, D), (T, D))]
    return det_cls, det_id, det_valid, logits


def test_generate_gt_and_tracking_loss_match_jax():
    """`generate_gt` exactly JAX's; `tracking_loss` (det BCE, the row and
    column link soft-maxes) within LOSS_TOL, and its gradient with respect
    to every logit within LOSS_TOL of `jax.grad`'s."""
    det_cls, det_id, det_valid, logits = _sequence_gt()
    gt = tt.generate_gt(det_cls, det_id, det_valid)
    jgt = jtt.generate_gt(det_cls, det_id, det_valid)
    assert set(gt) == set(jgt)
    for k in gt:
        np.testing.assert_array_equal(gt[k].numpy(), np.asarray(jgt[k]),
                                      err_msg=k)
    assert gt["gt_link"].sum() > 0 and gt["gt_new"].sum() > 0

    def jloss(*lg):
        return jtt.tracking_loss(*lg, jgt, det_cls, det_valid)
    want = jax.jit(jloss)(*map(jnp.asarray, logits))
    jgrads = jax.jit(jax.grad(lambda *lg: jloss(*lg)["loss"],
                              argnums=(0, 1, 2, 3)))(*map(jnp.asarray,
                                                          logits))
    tl = [torch.from_numpy(x).requires_grad_() for x in logits]
    got = tt.tracking_loss(*tl, gt, torch.from_numpy(det_cls),
                           torch.from_numpy(det_valid))
    got["loss"].backward()
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   **LOSS_TOL, err_msg=k)
    for t, g in zip(tl, jgrads):
        assert np.abs(np.asarray(g)).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **LOSS_TOL)


def test_match_dets_to_gt_and_nms_vid_match_jax():
    """`match_dets_to_gt` (the host det↔gt matching) exactly JAX's; the
    port's `nms_vid` (its rotated NMS, the plain versions on the CPU) keeps
    JAX's detections, boxes and scores within 1e-6."""
    rng = np.random.default_rng(15)
    gt = rng.uniform(0, 30, (6, 2))
    gt_bev = np.concatenate([gt - 1, gt + 1], 1)
    det_bev = np.concatenate([gt_bev[:4] + rng.normal(0, 0.2, (4, 4)),
                              rng.uniform(0, 30, (3, 4))])
    names = np.array(["Car", "Car", "DontCare", "Van", "Car", "Car"])
    args = (det_bev, gt_bev, np.arange(6) + 10, names)
    _equal(tt.match_dets_to_gt(*args), jtt.match_dets_to_gt(*args))
    n = 64
    ctr = rng.uniform(0, 12, (n, 2))
    boxes = np.concatenate([ctr, np.full((n, 1), -1.7),
                            rng.uniform(1.5, 4, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))],
                           1).astype(np.float32)
    cls = rng.normal(0, 2, (n, 1)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    jb, js, jk = jax.device_get(jax.jit(
        lambda b, c, v: jtt.nms_vid(b, c, v, post_max_size=32))(
            jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid)))
    b, s, k = tt.nms_vid(torch.from_numpy(boxes), torch.from_numpy(cls),
                         torch.from_numpy(valid), post_max_size=32)
    np.testing.assert_array_equal(k.numpy(), jk)
    assert 0 < jk.sum() < valid.sum()
    np.testing.assert_allclose(b.numpy()[jk], jb[jk], rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=1e-6)


# ------------------------------------------------------------- id managers


def test_trackers_and_stitcher_match_jax():
    """`Tracker`, `MemoryTracker` and `SequenceStitcher` driven by the same
    matches and windows on a synthetic sequence: the ids JAX's, frame by
    frame, and the memory's track features."""
    rng = np.random.default_rng(16)
    pairs = [(trk.Tracker(), jtrk.Tracker()),
             (trk.MemoryTracker(), jtrk.MemoryTracker())]
    stitch, jstitch = trk.SequenceStitcher(), jtrk.SequenceStitcher()
    n_prev = 0
    for t in range(6):
        n = int(rng.integers(2, 6))
        m = min(n, n_prev)
        matches = np.stack([rng.permutation(n_prev)[:m],
                            rng.permutation(n)[:m]], -1).astype(np.int64) \
            if m else np.zeros((0, 2), np.int64)
        feats = rng.normal(size=(n, 8))
        for ours, theirs in pairs:
            arg = feats if isinstance(ours, trk.MemoryTracker) else n
            _equal(ours.step(matches, arg), theirs.step(matches, arg),
                   f"frame {t} {type(ours).__name__}")
        n_prev = n
    _equal(pairs[1][0].track_feats, pairs[1][1].track_feats)
    for w0 in (0, 2, 5):            # overlapping, then discontinuous
        ids = [rng.integers(0, 5, 3) for _ in range(3)]
        loc = rng.normal(size=(3, 3, 3))
        dets = [{"frame_idx": w0 + i, "location": loc[i]} for i in range(3)]
        if w0 == 2:
            dets[0] = {"frame_idx": 2, "location":
                       jstitch.frames_det[-1]["location"][::-1].copy()}
        _equal(stitch.update(ids, dets, list(range(w0, w0 + 3))),
               jstitch.update(ids, dets, list(range(w0, w0 + 3))),
               f"window {w0}")
    _equal(stitch.frames_id, jstitch.frames_id)


# ---------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """JAX's and the port's `TrackingTrainer` (3 frames, 8 detections,
    feature dim 16, synthetic sequences, seed 0), the port's net loaded
    with JAX's initial parameters."""
    kw = dict(num_frames=3, max_dets=8, feature_dim=16, dataset_size=4)
    jtr = JTrainer(tmp_path_factory.mktemp("jax"), **kw)
    tr = run_tracking.TrackingTrainer(tmp_path_factory.mktemp("port"), **kw,
                                      device="cpu")
    tr.net.load_state_dict(tracking_state_dict_from_jax(jtr.params),
                           strict=True)
    return jtr, tr


def test_tracking_trainer_matches_jax(trainers):
    """From the same parameters: evaluate's CLEAR-MOT summary JAX's
    exactly (simple and memory trackers, and the windowed evaluation);
    then two Adam steps, the first loss within 1e-5 of JAX's (the same
    prepared sequence), and evaluate's summary keys JAX's."""
    jtr, tr = trainers
    for kind in ("simple", "memory"):
        assert tr.evaluate(2, tracker_kind=kind) == \
            jtr.evaluate(2, tracker_kind=kind), kind
    assert tr.evaluate_windowed(2, num_sequences=2) == \
        jtr.evaluate_windowed(2, num_sequences=2)
    res, jres = tr.train(2, log_every=1), jtr.train(2, log_every=1)
    np.testing.assert_allclose(res["first_loss"], jres["first_loss"],
                               rtol=1e-5)
    assert np.isfinite(res["last_loss"])
    summary = tr.evaluate(1)
    assert set(summary) == set(jtr.evaluate(1)) and "mota" in summary
    assert (tr.model_dir / "tracking_results" / "val" / "0000.txt").exists()


def test_tracking_cli_and_refused_flags(tmp_path, capsys):
    """`run_tracking` train then evaluate (memory tracker, a 2-frame window)
    on the CPU restores the checkpoint and prints CLEAR-MOT; the detector
    flags are refused where they cannot run: `--with_detector` without
    `--detector_config` is a usage error, a `--detector_config` that does
    not exist raises (`tests/test_torch_joint_track.py` and
    `tests/test_torch_inference_ctx.py` run both paths)."""
    args = ["--model_dir", str(tmp_path), "--device", "cpu", "--steps", "1",
            "--num_frames", "3", "--max_dets", "6", "--feature_dim", "8",
            "--num_sequences", "1"]
    run_tracking.main(["train", *args])
    assert (tmp_path / "tracknet-1.pt").exists()
    out = run_tracking.main(["evaluate", *args, "--tracker", "memory"])
    assert "mota" in out and "id_switches" in out
    assert "mota" in run_tracking.main(["evaluate", *args, "--window", "2"])
    assert '"windowed": true' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run_tracking.main(["train", *args, "--with_detector"])
    for extra in ([], ["--with_detector"]):
        with pytest.raises(FileNotFoundError):
            run_tracking.main(["train", *args, *extra, "--detector_config",
                               str(tmp_path / "missing.config")])
