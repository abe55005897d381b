"""Training the port's PointPillars against the JAX package's, on the CPU:
three fp32 momentum-SGD steps of `TINY_PIPELINE` (pillar encoder, BEV
scatter, 2-stage RPN) from the same converted weights on the same batch,
held to JAX's `make_train_step` run eagerly (the loss, every gradient,
every parameter and the encoder's and the RPN's batch statistics); one step
under the config's one-cycle AdamW, compared where the gradient's sign is
settled; the eval step's in-graph anchors mask against the host mask; and
the `Trainer` with the config's anchor-area mask in both readers; the
port's KITTI evaluation of frames without detections; and where the fp32
train step of the published config loses precision against fp64 (the ReLU
derivative at pre-activations within fp32 rounding of zero). Why the JAX
step runs eagerly and why SGD for three steps: see `test_torch_train.py`."""

import json
import pickle

import numpy as np
import pytest
import torch

from second_tpu.testing import TINY_PIPELINE, tiny_scene_kwargs
from second_tpu_torch.config import loads_pipeline_config
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.data import ExamplePrep, PrepConfig, sample_scene
from second_tpu_torch.data.synthetic import SyntheticDataset
from second_tpu_torch.models import (build_voxelnet, calibrate_norms_,
                                     compute_loss, init_train_weights_)
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize
from second_tpu_torch.utils import kitti_eval
from second_tpu_torch.train.run import (Trainer,
                                        _synthetic_lidar_to_camera_annos)
from second_tpu_torch.train.state import TrainState, make_eval_step

from test_torch_pointpillars import _quarter_config
from test_torch_train import (GRAD_TOL, LOSS_RTOL, PARAM_ATOL, SGD_PATCH,
                              STAT_TOL, STEPS, _jax_run, _port_run)
from test_torch_trainer import TRAINER_PATCHES


@pytest.fixture(scope="module")
def sgd_runs():
    batch, variables, jout = _jax_run(False, STEPS, SGD_PATCH, TINY_PIPELINE)
    return jout, _port_run(batch, variables, False, STEPS, SGD_PATCH,
                           TINY_PIPELINE)


def test_pointpillars_train_step_metrics_match_jax(sgd_runs):
    """Every metric of every step: the loss within LOSS_RTOL relative and
    each of its parts within LOSS_RTOL of it, the counts exact (the
    scatter's stage_overflow 0), the gradient norm within 1e-4 relative;
    the loss falls over the three steps."""
    jout, tout = sgd_runs
    for i, (j, t) in enumerate(zip(jout, tout)):
        jm, tm = j["metrics"], t["metrics"]
        assert set(tm) == set(jm), i
        loss = float(jm["loss"])
        np.testing.assert_allclose(float(tm["loss"]), loss, rtol=LOSS_RTOL)
        for k in ("cls_loss", "loc_loss", "cls_pos_loss", "cls_neg_loss",
                  "dir_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                       atol=LOSS_RTOL * loss,
                                       err_msg=f"{i} {k}")
        for k in ("num_pos", "voxel_overflow", "stage_overflow"):
            assert int(tm[k]) == int(jm[k]), (i, k)
        assert int(tm["stage_overflow"]) == 0
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert float(jout[-1]["loss"]) < float(jout[0]["loss"])


def test_pointpillars_train_step_grads_match_jax(sgd_runs):
    """Every parameter's gradient at every step, the encoder's Linear and
    norm among them, JAX's mapped through the converter: within GRAD_TOL of
    the tensor's largest entry; the encoder's and the first RPN conv's
    gradients are not zero."""
    jout, tout = sgd_runs
    for i, (j, t) in enumerate(zip(jout, tout)):
        want = grads_from_jax(j["grads"])
        assert set(want) == set(t["grads"])
        for name, w in want.items():
            g = t["grads"][name].numpy()
            scale = max(np.abs(w.numpy()).max(), 1e-12)
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=GRAD_TOL * scale,
                                       err_msg=f"step {i} {name}")
        for name in ("vfe.layers.0.linear.weight", "vfe.layers.0.norm.weight",
                     "rpn.trunk.convs.0.conv.weight"):
            assert np.abs(t["grads"][name].numpy()).max() > 0, name


def test_pointpillars_train_step_params_and_stats_match_jax(sgd_runs):
    """Parameters after each update within PARAM_ATOL; the running
    statistics of every norm (the encoder's 1-D norm over all B·V·T rows,
    and the RPN's) within STAT_TOL."""
    jout, tout = sgd_runs
    for i, (j, t) in enumerate(zip(jout, tout)):
        want = state_dict_from_jax(j["variables"])
        got = t["state"]
        running = [n for n in want if "running" in n]
        assert {"vfe.layers.0.norm.running_mean",
                "vfe.layers.0.norm.running_var"} <= set(running)
        assert any(n.startswith("rpn.") for n in running)
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            tol = STAT_TOL if "running" in name else \
                dict(rtol=0, atol=PARAM_ATOL)
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), **tol,
                                       err_msg=f"step {i} {name}")


def test_pointpillars_adam_train_step_matches_jax():
    """One step under the config's optimizer (one-cycle AdamW, β2 0.99,
    decoupled weight decay 0.01, the clip at 10): the loss and gradients as
    in the SGD steps; the parameters within PARAM_ATOL where the gradient
    is above 1e-3 of its tensor's largest entry (its sign settled), and
    elsewhere within the most Adam's first step can move a parameter,
    lr · (2 + wd · |p|); the norm statistics within STAT_TOL."""
    batch, variables, jout = _jax_run(False, 1, pipeline=TINY_PIPELINE)
    tout = _port_run(batch, variables, False, 1, pipeline=TINY_PIPELINE)
    j, t = jout[0], tout[0]
    np.testing.assert_allclose(float(t["metrics"]["loss"]), j["loss"],
                               rtol=LOSS_RTOL)
    grads = grads_from_jax(j["grads"])
    want = state_dict_from_jax(j["variables"])
    before = state_dict_from_jax(variables)
    lr = 3e-4                         # one-cycle at count 0: lr_max / 10
    settled = 0
    for name, g in grads.items():
        g = g.numpy()
        scale = np.abs(g).max()
        np.testing.assert_allclose(t["grads"][name].numpy(), g, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
        diff = np.abs(t["state"][name].numpy() - want[name].numpy())
        sure = np.abs(g) > 1e-3 * scale
        settled += int(sure.sum())
        assert np.all(diff[sure] <= PARAM_ATOL), name
        assert np.all(diff <= lr * (2 + 0.01 * np.abs(before[name].numpy()))
                      + PARAM_ATOL), name
    assert settled > 0.9 * sum(g.numel() for g in grads.values())
    for name in want:
        if "running" in name:
            np.testing.assert_allclose(t["state"][name].numpy(),
                                       want[name].numpy(), **STAT_TOL,
                                       err_msg=name)


def test_eval_step_in_graph_mask_equals_host_mask():
    """`make_eval_step` with `mask_info` (the mask computed on the device
    from the voxelizer's coords) gives the same detections as the same
    batch carrying the host's `anchors_mask` (which prunes some anchors),
    where voxel_overflow is 0."""
    cfg = loads_pipeline_config(TINY_PIPELINE)
    net, spec, info, assigner, _ = build_voxelnet(cfg.model, device="cpu",
                                                  seed=3)
    vg = cfg.model.voxel_generator
    kw = dict(max_points=3000, training=False, anchor_area_threshold=1,
              voxel_size=tuple(vg.voxel_size),
              pc_range=tuple(vg.point_cloud_range))
    host_prep = ExamplePrep(assigner, info.feature_map_size, PrepConfig(**kw))
    dev_prep = ExamplePrep(assigner, info.feature_map_size,
                           PrepConfig(device_anchors_mask=True, **kw))
    scenes = []
    rng = np.random.default_rng(2)
    for i in range(2):
        p, b, n = sample_scene(rng, **tiny_scene_kwargs())
        scenes.append({"points": p[p[:, 0] < 6.0 + 6.0 * i], "gt_boxes": b,
                       "gt_names": n})
    batches = [{k: torch.as_tensor(v) for k, v in prep.collate(
        [prep(s, np.random.default_rng(0)) for s in scenes]).items()
        if k != "image_idx"} for prep in (host_prep, dev_prep)]
    assert "anchors_mask" in batches[0] and "anchors_mask" not in batches[1]
    vspec = VoxelizeSpec.from_config(vg, 4096)
    vox = device_voxelize(vspec, batches[1]["points"],
                          batches[1]["points_mask"], "cpu")
    calibrate_norms_(net, vox["voxels"], vox["num_points"],
                     vox["coordinates"], vox["voxel_valid"])
    state = TrainState(net, None)
    mi = dev_prep.sat_mask_info()
    host = make_eval_step(spec, vspec)(state, batches[0])
    dev = make_eval_step(spec, vspec, mask_info=mi)(state, batches[1])
    assert int(dev["voxel_overflow"]) == 0
    for k in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(dev[k], host[k]), k
    hmask = batches[0]["anchors_mask"]
    assert 0 < int(hmask.sum()) < hmask.numel()
    assert 0 < int(dev["valid"].sum())


def test_pointpillars_trainer_trains_and_evaluates(tmp_path):
    """The `Trainer` on the tiny PointPillars config with the anchor-area
    mask at threshold 1 in both readers (which it refused before): two
    steps on synthetic scans with targets assigned under the host mask, a
    finite loss in the log, then `evaluate` with the in-graph mask writes
    result.pkl and one KITTI txt file a frame."""
    cfg_path = tmp_path / "tiny_pp.config"
    cfg_path.write_text(TINY_PIPELINE)
    patches = TRAINER_PATCHES + ["train_input_reader.anchor_area_threshold=1",
                                 "eval_input_reader.anchor_area_threshold=1"]
    tr = Trainer(str(cfg_path), tmp_path / "model", synthetic=True,
                 dataset_size=4, max_points=3000, total_steps=2,
                 patches=patches, device="cpu")
    try:
        assert tr._eval_mask_info is not None
        assert tr._eval_mask_info[2] == 1.0
        ex = tr.prep(tr.train_ds[0], np.random.default_rng(0))
        mask = ex["anchors_mask"]
        assert 0 < mask.sum() < mask.size
        assert (ex["labels"][~mask] == -1).all()
        state = tr.train(2)
        assert state.step == 2
        log = [json.loads(line) for line in
               (tmp_path / "model" / "log.json").read_text().splitlines()]
        assert [r["step"] for r in log] == [1, 2]
        assert np.isfinite(log[-1]["train.loss"])
        assert log[-1]["train.stage_overflow"] == 0
        tr.evaluate(state, max_frames=4)
        out = tmp_path / "model" / "eval_results" / "step_2"
        assert len(pickle.loads((out / "result.pkl").read_bytes())) == 4
        assert len(list((out / "txt").iterdir())) == 4
    finally:
        tr.logger.close()


def test_kitti_eval_takes_frames_without_detections():
    """A frame with cars but no detection (a young PointPillars model's
    eval under its initial norm statistics gives none): the fused
    statistics equal the per-threshold matching (every car a miss), where
    the copy of JAX's took an argmax over no detections and raised; and the
    official evaluation of such frames beside detected ones runs."""
    boxes = np.array([[10.0, 2.0, -1.0, 1.6, 3.9, 1.56, 0.3],
                      [20.0, -4.0, -1.0, 1.6, 3.9, 1.56, -1.2]])
    gt = _synthetic_lidar_to_camera_annos(boxes, ["Car", "Car"])
    empty = _synthetic_lidar_to_camera_annos(np.zeros((0, 7)), [], [])
    found = _synthetic_lidar_to_camera_annos(boxes[:1], ["Car"], [0.9])
    thresholds = np.linspace(0.05, 0.95, 41)
    for metric in (0, 1, 2):
        ov = kitti_eval._frame_overlaps([gt], [empty], metric)[0]
        nv, ig, idt, dc = kitti_eval.clean_data(gt, empty, 0, 0)
        gt_data = np.concatenate([gt["bbox"], gt["alpha"][:, None]], 1)
        dt_data = np.zeros((0, 6))
        ftp, ffp, ffn, fsim = kitti_eval.compute_statistics_fused(
            ov, gt_data, dt_data, ig, idt, dc, metric, 0.7, thresholds,
            compute_aos=True)
        for t, th in enumerate(thresholds):
            tp, fp, fn, sim, _ = kitti_eval.compute_statistics(
                ov, gt_data, dt_data, ig, idt, dc, metric, 0.7, thresh=th,
                compute_fp=True, compute_aos=True)
            assert (tp, fp, fn, sim) == (ftp[t], ffp[t], ffn[t], fsim[t])
        assert (ffn == int((ig == 0).sum())).all() and (ig == 0).sum() > 0
    text, detail = kitti_eval.get_official_eval_result(
        [gt, gt], [empty, found], ["Car"])
    assert "Car" in text and detail


def _relu_kink_step(dtype, monkeypatch, masks=None, record=None):
    """One train-mode forward and backward of the published PointPillars
    config (cropped to a quarter of its grid) in `dtype` on one synthetic
    scan, from flax's initialisers (seed 0): the loss and every parameter's
    gradient, in fp64. Every ReLU's mask (x > 0) is appended to `record`;
    with `masks`, each ReLU multiplies by the given mask instead."""
    cfg = loads_pipeline_config(_quarter_config())
    vg, reader = cfg.model.voxel_generator, cfg.train_input_reader
    net, spec, info, assigner, _ = build_voxelnet(
        cfg.model, device="cpu", mixed_precision=False, seed=0)
    init_train_weights_(net, 0)
    net.to(dtype).train()
    prep = ExamplePrep(assigner, info.feature_map_size, PrepConfig(
        max_points=20000, training=True, shuffle_points=reader.shuffle_points,
        anchor_area_threshold=reader.anchor_area_threshold,
        voxel_size=tuple(vg.voxel_size), pc_range=tuple(vg.point_cloud_range)))
    scan = SyntheticDataset(1, seed=1, pc_range=tuple(vg.point_cloud_range),
                            scan=True)[0]
    batch = {k: torch.as_tensor(v) for k, v in prep.collate(
        [prep(scan, np.random.default_rng(0))]).items() if k != "image_idx"}
    vspec = VoxelizeSpec.from_config(vg, reader.max_number_of_voxels,
                                     shuffle_overflow=True)
    vox = device_voxelize(vspec, batch["points"], batch["points_mask"], "cpu")
    relu, replay = torch.nn.functional.relu, iter(masks or ())

    def recording_relu(x, inplace=False):
        record.append(x.detach() > 0)
        return x * next(replay).to(x.dtype) if masks else relu(x)
    monkeypatch.setattr(torch.nn.functional, "relu", recording_relu)
    preds = net(vox["voxels"].to(dtype), vox["num_points"],
                vox["coordinates"], vox["voxel_valid"])
    loss = compute_loss(spec, preds, batch["labels"], batch["reg_targets"],
                        batch["anchors"].to(dtype))["loss"]
    loss.backward()
    monkeypatch.setattr(torch.nn.functional, "relu", relu)
    return float(loss.detach()), {n: p.grad.double() for n, p in
                                  net.named_parameters()}


def test_pointpillars_fp32_step_loses_precision_at_relu_kinks(monkeypatch):
    """Where the fp32 PointPillars train step loses precision (ROADMAP §3,
    F2). The published config (64-filter pillar encoder, 3-stage RPN, a
    quarter of its grid, one synthetic scan) in fp32 against fp64 from the
    same weights: the loss agrees within 1e-7 relative, yet the gradients
    differ by more than 1e-2 of their tensor's scale. The cause is a
    handful of ReLU inputs (fewer than 20 of over 3e7) whose sign differs
    between fp32 and fp64, each a pre-activation within fp32 rounding of
    zero: with the fp64 step's ReLU masks replayed, every fp32 gradient is
    within 1e-4 of fp64. The norms' fast variance and the loss sums over
    the anchors lose no more than that; the kink is the ReLU's, in JAX's
    semantics as in the port's, so no fp32 implementation avoids it."""
    masks64, masks32 = [], []
    loss64, g64 = _relu_kink_step(torch.float64, monkeypatch, record=masks64)
    loss32, g32 = _relu_kink_step(torch.float32, monkeypatch, record=masks32)
    assert abs(loss32 / loss64 - 1) < 1e-7
    assert len(masks32) == len(masks64) == 20      # encoder + 16 + 3 blocks
    flips = sum(int((a != b).sum()) for a, b in zip(masks32, masks64))
    assert 0 < flips < 20 and sum(m.numel() for m in masks32) > 3e7

    def err(g):
        return max(((g[k] - g64[k]).abs().max() /
                    g64[k].abs().max()).item() for k in g64)
    assert err(g32) > 1e-2
    _, g_replayed = _relu_kink_step(torch.float32, monkeypatch,
                                    masks=masks64, record=[])
    assert err(g_replayed) < 1e-4
