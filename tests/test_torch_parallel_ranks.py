"""What each rank runs in the multi-device tests (`test_torch_parallel.py`),
and the tests of the world launcher itself (`parallel/launch.py`).

The rank functions run in the children of `run_world`, on one thread each:
this module imports torch, numpy and the port only, never JAX, so a child
imports nothing else. Each takes its inputs from files the parent wrote
(numpy archives, a torch state dict) and returns numpy; `bundle` runs
several in one world, which the parent starts once.
"""

import os
import time

import numpy as np
import pytest
import torch

from second_tpu_torch.config import load_pipeline_config
from second_tpu_torch.models import build_temporal_voxelnet, build_voxelnet
from second_tpu_torch.models.rpn import RPN
from second_tpu_torch.ops.voxelize import VoxelizeSpec
from second_tpu_torch.parallel.eval_dp import (_local_stats,
                                               make_dp_eval_any,
                                               make_dp_eval_step)
from second_tpu_torch.parallel.launch import run_world
from second_tpu_torch.parallel.mesh import (globalise, make_dp_train_step,
                                            make_group, shard_batch)
from second_tpu_torch.parallel.spatial import gather_rows, \
    make_spatial_forward
from second_tpu_torch.parallel.temporal_sp import make_sp_sequence_forward
from second_tpu_torch.train.metrics import MetricsLogger
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.prefetch import PrefetchIterator
from second_tpu_torch.train.run import Trainer, apply_config_patches
from second_tpu_torch.train.state import TrainState, make_train_step
from second_tpu_torch.train.steps_multistage import make_temporal_steps


def tensors(path):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def config(cfg_path, patches=()):
    return apply_config_patches(load_pipeline_config(cfg_path), patches)


def one_stage(cfg, state_path):
    net, spec, *_ = build_voxelnet(cfg.model, device="cpu",
                                   mixed_precision=False)
    net.load_state_dict(torch.load(state_path), strict=True)
    return net, spec


def _train_state(cfg, state_path):
    net, spec = one_stage(cfg, state_path)
    opt, lr = build_optimizer(cfg.train_config.optimizer,
                              cfg.train_config.steps, net.parameters())
    return TrainState(net, opt, 0, lr), spec


def dp_train(cfg_path, patches, state_path, batch_path, max_voxels):
    """One data-parallel train step of the one-stage model on the global
    batch: its metrics (over the ranks) and the state after it. Then, on a
    group of this rank alone, two DP steps on this rank's slice against
    two plain steps: the largest difference of any state entry (0 where
    the all-reduces over one rank change no bit)."""
    cfg = config(cfg_path, patches)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, max_voxels,
                                     shuffle_overflow=True)
    state, spec = _train_state(cfg, state_path)
    step = make_dp_train_step(make_train_step(spec, vspec), make_group())
    batch = tensors(batch_path)
    state, metrics = step(state, batch)
    out = {"metrics": metrics, "state": dict(state.module.state_dict())}

    dist = torch.distributed
    rank, world = dist.get_rank(), dist.get_world_size()
    alone = [dist.new_group([r]) for r in range(world)][rank]
    local = shard_batch(batch, rank, world)
    dp_state, _ = _train_state(cfg, state_path)
    plain_state, _ = _train_state(cfg, state_path)
    dp_step = make_dp_train_step(make_train_step(spec, vspec), alone)
    plain_step = make_train_step(spec, vspec)
    for _ in range(2):
        dp_step(dp_state, local)
        plain_step(plain_state, local)
    a, b = dp_state.module.state_dict(), plain_state.module.state_dict()
    out["one_rank_diff"] = max(float((a[k].double() - b[k].double()).abs()
                                     .max()) for k in a)
    return out


def dp_eval(cfg_path, state_path, batch_path, mask_path, max_voxels):
    """`make_dp_eval_step` on the global batch with the in-graph anchors
    mask: the gathered detections and the reduced statistics."""
    cfg = config(cfg_path)
    net, spec = one_stage(cfg, state_path)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, max_voxels)
    m = np.load(mask_path)
    mask_info = (torch.from_numpy(m["corners"]), tuple(m["grid_hw"]),
                 float(m["threshold"]))
    det, stats = make_dp_eval_step(spec, vspec, make_group(), mask_info)(
        TrainState(net, None), tensors(batch_path))
    return {"det": det, "stats": stats}


def dp_eval_temporal(cfg_path, batch_path, max_voxels, proposals):
    """`make_dp_eval_any` around the temporal eval step (seeded weights),
    and the same eval step on the whole batch on this rank alone."""
    cfg = config(cfg_path)
    net, spec, *_ = build_temporal_voxelnet(cfg.model, proposals,
                                            device="cpu", seed=3)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, max_voxels)
    _, eval_step = make_temporal_steps(spec, vspec)
    state, batch = TrainState(net, None), tensors(batch_path)
    det, stats = make_dp_eval_any(eval_step, make_group())(state, batch)
    ref = eval_step(state, batch)
    return {"det": det, "stats": stats, "ref": ref,
            "ref_stats": _local_stats(ref)}


def spatial_rpn(rpn_kwargs, state_path, x_path, train=False):
    """The row-sharded RPN forward (eval, or with `train` train mode) on
    this rank's rows of x, the ranks' outputs gathered."""
    rpn = RPN(**rpn_kwargs)
    rpn.load_state_dict(torch.load(state_path), strict=True)
    group = make_group()
    x = tensors(x_path)["x"]
    rank, world = torch.distributed.get_rank(), \
        torch.distributed.get_world_size()
    h = x.shape[2] // world
    out = make_spatial_forward(rpn, group, train=train)(
        x[:, :, rank * h:(rank + 1) * h])
    return gather_rows(out, group)


def sp_sequence(cfg_path, state_path, frames_path, proposals):
    """The sequence-parallel forward on this rank's frames, the ranks'
    outputs gathered."""
    cfg = config(cfg_path)
    net = build_temporal_voxelnet(cfg.model, proposals, device="cpu",
                                  sequence=True)[0]
    net.load_state_dict(torch.load(state_path), strict=True)
    inputs = tensors(frames_path)
    anchors = inputs.pop("anchors")
    group = make_group()
    rank, world = torch.distributed.get_rank(), \
        torch.distributed.get_world_size()
    preds = make_sp_sequence_forward(net, group)(
        shard_batch(inputs, rank, world), anchors)
    return globalise(preds, group)


def _no_tensorboard(trainer):
    """Rank 0's logger writing its log files without TensorBoard
    summaries: their first record imports TensorBoard (and TensorFlow),
    some 20 s on an idle host, which rank 0 alone would pay inside the
    world while the other rank waits at a collective."""
    if trainer.is_chief:
        trainer.logger.close()
        trainer.logger = MetricsLogger(trainer.model_dir,
                                       use_tensorboard=False)


def trainer_first_step(cfg_path, model_dir, batch_size, patches):
    """A `Trainer` on the group (no TensorBoard summaries): whether it took
    the data-parallel path, and the loss of its first train step on its
    first global batch."""
    trainer = Trainer(cfg_path, model_dir, synthetic=True, dataset_size=8,
                      max_points=2000, device="cpu",
                      patches=[f"train_input_reader.batch_size={batch_size}",
                               *patches])
    _no_tensorboard(trainer)
    batch = next(trainer._batch_iter(batch_size, np.random.default_rng(0)))
    _, metrics = trainer.train_step(trainer._init_state(), batch)
    trainer.logger.close()
    return {"data_parallel": trainer._train_group is not None,
            "loss": metrics["loss"]}


def trainer_steps(cfg_path, model_dir, batch_size, steps, evaluate=False,
                  stream=False):
    """A `Trainer`'s `train` over `steps` steps (no TensorBoard
    summaries), its input made by 4 prefetch workers: for each step the sum
    of the points of the global batch it took and the step's loss. With
    `stream`, first the sums of the first `steps` global batches as its
    reader makes them; with `evaluate`, then `evaluate` over 4 frames,
    detections written without scoring (`predict_test`): its reduced
    statistics."""
    trainer = Trainer(cfg_path, model_dir, synthetic=True, dataset_size=8,
                      max_points=2000, device="cpu",
                      patches=[f"train_input_reader.batch_size={batch_size}",
                               "train_input_reader.num_workers=4",
                               "eval_input_reader.num_workers=1"])
    _no_tensorboard(trainer)
    out = {}
    if stream:
        batches = trainer._batch_iter(batch_size, np.random.default_rng(0))
        out["stream"] = [float(next(batches)["points"].double().sum())
                         for _ in range(steps)]
    step, seen = trainer.train_step, []

    def recorded(state, batch):
        state, metrics = step(state, batch)
        seen.append((float(batch["points"].double().sum()),
                     float(metrics["loss"])))
        return state, metrics

    trainer.train_step = recorded
    state = trainer.train(total_steps=steps)
    out.update(data_parallel=trainer._train_group is not None,
               seen=np.array(seen))
    if evaluate:
        trainer.evaluate(state, max_frames=4, predict_test=True)
        out["eval_stats"] = trainer._last_eval_stats
    trainer.logger.close()
    return out


def bundle(jobs):
    """Each (function name of this module, args) of `jobs`, in order:
    their results. Each job's seconds go to the rank's log."""
    out = []
    for name, args in jobs:
        t0 = time.monotonic()
        out.append(globals()[name](*args))
        print(f"job {name} {time.monotonic() - t0:.1f} s", flush=True)
    return out


# ------------------------------------------------------- the launcher


def test_run_world_returns_each_ranks_result(tmp_path):
    """Two gloo ranks, each returning its rank (a child that imports only
    torch)."""
    assert run_world("torch.distributed:get_rank", 2, tmp_path,
                     deadline=60) == [0, 1]


def test_run_world_kills_a_world_past_its_deadline(tmp_path):
    """A world that outlives its deadline is killed and raises: a hang
    fails the test, not the run."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        run_world("time:sleep", 2, tmp_path, args=(600,), deadline=5)
    assert time.monotonic() - t0 < 30


def test_run_world_raises_a_ranks_error(tmp_path):
    """A rank that raises ends the world at once, with its traceback."""
    with pytest.raises(RuntimeError, match="invalid literal"):
        run_world("builtins:int", 2, tmp_path, args=("x",), deadline=60)


def test_shard_batch_slices_and_refuses_indivisible():
    batch = {"a": torch.arange(6).reshape(6, 1), "b": np.arange(6)}
    got = shard_batch(batch, 1, 3)
    assert got["a"].flatten().tolist() == [2, 3] and \
        got["b"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(batch, 0, 4)


def test_prefetch_hands_out_batches_in_the_order_they_were_made():
    """4 workers making batches faster than a slow consumer takes them (the
    queue full, workers racing to enqueue): the batches still come out in
    the order they were made, as a data-parallel step's ranks need."""
    made = iter(range(10 ** 6))
    batches = PrefetchIterator(lambda: next(made), num_workers=4,
                               prefetch_size=2)
    got = []
    try:
        for i in range(300):
            if i % 50 == 0:
                time.sleep(0.02)
            got.append(next(batches))
    finally:
        batches.close()
    assert got == list(range(300))


def _here():
    """This module's directory, for the children's `sys.path`."""
    return os.path.dirname(os.path.abspath(__file__))
