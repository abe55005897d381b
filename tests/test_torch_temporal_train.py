"""The temporal detector's train step in the port against the JAX
package's, on the CPU, on the tiny sparse pipeline (`test_torch_temporal.py`
has the forward, the eval step, the sequence model, the converter and the
`Trainer`): one step of JAX's `make_temporal_steps`, jitted, in fp64,
against the port's in fp64 (the loss, every gradient, the gate's among
them, and the running statistics of a backbone that pools both frames in
one batch) and in fp32."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from second_tpu.train.state import TrainState as JTrainState
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.steps_multistage import \
    make_temporal_steps as jax_make_temporal_steps
from second_tpu_torch import convert
from second_tpu_torch.convert import state_dict_from_jax
from second_tpu_torch.models import compute_temporal_loss
from second_tpu_torch.ops.voxelize import VoxelizeSpec
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.state import TrainState
from second_tpu_torch.train.steps_multistage import make_temporal_steps

from test_torch_multiclass import GRAD64_TOL, _rel_err
from test_torch_temporal import (MAX_VOXELS, _jax_frames, _models,
                                 _pair_batch, _port_frames, _t, _variables,
                                 one_thread)
from test_torch_train import LOSS_RTOL, SGD_PATCH

# two fp32 backward passes of the same forward on the CPU: the sparse
# middle's backward sums in threads, in no fixed order (1.03e-6 of a
# tensor's scale seen between two runs)
STEP_GRAD_TOL = 1e-5


def _grads_as_params():
    """An optax transformation whose update takes the parameters to the
    gradient it receives (g - p, added to p): after one step of JAX's
    jitted train step the state's params are the gradients the optimizer
    was given, which a jitted step cannot hand out otherwise."""
    return optax.GradientTransformation(
        lambda params: optax.EmptyState(),
        lambda grads, state, params: (jax.tree.map(
            lambda g, p: g - p, grads, params), state))


def _jax_step64(jmod, jspec, jcfg, variables, batch):
    """One step of JAX's `make_temporal_steps` train step, jitted, in fp64
    (x64 on, and `jnp.float32` read as fp64 while the step is traced, as
    `test_torch_multiclass.jax_grads64` does): its metrics, the gradients
    (`_grads_as_params`) and the batch statistics after it, by the port's
    names."""
    vspec = JVoxelizeSpec.from_config(jcfg.model.voxel_generator, MAX_VOXELS)

    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f"
                           else a)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jnp, "float32", jnp.float64)
        v = jax.tree.map(f64, variables)
        tx = _grads_as_params()
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                            batch_stats=v["batch_stats"],
                            opt_state=tx.init(v["params"]), tx=tx,
                            apply_fn=jmod.apply)
        train_step, _ = jax_make_temporal_steps(jspec, vspec)
        state, metrics = train_step(state, {k: f64(x)
                                            for k, x in batch.items()})
        grads, stats = jax.device_get((state.params, state.batch_stats))
        assert jax.tree.leaves(grads)[0].dtype == np.float64
    with pytest.MonkeyPatch.context() as mp:
        # the converter's names, the values kept fp64
        mp.setattr(convert, "_t", lambda a: torch.from_numpy(
            np.array(a, dtype=np.float64)))
        stats = convert.state_dict_from_jax({"params": grads,
                                             "batch_stats": stats})
        grads = convert.grads_from_jax(grads)
    return jax.device_get(metrics), grads, stats


def _port_step(net, spec, cfg, batch, dtype):
    """One step of the port's `make_temporal_steps` train step on a copy of
    `net` in `dtype` under momentum SGD: its metrics, the gradients the
    optimizer receives, the state dict after it."""
    net = copy.deepcopy(net).to(dtype)
    opt, lr_sched = build_optimizer(cfg.train_config.optimizer,
                                    cfg.train_config.steps, net.parameters())
    grads = []
    step_opt = opt.step

    def recording_step(count):
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
        return step_opt(count)
    opt.step = recording_step
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    train_step, _ = make_temporal_steps(spec, vspec)
    b = {k: _t(v) for k, v in batch.items()}
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
    _, metrics = train_step(TrainState(net, opt, 0, lr_sched), b)
    return metrics, grads[0], net.state_dict()


@pytest.fixture(scope="module")
def step_runs():
    """One batch of two pairs, random weights, the proposals' NMS allowed
    the positive anchors and a tenth of the others (so some positive is
    among the NUM_PROPOSALS proposals and the stage-2 losses count): JAX's
    train step in fp64 (`_jax_step64`), the port's in fp64 and in fp32, one
    backward of the port's fp32 loss, and the statistics of the current
    frame alone through a train-mode backbone."""
    jcfg, cfg, jmod, jspec, net, spec, info, assigner = _models(SGD_PATCH)
    batch = _pair_batch(info, assigner, seed=1)
    rng = np.random.default_rng(2)
    batch["anchors_mask"] = (batch["labels"] > 0) | \
        (rng.uniform(size=batch["labels"].shape) < 0.1)
    _, cur, prev = _jax_frames(jcfg, batch)
    variables = _variables(jmod, cur, prev, jnp.asarray(batch["anchors"]))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with one_thread():
        tcur, tprev = _port_frames(cfg, batch)
        ref = copy.deepcopy(net).train()
        b = {k: _t(v) for k, v in batch.items()}
        preds = ref(tcur, tprev, b["anchors"],
                    anchors_mask=b["anchors_mask"])
        compute_temporal_loss(spec, preds, b["labels"], b["reg_targets"],
                              b["anchors"], b["gt_boxes_padded"],
                              b["gt_valid"])["loss"].backward()
        alone = copy.deepcopy(net).double().train()
        with torch.no_grad():
            alone.backbone({k: v.double() if v.is_floating_point() else v
                            for k, v in tcur.items()})
        port = {str(d)[6:]: _port_step(net, spec, cfg, batch, d)
                for d in (torch.float64, torch.float32)}
    return dict(jax=_jax_step64(jmod, jspec, jcfg, variables, batch),
                **port,
                backward={n: p.grad for n, p in ref.named_parameters()},
                alone=alone.state_dict(),
                voxel_overflow=int(tcur["voxel_overflow"]) +
                int(tprev["voxel_overflow"]))


def test_temporal_batch_stats_fold_both_frames(step_runs):
    """The running statistics after one train step: every norm's (the
    sparse middle's masked norms and the RPN's) within 1e-10 of JAX's in
    fp64, whose backbone pools both frames in one batch; the current frame
    alone gives the middle other statistics."""
    want = step_runs["jax"][2]
    got, alone = step_runs["float64"][2], step_runs["alone"]
    names = [n for n in want if "running" in n]
    assert any(n.startswith("middle.") for n in names) and \
        any(n.startswith("rpn.") for n in names)
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    middle = [n for n in names if n.startswith("middle.")]
    assert max(float((alone[n] - got[n]).abs().max()) for n in middle) > 1e-4


def test_temporal_loss_and_grads_match_jax(step_runs):
    """The port's fp64 step against JAX's: the metrics (JAX's keys plus the
    stage-2 direction loss and the overflow counts) within 1e-10 of the
    loss, the counts exact, the stage-2 losses counting positives, the
    gradient norm within 1e-6 (the port sums it in fp32); every gradient within GRAD64_TOL of its
    scale, the gate's (which only the fused map reaches) and the refine
    head's among them, nonzero; voxel_overflow counts both frames."""
    jm, jgrads, _ = step_runs["jax"]
    tm, grads, _ = step_runs["float64"]
    assert set(tm) == set(jm) | {"second_dir_loss", "voxel_overflow",
                                 "stage_overflow"}
    loss = float(jm["loss"])
    assert int(tm["second_num_pos"]) > 0
    for k in jm:
        if k in ("num_pos", "second_num_pos"):
            assert int(tm[k]) == int(jm[k]), k
        elif k == "grad_norm":
            # the port's global norm sums in fp32 (`train/optimizer.py`)
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        else:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                       atol=1e-10 * loss, err_msg=k)
    assert int(tm["voxel_overflow"]) == step_runs["voxel_overflow"]
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert g.dtype == torch.float64
        assert _rel_err(g, jgrads[name]) < GRAD64_TOL, name
    for name in ("bev_fusion.conv_gating_bev.weight",
                 "second_rpn.conv_cls_second.weight",
                 "middle.subm.0.weight"):
        assert grads[name].abs().max() > 0, name


def test_temporal_steps_match_jax(step_runs):
    """The port's fp32 `make_temporal_steps` train step: its loss and its
    parts within LOSS_RTOL of JAX's fp64 step's loss, the counts exact, the
    gradients the optimizer receives those of one backward of
    `compute_temporal_loss` on both frames (within STEP_GRAD_TOL of their
    scale) and grad_norm their global norm."""
    jm = step_runs["jax"][0]
    tm, tgrads, _ = step_runs["float32"]
    want = step_runs["backward"]
    loss = float(jm["loss"])
    for k in jm:
        if k in ("num_pos", "second_num_pos"):
            assert int(tm[k]) == int(jm[k]), k
        elif k != "grad_norm":
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                       atol=LOSS_RTOL * loss, err_msg=k)
    for name, g in tgrads.items():
        assert _rel_err(g, want[name]) < STEP_GRAD_TOL, name
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in want.values()))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(norm),
                               rtol=STEP_GRAD_TOL)
