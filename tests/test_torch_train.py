"""Training in the port against the JAX package's, on the CPU: fp32 train
steps of the tiny sparse pipeline (`TINY_SPARSE_PIPELINE`: VFE-V3,
SpMiddleFHD, the RPN) from the same converted weights on the same batch,
with the loss, every gradient (through the converter), every parameter and
batch statistic held to JAX's `make_train_step`: three steps under momentum
SGD (the clip at 10 triggered), and `compute_loss` with and without the
direction classifier, one step under the config's Adam, from the same
eager gradient, and one mixed-precision step (its own eager run, in the
same process so that the two share their operations' compiles). The
`Trainer` is in `test_torch_trainer.py`.

JAX's step runs eagerly (`jax.disable_jit`), op by op. XLA's compilation of
the whole step moves some gradients by up to 6% of their tensor's largest
entry against JAX's own eager step (measured on this batch: batch-norm
backward sums that nearly cancel, fused in another order), while the eager
step and the port agree to 4.3e-5. Adam's first update is ±lr wherever
|g| is well above eps, so an entry whose gradient lies within that noise of
zero moves by 2·lr one way or the other; over three Adam steps the two
runs drift apart from there. So the three-step comparison uses momentum
SGD, whose update is linear in the gradient, and the Adam step is compared
where the gradient's sign is settled.

The first step's gradient does not depend on the optimizer (the same
weights, batch and forward), so JAX's Adam step is the recorded eager
gradient of the SGD run's first step under the config's optax Adam: one
eager run (its op-by-op compiles are most of this file's time) serves
both.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from second_tpu.data import ExamplePrep, PrepConfig
from second_tpu.data.synthetic import sample_scene
from second_tpu.models import build_voxelnet as jax_build_voxelnet
from second_tpu.models.detector import compute_loss as jax_compute_loss
from second_tpu.testing import TINY_SPARSE_PIPELINE, tiny_scene_kwargs
from second_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from second_tpu.train.state import TrainState as JTrainState
from second_tpu.train.state import VoxelizeSpec as JVoxelizeSpec
from second_tpu.train.state import device_voxelize as jax_device_voxelize
from second_tpu.train.state import make_train_step as jax_make_train_step
from second_tpu_torch.config import loads_pipeline_config
from second_tpu_torch.convert import grads_from_jax, state_dict_from_jax
from second_tpu_torch.models import build_voxelnet, compute_loss
from second_tpu_torch.ops.voxelize import VoxelizeSpec
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.state import TrainState, make_train_step

from test_torch_model import _random_variables

MAX_VOXELS = 2048
STEPS = 3
# the three-step optimizer: momentum SGD at a fixed lr
SGD_PATCH = dict(kind="momentum_optimizer", momentum_optimizer_value=0.9,
                 rates=[1e-3])
# fp32 tolerances, port against JAX (measured worst over the steps in
# brackets, see PERF.md): the loss and its parts 1e-5 relative; each
# gradient within 2e-4 of its tensor's largest entry (sums in another order
# through 14 sparse convs and the RPN); parameters 2e-6 absolute; batch
# statistics 1e-5.
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4
PARAM_ATOL = 2e-6
STAT_TOL = dict(rtol=1e-5, atol=1e-5)


@contextlib.contextmanager
def eager_compile_cache():
    """JAX's persistent compilation cache for every compile, however
    short, while JAX runs op by op: each operation's compile (some 1350 in
    a train step, 50 ms each) is written to the cache the JAX package sets
    up (`second_tpu/__init__.py`, `.jax_cache` at the repo root) and read
    by the next process that runs the same operation on the same shapes,
    as the test workers do. The executables are the same, so are the
    results; where the process runs without a cache directory, nothing
    changes."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 0.0)
    try:
        yield
    finally:
        jax.config.update(key, old)


def _config(optimizer=None, pipeline=TINY_SPARSE_PIPELINE):
    cfg = loads_pipeline_config(pipeline)
    if optimizer:
        opt = cfg.train_config.optimizer
        opt.kind = optimizer["kind"]
        opt.momentum_optimizer_value = optimizer["momentum_optimizer_value"]
        opt.learning_rate.kind = "manual_stepping"
        opt.learning_rate.rates = list(optimizer["rates"])
        opt.learning_rate.boundaries = []
    return cfg


def _tiny_batch(prep, n=2, seed=0):
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(n):
        p, b, names = sample_scene(rng, **tiny_scene_kwargs())
        examples.append(prep({"points": p, "gt_boxes": b, "gt_names": names},
                             rng))
    return prep.collate(examples)


def _recording(tx, sink):
    """`tx` behind a transformation that appends the gradients it is given
    to `sink`: JAX's train step hands its raw gradients to its optimizer,
    and eagerly they are concrete arrays."""
    def update(grads, state, params=None):
        sink.append(jax.device_get(grads))
        return grads, state
    return optax.chain(optax.GradientTransformation(lambda p: (), update),
                       tx)


def _jax_run(mixed, steps, optimizer=None, pipeline=TINY_SPARSE_PIPELINE):
    """JAX: the tiny model of `pipeline` (the sparse one unless another is
    given) from `_random_variables`, `steps` train steps of
    `make_train_step` on one batch, eagerly. Returns the batch, the initial
    variables and, per step, the metrics, the gradients and the variables
    after it."""
    cfg = _config(optimizer, pipeline)
    module, spec, info, assigner, _ = jax_build_voxelnet(
        cfg.model, mixed_precision=mixed)
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=3000, training=True))
    batch = {k: v for k, v in _tiny_batch(prep).items() if k != "image_idx"}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    vspec = JVoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS,
                                      shuffle_overflow=True)
    vox = jax_device_voxelize(vspec, jbatch["points"], jbatch["points_mask"])
    args = (vox["voxels"], vox["num_points"], vox["coordinates"],
            vox["voxel_valid"])
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    variables = _random_variables(shapes, np.random.default_rng(1))
    grads = []
    tx, _ = jax_build_optimizer(cfg.train_config.optimizer,
                                cfg.train_config.steps)
    tx = _recording(tx, grads)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"]),
                        opt_state=tx.init(params), tx=tx,
                        apply_fn=module.apply)
    step_fn = jax_make_train_step(spec, vspec)
    out = []
    for i in range(steps):
        # op by op: every bf16 cast rounds, and no whole-step fusion
        with jax.disable_jit(), eager_compile_cache():
            state, metrics = step_fn(state, jbatch)
        out.append(dict(loss=float(metrics["loss"]),
                        metrics=jax.device_get(metrics), grads=grads[i],
                        variables=jax.device_get(
                            {"params": state.params,
                             "batch_stats": state.batch_stats})))
    return batch, variables, out


def _port_run(batch, variables, mixed, steps, optimizer=None,
              pipeline=TINY_SPARSE_PIPELINE):
    """The port: the same weights, optimizer and batch through
    `make_train_step`; the gradients recorded as the optimizer receives
    them (before its clip)."""
    cfg = _config(optimizer, pipeline)
    net, spec, _, _, _ = build_voxelnet(cfg.model, device="cpu",
                                        mixed_precision=mixed)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt, lr_sched = build_optimizer(cfg.train_config.optimizer,
                                    cfg.train_config.steps, net.parameters())
    grads = []
    step_opt = opt.step

    def recording_step(count):
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
        return step_opt(count)
    opt.step = recording_step
    state = TrainState(net, opt, 0, lr_sched)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS,
                                     shuffle_overflow=True)
    step_fn = make_train_step(spec, vspec)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out = []
    for i in range(steps):
        state, metrics = step_fn(state, tbatch)
        out.append(dict(metrics={k: v.clone() for k, v in metrics.items()},
                        grads=grads[i],
                        state={k: v.clone()
                               for k, v in net.state_dict().items()}))
    assert state.step == steps
    return out


@pytest.fixture(scope="module")
def fp32_runs():
    """JAX's and the port's three SGD steps, the batch and the initial
    variables."""
    batch, variables, jout = _jax_run(False, STEPS, SGD_PATCH)
    return jout, _port_run(batch, variables, False, STEPS, SGD_PATCH), \
        batch, variables


def test_train_step_metrics_match_jax(fp32_runs):
    """Every metric of every step: the loss within 1e-5 relative and each
    of its parts within 1e-5 of it, the counts exact, the gradient norm
    (before the clip, which triggers: it is above 10) within 1e-4
    relative."""
    jout, tout = fp32_runs[:2]
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
        np.testing.assert_allclose(float(tm["loss"]), j["loss"],
                                   rtol=LOSS_RTOL)
        for k in ("num_pos", "voxel_overflow", "stage_overflow"):
            assert int(tm[k]) == int(jm[k]), (i, k)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(jm["grad_norm"]) > 10.0
    assert int(jout[0]["metrics"]["stage_overflow"]) > 0
    assert float(jout[-1]["loss"]) < float(jout[0]["loss"])


def test_train_step_grads_match_jax(fp32_runs):
    """Every parameter's gradient at every step, JAX's mapped through the
    converter: within GRAD_TOL of the tensor's largest entry."""
    jout, tout = fp32_runs[:2]
    for i, (j, t) in enumerate(zip(jout, tout)):
        want = grads_from_jax(j["grads"])
        assert set(want) == set(t["grads"])
        for name, w in want.items():
            g = t["grads"][name].numpy()
            scale = max(np.abs(w.numpy()).max(), 1e-12)
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=GRAD_TOL * scale,
                                       err_msg=f"step {i} {name}")
    sparse = [n for n in want if n.startswith("middle.") and
              n.endswith(".weight") and ".bn." not in n]
    assert len(sparse) == 14


def test_train_step_params_and_stats_match_jax(fp32_runs):
    """Parameters after each optimizer update within PARAM_ATOL, the running
    statistics of every norm within STAT_TOL."""
    jout, tout = fp32_runs[:2]
    for i, (j, t) in enumerate(zip(jout, tout)):
        want = state_dict_from_jax(j["variables"])
        got = t["state"]
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            tol = STAT_TOL if "running" in name else \
                dict(rtol=0, atol=PARAM_ATOL)
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), **tol,
                                       err_msg=f"step {i} {name}")


def _jax_adam_step(variables, jax_step):
    """JAX's step under the config's optimizer (one-cycle Adam, the clip)
    from `variables`, given the SGD run's first step `jax_step`: its
    recorded gradient through the config's optax chain, eagerly as the
    step applies it, and its batch statistics (the forward is the same).
    Returns the variables after the step."""
    cfg = _config()
    tx, _ = jax_build_optimizer(cfg.train_config.optimizer,
                                cfg.train_config.steps)
    params = jax.tree.map(jnp.asarray, variables["params"])
    grads = jax.tree.map(jnp.asarray, jax_step["grads"])
    with jax.disable_jit(), eager_compile_cache():
        updates, _ = tx.update(grads, tx.init(params), params)
        params = optax.apply_updates(params, updates)
    return {"params": jax.device_get(params),
            "batch_stats": jax_step["variables"]["batch_stats"]}


def test_adam_train_step_matches_jax(fp32_runs):
    """One step under the config's optimizer: one-cycle Adam (β2 0.99) with
    decoupled weight decay 0.01 and the clip. The loss and gradients as in
    the SGD steps; the parameters within PARAM_ATOL where the gradient is
    above 1e-3 of its tensor's largest entry (its sign settled: the two
    gradients agree to 4.3e-5 of it), and elsewhere within the most Adam's
    first step can move a parameter, lr · (2 + wd · |p|)."""
    jout, _, batch, variables = fp32_runs
    j = jout[0]
    t = _port_run(batch, variables, False, 1)[0]
    np.testing.assert_allclose(float(t["metrics"]["loss"]), j["loss"],
                               rtol=LOSS_RTOL)
    grads = grads_from_jax(j["grads"])
    want = state_dict_from_jax(_jax_adam_step(variables, j))
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


@pytest.mark.parametrize("use_dir", [True, False])
def test_compute_loss_matches_jax(use_dir):
    """`compute_loss` on random predictions and real targets, with and
    without the direction classifier: every output within 1e-6 relative."""
    cfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    cfg.model.use_direction_classifier = use_dir
    module, jspec, info, assigner, _ = jax_build_voxelnet(cfg.model)
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=3000, training=True))
    batch = _tiny_batch(prep, seed=4)
    _, tspec, _, _, _ = build_voxelnet(cfg.model, device="cpu")
    B, A = batch["labels"].shape
    rng = np.random.default_rng(5)
    preds = {"box_preds": rng.normal(0, 0.5, (B, A, 7)).astype(np.float32),
             "cls_preds": rng.normal(-2, 1, (B, A, 1)).astype(np.float32)}
    if use_dir:
        preds["dir_cls_preds"] = rng.normal(0, 1, (B, A, 2)).astype(
            np.float32)
    args = (batch["labels"], batch["reg_targets"], batch["anchors"])
    want = jax_compute_loss(jspec, {k: jnp.asarray(v)
                                    for k, v in preds.items()},
                            *map(jnp.asarray, args))
    got = compute_loss(tspec, {k: torch.from_numpy(v)
                               for k, v in preds.items()},
                       *map(torch.from_numpy, args))
    assert set(got) == set(want) and ("dir_loss_reduced" in got) == use_dir
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_iou_branch_is_refused():
    """The IoU branch, once refused here, is ported: the model builds with
    its IoU head and the detector spec carries the branch's loss (its
    parity with JAX: `test_torch_iou_branch.py`)."""
    cfg = loads_pipeline_config(TINY_SPARSE_PIPELINE)
    cfg.model.use_iou_branch = True
    net, spec, _, _, _ = build_voxelnet(cfg.model, device="cpu")
    assert spec.use_iou_branch and spec.iou_loss_fn is not None
    assert net.iou is not None and net.iou.out.out_channels == 2


def test_bf16_train_step_matches_jax():
    """One mixed-precision step (bf16 middle and RPN trunk, fp32 sums, norms
    and heads), JAX run eagerly so every bf16 cast rounds. bf16 keeps 8
    mantissa bits, and on this random-weight model the bf16 gradients of
    either framework lie some 30% (median relative norm over the tensors)
    from the fp32 gradients of the same weights (measured: port 0.33, JAX
    0.35): rounding flips activations at the ReLUs' zero and the flips grow
    through the 14 sparse convs. So the bound is the bf16 one: the loss
    within 3e-3 relative (measured 1.2e-3), and each gradient pointing the
    same way as JAX's, cosine at least 0.9 (measured 0.95 at the lowest),
    within 0.6 of its norm (measured 0.34 at the highest)."""
    batch, variables, jout = _jax_run(True, 1)
    tout = _port_run(batch, variables, True, 1)
    np.testing.assert_allclose(float(tout[0]["metrics"]["loss"]),
                               jout[0]["loss"], rtol=3e-3)
    want = grads_from_jax(jout[0]["grads"])
    assert set(want) == set(tout[0]["grads"])
    for name, w in want.items():
        w = w.numpy().ravel().astype(np.float64)
        g = tout[0]["grads"][name].numpy().ravel().astype(np.float64)
        assert np.isfinite(g).all(), name
        cos = (w @ g) / max(np.linalg.norm(w) * np.linalg.norm(g), 1e-30)
        assert cos >= 0.9, (name, cos)
        assert np.linalg.norm(g - w) <= 0.6 * np.linalg.norm(w), name
