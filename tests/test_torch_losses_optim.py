"""The port's losses (`second_tpu_torch/models/losses.py`) and optimizer stack
(`second_tpu_torch/train/optimizer.py`) against the JAX package's, on the
CPU, with inputs made from numpy seeds: every loss and its builder,
`prepare_loss_weights` under each norm type, every schedule's value at
every step of a short run, the global-norm clip, and one and three updates
of each optimizer against optax with the clip triggered and weight decay
on."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from second_tpu.models import losses as jl
from second_tpu.train import optimizer as jopt
from second_tpu_torch.models import losses as tl
from second_tpu_torch.train import optimizer as topt

TOL = dict(rtol=1e-6, atol=1e-6)       # fp32, the same formulas
RNG = np.random.default_rng


def _inputs(seed, C=3):
    rng = RNG(seed)
    logits = rng.normal(0, 2, (2, 50, C)).astype(np.float32)
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, (2, 50))]
    preds = rng.normal(0, 1, (2, 50, 7)).astype(np.float32)
    targets = rng.normal(0, 1, (2, 50, 7)).astype(np.float32)
    weights = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    return logits, onehot, preds, targets, weights


def _both(jfn, tfn, *arrays, **kw):
    want = jfn(*map(jnp.asarray, arrays), **kw)
    got = tfn(*map(torch.from_numpy, arrays), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return got


CLS_CASES = [
    ("sigmoid_cross_entropy_with_logits", "labels", {}),
    ("weighted_sigmoid_loss", "weights", {}),
    ("sigmoid_focal_loss", "weights", {}),
    ("sigmoid_focal_loss", "weights", dict(gamma=0.0, alpha=None)),
    ("sigmoid_focal_loss", "weights", dict(gamma=1.5, alpha=0.5)),
    ("softmax_focal_loss", "weights", {}),
    ("softmax_focal_loss", "weights", dict(gamma=1.0, alpha=None)),
    ("weighted_softmax_loss", "weights", dict(logit_scale=2.0)),
    ("bootstrapped_sigmoid_loss", "weights", {}),
    ("bootstrapped_sigmoid_loss", "weights",
     dict(alpha=0.3, bootstrap_type="hard")),
]


@pytest.mark.parametrize("name,kind,kw", CLS_CASES)
def test_classification_losses_match_jax(name, kind, kw):
    logits, onehot, _, _, weights = _inputs(0)
    args = (logits, onehot) if kind == "labels" else \
        (logits, onehot, weights)
    _both(getattr(jl, name), getattr(tl, name), *args, **kw)


@pytest.mark.parametrize("name,kw", [
    ("weighted_smooth_l1_loss", {}),
    ("weighted_smooth_l1_loss", dict(sigma=1.0)),
    ("weighted_smooth_l1_loss",
     dict(sigma=3.0, code_weights=[1, 1, 2, 1, 1, 1, 0.5])),
    ("weighted_l2_loss", {}),
    ("weighted_l2_loss", dict(code_weights=[1, 2, 1, 1, 1, 1, 1])),
])
def test_localization_losses_match_jax(name, kw):
    _, _, preds, targets, weights = _inputs(1)
    got = _both(getattr(jl, name), getattr(tl, name), preds, targets, weights,
                **kw)
    assert got.shape == preds.shape


def test_bootstrapped_loss_rejects_unknown_type():
    logits, onehot, _, _, weights = _inputs(2)
    with pytest.raises(ValueError):
        tl.bootstrapped_sigmoid_loss(torch.from_numpy(logits),
                                     torch.from_numpy(onehot),
                                     torch.from_numpy(weights),
                                     bootstrap_type="medium")


@pytest.mark.parametrize("norm", ["NormByNumExamples", "NormByNumPositives",
                                  "NormByNumPosNeg"])
@pytest.mark.parametrize("pos_w,neg_w", [(1.0, 1.0), (2.0, 0.5)])
def test_prepare_loss_weights_matches_jax(norm, pos_w, neg_w):
    """Every norm type, with an example that has no positives (the clamp
    at 1) and ignored anchors (-1)."""
    rng = RNG(3)
    labels = rng.choice([-1, 0, 0, 0, 1, 2], size=(3, 40)).astype(np.int32)
    labels[2] = np.where(labels[2] > 0, 0, labels[2])
    want = jl.prepare_loss_weights(jnp.asarray(labels), pos_w, neg_w, norm)
    got = tl.prepare_loss_weights(torch.from_numpy(labels), pos_w, neg_w,
                                  norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_prepare_loss_weights_rejects_unknown_norm():
    with pytest.raises(ValueError):
        tl.prepare_loss_weights(torch.zeros(1, 3, dtype=torch.int32),
                                loss_norm_type="NormByNothing")


@pytest.mark.parametrize("cfg", [
    SimpleNamespace(kind="weighted_sigmoid_focal", gamma=2.0, alpha=0.25),
    SimpleNamespace(kind="weighted_sigmoid"),
    SimpleNamespace(kind="weighted_softmax_focal", gamma=2.0, alpha=0.25),
    SimpleNamespace(kind="weighted_softmax", logit_scale=1.5),
    SimpleNamespace(kind="bootstrapped_sigmoid", alpha=0.5,
                    hard_bootstrap=True),
    SimpleNamespace(kind="bootstrapped_sigmoid", alpha=0.5),
], ids=lambda c: c.kind + ("_hard" if getattr(c, "hard_bootstrap", 0)
                           else ""))
def test_classification_builder_matches_jax(cfg):
    logits, onehot, _, _, weights = _inputs(4)
    _both(jl.build_classification_loss(cfg),
          tl.build_classification_loss(cfg), logits, onehot, weights)


@pytest.mark.parametrize("cfg", [
    SimpleNamespace(kind="weighted_smooth_l1", sigma=3.0, code_weight=[]),
    SimpleNamespace(kind="weighted_smooth_l1", sigma=2.0,
                    code_weight=[1, 1, 1, 2, 2, 2, 1]),
    SimpleNamespace(kind="weighted_l2", code_weight=[]),
], ids=["smooth_l1", "smooth_l1_code_weights", "l2"])
def test_localization_builder_matches_jax(cfg):
    _, _, preds, targets, weights = _inputs(5)
    _both(jl.build_localization_loss(cfg), tl.build_localization_loss(cfg),
          preds, targets, weights)


def test_builders_reject_unknown_kinds():
    with pytest.raises(ValueError):
        tl.build_classification_loss(SimpleNamespace(kind="hinge"))
    with pytest.raises(ValueError):
        tl.build_localization_loss(SimpleNamespace(kind="l1",
                                                   code_weight=[]))


# ---------------------------------------------------------------- schedules

TOTAL = 20
# The port evaluates the schedules in Python floats; JAX's functions are
# evaluated in float64 here (`jax.enable_x64`), so the two compute the same
# function at the same precision. In float32, as optax evaluates them in
# training, JAX's values differ from these by float32 rounding, up to
# 1.4e-6 relative (measured).
SCHED_RTOL = 1e-7


def _lr_cfg(**kw):
    base = dict(kind="one_cycle", boundaries=[], rates=[1e-4], lr_max=3e-3,
                moms=[0.95, 0.85], div_factor=10.0, pct_start=0.4,
                phases=[])
    base.update(kw)
    return SimpleNamespace(**base)


def _values(fn, jax_side, x64=True):
    steps = range(TOTAL + 2)
    if jax_side:
        with jax.enable_x64(x64):
            dtype = jnp.int64 if x64 else jnp.int32
            return np.array([float(fn(jnp.asarray(c, dtype)))
                             for c in steps])
    return np.array([fn(c) for c in steps])


def test_one_cycle_schedules_match_jax():
    """lr and β1 at every count from 0 to past the end."""
    cfg = _lr_cfg()
    (jlr, jmom), (tlr, tmom) = (jopt.one_cycle_schedules(cfg, TOTAL),
                                topt.one_cycle_schedules(cfg, TOTAL))
    for j, t in ((jlr, tlr), (jmom, tmom)):
        np.testing.assert_allclose(_values(t, False), _values(j, True),
                                   rtol=SCHED_RTOL, atol=0)


def test_manual_stepping_matches_optax_exactly():
    """optax's piecewise constant at int(b · total) boundaries, scales from
    the count at the boundary on: the same float32 values, to the bit."""
    cfg = _lr_cfg(kind="manual_stepping", rates=[1e-4, 1e-5, 3e-6],
                  boundaries=[0.35, 0.8])
    want = _values(jopt.manual_stepping_schedule(cfg, TOTAL), True, False)
    got = _values(topt.manual_stepping_schedule(cfg, TOTAL), False)
    np.testing.assert_array_equal(got, want)
    assert got[6] == got[0] != got[7]          # boundary int(0.35 · 20) = 7


PHASES = [
    {"start": 0.0, "lambda_func": "lambda p: annealing_cos(1e-4, 1e-3, p)",
     "momentum_lambda_func": "lambda p: annealing_cos(0.95, 0.85, p)"},
    {"start": 0.3, "lambda_func": "lambda p: 1e-3 * math.cos(p)"},
    {"start": 0.7, "lambda_func": "lambda p: annealing_cos(1e-3, 1e-6, p)",
     "momentum_lambda_func": "lambda p: 0.85 + 0.1 * p"},
]


def test_multi_phase_schedules_match_jax():
    """The lambda strings evaluated in the restricted namespace; the last
    phase that has started wins."""
    cfg = _lr_cfg(kind="multi_phase", phases=PHASES)
    (jlr, jmom), (tlr, tmom) = (jopt.multi_phase_schedules(cfg, TOTAL),
                                topt.multi_phase_schedules(cfg, TOTAL))
    for j, t in ((jlr, tlr), (jmom, tmom)):
        np.testing.assert_allclose(_values(t, False), _values(j, True),
                                   rtol=SCHED_RTOL, atol=0)


def test_multi_phase_namespace_has_no_builtins():
    cfg = _lr_cfg(kind="multi_phase", phases=[
        {"start": 0.0, "lambda_func": "lambda p: open('x')"}])
    lr, _ = topt.multi_phase_schedules(cfg, TOTAL)
    with pytest.raises(NameError):
        lr(0)


@pytest.mark.parametrize("staircase,burnin", [(True, 0), (False, 0),
                                              (True, 4)])
def test_exponential_decay_matches_jax(staircase, burnin):
    args = (1e-3, 5, 0.5, staircase, 2e-4, burnin)
    np.testing.assert_allclose(
        _values(topt.exponential_decay_schedule(*args), False),
        _values(jopt.exponential_decay_schedule(*args), True),
        rtol=SCHED_RTOL, atol=0)


@pytest.mark.parametrize("warmup", [0, 5])
def test_cosine_decay_with_warmup_matches_jax(warmup):
    args = (1e-3, TOTAL, 1e-5, warmup)
    np.testing.assert_allclose(
        _values(topt.cosine_decay_with_warmup_schedule(*args), False),
        _values(jopt.cosine_decay_with_warmup_schedule(*args), True),
        rtol=SCHED_RTOL, atol=1e-12)


@pytest.mark.parametrize("kind", ["one_cycle", "manual_stepping",
                                  "multi_phase"])
def test_build_lr_schedules_dispatch(kind):
    cfg = _lr_cfg(kind=kind, phases=PHASES, rates=[1e-4, 1e-5],
                  boundaries=[0.5])
    jl_, jm = jopt.build_lr_schedules(cfg, TOTAL)
    tl_, tm = topt.build_lr_schedules(cfg, TOTAL)
    assert (jm is None) == (tm is None)
    np.testing.assert_allclose(_values(tl_, False), _values(jl_, True),
                               rtol=SCHED_RTOL, atol=0)
    with pytest.raises(ValueError):
        topt.build_lr_schedules(_lr_cfg(kind="triangular"), TOTAL)


# ---------------------------------------------------------------- updates

SHAPES = [(4, 3), (7,), (2, 2, 5)]
UPDATE_TOL = dict(rtol=1e-6, atol=1e-6)


def _params_and_grads(seed, steps, scale):
    rng = RNG(seed)
    params = [rng.normal(0, 1, s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(0, scale, s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return params, grads


def _run_optax(tx, params, grads):
    p = [jnp.asarray(x) for x in params]
    state = tx.init(p)
    out = []
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, p)
        p = optax.apply_updates(p, upd)
        out.append([np.asarray(x) for x in p])
    return out


def _run_port(opt_cfg, params, grads):
    p = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in params]
    opt, _ = topt.build_optimizer(opt_cfg, TOTAL, p)
    out, norms = [], []
    for c, g in enumerate(grads):
        for t, x in zip(p, g):
            t.grad = torch.from_numpy(x.copy())
        norms.append(float(opt.step(c)))
        out.append([t.detach().numpy().copy() for t in p])
    return out, norms


def _opt_cfg(kind, lr_kind="one_cycle", weight_decay=0.01, **kw):
    return SimpleNamespace(
        kind=kind, learning_rate=_lr_cfg(kind=lr_kind, rates=[2e-3],
                                         boundaries=[]),
        weight_decay=weight_decay, momentum_optimizer_value=0.9, decay=0.9,
        epsilon=1e-8, fixed_weight_decay=True, **kw)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("kind,lr_kind,wd", [
    ("adam_optimizer", "one_cycle", 0.01),
    ("adam_optimizer", "manual_stepping", 0.01),
    ("adam_optimizer", "manual_stepping", 0.0),
    ("momentum_optimizer", "one_cycle", 0.01),
    ("rms_prop_optimizer", "manual_stepping", 0.0),
])
def test_optimizer_updates_match_optax(steps, kind, lr_kind, wd):
    """Gradients of global norm about 50, so the clip at 10 triggers; the
    parameters after each update within 1e-6. RMSProp's eps sits under the
    root in optax and outside it in torch (the module docstring): with
    ν ≈ 0.1 · g² ≈ 25 against eps = 1e-8 the two agree within that bound."""
    cfg = _opt_cfg(kind, lr_kind, wd)
    params, grads = _params_and_grads(6, steps, scale=10.0)
    tx, _ = jopt.build_optimizer(cfg, TOTAL)
    want = _run_optax(tx, params, grads)
    got, norms = _run_port(cfg, params, grads)
    for step, (g_step, w_step) in enumerate(zip(got, want)):
        for g, w in zip(g_step, w_step):
            np.testing.assert_allclose(g, w, **UPDATE_TOL,
                                       err_msg=f"update {step}")
    assert min(norms) > 10.0
    np.testing.assert_allclose(
        norms[0], float(optax.global_norm([jnp.asarray(x)
                                           for x in grads[0]])), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Below the limit the gradients stay as they are, to the bit; above
    it, optax's (g / ‖g‖) · 10."""
    _, grads = _params_and_grads(7, 1, scale)
    g = [torch.from_numpy(x.copy()) for x in grads[0]]
    norm = topt.clip_by_global_norm_(g, 10.0)
    tx = optax.clip_by_global_norm(10.0)
    want, _ = tx.update([jnp.asarray(x) for x in grads[0]], tx.init(None))
    for a, b in zip(g, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    if scale < 1:
        assert float(norm) < 10.0
        for a, b in zip(g, grads[0]):
            np.testing.assert_array_equal(a.numpy(), b)
    else:
        assert float(norm) > 10.0


def test_missing_gradients_update_like_zero_gradients():
    """optax updates every leaf: a parameter without a gradient is stepped
    with zeros (its weight decay and moments move on), as in JAX."""
    cfg = _opt_cfg("adam_optimizer")
    params, grads = _params_and_grads(8, 2, scale=1.0)
    for g in grads:
        g[1] = np.zeros_like(g[1])
    tx, _ = jopt.build_optimizer(cfg, TOTAL)
    want = _run_optax(tx, params, grads)
    p = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in params]
    opt, _ = topt.build_optimizer(cfg, TOTAL, p)
    for c, g in enumerate(grads):
        opt.zero_grad()
        for i in (0, 2):
            p[i].grad = torch.from_numpy(g[i].copy())
        opt.step(c)
    for a, b in zip(p, want[-1]):
        np.testing.assert_allclose(a.detach().numpy(), b, **UPDATE_TOL)
    assert not np.array_equal(p[1].detach().numpy(), params[1])


def test_build_optimizer_rejects_unknown_kind():
    with pytest.raises(ValueError):
        topt.build_optimizer(_opt_cfg("lion_optimizer"), TOTAL,
                             [torch.nn.Parameter(torch.zeros(2))])
