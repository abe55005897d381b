"""Optimizer + LR/momentum schedules — the port of
`second_tpu/train/optimizer.py`, all of it.

The reference's fastai optimizer stack (`optimizer_builder.py` +
`learning_schedules_fastai.py`): Adam (β2 = 0.99, eps 1e-8) with decoupled
weight decay, global-norm gradient clipping at 10 (`train.py:349`), and the
OneCycle / ManualStepping / MultiPhase / exponential-decay / cosine
schedules. OneCycle follows the fastai recipe: cosine lr_max/div → lr_max
over pct_start, then lr_max → lr_max/div/1e4, with β1 annealed moms[0] →
moms[1] → moms[0].

A schedule is a function of the update count c = 0, 1, ... returning a
Python float: the update at count c uses lr(c), from c = 0, as optax's
`inject_hyperparams` does. `build_optimizer` returns a `ClippedOptimizer`
over a torch optimizer:

  * `adam_optimizer` → `torch.optim.AdamW(betas=(β1, 0.99), eps=1e-8,
    weight_decay=wd)`. The JAX chain is clip → scale_by_adam →
    add_decayed_weights(wd) → scale by −lr, i.e. p − lr · (adam + wd · p)
    whether or not `fixed_weight_decay` is set (the code, not its comment);
    AdamW's p · (1 − lr · wd) − lr · adam is the same update. One-cycle's
    β1 of count c goes into the param group before the step.
  * `momentum_optimizer` → `torch.optim.SGD(momentum=m)`: optax's
    `trace` then −lr, one to one (the first buffer is the gradient).
  * `rms_prop_optimizer` → `torch.optim.RMSprop(alpha=decay, eps=epsilon,
    momentum=m)`. Not one to one in eps: optax divides by sqrt(ν + eps)
    (`eps_in_sqrt=True`), torch by sqrt(ν) + eps; they agree where eps is
    small against ν.

The weight decay of the momentum and RMSProp optimizers is ignored, as in
JAX. The clip is optax's `clip_by_global_norm`: g unchanged where ‖g‖ <
10, else (g / ‖g‖) · 10, computed on the device (no host sync; torch's
`clip_grad_norm_` adds 1e-6 to the norm).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import schema


def _annealing_cos(start, end, pct):
    return end + (start - end) / 2 * (math.cos(math.pi * pct) + 1)


def _clip01(x):
    return min(max(x, 0.0), 1.0)


def one_cycle_schedules(cfg: schema.LearningRateConfig, total_steps: int
                        ) -> Tuple[Callable, Callable]:
    lr_max = cfg.lr_max
    low = lr_max / cfg.div_factor
    split = int(total_steps * cfg.pct_start)
    moms = list(cfg.moms) if cfg.moms else [0.95, 0.85]

    def lr(step):
        if step < split:
            pct = _clip01(step / max(split, 1))
            return lr_max + (low - lr_max) / 2 * (math.cos(math.pi * pct) + 1)
        pct = _clip01((step - split) / max(total_steps - split, 1))
        return low / 1e4 + (lr_max - low / 1e4) / 2 * \
            (math.cos(math.pi * pct) + 1)

    def mom(step):
        if step < split:
            pct = _clip01(step / max(split, 1))
            return moms[1] + (moms[0] - moms[1]) / 2 * \
                (math.cos(math.pi * pct) + 1)
        pct = _clip01((step - split) / max(total_steps - split, 1))
        return moms[0] + (moms[1] - moms[0]) / 2 * \
            (math.cos(math.pi * pct) + 1)

    return lr, mom


def manual_stepping_schedule(cfg: schema.LearningRateConfig,
                             total_steps: int) -> Callable:
    """optax's `piecewise_constant_schedule(rates[0], {int(b · total):
    rates[i + 1] / rates[i]})`: each scale applies from the count at its
    boundary on, multiplied in float32 in boundary order as optax does, so
    the values are optax's to the bit."""
    boundaries = [int(b * total_steps) for b in cfg.boundaries]
    rates = list(cfg.rates)
    assert len(boundaries) + 1 == len(rates)
    scales = [np.float32(rates[i + 1] / rates[i])
              for i in range(len(boundaries))]

    def sched(step):
        v = np.float32(rates[0])
        for b, s in zip(boundaries, scales):
            if step >= b:
                v = np.float32(s * v)
        return float(v)
    return sched


def _phase_namespace():
    """Names available inside multi_phase lambda strings (the reference
    eval's them verbatim, `learning_schedules_fastai.py:21-22`; the usual
    body is `annealing_cos`). `np` and `jnp` both name numpy here, so the
    lambda strings written for the JAX package evaluate unchanged."""
    return {"annealing_cos": _annealing_cos, "math": math, "np": np,
            "jnp": np, "torch": torch, "__builtins__": {}}


def _compile_phases(phase_items, total_steps):
    """[(start_frac, lambda_str)] → step→value schedule with the reference's
    last-matching-phase-wins semantics (`LRSchedulerStep.step`)."""
    ns = _phase_namespace()
    spans = []
    for i, (start, fn_str) in enumerate(phase_items):
        s = int(start * total_steps)
        e = (int(phase_items[i + 1][0] * total_steps)
             if i < len(phase_items) - 1 else total_steps)
        spans.append((s, max(e, s + 1), eval(fn_str, ns)))
    assert spans[0][0] == 0, "first multi_phase phase must start at 0"

    def sched(step):
        s0, e0, f0 = spans[0]
        val = f0(step / (e0 - s0))
        for s, e, f in spans[1:]:
            if step >= s:
                val = f((step - s) / (e - s))
        return float(val)
    return sched


def multi_phase_schedules(cfg: schema.LearningRateConfig, total_steps: int
                          ) -> Tuple[Callable, Optional[Callable]]:
    """The reference's MultiPhase schedule (`optimizer.proto`
    LearningRatePhase {start, lambda_func, momentum_lambda_func};
    `learning_schedules_fastai.py:8-46`)."""
    lr_items = [(float(p.get("start", 0.0)), p["lambda_func"])
                for p in cfg.phases]
    lr_sched = _compile_phases(lr_items, total_steps)
    mom_items = [(float(p.get("start", 0.0)), p["momentum_lambda_func"])
                 for p in cfg.phases if p.get("momentum_lambda_func")]
    mom_sched = (_compile_phases(mom_items, total_steps)
                 if mom_items else None)
    return lr_sched, mom_sched


def exponential_decay_schedule(base_lr, decay_steps, decay_factor,
                               staircase=True, burnin_learning_rate=0.0,
                               burnin_steps=0):
    """The legacy TF-style ExponentialDecay[WithBurnin]
    (`torchplus/train/learning_schedules.py:90-142`)."""
    def sched(step):
        if burnin_steps > 0 and step < burnin_steps:
            return float(burnin_learning_rate or base_lr)
        exp = (step // decay_steps) if staircase else (step / decay_steps)
        return base_lr * decay_factor ** exp
    return sched


def cosine_decay_with_warmup_schedule(base_lr, total_steps,
                                      warmup_learning_rate=0.0,
                                      warmup_steps=0):
    """Legacy CosineDecayWithWarmup (`learning_schedules.py:145-178`)."""
    def sched(step):
        if warmup_steps > 0 and step < warmup_steps:
            slope = (base_lr - warmup_learning_rate) / warmup_steps
            return slope * step + warmup_learning_rate
        return 0.5 * base_lr * (1 + math.cos(
            math.pi * (step - warmup_steps) /
            max(total_steps - warmup_steps, 1)))
    return sched


def build_lr_schedules(cfg: schema.LearningRateConfig, total_steps: int
                       ) -> Tuple[Callable, Optional[Callable]]:
    """Returns (lr_schedule, momentum_schedule_or_None)."""
    if cfg.kind == "one_cycle":
        return one_cycle_schedules(cfg, total_steps)
    if cfg.kind == "manual_stepping":
        return manual_stepping_schedule(cfg, total_steps), None
    if cfg.kind == "multi_phase":
        return multi_phase_schedules(cfg, total_steps)
    raise ValueError(f"unknown learning-rate kind {cfg.kind}")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, fp32, on the device."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(tensors, max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm`, in place: each t stays where the global
    norm is below max_norm, else becomes (t / norm) · max_norm. Returns the
    norm before clipping; reads nothing on the host."""
    norm = global_norm(tensors)
    keep = norm < max_norm
    for t in tensors:
        t.copy_(torch.where(keep, t, (t / norm.to(t.dtype)) * max_norm))
    return norm


class ClippedOptimizer:
    """A torch optimizer behind optax's chain: `step(count)` fills missing
    gradients with zeros (optax updates every leaf), clips them by their
    global norm, sets each param group's lr (and β1) from the schedules at
    `count`, and steps. Returns the gradient norm before clipping."""

    def __init__(self, opt: torch.optim.Optimizer, lr_sched: Callable,
                 mom_sched: Optional[Callable] = None,
                 clip_norm: float = 10.0):
        self.opt = opt
        self.lr_sched = lr_sched
        self.mom_sched = mom_sched
        self.clip_norm = clip_norm

    @property
    def params(self):
        return [p for g in self.opt.param_groups for p in g["params"]]

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self, count: int) -> torch.Tensor:
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in params], self.clip_norm)
        lr = self.lr_sched(count)
        for g in self.opt.param_groups:
            g["lr"] = lr
            if self.mom_sched is not None:
                if "betas" in g:
                    g["betas"] = (self.mom_sched(count), g["betas"][1])
                else:
                    g["momentum"] = self.mom_sched(count)
        self.opt.step()
        return norm

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, state):
        self.opt.load_state_dict(state)


def build_optimizer(cfg: schema.OptimizerConfig, total_steps: int, params,
                    clip_norm: float = 10.0):
    """schema.OptimizerConfig and the parameters → (ClippedOptimizer,
    lr_schedule)."""
    lr_sched, mom_sched = build_lr_schedules(cfg.learning_rate, total_steps)
    params = list(params)
    if cfg.kind == "adam_optimizer":
        b1 = mom_sched(0) if mom_sched is not None else 0.9
        opt = torch.optim.AdamW(params, lr=lr_sched(0), betas=(b1, 0.99),
                                eps=1e-8, weight_decay=cfg.weight_decay or 0.0)
        return ClippedOptimizer(opt, lr_sched, mom_sched, clip_norm), lr_sched
    if cfg.kind == "momentum_optimizer":
        opt = torch.optim.SGD(params, lr=lr_sched(0),
                              momentum=cfg.momentum_optimizer_value)
        return ClippedOptimizer(opt, lr_sched, None, clip_norm), lr_sched
    if cfg.kind == "rms_prop_optimizer":
        opt = torch.optim.RMSprop(params, lr=lr_sched(0), alpha=cfg.decay,
                                  eps=cfg.epsilon,
                                  momentum=cfg.momentum_optimizer_value)
        return ClippedOptimizer(opt, lr_sched, None, clip_norm), lr_sched
    raise ValueError(f"unknown optimizer kind {cfg.kind}")
