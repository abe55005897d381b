"""Detection losses — the port of `second_tpu/models/losses.py`, all of it.

Equivalents of the reference's TF-object-detection-style loss classes
(`second/pytorch/core/losses.py`): WeightedSmoothL1 (sigma, code weights),
SigmoidFocal (α, γ), WeightedSoftmax (direction), WeightedSigmoid,
WeightedL2, bootstrapped sigmoid; plus the loss-weight preparation of
`voxelnet.py:684-720`. Elementwise torch, the same formulas in the same
order as the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..device import constant


def sigmoid_cross_entropy_with_logits(logits, labels):
    """Numerically stable elementwise sigmoid CE (TF semantics)."""
    return (torch.clamp(logits, min=0) - logits * labels +
            torch.log1p(torch.exp(-torch.abs(logits))))


def weighted_sigmoid_loss(logits, targets, weights):
    """[B, A, C] logits/one-hot targets, [B, A] weights → [B, A, C]."""
    return sigmoid_cross_entropy_with_logits(logits, targets) * \
        weights[..., None]


def sigmoid_focal_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """Sigmoid focal CE (Lin et al.); anchorwise output [B, A, C]."""
    ce = sigmoid_cross_entropy_with_logits(logits, targets)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    loss = ce
    if gamma:
        loss = loss * torch.pow(1.0 - p_t, gamma)
    if alpha is not None:
        alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
        loss = loss * alpha_w
    return loss * weights[..., None]


def softmax_focal_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    logp = F.log_softmax(logits, dim=-1)
    ce = -(targets * logp).sum(-1)
    p_t = (targets * torch.exp(logp)).sum(-1)
    loss = ce * torch.pow(1.0 - p_t, gamma)
    if alpha is not None:
        alpha_w = (targets[..., 1:].sum(-1) * alpha +
                   targets[..., 0] * (1 - alpha))
        loss = loss * alpha_w
    return loss * weights


def weighted_smooth_l1_loss(preds, targets, weights, sigma=3.0,
                            code_weights: Optional[Sequence[float]] = None):
    """Per-code smooth-L1 (Huber) with the reference's sigma scaling;
    anchorwise output [B, A, code]."""
    diff = preds - targets
    if code_weights is not None:
        diff = diff * constant(code_weights, diff.device, diff.dtype)
    abs_diff = torch.abs(diff)
    thresh = 1.0 / (sigma ** 2)
    loss = torch.where(abs_diff <= thresh,
                       0.5 * torch.square(abs_diff * sigma),
                       abs_diff - 0.5 * thresh)
    return loss * weights[..., None]


def weighted_l2_loss(preds, targets, weights,
                     code_weights: Optional[Sequence[float]] = None):
    diff = preds - targets
    if code_weights is not None:
        diff = diff * constant(code_weights, diff.device, diff.dtype)
    return 0.5 * torch.square(diff * weights[..., None])


def weighted_softmax_loss(logits, targets, weights, logit_scale=1.0):
    """Per-anchor softmax CE (direction classifier)."""
    logp = F.log_softmax(logits / logit_scale, dim=-1)
    return -(targets * logp).sum(-1) * weights


def bootstrapped_sigmoid_loss(logits, targets, weights, alpha=0.5,
                              bootstrap_type="soft"):
    """Bootstrapped sigmoid CE (Reed et al. 2015): targets are a convex
    combination of labels and the model's own predictions (reference
    `losses.py:409-466` BootstrappedSigmoidClassificationLoss). The
    predictions enter the targets without a gradient stop, as in JAX."""
    p = torch.sigmoid(logits)
    if bootstrap_type == "soft":
        boot = alpha * targets + (1.0 - alpha) * p
    elif bootstrap_type == "hard":
        boot = alpha * targets + (1.0 - alpha) * (p > 0.5).to(logits.dtype)
    else:
        raise ValueError(f"unknown bootstrap_type {bootstrap_type}")
    return sigmoid_cross_entropy_with_logits(logits, boot) * \
        weights[..., None]


def prepare_loss_weights(labels, pos_cls_weight=1.0, neg_cls_weight=1.0,
                         loss_norm_type="NormByNumPositives",
                         dtype=torch.float32):
    """cls/reg weights from labels (reference `voxelnet.py:684-720`).

    labels: [B, A] int (-1 ignore, 0 bg, >0 class).
    Returns (cls_weights [B, A], reg_weights [B, A], cared [B, A] bool).
    """
    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    cls_weights = (negatives.to(dtype) * neg_cls_weight +
                   positives.to(dtype) * pos_cls_weight)
    reg_weights = positives.to(dtype)
    if loss_norm_type == "NormByNumExamples":
        num_examples = torch.clamp(cared.to(dtype).sum(1, keepdim=True),
                                   min=1.0)
        cls_weights = cls_weights / num_examples
        bbox_norm = torch.clamp(positives.to(dtype).sum(1, keepdim=True),
                                min=1.0)
        reg_weights = reg_weights / bbox_norm
    elif loss_norm_type == "NormByNumPositives":
        pos_norm = torch.clamp(positives.to(dtype).sum(1, keepdim=True),
                               min=1.0)
        reg_weights = reg_weights / pos_norm
        cls_weights = cls_weights / pos_norm
    elif loss_norm_type == "NormByNumPosNeg":
        pos_neg = torch.stack([positives, negatives], -1).to(dtype)
        normalizer = pos_neg.sum(1, keepdim=True)              # [B, 1, 2]
        cls_normalizer = torch.clamp((pos_neg * normalizer).sum(-1), min=1.0)
        normalizer = torch.clamp(normalizer, min=1.0)
        reg_weights = reg_weights / normalizer[:, 0:1, 0]
        cls_weights = cls_weights / cls_normalizer
    else:
        raise ValueError(f"unknown loss norm type {loss_norm_type}")
    return cls_weights, reg_weights, cared


def build_classification_loss(cfg):
    """schema.ClassificationLossConfig → loss fn (logits, one_hot, w) →
    [B, A, C]."""
    if cfg.kind == "weighted_sigmoid_focal":
        return lambda lo, t, w: sigmoid_focal_loss(lo, t, w, cfg.gamma,
                                                   cfg.alpha)
    if cfg.kind == "weighted_sigmoid":
        return weighted_sigmoid_loss
    if cfg.kind == "weighted_softmax_focal":
        return lambda lo, t, w: softmax_focal_loss(lo, t, w, cfg.gamma,
                                                   cfg.alpha)[..., None]
    if cfg.kind == "weighted_softmax":
        return lambda lo, t, w: weighted_softmax_loss(
            lo, t, w, cfg.logit_scale)[..., None]
    if cfg.kind == "bootstrapped_sigmoid":
        return lambda lo, t, w: bootstrapped_sigmoid_loss(
            lo, t, w, cfg.alpha,
            "hard" if getattr(cfg, "hard_bootstrap", False) else "soft")
    raise ValueError(f"unknown classification loss {cfg.kind}")


def build_localization_loss(cfg):
    cw = list(cfg.code_weight) if cfg.code_weight else None
    if cfg.kind == "weighted_smooth_l1":
        return lambda p, t, w: weighted_smooth_l1_loss(p, t, w, cfg.sigma, cw)
    if cfg.kind == "weighted_l2":
        return lambda p, t, w: weighted_l2_loss(p, t, w, cw)
    raise ValueError(f"unknown localization loss {cfg.kind}")
