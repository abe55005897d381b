"""Train state and the train/eval steps — the port of
`second_tpu/train/state.py`.

The JAX step is one jitted function: voxelize → VFE → middle → RPN → loss →
grad → optax update. Here the same sequence runs eagerly: voxelize with no
grad, the forward in `train()` mode (the norms use and update batch
statistics), `compute_loss`, `backward` (every sparse conv's backward is the
gather-GEMM and weight-gradient kernels on the card), the gradient norm
before clipping, the clip and the optimizer step. Nothing in it reads a
tensor on the host; the step count is a Python int, as the JAX loop's
`int(state.step)` is its one sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn

from ..models.build import init_train_weights_
from ..models.detector import DetectorSpec, compute_loss, detect
from ..ops.voxelize import VoxelizeSpec, device_voxelize
from .optimizer import ClippedOptimizer, build_optimizer


@dataclasses.dataclass
class TrainState:
    """The module (its parameters and norm statistics), the optimizer (its
    moments), the update count and the lr schedule."""
    module: nn.Module
    optimizer: ClippedOptimizer
    step: int = 0
    lr_sched: Callable = None

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def state_dict(self) -> dict:
        return {"model": self.module.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.module.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def create_state(module: nn.Module, optimizer_config, total_steps,
                 seed: int = 0) -> TrainState:
    """A fresh train state for `module`, a one- or two-stage detector:
    flax's initialisers drawn from `seed` (`init_train_weights_`), the
    config's optimizer and lr schedule, step 0 (JAX's `TrainState.create`
    and `create_two_stage_state`)."""
    init_train_weights_(module, seed)
    opt, lr_sched = build_optimizer(optimizer_config, total_steps,
                                    module.parameters())
    return TrainState(module, opt, 0, lr_sched)


def make_train_step(spec: DetectorSpec, vspec: VoxelizeSpec):
    """Returns train_step(state, batch) → (state, metrics), updating the
    state in place. batch: points [B, P, C], points_mask [B, P], labels
    [B, A], reg_targets [B, A, code], anchors [B, A, code], tensors on the
    state's device; with the IoU branch (or Part-A² soft labels) also the
    padded gt boxes, gt_boxes_padded [B, G, 7] and gt_valid [B, G]. The
    metrics are JAX's keys, 0-d tensors on the device, and with the IoU
    branch its loss, iou_loss."""

    def forward_loss(net, vox, batch):
        preds = net(vox["voxels"], vox["num_points"], vox["coordinates"],
                    vox["voxel_valid"])
        return preds, compute_loss(spec, preds, batch["labels"],
                                   batch["reg_targets"], batch["anchors"],
                                   batch.get("gt_boxes_padded"),
                                   batch.get("gt_valid"))

    def metrics_of(aux):
        out = {"cls_loss": aux["cls_loss_reduced"].detach(),
               "loc_loss": aux["loc_loss_reduced"].detach(),
               "cls_pos_loss": aux["cls_pos_loss"].detach(),
               "cls_neg_loss": aux["cls_neg_loss"].detach(),
               "num_pos": aux["num_pos"]}
        if "dir_loss_reduced" in aux:
            out["dir_loss"] = aux["dir_loss_reduced"].detach()
        if "iou_loss_reduced" in aux:
            out["iou_loss"] = aux["iou_loss_reduced"].detach()
        return out

    return step_of(vspec, forward_loss, metrics_of)


def step_of(vspec: VoxelizeSpec, forward_loss, metrics_of):
    """The train step around a model's forward and loss:
    forward_loss(net, vox, batch) → (preds, loss dict with "loss") in train
    mode, metrics_of(loss dict) → the model's metrics. The step voxelizes
    with no grad, runs forward_loss, backward, the gradient norm before
    the clip, the clip and the optimizer step, and adds loss, grad_norm,
    voxel_overflow and stage_overflow to the metrics."""

    def train_step(state: TrainState, batch: Dict):
        net, dev = state.module, state.device
        with torch.no_grad():
            vox = device_voxelize(vspec, batch["points"],
                                  batch["points_mask"], dev)
        net.train()
        with torch.enable_grad():
            preds, aux = forward_loss(net, vox, batch)
            state.optimizer.zero_grad()
            aux["loss"].backward()
        grad_norm = state.optimizer.step(state.step)
        state.step += 1
        metrics = {"loss": aux["loss"].detach(), **metrics_of(aux),
                   "grad_norm": grad_norm,
                   "voxel_overflow": vox["voxel_overflow"],
                   "stage_overflow": preds["stage_overflow"]}
        return state, metrics

    return train_step


def make_eval_step(spec: DetectorSpec, vspec: VoxelizeSpec,
                   eval_vspec: VoxelizeSpec = None, mask_info=None):
    """Returns eval_step(state, batch) → detections: the existing `detect`
    (voxelize → forward in eval mode → predict) at the eval voxel capacity
    (`eval_vspec`, the reference evaluates fhd at 40k voxels against 16k in
    training), with the voxel and stage overflow counts.

    `mask_info = (sat_corners [A, 4], grid_hw, threshold)` computes the
    occupancy anchors mask on the device from the voxelizer's coords
    (`ops/anchors_mask.py`) where the batch carries no host-computed
    `anchors_mask`, as JAX's eval step does."""
    vspec = eval_vspec or vspec

    def eval_step(state: TrainState, batch: Dict):
        net = state.module
        net.eval()
        det, vox, preds = detect(net, spec, vspec, batch["points"],
                                 batch["points_mask"], batch["anchors"],
                                 device=state.device, mask_info=mask_info,
                                 anchors_mask=batch.get("anchors_mask"))
        det["voxel_overflow"] = vox["voxel_overflow"]
        det["stage_overflow"] = preds["stage_overflow"]
        return det

    return eval_step


__all__ = ["TrainState", "VoxelizeSpec", "device_voxelize", "make_train_step",
           "make_eval_step", "step_of", "create_state"]
