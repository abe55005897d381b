"""Temporal two-frame detector (the reference's "spatio" model), its
N-frame sequence form and its camera-fusion form — the port of
`second_tpu/models/temporal.py` (`GatedBEVFusion`, `TemporalVoxelNet`,
`compute_temporal_loss`, `predict_temporal`, `TemporalSequenceVoxelNet`,
`build_temporal_voxelnet`, `TemporalFusionVoxelNet`,
`build_temporal_fusion_voxelnet`).

The current and the previous frame go through one weight-shared VFE and
sparse middle, folded into the batch axis (2B frames in one backbone call:
in training the masked norms pool their statistics over both frames), are
fused in BEV by a learned sigmoid gate, f = prev·g + cur·(1−g), and feed
the RPN; the proposals are refined from rotated crops of the fused map, not of
the RPN's trunk. The loss and predict are the two-stage ones, against the
current frame's targets.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .detector_two_stage import (RefineStage, RoiSpec,
                                 compute_two_stage_loss, predict_two_stage)
from .fusion import ZSliceFusionRPN, fusion_args
from .middle import MIDDLE_REGISTRY
from .rpn import RPN
from .second_stage import ProposalSpec, SecondStageHead
from .voxel_encoder import VFE_REGISTRY

_FRAME_KEYS = ("voxels", "num_points", "coordinates", "voxel_valid")


class GatedBEVFusion(nn.Module):
    """f = prev·g + cur·(1−g), g = σ(conv3x3([prev; cur])) (reference
    spatio :701-705); NCHW, the conv's input is prev's channels then
    cur's."""

    def __init__(self, channels):
        super().__init__()
        self.conv_gating_bev = nn.Conv2d(2 * channels, 1, 3, padding=1)

    def forward(self, cur, prev):
        g = torch.sigmoid(self.conv_gating_bev(torch.cat([prev, cur], 1)))
        return prev * g + cur * (1.0 - g)


class TemporalVoxelNet(RefineStage, nn.Module):
    """Two-frame gated-fusion two-stage detector with a shared backbone:
    `vfe`, `middle`, `bev_fusion`, `rpn` and `second_rpn`, the JAX module's
    names."""

    def __init__(self, vfe_class_name, vfe_kwargs, middle_class_name,
                 middle_kwargs, rpn_kwargs, spec, pspec: ProposalSpec,
                 roi: RoiSpec):
        super().__init__()
        self.spec, self.pspec, self.roi = spec, pspec, roi
        self.vfe = VFE_REGISTRY[vfe_class_name](**vfe_kwargs)
        self.middle = MIDDLE_REGISTRY[middle_class_name](**middle_kwargs)
        channels = self.middle.out_channels
        self.bev_fusion = GatedBEVFusion(channels)
        self.rpn = RPN(channels, **rpn_kwargs)
        self.second_rpn = SecondStageHead(
            channels, spec.num_class, spec.box_code_size,
            crop_size=roi.crop_size,
            use_direction_classifier=spec.use_direction_classifier)

    def backbone(self, frames):
        """frames: dict of voxelized [N, ...] tensors (`_FRAME_KEYS`), N
        frames of any sequences → (BEV [N, C, H, W], stage_overflow)."""
        vf = self.vfe(frames["voxels"], frames["num_points"],
                      frames["coordinates"])
        vf = torch.where(frames["voxel_valid"][..., None], vf, 0.0)
        return self.middle(vf, frames["coordinates"], frames["voxel_valid"])

    def fuse(self, cur_bev, prev_bev):
        """Gate-fuse the (cur, prev) BEV pairs [P, C, H, W] and run the RPN
        on the fused map → the RPN's outputs plus gated_bev_feat."""
        fused = self.bev_fusion(cur_bev, prev_bev)
        preds = self.rpn(fused)
        preds["gated_bev_feat"] = fused
        return preds

    def fuse_and_detect(self, cur_bev, prev_bev, anchors, anchors_mask=None):
        """`fuse`, then the second stage on the fused map; anchors [P, A,
        7]."""
        preds = self.fuse(cur_bev, prev_bev)
        return self.refine(preds, anchors, anchors_mask,
                           crop_map=preds["gated_bev_feat"])

    def stage1(self, cur, prev):
        """Both frames through one backbone call, folded into the batch
        axis, then `fuse`: stage 1's outputs with gated_bev_feat and
        stage_overflow."""
        stacked = {k: torch.cat([cur[k], prev[k]], 0) for k in _FRAME_KEYS}
        bev, overflow = self.backbone(stacked)
        B = cur["voxels"].shape[0]
        preds = self.fuse(bev[:B], bev[B:])
        preds["stage_overflow"] = overflow
        return preds

    def forward(self, cur, prev, anchors, anchors_mask=None):
        """cur / prev: dicts of the voxelized frames (voxels [B, V, T, C],
        num_points, coordinates, voxel_valid); anchors [B, A, 7] and the
        optional anchors mask [B, A] → the two-stage outputs (stage 1's,
        proposals, second_*_preds), gated_bev_feat and stage_overflow."""
        preds = self.stage1(cur, prev)
        return self.refine(preds, anchors, anchors_mask,
                           crop_map=preds["gated_bev_feat"])


class TemporalSequenceVoxelNet(TemporalVoxelNet):
    """N-frame temporal inference: all T frames of one sequence through the
    backbone in one call, adjacent frames gate-fused and both stages run
    for every frame t ≥ 1. The submodules are the pair model's, so one
    state dict loads into both."""

    def forward(self, frames, anchors):
        """frames: dict of [T, ...] voxelized tensors of one sequence;
        anchors [A, 7] → per-pair outputs with leading axis T - 1."""
        bev, overflow = self.backbone(frames)
        T1 = bev.shape[0] - 1
        preds = self.fuse_and_detect(
            bev[1:], bev[:-1], anchors[None].expand(T1, *anchors.shape))
        preds["stage_overflow"] = overflow
        return preds


compute_temporal_loss = compute_two_stage_loss
predict_temporal = predict_two_stage


class TemporalFusionVoxelNet(RefineStage, nn.Module):
    """The complete reference spatio model: the two-frame gated BEV fusion
    of `TemporalVoxelNet` (both frames through one backbone call, folded
    into the batch axis), then the camera RPN (`ZSliceFusionRPN`: the
    current frame's image cropped per z-slice) and a second stage that
    crops both the RPN's trunk (the regression tower) and the z-slice map
    (the classification tower), with a stage-2 direction head where the
    config has the direction classifier. `vfe`, `middle`, `bev_fusion`,
    `rpn` and `second_rpn`, the JAX module's names."""

    backbone = TemporalVoxelNet.backbone

    def __init__(self, vfe_class_name, vfe_kwargs, middle_class_name,
                 middle_kwargs, rpn_kwargs, spec, pspec: ProposalSpec,
                 roi: RoiSpec):
        super().__init__()
        self.spec, self.pspec, self.roi = spec, pspec, roi
        self.vfe = VFE_REGISTRY[vfe_class_name](**vfe_kwargs)
        self.middle = MIDDLE_REGISTRY[middle_class_name](**middle_kwargs)
        channels = self.middle.out_channels
        self.bev_fusion = GatedBEVFusion(channels)
        self.rpn = ZSliceFusionRPN(channels, **rpn_kwargs)
        self.second_rpn = SecondStageHead(
            self.rpn.trunk_channels, spec.num_class, spec.box_code_size,
            crop_size=roi.crop_size,
            use_direction_classifier=spec.use_direction_classifier,
            concat_channels=self.rpn.concat_channels)

    def stage1(self, cur, prev, image, idxs_norm, idxs_valid):
        """Both frames through one backbone call, the gate, the camera RPN
        on the fused map: stage 1's outputs (gated_bev_feat the RPN's trunk,
        gated_concat_feat the z-slice map) and stage_overflow."""
        stacked = {k: torch.cat([cur[k], prev[k]], 0) for k in _FRAME_KEYS}
        bev, overflow = self.backbone(stacked)
        B = cur["voxels"].shape[0]
        fused = self.bev_fusion(bev[:B], bev[B:])
        preds = self.rpn(fused, image, idxs_norm, idxs_valid)
        preds["stage_overflow"] = overflow
        return preds

    def forward(self, cur, prev, image, idxs_norm, idxs_valid, anchors,
                anchors_mask=None):
        """cur / prev: the voxelized frames (as `TemporalVoxelNet`'s); image
        [B, Hi, Wi, 3] the current frame's camera; idxs_norm [B, D, H, W, 2]
        and idxs_valid [B, D, H, W] the z-slice projection
        (`compute_bev_zslice_projection`); anchors [B, A, 7] and the optional
        anchors mask [B, A] → the two-stage outputs."""
        preds = self.stage1(cur, prev, image, idxs_norm, idxs_valid)
        return self.refine(preds, anchors, anchors_mask,
                           crop_map=preds["gated_bev_feat"],
                           concat_map=preds["gated_concat_feat"])


# the compressed width of the z-slice stack (JAX's builder sets it)
CONCAT_FEATURES = 256


def build_temporal_fusion_voxelnet(cfg, num_proposals: int = 512,
                                   device="cuda", seed: int = 0):
    """ModelConfig → (TemporalFusionVoxelNet, spec, info, assigner,
    coder): the one-stage builder's VFE and middle, the camera RPN with
    the RPN's `dtype` dropped (fp32, as JAX's builder), its z-slice stack
    compressed to CONCAT_FEATURES channels, `num_proposals` proposals an
    example. The module is in eval mode on `device` (the CUDA
    card unless the caller asks for the CPU), weights drawn by
    `init_weights_` from `seed`."""
    from .build import init_weights_
    from .detector import build_detector_spec
    dev = resolve_device(device)
    args, info, assigner, coder = fusion_args(cfg)
    rpn_kwargs = dict(args[4], concat_features=CONCAT_FEATURES)
    vg = cfg.voxel_generator
    roi = RoiSpec(pc_range=tuple(vg.point_cloud_range),
                  voxel_size=tuple(vg.voxel_size),
                  out_stride=info.out_size_factor)
    module = TemporalFusionVoxelNet(
        *args[:4], rpn_kwargs, spec=build_detector_spec(cfg),
        pspec=ProposalSpec(num_proposals=num_proposals), roi=roi)
    init_weights_(module, seed)
    return module.to(dev).eval(), module.spec, info, assigner, coder


def build_temporal_voxelnet(cfg, num_proposals: int = 512, device="cuda",
                            seed: int = 0, sequence: bool = False):
    """ModelConfig → (module, spec, info, assigner, coder), temporal: the
    one-stage builder's VFE, middle and RPN (no IoU head, as in JAX), the
    gate on the middle's channels, the refine head on the fused map,
    `num_proposals` proposals an example; `TemporalSequenceVoxelNet` with
    `sequence`. The module is in eval mode on `device` (the CUDA card
    unless the caller asks for the CPU), with weights drawn by
    `init_weights_` from `seed`. It computes in fp32 whatever the config's
    `enable_mixed_precision`: JAX's builder calls `build_voxelnet(cfg)`
    with its default, no mixed precision."""
    from .build import init_weights_, voxelnet_args
    from .detector import build_detector_spec
    dev = resolve_device(device)
    args, info, assigner, coder = voxelnet_args(cfg)
    vg = cfg.voxel_generator
    roi = RoiSpec(pc_range=tuple(vg.point_cloud_range),
                  voxel_size=tuple(vg.voxel_size),
                  out_stride=info.out_size_factor)
    cls = TemporalSequenceVoxelNet if sequence else TemporalVoxelNet
    spec = build_detector_spec(cfg)
    module = cls(*args[:5], spec=spec,
                 pspec=ProposalSpec(num_proposals=num_proposals), roi=roi)
    init_weights_(module, seed)
    return module.to(dev).eval(), spec, info, assigner, coder


__all__ = ["GatedBEVFusion", "TemporalVoxelNet", "TemporalSequenceVoxelNet",
           "TemporalFusionVoxelNet", "compute_temporal_loss",
           "predict_temporal", "build_temporal_voxelnet",
           "build_temporal_fusion_voxelnet"]
