"""Fusion two-stage detector: the camera-fused stage 1 and the dual-crop
refine — the port of `second_tpu/models/detector_fusion_two_stage.py`
(`FusionTwoStageVoxelNet`, `compute_fusion_two_stage_loss`,
`predict_fusion_two_stage`, `build_fusion_two_stage_voxelnet`).

Stage 1 is `FusionVoxelNet`; the second stage crops both the gated BEV map
(the RPN's trunk, into the regression tower) and the fused map (into the
classification tower) at the same proposals with the rotated ROI-align
kernel, and refines residually. The loss and predict are the two-stage
ones.
"""

from __future__ import annotations

from torch import nn

from ..device import resolve_device
from .detector_two_stage import (RefineStage, RoiSpec,
                                 compute_two_stage_loss, predict_two_stage)
from .fusion import FusionVoxelNet, fusion_args
from .second_stage import ProposalSpec, SecondStageHead


class FusionTwoStageVoxelNet(RefineStage, nn.Module):
    """`FusionVoxelNet` stage 1 (`stage1`) + the dual-crop refine head
    (`second_rpn`), the JAX module's names."""

    def __init__(self, vfe_class_name, vfe_kwargs, middle_class_name,
                 middle_kwargs, rpn_kwargs, spec, pspec: ProposalSpec,
                 roi: RoiSpec):
        super().__init__()
        self.spec, self.pspec, self.roi = spec, pspec, roi
        self.stage1 = FusionVoxelNet(vfe_class_name, vfe_kwargs,
                                     middle_class_name, middle_kwargs,
                                     rpn_kwargs)
        rpn = self.stage1.rpn
        self.second_rpn = SecondStageHead(
            rpn.trunk_channels, spec.num_class, spec.box_code_size,
            crop_size=roi.crop_size,
            use_direction_classifier=spec.use_direction_classifier,
            concat_channels=rpn.fusion_refine1.conv.out_channels)

    def forward(self, voxels, num_points, coords, voxel_valid, image,
                proj_pix, proj_bev, proj_valid, anchors, anchors_mask=None):
        """`FusionVoxelNet`'s inputs, anchors [B, A, 7] and the optional
        anchors mask [B, A] → stage 1's outputs plus proposals and the
        refined second_*_preds."""
        stage1 = self.stage1(voxels, num_points, coords, voxel_valid, image,
                             proj_pix, proj_bev, proj_valid)
        return self.refine(stage1, anchors, anchors_mask,
                           crop_map=stage1["gated_bev_feat"],
                           concat_map=stage1["gated_concat_feat"])


compute_fusion_two_stage_loss = compute_two_stage_loss
predict_fusion_two_stage = predict_two_stage


def build_fusion_two_stage_voxelnet(cfg, num_proposals: int = 512,
                                    device="cuda", seed: int = 0):
    """ModelConfig → (FusionTwoStageVoxelNet, spec, info, assigner, coder):
    `num_proposals` proposals an example, fp32 whatever the config's mixed
    precision (as JAX's builder), in eval mode on `device` (the CUDA card
    unless the caller asks for the CPU), weights drawn by `init_weights_`
    from `seed`."""
    from .build import init_weights_
    from .detector import build_detector_spec
    dev = resolve_device(device)
    args, info, assigner, coder = fusion_args(cfg)
    vg = cfg.voxel_generator
    roi = RoiSpec(pc_range=tuple(vg.point_cloud_range),
                  voxel_size=tuple(vg.voxel_size),
                  out_stride=info.out_size_factor)
    module = FusionTwoStageVoxelNet(
        *args, spec=build_detector_spec(cfg),
        pspec=ProposalSpec(num_proposals=num_proposals), roi=roi)
    init_weights_(module, seed)
    return module.to(dev).eval(), module.spec, info, assigner, coder


__all__ = ["FusionTwoStageVoxelNet", "compute_fusion_two_stage_loss",
           "predict_fusion_two_stage", "build_fusion_two_stage_voxelnet"]
