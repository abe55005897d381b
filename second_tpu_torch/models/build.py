"""Model builder: ModelConfig → (VoxelNet, DetectorSpec, NetInfo, target
assigner, box coder) — the port of `second_tpu/models/build.py`
`build_voxelnet` (`voxelnet_args` gives its constructor arguments, which
the two-stage builder shares), plus seeded weights: random eval-test weights
(`init_weights_`) and flax's initialisers for training from scratch
(`init_train_weights_`), and norm statistics calibrated on a batch
(`calibrate_norms_`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..config import schema
from ..core.anchors import build_box_coder, build_target_assigner
from ..device import resolve_device
from .detector import VoxelNet, build_detector_spec
from .middle import MIDDLE_REGISTRY
from .sparse_middle import (DownBlock, MaskedBatchNorm, SparseBasicBlock,
                            SparseBottleneck, SubMBlock)
from .voxel_encoder import VFE_REGISTRY

# the middles that compute in bf16 under mixed precision, as JAX's
# `build_voxelnet` has it (`second_tpu/models/build.py:71-75`); the stack
# middles stay fp32
BF16_MIDDLES = ("SpMiddleFHD", "SpMiddleFHDLite", "SpMiddleResNetFHD")


@dataclasses.dataclass
class NetInfo:
    """Static shape info derived from the config."""
    grid_size: Tuple[int, int, int]          # (nx, ny, nz)
    dense_shape: Tuple[int, ...]             # (nz + 1, ny, nx) zyx
    out_size_factor: int                     # BEV stride of the RPN output
    feature_map_size: Tuple[int, int, int]   # (1, ny/f, nx/f)
    num_anchors: int


def _rpn_out_stride(rpn_cfg: schema.RPNConfig) -> int:
    """Overall stride of the RPN output relative to its input BEV map."""
    factors = []
    for i in range(len(rpn_cfg.layer_nums)):
        down = int(np.prod(rpn_cfg.layer_strides[:i + 1]))
        if down % rpn_cfg.upsample_strides[i]:
            raise ValueError("RPN upsample stride does not divide its stage "
                             "stride")
        factors.append(down // rpn_cfg.upsample_strides[i])
    if any(f != factors[0] for f in factors):
        raise ValueError(f"RPN stages end at different strides {factors}")
    return int(factors[0])


def build_voxelnet(cfg: schema.ModelConfig, device="cuda",
                   mixed_precision: bool = False, seed: int = 0):
    """Returns (module, spec, info, target_assigner, box_coder); the module
    is in eval mode on `device` (the CUDA card unless the caller asks for
    the CPU), with weights drawn by `init_weights_` from `seed`.

    Under `mixed_precision` the RPN trunk and the middles of
    `BF16_MIDDLES` compute in bf16 (sparse-conv sums and normalisation stay
    fp32, the heads fp32); the encoders, the stack middles and the scatter
    stay fp32."""
    dev = resolve_device(device)
    args, info, target_assigner, box_coder = voxelnet_args(cfg,
                                                           mixed_precision)
    module = VoxelNet(*args)
    init_weights_(module, seed)
    module = module.to(dev).eval()
    return module, build_detector_spec(cfg), info, target_assigner, \
        box_coder


def voxelnet_args(cfg: schema.ModelConfig, mixed_precision: bool = False):
    """The `VoxelNet` constructor's arguments for this config (vfe name and
    kwargs, middle name and kwargs, rpn kwargs, IoU-head kwargs or None),
    the NetInfo, the target assigner and the box coder."""
    vg = cfg.voxel_generator
    nx, ny, nz = vg.grid_size
    box_coder = build_box_coder(cfg.box_coder)
    target_assigner = build_target_assigner(cfg.target_assigner, box_coder)
    num_anchor_per_loc = target_assigner.num_anchors_per_location

    dtype = torch.bfloat16 if mixed_precision else None
    vfe_name = cfg.voxel_feature_extractor.module_class_name
    if vfe_name not in VFE_REGISTRY:
        raise ValueError(f"unknown voxel encoder {vfe_name!r}; registered: "
                         f"{sorted(VFE_REGISTRY)}")
    vfe_cls = VFE_REGISTRY[vfe_name]
    vfe_kwargs = {
        "num_filters": tuple(cfg.voxel_feature_extractor.num_filters),
        "with_distance": cfg.voxel_feature_extractor.with_distance,
    }
    if vfe_cls.takes_point_width:
        vfe_kwargs["num_input_features"] = cfg.num_point_features
    if vfe_name == "PillarFeatureNet":
        # fp32, as in JAX: `build_voxelnet` gives the encoder no dtype
        vfe_kwargs["voxel_size"] = tuple(vg.voxel_size)
        vfe_kwargs["pc_range"] = tuple(vg.point_cloud_range)
    # the middle's input width is the encoder's output, as flax infers it
    vfe_out = vfe_cls.out_width(vfe_kwargs["num_filters"],
                                cfg.num_point_features)
    mcfg = cfg.middle_feature_extractor
    middle_name = mcfg.module_class_name
    if middle_name == "PointPillarsScatter":
        middle_downsample = 1
        middle_kwargs = {
            "output_shape": (ny, nx),
            "num_input_features": cfg.voxel_feature_extractor.num_filters[-1],
        }
    elif middle_name in MIDDLE_REGISTRY:
        middle_downsample = mcfg.downsample_factor
        middle_kwargs = {
            # dense zyx shape is grid + (1, 0, 0)
            "output_shape": (nz + 1, ny, nx),
            "num_input_features": vfe_out,
        }
        if middle_name == "SparseMiddleExtractor":
            # JAX's exception: the config's width is the first strided
            # conv's where num_filters_down1 is empty
            middle_kwargs.update(
                num_input_features=mcfg.num_input_features,
                in_channels=vfe_out,
                num_filters_down1=tuple(mcfg.num_filters_down1),
                num_filters_down2=tuple(mcfg.num_filters_down2))
        if middle_name in BF16_MIDDLES:
            middle_kwargs["dtype"] = dtype
    else:
        raise ValueError(f"unknown middle {middle_name!r}; registered: "
                         f"{sorted(MIDDLE_REGISTRY)}")
    out_size_factor = middle_downsample * _rpn_out_stride(cfg.rpn)
    fmap = (1, ny // out_size_factor, nx // out_size_factor)
    rpn_kwargs = {
        "dtype": dtype,
        "layer_nums": tuple(cfg.rpn.layer_nums),
        "layer_strides": tuple(cfg.rpn.layer_strides),
        "num_filters": tuple(cfg.rpn.num_filters),
        "upsample_strides": tuple(cfg.rpn.upsample_strides),
        "num_upsample_filters": tuple(cfg.rpn.num_upsample_filters),
        "num_class": max(1, len(cfg.target_assigner.anchor_generators)),
        "num_anchor_per_loc": num_anchor_per_loc,
        "box_code_size": box_coder.code_size,
        "encode_background_as_zeros": cfg.encode_background_as_zeros,
        "use_direction_classifier": cfg.use_direction_classifier,
        "use_groupnorm": cfg.rpn.use_groupnorm,
        "num_groups": cfg.rpn.num_groups,
    }
    iou_kwargs = None
    if cfg.use_iou_branch:
        iou_kwargs = {"num_filters": tuple(cfg.iou.num_filters),
                      "num_anchor_per_loc": num_anchor_per_loc}
    info = NetInfo(grid_size=(nx, ny, nz), dense_shape=(nz + 1, ny, nx),
                   out_size_factor=out_size_factor, feature_map_size=fmap,
                   num_anchors=fmap[1] * fmap[2] * num_anchor_per_loc)
    return ((vfe_name, vfe_kwargs, middle_name, middle_kwargs, rpn_kwargs,
             iou_kwargs), info, target_assigner, box_coder)


# the residual sparse blocks, whose kernels (`kernels()`) are drawn in
# flax's order
_RESIDUAL = (SparseBasicBlock, SparseBottleneck)


def _kernel_fan_in(w) -> int:
    """A sparse or 1x1 kernel's fan-in as flax counts it: K · Cin for
    [K, Cin, Cout], Cin for [Cin, Cout]."""
    return int(np.prod(w.shape[:-1]))


# the norms with running statistics
_NORMS = (MaskedBatchNorm, nn.BatchNorm1d, nn.BatchNorm2d)


def _fan_in(m: nn.Module) -> int:
    """Inputs a kernel entry sums over, as flax counts them: kh · kw · in
    channels for a conv or transposed conv, the input width for a Linear
    (the pillar encoder's, fan_in 9)."""
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w[0].numel()


@torch.no_grad()
def init_weights_(module: nn.Module, seed: int = 0) -> None:
    """Random weights from a seeded CPU `torch.Generator`, so a seed gives
    the same weights on every device: fan-in-scaled normal kernels, and
    normalisation layers with non-trivial scales, shifts and running
    statistics. Every dense conv is covered, the two-stage refine head's
    among them."""
    g = torch.Generator().manual_seed(seed)

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=g) * std)

    def uniform_(t, lo, hi):
        t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g))

    for m in module.modules():
        if isinstance(m, (SubMBlock, DownBlock)):
            K, cin, _ = m.weight.shape
            normal_(m.weight, (K * cin) ** -0.5)
        elif isinstance(m, _RESIDUAL):
            for w in m.kernels():
                normal_(w, _kernel_fan_in(w) ** -0.5)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            normal_(m.weight, _fan_in(m) ** -0.5)
            if m.bias is not None:
                normal_(m.bias, 0.1)
        if isinstance(m, _NORMS + (nn.GroupNorm,)):
            uniform_(m.weight, 0.5, 1.5)
            normal_(m.bias, 0.1)
        if isinstance(m, _NORMS):
            normal_(m.running_mean, 0.1)
            uniform_(m.running_var, 0.5, 2.0)


# flax's truncated normal: a standard normal cut to [-2, 2], then scaled so
# the samples' std is the one asked for (`jax.nn.initializers` divides by
# the cut distribution's std)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_train_weights_(module: nn.Module, seed: int = 0) -> None:
    """flax's initialisers, the ones the JAX trainer starts from, drawn from
    a seeded CPU `torch.Generator` (the draws cannot equal flax's):

      * sparse kernels [K, Cin, Cout] and the residual blocks' 1x1 kernels
        [Cin, Cout] (`proj`, the bottleneck's `kernel1x1_a/b`):
        `variance_scaling(1.0, "fan_in", "normal")`, std (K · Cin)^-0.5,
        or Cin^-0.5 (`second_tpu/models/sparse_middle.py:78-79`, `:105`);
      * dense conv, transposed-conv and Linear kernels: `nn.Conv`'s and
        `nn.Dense`'s default `lecun_normal`, a truncated normal of std
        fan_in^-0.5 (`_fan_in`), zero biases (the two-stage refine head's
        3x3 and crop-sized convs among them);
      * norms: scale 1, bias 0, running mean 0, running variance 1."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (SubMBlock, DownBlock)):
            K, cin, _ = m.weight.shape
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) *
                           (K * cin) ** -0.5)
        elif isinstance(m, _RESIDUAL):
            for w in m.kernels():
                w.copy_(torch.randn(w.shape, generator=g) *
                        _kernel_fan_in(w) ** -0.5)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            t = torch.empty(w.shape)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
            w.copy_(t * (_fan_in(m) ** -0.5 / _TRUNC_STD))
            if m.bias is not None:
                m.bias.zero_()
        if isinstance(m, _NORMS + (nn.GroupNorm,)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if isinstance(m, _NORMS):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


@torch.no_grad()
def calibrate_norms_(module: nn.Module, voxels, num_points, coords,
                     voxel_valid) -> None:
    """Set the running statistics of every torch batch norm (the pillar
    encoder's and the RPN's; the sparse middle's masked norms keep theirs)
    to the batch statistics of one train-mode forward on these voxels
    (momentum 1 for that forward), then leave the module in eval mode. A
    random model's eval predictions then have a trained model's scale.
    PointPillars needs it: JAX's pillar encoder feeds its norm cluster
    offsets of 1e4-1e5 (the offset's sum runs over the voxels, ROADMAP §3),
    so under initial or random running statistics the eval predictions
    reach 1e3 and the decoded boxes overflow."""
    norms = [m for m in module.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    module.train()
    try:
        module(voxels, num_points, coords, voxel_valid)
    finally:
        for m, mom in zip(norms, momenta):
            m.momentum = mom
        module.eval()
