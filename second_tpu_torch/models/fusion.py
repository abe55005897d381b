"""Camera–LiDAR fusion — the port of `second_tpu/models/fusion.py`
(`BasicBlock`, `ResNetFPN18`, `BasicGate`, `project_image_to_bev`,
`FusionRPN`, `gather_image_features`, `ZSliceFusionRPN`,
`FusionVoxelNet`, `build_fusion_voxelnet`, and the host helpers
`compute_image_projection`, `compute_bev_zslice_projection`), in NCHW.

A ResNet-18 FPN over the camera image gives a stride-8, 256-channel map
(P3). `FusionRPN` scatters P3's pixels into the BEV cells of the lidar
points that project onto them, refines them, gates the BEV trunk and the
image features with sigmoid gates computed from the trunk, fuses the two
and runs the class and direction heads on the fused map, the box head on
the trunk. `ZSliceFusionRPN` (the temporal-fusion model's RPN) runs every
head on the trunk and crops P3, without gradient, at the host-projected
pixel of each (z-slice, BEV cell), stacking the slices on channels (a 1x1
conv compresses them) as the map the second stage's classification tower
crops.

JAX computes all of it in XLA (no Pallas kernel): here it is plain
PyTorch, fp32 as JAX's builders make the fusion models. The BatchNorms of
the FPN are flax's (momentum 0.9, eps 1e-5), the others the RPN's.
The camera inputs are taken as the batch carries them: the image
[B, Hi, Wi, 3], the projections row-major.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import box_np
from ..device import resolve_device
from .layers import ConvBlock, FlaxBatchNorm2d, same_padding
from .middle import MIDDLE_REGISTRY
from .rpn import RPNBase, RPNHead
from .voxel_encoder import VFE_REGISTRY

FPN_FEATURES = 256
# z-slices of the temporal-fusion model's camera crops: the examples'
# `PrepConfig.num_z_slices` (flax infers the compress conv's input width
# from the data; torch needs it when the module is built)
NUM_Z_SLICES = 4


def _same_pad(x, kernel, stride, value=0.0):
    """x [B, C, H, W] padded as flax's "SAME" pads it for this kernel and
    stride (one more after than before on an odd total)."""
    ph = same_padding(x.shape[-2], kernel, stride)
    pw = same_padding(x.shape[-1], kernel, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


class SameConv2d(nn.Conv2d):
    """Conv2d with flax's "SAME" padding, asymmetric where the total is
    odd (a stride-2 conv on an even size pads 0 before and 1 after)."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        return F.conv2d(_same_pad(x, k, s), self.weight, self.bias, s)


def _conv(cin, cout, k, stride=1, bias=False):
    return SameConv2d(cin, cout, k, stride, bias=bias)


def _fpn_norm(c):
    return FlaxBatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """ResNet-18 basic block: conv3x3 (stride) → BN → ReLU → conv3x3 → BN,
    plus the input or its 1x1 (stride) projection, → ReLU."""

    def __init__(self, in_channels, features, stride=1):
        super().__init__()
        self.conv1 = _conv(in_channels, features, 3, stride)
        self.norm1 = _fpn_norm(features)
        self.conv2 = _conv(features, features, 3)
        self.norm2 = _fpn_norm(features)
        self.down = None
        if in_channels != features or stride != 1:
            self.down = _conv(in_channels, features, 1, stride)
            self.down_norm = _fpn_norm(features)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        res = x if self.down is None else self.down_norm(self.down(x))
        return F.relu(y + res)


class ResNetFPN18(nn.Module):
    """ResNet-18 trunk and top-down FPN → the stride-8 P3 map [B, 256,
    ceil(Hi / 8), ceil(Wi / 8)] of an image [B, 3, Hi, Wi]. The stem's
    max pool pads with -inf as flax's "SAME" does, and the top-down
    upsampling is nearest with half-pixel centres (`jax.image.resize`'s
    "nearest", torch's "nearest-exact")."""

    STAGES = ((64, 1, 2), (128, 2, 2), (256, 2, 2), (512, 2, 2))

    def __init__(self):
        super().__init__()
        self.stem = _conv(3, 64, 7, 2)
        self.stem_norm = _fpn_norm(64)
        blocks, cin = [], 64
        for f, s, n in self.STAGES:
            for i in range(n):
                blocks.append(BasicBlock(cin, f, s if i == 0 else 1))
                cin = f
        self.blocks = nn.ModuleList(blocks)
        self.lateral5 = nn.Conv2d(512, FPN_FEATURES, 1)
        self.lateral4 = nn.Conv2d(256, FPN_FEATURES, 1)
        self.lateral3 = nn.Conv2d(128, FPN_FEATURES, 1)
        self.smooth = _conv(FPN_FEATURES, FPN_FEATURES, 3, bias=True)

    def forward(self, image):
        x = F.relu(self.stem_norm(self.stem(image)))
        x = F.max_pool2d(_same_pad(x, 3, 2, float("-inf")), 3, 2)
        feats, j = {}, 0
        for f, _, n in self.STAGES:
            for _ in range(n):
                x = self.blocks[j](x)
                j += 1
            feats[f] = x
        p4 = self.lateral4(feats[256])
        p4 = p4 + F.interpolate(self.lateral5(feats[512]),
                                size=p4.shape[-2:], mode="nearest-exact")
        p3 = self.lateral3(feats[128])
        p3 = p3 + F.interpolate(p4, size=p3.shape[-2:], mode="nearest-exact")
        return self.smooth(p3)


class BasicGate(nn.Module):
    """x · σ(conv3x3(bev)): a spatial sigmoid gate from `bev` applied to
    `x`."""

    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, 1, 3, padding=1)

    def forward(self, bev, x):
        return x * torch.sigmoid(self.conv(bev))


def _pixels(p3, lin):
    """p3 [B, C, Hf, Wf] at the flat pixel indices lin [B, N] → [B, C, N].
    Where a gradient is wanted, an index into P3's channels-last rows: its
    backward (an accumulating `index_put_`) sums the gradients of the
    entries that share a pixel in a fixed order on the card, where a
    `gather`'s backward adds them with atomics. Without one, a `gather`,
    whose output is contiguous."""
    B, C, Hf, Wf = p3.shape
    if not (torch.is_grad_enabled() and p3.requires_grad):
        return p3.flatten(2).gather(2, lin[:, None, :].expand(B, C, -1))
    base = torch.arange(B, device=p3.device)[:, None] * (Hf * Wf)
    rows_hwc = p3.permute(0, 2, 3, 1).reshape(B * Hf * Wf, C)
    return rows_hwc[base + lin].permute(0, 2, 1)


def _flat_pixels(p3, rows, cols):
    """p3 [B, C, Hf, Wf] at the pixels (rows, cols), each [B, N] (clipped
    to the map) → [B, C, N]."""
    Hf, Wf = p3.shape[-2:]
    return _pixels(p3, (rows.clamp(0, Hf - 1) * Wf +
                        cols.clamp(0, Wf - 1)).long())


def projection_winners(proj_bev, proj_valid, bev_hw):
    """[B, Hb * Wb] int64: the index of the point each BEV cell takes its
    image feature from, -1 for a cell no valid point falls in. The rule
    where several valid points share a cell: the highest index wins, the
    point JAX's scatter writes last (`.at[].set` on the CPU writes the
    updates in order). A valid point whose cell lies off the canvas
    (row · Wb + col outside [0, Hb · Wb)) writes nothing; the host
    projection marks no such point valid."""
    Hb, Wb = bev_hw
    B, P = proj_valid.shape
    cells = Hb * Wb
    lin = proj_bev[..., 0].long() * Wb + proj_bev[..., 1].long()
    ok = proj_valid & (lin >= 0) & (lin < cells)
    lin = torch.where(ok, lin, cells)                # a dump cell
    idx = torch.arange(P, device=lin.device).expand(B, P)
    win = torch.full((B, cells + 1), -1, dtype=torch.int64,
                     device=lin.device)
    win.scatter_reduce_(1, lin, torch.where(ok, idx, -1), "amax")
    return win[:, :cells]


def project_image_to_bev(p3, proj_pix, proj_bev, proj_valid, bev_hw):
    """Point-guided scatter of image features into the BEV canvas.

    p3 [B, C, Hf, Wf]; proj_pix [B, P, 2] (row, col) P3 pixel of each lidar
    point (clipped to the map); proj_bev [B, P, 2] (row, col) BEV cell;
    proj_valid [B, P]. Returns [B, C, Hb, Wb]: each cell the P3 feature of
    its winning point (`projection_winners`), zero where no valid point
    falls. Built as a scatter of point indices (amax) and a gather of the
    winners' pixels, so the gradient reaches P3 through the winners only,
    as JAX's scatter-set JVP sends it."""
    Hb, Wb = bev_hw
    B, C, Hf, Wf = p3.shape
    win = projection_winners(proj_bev, proj_valid, bev_hw)
    src = win.clamp(min=0)
    rows = proj_pix[..., 0].long().gather(1, src).clamp(0, Hf - 1)
    cols = proj_pix[..., 1].long().gather(1, src).clamp(0, Wf - 1)
    # an empty cell reads a pixel of its own, spread over the map (and is
    # zeroed below): pointed at one pixel, the empty cells, most of the
    # canvas, made one long run of zeros for the backward to sum
    spread = torch.arange(Hb * Wb, device=p3.device) % (Hf * Wf)
    lin = torch.where(win >= 0, rows * Wf + cols, spread)
    canvas = _pixels(p3, lin)                       # [B, C, Hb * Wb]
    canvas = torch.where((win >= 0)[:, None, :], canvas, 0.0)
    return canvas.reshape(B, C, Hb, Wb)


class _CameraRPN(nn.Module):
    """The BEV trunk, the FPN and the 1x1 heads of the fusion RPNs (the
    class and direction heads on `cls_channels`, the trunk's unless
    given), and their outputs in the RPN's anchor layout
    (`RPNHead._flatten`)."""

    def __init__(self, in_channels, layer_nums, layer_strides, num_filters,
                 upsample_strides, num_upsample_filters, use_groupnorm,
                 num_groups, cls_channels, num_class, num_anchor_per_loc,
                 box_code_size, encode_background_as_zeros,
                 use_direction_classifier):
        super().__init__()
        self.box_code_size = box_code_size
        self.trunk = RPNBase(in_channels, layer_nums, layer_strides,
                             num_filters, upsample_strides,
                             num_upsample_filters, use_groupnorm, num_groups)
        self.trunk_channels = sum(num_upsample_filters)
        self.fpn18 = ResNetFPN18()
        A = num_anchor_per_loc
        self.num_cls = num_class if encode_background_as_zeros \
            else num_class + 1
        cls_channels = cls_channels or self.trunk_channels
        self.conv_box = nn.Conv2d(self.trunk_channels, A * box_code_size, 1)
        self.conv_cls = nn.Conv2d(cls_channels, A * self.num_cls, 1)
        self.conv_dir_cls = nn.Conv2d(cls_channels, A * 2, 1) \
            if use_direction_classifier else None

    def _outputs(self, trunk, cls_map, concat):
        flat = RPNHead._flatten
        out = {"box_preds": flat(self.conv_box(trunk), self.box_code_size),
               "cls_preds": flat(self.conv_cls(cls_map), self.num_cls),
               "trunk": trunk, "gated_bev_feat": trunk,
               "gated_concat_feat": concat}
        if self.conv_dir_cls is not None:
            out["dir_cls_preds"] = flat(self.conv_dir_cls(cls_map), 2)
        return out


class FusionRPN(_CameraRPN):
    """BEV trunk + the image branch + gated fusion + heads. Outputs as
    JAX's: box_preds from the trunk, cls_preds (and dir_cls_preds) from the
    fused map, trunk and gated_bev_feat the (ungated) trunk,
    gated_concat_feat the fused map [B, fusion_features, H, W]."""

    def __init__(self, in_channels, layer_nums=(5,), layer_strides=(1,),
                 num_filters=(128,), upsample_strides=(1,),
                 num_upsample_filters=(128,), num_class=1,
                 num_anchor_per_loc=2, box_code_size=7,
                 encode_background_as_zeros=True,
                 use_direction_classifier=False, use_groupnorm=False,
                 num_groups=32, fusion_features=128):
        nf = fusion_features
        super().__init__(in_channels, layer_nums, layer_strides, num_filters,
                         upsample_strides, num_upsample_filters,
                         use_groupnorm, num_groups, nf, num_class,
                         num_anchor_per_loc, box_code_size,
                         encode_background_as_zeros,
                         use_direction_classifier)
        tc = self.trunk_channels
        self.depth_refine0 = ConvBlock(FPN_FEATURES, 256, 3)
        self.depth_refine1 = ConvBlock(256, nf, 1)
        self.bev_gate = BasicGate(tc)
        self.crop_gate = BasicGate(tc)
        self.fusion_refine0 = ConvBlock(tc + nf, 2 * nf, 3)
        self.fusion_refine1 = ConvBlock(2 * nf, nf, 1)

    def fuse(self, trunk, projected):
        """The refine blocks, the gates and the fused map [B,
        fusion_features, H, W] from the trunk and the projected P3."""
        refined = self.depth_refine1(self.depth_refine0(projected))
        fused = torch.cat([self.bev_gate(trunk, trunk),
                           self.crop_gate(trunk, refined)], 1)
        return self.fusion_refine1(self.fusion_refine0(fused))

    def forward(self, bev, image, proj_pix, proj_bev, proj_valid):
        trunk = self.trunk(bev)
        p3 = self.fpn18(image.permute(0, 3, 1, 2))
        projected = project_image_to_bev(p3, proj_pix, proj_bev, proj_valid,
                                         trunk.shape[-2:])
        fused = self.fuse(trunk, projected)
        return self._outputs(trunk, fused, fused)


def gather_image_features(p3, idxs, valid, bilinear: bool = False):
    """Per-BEV-cell image features — the reference's `feature_crop`
    (nearest) / `feature_crop_interp` (bilinear).

    p3 [B, C, Hf, Wf]; idxs [B, H, W, 2] fractional (row, col) P3 pixel a
    cell; valid [B, H, W]. Returns [B, C, H, W], zero at invalid cells.
    Nearest rounds half to even (`jnp.round`, `torch.round`); bilinear
    clips to the map and weighs the four neighbours in JAX's order."""
    B, C, Hf, Wf = p3.shape
    H, W = idxs.shape[1:3]
    ir = idxs[..., 0].reshape(B, -1)
    ic = idxs[..., 1].reshape(B, -1)
    if not bilinear:
        out = _flat_pixels(p3, torch.round(ir).long(), torch.round(ic).long())
    else:
        r = ir.clamp(0.0, Hf - 1.0)
        c = ic.clamp(0.0, Wf - 1.0)
        r0, c0 = torch.floor(r), torch.floor(c)
        wr = (r - r0)[:, None, :]
        wc = (c - c0)[:, None, :]
        r0, c0 = r0.long(), c0.long()
        r1 = (r0 + 1).clamp(max=Hf - 1)
        c1 = (c0 + 1).clamp(max=Wf - 1)
        out = (_flat_pixels(p3, r0, c0) * (1 - wr) * (1 - wc) +
               _flat_pixels(p3, r0, c1) * (1 - wr) * wc +
               _flat_pixels(p3, r1, c0) * wr * (1 - wc) +
               _flat_pixels(p3, r1, c1) * wr * wc)
    out = torch.where(valid.reshape(B, 1, -1), out, 0.0)
    return out.reshape(B, C, H, W)


class ZSliceFusionRPN(_CameraRPN):
    """Per-z-slice feature-crop fusion RPN — the reference's
    `RPN_SECOND_FUSION`: every head on the BEV trunk; the FPN runs in the
    module's mode (its BatchNorm statistics update in training) without
    gradient (JAX's `lax.stop_gradient` of P3), then P3 is cropped once per
    z-slice at the host-projected pixels (`gather_image_features`, nearest),
    the NUM_Z_SLICES crops stacked on channels (slice 0's first) and, with
    `concat_features`, compressed by a 1x1 conv: gated_concat_feat
    [B, concat_features or NUM_Z_SLICES · 256, H, W]."""

    def __init__(self, in_channels, layer_nums=(5,), layer_strides=(1,),
                 num_filters=(128,), upsample_strides=(1,),
                 num_upsample_filters=(128,), num_class=1,
                 num_anchor_per_loc=2, box_code_size=7,
                 encode_background_as_zeros=True,
                 use_direction_classifier=False, use_groupnorm=False,
                 num_groups=32, concat_features=0):
        super().__init__(in_channels, layer_nums, layer_strides, num_filters,
                         upsample_strides, num_upsample_filters,
                         use_groupnorm, num_groups, None, num_class,
                         num_anchor_per_loc, box_code_size,
                         encode_background_as_zeros,
                         use_direction_classifier)
        stacked = NUM_Z_SLICES * FPN_FEATURES
        self.concat_compress = nn.Conv2d(stacked, concat_features, 1) \
            if concat_features else None
        self.concat_channels = concat_features or stacked

    def crops(self, p3, idxs_norm, idxs_valid):
        """The z-slice crops of P3, stacked and compressed →
        gated_concat_feat."""
        D = idxs_norm.shape[1]
        out = torch.cat([gather_image_features(p3, idxs_norm[:, i],
                                               idxs_valid[:, i])
                         for i in range(D)], 1)
        if self.concat_compress is not None:
            out = self.concat_compress(out)
        return out

    def forward(self, bev, image, idxs_norm, idxs_valid):
        trunk = self.trunk(bev)
        with torch.no_grad():
            p3 = self.fpn18(image.permute(0, 3, 1, 2))
        return self._outputs(trunk, trunk,
                             self.crops(p3, idxs_norm, idxs_valid))


class FusionVoxelNet(nn.Module):
    """VFE → middle → FusionRPN: `vfe`, `middle`, `rpn`, the JAX module's
    names."""

    def __init__(self, vfe_class_name, vfe_kwargs, middle_class_name,
                 middle_kwargs, rpn_kwargs):
        super().__init__()
        self.vfe = VFE_REGISTRY[vfe_class_name](**vfe_kwargs)
        self.middle = MIDDLE_REGISTRY[middle_class_name](**middle_kwargs)
        self.rpn = FusionRPN(self.middle.out_channels, **rpn_kwargs)

    def forward(self, voxels, num_points, coords, voxel_valid, image,
                proj_pix, proj_bev, proj_valid):
        """VoxelNet's voxel inputs, the image [B, Hi, Wi, 3] and the
        points' projections proj_pix / proj_bev [B, P, 2], proj_valid
        [B, P] → the RPN's outputs and stage_overflow."""
        vf = self.vfe(voxels, num_points, coords)
        vf = torch.where(voxel_valid[..., None], vf, 0.0)
        bev, overflow = self.middle(vf, coords, voxel_valid)
        out = self.rpn(bev, image, proj_pix, proj_bev, proj_valid)
        out["stage_overflow"] = overflow
        return out


def fusion_args(cfg):
    """The fusion models' constructor arguments: `voxelnet_args`' vfe,
    middle and rpn ones with the RPN's `dtype` dropped (JAX's fusion
    builders pop it: the fusion models compute in fp32 whatever the
    config's mixed precision), the NetInfo, assigner and coder."""
    from .build import voxelnet_args
    args, info, assigner, coder = voxelnet_args(cfg)
    rpn_kwargs = dict(args[4])
    rpn_kwargs.pop("dtype", None)
    return (*args[:4], rpn_kwargs), info, assigner, coder


def build_fusion_voxelnet(cfg, device="cuda", seed: int = 0):
    """ModelConfig → (FusionVoxelNet, spec, info, assigner, coder), the
    one-stage camera-fusion model. The module is in eval mode on `device`
    (the CUDA card unless the caller asks for the CPU), fp32, with weights
    drawn by `init_weights_` from `seed`."""
    from .build import init_weights_
    from .detector import build_detector_spec
    dev = resolve_device(device)
    args, info, assigner, coder = fusion_args(cfg)
    module = FusionVoxelNet(*args)
    init_weights_(module, seed)
    return module.to(dev).eval(), build_detector_spec(cfg), info, \
        assigner, coder


def compute_bev_zslice_projection(rect, Trv2c, P2, image_shape, pc_range,
                                  voxel_size, out_stride, bev_hw,
                                  num_z_slices, image_stride: int = 8):
    """Host/numpy: the P3 pixel of the centre of every (z-slice, BEV cell)
    — the data-layer contract behind the reference's `idxs_norm`.

    Returns (idxs [D, H, W, 2] f32 fractional (row, col), valid
    [D, H, W])."""
    H, W = bev_hw
    D = num_z_slices
    xs = pc_range[0] + (np.arange(W) + 0.5) * voxel_size[0] * out_stride
    ys = pc_range[1] + (np.arange(H) + 0.5) * voxel_size[1] * out_stride
    z_step = (pc_range[5] - pc_range[2]) / D
    zs = pc_range[2] + (np.arange(D) + 0.5) * z_step
    gz, gy, gx = np.meshgrid(zs, ys, xs, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    cam = box_np.lidar_to_camera(pts, rect, Trv2c)
    with np.errstate(invalid="ignore", divide="ignore"):
        uv = box_np.project_to_image(cam, P2)
    uv = np.nan_to_num(uv, nan=-1.0, posinf=-1.0, neginf=-1.0)
    valid = ((cam[:, 2] > 0) &
             (uv[:, 0] >= 0) & (uv[:, 0] < image_shape[1]) &
             (uv[:, 1] >= 0) & (uv[:, 1] < image_shape[0]))
    idxs = np.stack([uv[:, 1], uv[:, 0]], -1) / image_stride
    return (idxs.reshape(D, H, W, 2).astype(np.float32),
            valid.reshape(D, H, W))


def compute_image_projection(points, points_mask, rect, Trv2c, P2,
                             image_shape, pc_range, voxel_size, out_stride,
                             bev_hw, image_stride: int = 8):
    """Host/numpy: each point's P3 pixel and BEV cell (the fusion
    examples' projection contract). Returns (pix [P, 2] int32 (row, col),
    bev [P, 2] int32 (row, col), valid [P] bool)."""
    xyz = points[:, :3]
    cam = box_np.lidar_to_camera(xyz, rect, Trv2c)
    with np.errstate(invalid="ignore", divide="ignore"):
        uv = box_np.project_to_image(cam, P2)
    # padded points sit at the origin → cam depth 0 → NaN pixels; they are
    # excluded by `valid` below, but must not poison the int cast
    uv = np.nan_to_num(uv, nan=-1.0, posinf=-1.0, neginf=-1.0)
    pix = np.stack([uv[:, 1], uv[:, 0]], 1) / image_stride   # (row, col)
    bev_r = (xyz[:, 1] - pc_range[1]) / (voxel_size[1] * out_stride)
    bev_c = (xyz[:, 0] - pc_range[0]) / (voxel_size[0] * out_stride)
    bev = np.stack([bev_r, bev_c], 1)
    valid = (points_mask & (cam[:, 2] > 0) &
             (uv[:, 0] >= 0) & (uv[:, 0] < image_shape[1]) &
             (uv[:, 1] >= 0) & (uv[:, 1] < image_shape[0]) &
             (bev_r >= 0) & (bev_r < bev_hw[0]) &
             (bev_c >= 0) & (bev_c < bev_hw[1]))
    return (pix.astype(np.int32), bev.astype(np.int32),
            valid.astype(bool))


__all__ = ["BasicBlock", "ResNetFPN18", "BasicGate", "projection_winners",
           "project_image_to_bev", "FusionRPN", "gather_image_features",
           "ZSliceFusionRPN", "FusionVoxelNet", "fusion_args",
           "build_fusion_voxelnet", "compute_bev_zslice_projection",
           "compute_image_projection"]
