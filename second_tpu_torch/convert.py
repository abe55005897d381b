"""Carry the JAX model's weights across to the port.

`state_dict_from_jax(variables)` takes the flax variables of
`second_tpu.models.VoxelNet` as a nested dict of numpy arrays ({"params":
..., "batch_stats": ...}) and returns the `state_dict` of this package's
`VoxelNet`. `grads_from_jax(grads)` maps a tree with the params' structure,
a JAX gradient, to the port's parameter names the same way (each layout
change is a permutation, so it carries gradients as it carries weights).
A two-stage tree (`second_tpu.models.TwoStageVoxelNet`: `stage1/...` and
`second_rpn/{reg_tower,cls_tower}/Conv_0..4`, `conv_box_second`,
`conv_cls_second`, `conv_dir_second`) maps onto `TwoStageVoxelNet`'s
`stage1.*` and `second_rpn.*` the same way, and a temporal tree
(`second_tpu.models.temporal.TemporalVoxelNet`: `vfe`, `middle`,
`bev_fusion/conv_gating_bev`, `rpn`, `second_rpn`) onto
`TemporalVoxelNet`'s and `TemporalSequenceVoxelNet`'s names. The
camera-fusion trees map the same way: `FusionVoxelNet`'s (`vfe`,
`middle`, `rpn` with `trunk`, `fpn18`, `depth_refine0/1`, `bev_gate`,
`crop_gate`, `fusion_refine0/1`, `conv_box`, `conv_cls`, `conv_dir_cls`),
`FusionTwoStageVoxelNet`'s (that under `stage1`, and `second_rpn`) and
`TemporalFusionVoxelNet`'s (the temporal tree with `rpn` a
`ZSliceFusionRPN`: `trunk`, `fpn18`, `concat_compress` and the 1x1
heads); `ResNetFPN18`'s auto-named flax modules map as `_fpn18` lists.
`tracking_state_dict_from_jax(params)` maps the tracking net's tree
(`second_tpu.models.tracking.SequenceTrackNet` / `TrackNet`, flax's
automatic names) onto `models/tracking.py`'s. The joint detector +
tracker's tree (`second_tpu.models.joint_track.JointDetTrack`: the
temporal tree under `detector`, the tracking heads `appearance`,
`point_net`, `fusion`, `w_det` and `w_link` beside it) maps onto
`models/joint_track.py`'s `detector.*` and the heads' names.
A sparse middle's blocks are numbered per class in flax (`SubMBlock_i`,
`DownBlock_i`, `SparseBasicBlock_i` with `proj`, `kernel0/1` and
`MaskedBatchNorm_0/1`, `SparseBottleneck_i` with `proj`,
`kernel1x1_a`, `kernel3x3`, `kernel1x1_b` and `MaskedBatchNorm_0..2`) and
map onto the port's ModuleList of that kind (`subm`, `down`, `res`,
`bottleneck`); the VFE layers' trees (`VFELayer_i/DenseBNReLU_0`) onto
`vfe.vfe_layers.i.dense`, the encoder's own `DenseBNReLU_i` onto
`vfe.layers.i`.
Sparse kernels stay [K, Cin, Cout] in tap order, 1x1 kernels [Cin, Cout];
dense conv kernels go
from HWIO to OIHW; transposed-conv kernels go from flax's (kh, kw, in,
out), applied without a kernel transpose, to torch's (in, out, kh, kw)
with the spatial axes flipped; the encoders' Dense kernels go from
[in, out] to [out, in]. A model whose encoder or middle has no parameters
(VFE-V3, `SimpleVoxel`, the PointPillars scatter) has no tree for it; the
IoU head's tree, `params["iou"]`, is there only with the IoU branch.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _numbered(tree, prefix):
    """The children `prefix_0, prefix_1, ...` of a flax module, in order."""
    idx = sorted(int(m.group(1)) for k in tree
                 for m in [re.fullmatch(rf"{prefix}_(\d+)", k)] if m)
    if idx != list(range(len(idx))):
        raise ValueError(f"non-contiguous {prefix}_* modules: {idx}")
    return [tree[f"{prefix}_{i}"] for i in idx]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _norm(out, name, params, stats):
    """Flax BatchNorm / MaskedBatchNorm / GroupNorm → torch norm entries."""
    out[f"{name}.weight"] = _t(params["scale"])
    out[f"{name}.bias"] = _t(params["bias"])
    if stats is not None:
        out[f"{name}.running_mean"] = _t(stats["mean"])
        out[f"{name}.running_var"] = _t(stats["var"])


# flax's per-class block names in a sparse middle → the port's ModuleLists
_MIDDLE_BLOCKS = (("SubMBlock", "subm"), ("DownBlock", "down"),
                  ("SparseBasicBlock", "res"),
                  ("SparseBottleneck", "bottleneck"))
# the residual blocks' kernels, by the same name in both trees
_RESIDUAL_KERNELS = ("proj", "kernel0", "kernel1", "kernel1x1_a",
                     "kernel3x3", "kernel1x1_b")


def _dense(out, name, p, s):
    """A `DenseBNReLU` tree (`Dense_0` [in, out] → [out, in], `BatchNorm_0`)
    → the port's `DenseBNReLU` entries under `name`."""
    out[f"{name}.linear.weight"] = _t(np.asarray(p["Dense_0"]["kernel"]).T)
    _batch_norm(out, f"{name}.norm", p["BatchNorm_0"],
                None if s is None else s["BatchNorm_0"])


def _middle(out, name, mp, ms):
    """A sparse middle's tree (params mp, batch stats ms or None) → the
    port's entries under `name`: each per-class numbered block onto the
    ModuleList of its kind (`_MIDDLE_BLOCKS`)."""
    for kind, attr in _MIDDLE_BLOCKS:
        for i, p in enumerate(_numbered(mp, kind)):
            pre = f"{name}.{attr}.{i}"
            s = None if ms is None else ms[f"{kind}_{i}"]
            if "kernel" in p:
                out[f"{pre}.weight"] = _t(p["kernel"])
            for k in _RESIDUAL_KERNELS:
                if k in p:
                    out[f"{pre}.{k}"] = _t(p[k])
            for j, bn in enumerate(_numbered(p, "MaskedBatchNorm")):
                _norm(out, f"{pre}.bn" if "kernel" in p else f"{pre}.bn{j}",
                      bn, None if s is None else s[f"MaskedBatchNorm_{j}"])


def _convert(params, stats) -> dict:
    """params (and batch_stats, or None for a params-only tree) → port
    names."""
    out = {}
    vp = params.get("vfe", {})
    vs = None if stats is None else stats.get("vfe", {})
    for i, p in enumerate(_numbered(vp, "VFELayer")):
        _dense(out, f"vfe.vfe_layers.{i}.dense", p["DenseBNReLU_0"],
               None if vs is None else vs[f"VFELayer_{i}"]["DenseBNReLU_0"])
    for i, p in enumerate(_numbered(vp, "DenseBNReLU")):
        _dense(out, f"vfe.layers.{i}", p,
               None if vs is None else vs[f"DenseBNReLU_{i}"])

    _middle(out, "middle", params.get("middle", {}),
            None if stats is None else stats.get("middle", {}))

    tp = params["rpn"]["trunk"]
    ts = None if stats is None else stats.get("rpn", {}).get("trunk", {})
    for kind, attr, conv in (("ConvBlock", "convs", "Conv_0"),
                             ("DeconvBlock", "deconvs", "ConvTranspose_0")):
        for i in range(len(_numbered(tp, kind))):
            p = tp[f"{kind}_{i}"]
            k = np.asarray(p[conv]["kernel"])
            if conv == "Conv_0":
                w = k.transpose(3, 2, 0, 1)                  # HWIO → OIHW
            else:
                w = k[::-1, ::-1].transpose(2, 3, 0, 1)      # → (I, O, H, W)
            out[f"rpn.trunk.{attr}.{i}.conv.weight"] = _t(w)
            name = f"rpn.trunk.{attr}.{i}.norm"
            if "GroupNorm_0" in p:
                _norm(out, name, p["GroupNorm_0"], None)
            elif ts is None:
                _norm(out, name, p["BatchNorm_0"], None)
            else:
                _norm(out, name, p["BatchNorm_0"],
                      ts[f"{kind}_{i}"]["BatchNorm_0"])
                out[f"{name}.num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.int64)

    if "head" not in params["rpn"]:
        _camera_rpn(out, params["rpn"], None if stats is None
                    else stats.get("rpn", {}))
        return out
    hp = params["rpn"]["head"]
    for i, attr in enumerate(("box", "cls", "dir")[:len(_numbered(hp,
                                                                  "Conv"))]):
        c = hp[f"Conv_{i}"]
        out[f"rpn.head.{attr}.weight"] = _t(
            np.asarray(c["kernel"]).transpose(3, 2, 0, 1))
        out[f"rpn.head.{attr}.bias"] = _t(c["bias"])

    # the IoU head: its 3x3 convs, then the 1x1 output conv
    ip = params.get("iou")
    if ip is not None:
        convs = _numbered(ip, "Conv")
        for i, c in enumerate(convs):
            name = "iou.out" if i == len(convs) - 1 else f"iou.convs.{i}"
            out[f"{name}.weight"] = _t(
                np.asarray(c["kernel"]).transpose(3, 2, 0, 1))
            out[f"{name}.bias"] = _t(c["bias"])
    return out


def _conv(out, name, c):
    """A flax nn.Conv (kernel HWIO, bias if it has one) → torch Conv2d
    entries (OIHW)."""
    out[f"{name}.weight"] = _t(np.asarray(c["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in c:
        out[f"{name}.bias"] = _t(c["bias"])


def _batch_norm(out, name, params, stats):
    """A flax BatchNorm (with its statistics where `stats` is not None) →
    a torch BatchNorm's entries."""
    _norm(out, name, params, stats)
    if stats is not None:
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _sub(stats, name):
    return None if stats is None else stats[name]


def _fpn18(out, name, p, s):
    """`ResNetFPN18`'s flax tree (auto-named: the stem `Conv_0` and
    `BatchNorm_0`, `BasicBlock_0..7` with `Conv_0..2` / `BatchNorm_0..2`,
    the FPN's `Conv_1..4`) → the port's `stem`, `stem_norm`,
    `blocks.i.{conv1,norm1,conv2,norm2,down,down_norm}`, `lateral5`,
    `lateral4`, `lateral3`, `smooth`."""
    _conv(out, f"{name}.stem", p["Conv_0"])
    _batch_norm(out, f"{name}.stem_norm", p["BatchNorm_0"],
                _sub(s, "BatchNorm_0"))
    for i, bp in enumerate(_numbered(p, "BasicBlock")):
        bs = _sub(s, f"BasicBlock_{i}")
        for j, (conv, norm) in enumerate((("conv1", "norm1"),
                                          ("conv2", "norm2"),
                                          ("down", "down_norm"))):
            if f"Conv_{j}" in bp:
                _conv(out, f"{name}.blocks.{i}.{conv}", bp[f"Conv_{j}"])
                _batch_norm(out, f"{name}.blocks.{i}.{norm}",
                            bp[f"BatchNorm_{j}"], _sub(bs, f"BatchNorm_{j}"))
    for j, lat in enumerate(("lateral5", "lateral4", "lateral3", "smooth")):
        _conv(out, f"{name}.{lat}", p[f"Conv_{j + 1}"])


def _camera_rpn(out, rp, rs):
    """A fusion RPN's tree beyond the trunk (`FusionRPN`: `fpn18`,
    `depth_refine0/1`, `bev_gate`, `crop_gate`, `fusion_refine0/1`;
    `ZSliceFusionRPN`: `fpn18`, `concat_compress`; both: `conv_box`,
    `conv_cls`, `conv_dir_cls`) → the port's `rpn.*` names."""
    _fpn18(out, "rpn.fpn18", rp["fpn18"], _sub(rs, "fpn18"))
    for name in ("depth_refine0", "depth_refine1", "fusion_refine0",
                 "fusion_refine1"):
        if name in rp:
            _conv(out, f"rpn.{name}.conv", rp[name]["Conv_0"])
            _batch_norm(out, f"rpn.{name}.norm", rp[name]["BatchNorm_0"],
                        None if rs is None else rs[name]["BatchNorm_0"])
    for name in ("bev_gate", "crop_gate"):
        if name in rp:
            _conv(out, f"rpn.{name}.conv", rp[name]["Conv_0"])
    for name in ("concat_compress", "conv_box", "conv_cls", "conv_dir_cls"):
        if name in rp:
            _conv(out, f"rpn.{name}", rp[name])


def _second_rpn(out, hp):
    """The refine head's towers and crop-sized convs → `second_rpn.*`."""
    for tower in ("reg_tower", "cls_tower"):
        for i, c in enumerate(_numbered(hp[tower], "Conv")):
            _conv(out, f"second_rpn.{tower}.convs.{i}", c)
    for name in ("conv_box_second", "conv_cls_second", "conv_dir_second"):
        if name in hp:
            _conv(out, f"second_rpn.{name}", hp[name])


def _convert_any(params, stats) -> dict:
    """A one-stage tree, a two-stage one (`stage1` and `second_rpn`) or a
    temporal one (`vfe`, `middle`, `bev_fusion`, `rpn` and `second_rpn`),
    each with the plain or a camera RPN."""
    if "second_rpn" not in params:
        return _convert(params, stats)
    if "stage1" in params:
        out = {f"stage1.{k}": v for k, v in _convert(
            params["stage1"],
            None if stats is None else stats.get("stage1", {})).items()}
    else:
        out = _convert(params, stats)
        _conv(out, "bev_fusion.conv_gating_bev",
              params["bev_fusion"]["conv_gating_bev"])
    _second_rpn(out, params["second_rpn"])
    return out


def _convert_joint(params, stats) -> dict:
    """A joint tree: the detector's under `detector.`, the tracking heads'
    beside it; any other tree as `_convert_any`."""
    if "detector" not in params:
        return _convert_any(params, stats)
    out = {f"detector.{k}": v for k, v in _convert_any(
        params["detector"],
        None if stats is None else stats.get("detector", {})).items()}
    out.update(tracking_state_dict_from_jax(
        {k: v for k, v in params.items() if k != "detector"}))
    return out


def state_dict_from_jax(variables) -> dict:
    return _convert_joint(variables["params"],
                          variables.get("batch_stats", {}))


def grads_from_jax(grads) -> dict:
    """A JAX gradient (or any tree with the params' structure) → {port
    parameter name: tensor}, the names of `VoxelNet.named_parameters()`
    (of `TwoStageVoxelNet`'s for a two-stage tree, `JointDetTrack`'s for a
    joint one)."""
    return _convert_joint(grads, None)


def tracking_state_dict_from_jax(params) -> dict:
    """The tracking net's flax params (or a gradient with their structure)
    → the port's names (`models/tracking.py`): every flax module path
    `a/b/Dense_0` becomes `a.b.Dense_0`, Dense kernels [in, out] go to
    [out, in], conv kernels HWIO to OIHW."""
    out = {}

    def walk(tree, prefix):
        if "kernel" in tree:
            k = np.asarray(tree["kernel"])
            out[f"{prefix}.weight"] = _t(k.transpose(3, 2, 0, 1)
                                         if k.ndim == 4 else k.T)
            out[f"{prefix}.bias"] = _t(tree["bias"])
            return
        for name, sub in tree.items():
            walk(sub, f"{prefix}.{name}" if prefix else name)
    walk(params, "")
    return out
