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
`stage1.*` and `second_rpn.*` the same way.
Sparse kernels stay [K, Cin, Cout] in tap order; dense conv kernels go
from HWIO to OIHW; transposed-conv kernels go from flax's (kh, kw, in,
out), applied without a kernel transpose, to torch's (in, out, kh, kw)
with the spatial axes flipped; the pillar encoder's Dense kernels go from
[in, out] to [out, in]. A model whose encoder or middle has no parameters
(VFE-V3, the PointPillars scatter) has no tree for it; the IoU head's tree,
`params["iou"]`, is there only with the IoU branch.
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


def _convert(params, stats) -> dict:
    """params (and batch_stats, or None for a params-only tree) → port
    names."""
    out = {}
    vp = params.get("vfe", {})
    vs = None if stats is None else stats.get("vfe", {})
    for i in range(len(_numbered(vp, "DenseBNReLU"))):
        p = vp[f"DenseBNReLU_{i}"]
        out[f"vfe.layers.{i}.linear.weight"] = _t(
            np.asarray(p["Dense_0"]["kernel"]).T)
        s = None if vs is None else vs[f"DenseBNReLU_{i}"]["BatchNorm_0"]
        _norm(out, f"vfe.layers.{i}.norm", p["BatchNorm_0"], s)
        if s is not None:
            out[f"vfe.layers.{i}.norm.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)

    mp = params.get("middle", {})
    ms = None if stats is None else stats.get("middle", {})
    for kind, attr in (("SubMBlock", "subm"), ("DownBlock", "down")):
        n = len(_numbered(mp, kind))
        for i in range(n):
            p = mp[f"{kind}_{i}"]
            out[f"middle.{attr}.{i}.weight"] = _t(p["kernel"])
            s = None if ms is None else ms[f"{kind}_{i}"]["MaskedBatchNorm_0"]
            _norm(out, f"middle.{attr}.{i}.bn", p["MaskedBatchNorm_0"], s)

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
    """A flax nn.Conv (kernel HWIO, bias) → torch Conv2d entries (OIHW)."""
    out[f"{name}.weight"] = _t(np.asarray(c["kernel"]).transpose(3, 2, 0, 1))
    out[f"{name}.bias"] = _t(c["bias"])


def _convert_any(params, stats) -> dict:
    """A one-stage tree, or a two-stage one (`stage1` and `second_rpn`)."""
    if "stage1" not in params:
        return _convert(params, stats)
    out = {f"stage1.{k}": v for k, v in _convert(
        params["stage1"],
        None if stats is None else stats.get("stage1", {})).items()}
    hp = params["second_rpn"]
    for tower in ("reg_tower", "cls_tower"):
        for i, c in enumerate(_numbered(hp[tower], "Conv")):
            _conv(out, f"second_rpn.{tower}.convs.{i}", c)
    for name in ("conv_box_second", "conv_cls_second", "conv_dir_second"):
        if name in hp:
            _conv(out, f"second_rpn.{name}", hp[name])
    return out


def state_dict_from_jax(variables) -> dict:
    return _convert_any(variables["params"],
                        variables.get("batch_stats", {}))


def grads_from_jax(grads) -> dict:
    """A JAX gradient (or any tree with the params' structure) → {port
    parameter name: tensor}, the names of `VoxelNet.named_parameters()`
    (of `TwoStageVoxelNet`'s for a two-stage tree)."""
    return _convert_any(grads, None)
