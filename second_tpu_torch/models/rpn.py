"""BEV region-proposal network — the port of `second_tpu/models/rpn.py`
(`RPN`/`RPNV2` trunk and `RPNHead`), in NCHW.

Heads are fp32 whatever the trunk's compute dtype (fp64 in an fp64 model).
Their outputs are returned in the JAX package's anchor layout: the per-cell
head axis is [anchor, code], flattened row-major over (H, W, anchor), i.e.
box_preds [B, H*W*A, code].
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import at_least_fp32
from .layers import ConvBlock, DeconvBlock


class RPNBase(nn.Module):
    """Staged conv trunk: per stage one strided ConvBlock plus `layer_nums`
    stride-1 ConvBlocks, then a DeconvBlock to the common resolution; the
    stage outputs are concatenated on channels."""

    def __init__(self, in_channels, layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 num_filters: Sequence[int] = (128, 128, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 num_upsample_filters: Sequence[int] = (256, 256, 256),
                 use_groupnorm=False, num_groups=32, dtype=None):
        super().__init__()
        if not (len(layer_nums) == len(layer_strides) == len(num_filters) ==
                len(upsample_strides) == len(num_upsample_filters)):
            raise ValueError("RPN stage lists differ in length")
        self.layer_nums = tuple(layer_nums)
        self.dtype = dtype
        norm = dict(use_groupnorm=use_groupnorm, num_groups=num_groups)
        # flat, in the flax auto-naming order (ConvBlock_0, ConvBlock_1, ...)
        self.convs = nn.ModuleList()
        self.deconvs = nn.ModuleList()
        cin = in_channels
        for i, n in enumerate(layer_nums):
            self.convs.append(ConvBlock(cin, num_filters[i], 3,
                                        layer_strides[i], dtype=dtype, **norm))
            for _ in range(n):
                self.convs.append(ConvBlock(num_filters[i], num_filters[i], 3,
                                            1, dtype=dtype, **norm))
            self.deconvs.append(DeconvBlock(num_filters[i],
                                            num_upsample_filters[i],
                                            upsample_strides[i], dtype=dtype,
                                            **norm))
            cin = num_filters[i]

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        ups, j = [], 0
        for i, n in enumerate(self.layer_nums):
            for _ in range(n + 1):
                x = self.convs[j](x)
                j += 1
            ups.append(self.deconvs[i](x))
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]


class RPNHead(nn.Module):
    """1x1 cls / box / direction heads, fp32."""

    def __init__(self, in_channels, num_class=1, num_anchor_per_loc=2,
                 box_code_size=7, encode_background_as_zeros=True,
                 use_direction_classifier=False):
        super().__init__()
        self.num_anchor_per_loc = num_anchor_per_loc
        self.box_code_size = box_code_size
        self.num_cls = num_class if encode_background_as_zeros \
            else num_class + 1
        A = num_anchor_per_loc
        self.box = nn.Conv2d(in_channels, A * box_code_size, 1)
        self.cls = nn.Conv2d(in_channels, A * self.num_cls, 1)
        self.dir = nn.Conv2d(in_channels, A * 2, 1) \
            if use_direction_classifier else None

    @staticmethod
    def _flatten(x, code):
        """[B, A*code, H, W] → [B, H*W*A, code]."""
        B = x.shape[0]
        return x.permute(0, 2, 3, 1).reshape(B, -1, code)

    def forward(self, x):
        x = at_least_fp32(x)
        out = {"box_preds": self._flatten(self.box(x), self.box_code_size),
               "cls_preds": self._flatten(self.cls(x), self.num_cls)}
        if self.dir is not None:
            out["dir_cls_preds"] = self._flatten(self.dir(x), 2)
        return out


class RPN(nn.Module):
    """Trunk + heads (the reference's RPN / RPNV2)."""

    def __init__(self, in_channels, layer_nums=(3, 5, 5),
                 layer_strides=(2, 2, 2), num_filters=(128, 128, 256),
                 upsample_strides=(1, 2, 4),
                 num_upsample_filters=(256, 256, 256), num_class=1,
                 num_anchor_per_loc=2, box_code_size=7,
                 encode_background_as_zeros=True,
                 use_direction_classifier=False, use_groupnorm=False,
                 num_groups=32, dtype=None):
        super().__init__()
        self.trunk = RPNBase(in_channels, layer_nums, layer_strides,
                             num_filters, upsample_strides,
                             num_upsample_filters, use_groupnorm, num_groups,
                             dtype)
        self.head = RPNHead(sum(num_upsample_filters), num_class,
                            num_anchor_per_loc, box_code_size,
                            encode_background_as_zeros,
                            use_direction_classifier)

    def forward(self, x):
        trunk = self.trunk(x)
        out = self.head(trunk)
        out["trunk"] = trunk
        return out
