"""The eval forward of a dense BEV module with its rows sharded over the
ranks — the port of `second_tpu/parallel/spatial.py`.

JAX places the activation with its H axis sharded over the mesh and lets
XLA's SPMD partitioner add each conv's halo exchange. Here each rank holds
its h rows of the global H = world · h (rank r the rows [r h, (r + 1) h))
and the module's own forward runs on them, its `ConvBlock`s swapped for
row-sharded ones for the call:
- a k x k conv of stride s under SAME padding reads, for its output rows of
  this rank, `pad_before` rows above the shard and k - s - `pad_before`
  below it, with the padding of the GLOBAL H (`same_padding(H, k, s)`; a
  stride-2, k = 3 conv on an even H pads (0, 1): one row from the rank
  below, none from above). Those rows come from the neighbours
  (`dist.batch_isend_irecv`); zeros stand only at the global borders. The
  shard height must divide by the stride.
- a `DeconvBlock` (kernel = stride) and the 1 x 1 heads need no halo;
- the batch norms in eval are per element;
- a GroupNorm (an RPN with `use_groupnorm`) normalises each example over
  all its rows: each rank sums its rows' values and squares per example
  and group, the sums are all-reduced over the group, and the rows are
  normalised by flax's GroupNorm formula (mean and mean square, variance
  their difference clipped at 0, eps 1e-3), as XLA reduces JAX's over the
  sharded rows.
Any other layer (a conv of another shape) is refused by name, as is a shard
height a stride does not divide. The input is never gathered. `train=True`
runs the same forward under no gradient, as JAX's `run` applies the module
with `train=True` and no mutable collection: a module with batch norms is
refused there (its batch statistics; JAX's fails), and so is an input that
asks for a gradient (the halo exchange has no backward).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import (ConvBlock, DeconvBlock, FlaxBatchNorm2d,
                             same_padding)
from ..models.rpn import RPN, RPNBase, RPNHead
from .mesh import data_sharding, gather_ranks

# the layers the row rule covers (the conv modules inside the blocks hold
# their weights; the heads' 1 x 1 convs are checked for their shape)
_COVERED = (RPN, RPNBase, RPNHead, nn.ModuleList, ConvBlock, DeconvBlock,
            FlaxBatchNorm2d, nn.GroupNorm, nn.Conv2d, nn.ConvTranspose2d)


def _check_layers(module, train):
    held = {id(m.conv) for m in module.modules()
            if isinstance(m, (ConvBlock, DeconvBlock))}
    for name, m in module.named_modules():
        name = name or type(module).__name__
        if not isinstance(m, _COVERED):
            raise ValueError(f"make_spatial_forward: layer {name} "
                             f"({type(m).__name__}) is not covered by the "
                             f"row-sharding rule")
        if train and isinstance(m, FlaxBatchNorm2d):
            raise ValueError(f"make_spatial_forward: train=True with batch "
                             f"norm {name}: its batch statistics would be "
                             f"updated, and the forward takes no mutable "
                             f"state (JAX's fails there too)")
        if isinstance(m, nn.Conv2d) and id(m) not in held and (
                m.kernel_size != (1, 1) or m.stride != (1, 1) or
                m.padding != (0, 0)):
            raise ValueError(f"make_spatial_forward: layer {name}: a "
                             f"{m.kernel_size} conv of stride {m.stride} "
                             f"outside a ConvBlock")
        if isinstance(m, DeconvBlock) and \
                m.conv.kernel_size != m.conv.stride:
            raise ValueError(f"make_spatial_forward: layer {name}: a deconv "
                             f"whose kernel is not its stride")


def _peer(group, r):
    return r if group is None or group is dist.group.WORLD else \
        dist.get_global_rank(group, r)


def exchange_rows(x, above, below, group):
    """(the `above` rows over this rank's shard x [B, C, h, W]: the last
    rows of the rank above, or zeros at the top border; the `below` rows
    under it: the first rows of the rank below, or zeros at the bottom)."""
    rank, world = data_sharding(group)
    B, C, h, W = x.shape
    top = x.new_zeros((B, C, above, W))
    bottom = x.new_zeros((B, C, below, W))
    ops = []
    if above and rank + 1 < world:
        ops.append(dist.P2POp(dist.isend, x[:, :, h - above:].contiguous(),
                              _peer(group, rank + 1), group))
    if above and rank > 0:
        ops.append(dist.P2POp(dist.irecv, top, _peer(group, rank - 1),
                              group))
    if below and rank > 0:
        ops.append(dist.P2POp(dist.isend, x[:, :, :below].contiguous(),
                              _peer(group, rank - 1), group))
    if below and rank + 1 < world:
        ops.append(dist.P2POp(dist.irecv, bottom, _peer(group, rank + 1),
                              group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return top, bottom


def _conv_rows(block, name, group, x):
    """`ConvBlock.forward` on this rank's rows x [B, C, h, W]: its halo from
    the neighbours under the global H's SAME padding, then the block with
    no padding of its own in H; → the rank's h / stride output rows."""
    k, s = block.kernel_size, block.stride
    h = x.shape[2]
    world = data_sharding(group)[1]
    if world == 1:
        return ConvBlock.forward(block, x)
    if h % s:
        raise ValueError(f"make_spatial_forward: layer {name}: a shard of "
                         f"{h} rows does not divide by its stride {s}")
    before, _ = same_padding(h * world, k, s)
    below = max(k - s - before, 0)
    if max(before, below) > h:
        raise ValueError(f"make_spatial_forward: layer {name}: a halo of "
                         f"{max(before, below)} rows is deeper than a shard "
                         f"of {h}")
    top, bottom = exchange_rows(x, before, below, group)
    y = ConvBlock.forward(block, torch.cat([top, x, bottom], 2),
                          pad_h=(0, 0))
    return y[:, :, :h // s]


def _group_norm_rows(norm, group, x):
    """`norm` (an nn.GroupNorm) on this rank's rows x [B, C, h, W] of the
    global map, as flax's GroupNorm on all the rows: the per-example,
    per-group sums of x and x² all-reduced over the group, mean and mean
    square from them, the variance their difference clipped at 0, then
    (x - mean) · (rsqrt(var + eps) · scale) + bias."""
    B, C, h, W = x.shape
    G = norm.num_groups
    world = data_sharding(group)[1]
    xg = x.reshape(B, G, C // G, h, W)
    sums = torch.stack([xg.sum((2, 3, 4)), (xg * xg).sum((2, 3, 4))])
    dist.all_reduce(sums, group=group)
    mean, mean2 = sums / (C // G * h * W * world)       # [B, G] each
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + norm.eps)[..., None] * \
        norm.weight.to(x.dtype).view(G, C // G)
    y = (xg - mean[..., None, None, None]) * mul[..., None, None] + \
        norm.bias.to(x.dtype).view(G, C // G)[..., None, None]
    return y.reshape(B, C, h, W)


@contextlib.contextmanager
def _rows(module, group):
    blocks = [(n, m) for n, m in module.named_modules()
              if isinstance(m, ConvBlock)]
    norms = [m for m in module.modules() if isinstance(m, nn.GroupNorm)] \
        if data_sharding(group)[1] > 1 else []
    try:
        for name, m in blocks:
            m.forward = (lambda x, m=m, name=name:
                         _conv_rows(m, name, group, x))
        for m in norms:
            m.forward = lambda x, m=m: _group_norm_rows(m, group, x)
        yield
    finally:
        for _, m in blocks:
            m.__dict__.pop("forward", None)
        for m in norms:
            m.__dict__.pop("forward", None)


def make_spatial_forward(module, group=None, spatial_dim: int = 2,
                         train: bool = False):
    """`run(x) -> out`: the forward of the dense BEV module `module` (an
    RPN, NCHW) on this rank's rows x [B, C, h, W] of a global map
    [B, C, world · h, W], in eval mode or, with `train`, in train mode
    (a module without batch norms); `out` is the module's output for those
    rows (`gather_rows` puts the ranks' outputs together). The parameters
    must be the same on every rank (`mesh.replicate_state`). Only the rows
    (spatial_dim 2) are sharded, and no gradient is taken: the halo
    exchange has no backward."""
    if spatial_dim != 2:
        raise ValueError(f"make_spatial_forward: spatial_dim {spatial_dim}; "
                         f"the rows (2, NCHW) are sharded")
    _check_layers(module, train)

    def run(x):
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("make_spatial_forward: no gradient (the halo "
                             "exchange has no backward)")
        module.train(train)
        with torch.no_grad(), _rows(module, group):
            return module(x)

    return run


def gather_rows(out, group=None):
    """The ranks' outputs of `make_spatial_forward`'s run put together in
    rank order: a 4-D map [B, C, h, W] on its rows, a head's flattened
    [B, h · W · A, code] (rows outermost, `RPNHead._flatten`) on axis 1."""
    if isinstance(out, dict):
        return {k: gather_rows(v, group) for k, v in out.items()}
    return gather_ranks(out, group, dim=2 if out.dim() == 4 else 1)


__all__ = ["make_spatial_forward", "gather_rows", "exchange_rows"]
