"""Sequence parallelism for the temporal detector — the port of
`second_tpu/parallel/temporal_sp.py`.

The frames of one sequence are sharded over the ranks: each rank runs the
weight-shared backbone on its frames, passes its last frame's BEV map to
the rank on its right and takes the one from its left (a ring, as JAX's
`lax.ppermute`; the only dependency between frames is the adjacent pair's
gate), then gate-fuses and detects its local pairs. The ranks' outputs put
together in rank order are the unsharded `TemporalSequenceVoxelNet`'s, with
one more pair in front: pair 0 wraps around to the last global frame, and
`pair_valid` marks it invalid.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.temporal import TemporalSequenceVoxelNet
from .mesh import data_sharding


def _ring(last, group):
    """This rank's `last` to the right neighbour, the left one's back: the
    ppermute [(i, (i + 1) % n)]. At one rank the neighbour is the rank
    itself: a local copy, no send to self."""
    rank, world = data_sharding(group)
    if world == 1:
        return last.clone()
    glob = (lambda r: r) if group is None or group is dist.group.WORLD \
        else (lambda r: dist.get_global_rank(group, r))
    got = torch.empty_like(last)
    ops = [dist.P2POp(dist.isend, last.contiguous(),
                      glob((rank + 1) % world), group),
           dist.P2POp(dist.irecv, got, glob((rank - 1) % world), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def make_sp_sequence_forward(module: TemporalSequenceVoxelNet, group=None):
    """`forward(frames, anchors) -> preds`: frames, this rank's T_local
    consecutive frames of the sequence (a dict of voxelized [T_local, ...]
    tensors; rank r holds frames [r T_local, (r + 1) T_local)), anchors
    [A, 7]. preds have leading axis T_local: entry t is the pair (global
    frame r T_local + t, the frame before it), entry 0 of rank 0 pairing
    with the sequence's last frame (the ring's wrap), which `pair_valid`
    [T_local] marks invalid; drop it to match the unsharded module's
    T - 1 outputs (`mesh.globalise` gathers the ranks' preds)."""
    rank, _ = data_sharding(group)

    @torch.no_grad()
    def forward(frames, anchors):
        module.eval()
        bev, _ = module.backbone(frames)
        prev = torch.cat([_ring(bev[-1:], group), bev[:-1]], 0)
        T = bev.shape[0]
        preds = module.fuse_and_detect(
            bev, prev, anchors[None].expand(T, *anchors.shape))
        preds["pair_valid"] = torch.arange(
            T, device=bev.device) + rank * T > 0
        return preds

    return forward


__all__ = ["make_sp_sequence_forward"]
