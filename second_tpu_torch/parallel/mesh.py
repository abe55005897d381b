"""Process groups and batch sharding — the port of
`second_tpu/parallel/mesh.py`.

JAX's data parallelism is one process over a device mesh: the batch is
placed sharded on a `data` axis, the state replicated, and XLA's SPMD
partitioner makes every reduction global (the gradient all-reduce, and the
norms' batch statistics over the whole batch). The port runs one process a
device in a `torch.distributed` process group. Every rank builds the same
global batch from the same seeded iterator and takes its equal slice of
each leaf's leading axis (`shard_batch`, JAX's `shard_batch` without the
placement); the module is broadcast from rank 0 (`replicate_state`); the
norms reduce their training statistics over the group (`global_moments`,
used by `models/layers.py` `_flax_batch_norm` and `models/sparse_middle.py`
`MaskedBatchNorm`), and `DistributedDataParallel` averages the gradients,
so a sharded step computes the single-device step over the global batch.

At one rank (no process group, or one of size 1) a data-parallel step is
the plain step bit for bit: the norms keep the rank's own statistics and
DDP's average over one rank changes no bit (`chip_smoke.py`'s dp phase).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


def make_group():
    """The current process group (the default one) where one is
    initialised, else None, which the functions here read as a group of
    one rank (JAX `make_mesh` over the devices the process has)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def data_sharding(group=None):
    """(this process's rank, the number of ranks) of `group` (one rank
    where None): the slice of the batch's leading axis a rank holds (JAX
    `data_sharding`, the `data` axis of the mesh)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


# the group the norms reduce their training statistics over while a
# data-parallel step runs (`sync_norms`), else None; a step's forward and
# backward run in the thread that set it
_SYNC_GROUP = None


@contextlib.contextmanager
def sync_norms(group):
    """Within this block the norms' training statistics are the whole
    batch's over `group`'s ranks (None: no group, nothing changes): what a
    data-parallel step, whose ranks each hold an equal slice of the batch,
    runs its forward under. Over a group of one rank the all-reduces run
    and change no bit."""
    global _SYNC_GROUP
    old = _SYNC_GROUP
    _SYNC_GROUP = group
    try:
        yield
    finally:
        _SYNC_GROUP = old


class _SumRanks(torch.autograd.Function):
    """t summed over a group's ranks; the backward sums the gradients over
    them too (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks of the enclosing `sync_norms` block,
    differentiably (the backward sums the gradients over the ranks too, so
    the gradient through batch statistics is the whole batch's); t itself
    outside one."""
    group = _SYNC_GROUP
    if group is None:
        return t
    return _SumRanks.apply(t, group)


def global_moments(x: torch.Tensor, dims, mask=None):
    """(mean, biased variance) of x over `dims`, a channel on each of its
    other positions: the whole batch's over the ranks of the enclosing
    `sync_norms` block (`global_sum`), x's alone outside one. Without
    `mask`, flax `BatchNorm`'s: mean(x) and mean(x²), the variance
    max(mean(x²) − mean(x)², 0); over the ranks the mean of the ranks'
    means, their slices being equal (`shard_batch`), which at one rank
    changes no bit. With `mask` (x's shape without its last, channel,
    axis), JAX's masked norm's over the rows where it is set: their count
    (clamped to 1) and sum, then the centred square sum, each summed over
    the ranks."""
    if mask is None:
        mean, sq = x.mean(dims), (x * x).mean(dims)
        if _SYNC_GROUP is not None:
            C = mean.shape[0]
            both = global_sum(torch.cat([mean, sq]) /
                              dist.get_world_size(_SYNC_GROUP))
            mean, sq = both[:C], both[C:]
        return mean, torch.clamp(sq - mean * mean, min=0.0)
    m = mask[..., None].to(x.dtype)
    first = global_sum(torch.cat([m.sum()[None], (x * m).sum(dims)]))
    count = torch.clamp(first[0], min=1.0)
    mean = first[1:] / count
    return mean, global_sum((torch.square(x - mean) * m).sum(dims)) / count


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """This rank's equal slice of the leading axis of every leaf of
    `batch` (tensors or numpy arrays): rows [rank * B / world, (rank + 1) *
    B / world). Raises where a leaf's B does not divide by `world`."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise ValueError(f"shard_batch: {k} has {n} rows, not divisible "
                             f"by {world} ranks")
        per = n // world
        out[k] = v[rank * per:(rank + 1) * per]
    return out


def replicate_state(module, group=None):
    """Broadcast `module`'s parameters and buffers from the first rank of
    `group` (the default group where None) to every rank of it, in place
    (JAX `replicate_state`). Nothing to do without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return module
    src = 0 if group is None or group is dist.group.WORLD else \
        dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src, group=group)
    return module


def sum_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the ranks of `group` (a copy; t itself at one
    rank)."""
    if data_sharding(group)[1] == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def gather_ranks(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' equal slices of t concatenated along `dim` in rank order
    (bool through uint8, which every backend takes); t itself at one
    rank."""
    world = data_sharding(group)[1]
    if world == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.bool() if t.dtype == torch.bool else out


def globalise(tree, group):
    """Every 0-d tensor of `tree` (nested dicts; a count such as
    voxel_overflow) summed over the ranks, every other tensor gathered on
    its leading axis: the global batch's values from each rank's slice
    (JAX: `psum` of the ndim-0 leaves, the others sharded on the batch
    axis)."""
    if isinstance(tree, dict):
        return {k: globalise(v, group) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return sum_ranks(tree, group) if tree.dim() == 0 else \
        gather_ranks(tree, group)


# metrics that count (summed over the ranks); the others are means over
# the batch (averaged over the ranks): both then equal the global batch's
COUNT_METRICS = ("num_pos", "second_num_pos", "voxel_overflow",
                 "stage_overflow")


def all_reduce_metrics(metrics: dict, group) -> dict:
    """The step's 0-d metrics over the ranks of `group`, in one all-reduce
    on the device: counts (COUNT_METRICS) summed, means averaged, each in
    its own dtype."""
    world = data_sharding(group)[1]
    if world == 1:
        return metrics
    keys = list(metrics)
    dev = next(v.device for v in metrics.values()
               if isinstance(v, torch.Tensor))
    vals = [torch.as_tensor(metrics[k], device=dev) for k in keys]
    flat = torch.stack([v.detach().double() for v in vals])
    dist.all_reduce(flat, group=group)
    return {k: (s if k in COUNT_METRICS else s / world).to(v.dtype)
            for k, s, v in zip(keys, flat, vals)}


def wrap_ddp(state, group=None):
    """`state.ddp`: `state.module` in `DistributedDataParallel` over
    `group` (its parameters and buffers broadcast from the group's first
    rank as it is built, `replicate_state`), created once. Gradients are
    averaged over the ranks; the buffers are not broadcast at each forward
    (the norms' statistics are the same on every rank, `sync_norms`). The
    graph is static (every step the same): parameters that take no
    gradient (the temporal-fusion FPN's, JAX's stop_gradient) are found in
    the first step, not by a traversal of every step's graph."""
    if state.ddp is None:
        from torch.nn.parallel import DistributedDataParallel
        dev = state.device
        replicate_state(state.module, group)
        state.ddp = DistributedDataParallel(
            state.module, device_ids=[dev] if dev.type == "cuda" else None,
            process_group=group, static_graph=True, broadcast_buffers=False)
    return state


def make_dp_train_step(train_step, group=None):
    """The data-parallel form of `train_step(state, batch) → (state,
    metrics)` (a `step_of` step): it takes the global batch, runs the step
    on this rank's slice (`shard_batch`) through `state.ddp` (`wrap_ddp`)
    with the norms' statistics over the ranks where there are more than
    one (`sync_norms`), and returns the metrics over the ranks
    (`all_reduce_metrics`). Each rank's loss is
    its slice's sum over its examples / B_local; DDP averages the
    gradients, which makes them those of JAX's sum / B over the global
    batch (JAX `_setup_dp_train`, `second_tpu/train/run.py:304-316`)."""
    rank, world = data_sharding(group)
    # one rank holds the whole batch: its statistics are the batch's
    norms = group if world > 1 else None

    def dp_train_step(state, batch):
        wrap_ddp(state, group)
        with sync_norms(norms):
            state, metrics = train_step(state,
                                        shard_batch(batch, rank, world))
        return state, all_reduce_metrics(metrics, group)

    return dp_train_step


__all__ = ["make_group", "data_sharding", "sync_norms", "global_sum",
           "global_moments", "shard_batch", "replicate_state", "sum_ranks",
           "gather_ranks", "globalise", "all_reduce_metrics", "wrap_ddp",
           "make_dp_train_step"]
