"""Multi-device execution — the port of `second_tpu/parallel/`.

`mesh` (process groups, batch sharding, the norms' global statistics),
`eval_dp` (data-parallel evaluation with its statistics reduced over the
group), `spatial` (a dense BEV module's eval forward with its rows sharded
over the ranks, halos exchanged with the neighbours), `temporal_sp` (the
sequence model's frames sharded over the ranks, a ring exchange of the
boundary BEV maps) and `launch` (a world of CPU processes on a gloo group,
for the tests and `entry.dryrun_multichip`). Only `mesh` is imported here:
the models import it, and the other modules import the models.
"""

from .mesh import (all_reduce_metrics, data_sharding, global_moments,
                   global_sum, make_dp_train_step, make_group,
                   replicate_state, shard_batch, sync_norms, wrap_ddp)

__all__ = ["make_group", "data_sharding", "sync_norms", "global_sum",
           "global_moments", "shard_batch", "replicate_state",
           "all_reduce_metrics", "wrap_ddp", "make_dp_train_step"]
