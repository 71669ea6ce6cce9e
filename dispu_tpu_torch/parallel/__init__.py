"""Data-parallel runs over ``torch.distributed`` (counterpart of
``parallel/``): the device mesh and its collectives (:mod:`.mesh`), sharded
whole-cloud evaluation (:mod:`.sharded_eval`) and the CPU dry run of every
mesh path (:mod:`.dryrun`)."""

from dispu_tpu_torch.parallel.mesh import (all_gather_rows, all_reduce_max_,
                                           all_reduce_mean_, all_reduce_sum,
                                           all_reduce_sum_, broadcast_,
                                           data_rank, data_size, is_writer,
                                           launcher_world_size, local_rows,
                                           make_mesh, shard_batch)

__all__ = ["make_mesh", "shard_batch", "local_rows", "data_size",
           "data_rank", "is_writer", "launcher_world_size", "all_reduce_sum",
           "all_reduce_sum_", "all_reduce_mean_", "all_reduce_max_",
           "all_gather_rows", "broadcast_"]
