"""Data and tensor parallelism over ``torch.distributed`` (the port of
``vln_hamt_tpu/parallel``)."""

from .mesh import (Mesh, all_reduce_grads, gather_state_dict, global_sum, host_allgather,
                   init_distributed, is_default_process, local_device, make_mesh,
                   param_partition_spec, process_feed_rows, reduce_dict_mean, shard_model,
                   shard_state_dict)

__all__ = ["Mesh", "all_reduce_grads", "gather_state_dict", "global_sum", "host_allgather",
           "init_distributed", "is_default_process", "local_device", "make_mesh",
           "param_partition_spec", "process_feed_rows", "reduce_dict_mean", "shard_model",
           "shard_state_dict"]
