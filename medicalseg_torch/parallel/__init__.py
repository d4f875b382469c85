# Copyright 2026. Apache License 2.0.
from .collectives import all_reduce_sum, gather_h, halo_h, sum_grads
from .mesh import (Mesh, active_mesh, build_mesh, h_levels, init_from_env,
                   init_process_group, process_shard, shard_batch, use_mesh)

__all__ = ["Mesh", "build_mesh", "process_shard", "shard_batch",
           "init_from_env", "init_process_group", "active_mesh", "use_mesh",
           "halo_h", "all_reduce_sum", "sum_grads", "gather_h", "h_levels"]
