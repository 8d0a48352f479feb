from .dist import (all_gather_object, all_reduce_grads, all_reduce_max,
                   all_reduce_sum, barrier, broadcast_from_rank0,
                   check_mesh_shape, destroy, init_distributed, is_main,
                   rank, rank_rows, world_size)

__all__ = ["all_gather_object", "all_reduce_grads", "all_reduce_max",
           "all_reduce_sum", "barrier", "broadcast_from_rank0",
           "check_mesh_shape", "destroy", "init_distributed", "is_main",
           "rank", "rank_rows", "world_size"]
