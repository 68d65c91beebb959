from .sharding import (all_reduce_mean, all_reduce_sum, barrier,
                       gather_rows, global_mean, group_device,
                       is_main_process, local_batch, local_batch_slice,
                       local_rows, maybe_init_distributed, rank, spawn_group,
                       world)

__all__ = ['all_reduce_mean', 'all_reduce_sum', 'barrier', 'gather_rows',
           'global_mean', 'group_device', 'is_main_process', 'local_batch',
           'local_batch_slice', 'local_rows', 'maybe_init_distributed',
           'rank', 'spawn_group', 'world']
