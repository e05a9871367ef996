"""Data parallelism across processes (counterpart of ``act_tpu/parallel``)."""
from act_tpu_torch.parallel.mesh import (barrier, cpu_group, destroy_distributed,
                                         initialize_distributed, is_distributed,
                                         is_main_process, local_device, process_count,
                                         process_index, rand_local, randint_local)
from act_tpu_torch.parallel.collectives import (all_gather_objects, all_reduce_mean,
                                                all_reduce_sum, broadcast_module,
                                                gather_concat, reduce_mean_scalar)

__all__ = [
    "barrier", "cpu_group", "destroy_distributed", "initialize_distributed",
    "is_distributed", "is_main_process", "local_device", "process_count", "process_index",
    "rand_local", "randint_local", "all_gather_objects", "all_reduce_mean", "all_reduce_sum",
    "broadcast_module", "gather_concat", "reduce_mean_scalar",
]
