"""Data and tensor parallelism across processes (counterpart of ``act_tpu/parallel``):
the (data, model) grid of ranks (``mesh``), the collectives over its data
groups (``collectives``) and the Megatron shardings over its model groups
(``tp``)."""
from act_tpu_torch.parallel.mesh import (barrier, cpu_group, data_count, data_index,
                                         destroy_distributed, initialize_distributed,
                                         initialize_model_parallel, is_distributed,
                                         is_main_process, local_device, model_count,
                                         model_index, process_count, process_index,
                                         rand_local, randint_local)
from act_tpu_torch.parallel.collectives import (all_gather_cat, all_gather_objects,
                                                all_reduce_mean, all_reduce_sum,
                                                broadcast_module, gather_concat,
                                                gather_in_index_order, reduce_mean_scalar)

__all__ = [
    "barrier", "cpu_group", "data_count", "data_index", "destroy_distributed",
    "initialize_distributed", "initialize_model_parallel", "is_distributed",
    "is_main_process", "local_device", "model_count", "model_index", "process_count",
    "process_index", "rand_local", "randint_local", "all_gather_cat", "all_gather_objects",
    "all_reduce_mean", "all_reduce_sum", "broadcast_module", "gather_concat",
    "gather_in_index_order", "reduce_mean_scalar",
]
