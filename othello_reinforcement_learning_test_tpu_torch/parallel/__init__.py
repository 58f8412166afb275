from .mesh import (
    all_gather_leading,
    all_reduce_mean_grads,
    barrier,
    broadcast,
    fold_in_process,
    global_mean,
    initialize_distributed,
    local_device,
    local_slice,
    process_count,
    process_index,
)

__all__ = [
    "all_gather_leading",
    "all_reduce_mean_grads",
    "barrier",
    "broadcast",
    "fold_in_process",
    "global_mean",
    "initialize_distributed",
    "local_device",
    "local_slice",
    "process_count",
    "process_index",
]
