"""Data parallelism: one process per card, a global batch split by rank."""

from medseg_tpu_torch.parallel.sharding import (  # noqa: F401
    DataParallelGroup,
    all_reduce_sum,
    batch_sharding,
    current_group,
    data_parallel,
    data_parallel_mesh,
    pad_to_multiple,
    replicate_,
    replicated,
    require_divisible_batch,
    shard_batch,
)
from medseg_tpu_torch.parallel.dist import (  # noqa: F401
    global_data_parallel_mesh,
    initialize_from_env,
    shard_process_local,
)
