"""Data parallelism of the port over ``torch.distributed`` (``mesh.py``)."""

from medicaldetectiontoolkit_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    batch_mean,
    batch_sum,
    host_shard_info,
    maybe_initialize_distributed,
    shard_batch,
    shard_rows,
)
