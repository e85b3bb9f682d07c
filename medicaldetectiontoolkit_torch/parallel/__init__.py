"""Data parallelism and spatial partitioning of the port over
``torch.distributed`` (``mesh.py``)."""

from medicaldetectiontoolkit_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    SpaceGroup,
    batch_mean,
    batch_sum,
    check_space_cap,
    grid_layout,
    host_shard_info,
    maybe_initialize_distributed,
    shard_batch,
    shard_rows,
)
