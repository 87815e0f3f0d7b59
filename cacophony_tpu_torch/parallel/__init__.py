"""Data and tensor parallelism over a process-group mesh (cacophony_tpu/parallel)."""
from cacophony_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_spec,
    make_mesh,
    param_specs,
    shard_batch,
    shard_params,
)
