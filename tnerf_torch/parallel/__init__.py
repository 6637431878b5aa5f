"""Data-, sample- and table-parallel training and rendering on
`torch.distributed` (counterpart of `tnerf/parallel/`)."""

from tnerf_torch.parallel.mesh import (  # noqa: F401
    make_dp_train_step,
    make_mesh,
    replicate,
    shard_batch,
)
