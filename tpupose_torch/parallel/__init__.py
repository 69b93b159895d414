"""The (data, spatial) process mesh over ``torch.distributed`` (port of
``tpupose/parallel``) and the spatial axis's halo exchange."""

from tpupose_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    all_gather_list,
    data_part,
    initialize_distributed,
    make_mesh,
    replicate,
    shard_batch,
    slab_rows,
)
from tpupose_torch.parallel.spatial import (
    SpatialSlabs,
    spatial_forward,
    spatial_halos,
)
