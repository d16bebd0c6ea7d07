from swarm_tpu.ops.bresenham import bresenham_cells, chebyshev_cells  # noqa: F401
from swarm_tpu.ops.raster import (  # noqa: F401
    RayBatch,
    grid_to_world,
    logodds_delta,
    logodds_raster,
    parity_raster,
    tri_state_view,
    world_to_grid,
)
from swarm_tpu.ops.beam_raster import (  # noqa: F401
    BeamSpec,
    beam_raster_reference,
    beams_from_4way,
    beams_from_scan,
    endpoint_rays,
    free_raster_reference,
)
from swarm_tpu.ops.fast_raster import (  # noqa: F401
    apply_counts,
    fan_counts,
    free_raster_fast,
)
from swarm_tpu.ops.frontier import (  # noqa: F401
    frontier_clusters,
    frontier_mask,
    frontier_targets_coarse,
)
