"""The multi-device layer of the port (counterpart of src/repro/distributed):
the named-axis mesh over `torch.distributed`, its collectives and `spawn`,
and the pod-aware collectives."""

from repro_torch.distributed.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_POD,
    AbstractMesh,
    Mesh,
    batch_axes,
    local_fits,
    make_mesh,
    mesh_geometry,
    spawn,
)
from repro_torch.distributed.collectives import (  # noqa: F401
    compressed_cross_pod_psum,
    hierarchical_psum,
    int8_dequantize,
    int8_quantize,
    reduce_scatter_then_allgather,
)
