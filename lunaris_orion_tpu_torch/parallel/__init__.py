"""The parallel layer of the port (counterpart: lunaris_orion_tpu/parallel):
a (data, model) mesh over `torch.distributed` ranks, the collectives with
their gradients, context-parallel attention (ring and allgather), and
the placement of tensor and expert parallelism over the model axis
(`sharding.py`)."""

from lunaris_orion_tpu_torch.parallel.mesh import (  # noqa: F401
    AxisGroup, Mesh, Parallel, close_mesh, init_mesh, make_mesh)
