"""The one-process mesh (W ranks on one device, over one axis or
several)."""

from triton_distributed_tpu_torch.parallel.mesh import (  # noqa: F401
    TP_AXIS, MeshContext, make_hierarchical_mesh, make_mesh)
