"""The tensor-parallel mesh (one process, W ranks on one device)."""

from triton_distributed_tpu_torch.parallel.mesh import (  # noqa: F401
    TP_AXIS, MeshContext, make_mesh)
