"""The mesh of a tensor-parallel run (port of `triton_distributed_tpu/
parallel/mesh.py` `make_mesh` :153 and `MeshContext` :123).

Here a mesh is ONE process holding ``world`` ranks on one device: the one
card of the emulation, as the JAX package's tests run a world of 4 on
virtual CPU devices.  A rank's activation or weight shard is row ``r`` of
a rank-stacked tensor ``(world, ...)`` on that device, so a collective
kernel reaches every rank's data in one launch, and

- row-sharded activations ``(world, M / world, h)`` are the global rows in
  order: RMSNorm and the residual adds run on them unchanged, and the
  all-gather of rows is a reshape;
- rank r's attention heads are the global heads ``r * h_loc ..``, so the
  stacked q, k and v reshape to the global head order and the attention
  kernels run every rank's heads in one launch, the GQA grouping kept;
- the KV cache's global layout ``(B, Hkv, S, D)`` is the stack of the
  ranks' head shards.

The per-process form, `initialize_distributed` (:205: one process a GPU,
peer pointers from `torch.distributed` symmetric memory), is not ported:
it waits for a machine with more than one card.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.utils.platform import resolve_device

TP_AXIS = "tp"

#: The largest world the collective kernels take (`kernels/csrc/dl.cuh`
#: MAX_RANKS).
MAX_WORLD = 8


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """``world_size`` ranks along the axis ``axis``, all on ``device``."""

    world_size: int
    axis: str
    device: torch.device

    def shard_rows(self, x):
        """(M, ...) -> the rank-stacked (world, M / world, ...) view."""
        if x.shape[0] % self.world_size:
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"world_size={self.world_size}")
        return x.reshape(self.world_size, -1, *x.shape[1:])

    @staticmethod
    def gather_rows(x):
        """The rank-stacked (world, m, ...) -> the global (world * m, ...)
        rows (JAX ``all_gather(..., tiled=True)``)."""
        return x.reshape(-1, *x.shape[2:])


def make_mesh(world: int, axis: str = TP_AXIS, device=None) -> MeshContext:
    """A one-process mesh of ``world`` ranks on ``device`` (CUDA unless
    ``device="cpu"``; raises without CUDA otherwise)."""
    if not 1 <= world <= MAX_WORLD:
        raise ValueError(f"world={world}: a mesh holds 1 to {MAX_WORLD} "
                         "ranks")
    return MeshContext(world, axis, resolve_device(device))
