"""The mesh of a parallel run (port of `triton_distributed_tpu/
parallel/mesh.py` `make_mesh` :153, `make_hierarchical_mesh` :178 and
`MeshContext` :123).

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

A mesh has one axis or several.  With several (``make_mesh({"x": 2, "y":
4})``, ``make_hierarchical_mesh(dcn, ici)``) the flat rank g is row-major
over the axes in the order given, as JAX's ``Mesh(devs.reshape(*sizes),
axes)`` orders its devices, so a rank-stacked tensor's row g is the rank
whose coordinate along axis a is ``coord(g, a)``.  The hierarchical
collectives number ranks g = dcn_index * ici_size + ici_index, the case
of two axes (dcn, ici).  The emulation has no slices to discover: the
sizes are arguments.

The per-process form, `initialize_distributed` (:205: one process a GPU,
peer pointers from `torch.distributed` symmetric memory), is not ported:
it waits for a machine with more than one card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from triton_distributed_tpu_torch.utils.platform import resolve_device

TP_AXIS = "tp"

#: The largest world the collective kernels take (`kernels/csrc/dl.cuh`
#: MAX_RANKS).
MAX_WORLD = 8


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """``world_size`` ranks on ``device`` over the axes ``axes`` of sizes
    ``sizes`` (row-major; one axis, ``axis``, unless given).  ``axis`` is
    the first axis: the one a one-axis caller shards over."""

    world_size: int
    axis: str
    device: torch.device
    axes: tuple = ()
    sizes: tuple = ()

    def __post_init__(self):
        if not self.axes:
            object.__setattr__(self, "axes", (self.axis,))
            object.__setattr__(self, "sizes", (self.world_size,))
        if math.prod(self.sizes) != self.world_size or \
                len(self.axes) != len(self.sizes):
            raise ValueError(f"axes {self.axes} of sizes {self.sizes} do "
                             f"not make a world of {self.world_size}")

    def axis_size(self, axis: str) -> int:
        return self.sizes[self.axes.index(axis)]

    def _stride(self, axis: str) -> int:
        return math.prod(self.sizes[self.axes.index(axis) + 1:])

    def coord(self, g: int, axis: str) -> int:
        """Rank g's coordinate along ``axis``."""
        return g // self._stride(axis) % self.axis_size(axis)

    def rank_of(self, coords) -> int:
        """The flat rank at ``coords`` (one per axis, in the mesh's
        order)."""
        g = 0
        for c, w in zip(coords, self.sizes):
            if not 0 <= c < w:
                raise ValueError(f"coordinates {tuple(coords)} outside "
                                 f"sizes {self.sizes}")
            g = g * w + c
        return g

    def groups(self, axis: str):
        """The ranks that share every coordinate but ``axis``'s, one tuple
        a group in the order of the other coordinates, each tuple ordered
        along ``axis``: the ranks a collective over ``axis`` joins."""
        w, stride = self.axis_size(axis), self._stride(axis)
        return [tuple(g + i * stride for i in range(w))
                for g in range(self.world_size)
                if self.coord(g, axis) == 0]

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


def make_mesh(world, axis: str = TP_AXIS, device=None) -> MeshContext:
    """A one-process mesh on ``device`` (CUDA unless ``device="cpu"``;
    raises without CUDA otherwise): ``world`` ranks along ``axis``, or,
    when ``world`` maps axis names to sizes (JAX ``make_mesh(axis_shapes)``,
    e.g. ``{"x": 2, "y": 4}``), their product over those axes."""
    if isinstance(world, dict):
        axes, sizes = tuple(world), tuple(int(v) for v in world.values())
    else:
        axes, sizes = (axis,), (int(world),)
    total = math.prod(sizes)
    if not axes or min(sizes) < 1 or not 1 <= total <= MAX_WORLD:
        raise ValueError(f"mesh {dict(zip(axes, sizes))}: a mesh holds 1 to "
                         f"{MAX_WORLD} ranks")
    return MeshContext(total, axes[0], resolve_device(device), axes, sizes)


def make_hierarchical_mesh(dcn: int, ici: int, device=None, *,
                           dcn_axis: str = "dcn",
                           ici_axis: str = "ici") -> MeshContext:
    """A two-level (slices x ranks a slice) mesh, axes (dcn_axis,
    ici_axis): the mesh the hierarchical collectives
    (`kernels.hierarchical`) expect.  The JAX form groups devices by
    their slice index; here the two sizes are given."""
    return make_mesh({dcn_axis: dcn, ici_axis: ici}, device=device)
