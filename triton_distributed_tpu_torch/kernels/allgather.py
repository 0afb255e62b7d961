"""AllGather (port of `triton_distributed_tpu/kernels/allgather.py`
`AllGatherMethod`, `AllGatherContext`, `create_allgather_context` :48-103
and `all_gather` :251).

The operand is rank-stacked (`parallel.mesh`): ``x`` (W, m, n) holds every
rank's row shard, and every rank gets all of them in rank order, so the
result is (W, W*m, n), row r being rank r's copy of the gathered (W*m, n)
(JAX ``all_gather(x, tiled=True)`` on every device).  On the card that is
one launch of ``csrc/all_gather.cu`` (K15) over every rank: ``"ring"``
forwards one chunk a step to the right neighbour (JAX `_ring_ag_kernel`),
``"push_all"`` pushes every shard straight to every rank
(`_push_all_ag_kernel`), ``"bidir_ring"`` runs a ring on each half of the
rows in opposite directions (`_bidir_ring_ag_kernel`; taken for an even row
count at world > 2, else the ring, as the JAX wrapper does), and ``"xla"``
is the plain version.  Every method copies bytes, so every dtype is exact
and the methods agree bit for bit.  The JAX wrapper pads the columns to
128 lanes for Mosaic; the kernel needs no padding.

``"auto"`` is a byte rule, not the JAX package's TPU ICI model
(`comm_perf_model`): ``"push_all"`` while a shard is at most
`AllGatherContext.PUSH_ALL_MAX_BYTES`, else ``"ring"``: the crossover of
``chip_smoke.py``'s sweep at world 4 on an H100 80GB HBM3 at 700 W
(PERF.md), where push_all led up to 512 KiB and the ring from 1 MiB; the
bidirectional ring was never fastest.  The hierarchical and torus
variants, the feedback bus and the observability event are not ported.

On a CUDA tensor `all_gather` launches the kernel or raises; on a CPU tensor
it computes the plain version, `all_gather_reference`.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import enum
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.language.core import (
    fault_args, symmetric_buffers)
from triton_distributed_tpu_torch.parallel.mesh import MAX_WORLD

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_SIGNATURES = {"all_gather": [_P, _P, _P, _I, _I, _I, _I, _U64, _U64, _I,
                              ctypes.c_longlong, _I, ctypes.POINTER(_I), _P]}


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    RING = "ring"
    BIDIR_RING = "bidir_ring"
    PUSH_ALL = "push_all"
    XLA = "xla"


#: The kernel's method codes (csrc/all_gather.cu).
_CODES = {AllGatherMethod.RING: 0, AllGatherMethod.PUSH_ALL: 1,
          AllGatherMethod.BIDIR_RING: 2}


@dataclasses.dataclass
class AllGatherContext:
    """``axis``: the mesh axis gathered over; ``world_size`` its size.
    ``collective_id`` keys the instance's symmetric buffers and signals
    (concurrent instances need distinct ids, `collective_ids`).
    ``straggler``: None or (rank, cycles), that rank spinning ``cycles``
    before it communicates; ``for_correctness`` staggers every rank (the
    JAX fault injection, `dl.maybe_straggle` / `dl.correctness_delay`)."""

    axis: str
    world_size: int
    method: AllGatherMethod = AllGatherMethod.AUTO
    collective_id: int = cids.ALLGATHER
    straggler: Optional[tuple] = None
    for_correctness: bool = False
    #: Which group of ranks this is (a slice of a hierarchical mesh; 0 for
    #: a whole mesh): each group keys its own instance.
    group: int = 0

    #: "auto" takes "push_all" up to this many bytes a shard, else "ring"
    #: (the crossover of chip_smoke.py's sweep on an H100, PERF.md).
    PUSH_ALL_MAX_BYTES = 512 << 10

    def resolve_method(self, nbytes_per_shard: int) -> AllGatherMethod:
        method = AllGatherMethod(self.method)
        if method != AllGatherMethod.AUTO:
            return method
        return (AllGatherMethod.PUSH_ALL
                if nbytes_per_shard <= self.PUSH_ALL_MAX_BYTES
                else AllGatherMethod.RING)


def create_allgather_context(axis: str, world_size: int,
                             method=AllGatherMethod.AUTO,
                             **kw) -> AllGatherContext:
    return AllGatherContext(axis=axis, world_size=world_size,
                            method=AllGatherMethod(method), **kw)


def all_gather_reference(x):
    """The plain version: every rank's copy of the shards in rank order.
    x (W, m, ...) -> (W, W*m, ...)."""
    world = x.shape[0]
    full = x.reshape(1, -1, *x.shape[2:])
    return full.expand(world, *full.shape[1:]).clone()


def all_gather(x, ctx: AllGatherContext):
    """Gather the rank-stacked row shards x (W, m, n) on every rank ->
    (W, W*m, n) (any dtype, any trailing dims).  The kernel takes a
    contiguous CUDA tensor of at most 8 ranks; anything else raises.  Each
    launch of K15 adds one to ``all_gather.launches`` and to
    ``all_gather.method_launches[method]``."""
    world = ctx.world_size
    if x.dim() < 2 or x.shape[0] != world:
        raise ValueError(f"all_gather at world {world}: want x (W, m, ...), "
                         f"got {tuple(x.shape)}")
    m = x.shape[1]
    method = ctx.resolve_method(x[0].numel() * x.element_size())
    if method == AllGatherMethod.BIDIR_RING and (m % 2 or world <= 2):
        method = AllGatherMethod.RING
    if method == AllGatherMethod.XLA or x.device.type == "cpu":
        return all_gather_reference(x)
    return _launch(x, ctx, method)


all_gather.launches = 0
all_gather.method_launches = collections.Counter()


def _launch(x, ctx, method):
    world = x.shape[0]
    _check("all_gather", x, world)
    inst = symmetric_buffers("all_gather", ctx.collective_id, method.value,
                             x.dtype, world, x.device, group=ctx.group)
    # In the one-process emulation the output is every rank's receive
    # buffer: rank r's slice is where the peers put into.
    out = torch.empty((world, world * x.shape[1], *x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("all_gather", _SIGNATURES)
    rc = lib.all_gather(
        x.data_ptr(), inst.peers(out), inst.signal_peers(), world, 0, world,
        _CODES[method], x[0].numel() * x.element_size(), inst.epoch,
        *fault_args(ctx.straggler, ctx.for_correctness), ctypes.byref(blocks),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"all_gather ({method.value}) kernel launch")
    inst.advance(blocks.value)
    all_gather.launches += 1
    all_gather.method_launches[method.value] += 1
    return out


def _check(who, x, world, dtypes=None):
    """The checks every collective wrapper makes of a rank-stacked
    operand before it launches."""
    if x.device.type != "cuda":
        raise ValueError(f"{who}: x on {x.device}; want a CUDA device")
    if dtypes is not None and x.dtype not in dtypes:
        raise ValueError(f"{who}: x is {x.dtype}; want one of "
                         f"{sorted(str(d) for d in dtypes)}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: x must be contiguous")
    if world > MAX_WORLD:
        raise ValueError(f"{who}: world {world} > {MAX_WORLD}")
    if x.numel() == 0:
        raise ValueError(f"{who}: empty operand {tuple(x.shape)}")
