"""ReduceScatter (port of `triton_distributed_tpu/kernels/reduce_scatter.py`
`ReduceScatterMethod`, `ReduceScatterContext` :52, `create_reduce_scatter
_context` and `reduce_scatter` :263).

The operand is rank-stacked (`parallel.mesh`): ``x`` (W, W*m, n) holds
every rank's partial of the full array, and rank c gets row chunk c of
their sum, so the result is (W, m, n).  On the card that is one launch of
``csrc/reduce_scatter.cu`` (K16) over every rank: ``"scatter_reduce"``
puts each foreign chunk straight into its destination's receive slot,
and each destination block sums its own range as soon as the blocks that
wrote it have signalled (`_scatter_reduce_kernel`; the body K21b
`reduce_scatter_torus` shares with its own order, `scatter_sum`);
``"ring"`` passes running sums around the ring with the JAX kernel's
two-slot ack flow control (`_ring_rs_kernel`).  ``"xla"`` (JAX
``psum_scatter``) is the plain f32 sum in rank order.

Numerics, in the kernel and its plain version alike: ``"scatter_reduce"``
and ``"xla"`` sum the partials in f32 in rank order 0 .. W-1 and round once
(JAX `_emit_reduce_sum`; the trivial table of `scatter_reduce_order`);
``"ring"`` adds one hop at a time in f32 and rounds to x's dtype at every
hop (its staging and accumulator buffers hold x's dtype, as the JAX
kernel's do), chunk c's sum running x_{c+1}, + x_{c+2}, .., + x_c.  So in
bf16 the two methods differ by design; in f32 they agree to the order of
the sums.

``"auto"`` is ``"scatter_reduce"`` at every size, not the JAX package's
TPU ICI model: in ``chip_smoke.py``'s sweep at world 4 on an H100 80GB
HBM3 at 700 W it led the ring at all 11 sizes, 8 KiB to 32 MiB a rank,
on one card, where no put crosses NVLink (PERF.md).  The ring stays a
method to name.

On a CUDA tensor `reduce_scatter` launches the kernel or raises; on a CPU
tensor it computes the plain version, `reduce_scatter_reference`.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import enum
import functools
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.allgather import _check
from triton_distributed_tpu_torch.language.core import (
    SIGNAL_WORDS, fault_args, symmetric_buffers)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_FAULTS = [_I, ctypes.c_longlong, _I, ctypes.POINTER(_I), _P]
_SIGNATURES = {
    "reduce_scatter_sum": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U64, _U64,
                           _I, _P, _P, _I, _U64] + _FAULTS,
    "reduce_scatter_ring": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _U64, _U64]
    + _FAULTS,
}

#: Signal words a rank of the scatter-then-sum body (``csrc/reduce_scatter.cu``
#: SUM_WORDS): the entry barrier, the local word, then 256 arrival words
#: (one a block, at most 256 blocks a rank) for each of up to 8 source ranks.
SUM_WORDS = 2 + 8 * 256
#: Nested levels of a sum order (``csrc/reduce_scatter.cu`` MAX_LEVELS).
ORDER_LEVELS = 3


class ReduceScatterMethod(enum.Enum):
    AUTO = "auto"
    SCATTER_REDUCE = "scatter_reduce"
    RING = "ring"
    XLA = "xla"


@dataclasses.dataclass
class ReduceScatterContext:
    """As `AllGatherContext`: the axis and its size, the method, the
    collective id keying the instance, and the fault injection
    (``straggler``, ``for_correctness``)."""

    axis: str
    world_size: int
    method: ReduceScatterMethod = ReduceScatterMethod.AUTO
    collective_id: int = cids.REDUCE_SCATTER
    straggler: Optional[tuple] = None
    for_correctness: bool = False
    #: The group of ranks (a slice's index; 0 for a whole mesh).
    group: int = 0

    def resolve_method(self) -> ReduceScatterMethod:
        """The method named, ``"auto"`` taken as ``"scatter_reduce"``."""
        method = ReduceScatterMethod(self.method)
        if method != ReduceScatterMethod.AUTO:
            return method
        return ReduceScatterMethod.SCATTER_REDUCE


def create_reduce_scatter_context(axis: str, world_size: int, **kw):
    if "method" in kw:
        kw["method"] = ReduceScatterMethod(kw["method"])
    return ReduceScatterContext(axis=axis, world_size=world_size, **kw)


def sum_in_rank_order(parts):
    """sum over w of parts[w], each widened to f32 and added in rank order
    0 .. W-1, cast to parts' dtype once (JAX `_emit_reduce_sum`)."""
    acc = parts[0].float()
    for w in range(1, parts.shape[0]):
        acc = acc + parts[w].float()
    return acc.to(parts.dtype)


def scatter_reduce_order(world: int):
    """K16 ``scatter_reduce``'s sum order as the scatter-then-sum body takes
    it (`kernels/torus.py` `rs_order` has K21b's): one lane, whose chain
    lengths are (W,) (one level) and whose sources at every destination
    are the ranks in order 0 .. W-1; the body rounds once, at the end."""
    return ((world,),), (tuple(tuple(range(world)) for _ in range(world)),)


@functools.lru_cache(maxsize=64)
def order_args(lens, srcs):
    """A sum order (``lens`` (L, levels), ``srcs`` (L, W, W)) as the
    kernel's int32 arguments: the lane count, the chain lengths (L, 3)
    padded with chains of one, and the sources (L, W, W)."""
    flat_lens = [n for lane in lens
                 for n in (*lane, *[1] * (ORDER_LEVELS - len(lane)))]
    flat_srcs = [s for lane in srcs for row in lane for s in row]
    return (len(lens), (ctypes.c_int * len(flat_lens))(*flat_lens),
            (ctypes.c_int * len(flat_srcs))(*flat_srcs))


def reduce_scatter_reference(x, method="scatter_reduce"):
    """The plain version of ``method``: x (W, W*m, ...) -> (W, m, ...),
    rank c getting chunk c of the ranks' sum in the method's order and
    rounding (see the module docstring)."""
    method = ReduceScatterMethod(method)
    world = x.shape[0]
    chunks = x.reshape(world, world, -1, *x.shape[2:])   # [rank, chunk]
    if method != ReduceScatterMethod.RING:
        return torch.stack([sum_in_rank_order(chunks[:, c])
                            for c in range(world)])
    outs = []
    for c in range(world):
        acc = chunks[(c + 1) % world, c]
        for j in range(2, world + 1):
            acc = (acc.float() + chunks[(c + j) % world, c].float()).to(
                x.dtype)
        outs.append(acc)
    return torch.stack(outs)


def reduce_scatter(x, ctx: ReduceScatterContext):
    """Sum the rank-stacked partials x (W, W*m, n) and give rank c row
    chunk c -> (W, m, n).  The kernel takes contiguous bf16 or f32 on a
    CUDA device, at most 8 ranks (the ring at least 2); anything else
    raises.  Each launch of K16 adds one to ``reduce_scatter.launches`` and
    to ``reduce_scatter.method_launches[method]``."""
    world = ctx.world_size
    if x.dim() < 2 or x.shape[0] != world or x.shape[1] % world:
        raise ValueError(f"reduce_scatter at world {world}: want x (W, W*m, "
                         f"...), got {tuple(x.shape)}")
    method = ctx.resolve_method()
    if method == ReduceScatterMethod.RING and world == 1:
        method = ReduceScatterMethod.SCATTER_REDUCE
    if method == ReduceScatterMethod.XLA or x.device.type == "cpu":
        return reduce_scatter_reference(x, method)
    return _launch(x, ctx, method)


reduce_scatter.launches = 0
reduce_scatter.method_launches = collections.Counter()


def scatter_sum(x, out, inst, order, piece: int, round_each: bool,
                straggler=None, for_correctness=False) -> None:
    """One launch of the scatter-then-sum body (K16 ``scatter_reduce``, K21b)
    over every rank: x (W, W*m, ...) contiguous bf16 or f32 on a CUDA
    device into out (W, m, ...), through the instance ``inst``'s receive
    buffer "rbuf" (W, m * ...) a rank and its SUM_WORDS signal words, each
    lane of ``piece`` elements of a chunk summed in ``order`` (`order_args`'s
    pair ``(lens, srcs)``), every add rounded to x's dtype if
    ``round_each`` (else once)."""
    world = x.shape[0]
    elems = x[0].numel() // world
    rbuf = inst.buffer("rbuf", (world, elems), x.dtype)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("reduce_scatter", _SIGNATURES)
    rc = lib.reduce_scatter_sum(
        x.data_ptr(), out.data_ptr(), inst.peers(rbuf), inst.signal_peers(),
        inst.words, world, 0, world, _build.DTYPE_CODES[x.dtype], elems,
        piece, *order_args(*order), int(round_each), inst.epoch,
        *fault_args(straggler, for_correctness), ctypes.byref(blocks),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "reduce_scatter scatter-then-sum kernel launch")
    inst.advance(blocks.value)


def _launch(x, ctx, method):
    world = x.shape[0]
    _check("reduce_scatter", x, world, _build.DTYPE_CODES)
    elems = x[0].numel() // world
    out = torch.empty((world, x.shape[1] // world, *x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    ring = method == ReduceScatterMethod.RING
    inst = symmetric_buffers("reduce_scatter", ctx.collective_id,
                             method.value, x.dtype, world, x.device,
                             group=ctx.group,
                             words=SIGNAL_WORDS if ring else SUM_WORDS)
    if ring:
        staging = inst.buffer("staging", (2, elems), x.dtype)
        accum = inst.buffer("accum", (2, elems), x.dtype)
        blocks = ctypes.c_int(0)
        lib = _build.load_library("reduce_scatter", _SIGNATURES)
        rc = lib.reduce_scatter_ring(
            x.data_ptr(), out.data_ptr(), inst.peers(staging),
            accum.data_ptr(), inst.signal_peers(), world, 0, world,
            _build.DTYPE_CODES[x.dtype], elems, inst.epoch,
            *fault_args(ctx.straggler, ctx.for_correctness),
            ctypes.byref(blocks),
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, "reduce_scatter (ring) kernel launch")
        inst.advance(blocks.value)
    else:
        scatter_sum(x, out, inst, scatter_reduce_order(world), elems, False,
                    ctx.straggler, ctx.for_correctness)
    reduce_scatter.launches += 1
    reduce_scatter.method_launches[method.value] += 1
    return out
