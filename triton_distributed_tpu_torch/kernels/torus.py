"""Collectives over a two- or three-axis process grid, every axis at once
(port of `triton_distributed_tpu/kernels/torus.py`: `TorusContext` :87,
`lane_schedules` :166, `all_gather_torus` :313, `reduce_scatter_torus`
:557, `ag_gemm_torus` :675, `gemm_rs_torus` :767, `all_reduce_torus`
:796).

The grid is the one-process mesh of `parallel.mesh` with several axes: rank
g's data is row g of a rank-stacked (W, ...) tensor, g row-major over
``ctx.axes`` (``make_mesh({"x": 2, "y": 4})``).  The schedule is the JAX
package's: a rank's shard splits into L = 2 * nd pieces of ``ms`` rows
(``round_up_rows(cdiv(m, L))``; the JAX wrappers pad the rows to L * ms,
the kernels take the last pieces short or empty and copy nothing), and lane
q of the L runs an nd-phase ring, riding axis (r + p) mod nd at phase p in direction
s (`lane_schedules`: rotation r, sign s), phase 0 moving single pieces and
phase p > 0 the slab the lane has gathered over its first p axes.

- `all_gather_torus`: K21a, one launch of ``csrc/torus.cu`` over every
  rank: x (W, m, ...) -> (W, W*m, ...), every rank's copy of the shards in
  rank order.  Its plain version is the gathered copy (the schedule moves
  bytes, so the result is the same whatever the order).
- `reduce_scatter_torus`: K21b, the schedule reversed: lane q's stage t
  reduces, along the axis of its AG phase nd-1-t, the slab that phase
  gathered, each add an f32 add rounded to x's dtype (JAX `emit_add_into`),
  in the JAX lane, stage and step order (`reduce_scatter_torus_plain`).  On
  the card it is K16's scatter-then-sum body (``csrc/reduce_scatter.cu``,
  `reduce_scatter.scatter_sum`): every piece is put once into its
  destination's receive slot, and the destination evaluates that order
  from a host-built table (`rs_order`), so the kernel equals the plain
  version bit for bit.  x (W, W*m, ...) -> (W, m, ...).
- `ag_gemm_torus`: K21c, K21a's schedule with each piece multiplied by the
  rank's resident B shard as it lands: a (W, m, k), b (W, k, n) -> (W,
  W*m, n) [, the gathered A (W, W*m, k)].  Which body a launch runs
  depends on the operands only (`allgather_gemm.kernel_body`): bf16 on
  16-byte rows the Hopper body (the `wgmma` + TMA tile, the lanes' copies
  on each block's spare producer warps, every piece a rank multiplies a
  run of tiles in one flat list, `ag_gemm_pieces`); f32 and bf16 off
  16-byte rows the first body (K12's `mma.sync` tile, ``gemm_tile.cuh``,
  each lane's blocks computing between their copies).
- `gemm_rs_torus`: every rank's partial product on K6 (`matmul`, one
  launch a rank, as each JAX device calls its Pallas `matmul`), rounded to
  a's dtype, then K21b.
- `all_reduce_torus`: K21b, then K21a under the paired collective id
  (`collective_ids.paired_ag_id`), the rows padded to a multiple of W.

A grid with one axis of size > 1 (``active()`` drops the size-1 axes) runs
the single-axis kernels, as the JAX wrappers do: K15 and K16 for the
collectives, K12 and K14 for the GEMMs (so does world 1).

``method``: ``"torus"`` the schedule above, ``"xla"`` the plain torch
composition (JAX's XLA collectives: a reshape, or an f32 sum in rank
order).  ``"auto"`` is ``"torus"``: JAX's auto rests on
`comm_perf_model.torus_beats_single_axis`, built on the TPU's ICI
constants, and the port has no model of this card's links yet; both
methods compute the same function.  JAX's lane padding to 128 columns is
Mosaic's rule and is not copied; the row split into pieces is kept,
since it decides which lane reduces which rows.

On one card the W ranks share the SMs and one HBM: every put is a copy
inside it, so the schedule's use of several links at once buys nothing
here, and the kernels' times say what their copies and adds cost.

On a CUDA tensor the wrappers launch their kernels or raise; on a CPU
tensor they compute the plain versions.  The observability event, the
comm-sanitizer registration and the training duals are not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.allgather import (
    AllGatherContext, _check, all_gather, all_gather_reference)
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    AllGatherGEMMContext, ag_gemm, ag_gemm_plain, kernel_body, round_up_rows)
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    GEMMReduceScatterContext, gemm_rs, gemm_rs_nonoverlap)
from triton_distributed_tpu_torch.kernels.matmul import matmul
from triton_distributed_tpu_torch.kernels.reduce_scatter import (
    SUM_WORDS, ReduceScatterContext, reduce_scatter, reduce_scatter_reference,
    scatter_sum)
from triton_distributed_tpu_torch.language.core import (
    fault_args, symmetric_buffers)

METHODS = ("auto", "torus", "xla")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_FAULTS = [_I, ctypes.c_longlong, _I]
_SIGNATURES = {
    "torus_all_gather": [_P, _P, _P, _I, _P, _I, _I, _I, _U64, _U64]
    + _FAULTS + [ctypes.POINTER(_I), _P],
    "torus_ag_gemm": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                      _U64] + _FAULTS + [ctypes.POINTER(_I), _P],
    "torus_ag_gemm_wgmma": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                            _I, _P, _P, _P, _I, _P, _U64] + _FAULTS
    + [ctypes.POINTER(_I), _P],
}


@dataclasses.dataclass
class TorusContext:
    """Two or three axes of one process grid driven at once: ``axes`` and
    their ``sizes`` (row-major rank order).  ``method``: "auto" | "torus" |
    "xla".  ``collective_id`` keys the instance's symmetric buffers and
    signals (`collective_ids`); ``straggler`` (None or (flat rank,
    cycles)) and ``for_correctness`` are the fault injection."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    method: str = "auto"
    collective_id: int = cids.ALLGATHER
    straggler: Optional[Tuple[int, int]] = None
    for_correctness: bool = False

    @property
    def world_size(self) -> int:
        return math.prod(self.sizes)

    def active(self) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
        """Axes and sizes with the size-1 axes dropped (a (1, 8) grid is
        one ring, a (2, 2, 1) grid a two-axis one); the rank order is
        unchanged."""
        pairs = [(a, s) for a, s in zip(self.axes, self.sizes) if s > 1]
        return tuple(a for a, _ in pairs), tuple(s for _, s in pairs)

    def resolve_method(self) -> str:
        """The method named; "auto" is "torus" (see the module
        docstring)."""
        if self.method not in METHODS:
            raise ValueError(f"method {self.method!r} not in {METHODS}")
        return "torus" if self.method == "auto" else self.method


def lane_schedules(nd: int):
    """The 2 * nd lane schedules: lane (sign s, rotation r) rides axis
    (r + p) mod nd in direction s at phase p; a tuple of (axis, direction)
    a phase for each lane, the + lanes first (JAX `lane_schedules`)."""
    return tuple(tuple(((r + p) % nd, s) for p in range(nd))
                 for s in (+1, -1) for r in range(nd))


def _pieces(m: int, nd: int, dtype) -> int:
    """Rows of one of a shard's 2 * nd pieces (JAX ``ms``)."""
    return round_up_rows(-(-m // (2 * nd)), dtype)


def ag_word(phase: int, lane: int, c: int, sizes) -> int:
    """The signal word on which a rank receives lane ``lane``'s phase-
    ``phase`` slab at ring position ``c`` (``torus.cu`` `ag_word`)."""
    return 1 + (phase * 2 * len(sizes) + lane) * max(sizes) + c


def ag_gemm_pieces(sizes, m: int, ms: int):
    """K21c's flat tile list on the Hopper body: for every rank g, its
    pieces in the order the JAX kernel multiplies them
    (`_ag_gemm_torus_kernel`'s ``consume_local``, then ``consume_piece``
    at each round of `_emit_torus_ag`: phase p, step s, lane q, the cells
    of the slab that landed, its gathered axes in phase order, the last
    fastest), each a tuple (cell, lane, first row, rows, arrival word,
    run); the own pieces wait on no word (0) and are run 0, a round's
    pieces run 1 + its index among the rounds; pieces with no rows are
    dropped.  The lanes and runs are the same on every rank."""
    sizes = tuple(sizes)
    nd, world = len(sizes), math.prod(sizes)
    scheds = lane_schedules(nd)
    lanes = len(scheds)
    steps = [max(sizes[sch[p][0]] for sch in scheds) - 1 for p in range(nd)]
    rounds = [(p, s) for p in range(nd) for s in range(steps[p])]
    rows = [max(0, min(ms, m - q * ms)) for q in range(lanes)]
    table = []
    for g in range(world):
        pos = [int(c) for c in np.unravel_index(g, sizes)]
        order = [(g, q, 0, 0) for q in range(lanes)]
        for run, (p, s) in enumerate(rounds, 1):
            for q, sched in enumerate(scheds):
                ax, d = sched[p]
                if s >= sizes[ax] - 1:
                    continue
                c = (pos[ax] - (s + 1) * d) % sizes[ax]
                gathered = [sched[j][0] for j in range(p)]
                for combo in itertools.product(
                        *[range(sizes[a]) for a in gathered]):
                    cell = list(pos)
                    cell[ax] = c
                    for a, i in zip(gathered, combo):
                        cell[a] = i
                    order.append((int(np.ravel_multi_index(cell, sizes)), q,
                                  ag_word(p, q, c, sizes), run))
        table.append([(c, q, q * ms, rows[q], w, run)
                      for c, q, w, run in order if rows[q] > 0])
    return table


@functools.lru_cache(maxsize=64)
def _piece_args(sizes, m: int, ms: int):
    """`ag_gemm_pieces` as the kernel's arguments, int32: the count a rank,
    the lanes, each rank's cells and arrival words (W, count), the count
    of runs and each run's first piece."""
    table = ag_gemm_pieces(sizes, m, ms)
    count = len(table[0])
    ints = ctypes.c_int * (len(table) * count)
    lanes = (ctypes.c_int * count)(*[q for _, q, *_ in table[0]])
    cells = ints(*[c for rank in table for c, *_ in rank])
    waits = ints(*[piece[4] for rank in table for piece in rank])
    runs = [piece[5] for piece in table[0]]
    starts = [i for i in range(count) if i == 0 or runs[i] != runs[i - 1]]
    return (count, lanes, cells, waits, len(starts),
            (ctypes.c_int * len(starts))(*starts))


@functools.lru_cache(maxsize=64)
def rs_order(sizes):
    """K21b's sum order, the one `reduce_scatter_torus_plain` evaluates, as
    the scatter-then-sum body takes it: ``(lens, srcs)`` with, for each
    lane q, its chain lengths at its nd nested levels, innermost first
    (level t is stage t's chain, along the axis of the lane's phase
    nd-1-t: that axis's size), and for each destination rank g the W
    source ranks in evaluation order.  The outermost level's position runs
    slowest; at every level the chain runs from position c + d to c along
    its axis (c the destination's coordinate, d the lane's direction), so
    the first operand of a chain is source position c + d and the last c.
    The first operand of a chain is taken as it is and every later add is
    rounded to the dtype."""
    sizes = tuple(sizes)
    nd, world = len(sizes), math.prod(sizes)
    lens, srcs = [], []
    for sched in lane_schedules(nd):
        stages = [sched[nd - 1 - t] for t in range(nd)]   # level t
        lens.append(tuple(sizes[a] for a, _ in stages))
        outer_first = stages[::-1]
        rows = []
        for g in range(world):
            pos = [int(c) for c in np.unravel_index(g, sizes)]
            row = []
            for steps in itertools.product(
                    *[range(1, sizes[a] + 1) for a, _ in outer_first]):
                cell = list(pos)
                for (a, d), j in zip(outer_first, steps):
                    cell[a] = (pos[a] + j * d) % sizes[a]
                row.append(int(np.ravel_multi_index(cell, sizes)))
            rows.append(tuple(row))
        srcs.append(tuple(rows))
    return tuple(lens), tuple(srcs)


def all_gather_torus_plain(x):
    """The plain version of K21a: x (W, m, ...) -> (W, W*m, ...), every
    rank's copy of the shards in rank order."""
    return all_gather_reference(x)


def reduce_scatter_torus_plain(x, sizes):
    """The plain version of K21b on the grid ``sizes`` (its active axes,
    at least two): x (W, W*m, ...) -> (W, m, ...) in the kernel's order
    and rounding.  For lane q's piece of every destination rank, stage t
    = 0 .. nd-1 reduces along the axis A of the lane's phase nd-1-t in
    its direction d: destination position c along A gets x at source
    position c + d, then + c + 2d, .., + c, each add in f32 rounded to x's
    dtype."""
    sizes = tuple(sizes)
    nd, world = len(sizes), math.prod(sizes)
    lanes = 2 * nd
    trailing = x.shape[2:]
    m = x.shape[1] // world
    ms = _pieces(m, nd, x.dtype)
    xr = x.reshape(world, world, m, -1)
    if lanes * ms != m:
        xr = torch.nn.functional.pad(xr, (0, 0, 0, lanes * ms - m))
    xr = xr.reshape(world, world, lanes, ms, -1)
    outs = []
    for q, sched in enumerate(lane_schedules(nd)):
        y = xr[:, :, q].reshape(*sizes, *sizes, ms, -1)
        labels = [("src", a) for a in range(nd)] + [("dst", a)
                                                    for a in range(nd)]
        for t in range(nd):
            a, d = sched[nd - 1 - t]
            w = sizes[a]
            sd, dd = labels.index(("src", a)), labels.index(("dst", a))
            yp = y.movedim((sd, dd), (0, 1))
            c = torch.arange(w, device=x.device)
            acc = yp[(c + d) % w, c]
            for j in range(2, w + 1):
                acc = (acc.float() + yp[(c + j * d) % w, c].float()).to(
                    x.dtype)
            labels = [("dst", a)] + [lb for lb in labels
                                     if lb not in (("src", a), ("dst", a))]
            y = acc
        order = [labels.index(("dst", a)) for a in range(nd)]
        y = y.permute(*order, nd, nd + 1)
        outs.append(y.reshape(world, ms, -1))
    out = torch.stack(outs, dim=1).reshape(world, lanes * ms, -1)[:, :m]
    return out.reshape(world, m, *trailing)


def ag_gemm_torus_plain(a_shard, b):
    """The plain version of K21c: every rank's f32 product of the gathered
    rows with its B shard, cast to a's dtype (each output row is its own
    product, so the arrival order does not enter): a (W, m, k), b (W, k,
    n) -> (W, W*m, n)."""
    return ag_gemm_plain(a_shard, b)


def _check_stack(who, x, world, rows_mult=1):
    if x.dim() < 2 or x.shape[0] != world or x.shape[1] % rows_mult:
        raise ValueError(f"{who} at world {world}: want a rank-stacked "
                         f"(W, {'W*' if rows_mult > 1 else ''}m, ...) "
                         f"operand, got {tuple(x.shape)}")


def all_gather_torus(x, ctx: TorusContext):
    """Gather the rank-stacked row shards x (W, m, ...) over every axis of
    the grid -> (W, W*m, ...) (any dtype).  Each launch of K21a adds one to
    ``all_gather_torus.launches``."""
    world = ctx.world_size
    _check_stack("all_gather_torus", x, world)
    method = ctx.resolve_method()
    axes, sizes = ctx.active()
    if world <= 1:
        return x
    if method == "xla":
        return all_gather_torus_plain(x)
    if len(axes) == 1:
        return all_gather(x, AllGatherContext(
            axis=axes[0], world_size=world, collective_id=ctx.collective_id,
            straggler=ctx.straggler, for_correctness=ctx.for_correctness))
    if x.device.type == "cpu":
        return all_gather_torus_plain(x)
    return _launch_ag(x, ctx, sizes)


all_gather_torus.launches = 0


def reduce_scatter_torus(x, ctx: TorusContext):
    """Sum the rank-stacked partials x (W, W*m, ...) over every axis of the
    grid and give rank g row chunk g -> (W, m, ...) (bf16 or f32).  Each
    launch of K21b adds one to ``reduce_scatter_torus.launches``."""
    world = ctx.world_size
    _check_stack("reduce_scatter_torus", x, world, world)
    method = ctx.resolve_method()
    axes, sizes = ctx.active()
    if world <= 1:
        return x
    if method == "xla":
        return reduce_scatter_reference(x)
    if len(axes) == 1:
        return reduce_scatter(x, ReduceScatterContext(
            axis=axes[0], world_size=world, collective_id=ctx.collective_id,
            straggler=ctx.straggler, for_correctness=ctx.for_correctness))
    if x.device.type == "cpu":
        return reduce_scatter_torus_plain(x, sizes)
    return _launch_rs(x, ctx, sizes)


reduce_scatter_torus.launches = 0


def all_reduce_torus(x, ctx: TorusContext):
    """Sum the rank-stacked partials x (W, m, ...) over every axis ->
    (W, m, ...), every rank's copy of the sum: `reduce_scatter_torus` of
    the rows padded to a multiple of W, then `all_gather_torus` of the
    chunks under the paired id."""
    world = ctx.world_size
    _check_stack("all_reduce_torus", x, world)
    if world <= 1:
        return x
    if ctx.resolve_method() == "xla":
        total = x.float().sum(0).to(x.dtype)
        return total.expand(world, *total.shape).clone()
    m = x.shape[1]
    pad = (-m) % world
    xp = x
    if pad:
        xp = torch.cat([x, x.new_zeros((world, pad, *x.shape[2:]))], dim=1)
    chunk = reduce_scatter_torus(xp.contiguous(), ctx)
    full = all_gather_torus(chunk, dataclasses.replace(
        ctx, collective_id=cids.paired_ag_id(ctx.collective_id)))
    return full[:, :m] if pad else full


def ag_gemm_torus(a_shard, b, ctx: TorusContext,
                  return_gathered: bool = False):
    """out = all_gather_torus(a) @ b with the gather and the product in
    one kernel: a (W, m, k), b (W, k, n), both bf16 or both f32 -> (W, W*m,
    n) [, the gathered A (W, W*m, k)].  Each launch of K21c adds one to
    ``ag_gemm_torus.launches``, one of its Hopper body also to
    ``ag_gemm_torus.wgmma_launches``."""
    world = ctx.world_size
    if (a_shard.dim() != 3 or b.dim() != 3 or a_shard.shape[0] != world
            or b.shape[0] != world or a_shard.shape[2] != b.shape[1]):
        raise ValueError(f"ag_gemm_torus at world {world}: want a_shard (W, "
                         f"m, k) and b (W, k, n), got {tuple(a_shard.shape)}"
                         f" and {tuple(b.shape)}")
    method = ctx.resolve_method()
    axes, sizes = ctx.active()
    if world <= 1 or len(axes) <= 1:
        single = AllGatherGEMMContext(
            axis=axes[0] if axes else ctx.axes[0], world_size=world,
            collective_id=ctx.collective_id)
        if world > 1:
            return ag_gemm(a_shard, b, single, return_gathered)
        res = ag_gemm(a_shard[0], b[0], single, return_gathered)
        return (tuple(t[None] for t in res) if return_gathered
                else res[None])
    if method == "xla" or a_shard.device.type == "cpu":
        out = ag_gemm_torus_plain(a_shard, b)
        if not return_gathered:
            return out
        return out, all_gather_torus_plain(a_shard)
    return _launch_ag_gemm(a_shard, b, ctx, sizes, return_gathered)


ag_gemm_torus.launches = 0
ag_gemm_torus.wgmma_launches = 0


def gemm_rs_torus(a, b, ctx: TorusContext):
    """reduce_scatter_torus(a @ b): a (W, M, k), b (W, k, n), W | M ->
    (W, M/W, n).  The partial products run on K6 (`matmul`, one launch a
    rank), rounded to a's dtype, then K21b; "xla" sums the f32 partials
    unrounded (`gemm_rs_nonoverlap`)."""
    world = ctx.world_size
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != world
            or b.shape[0] != world or a.shape[2] != b.shape[1]
            or a.shape[1] % world):
        raise ValueError(f"gemm_rs_torus at world {world}: want a (W, M, k) "
                         f"with W | M and b (W, k, n), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    axes, sizes = ctx.active()
    if world <= 1 or len(axes) <= 1:
        return gemm_rs(a, b, GEMMReduceScatterContext(
            axis=axes[0] if axes else ctx.axes[0], world_size=world,
            collective_id=ctx.collective_id))
    if ctx.resolve_method() == "xla":
        return gemm_rs_nonoverlap(a, b)
    partial = torch.stack([matmul(a[r], b[r]) for r in range(world)])
    return reduce_scatter_torus(partial, ctx)


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------

def _grid(sizes):
    nd = len(sizes)
    return nd, 2 * nd, max(sizes), (ctypes.c_int * 3)(*sizes, *[1] * (3 - nd))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_ag(x, ctx, sizes):
    world, m = x.shape[:2]
    _check("all_gather_torus", x, world)
    nd, lanes, maxw, dims = _grid(sizes)
    words = 1 + nd * lanes * maxw
    inst = symmetric_buffers("all_gather_torus", ctx.collective_id,
                             f"torus{tuple(sizes)}", None, world, x.device,
                             words=words)
    # The output is every rank's receive buffer (the peers put into it).
    out = torch.empty((world, world * m, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("torus", _SIGNATURES)
    rc = lib.torus_all_gather(
        x.data_ptr(), inst.peers(out), inst.signal_peers(), nd, dims, words,
        m, _pieces(m, nd, x.dtype), x[0, 0].numel() * x.element_size(),
        inst.epoch, *fault_args(ctx.straggler, ctx.for_correctness),
        ctypes.byref(blocks), _stream(x))
    _build.check(lib, rc, "all_gather_torus kernel launch")
    inst.advance(blocks.value)
    all_gather_torus.launches += 1
    return out


def _launch_rs(x, ctx, sizes):
    world = x.shape[0]
    _check("reduce_scatter_torus", x, world, _build.DTYPE_CODES)
    m = x.shape[1] // world
    n = x[0, 0].numel()
    inst = symmetric_buffers("reduce_scatter_torus", ctx.collective_id,
                             f"torus{tuple(sizes)}", x.dtype, world,
                             x.device, words=SUM_WORDS)
    out = torch.empty((world, m, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    scatter_sum(x, out, inst, rs_order(tuple(sizes)),
                _pieces(m, len(sizes), x.dtype) * n, True, ctx.straggler,
                ctx.for_correctness)
    reduce_scatter_torus.launches += 1
    return out


def _launch_ag_gemm(a, b, ctx, sizes, return_gathered):
    world, m, k = a.shape
    n = b.shape[2]
    _check("ag_gemm_torus", a, world, _build.DTYPE_CODES)
    if b.device != a.device or b.dtype != a.dtype:
        raise ValueError(f"ag_gemm_torus: a is {a.dtype} on {a.device}, b "
                         f"{b.dtype} on {b.device}; want both bfloat16 or "
                         "both float32 on one CUDA device")
    if not b.is_contiguous():
        raise ValueError("ag_gemm_torus: b must be contiguous")
    nd, lanes, maxw, dims = _grid(sizes)
    words = 1 + nd * lanes * maxw
    inst = symmetric_buffers("ag_gemm_torus", ctx.collective_id,
                             f"torus{tuple(sizes)}", a.dtype, world,
                             a.device, words=words)
    gathered = torch.empty((world, world * m, k), dtype=a.dtype,
                           device=a.device)
    out = torch.empty((world, world * m, n), dtype=a.dtype, device=a.device)
    ms = _pieces(m, nd, a.dtype)
    wgmma = kernel_body(a, b) == "wgmma"
    blocks = ctypes.c_int(0)
    lib = _build.load_library("torus", _SIGNATURES)
    faults = fault_args(ctx.straggler, ctx.for_correctness)
    if wgmma:
        rc = lib.torus_ag_gemm_wgmma(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), inst.peers(gathered),
            inst.signal_peers(), nd, dims, words, m, ms, n, k,
            *_piece_args(tuple(sizes), m, ms), inst.epoch, *faults,
            ctypes.byref(blocks), _stream(a))
    else:
        rc = lib.torus_ag_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), inst.peers(gathered),
            inst.signal_peers(), nd, dims, words, _build.DTYPE_CODES[a.dtype],
            m, ms, n, k, inst.epoch, *faults, ctypes.byref(blocks),
            _stream(a))
    _build.check(lib, rc, "ag_gemm_torus kernel launch")
    inst.advance(blocks.value)
    ag_gemm_torus.launches += 1
    if wgmma:
        ag_gemm_torus.wgmma_launches += 1
    return (out, gathered) if return_gathered else out
