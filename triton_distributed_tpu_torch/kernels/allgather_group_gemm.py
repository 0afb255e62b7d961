"""AllGather + grouped GEMM, the MoE tensor-parallel prologue (port of
`triton_distributed_tpu/kernels/allgather_group_gemm.py`
`AGGroupGEMMContext`, `ag_group_gemm` and `ag_group_gemm_w8a8`).

Each rank buckets its own tokens per expert (capacity-padded,
`moe_utils.route_capacity`), so the payload of the all-gather is a rank's
bucket tensor (E, cap, k).  The operands are rank-stacked
(`parallel.mesh`): the buckets (W, E, cap, k), rank r's column shard of
every expert's weights (W, E, k, n_loc) and, optionally, the true bucket
sizes ``counts`` (W, E) (replicated).  Every rank gets every rank's buckets
times its own shard: out (W, W, E, cap, n_loc), ``out[r, c]`` rank c's
tokens through rank r's columns.

On the card each call is one cooperative launch over every rank of
``csrc/ag_group_gemm.cu``: K11 (``ag_group_gemm``, bf16 or f32) and K11-int8
(``ag_group_gemm_w8a8``), on the row tiles that hold tokens only: with
``counts``, a row tile (`grouped_gemm.row_tile`) that starts at or past an
expert's count computes nothing and writes zeros, as the JAX ``count_of``
does.  bf16 on 16-byte rows (`kernel_body`; every main-path call) and every
int8 call run the Hopper body: the crew of each block forwards the ring in
pieces of `RING_PIECE_EXPERTS` experts, and the blocks walk a list of
units, each one expert's column tile of 128 times up to four 64-row boxes
of its live buckets (`unit_list`, built from the counts on the device), so
a rank loads each tile of its weights once for every chunk's rows.  f32
and bf16 off 16-byte rows run the first body: the ring of K12 carrying one
bucket tensor a step and the grouped GEMM of each chunk as it arrives.
The int8 path quantizes the buckets per token (`quantized.quantize_sym`),
carries int8 through the ring, and gathers the per-token scales outside
the kernel (here: the rank-stacked tensor is the gathered one), as JAX
gathers them in XLA; it reads the weights K-major, (W, E, n, k), as the
`wgmma` instruction takes 8-bit operands: in place when the (W, E, k, n)
argument is the transpose of such a tensor (how `MoEMLP` stores them),
else through one copy a call (``ag_group_gemm_w8a8.transposes``).  On a CPU
tensor
the wrappers compute the plain versions, `ag_group_gemm_plain` and
`ag_group_gemm_w8a8_plain`.  The kernels run at world 2 to 8; the MoE
layer never calls them at world 1 (it takes its ``xla`` path there, as the
JAX layer does).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.grouped_gemm import (
    WGMMA_BOX_ROWS, grouped_matmul_reference,
    grouped_matmul_w8a8_reference,
    row_tile, zero_past_counts)
from triton_distributed_tpu_torch.kernels.quantized import quantize_sym
from triton_distributed_tpu_torch.language.core import symmetric_buffers
from triton_distributed_tpu_torch.parallel.mesh import MAX_WORLD

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"ag_group_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, ctypes.c_uint64, ctypes.POINTER(_I), _P],
               "ag_group_gemm_wgmma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _I, _I, ctypes.c_uint64,
                                       ctypes.POINTER(_I), _P],
               "ag_group_gemm_w8a8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I,
                                      ctypes.c_uint64, ctypes.POINTER(_I),
                                      _P]}

#: The most experts the kernels take (their per-chunk tile table lives in
#: shared memory).
MAX_EXPERTS = 512
#: The Hopper body's unit: up to UNIT_BOXES boxes of UNIT_ROWS rows (a
#: chunk's bucket rows of one expert each) times UNIT_N columns of that
#: expert's weights (``csrc/ag_group_gemm.cu`` `UnitTile`).
UNIT_BOXES, UNIT_ROWS, UNIT_N = 4, WGMMA_BOX_ROWS, 128
#: Experts a piece of the Hopper body's ring: each chunk is forwarded in
#: pieces of this many experts' buckets, one arrival word a (chunk, piece).
RING_PIECE_EXPERTS = 4


@dataclasses.dataclass(frozen=True)
class AGGroupGEMMContext:
    """``collective_id`` keys the instance's symmetric buffers and
    signals; concurrent instances need distinct ids (`collective_ids`)."""

    axis: str
    world_size: int
    num_experts: int
    collective_id: int = cids.AG_GROUP_GEMM


def kernel_body(buckets, expert_weights) -> str:
    """The K11 body a launch on these operands runs: "wgmma" for bf16 on
    16-byte rows (k and n multiples of 8, both operands 16-byte aligned),
    "mma" for other bf16 (the `mma.sync` tile, loads by element), "f32"
    (CUDA cores).  By operand only; nothing falls back on a failure."""
    if buckets.dtype != torch.bfloat16:
        return "f32"
    k, n = buckets.shape[-1], expert_weights.shape[-1]
    aligned = (buckets.data_ptr() % 16 == 0
               and expert_weights.data_ptr() % 16 == 0)
    return "wgmma" if k % 8 == 0 and n % 8 == 0 and aligned else "mma"


def ag_group_gemm_plain(buckets, expert_weights, counts=None):
    """The plain version of `ag_group_gemm`: out[r, c] is chunk c's
    buckets through rank r's weights, an f32 grouped product cast to the
    buckets' dtype (`grouped_gemm.grouped_matmul_reference`), zero in the
    row tiles past ``counts[c]`` (`grouped_gemm.row_tile` of the body these
    operands run on)."""
    world, _, cap, _ = buckets.shape
    out = torch.stack([torch.stack([
        grouped_matmul_reference(buckets[c], expert_weights[r])
        for c in range(world)]) for r in range(world)])
    if counts is None:
        return out
    return zero_past_counts(out, counts, row_tile(
        cap, buckets.dtype, kernel_body(buckets, expert_weights)))


def unit_list(counts, world: int, num_experts: int, cap: int, n: int):
    """The Hopper body's units from the routing's counts (W, E), by torch
    ops on their device (no host sync): (units (T, 4) int32, ntiles (1,)
    int32).  Expert e's live boxes are the (row box i, chunk c) with
    counts[c, e] > 64 i, in the order (i, c); they fill ceil(live / 4)
    units of up to four boxes, for each column tile of 128 in turn: the
    list is expert-major, then column tile, so the units that share a
    weight tile are one run.  Unit t (t < ntiles) is {e, column tile,
    box 0 | box 1 << 16, box 2 | box 3 << 16}, a box i << 3 | c and 0xFFFF
    an empty slot; T, the most units any counts give, sizes the launch (the
    rows past ntiles are not units).  About 25 small kernels a call: K11
    and K10 build a list at every MoE layer."""
    e, nt = num_experts, -(-n // UNIT_N)
    row0, code, t = _unit_consts(world, e, cap, n, counts.device)
    slots = code.numel() // UNIT_BOXES           # box slots of an expert
    # live[e, p]: box p = (i, c) of expert e holds a token; rank: its
    # 1-based place among e's live boxes, 0 for a dead one.
    live = (counts.t()[:, None, :] > row0[None, :, None]).reshape(e, -1)
    rank = torch.cumsum(live, 1)
    boxes = torch.full((e, 1 + slots * UNIT_BOXES), 0xFFFF,
                       dtype=torch.int64, device=counts.device)
    boxes.scatter_(1, rank * live, code[:live.shape[1]].expand_as(live))
    # Each unit slot's two 32-bit words (signed: the high box's top bit
    # is the word's sign), (E, slots, 2).
    pair = boxes[:, 1:].view(e, slots, 2, 2)
    words = pair[..., 0] + ((pair[..., 1] ^ 0x8000) - 0x8000) * 65536
    units_e = (rank[:, -1] + UNIT_BOXES - 1) // UNIT_BOXES
    tiles_e = units_e * nt
    last = torch.cumsum(tiles_e, 0)
    ex = torch.searchsorted(last, t, right=True).clamp_(max=e - 1)
    rem = t - (last - tiles_e)[ex]
    per_col = units_e[ex].clamp_(min=1)
    col = rem // per_col
    unit = words[ex, rem - col * per_col]
    units = torch.stack([ex, col, unit[:, 0], unit[:, 1]], 1).to(torch.int32)
    return units, last[-1:].to(torch.int32)


@functools.lru_cache(maxsize=64)
def _unit_consts(world: int, num_experts: int, cap: int, n: int, device):
    """`unit_list`'s constants: each row box's first row (rt,), the box
    codes i << 3 | c in the order (i, c), padded with empty slots to whole
    units, and the list's indices (T,)."""
    rt, nt = -(-cap // UNIT_ROWS), -(-n // UNIT_N)
    slots = -(-rt * world // UNIT_BOXES)
    code = torch.full((slots * UNIT_BOXES,), 0xFFFF, dtype=torch.int64)
    code[:rt * world] = (torch.arange(rt)[:, None] * 8
                         + torch.arange(world)).reshape(-1)
    return (torch.arange(rt, device=device) * UNIT_ROWS, code.to(device),
            torch.arange(num_experts * nt * slots, device=device))


def ag_group_gemm_w8a8_plain(buckets_q, scales, expert_weights_q, w_scales,
                             out_dtype, counts=None):
    """The plain version of the int8 kernel on quantized buckets (W, E,
    cap, k) int8 with their scales (W, E, cap): exact products, then
    (float(acc) * scale) * w_scale (`grouped_matmul_w8a8_reference`), zero
    in the 64-row boxes past ``counts`` (the Hopper body's row tile,
    `grouped_gemm.row_tile(.., "wgmma")`)."""
    world, _, cap, _ = buckets_q.shape
    out = torch.stack([torch.stack([
        grouped_matmul_w8a8_reference(
            buckets_q[c], expert_weights_q[r], scales[c], w_scales[r],
            out_dtype) for c in range(world)]) for r in range(world)])
    if counts is None:
        return out
    return zero_past_counts(out, counts, row_tile(cap, torch.int8, "wgmma"))


def ag_group_gemm(buckets, expert_weights, ctx: AGGroupGEMMContext,
                  counts=None):
    """all_gather(buckets) times every rank's expert weights, f32
    accumulation, in the buckets' dtype.

    buckets (W, E, cap, k), expert_weights (W, E, k, n), both bf16 or both
    f32, contiguous; counts (W, E) int, optional.  Returns (W, W, E, cap,
    n).  Each launch of K11 adds one to ``ag_group_gemm.launches``, one of
    the Hopper body (`kernel_body`) also to
    ``ag_group_gemm.wgmma_launches``."""
    _check_shapes(buckets, expert_weights, counts, ctx)
    if buckets.device.type == "cpu":
        return ag_group_gemm_plain(buckets, expert_weights, counts)
    if buckets.dtype not in _build.DTYPE_CODES or (
            expert_weights.dtype != buckets.dtype):
        raise ValueError(f"ag_group_gemm: buckets {buckets.dtype}, weights "
                         f"{expert_weights.dtype}; want both bfloat16 or "
                         "both float32")
    if kernel_body(buckets, expert_weights) == "wgmma":
        out = _launch_wgmma(buckets, expert_weights, counts, ctx,
                            buckets.dtype)
        ag_group_gemm.wgmma_launches += 1
    else:
        out = _launch(buckets, expert_weights, counts, ctx)
    ag_group_gemm.launches += 1
    return out


ag_group_gemm.launches = 0
ag_group_gemm.wgmma_launches = 0


def ag_group_gemm_w8a8(buckets, expert_weights_q, w_scales,
                       ctx: AGGroupGEMMContext, counts=None,
                       out_dtype=None):
    """The int8 form: the float buckets (W, E, cap, k) quantized per token
    on the fly, int8 expert weights (W, E, k, n) with per-expert,
    per-output-channel scales w_scales (W, E, n) f32 (`MoEMLP.
    quantize_params`, column-sharded), int32 accumulation, out (W, W, E,
    cap, n) in ``out_dtype`` (default the buckets' dtype).  cap must be a
    multiple of 32 (`MoEMLP.capacity` aligns w8a8 buckets so), k a
    multiple of 16.  The kernel reads the weights K-major: in place when
    ``expert_weights_q.transpose(-1, -2)`` is contiguous, else through one
    copy, which adds one to ``ag_group_gemm_w8a8.transposes``.  Each launch
    of K11-int8 (on the Hopper body, every launch) adds one to
    ``ag_group_gemm_w8a8.launches`` and ``.wgmma_launches``."""
    _check_shapes(buckets, expert_weights_q, counts, ctx)
    world, e, cap, k = buckets.shape
    n = expert_weights_q.shape[3]
    out_dtype = out_dtype or buckets.dtype
    if cap % 32:
        raise ValueError(f"ag_group_gemm_w8a8: int8 buckets need a capacity "
                         f"that is a multiple of 32, got {cap}")
    if expert_weights_q.dtype != torch.int8 or tuple(w_scales.shape) != (
            world, e, n):
        raise ValueError(f"ag_group_gemm_w8a8: weights "
                         f"{expert_weights_q.dtype}, scales "
                         f"{tuple(w_scales.shape)}; want int8 and ({world}, "
                         f"{e}, {n})")
    buckets_q, scales = quantize_sym(buckets, -1)
    w_scales = w_scales.float().contiguous()
    if buckets.device.type == "cpu":
        return ag_group_gemm_w8a8_plain(buckets_q, scales, expert_weights_q,
                                        w_scales, out_dtype, counts)
    if k % 16 or out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"ag_group_gemm_w8a8: k={k} must be a multiple of "
                         f"16 and out {out_dtype} bfloat16 or float32")
    bt = expert_weights_q.transpose(-1, -2)
    if not bt.is_contiguous():
        ag_group_gemm_w8a8.transposes += 1
        bt = bt.contiguous()
    out = _launch_wgmma(buckets_q, bt, counts, ctx, out_dtype, scales,
                        w_scales)
    ag_group_gemm_w8a8.launches += 1
    ag_group_gemm_w8a8.wgmma_launches += 1
    return out


ag_group_gemm_w8a8.launches = 0
ag_group_gemm_w8a8.wgmma_launches = 0
ag_group_gemm_w8a8.transposes = 0


def _check_shapes(buckets, w, counts, ctx):
    world, e = ctx.world_size, ctx.num_experts
    if (buckets.dim() != 4 or w.dim() != 4 or buckets.shape[:2] != (world, e)
            or w.shape[:2] != (world, e) or buckets.shape[3] != w.shape[2]):
        raise ValueError(f"ag_group_gemm at world {world}, {e} experts: want "
                         f"buckets (W, E, cap, k) and weights (W, E, k, n), "
                         f"got {tuple(buckets.shape)} and {tuple(w.shape)}")
    if counts is not None and tuple(counts.shape) != (world, e):
        raise ValueError(f"ag_group_gemm: counts {tuple(counts.shape)}, want "
                         f"({world}, {e})")


def _check_launch(a, b, scales, w_scales, counts):
    world, e = a.shape[:2]
    if not 2 <= world <= MAX_WORLD or e > MAX_EXPERTS:
        raise ValueError(f"ag_group_gemm: world {world} (2 to {MAX_WORLD}) "
                         f"and {e} experts (at most {MAX_EXPERTS})")
    for nm, t in (("buckets", a), ("weights", b), ("scales", scales),
                  ("w_scales", w_scales), ("counts", counts)):
        if t is not None and (t.device != a.device or not t.is_contiguous()):
            raise ValueError(f"ag_group_gemm: {nm} not contiguous on "
                             f"{a.device}")


def _launch_wgmma(a, b, counts, ctx, out_dtype, scales=None,
                  w_scales=None):
    """One launch of the Hopper body of csrc/ag_group_gemm.cu over every
    rank: bf16 a (W, E, cap, k) and b (W, E, k, n), or, with the scales,
    int8 a and b given K-major as (W, E, n, k)."""
    world, e, cap, k = a.shape
    int8 = scales is not None
    n = b.shape[2] if int8 else b.shape[3]
    dev = a.device
    _check_launch(a, b, scales, w_scales, counts)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("ag_group_gemm: buckets and weights must be 16-byte "
                         "aligned")
    live = None if counts is None else counts.clamp(0, cap).to(
        torch.int32).contiguous()
    units, ntiles = unit_list(
        torch.full((world, e), cap, device=dev) if live is None else live,
        world, e, cap, n)
    pieces = -(-e // RING_PIECE_EXPERTS)
    inst = symmetric_buffers("ag_group_gemm", ctx.collective_id, "wgmma",
                             a.dtype, world, dev, words=2 + world * pieces)
    gathered = inst.buffer("gathered", (world, e, cap, k), a.dtype)
    out = torch.empty((world, world, e, cap, n), dtype=out_dtype, device=dev)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("ag_group_gemm", _SIGNATURES)
    common = (units.data_ptr(), ntiles.data_ptr(),
              None if live is None else live.data_ptr(), out.data_ptr(),
              inst.peers(gathered), inst.signal_peers(), world, e, cap, n, k,
              units.shape[0], RING_PIECE_EXPERTS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if int8:
        rc = lib.ag_group_gemm_w8a8(
            a.data_ptr(), b.data_ptr(), scales.data_ptr(),
            w_scales.data_ptr(), *common, _build.DTYPE_CODES[out_dtype],
            inst.epoch, ctypes.byref(blocks), stream)
    else:
        rc = lib.ag_group_gemm_wgmma(a.data_ptr(), b.data_ptr(), *common,
                                     inst.epoch, ctypes.byref(blocks), stream)
    _build.check(lib, rc, "ag_group_gemm (wgmma) kernel launch")
    inst.advance(blocks.value)
    return out


def _launch(a, b, counts, ctx):
    """One launch of the first body of csrc/ag_group_gemm.cu over every
    rank (f32, or bf16 off 16-byte rows)."""
    world, e, cap, k = a.shape
    n = b.shape[3]
    dev = a.device
    _check_launch(a, b, None, None, counts)
    # Routing metadata for the kernel: per chunk, the row tiles (of the
    # kernel's tile) that hold a token before each expert, and their total.
    bm = row_tile(cap, a.dtype)
    live = torch.full((world, e), cap, device=dev) if counts is None else (
        counts.long().clamp(0, cap))
    live = (live + bm - 1) // bm
    tile_start = torch.cat([live.new_zeros((world, 1)), live.cumsum(1)],
                           dim=1).to(torch.int32)
    inst = symmetric_buffers("ag_group_gemm", ctx.collective_id, "ring",
                             a.dtype, world, dev)
    gathered = inst.buffer("gathered", (world, e, cap, k), a.dtype)
    out = torch.empty((world, world, e, cap, n), dtype=a.dtype, device=dev)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("ag_group_gemm", _SIGNATURES)
    rc = lib.ag_group_gemm(
        a.data_ptr(), b.data_ptr(), tile_start.data_ptr(), out.data_ptr(),
        inst.peers(gathered), inst.signal_peers(), world,
        _build.DTYPE_CODES[a.dtype], e, cap, n, k, inst.epoch,
        ctypes.byref(blocks), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "ag_group_gemm kernel launch")
    inst.advance(blocks.value)
    return out
