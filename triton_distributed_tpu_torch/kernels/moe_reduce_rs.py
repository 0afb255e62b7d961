"""Grouped GEMM + top-k weighted combine + ReduceScatter, the MoE
tensor-parallel epilogue (port of `triton_distributed_tpu/kernels/
moe_reduce_rs.py` `MoEReduceRSContext`, `moe_reduce_rs` and
`moe_reduce_rs_fused`).

Operands are rank-stacked (`parallel.mesh`).  Rank r holds the activated
expert buckets of every chunk, (W, E, cap, k_loc) (chunk c: the tokens
rank c owns after the scatter), and its row shard of the down projection
(E, k_loc, n); rank c gets chunk c's top-k weighted combine of the sum
over the ranks, (mc, n).

- `moe_reduce_rs`: the staged golden, `grouped_matmul` (K8) of every
  rank's buckets, `moe_utils.combine_tokens`, then `reduce_scatter` (K16).
- `moe_reduce_rs_fused` (K10): one cooperative launch over every rank of
  ``csrc/moe_reduce_rs.cu``: the packed grouped GEMM of every chunk's
  occupied rows (`moe_utils.plan_chunks`), each row rounded to the
  activations' dtype into the chunk's packed stage; then, chunk by chunk
  in the order (r + 1 + s) mod W, each token's kept pairs
  (`moe_utils.combine_pairs`, ascending expert order) weighted by the
  bf16-rounded combine weight and summed in f32, the partial rounded to
  the activations' dtype and stored into slot r of rank c's receive
  buffer; last, the W partials summed in f32 in rank order.  bf16 on
  16-byte rows (`kernel_body`; every main-path call) runs the Hopper body:
  K11's units (`allgather_group_gemm.unit_list`), each one expert's
  column tile of 128 times up to four 64-row boxes of its live buckets, so
  a rank loads each tile of its down shard once for every chunk's rows,
  and only the counted rows are staged (`wgmma_stores`, the plain model of
  its stores).  f32, int8 weights and bf16 off 16-byte rows run the first
  body: chunk by chunk, the GEMM of the chunk's occupied blocks, a barrier
  of the rank's blocks, the combine.  With int8 weights (and their (E, n)
  scales) the buckets are quantized per token and the GEMM is int8 with
  the dequant epilogue (float(acc) * sa) * sw, as the JAX kernel's.  The
  plain version, `moe_reduce_rs_fused_plain`, keeps the same roundings and
  orders.

On a CPU tensor the wrappers compute the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build, moe_utils
from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
    UNIT_ROWS, unit_list)
from triton_distributed_tpu_torch.kernels.grouped_gemm import (
    grouped_matmul, packed_combine_reference, packed_matmul_reference)
from triton_distributed_tpu_torch.kernels.quantized import quantize_sym
from triton_distributed_tpu_torch.kernels.reduce_scatter import (
    ReduceScatterContext, reduce_scatter, sum_in_rank_order)
from triton_distributed_tpu_torch.language.core import symmetric_buffers
from triton_distributed_tpu_torch.parallel.mesh import MAX_WORLD

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"moe_reduce_rs": [_P] * 13 + [_I] * 11 + [
    ctypes.c_uint64, ctypes.POINTER(_I), _P],
               "moe_reduce_rs_wgmma": [_P] * 12 + [_I] * 9 + [
    ctypes.c_uint64, ctypes.POINTER(_I), _P]}


@dataclasses.dataclass(frozen=True)
class MoEReduceRSContext:
    """``collective_id`` keys the instance's symmetric buffers and
    signals (and the staged golden's `reduce_scatter`'s)."""

    axis: str
    world_size: int
    num_experts: int
    topk: int
    collective_id: int = cids.MOE_REDUCE_RS


def moe_reduce_rs(buckets, expert_weights, expert_ids, slot_of_pair,
                  topk_weights, ctx: MoEReduceRSContext):
    """The staged golden.  buckets (W, E, cap, k_loc) (every rank's
    routed tokens, its K shard), expert_weights (W, E, k_loc, n); the
    routing (n_tokens, topk) of `moe_utils.route_capacity` on all tokens.
    Returns (W, n_tokens / W, n): K8 over every rank's experts in one
    launch, the combine, then K16."""
    world, e, cap, k = buckets.shape
    n = expert_weights.shape[3]
    expert_out = grouped_matmul(
        buckets.reshape(world * e, cap, k),
        expert_weights.reshape(world * e, k, n)).reshape(world, e, cap, n)
    combined = torch.stack([moe_utils.combine_tokens(
        expert_out[r], expert_ids, slot_of_pair, topk_weights)
        for r in range(world)])
    return reduce_scatter(combined, ReduceScatterContext(
        ctx.axis, world, collective_id=ctx.collective_id))


def moe_reduce_rs_fused_plain(buckets, expert_weights, plan, rows, weights,
                              scales=None, weight_scales=None):
    """The plain version of K10 on its operands as the kernel gets them:
    buckets (W, W, E, cap, k) float, or int8 with ``scales`` (W, W, E,
    cap) and ``weight_scales`` (E, n); ``rows``/``weights`` of
    `moe_utils.combine_pairs`, the weights in the activations' dtype.
    Returns (W, mc, n) in the activations' dtype."""
    world = buckets.shape[0]
    dtype = weights.dtype
    block = plan.pack_block_size
    partials = torch.stack([torch.stack([packed_combine_reference(
        packed_matmul_reference(
            buckets[r, c], expert_weights[r], plan.block_expert[c],
            plan.block_slot[c], plan.n_blocks[c], block, dtype,
            None if scales is None else scales[r, c],
            None if weight_scales is None else weight_scales),
        rows[c], weights[c]).to(dtype) for c in range(world)])
        for r in range(world)])                    # (W rank, W chunk, mc, n)
    return torch.stack([sum_in_rank_order(partials[:, c])
                        for c in range(world)])


def kernel_body(buckets, expert_weights) -> str:
    """The K10 body a launch on these operands runs: "wgmma" for bf16
    activations and weights on 16-byte rows (k and n multiples of 8, both
    operands 16-byte aligned), "int8" for int8 weights (``w8a8_body.cuh``'s tile), "mma"
    for other bf16 (the `mma.sync` tile), "f32" (CUDA cores).  By operand
    only; nothing falls back on a failure."""
    if expert_weights.dtype == torch.int8:
        return "int8"
    if buckets.dtype != torch.bfloat16:
        return "f32"
    k, n = buckets.shape[-1], expert_weights.shape[-1]
    aligned = (buckets.data_ptr() % 16 == 0
               and expert_weights.data_ptr() % 16 == 0)
    return "wgmma" if k % 8 == 0 and n % 8 == 0 and aligned else "mma"


def wgmma_stores(counts, world: int, num_experts: int, cap: int, n: int,
                 block: int) -> dict:
    """A plain model of the Hopper body's stores into the packed stage, one
    entry a stored row: for each unit of `unit_list` (its int4 entries
    decoded as the kernel does) and each live box (row box i, chunk c), the
    rows 64 i + j below ``counts[c, e]``, each to row ``base[c, e] + 64 i +
    j`` of chunk c's stage (base: the expert's first packed block times
    ``block``).  Returns 1-D int64 tensors "unit", "chunk", "expert",
    "slot" (the bucket row), "row" (the stage row) and "col" (the column
    tile of 128)."""
    counts = counts.long()
    units, ntiles = unit_list(counts, world, num_experts, cap, n)
    units = units[:int(ntiles)].long()
    _, off = moe_utils._block_offsets(counts, block)
    boxes = torch.stack((units[:, 2], units[:, 2] >> 16, units[:, 3],
                         units[:, 3] >> 16), 1) & 0xFFFF       # (T, 4)
    live = boxes != 0xFFFF
    t = live.nonzero()[:, 0]
    code = boxes[live]
    c, e = code & 7, units[t, 0]
    slot = (code >> 3)[:, None] * UNIT_ROWS + torch.arange(UNIT_ROWS)
    kept = slot < counts[c, e][:, None]
    row = off[c, e][:, None] * block + slot
    per_row = (lambda x: x[:, None].expand_as(slot)[kept])
    return {"unit": per_row(t), "chunk": per_row(c), "expert": per_row(e),
            "slot": slot[kept], "row": row[kept],
            "col": per_row(units[t, 1])}


def moe_reduce_rs_fused(buckets, expert_weights, plan: moe_utils.ChunkPlan,
                        ctx: MoEReduceRSContext, weight_scales=None):
    """buckets (W, W, E, cap, k_loc): rank r's activated buckets of every
    chunk (the activated output of `ag_group_gemm`), bf16 or f32;
    expert_weights (W, E, k_loc, n) in their dtype, or int8 with
    ``weight_scales`` (E, n) f32 (per expert and output channel, over the
    whole K: `MoEMLP.quantize_params`); ``plan`` the replicated
    `moe_utils.plan_chunks`.  Returns (W, mc, n) in the buckets' dtype.
    Each launch of K10 adds one to ``moe_reduce_rs_fused.launches``."""
    world, e, topk = ctx.world_size, ctx.num_experts, ctx.topk
    if (buckets.dim() != 5 or buckets.shape[:3] != (world, world, e)
            or expert_weights.dim() != 4
            or expert_weights.shape[:2] != (world, e)
            or buckets.shape[4] != expert_weights.shape[2]):
        raise ValueError(f"moe_reduce_rs_fused at world {world}, {e} "
                         f"experts: want buckets (W, W, E, cap, k) and "
                         f"weights (W, E, k, n), got {tuple(buckets.shape)} "
                         f"and {tuple(expert_weights.shape)}")
    cap = buckets.shape[3]
    block = plan.pack_block_size
    if cap % block or plan.combine_blocks.shape[0] != world:
        raise ValueError(f"moe_reduce_rs_fused: capacity {cap}, pack block "
                         f"{block}, plan of {plan.combine_blocks.shape[0]} "
                         f"chunks at world {world}")
    quantized = expert_weights.dtype == torch.int8
    if quantized != (weight_scales is not None):
        raise ValueError("moe_reduce_rs_fused: int8 weights take "
                         "weight_scales, float weights none")
    if quantized and block % 32:
        raise ValueError(f"moe_reduce_rs_fused: int8 packed blocks need "
                         f"32-row alignment, got {block}")
    dtype = buckets.dtype
    rows, weights = moe_utils.combine_pairs(plan, topk)
    weights = weights.to(dtype)
    scales = None
    if quantized:
        buckets, scales = quantize_sym(buckets, -1)
        weight_scales = weight_scales.float().contiguous()
    if buckets.device.type == "cpu":
        return moe_reduce_rs_fused_plain(buckets, expert_weights, plan, rows,
                                         weights, scales, weight_scales)
    if kernel_body(buckets, expert_weights) == "wgmma":
        out = _launch_wgmma(buckets, expert_weights, plan, rows, weights, ctx)
        moe_reduce_rs_fused.wgmma_launches += 1
    else:
        out = _launch(buckets, expert_weights, scales, weight_scales, plan,
                      rows, weights, ctx, dtype)
    moe_reduce_rs_fused.launches += 1
    return out


moe_reduce_rs_fused.launches = 0
moe_reduce_rs_fused.wgmma_launches = 0


def _check_launch(a, b, scales, dtype, named):
    """Raise unless the launch's operands suit the kernels; ``named``:
    (name, tensor or None) of every operand, each contiguous on a's
    device."""
    world, k = a.shape[0], a.shape[4]
    if not 2 <= world <= MAX_WORLD or dtype not in _build.DTYPE_CODES:
        raise ValueError(f"moe_reduce_rs_fused: world {world} (2 to "
                         f"{MAX_WORLD}), activations {dtype}")
    if scales is not None and k % 16:
        raise ValueError(f"moe_reduce_rs_fused: int8 k={k} must be a "
                         "multiple of 16")
    if scales is None and b.dtype != dtype:
        raise ValueError(f"moe_reduce_rs_fused: weights {b.dtype}, "
                         f"activations {dtype}")
    for nm, t in named:
        if t is not None and (t.device != a.device or not t.is_contiguous()):
            raise ValueError(f"moe_reduce_rs_fused: {nm} not contiguous on "
                             f"{a.device}")


def _instance(ctx, world, dtype, dev, int8, mc, n):
    """The call's symmetric instance and its (W, mc, n) receive buffer: the
    bf16 bodies share one (each block of either adds W to its rank's local
    word a call, one arrival a chunk)."""
    inst = symmetric_buffers("moe_reduce_rs", ctx.collective_id,
                             "int8" if int8 else "fused", dtype, world, dev)
    return inst, inst.buffer("rbuf", (world, mc, n), dtype)


def _launch_wgmma(a, b, plan, rows, weights, ctx):
    """One launch of the Hopper body of csrc/moe_reduce_rs.cu over every
    rank."""
    world, _, e, cap, k = a.shape
    n = b.shape[3]
    mc, topk = rows.shape[1:]
    block = plan.pack_block_size
    trows = plan.num_blocks_static * block
    dev = a.device
    counts = plan.counts.to(torch.int32).contiguous()
    _, off = moe_utils._block_offsets(counts, block)
    base = (off * block).to(torch.int32).contiguous()
    units, ntiles = unit_list(counts, world, e, cap, n)
    _check_launch(a, b, None, a.dtype, (
        ("buckets", a), ("weights", b), ("rows", rows),
        ("combine weights", weights)))
    inst, rbuf = _instance(ctx, world, a.dtype, dev, False, mc, n)
    # Each rank's packed stage of every chunk.
    stage = torch.empty((world, world, trows, n), dtype=a.dtype, device=dev)
    out = torch.empty((world, mc, n), dtype=a.dtype, device=dev)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("moe_reduce_rs", _SIGNATURES)
    rc = lib.moe_reduce_rs_wgmma(
        a.data_ptr(), b.data_ptr(), units.data_ptr(), ntiles.data_ptr(),
        counts.data_ptr(), base.data_ptr(), rows.data_ptr(),
        weights.data_ptr(), stage.data_ptr(), out.data_ptr(),
        inst.peers(rbuf), inst.signal_peers(), world, e, cap, k, n, mc,
        trows, topk, units.shape[0], inst.epoch, ctypes.byref(blocks),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "moe_reduce_rs_fused (wgmma) kernel launch")
    inst.advance(blocks.value)
    return out


def _launch(a, b, scales, w_scales, plan, rows, weights, ctx, dtype):
    world, _, e, cap, k = a.shape
    n = b.shape[3]
    mc, topk = rows.shape[1:]
    t_max, block = plan.num_blocks_static, plan.pack_block_size
    dev = a.device
    tables = [t.to(torch.int32).contiguous() for t in (
        plan.block_expert, plan.block_slot, plan.n_blocks)]
    _check_launch(a, b, scales, dtype, (
        ("buckets", a), ("weights", b), ("scales", scales),
        ("weight_scales", w_scales), ("rows", rows),
        ("combine weights", weights), *zip(("tables",) * 3, tables)))
    inst, rbuf = _instance(ctx, world, dtype, dev, scales is not None, mc, n)
    # Each rank's two packed stages (chunks alternate between them).
    stage = torch.empty((world, 2, t_max * block, n), dtype=dtype,
                        device=dev)
    out = torch.empty((world, mc, n), dtype=dtype, device=dev)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("moe_reduce_rs", _SIGNATURES)
    rc = lib.moe_reduce_rs(
        a.data_ptr(), b.data_ptr(),
        None if scales is None else scales.data_ptr(),
        None if w_scales is None else w_scales.data_ptr(),
        *(t.data_ptr() for t in tables), rows.data_ptr(), weights.data_ptr(),
        stage.data_ptr(), out.data_ptr(), inst.peers(rbuf),
        inst.signal_peers(), world, int(scales is not None),
        _build.DTYPE_CODES[dtype], e, cap, k, n, mc, t_max, block, topk,
        inst.epoch, ctypes.byref(blocks),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "moe_reduce_rs_fused kernel launch")
    inst.advance(blocks.value)
    return out
