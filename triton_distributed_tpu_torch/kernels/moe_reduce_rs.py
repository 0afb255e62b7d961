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
  ``csrc/moe_reduce_rs.cu``.  Per chunk, in the order (r + 1 + s) mod W:
  the packed grouped GEMM over the chunk's occupied blocks
  (`moe_utils.plan_chunks`), each tile rounded to the activations' dtype;
  then each token's kept pairs (`moe_utils.combine_pairs`, ascending
  expert order) weighted by the bf16-rounded combine weight and summed in
  f32; the partial rounded to the activations' dtype and stored into slot
  r of rank c's receive buffer; last, the W partials summed in f32 in
  rank order.  With int8 weights (and their (E, n) scales) the buckets are
  quantized per token and the GEMM is int8 with the dequant epilogue
  (float(acc) * sa) * sw, as the JAX kernel's.  The plain version,
  `moe_reduce_rs_fused_plain`, keeps the same roundings and orders.

On a CPU tensor the wrappers compute the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build, moe_utils
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
    out = _launch(buckets, expert_weights, scales, weight_scales, plan,
                  rows, weights, ctx, dtype)
    moe_reduce_rs_fused.launches += 1
    return out


moe_reduce_rs_fused.launches = 0


def _launch(a, b, scales, w_scales, plan, rows, weights, ctx, dtype):
    world, _, e, cap, k = a.shape
    n = b.shape[3]
    mc, topk = rows.shape[1:]
    t_max, block = plan.num_blocks_static, plan.pack_block_size
    dev = a.device
    if not 2 <= world <= MAX_WORLD or dtype not in _build.DTYPE_CODES:
        raise ValueError(f"moe_reduce_rs_fused: world {world} (2 to "
                         f"{MAX_WORLD}), activations {dtype}")
    if scales is not None and k % 16:
        raise ValueError(f"moe_reduce_rs_fused: int8 k={k} must be a "
                         "multiple of 16")
    if scales is None and b.dtype != dtype:
        raise ValueError(f"moe_reduce_rs_fused: weights {b.dtype}, "
                         f"activations {dtype}")
    tables = [t.to(torch.int32).contiguous() for t in (
        plan.block_expert, plan.block_slot, plan.n_blocks)]
    for nm, t in (("buckets", a), ("weights", b), ("scales", scales),
                  ("weight_scales", w_scales), ("rows", rows),
                  ("combine weights", weights), *zip(("tables",) * 3,
                                                     tables)):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"moe_reduce_rs_fused: {nm} not contiguous on "
                             f"{dev}")
    inst = symmetric_buffers("moe_reduce_rs", ctx.collective_id,
                             "int8" if scales is not None else "fused",
                             dtype, world, dev)
    rbuf = inst.buffer("rbuf", (world, mc, n), dtype)
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
