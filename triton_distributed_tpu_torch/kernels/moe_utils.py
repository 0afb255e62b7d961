"""MoE routing tables: histograms, capacity-padded routing, gather and
combine (port of `triton_distributed_tpu/kernels/moe_utils.py`, which is
XLA code there and plain tensor code here).

Dynamic token counts per expert are handled by capacity padding (a fixed
number of slots an expert; pairs past it are dropped), which keeps the
grouped GEMM's shapes static.  Every function is bit-equal to the JAX
one: earlier tokens win slots (a stable sort by expert), empty slots point
at the sentinel token ``n_tokens``, dropped pairs get slot -1.  Of
`plan_chunks` only the fields the MoE layer's golden path reads
(``dispatch_index``, ``counts``, ``slot_of_pair``) are ported; the packed
block tables and combine weights (`combine_matrix`, `pack_block`) wait
for the fused multi-GPU MoE kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def histogram(expert_ids, num_experts: int):
    """Tokens per expert: expert_ids int (...,) -> (num_experts,) int32.
    (An index add, not ``bincount``, which waits for the device to size
    its output.)"""
    ids = expert_ids.reshape(-1).long()
    return torch.zeros(num_experts, dtype=torch.int32,
                       device=ids.device).index_add_(
                           0, ids, torch.ones_like(ids, dtype=torch.int32))


class Routing(NamedTuple):
    """Capacity-padded routing plan for one (token, topk) assignment.

    dispatch_index: (num_experts, capacity) int32 — source token index
      for each expert slot; ``n_tokens`` marks an empty slot.
    slot_of_pair:   (n_tokens, topk) int32 — slot each (token, k) pair
      landed in, -1 if dropped by capacity.
    counts:         (num_experts,) int32 — true (uncapped) tokens/expert.
    """

    dispatch_index: torch.Tensor
    slot_of_pair: torch.Tensor
    counts: torch.Tensor


def route_capacity(expert_ids, num_experts: int, capacity: int) -> Routing:
    """Build a capacity-padded routing plan.  expert_ids: (n_tokens, topk)
    int.  Deterministic: earlier tokens win slots."""
    n_tokens, topk = expert_ids.shape
    dev = expert_ids.device
    flat_e = expert_ids.reshape(-1).long()
    npairs = flat_e.numel()
    flat_tok = torch.arange(n_tokens, device=dev).repeat_interleave(topk)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = flat_tok[order]
    pos = (torch.arange(npairs, device=dev)
           - torch.searchsorted(sorted_e, sorted_e, side="left"))
    kept = pos < capacity
    # Dropped pairs land in a spare column that is cut off (no boolean
    # mask: it would wait for the device).
    dispatch_index = torch.full((num_experts, capacity + 1), n_tokens,
                                dtype=torch.int32, device=dev)
    dispatch_index[sorted_e, torch.where(kept, pos, capacity)] = (
        sorted_tok.to(torch.int32))
    dispatch_index = dispatch_index[:, :capacity].contiguous()
    slot_of_pair = torch.empty(npairs, dtype=torch.int32, device=dev)
    slot_of_pair[order] = torch.where(kept, pos, -1).to(torch.int32)
    return Routing(dispatch_index=dispatch_index,
                   slot_of_pair=slot_of_pair.reshape(n_tokens, topk),
                   counts=histogram(flat_e, num_experts))


def gather_tokens(tokens, dispatch_index):
    """Expand tokens (n_tokens, hidden) into per-expert buckets
    (E, capacity, hidden).  Empty slots read a zero row (sentinel index
    n_tokens)."""
    padded = torch.cat([tokens, tokens.new_zeros((1,) + tokens.shape[1:])])
    return padded[dispatch_index.long()]


def combine_tokens(expert_out, expert_ids, slot_of_pair, weights):
    """Weighted combine of expert outputs back to token order, in f32.

    expert_out: (E, capacity, H); expert_ids / slot_of_pair / weights:
    (n_tokens, topk).  Dropped pairs contribute zero.  Returns
    (n_tokens, H) in expert_out's dtype."""
    kept = slot_of_pair >= 0
    safe_slot = torch.where(kept, slot_of_pair, 0)
    vals = expert_out[expert_ids.long(), safe_slot.long()]  # (n, topk, H)
    w = torch.where(kept, weights, 0.0)[..., None].float()
    return (vals.float() * w).sum(dim=1).to(expert_out.dtype)


class ChunkPlan(NamedTuple):
    """Per-chunk routing (tokens row-partitioned into ``world`` chunks,
    each routed with its own capacity).

    dispatch_index: (world, E, cap) int32 — chunk-local source token
      index per expert slot (sentinel mc = empty).
    counts:         (world, E) int32 — tokens per (chunk, expert) bucket,
      capped at cap.
    slot_of_pair:   (world, mc, topk) int32 — slot each (token, k) pair
      landed in (-1 = dropped).
    """

    dispatch_index: torch.Tensor
    counts: torch.Tensor
    slot_of_pair: torch.Tensor


def plan_chunks(expert_ids, weights, world: int, num_experts: int,
                capacity: int) -> ChunkPlan:
    """Route each of ``world`` row chunks of expert_ids (n_tokens, topk)
    independently.  ``weights`` (n_tokens, topk) feed only the packed
    combine tables of the fused kernels (not ported); they are checked for
    shape and otherwise unused."""
    n_tokens, topk = expert_ids.shape
    if n_tokens % world or tuple(weights.shape) != (n_tokens, topk):
        raise ValueError(f"plan_chunks: ids {tuple(expert_ids.shape)}, "
                         f"weights {tuple(weights.shape)}, world {world}")
    mc = n_tokens // world
    routes = [route_capacity(ids, num_experts, capacity)
              for ids in expert_ids.reshape(world, mc, topk)]
    return ChunkPlan(
        dispatch_index=torch.stack([r.dispatch_index for r in routes]),
        counts=torch.stack([r.counts.clamp(max=capacity) for r in routes]),
        slot_of_pair=torch.stack([r.slot_of_pair for r in routes]))
