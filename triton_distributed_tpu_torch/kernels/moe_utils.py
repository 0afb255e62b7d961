"""MoE routing tables: histograms, capacity-padded routing, gather and
combine, and the per-chunk packed plan of the fused MoE kernels (port of
`triton_distributed_tpu/kernels/moe_utils.py`, which is XLA code there and
plain tensor code here).

Dynamic token counts per expert are handled by capacity padding (a fixed
number of slots an expert; pairs past it are dropped), which keeps the
grouped GEMM's shapes static.  Every function is bit-equal to the JAX
one: earlier tokens win slots (a stable sort by expert), empty slots point
at the sentinel token ``n_tokens``, dropped pairs get slot -1.
`plan_chunks` routes each rank's chunk with its own capacity and packs its
occupied slots into blocks (`pack_block`, `packed_block_bound`): the block
tables steer K10's grouped GEMM and ``counts`` K11's tile skipping;
`combine_pairs` reads each token's pairs off the plan for K10's combine.
Nothing here waits for the device (no ``bincount``, no boolean-mask
indexing), so a plan is built while the card works.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

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


def pack_block(capacity: int) -> int:
    """Default row block of the packed plan: the largest power of two
    <= 128 that divides ``capacity`` (capacity is a multiple of 16, of 32
    for w8a8: `MoEMLP.capacity`)."""
    return math.gcd(capacity, 128)


def packed_block_bound(n_pairs: int, num_experts: int, capacity: int,
                       block: int) -> int:
    """Static row-block budget T of a packed plan (shape only): expert e
    occupies ceil(min(count_e, capacity) / block) blocks, at most
    ``n_pairs // block + num_experts`` over all experts and at most the
    dense grid ``num_experts * (capacity // block)``."""
    if capacity % block:
        raise ValueError(f"capacity {capacity} is not a multiple of the "
                         f"block {block}")
    return max(min(n_pairs // block + num_experts,
                   num_experts * (capacity // block)), 1)


class ChunkPlan(NamedTuple):
    """Per-chunk routing (tokens row-partitioned into ``world`` chunks,
    chunk c the rows rank c owns after the reduce-scatter, each routed
    with its own capacity) and its ragged packed block schedule.

    dispatch_index: (world, E, cap) int32 — chunk-local source token
      index per expert slot (sentinel mc = empty).
    counts:         (world, E) int32 — tokens per (chunk, expert) bucket,
      capped at cap; drives the empty-tile skipping of `ag_group_gemm`.
    slot_of_pair:   (world, mc, topk) int32 — slot each (token, k) pair
      landed in (-1 = dropped).
    block_expert:   (world, T) int32 — expert of packed block t (0 past
      ``n_blocks``).
    block_slot:     (world, T) int32 — slot block of that expert (slot
      rows [block_slot B, block_slot B + B)).
    n_blocks:       (world,) int32 — occupied packed blocks per chunk;
      blocks are laid out in expert order.
    combine_blocks: (world, T, B, mc) — the combine weight of the pair in
      row b of packed block t for token m (0 elsewhere).
    """

    dispatch_index: torch.Tensor
    counts: torch.Tensor
    slot_of_pair: torch.Tensor
    block_expert: torch.Tensor
    block_slot: torch.Tensor
    n_blocks: torch.Tensor
    combine_blocks: torch.Tensor

    @property
    def pack_block_size(self) -> int:
        return self.combine_blocks.shape[2]

    @property
    def num_blocks_static(self) -> int:
        return self.combine_blocks.shape[1]


def _block_offsets(counts, block: int):
    """(blocks an expert occupies, its first packed block) per (chunk,
    expert): ceil(counts / block) and their exclusive cumulative sum."""
    blocks_e = (counts + block - 1) // block
    return blocks_e, torch.cumsum(blocks_e, dim=-1) - blocks_e


def plan_chunks(expert_ids, weights, world: int, num_experts: int,
                capacity: int, dtype=torch.float32,
                block: Optional[int] = None) -> ChunkPlan:
    """Route each of ``world`` row chunks of expert_ids (n_tokens, topk)
    independently with its own capacity, then pack each chunk's occupied
    slots into blocks of ``block`` rows (default `pack_block(capacity)`),
    with the combine weights (``weights`` (n_tokens, topk), cast to
    ``dtype``) in the packed layout.  Every field is bit-equal to the JAX
    `plan_chunks` (`_pack_chunk`).

    The chunks are routed together: chunk c's expert e is expert c E + e
    of one `route_capacity` over world E experts, which keeps each chunk's
    stable order and capacity."""
    n_tokens, topk = expert_ids.shape
    if n_tokens % world or tuple(weights.shape) != (n_tokens, topk):
        raise ValueError(f"plan_chunks: ids {tuple(expert_ids.shape)}, "
                         f"weights {tuple(weights.shape)}, world {world}")
    mc = n_tokens // world
    block = block or pack_block(capacity)
    t_max = packed_block_bound(mc * topk, num_experts, capacity, block)
    dev = expert_ids.device
    ids = expert_ids.reshape(world, mc, topk).long()
    chunk = torch.arange(world, device=dev)
    r = route_capacity((ids + num_experts * chunk[:, None, None]).reshape(
        n_tokens, topk), world * num_experts, capacity)
    # Global token ids -> chunk-local, the sentinel n_tokens -> mc.
    dispatch = r.dispatch_index.reshape(world, num_experts, capacity)
    dispatch = torch.where(dispatch == n_tokens, mc,
                           dispatch - mc * chunk[:, None, None].to(
                               torch.int32))
    slot_of_pair = r.slot_of_pair.reshape(world, mc, topk)
    counts = r.counts.reshape(world, num_experts).clamp(max=capacity)

    blocks_e, off = _block_offsets(counts, block)
    total = blocks_e.sum(-1)
    t_ids = torch.arange(t_max, device=dev).expand(world, t_max)
    used = t_ids < total[:, None]
    bexp = torch.where(used, torch.searchsorted(
        torch.cumsum(blocks_e, -1), t_ids.contiguous(), right=True), 0)
    bslot = torch.where(used, t_ids - off.gather(1, bexp), 0)

    # Pair (token i, slot s of expert e) -> block off_e + s // B, row
    # s % B, column i; dropped pairs go to a spare block that is cut off.
    kept = slot_of_pair >= 0
    safe = torch.where(kept, slot_of_pair, 0).long()
    pair_t = torch.where(kept, off.gather(1, ids.reshape(world, -1)
                                          ).reshape(world, mc, topk)
                         + safe // block, t_max)
    tok = torch.arange(mc, device=dev)[None, :, None].expand_as(ids)
    wv = torch.where(kept, weights.reshape(world, mc, topk), 0.0).to(dtype)
    cmatb = torch.zeros((world, t_max + 1, block, mc), dtype=dtype,
                        device=dev)
    cmatb.index_put_((chunk[:, None, None].expand_as(ids), pair_t,
                      safe % block, tok), wv, accumulate=True)
    return ChunkPlan(
        dispatch_index=dispatch.contiguous(), counts=counts,
        slot_of_pair=slot_of_pair, block_expert=bexp.to(torch.int32),
        block_slot=bslot.to(torch.int32), n_blocks=total.to(torch.int32),
        combine_blocks=cmatb[:, :t_max].contiguous())


def dense_combine_mats(plan: ChunkPlan, capacity: int):
    """The dense (world, E, mc, cap) combine tensor of a packed plan (a
    test utility, as the JAX one: no path reads it)."""
    world, t_max, block, mc = plan.combine_blocks.shape
    e = plan.counts.shape[1]
    t_ids = torch.arange(t_max, device=plan.n_blocks.device)
    safe_e = torch.where(t_ids[None] < plan.n_blocks[:, None].long(),
                         plan.block_expert.long(), e)
    dense = torch.zeros((world, e + 1, capacity // block, block, mc),
                        dtype=plan.combine_blocks.dtype,
                        device=plan.combine_blocks.device)
    chunk = torch.arange(world, device=dense.device)[:, None]
    dense.index_put_((chunk.expand_as(safe_e), safe_e,
                      plan.block_slot.long()), plan.combine_blocks,
                     accumulate=True)
    return dense[:, :e].reshape(world, e, capacity, mc).transpose(2, 3)


def combine_pairs(plan: ChunkPlan, topk: int):
    """Each token's kept pairs as rows of the packed stage (T B rows, block
    t's rows t B ..) in ascending expert order, and their combine weights:
    (world, mc, topk) int32 rows (-1 past a token's kept pairs) and
    (world, mc, topk) weights in the plan's dtype.  Read off
    ``dispatch_index`` (chunk-major over slots, so a stable sort by token
    keeps the expert order) and ``combine_blocks``; nothing waits for the
    device."""
    world, e, cap = plan.dispatch_index.shape
    mc = plan.combine_blocks.shape[3]
    block = plan.pack_block_size
    dev = plan.dispatch_index.device
    _, off = _block_offsets(plan.counts, block)
    slot = torch.arange(cap, device=dev)
    row = (off[:, :, None] * block + slot).reshape(world, -1)   # stage row
    tok = plan.dispatch_index.reshape(world, -1).long()
    order = torch.argsort(tok, dim=-1, stable=True)
    tok_s = tok.gather(1, order)
    row_s = row.gather(1, order)
    pos = (torch.arange(e * cap, device=dev)
           - torch.searchsorted(tok_s, tok_s, side="left"))
    # Empty slots (token mc) and positions past topk go to spare cells.
    dst = torch.where(tok_s < mc, tok_s * (topk + 1) + pos.clamp(max=topk),
                      mc * (topk + 1))
    rows = torch.full((world, mc * (topk + 1) + 1), -1, dtype=torch.int32,
                      device=dev)
    rows.scatter_(1, dst, row_s.to(torch.int32))
    rows = rows[:, :-1].reshape(world, mc, topk + 1)[..., :topk].contiguous()
    flat = plan.combine_blocks.reshape(world, -1, mc)          # (W, T B, mc)
    w = flat[torch.arange(world, device=dev)[:, None, None],
             rows.clamp(min=0).long(),
             torch.arange(mc, device=dev)[None, :, None]]
    return rows, torch.where(rows >= 0, w, 0)
