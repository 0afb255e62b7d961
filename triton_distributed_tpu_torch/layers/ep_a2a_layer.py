"""Expert-parallel AllToAll layer: dispatch and combine (port of
`triton_distributed_tpu/layers/ep_a2a_layer.py` `EPAll2AllLayer` :35).

Every rank of the one-process mesh is a row of a rank-stacked tensor
(`parallel.mesh`): tokens (W, n_loc, hidden), their top-k expert ids and
weights (W, n_loc, topk).  `dispatch` groups each rank's (token, k) pairs
by destination rank (expert // experts_per_rank) with
`moe_utils.route_capacity` (stable, capacity-dropped slots: earlier tokens
win), fills the capacity-padded send blocks, and exchanges them with K19
(`fast_all_to_all`), the local expert ids riding along as an f32 payload of
width 1 (the JAX layer's scale slot).  `combine` sends the processed blocks
back with K19 and takes each token's weighted sum over its kept pairs
(`moe_utils.combine_tokens`, f32).  The routing is plain tensor code, as it
is XLA code in the JAX layer; every rank's routing is computed in one pass
(rank r's destinations offset by r * W, so the stable order and the slots
are each rank's own).

`HierarchicalEPAll2AllLayer` is the same layer over a (dcn, ici) mesh
(`parallel.make_hierarchical_mesh`): its exchanges are
`kernels.hierarchical.hierarchical_all_to_all` (the DCN hop to the proxy of
the same ICI position in the destination slice, then K19 over each slice),
global EP rank g = dcn_index * ici_size + ici_index.  The routing and the
combine are the flat layer's, so the two layers give the same result on
the same routing.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import hierarchical, moe_utils
from triton_distributed_tpu_torch.kernels.low_latency_all_to_all import (
    AllToAllContext, fast_all_to_all)


@dataclasses.dataclass
class EPAll2AllLayer:
    """``ep_size`` ranks along ``axis`` own ``num_experts`` experts,
    ``experts_per_rank`` each in order; a token goes to ``topk`` of them;
    ``max_tokens_per_rank`` rows a (source, destination) block of
    ``hidden`` columns.  ``collective_ids``: the dispatch's and the
    combine's exchanges (distinct: they may run back to back)."""

    axis: str
    ep_size: int
    num_experts: int
    topk: int
    max_tokens_per_rank: int
    hidden: int
    collective_ids: tuple = (cids.EP_DISPATCH, cids.EP_COMBINE)

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.ep_size

    def _a2a_ctx(self, cid) -> AllToAllContext:
        return AllToAllContext(
            axis=self.axis, world_size=self.ep_size,
            max_tokens_per_rank=self.max_tokens_per_rank, hidden=self.hidden,
            collective_id=cid)

    def _exchange(self, send_tokens, counts, cid, send_scales=None):
        return fast_all_to_all(send_tokens, counts, self._a2a_ctx(cid),
                               send_scales=send_scales)

    def dispatch(self, tokens, expert_ids):
        """Route every rank's tokens to the expert-owner ranks.

        tokens (W, n_loc, hidden); expert_ids (W, n_loc, topk) int.
        Returns (recv_tokens (W, W, cap, hidden), recv_expert (W, W, cap)
        int32, the local expert id of each received row, recv_counts (W, W,
        1) int32, send_plan): block [r, p] is what rank p sent to rank r.
        ``send_plan`` is (routing, kept): rank-stacked `moe_utils.Routing`
        fields (dispatch_index (W, W, cap) rank-local token indices, the
        sentinel n_loc empty; slot_of_pair (W, n_loc, topk); counts (W, W)
        uncapped) and the kept-pair mask, for `combine`."""
        ep, cap, epr = self.ep_size, self.max_tokens_per_rank, \
            self.experts_per_rank
        world, n_loc, topk = expert_ids.shape
        if world != ep or tokens.shape != (ep, n_loc, self.hidden):
            raise ValueError(f"dispatch at ep_size {ep}: tokens "
                             f"{tuple(tokens.shape)}, expert_ids "
                             f"{tuple(expert_ids.shape)}")
        dev = tokens.device
        ids = expert_ids.long()
        dest = ids // epr                                     # (W, n, topk)
        rank = torch.arange(ep, device=dev)[:, None, None]
        routing = moe_utils.route_capacity(
            (dest + rank * ep).reshape(ep * n_loc, topk), ep * ep, cap)
        slot = routing.slot_of_pair.reshape(ep, n_loc, topk)
        kept = slot >= 0
        # Each kept pair's row of the flattened (W, W, cap) send blocks;
        # dropped pairs land in a spare row that is cut off (no boolean
        # mask: it would wait for the device).
        spare = ep * ep * cap
        row = torch.where(kept, ((rank * ep + dest) * cap + slot.long()),
                          spare).reshape(-1)
        send = tokens.new_zeros((spare + 1, self.hidden))
        send[row] = tokens[:, :, None].expand(
            ep, n_loc, topk, self.hidden).reshape(-1, self.hidden)
        send_expert = torch.zeros(spare + 1, dtype=torch.int32, device=dev)
        send_expert[row] = (ids % epr).to(torch.int32).reshape(-1)
        counts = routing.counts.reshape(ep, ep, 1).clamp_max(cap)
        recv_tokens, recv_counts, recv_expert = self._exchange(
            send[:spare].view(ep, ep, cap, self.hidden), counts.contiguous(),
            self.collective_ids[0],
            send_scales=send_expert[:spare].float().view(ep, ep, cap, 1))
        index = routing.dispatch_index.reshape(ep, ep, cap).long()
        local = torch.where(index == ep * n_loc, n_loc,
                            index - rank * n_loc).to(torch.int32)
        plan = moe_utils.Routing(dispatch_index=local, slot_of_pair=slot,
                                 counts=routing.counts.reshape(ep, ep))
        return (recv_tokens, recv_expert[..., 0].to(torch.int32),
                recv_counts, (plan, kept))

    def combine(self, expert_out, recv_counts, send_plan, topk_weights,
                expert_ids):
        """Return the processed rows to their owners and take each token's
        top-k weighted sum.  expert_out (W, W, cap, hidden): the processed
        rows still in arrival layout (block [r, p] the rows rank r received
        from rank p); topk_weights (W, n_loc, topk).  Returns (W, n_loc,
        hidden) in expert_out's dtype."""
        back, _ = self._exchange(expert_out, recv_counts,
                                 self.collective_ids[1])
        plan, _kept = send_plan
        ep, n_loc, topk = expert_ids.shape
        dest = expert_ids.long() // self.experts_per_rank
        # `moe_utils.combine_tokens` on every rank at once: the destination
        # rank plays the expert's role.
        return moe_utils.combine_tokens(
            back.reshape(ep * ep, *back.shape[2:]),
            (dest + torch.arange(ep, device=dest.device)[:, None, None]
             * ep).reshape(ep * n_loc, topk),
            plan.slot_of_pair.reshape(ep * n_loc, topk),
            topk_weights.reshape(ep * n_loc, topk)).reshape(
                ep, n_loc, -1)


@dataclasses.dataclass
class HierarchicalEPAll2AllLayer(EPAll2AllLayer):
    """The two-level EP layer (JAX `HierarchicalEPAll2AllLayer` :122):
    ``axis`` is the ICI (intra-slice) axis, ``dcn_axis`` spans the
    ``dcn_size`` slices, and ``ep_size`` is the whole dcn * ici world."""

    dcn_axis: str = "dcn"
    dcn_size: int = 1

    @property
    def ici_size(self) -> int:
        return self.ep_size // self.dcn_size

    def _hctx(self, cid) -> hierarchical.HierarchicalContext:
        return hierarchical.HierarchicalContext(
            ici_axis=self.axis, dcn_axis=self.dcn_axis,
            ici_size=self.ici_size, dcn_size=self.dcn_size,
            collective_id=cid)

    def _exchange(self, send_tokens, counts, cid, send_scales=None):
        return hierarchical.hierarchical_all_to_all(
            send_tokens, counts, self._hctx(cid), send_scales=send_scales)
