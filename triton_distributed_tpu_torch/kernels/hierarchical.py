"""Two-level (dcn x ici) collectives (port of `triton_distributed_tpu/
kernels/hierarchical.py`: `HierarchicalContext` :64,
`create_hierarchical_context` :145, `all_gather_2d` :177,
`reduce_scatter_2d` :204, `all_reduce_2d` :235 and
`hierarchical_all_to_all` :269).

The mesh is `parallel.make_hierarchical_mesh(dcn, ici)`: W = dcn * ici
ranks in one process, global rank g = dcn_index * ici_size + ici_index,
rank g's data row g of a rank-stacked (W, ...) tensor.  Slice s holds the
ranks s * ici .. (s + 1) * ici - 1, a contiguous run of rows.

Each op has the JAX package's two stages, in its order:

- the ICI stage is the kernel already ported, K15 (`all_gather`), K16
  (`reduce_scatter`) or K19 (`fast_all_to_all`), launched once a slice on
  that slice's rows ``x[s*ici:(s+1)*ici]`` with an instance of its own
  (the context's ``group`` is the slice index), so each ICI stage is
  ``dcn`` launches;
- the DCN stage is an XLA collective in JAX (``all_gather``,
  ``psum_scatter``, ``psum``, ``all_to_all`` over the dcn axis); here it is
  plain torch on the stack: a reshape or transpose, or a sum.  The sums
  (``psum_scatter`` and ``psum`` over dcn) add the slices' partials in f32
  in slice order 0 .. dcn-1 and round once to the input's dtype; at dcn =
  2 that is one rounded add, the same bits as JAX's sum in the input dtype.

``ag_method`` / ``rs_method`` choose the ICI stage's method (as
`AllGatherContext` / `ReduceScatterContext`), ``a2a_method`` the
exchange's ("auto", K19, or "xla", its plain version), ``gemm_method`` the
ICI stage of the two-level GEMMs (`allgather_gemm._ag_gemm_2d`,
`gemm_reduce_scatter._gemm_rs_2d`).  ``straggler`` and
``for_correctness`` reach the ICI stages of the collectives and the
exchange; the port's K12 and K14 take no fault injection.

On CPU tensors every ICI stage runs its kernel's plain version.  The
observability events and the comm-sanitizer registration are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels.allgather import (
    AllGatherContext, AllGatherMethod, all_gather)
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    AllGatherGEMMContext)
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    GEMMReduceScatterContext)
from triton_distributed_tpu_torch.kernels.low_latency_all_to_all import (
    AllToAllContext, fast_all_to_all)
from triton_distributed_tpu_torch.kernels.reduce_scatter import (
    ReduceScatterContext, ReduceScatterMethod, reduce_scatter,
    sum_in_rank_order)


@dataclasses.dataclass
class HierarchicalContext:
    """Two levels of one mesh: ``dcn_size`` slices of ``ici_size`` ranks,
    along ``dcn_axis`` and ``ici_axis``.  ``collective_id`` keys every ICI
    stage's instances (one a slice)."""

    ici_axis: str
    dcn_axis: str
    ici_size: int
    dcn_size: int
    ag_method: AllGatherMethod = AllGatherMethod.AUTO
    rs_method: ReduceScatterMethod = ReduceScatterMethod.AUTO
    collective_id: int = cids.HIERARCHICAL
    gemm_method: str = "auto"
    a2a_method: str = "auto"
    straggler: Optional[tuple] = None
    for_correctness: bool = False

    @property
    def world_size(self) -> int:
        return self.ici_size * self.dcn_size

    def slice_rows(self, s: int) -> slice:
        """The stack rows of slice ``s``."""
        return slice(s * self.ici_size, (s + 1) * self.ici_size)

    def _ag_ctx(self, s: int) -> AllGatherContext:
        return AllGatherContext(
            axis=self.ici_axis, world_size=self.ici_size,
            method=AllGatherMethod(self.ag_method),
            collective_id=self.collective_id, straggler=self.straggler,
            for_correctness=self.for_correctness, group=s)

    def _rs_ctx(self, s: int) -> ReduceScatterContext:
        return ReduceScatterContext(
            axis=self.ici_axis, world_size=self.ici_size,
            method=ReduceScatterMethod(self.rs_method),
            collective_id=self.collective_id, straggler=self.straggler,
            for_correctness=self.for_correctness, group=s)

    def _ag_gemm_ctx(self, s: int) -> AllGatherGEMMContext:
        return AllGatherGEMMContext(
            axis=self.ici_axis, world_size=self.ici_size,
            method=self.gemm_method, collective_id=self.collective_id,
            group=s)

    def _gemm_rs_ctx(self, s: int) -> GEMMReduceScatterContext:
        return GEMMReduceScatterContext(
            axis=self.ici_axis, world_size=self.ici_size,
            method=self.gemm_method, collective_id=self.collective_id,
            group=s)

    def _a2a_ctx(self, s: int, cap: int, hidden: int) -> AllToAllContext:
        return AllToAllContext(
            axis=self.ici_axis, world_size=self.ici_size,
            max_tokens_per_rank=cap, hidden=hidden,
            collective_id=self.collective_id, method=self.a2a_method,
            straggler=self.straggler, for_correctness=self.for_correctness,
            group=s)


def create_hierarchical_context(mesh, ici_axis: str, dcn_axis: str,
                                **kw) -> HierarchicalContext:
    """From a two-axis mesh (`parallel.make_hierarchical_mesh`)."""
    return HierarchicalContext(
        ici_axis=ici_axis, dcn_axis=dcn_axis,
        ici_size=mesh.axis_size(ici_axis), dcn_size=mesh.axis_size(dcn_axis),
        **kw)


def _check(who, x, ctx, rows_mult=1):
    if x.dim() < 2 or x.shape[0] != ctx.world_size or x.shape[1] % rows_mult:
        raise ValueError(f"{who} at (dcn {ctx.dcn_size}, ici {ctx.ici_size})"
                         f": want a rank-stacked (W, ...) operand with W = "
                         f"{ctx.world_size}, got {tuple(x.shape)}")


def all_gather_2d(x, ctx: HierarchicalContext):
    """Gather the rank-stacked row shards x (W, m, ...) over both levels ->
    (W, W*m, ...), rows in global rank order.  DCN stage first (each rank
    gets the shards of its ICI position in every slice, dcn * m rows),
    then K15 over each slice on those rows."""
    _check("all_gather_2d", x, ctx)
    dcn, ici = ctx.dcn_size, ctx.ici_size
    m, rest = x.shape[1], x.shape[2:]
    # ICI position i of every slice holds the shards of position i of
    # every slice (the same rows in each slice).
    xd = x.reshape(dcn, ici, m, *rest).transpose(0, 1).reshape(
        ici, dcn * m, *rest).contiguous()
    full = torch.cat([all_gather(xd, ctx._ag_ctx(s)) for s in range(dcn)])
    # Each rank's (ici, dcn, m) -> the global rank order (dcn, ici, m).
    full = full.reshape(dcn * ici, ici, dcn, m, *rest).transpose(1, 2)
    return full.reshape(dcn * ici, dcn * ici * m, *rest)


def reduce_scatter_2d(x, ctx: HierarchicalContext):
    """Sum the rank-stacked partials x (W, W*m, ...) over both levels and
    give rank g row chunk g -> (W, m, ...).  K16 over each slice first, on
    chunks ordered by ICI position (each holding the dcn chunks of that
    position), then the slices' partials summed (see the module
    docstring for the order)."""
    world = ctx.world_size
    _check("reduce_scatter_2d", x, ctx, world)
    dcn, ici = ctx.dcn_size, ctx.ici_size
    m, rest = x.shape[1] // world, x.shape[2:]
    xi = x.reshape(world, dcn, ici, m, *rest).transpose(1, 2).reshape(
        world, ici * dcn * m, *rest).contiguous()
    mine = torch.cat([reduce_scatter(xi[ctx.slice_rows(s)], ctx._rs_ctx(s))
                      for s in range(dcn)])               # (W, dcn * m, ..)
    # Rank (d, i) gets the sum over slices d' of rank (d', i)'s chunk d.
    parts = mine.reshape(dcn, ici, dcn, m, *rest)
    total = sum_in_rank_order(parts)                      # (ici, dcn, m, ..)
    return total.transpose(0, 1).reshape(world, m, *rest)


def all_reduce_2d(x, ctx: HierarchicalContext):
    """Sum the rank-stacked partials x (W, m, ...) over both levels -> (W,
    m, ...), every rank's copy: K16 over each slice on the rows padded to a
    multiple of ici, the slices' chunks summed, K15 over each slice."""
    _check("all_reduce_2d", x, ctx)
    dcn, ici = ctx.dcn_size, ctx.ici_size
    m, rest = x.shape[1], x.shape[2:]
    pad = (-m) % ici
    xp = x if not pad else torch.cat(
        [x, x.new_zeros((x.shape[0], pad, *rest))], dim=1)
    xp = xp.contiguous()
    chunk = torch.cat([reduce_scatter(xp[ctx.slice_rows(s)], ctx._rs_ctx(s))
                       for s in range(dcn)])        # (W, mp / ici, ...)
    total = sum_in_rank_order(chunk.reshape(dcn, ici, *chunk.shape[1:]))
    summed = total[None].expand(dcn, *total.shape).reshape(chunk.shape)
    summed = summed.contiguous()
    full = torch.cat([all_gather(summed[ctx.slice_rows(s)], ctx._ag_ctx(s))
                      for s in range(dcn)])
    return full[:, :m] if pad else full


def hierarchical_all_to_all(send_tokens, send_counts,
                            ctx: HierarchicalContext, send_scales=None):
    """The two-stage exchange over (dcn, ici): send_tokens (W, W, cap,
    hidden) (block [r, g] what rank r sends to global rank g),
    send_counts (W, W, 1) int32, send_scales None or (W, W, cap, ns) ->
    (recv_tokens, recv_counts[, recv_scales]) of the same shapes, block
    [r, g] what rank g sent to rank r.  The DCN hop takes each
    destination slice's blocks to the rank of the same ICI position there
    (a transpose of the stack); K19 over each slice then delivers them,
    dcn blocks of cap rows per destination, with their summed counts; the
    fine counts ride the same two hops (plain tensor code, as JAX's XLA
    ``all_to_all``)."""
    dcn, ici = ctx.dcn_size, ctx.ici_size
    world = dcn * ici
    if (send_tokens.dim() != 4 or send_tokens.shape[:2] != (world, world)
            or send_counts.shape != (world, world, 1)):
        raise ValueError(f"hierarchical_all_to_all at world {world}: want "
                         f"send (W, W, cap, hidden) and counts (W, W, 1), "
                         f"got {tuple(send_tokens.shape)} and "
                         f"{tuple(send_counts.shape)}")
    cap = send_tokens.shape[2]

    def stage1(t):
        # [src slice, src i, dst slice, dst i] -> the proxy's regrouping:
        # row (dst slice, src i) holds, per dst i, the dcn source slices.
        t = t.reshape(dcn, ici, dcn, ici, *t.shape[2:])
        return t.permute(2, 1, 3, 0, *range(4, t.dim())).reshape(
            world, ici, dcn * cap, t.shape[-1]).contiguous()

    counts = send_counts.to(torch.int32)
    coarse = counts.reshape(dcn, ici, dcn, ici).permute(2, 1, 3, 0).sum(
        -1, dtype=torch.int32).reshape(world, ici, 1).contiguous()
    t2 = stage1(send_tokens)
    s2 = None if send_scales is None else stage1(send_scales)
    outs = []
    for s in range(dcn):
        rows = ctx.slice_rows(s)
        outs.append(fast_all_to_all(
            t2[rows], coarse[rows],
            ctx._a2a_ctx(s, dcn * cap, send_tokens.shape[-1]),
            send_scales=None if s2 is None else s2[rows]))

    def to_global(parts):
        # [rank, src i, (src slice, cap)] -> [rank, (src slice, src i), cap]
        r = torch.cat(parts).reshape(world, ici, dcn, cap, -1)
        return r.transpose(1, 2).reshape(world, world, cap, r.shape[-1])

    recv_tokens = to_global([o[0] for o in outs])
    recv_counts = counts.transpose(0, 1).contiguous()
    if send_scales is None:
        return recv_tokens, recv_counts
    return recv_tokens, recv_counts, to_global([o[2] for o in outs])
