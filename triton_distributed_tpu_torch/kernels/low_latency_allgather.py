"""Low-latency all-gather for small (decode-path) payloads (port of
`triton_distributed_tpu/kernels/low_latency_allgather.py`
`create_fast_allgather_context` :44, `fast_allgather` :55 and
`fast_allgather_packed` :75 and `fast_allgather_2d` :61).

Both are K15's one-shot ``"push_all"`` method (`kernels.allgather`): one
traversal, every shard straight to every rank, which on this card's
cooperative launch signals each arrival beside its data, so no flag is
packed into the payload.  `fast_allgather_packed` gathers several small
tensors with one launch.  `fast_allgather_2d` is the two-level form over a
(dcn, ici) mesh: `hierarchical.all_gather_2d` with the ICI stage on
push_all.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels.allgather import (
    AllGatherContext, AllGatherMethod, all_gather)
from triton_distributed_tpu_torch.kernels.hierarchical import all_gather_2d

#: The packed payload's row is padded to this many bytes, the kernel's
#: 16-byte copy unit (the JAX package pads to 128 lanes for Mosaic).
PACK_ALIGN_BYTES = 16


def create_fast_allgather_context(axis: str, world_size: int,
                                  collective_id: int = cids.LL_ALLGATHER
                                  ) -> AllGatherContext:
    return AllGatherContext(axis=axis, world_size=world_size,
                            method=AllGatherMethod.PUSH_ALL,
                            collective_id=collective_id)


def fast_allgather(x, ctx: AllGatherContext):
    """The one-shot push all-gather: x (W, m, n) -> (W, W*m, n)."""
    return all_gather(x, ctx)


def fast_allgather_2d(x, hctx):
    """The two-level low-latency all-gather: x (W, m, ...) -> (W, W*m,
    ...) over the (dcn, ici) mesh of ``hctx``
    (`kernels.hierarchical.HierarchicalContext`), the ICI stage forced onto
    the one-shot push_all (K15, one launch a slice)."""
    return all_gather_2d(x, dataclasses.replace(
        hctx, ag_method=AllGatherMethod.PUSH_ALL))


def fast_allgather_packed(tensors: Sequence[torch.Tensor],
                          ctx: AllGatherContext):
    """Gather several small rank-stacked tensors of one dtype with one
    launch: each (W, m_i, ...) is flattened a rank, the rows concatenated
    and padded to `PACK_ALIGN_BYTES`, gathered, and unpacked.  Returns a
    list of (W, W*m_i, ...)."""
    world = ctx.world_size
    flats = [t.reshape(world, 1, -1) for t in tensors]
    sizes = [f.shape[2] for f in flats]
    payload = torch.cat(flats, dim=2)
    per = PACK_ALIGN_BYTES // payload.element_size() or 1
    pad = (-payload.shape[2]) % per
    if pad:
        payload = torch.nn.functional.pad(payload, (0, pad))
    gathered = all_gather(payload.contiguous(), ctx)     # (W, W, total)
    outs, off = [], 0
    for t, size in zip(tensors, sizes):
        part = gathered[:, :, off:off + size]
        outs.append(part.reshape(world, world * t.shape[1], *t.shape[2:]))
        off += size
    return outs
