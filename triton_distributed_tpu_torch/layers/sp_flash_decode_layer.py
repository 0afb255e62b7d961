"""Sequence-parallel GQA flash-decode layer (port of
`triton_distributed_tpu/layers/sp_flash_decode_layer.py`
`SpFlashDecodeAttention` :27-54).

The KV cache is split over the ``sp_size`` ranks along the sequence in the
contiguous layout: rank r holds positions [r * S_loc, (r + 1) * S_loc) of
every row, rank-stacked as (W, B, Hkv, S_loc, D) (`parallel.mesh`).  The
layer turns each row's global length into each rank's filled length and
runs `kernels.flash_decode.sp_flash_decode`.  It has no weights.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels.flash_decode import sp_flash_decode


@dataclasses.dataclass
class SpFlashDecodeAttention:
    """``sp_size`` ranks along ``axis``, each holding ``max_seq_per_rank``
    positions of the cache."""

    axis: str
    sp_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_seq_per_rank: int
    collective_id: int = cids.SP_FLASH_DECODE

    def local_kv_len(self, total_len, rank):
        """Contiguous layout: rank ``rank`` holds positions [rank * S_loc,
        (rank + 1) * S_loc), so its filled length is clamp(total - rank *
        S_loc, 0, S_loc)."""
        s_loc = self.max_seq_per_rank
        return torch.clamp(total_len - rank * s_loc, 0, s_loc)

    def __call__(self, q, k_shard, v_shard, total_len):
        """q (B, H, D) replicated; k_shard, v_shard (W, B, Hkv, S_loc, D);
        total_len (B,) int32 global lengths.  Returns (W, B, H, D), every
        rank's copy of the output."""
        ranks = torch.arange(self.sp_size, device=total_len.device)
        kv_len_local = self.local_kv_len(total_len[None, :],
                                         ranks[:, None]).to(torch.int32)
        return sp_flash_decode(q, k_shard, v_shard,
                               kv_len_local.contiguous(), self.axis,
                               collective_id=self.collective_id)
