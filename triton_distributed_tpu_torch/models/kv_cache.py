"""Dense KV cache with per-row offsets.

Port of `triton_distributed_tpu/models/kv_cache.py` `KVCache` (float
form).  The JAX cache is a functional pytree whose every update returns a
new cache; this one is updated IN PLACE: every method mutates the
tensors it holds and returns None; a decode step writes its new K/V
rows into ``ks[layer]``/``vs[layer]`` in place (`layers.tp_attn`).
Writes are ordinary kernels on the current stream, so a decode step's
cache write is ordered before the attention kernel that reads it.  The int8 variant and the paged cache are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from triton_distributed_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass
class KVCache:
    ks: List[torch.Tensor]          # per layer: (B, Hkv, S_max, D)
    vs: List[torch.Tensor]
    offset: torch.Tensor            # (B,) int32: filled length

    @classmethod
    def create(cls, num_layers: int, batch: int, num_kv_heads: int,
               max_seq: int, head_dim: int, dtype=torch.bfloat16,
               device=None):
        """Zero-filled cache, as the JAX package allocates it."""
        device = resolve_device(device)
        shape = (batch, num_kv_heads, max_seq, head_dim)
        return cls(
            ks=[torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(num_layers)],
            vs=[torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(num_layers)],
            offset=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def max_seq(self) -> int:
        return self.ks[0].shape[2]

    def write_prefill(self, layer: int, k, v) -> None:
        """k/v: (B, Hkv, S, D): fill positions [0, S) of ``layer``."""
        s = k.shape[2]
        self.ks[layer][:, :, :s].copy_(k)
        self.vs[layer][:, :, :s].copy_(v)

    def inc_offset(self, n: int = 1) -> None:
        self.offset += n

    def set_offset(self, value) -> None:
        self.offset.fill_(value)

    def reset_slot(self, b: int) -> None:
        """Free batch row ``b`` for reuse: zero its offset.  The K/V data
        stays: every attention path masks positions >= offset."""
        self.offset[b] = 0

    def bytes_per_slot(self) -> int:
        """Device bytes one batch row pins across all layers (K + V)."""
        total = 0
        for k, v in zip(self.ks, self.vs):
            per_row = k.shape[1] * k.shape[2] * k.shape[3]
            total += per_row * (k.element_size() + v.element_size())
        return total
