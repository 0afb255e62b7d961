"""Toy single-layer attention LM implementing the engine contract (port
of `triton_distributed_tpu/serving/toy.py`).

Same interface as `models.qwen.Qwen3` (`create_cache`,
`create_paged_cache`, `prefill`, `decode`, `decode_paged`; prefill sets
the offset, decode writes KV at per-row offsets and attends positions
``< offset + 1``) plus `prefill_suffix`, but plain torch with no kernel
(the JAX toy is plain `jnp` too), so the scheduler's tests exercise the
real continuous-batching machinery (bucketed prefill, slot and paged
insert, masked step, radix cache, preemption) on any host.  Position
embeddings make the logits depend on absolute position, so a wrong slot
offset or a consumed pad tail shows up as wrong tokens.  Caches are
updated in place.

With ``ToyConfig.quantize_kv_cache`` both layouts hold an int8 cache with
per-token scales (`kernels.flash_decode.quantize_kv`), as the JAX toy:
writes quantize, reads dequantize, so the slot and the paged engines see
the same dequantized values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from triton_distributed_tpu_torch.kernels.flash_decode import write_kv
from triton_distributed_tpu_torch.models.kv_cache import (
    KVCache, PagedKVCache)
from triton_distributed_tpu_torch.utils.platform import resolve_device

_PARAMS = ("embed", "pe", "wq", "wk", "wv", "wo")


@dataclasses.dataclass
class ToyConfig:
    vocab_size: int = 97
    hidden: int = 32
    max_seq_len: int = 128
    quantize_kv_cache: bool = False


class ToyModel:
    """Parameters live in ``self.params`` (a dict of f32 tensors on the
    model's device); fill them with `init_params` or `load_jax_params`."""

    def __init__(self, config: Optional[ToyConfig] = None, device=None):
        self.config = cfg = config or ToyConfig()
        self.device = resolve_device(device)
        h, v = cfg.hidden, cfg.vocab_size
        shapes = {"embed": (v, h), "pe": (cfg.max_seq_len, h),
                  "wq": (h, h), "wk": (h, h), "wv": (h, h), "wo": (h, v)}
        self.params = {n: torch.empty(shapes[n], dtype=torch.float32,
                                      device=self.device) for n in _PARAMS}

    def init_params(self, generator: torch.Generator) -> "ToyModel":
        """N(0, 1/hidden) for every parameter, as the JAX toy."""
        std = self.config.hidden ** -0.5
        for p in self.params.values():
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device).mul_(std))
        return self

    def load_jax_params(self, params) -> "ToyModel":
        """Copy the JAX toy's parameter dict (numpy-convertible leaves)."""
        for n in _PARAMS:
            src = torch.from_numpy(np.array(params[n], dtype=np.float32))
            if tuple(src.shape) != tuple(self.params[n].shape):
                raise ValueError(f"{n}: shape {tuple(src.shape)} != "
                                 f"{tuple(self.params[n].shape)}")
            self.params[n].copy_(src)
        return self

    def create_cache(self, batch: int, max_seq: Optional[int] = None):
        cfg = self.config
        return KVCache.create(1, batch, 1, max_seq or cfg.max_seq_len,
                              cfg.hidden, torch.float32, device=self.device,
                              quantized=cfg.quantize_kv_cache)

    def create_paged_cache(self, batch: int, num_pages: int,
                           page_size: int, max_pages_per_seq: int):
        cfg = self.config
        return PagedKVCache.create(1, num_pages, batch, 1, page_size,
                                   cfg.hidden, max_pages_per_seq,
                                   torch.float32, device=self.device,
                                   quantized=cfg.quantize_kv_cache)

    def _kv(self, ids, positions):
        """Token and position embedding, and its K and V.  Positions past
        the table (a suffix prefill's padding beyond ``max_seq_len``) read
        its last row, as the JAX toy's gather clamps; the paged insert
        drops their K/V."""
        p = self.params
        pos = positions.long().clamp(max=self.config.max_seq_len - 1)
        x = p["embed"][ids.long()] + p["pe"][pos]
        return x, x @ p["wk"], x @ p["wv"]

    def prefill(self, ids, cache: KVCache):
        """ids: (B, S).  Writes positions [0, S) of ``cache`` and sets its
        offset to S.  Returns logits (B, V) of the last position."""
        b, s = ids.shape
        x, k, v = self._kv(ids, torch.arange(s, device=ids.device)[None])
        q = x @ self.params["wq"]
        scores = torch.einsum("bqh,bkh->bqk", q, k) * self.config.hidden ** -0.5
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=ids.device).tril()
        att = torch.softmax(torch.where(causal[None], scores, -torch.inf),
                            dim=-1)
        out = torch.einsum("bqk,bkh->bqh", att, v)
        cache.write_prefill(0, k[:, None], v[:, None])
        cache.set_offset(s)
        return out[:, -1] @ self.params["wo"]

    def prefill_suffix(self, ids, start: int, cache: KVCache) -> None:
        """Prefix-cache-aware prefill: K/V for positions ``[start, start +
        S)`` of a prompt whose first ``start`` tokens are cached, at LOCAL
        positions [0, S) of ``cache`` (the paged insert scatters local
        pages to physical pages).  The toy's K/V at position i depend
        only on token i and position i, so no attention over the prefix
        is needed.  No logits: the serving insert recomputes position s-1
        and never reads prefill logits."""
        s = ids.shape[1]
        _, k, v = self._kv(ids, start + torch.arange(s, device=ids.device)[None])
        cache.write_prefill(0, k[:, None], v[:, None])
        cache.set_offset(s)

    def _attend(self, x, kf, vf, offset):
        """x: (B, h) queries at ``offset``; kf/vf: (B, S, h) logical K/V;
        attends positions <= offset.  Returns logits (B, V)."""
        q = x @ self.params["wq"]
        mask = (torch.arange(kf.shape[1], device=x.device)[None, :]
                <= offset[:, None])
        scores = torch.einsum("bh,bsh->bs", q, kf) * self.config.hidden ** -0.5
        att = torch.softmax(torch.where(mask, scores, -torch.inf), dim=-1)
        return torch.einsum("bs,bsh->bh", att, vf) @ self.params["wo"]

    @staticmethod
    def _write(cache, lead, pos, k, v) -> None:
        """One new K/V row per batch row, k/v (B, h), at ``[lead, 0,
        pos]`` of layer 0 (quantized per token when the cache is int8)."""
        kc, vc, ks, vs = cache.layer(0)
        write_kv((kc, vc), None if ks is None else (ks, vs),
                 (lead, slice(None), pos), k[:, None], v[:, None])

    @staticmethod
    def _dequant(k, v, k_scale=None, v_scale=None):
        """(k, v) as f32 values: int8 codes times their scales."""
        if k_scale is None:
            return k, v
        return k.float() * k_scale[..., None], v.float() * v_scale[..., None]

    def decode(self, tokens, cache: KVCache):
        """tokens: (B,).  Writes each row's K/V at ``cache.offset``,
        attends, advances every offset by one.  Returns logits (B, V)."""
        offset = cache.offset
        x, k, v = self._kv(tokens, offset)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        self._write(cache, rows, offset.long(), k, v)
        kf, vf = self._dequant(*cache.layer(0))
        logits = self._attend(x, kf[:, 0], vf[:, 0], offset)
        cache.inc_offset(1)
        return logits

    def decode_paged(self, tokens, cache: PagedKVCache):
        """`decode` through the page table: the new K/V goes to row
        ``offset % page`` of page ``page_table[b, offset // page]``
        (masked rows' null-mapped writes land in the trash page), and
        attention gathers the pool back into logical order.  Token for
        token the dense decode when T x page equals the dense max_seq."""
        offset = cache.offset
        ps = cache.page_size
        x, k, v = self._kv(tokens, offset)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        pos = offset.long()
        phys = cache.page_table[rows, pos // ps].long()
        self._write(cache, phys, pos % ps, k, v)
        kf, vf = self._dequant(*cache.gather_logical(0))
        logits = self._attend(x, kf[:, 0], vf[:, 0], offset)
        cache.inc_offset(1)
        return logits
