"""Dense KV cache with per-row offsets, and the paged KV pool.

Port of `triton_distributed_tpu/models/kv_cache.py` `KVCache` and
`PagedKVCache`, float or int8.  The JAX caches are functional pytrees
whose every update returns a new cache; these are updated IN PLACE:
every method mutates the tensors it holds and returns None; a decode
step writes its new K/V rows into ``ks[layer]``/``vs[layer]`` in place
(`layers.tp_attn`).  Writes are ordinary kernels on the current stream,
so a decode step's cache write is ordered before the attention kernel
that reads it.

An int8 cache (``quantized=True``) holds int8 K/V codes and per-token
f32 dequant scales ``kss``/``vss`` per layer, (B, Hkv, S) dense or
(P, Hkv, page) paged (`kernels.flash_decode.quantize_kv`): the K/V bytes
are halved, and the scales count in the admission budget.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from triton_distributed_tpu_torch.kernels.flash_decode import (
    gather_pages, quantize_kv)
from triton_distributed_tpu_torch.utils.platform import resolve_device


def _zeros(num_layers, shape, dtype, device):
    return [torch.zeros(shape, dtype=dtype, device=device)
            for _ in range(num_layers)]


def layer_tensors(cache) -> List[torch.Tensor]:
    """Every per-layer tensor of a `KVCache` or `PagedKVCache`: K, V and,
    when int8, the K and V scales.  Each has the slot or page as its
    leading dim."""
    return cache.ks + cache.vs + (cache.kss or []) + (cache.vss or [])


def _row_bytes(cache) -> int:
    """Bytes of one leading-dim row (a slot or a page) over all layers."""
    return sum(t[0].numel() * t.element_size() for t in layer_tensors(cache))


@dataclasses.dataclass
class KVCache:
    ks: List[torch.Tensor]          # per layer: (B, Hkv, S_max, D)
    vs: List[torch.Tensor]
    offset: torch.Tensor            # (B,) int32: filled length
    #: Per-token dequant scales (B, Hkv, S_max) f32 per layer when the
    #: cache is int8; None for a float cache.
    kss: Optional[List[torch.Tensor]] = None
    vss: Optional[List[torch.Tensor]] = None

    @property
    def quantized(self) -> bool:
        return self.kss is not None

    @classmethod
    def create(cls, num_layers: int, batch: int, num_kv_heads: int,
               max_seq: int, head_dim: int, dtype=torch.bfloat16,
               device=None, quantized: bool = False):
        """Zero-filled cache, as the JAX package allocates it; int8 codes
        and f32 scales when ``quantized``."""
        device = resolve_device(device)
        shape = (batch, num_kv_heads, max_seq, head_dim)
        dtype = torch.int8 if quantized else dtype
        scales = (lambda: _zeros(num_layers, shape[:3], torch.float32,
                                 device)) if quantized else (lambda: None)
        return cls(
            ks=_zeros(num_layers, shape, dtype, device),
            vs=_zeros(num_layers, shape, dtype, device),
            offset=torch.zeros((batch,), dtype=torch.int32, device=device),
            kss=scales(), vss=scales(),
        )

    @property
    def max_seq(self) -> int:
        return self.ks[0].shape[2]

    def write_prefill(self, layer: int, k, v) -> None:
        """k/v: (B, Hkv, S, D) float: fill positions [0, S) of ``layer``,
        quantizing on write when the cache is int8."""
        s = k.shape[2]
        if self.quantized:
            k, v, k_scale, v_scale = quantize_kv(k, v)
            self.kss[layer][:, :, :s].copy_(k_scale)
            self.vss[layer][:, :, :s].copy_(v_scale)
        self.ks[layer][:, :, :s].copy_(k)
        self.vs[layer][:, :, :s].copy_(v)

    def layer(self, i: int):
        """(k, v, k_scale, v_scale) of layer ``i``; the scales are None
        for a float cache."""
        return (self.ks[i], self.vs[i],
                self.kss[i] if self.quantized else None,
                self.vss[i] if self.quantized else None)

    def inc_offset(self, n: int = 1) -> None:
        self.offset += n

    def set_offset(self, value) -> None:
        self.offset.fill_(value)

    def reset_slot(self, b: int) -> None:
        """Free batch row ``b`` for reuse: zero its offset.  The K/V data
        stays: every attention path masks positions >= offset."""
        self.offset[b] = 0

    def bytes_per_slot(self) -> int:
        """Device bytes one batch row pins across all layers: K + V, and
        the dequant scales when the cache is int8."""
        return _row_bytes(self)


#: Physical page 0 is reserved as the null/trash page: unmapped page-table
#: entries point at it, and writes that must be discarded (a masked or
#: released row's frozen-offset decode write) land there.  Its contents
#: are garbage by design and are never read below a row's length.
NULL_PAGE = 0


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV positions."""
    return -(-int(tokens) // int(page_size)) if tokens > 0 else 0


@dataclasses.dataclass
class PagedKVCache:
    """One pool of fixed-size pages per layer plus a per-row page table
    mapping logical page ``j`` of row ``b`` to a physical page.  A row of
    length L pins ``ceil(L / page_size)`` pages, and rows may map the same
    physical page (refcounted prefix sharing, `serving.pages`).  The page
    table is managed on the host (`serving.pages.PagedKV`) and copied to
    the device by `with_page_table` when an allocation changed it."""

    ks: List[torch.Tensor]          # per layer: (P, Hkv, page, D)
    vs: List[torch.Tensor]
    page_table: torch.Tensor        # (B, T) int32: physical page ids
    offset: torch.Tensor            # (B,) int32: filled length
    #: Per-token dequant scales (P, Hkv, page) f32 per layer when int8;
    #: None for float pools.
    kss: Optional[List[torch.Tensor]] = None
    vss: Optional[List[torch.Tensor]] = None
    page_size: int = 16

    @property
    def quantized(self) -> bool:
        return self.kss is not None

    @property
    def num_pages(self) -> int:
        return int(self.ks[0].shape[0])

    @property
    def pages_per_seq(self) -> int:
        return int(self.page_table.shape[1])

    @property
    def batch(self) -> int:
        return int(self.offset.shape[0])

    @property
    def max_seq(self) -> int:
        """Logical sequence capacity of one row (T x page_size)."""
        return self.pages_per_seq * self.page_size

    @classmethod
    def create(cls, num_layers: int, num_pages: int, batch: int,
               num_kv_heads: int, page_size: int, head_dim: int,
               max_pages_per_seq: int, dtype=torch.bfloat16, device=None,
               quantized: bool = False):
        """Zero-filled pools; int8 codes and f32 scale pools when
        ``quantized``.  ``num_pages`` INCLUDES the null page 0 (usable
        pages = num_pages - 1)."""
        if num_pages < 2:
            raise ValueError(f"num_pages={num_pages}: need >= 1 usable page "
                             "beside NULL_PAGE")
        device = resolve_device(device)
        shape = (num_pages, num_kv_heads, page_size, head_dim)
        dtype = torch.int8 if quantized else dtype
        scales = (lambda: _zeros(num_layers, shape[:3], torch.float32,
                                 device)) if quantized else (lambda: None)
        return cls(
            ks=_zeros(num_layers, shape, dtype, device),
            vs=_zeros(num_layers, shape, dtype, device),
            page_table=torch.zeros((batch, max_pages_per_seq),
                                   dtype=torch.int32, device=device),
            offset=torch.zeros((batch,), dtype=torch.int32, device=device),
            kss=scales(), vss=scales(),
            page_size=page_size,
        )

    def layer(self, i: int):
        """(k_pool, v_pool, k_scale, v_scale) of layer ``i``; the scales
        are None for float pools."""
        return (self.ks[i], self.vs[i],
                self.kss[i] if self.quantized else None,
                self.vss[i] if self.quantized else None)

    def bytes_per_page(self) -> int:
        """Device bytes one physical page pins across all layers: K + V,
        and the dequant scales when int8.  The unit the paged scheduler's
        admission budget is counted in."""
        return _row_bytes(self)

    def inc_offset(self, n: int = 1) -> None:
        self.offset += n

    def set_offset(self, value) -> None:
        self.offset.fill_(value)

    def reset_slot(self, b: int) -> None:
        """Zero row ``b``'s offset.  Its page-table row is reset on the
        host (`serving.pages.PagedKV.release`) before the next dispatch."""
        self.offset[b] = 0

    def with_page_table(self, table: np.ndarray) -> None:
        """Copy the host page table ((B, T) int32) into the device table.
        The copy is synchronous (``copy_`` from pageable host memory waits
        for it), so the caller may edit ``table`` as soon as this
        returns."""
        self.page_table.copy_(torch.from_numpy(
            np.ascontiguousarray(table, dtype=np.int32)))

    def gather_logical(self, layer: int):
        """Tests: the logical (B, Hkv, T*page, D) view of ``layer``
        through the page table (a copy), as (k, v), or (k, v, k_scale,
        v_scale) with (B, Hkv, T*page) scales when int8.  Decode reads
        through the table in the kernel."""
        return tuple(gather_pages(t, self.page_table)
                     for t in self.layer(layer) if t is not None)
