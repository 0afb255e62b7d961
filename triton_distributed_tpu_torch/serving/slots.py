"""Slot-batched KV view: B fixed slots over one `KVCache` (port of
`triton_distributed_tpu/serving/slots.py`).

The decode cache is allocated ONCE at batch = ``num_slots`` and then
only updated in place (the masked step, the slot insert), so admitting a
request never re-zeroes device memory and never changes the decode
step's shapes.  A "slot" is a batch row plus host bookkeeping of which
rows are live.

`SlotKV` owns the per-slot state (the cache, and the per-slot sampling
keys as a host (num_slots, 2) int64 array of (seed, tokens emitted)) and
the host free list and KV admission budget (`KVCache.bytes_per_slot`).
The scheduler (`serving.scheduler`) holds request state; this class never
sees requests.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from triton_distributed_tpu_torch.models.kv_cache import KVCache
from triton_distributed_tpu_torch.serving.engine_batched import (
    make_insert_fn)


class SlotKV:
    def __init__(self, cache: KVCache,
                 kv_budget_bytes: Optional[int] = None):
        self.cache = cache
        self.num_slots = int(cache.offset.shape[0])
        self.max_seq = cache.max_seq
        self.bytes_per_slot = cache.bytes_per_slot()
        #: Admission budget: total KV bytes live slots may pin.  The
        #: cache is preallocated, so this caps concurrency, not
        #: allocation.  None/0 = all slots usable.
        self.kv_budget_bytes = (kv_budget_bytes
                                or self.num_slots * self.bytes_per_slot)
        #: Per-slot keys, advanced by the masked step for active rows
        #: only; the insert overwrites a reused slot's key.
        self.keys = np.zeros((self.num_slots, 2), np.int64)
        self._free: List[int] = list(range(self.num_slots))
        self._active = np.zeros(self.num_slots, bool)
        self._insert = make_insert_fn()

    # -- occupancy ------------------------------------------------------

    @property
    def bytes_in_use(self) -> int:
        return (self.num_slots - len(self._free)) * self.bytes_per_slot

    def can_admit(self) -> bool:
        return bool(self._free) and (
            self.bytes_in_use + self.bytes_per_slot
            <= self.kv_budget_bytes)

    def active_mask(self) -> np.ndarray:
        """(num_slots,) bool: True where a request is live (a copy)."""
        return self._active.copy()

    # -- lifecycle ------------------------------------------------------

    def insert_prefill(self, row_cache: KVCache, prompt_len: int,
                       key) -> int:
        """Claim a free slot and copy a single-row prefilled cache into
        it, offset set to ``prompt_len - 1`` (the masked step recomputes
        position s-1 and emits the first token, see `engine_batched`)
        and the slot's key set to ``key``.  Returns the slot index."""
        if not self.can_admit():
            raise RuntimeError("insert_prefill without can_admit()")
        if row_cache.offset.shape[0] != 1 or row_cache.max_seq > self.max_seq:
            raise ValueError("row cache must be one row of at most "
                             f"max_seq={self.max_seq} positions")
        slot = self._free.pop(0)
        self._insert(self.cache, self.keys, row_cache, key, slot,
                     prompt_len - 1)
        self._active[slot] = True
        return slot

    def release(self, slot: int) -> None:
        """Retire a slot: offset zeroed (`KVCache.reset_slot`: the data
        stays, every attention path masks ``>= offset``) and the slot
        returns to the free list."""
        if not 0 <= slot < self.num_slots or slot in self._free:
            raise ValueError(f"slot {slot} is not live")
        self.cache.reset_slot(slot)
        self._active[slot] = False
        self._free.append(slot)

    def snapshot_key(self, slot: int) -> np.ndarray:
        """A slot's current key (seed, tokens emitted), copied."""
        return self.keys[slot].copy()
