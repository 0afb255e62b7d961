"""Paged KV management: page pool, radix prefix cache, slot manager (port
of `triton_distributed_tpu/serving/pages.py`).

Host-side structures that cooperate over one `PagedKVCache`:

- `PagePool`: the physical allocator, a free list plus per-page refcounts
  over ``num_pages`` fixed-size pages (page 0 reserved as the null/trash
  page).  A request pins ``ceil(len / page_size)`` pages, its true
  footprint, instead of `SlotKV`'s max-context worst case.
- `RadixCache`: prefix sharing, a radix tree over page-granular token
  chunks.  Full prompt pages are registered at admission; later requests
  whose prompt starts with the same chunks map the SAME physical pages
  (refcounted).  Unreferenced nodes stay cached and are evicted LRU,
  leaves first, when the pool runs dry.  Only pages strictly below
  position ``s-1`` are shared: the insert recomputes position ``s-1`` and
  decode writes from there on, so every page a request can WRITE is
  private.
- `SpillPool`: under KV pressure an evicted refcount-0 prefix page parks
  its content in host memory, and a later prefix hit restores it,
  bit-exactly, onto a fresh page (opt-in, ``spill_pages`` > 0).
- `PagedKV`: the slot manager the scheduler drives: per-slot page tables
  (a host mirror, copied to the device by `flush` only when an
  allocation changed it), incremental allocation as sequences grow
  (`ensure`), page-based admission arithmetic, and the paged insert.

The invariant that makes mid-stream allocation safe: a request was only
admitted if its WORST-CASE pages fit the usable pool, and everything not
referenced by a live request is evictable, so after evicting the radix
cache and preempting down to one request, that request can always grow
to its horizon (the scheduler preempts newest-first when `ensure`
fails).

Not ported in this slice: `PagedKV.adopt_prefix` (its only user is the
serving cluster), `PagedKV.rollback` (speculative decoding), the disk
tier below the host spill (`serving/kvtier.py`), and the kvtier hit/miss
accounting and metrics of the observability slice.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from triton_distributed_tpu_torch.models.kv_cache import (
    NULL_PAGE, PagedKVCache, pages_for)
from triton_distributed_tpu_torch.serving.engine_batched import (
    make_paged_insert_fn)


class PagePool:
    """Free list + refcounts over physical pages 1..num_pages-1 (page
    `NULL_PAGE` is reserved and never allocated)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"num_pages={num_pages}: need >= 2")
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))
        self.refs = np.zeros(num_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages with refcount 1, or None (caller evicts/preempts)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self.refs[ids] = 1
        return ids

    def incref(self, ids: Sequence[int]) -> None:
        for i in ids:
            self.refs[i] += 1

    def decref(self, ids: Sequence[int]) -> None:
        """Drop one reference; pages reaching refcount 0 return to the
        free list.  (Radix-cached pages are kept alive by the tree's own
        reference; eviction drops it.)"""
        for i in ids:
            self.refs[i] -= 1
            assert self.refs[i] >= 0, (i, self.refs[i])
            if self.refs[i] == 0:
                self._free.append(i)


_next_spill_key = itertools.count(1)


class SpillPool:
    """Host-memory parking lot for spilled KV pages.  ``put`` parks one
    page's content (a dict of CPU tensors, one k/v entry per layer) under
    a unique key; ``take`` retrieves and forgets it on restore.  Bounded
    in pages: a full pool refuses the spill and the caller degrades to
    plain eviction."""

    def __init__(self, max_pages: int):
        if max_pages < 1:
            raise ValueError(f"max_pages={max_pages}: need >= 1")
        self.max_pages = int(max_pages)
        self._store: Dict[int, dict] = {}
        self.spilled_out = 0
        self.spilled_in = 0
        self.rejected = 0

    def can_accept(self) -> bool:
        """May one more page be parked right now?  (`RadixCache.evict`
        asks BEFORE the device-to-host page read.)"""
        return len(self._store) < self.max_pages

    def put(self, key: int, payload: dict) -> bool:
        """Park one page; False = pool full (caller evicts plainly)."""
        if len(self._store) >= self.max_pages:
            self.rejected += 1
            return False
        self._store[key] = payload
        self.spilled_out += 1
        return True

    def take(self, key: int) -> Optional[dict]:
        payload = self._store.pop(key, None)
        if payload is not None:
            self.spilled_in += 1
        return payload

    def drop(self, key: int) -> None:
        self._store.pop(key, None)


class _RadixNode:
    __slots__ = ("children", "parent", "chunk", "page", "refs",
                 "last_use", "spill_key")

    def __init__(self, parent, chunk: Tuple[int, ...], page: int):
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.parent = parent
        self.chunk = chunk
        self.page = page
        #: Live requests currently mapping this page (the tree's own
        #: retention is NOT counted here: refs 0 means evictable).
        self.refs = 0
        self.last_use = 0
        #: SpillPool key while this node's content is parked in host
        #: memory (``page`` is then NULL_PAGE); None = on the device.
        self.spill_key: Optional[int] = None

    @property
    def spilled(self) -> bool:
        return self.spill_key is not None


class RadixCache:
    """Page-granular radix tree: node = one full page of prompt tokens,
    keyed by that page's token tuple under its parent.  The tree holds
    one pool reference per cached page; live requests add theirs via
    `acquire`.  `evict` frees LRU refcount-0 leaves."""

    def __init__(self, pool: PagePool, page_size: int,
                 spill: Optional[SpillPool] = None, read_page=None):
        self.pool = pool
        self.page_size = page_size
        self._root = _RadixNode(None, (), NULL_PAGE)
        self._clock = 0
        self.cached_pages = 0   # PHYSICAL pages the tree retains
        #: Pages at refcount 0 (evictable), kept incrementally so the
        #: admission path never walks the tree.
        self._idle_pages = 0
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evicted_pages = 0
        #: Spill-before-evict (optional): the host pool and the
        #: ``read_page(page) -> payload`` reader (wired by `PagedKV`).
        self.spill = spill
        self.read_page = read_page
        self.spilled_nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: Sequence[int]) -> List[_RadixNode]:
        """Longest chain of cached full pages prefixing ``tokens``."""
        ps = self.page_size
        node, path = self._root, []
        j = 0
        while True:
            chunk = tuple(tokens[j * ps:(j + 1) * ps])
            if len(chunk) < ps:
                break
            child = node.children.get(chunk)
            if child is None:
                break
            path.append(child)
            node = child
            j += 1
        return path

    def acquire(self, path: Sequence[_RadixNode]) -> None:
        """Pin ``path`` for one request.  Spilled nodes are pinned too
        but hold no pool reference until the caller restores them
        (`PagedKV.insert_prefill` adds the tree's and the request's)."""
        t = self._tick()
        for n in path:
            if n.refs == 0 and not n.spilled:
                self._idle_pages -= 1
            n.refs += 1
            n.last_use = t
            if not n.spilled:
                self.pool.incref([n.page])

    def release(self, path: Sequence[_RadixNode]) -> None:
        t = self._tick()
        for n in path:
            assert not n.spilled, "released node was never restored"
            n.refs -= 1
            assert n.refs >= 0
            if n.refs == 0:
                self._idle_pages += 1
            n.last_use = t
            self.pool.decref([n.page])

    def restore(self, node: _RadixNode, page: int) -> None:
        """Re-materialize a spilled node onto freshly allocated physical
        ``page`` (the caller wrote the parked content back and holds the
        allocation's refcount 1, which becomes the tree's)."""
        assert node.spilled and node.page == NULL_PAGE
        node.spill_key = None
        node.page = int(page)
        self.cached_pages += 1
        self.spilled_nodes -= 1

    def extend(self, parent_path: Sequence[_RadixNode],
               tokens: Sequence[int], first_page: int,
               page_ids: Sequence[int]) -> List[_RadixNode]:
        """Register pages ``first_page .. first_page+len(page_ids)-1`` of
        ``tokens`` (already written; the tree adds its own pool ref).
        Returns the new nodes, ACQUIRED for the calling request (the
        caller's allocation ref becomes the request's)."""
        ps = self.page_size
        node = parent_path[-1] if parent_path else self._root
        t = self._tick()
        out = []
        for i, page in enumerate(page_ids):
            j = first_page + i
            chunk = tuple(tokens[j * ps:(j + 1) * ps])
            assert len(chunk) == ps, (j, len(chunk))
            assert chunk not in node.children, "duplicate radix chain"
            child = _RadixNode(node, chunk, int(page))
            child.refs = 1            # the inserting request
            child.last_use = t
            node.children[chunk] = child
            self.pool.incref([page])  # tree retention ref
            self.cached_pages += 1
            node = child
            out.append(child)
        return out

    def evictable_pages(self) -> int:
        """Pages the tree could free right now (refcount-0 nodes;
        ancestors of a refs>0 node are refs>0 themselves, so every refs-0
        subtree is fully evictable).  O(1)."""
        return self._idle_pages

    def _frontier_leaf(self, node: _RadixNode) -> bool:
        """May ``node``'s physical page be freed now?  Unheld, physical,
        and every child already spilled."""
        return (node.refs == 0 and not node.spilled
                and all(c.spilled for c in node.children.values()))

    def _prune(self, node: _RadixNode) -> None:
        """Remove an evicted node AND its (necessarily spilled) subtree,
        dropping parked content."""
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children.clear()
            if n.spilled:
                if self.spill is not None:
                    self.spill.drop(n.spill_key)
                n.spill_key = None
                self.spilled_nodes -= 1
        del node.parent.children[node.chunk]

    def evict(self, need: int) -> int:
        """Free up to ``need`` pages, LRU leaves first.  Returns how many
        were freed.  With a `SpillPool` each victim's content is parked in
        host memory first and the node stays in the tree (spilled; a
        later prefix hit restores it); a full spill pool degrades to
        plain eviction."""
        frontier = []                      # (last_use, id, node)
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if self._frontier_leaf(node):
                heapq.heappush(frontier, (node.last_use, id(node), node))
            stack.extend(node.children.values())
        freed = 0
        while freed < need and frontier:
            _, _, victim = heapq.heappop(frontier)
            parent = victim.parent
            spilled = False
            if self.spill is not None and self.read_page is not None:
                # Capacity check BEFORE the device-to-host page copy.
                if self.spill.can_accept():
                    key = next(_next_spill_key)
                    spilled = self.spill.put(key,
                                             self.read_page(victim.page))
                    if spilled:
                        victim.spill_key = key
                        self.spilled_nodes += 1
                else:
                    self.spill.rejected += 1
            self.pool.decref([victim.page])
            if spilled:
                victim.page = NULL_PAGE
            else:
                self._prune(victim)
                self.evicted_pages += 1
            self.cached_pages -= 1
            self._idle_pages -= 1
            freed += 1
            if parent is not self._root and self._frontier_leaf(parent):
                heapq.heappush(frontier,
                               (parent.last_use, id(parent), parent))
        return freed


class PagedKV:
    """Paged slot manager with radix prefix reuse: the `SlotKV` analogue
    the scheduler drives in ``kv_layout="paged"`` mode.

    ``num_pages`` counts USABLE pages (the null page is added).  With
    ``kv_budget_bytes`` instead, the pool holds ``budget //
    bytes_per_page`` pages; with neither, every slot can reach max_seq at
    once (slot-engine parity).  The per-slot keys are a host (num_slots,
    2) int64 array, as in `SlotKV`."""

    def __init__(self, model, num_slots: int, max_seq: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_budget_bytes: Optional[int] = None,
                 prefix_cache: bool = True, spill_pages: int = 0,
                 spill_disk_dir: Optional[str] = None):
        if spill_disk_dir:
            raise NotImplementedError(
                "spill_disk_dir: the disk tier below the host spill "
                "(serving/kvtier.py) is a later slice of the port")
        self.page_size = ps = int(page_size)
        self.max_seq = int(max_seq)
        self.pages_per_seq = t = pages_for(self.max_seq, ps)
        self.num_slots = int(num_slots)
        probe = model.create_paged_cache(1, 2, ps, 1)
        self.bytes_per_page = probe.bytes_per_page()
        del probe
        if num_pages is None:
            if kv_budget_bytes:
                num_pages = int(kv_budget_bytes // self.bytes_per_page)
            else:
                num_pages = self.num_slots * t
        self.usable_pages = int(num_pages)
        if self.usable_pages < 1:
            raise ValueError(f"kv budget holds {self.usable_pages} pages: "
                             "nothing is ever admittable")
        self.kv_budget_bytes = self.usable_pages * self.bytes_per_page
        self.cache: PagedKVCache = model.create_paged_cache(
            self.num_slots, 1 + self.usable_pages, ps, t)
        self.keys = np.zeros((self.num_slots, 2), np.int64)
        self.pool = PagePool(1 + self.usable_pages)
        self.radix = RadixCache(self.pool, ps) if prefix_cache else None
        self.spill: Optional[SpillPool] = None
        if spill_pages and self.radix is not None:
            self.spill = SpillPool(spill_pages)
            self.radix.spill = self.spill
            self.radix.read_page = self._read_page
        self._free: List[int] = list(range(self.num_slots))
        self._active = np.zeros(self.num_slots, bool)
        #: Host mirror of the device page table, the single source of
        #: truth; `flush` copies it before a dispatch when dirty.
        self._table = np.zeros((self.num_slots, t), np.int32)
        self._dirty = True
        #: Per-slot private page ids (allocation order = logical order)
        #: and acquired radix path.
        self._slot_pages: List[List[int]] = [[] for _ in
                                             range(self.num_slots)]
        self._slot_path: List[List[_RadixNode]] = [[] for _ in
                                                   range(self.num_slots)]
        #: Logical pages currently mapped per slot.
        self._mapped = np.zeros(self.num_slots, np.int64)
        self._insert = make_paged_insert_fn()

    # -- occupancy / accounting -----------------------------------------

    @property
    def free_pages(self) -> int:
        return self.pool.free_pages

    @property
    def used_pages(self) -> int:
        return self.pool.used_pages

    @property
    def cached_prefix_pages(self) -> int:
        return self.radix.cached_pages if self.radix else 0

    def _reclaimable(self) -> int:
        return self.pool.free_pages + (
            self.radix.evictable_pages() if self.radix else 0)

    def feasible(self, prompt_len: int, max_new: int) -> bool:
        """Could this request EVER run alone on an empty pool?  The last
        generated token needs no KV write, so the horizon is
        ``prompt_len + max_new - 1`` positions."""
        horizon = prompt_len + max_new - 1
        return (horizon <= self.max_seq
                and pages_for(horizon, self.page_size) <= self.usable_pages)

    def can_admit(self, tokens: Optional[Sequence[int]] = None) -> bool:
        """A slot is free and the pool (after evicting unreferenced prefix
        pages) covers the request's PREFILL pages; growth is incremental
        (`ensure`), with preemption as the safety valve.

        Matched-chain pages at refcount 0 are not counted as evictable:
        `insert_prefill` acquires the chain before allocating, which pins
        exactly those pages.  Spilled chain nodes count as demand: their
        restore allocates a fresh page each."""
        if not self._free:
            return False
        if tokens is None:
            return self._reclaimable() >= 1
        path = self.match_prefix(tokens)
        spilled = sum(1 for n in path if n.spilled)
        need = pages_for(len(tokens), self.page_size) - len(path) + spilled
        reclaim = self.pool.free_pages
        if self.radix is not None:
            on_path_idle = sum(1 for n in path
                               if n.refs == 0 and not n.spilled)
            reclaim += self.radix.evictable_pages() - on_path_idle
        return reclaim >= need

    # -- prefix cache ----------------------------------------------------

    def match_prefix(self, tokens: Sequence[int]) -> List[_RadixNode]:
        """Cached full pages prefixing ``tokens``, capped so every page
        holding positions >= len(tokens)-1 stays private (those get
        written: s-1 is recomputed at insert, generation writes from s
        on).  Host memory never loses a parked page, so a spilled chain
        node is always restorable here."""
        if self.radix is None:
            return []
        return self.radix.match(tokens)[:(len(tokens) - 1) // self.page_size]

    # -- allocation ------------------------------------------------------

    def _alloc(self, n: int) -> Optional[List[int]]:
        if n == 0:
            return []
        ids = self.pool.alloc(n)
        if ids is None and self.radix is not None:
            self.radix.evict(n - self.pool.free_pages)
            ids = self.pool.alloc(n)
        return ids

    def ensure(self, slot: int, need_positions: int) -> bool:
        """Grow slot ``slot``'s mapping to cover KV positions
        ``[0, need_positions)``, called before every dispatch so the
        decode write at ``offset`` always lands in a mapped private page.
        False = pool dry even after eviction (the caller preempts)."""
        need = min(pages_for(need_positions, self.page_size),
                   self.pages_per_seq)
        while self._mapped[slot] < need:
            ids = self._alloc(1)
            if not ids:
                return False
            j = int(self._mapped[slot])
            self._table[slot, j] = ids[0]
            self._slot_pages[slot].append(ids[0])
            self._mapped[slot] = j + 1
            self._dirty = True
        return True

    def flush(self) -> None:
        """Copy the host page table to the device cache if any allocation
        or release changed it since the last dispatch.  The copy is
        synchronous, so later host edits cannot race it."""
        if self._dirty:
            self.cache.with_page_table(self._table)
            self._dirty = False

    # -- lifecycle -------------------------------------------------------

    def insert_prefill(self, row_cache, tokens: Sequence[int],
                       prompt_len: int, key,
                       shared_path: List[_RadixNode],
                       row_start: int = 0) -> int:
        """Claim a slot, map shared prefix pages + freshly allocated
        private pages, scatter the prefilled row cache into the private
        pages, set offset to ``prompt_len - 1`` and the slot's key.
        ``row_cache`` covers prompt positions ``[row_start, prompt_len)``
        (``row_start = 0`` for a full prefill, or the page-aligned
        shared-prefix length for the suffix path).  Full prompt pages are
        registered in the radix cache so later arrivals share them.
        Returns the slot."""
        s = int(prompt_len)
        ps = self.page_size
        assert self._free, "insert_prefill without can_admit()"
        assert row_start % ps == 0, row_start
        c_pages = len(shared_path)
        assert row_start <= c_pages * ps
        total_pages = pages_for(s, ps)
        # Acquire the shared chain BEFORE allocating: _alloc may evict
        # refcount-0 radix pages, and the matched chain must not be among
        # them.
        if shared_path and self.radix is not None:
            self.radix.acquire(shared_path)
            # Restore any spilled chain node: a fresh page (its allocation
            # ref becomes the tree's), the parked content written back,
            # plus this request's own ref (acquire skipped it while the
            # node was spilled).  can_admit budgeted these pages.
            for node in shared_path:
                if not node.spilled:
                    continue
                ids = self._alloc(1)
                assert ids is not None, "insert_prefill without can_admit()"
                payload = self.spill.take(node.spill_key)
                assert payload is not None, node.spill_key
                self._write_page(ids[0], payload)
                self.radix.restore(node, ids[0])
                self.pool.incref([ids[0]])
        priv = self._alloc(total_pages - c_pages)
        assert priv is not None, "insert_prefill without can_admit()"
        slot = self._free.pop(0)
        # host table row: shared chain, then private pages, then NULL
        row = np.full(self.pages_per_seq, NULL_PAGE, np.int32)
        for j, node in enumerate(shared_path):
            row[j] = node.page
        for i, p in enumerate(priv):
            row[c_pages + i] = p
        self._table[slot] = row
        self._mapped[slot] = total_pages
        self._dirty = True
        # physical destination of each LOCAL row page (NULL = discard:
        # shared pages the row may not overwrite, pad-tail overflow)
        n_row_pages = pages_for(row_cache.max_seq, ps)
        page_ids = np.full(n_row_pages, NULL_PAGE, np.int32)
        for j in range(n_row_pages):
            g = row_start // ps + j
            if c_pages <= g < total_pages:
                page_ids[j] = row[g]
        self._insert(self.cache, self.keys, row_cache, key, slot, page_ids,
                     s - 1)
        self._active[slot] = True
        self._slot_pages[slot] = list(priv)
        self._slot_path[slot] = list(shared_path)
        # Register newly written FULL prompt pages (strictly below
        # position s-1) so the next same-prefix arrival shares them.
        if self.radix is not None:
            sharable = (s - 1) // ps          # pages 0..sharable-1
            n_new = sharable - c_pages
            if n_new > 0:
                new_pages = [row[c_pages + i] for i in range(n_new)]
                nodes = self.radix.extend(shared_path, tokens, c_pages,
                                          new_pages)
                # ownership moved: the request holds these through its
                # radix path, not as private pages
                self._slot_pages[slot] = list(priv[n_new:])
                self._slot_path[slot] = list(shared_path) + nodes
            self.radix.hit_tokens += c_pages * ps
            self.radix.miss_tokens += s - c_pages * ps
        return slot

    def release(self, slot: int) -> None:
        """Retire a slot: drop its radix references (pages stay cached
        for future prefix hits), free its private pages, reset its offset
        AND its page-table row to NULL: a masked row keeps issuing
        frozen-offset writes, which must land in the trash page, never in
        a page someone else may get."""
        if not 0 <= slot < self.num_slots or slot in self._free:
            raise ValueError(f"slot {slot} is not live")
        if self._slot_path[slot] and self.radix is not None:
            self.radix.release(self._slot_path[slot])
        self.pool.decref(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_path[slot] = []
        self._table[slot] = NULL_PAGE
        self._mapped[slot] = 0
        self._dirty = True
        self.cache.reset_slot(slot)
        self._active[slot] = False
        self._free.append(slot)

    # -- spill content I/O (admission path, not the decode hot path) ----

    def _page_tensors(self):
        """Payload name -> per-layer pool: ``k{i}``/``v{i}``, and the int8
        scale pools ``ks{i}``/``vs{i}`` (the JAX payload's names)."""
        c = self.cache
        names = {"k": c.ks, "v": c.vs, "ks": c.kss or [], "vs": c.vss or []}
        return {f"{n}{i}": t for n, ts in names.items()
                for i, t in enumerate(ts)}

    def _read_page(self, page: int) -> dict:
        """One physical page's content across all layers as CPU tensors
        (the SpillPool payload); a copy of the stored dtypes (int8 codes
        and f32 scales when int8), so restore is bit-exact."""
        return {name: t[page].to("cpu", copy=True)
                for name, t in self._page_tensors().items()}

    def _write_page(self, page: int, payload: dict) -> None:
        """Write parked content back into physical ``page`` (restore)."""
        for name, t in self._page_tensors().items():
            t[page].copy_(payload[name])

    def active_mask(self) -> np.ndarray:
        return self._active.copy()

    def snapshot_key(self, slot: int) -> np.ndarray:
        """A slot's current key (seed, tokens emitted), copied (the
        preemption path: the resumed request continues its key chain)."""
        return self.keys[slot].copy()
