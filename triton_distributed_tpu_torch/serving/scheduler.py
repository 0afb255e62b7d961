"""Continuous-batching scheduler: Orca-style iteration-level loop (port of
`triton_distributed_tpu/serving/scheduler.py` as it runs with
observability disabled).

Every `step()` is one scheduler iteration:

1. **admit**: while the FIFO head has arrived, a slot is free and the KV
   budget (bytes for ``kv_layout="slots"``, actual PAGES for ``"paged"``)
   allows, run a bucketed single-row prefill (or, on a radix prefix hit
   with a model that has ``prefill_suffix``, a suffix-only prefill) and
   insert it into the running decode batch: requests join mid-flight;
2. **decode**: ONE masked step for all slots
   (`engine_batched.make_masked_step_fn`); free slots emit the pad id and
   do not advance offsets or keys.  Paged mode first maps pages for the
   positions this dispatch writes (`PagedKV.ensure`), preempting the
   newest request (resumed later with its key chain intact) if the pool
   is dry even after LRU-evicting unreferenced prefix pages;
3. **retire**: the step's tokens come to the host (the one sync: EOS is
   data-dependent), are appended, streamed via ``on_token``, and rows that
   hit EOS / ``max_new_tokens`` / the KV horizon release their slot (and,
   paged, their private pages; prompt pages stay cached).

Backpressure is at `submit`: a bounded queue and static feasibility
checks reject with a typed reason instead of queueing unservable work.
Time comes from an injectable ``clock`` (+ optional ``clock_advance`` for
virtual time), so tests replay deterministic arrival schedules.

The model is anything with the engine contract: `create_cache`,
`prefill(ids, cache)`, `decode(tokens, cache)`, and for the paged layout
`create_paged_cache` and `decode_paged(tokens, cache)`
(`models.qwen.Qwen3`, `serving.toy.ToyModel`).  The scheduler runs on the
model's device.  The JAX scheduler's metrics, spans, lineage, cost,
anomaly and autotuner hooks wait for the observability slice;
speculative decoding (``spec_k``), SLO-aware admission (``slo_tbt_ms``)
and shipped prefills (``Request.shipped_kv``) wait for theirs and are
refused here.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from triton_distributed_tpu_torch.serving.engine_batched import (
    DEFAULT_PREFILL_BUCKETS, make_masked_block_fn, make_masked_step_fn,
    pad_prompt, pick_bucket, request_key)
from triton_distributed_tpu_torch.serving.pages import PagedKV
from triton_distributed_tpu_torch.serving.request import (
    FinishReason, RejectReason, Request, RequestState)
from triton_distributed_tpu_torch.serving.slots import SlotKV


@dataclasses.dataclass
class SchedulerConfig:
    num_slots: int = 8
    #: Bounded submit queue: `submit` rejects (QUEUE_FULL) beyond it.
    max_queue: int = 64
    #: Prefill length buckets (entries > max_seq are dropped).
    prefill_buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS
    #: Decode-cache sequence capacity; None = the model config's
    #: max_seq_len.
    max_seq: Optional[int] = None
    #: Cap on KV bytes live slots may pin (None = all slots).  In paged
    #: mode this sizes the PAGE POOL (budget // bytes_per_page pages).
    kv_budget_bytes: Optional[int] = None
    #: "slots" = one contiguous row of max_seq per request (`SlotKV`);
    #: "paged" = page-table-indexed pool with radix prefix sharing
    #: (`PagedKV`), where a request pins only the pages it has filled.
    kv_layout: str = "slots"
    #: Tokens per KV page (paged mode).  For token equality with the
    #: slot engine keep max_seq a multiple of this.
    page_size: int = 16
    #: Usable pages in the pool (paged mode); None = from
    #: kv_budget_bytes, else slot-engine parity.
    num_pages: Optional[int] = None
    #: Radix prefix cache (paged mode).
    prefix_cache: bool = True
    #: Host-memory spill capacity in pages (paged mode; 0 disables):
    #: evicted refcount-0 prefix pages park their content in host memory
    #: and restore bit-exactly on the next prefix hit.
    spill_pages: int = 0
    #: Disk tier below the host spill: a later slice (raises).
    spill_disk_dir: Optional[str] = None
    pad_id: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    #: Decode steps per host sync.  K>1 runs K masked steps per dispatch
    #: and retires at block granularity, over-generating <= K-1
    #: discarded tokens past EOS; pre-EOS tokens are identical.
    steps_per_sync: int = 1
    #: Speculative decoding: a later slice (raises when > 0).
    spec_k: int = 0
    #: SLO-aware admission: a later slice (raises when set).
    slo_tbt_ms: Optional[float] = None


class ContinuousBatchingScheduler:
    """model: anything with the engine contract (see the module
    docstring): `models.qwen.Qwen3` or `serving.toy.ToyModel`."""

    def __init__(self, model, config: Optional[SchedulerConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 clock_advance: Optional[Callable[[float], None]] = None):
        self.model = model
        self.config = cfg = config or SchedulerConfig()
        if getattr(model, "world_size", 1) > 1:
            raise NotImplementedError(
                f"a model at world_size={model.world_size}: the scheduler "
                "at world > 1 is a later slice of the port (no JAX test "
                "holds it there yet)")
        if cfg.spec_k:
            raise NotImplementedError(
                "spec_k: speculative decoding (make_spec_verify_fn, "
                "serving/speculative.py) is a later slice of the port")
        if cfg.slo_tbt_ms is not None:
            raise NotImplementedError(
                "slo_tbt_ms: SLO-aware admission reads the observability "
                "feedback bus, a later slice of the port")
        if cfg.steps_per_sync < 1:
            raise ValueError(f"steps_per_sync={cfg.steps_per_sync} < 1")
        self.clock = clock or time.monotonic
        #: With a virtual clock, how the idle loop moves time forward to
        #: the next arrival; with the default wall clock we sleep.
        self._clock_advance = clock_advance
        self.device = model.device
        self.max_seq = int(cfg.max_seq or model.config.max_seq_len)
        self.buckets = tuple(sorted(
            b for b in cfg.prefill_buckets if b <= self.max_seq))
        if not self.buckets:
            raise ValueError(f"no prefill bucket fits max_seq={self.max_seq}")
        self.paged = cfg.kv_layout == "paged"
        if self.paged:
            if not (hasattr(model, "create_paged_cache")
                    and hasattr(model, "decode_paged")):
                raise ValueError(
                    f"{type(model).__name__} lacks the paged engine "
                    "contract (create_paged_cache / decode_paged)")
            self.slots = PagedKV(
                model, cfg.num_slots, max_seq=self.max_seq,
                page_size=cfg.page_size, num_pages=cfg.num_pages,
                kv_budget_bytes=cfg.kv_budget_bytes,
                prefix_cache=cfg.prefix_cache,
                spill_pages=cfg.spill_pages,
                spill_disk_dir=cfg.spill_disk_dir)
            decode_fn = model.decode_paged
            self._prefill_suffix = (getattr(model, "prefill_suffix", None)
                                    if cfg.prefix_cache else None)
        elif cfg.kv_layout == "slots":
            self.slots = SlotKV(model.create_cache(cfg.num_slots,
                                                   max_seq=self.max_seq),
                                cfg.kv_budget_bytes)
            decode_fn = model.decode
            self._prefill_suffix = None
        else:
            raise ValueError(f"unknown kv_layout {cfg.kv_layout!r}")
        self._step = make_masked_step_fn(
            decode_fn, cfg.temperature, cfg.top_k, cfg.top_p, cfg.pad_id)
        self._block_fn = (make_masked_block_fn(
            decode_fn, cfg.temperature, cfg.top_k, cfg.top_p, cfg.pad_id,
            block=cfg.steps_per_sync) if cfg.steps_per_sync > 1 else None)
        self._tokens = np.full(cfg.num_slots, cfg.pad_id, np.int32)
        #: Per-bucket reusable prefill row caches (see `_row_cache`).
        self._row_caches: Dict[int, object] = {}
        self._queue: Deque[Request] = collections.deque()
        self._by_slot: Dict[int, Request] = {}
        self._stopped = False
        self.finished: List[Request] = []

    # -- submission / backpressure --------------------------------------

    def structural_reject(self, req: Request) -> Optional[RejectReason]:
        """The admission checks that depend only on request geometry
        against this engine's configuration, never on queue state.  One
        is geometry against the CACHE: a prompt longer than every bucket
        is still servable when a cached radix prefix leaves a bucketable
        suffix and the model has a suffix prefill."""
        if pick_bucket(req.prompt_len, self.buckets) is None:
            if not self.paged or self._prefill_suffix is None:
                return RejectReason.PROMPT_TOO_LONG
            c = len(self.slots.match_prefix(req.prompt)) * self.config.page_size
            if c == 0 or pick_bucket(req.prompt_len - c,
                                     self.buckets) is None:
                return RejectReason.PROMPT_TOO_LONG
        if req.prompt_len + req.max_new_tokens > self.max_seq + 1:
            # position max_seq-1 is the last writable KV row, and the
            # final token needs no KV write of its own.
            return RejectReason.EXCEEDS_KV_CAPACITY
        if self.paged and not self.slots.feasible(req.prompt_len,
                                                  req.max_new_tokens):
            # the horizon costs more pages than the pool holds
            return RejectReason.EXCEEDS_KV_CAPACITY
        if (not self.paged
                and self.slots.kv_budget_bytes < self.slots.bytes_per_slot):
            # a budget below one slot could never admit anything
            return RejectReason.EXCEEDS_KV_CAPACITY
        return None

    def submit(self, req: Request) -> bool:
        """Enqueue; False = rejected with ``req.reject_reason`` set."""
        if req.shipped_kv is not None:
            raise NotImplementedError(
                "Request.shipped_kv: prefill shipments come with the "
                "serving cluster, a later slice of the port")
        now = self.clock()
        req.t_arrival = (req.arrival_time if req.arrival_time is not None
                         else now)
        if self._stopped:
            reason = RejectReason.STOPPED
        elif len(self._queue) >= self.config.max_queue:
            reason = RejectReason.QUEUE_FULL
        else:
            reason = self.structural_reject(req)
        if reason is not None:
            req.state = RequestState.REJECTED
            req.reject_reason = reason
            return False
        self._queue.append(req)
        return True

    # -- the iteration loop ---------------------------------------------

    def has_work(self) -> bool:
        return bool(self._queue) or bool(self._by_slot)

    def step(self) -> dict:
        """One scheduler iteration.  Returns counts for introspection:
        ``{"admitted", "active", "retired"}``."""
        now = self.clock()
        admitted = self._admit(now)
        retired = 0
        active_n = len(self._by_slot)
        if self._by_slot:
            retired = self._decode_step()
        elif self._queue:
            # Nothing running, head not arrived yet: move time.
            dt = self._queue[0].t_arrival - now
            if dt > 0:
                if self._clock_advance is not None:
                    self._clock_advance(dt)
                else:
                    time.sleep(min(dt, 0.001))
        return {"admitted": admitted, "active": active_n,
                "retired": retired}

    def drain(self) -> List[Request]:
        """Run until queue and slots are empty; returns the finished
        requests in completion order."""
        while self.has_work():
            self.step()
        return self.finished

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Submit everything (arrivals still gate admission), then
        drain."""
        for r in requests:
            self.submit(r)
        return self.drain()

    def stop(self) -> None:
        """Abort: live requests finish with reason STOPPED, queued ones
        are rejected (or finish, if a preemption left them with output),
        later submits are rejected."""
        self._stopped = True
        for slot in list(self._by_slot):
            self._retire(slot, self.clock(), FinishReason.STOPPED)
        while self._queue:
            req = self._queue.popleft()
            if req.generated:
                req.state = RequestState.FINISHED
                req.finish_reason = FinishReason.STOPPED
                req.t_finish = self.clock()
                self.finished.append(req)
                continue
            req.state = RequestState.REJECTED
            req.reject_reason = RejectReason.STOPPED

    # -- internals ------------------------------------------------------

    def _can_admit_head(self) -> bool:
        if not self.paged:
            return self.slots.can_admit()
        head = self._queue[0]
        return self.slots.can_admit(head.resume_tokens or head.prompt)

    def _request_key(self, req: Request) -> np.ndarray:
        """The key a request starts (or RESUMES) from: its snapshot at
        preemption when it carries one, else (seed, 0)."""
        if req.resume_key is not None:
            return np.asarray(req.resume_key, np.int64)
        return request_key(req.seed)

    def _row_cache(self, bucket: int):
        # One reusable prefill row cache per bucket: prefill overwrites
        # it up to the bucket, and the insert has copied it out before
        # the next prefill is queued on the same stream.
        row = self._row_caches.get(bucket)
        if row is None:
            row = self.model.create_cache(1, max_seq=bucket)
            self._row_caches[bucket] = row
        return row

    def _prefill_row(self, tokens: Sequence[int], bucket: int):
        ids, _ = pad_prompt(tokens, bucket, self.config.pad_id,
                            device=self.device)
        row = self._row_cache(bucket)
        self.model.prefill(ids, row)
        return row

    def _admit(self, now: float) -> int:
        n = 0
        while (self._queue and not self._stopped
               and self._queue[0].t_arrival <= now
               and self._can_admit_head()):
            req = self._queue.popleft()
            if self.paged:
                admitted = self._admit_paged(req, now)
                if admitted is None:
                    continue              # retired at admission
                slot, bucket, tokens = admitted
            else:
                tokens = req.prompt
                bucket = pick_bucket(req.prompt_len, self.buckets)
                assert bucket is not None  # submit() validated
                row = self._prefill_row(tokens, bucket)
                slot = self.slots.insert_prefill(row, req.prompt_len,
                                                 self._request_key(req))
            self._tokens[slot] = tokens[-1]
            req.state = RequestState.RUNNING
            req.slot = slot
            req.bucket = bucket
            req.t_admitted = now
            self._by_slot[slot] = req
            n += 1
        return n

    def _admit_paged(self, req: Request, now: float):
        """Paged admission: radix prefix match, suffix-only prefill on a
        hit when the model has one, paged insert.  Returns (slot, bucket,
        tokens), or None when the request was retired at admission."""
        tokens = req.resume_tokens or req.prompt
        s = len(tokens)
        shared = self.slots.match_prefix(tokens)
        c = len(shared) * self.config.page_size
        row = None
        if c > 0 and self._prefill_suffix is not None:
            # Prefix hit with a prefix-aware model: prefill ONLY the
            # private suffix; the shared pages are already in the pool.
            bucket = pick_bucket(s - c, self.buckets)
            if bucket is not None:
                ids, _ = pad_prompt(tokens[c:], bucket, self.config.pad_id,
                                    device=self.device)
                row = self._row_cache(bucket)
                self._prefill_suffix(ids, c, row)
                row_start = c
        if row is None:
            bucket = pick_bucket(s, self.buckets)
            if bucket is None:
                # No full-prompt bucket.  (The matched chain was never
                # acquired: nothing to undo.)
                req.t_finish = now
                self.finished.append(req)
                if (req.resume_tokens is None and req.resume_key is None
                        and not req.generated):
                    # Admitted on the strength of a cached prefix that
                    # was evicted before it reached a slot: shed it.
                    req.state = RequestState.REJECTED
                    req.reject_reason = RejectReason.KV_PRESSURE
                else:
                    # Resume: prompt + generated outgrew every bucket;
                    # deliver what it has.
                    req.state = RequestState.FINISHED
                    req.finish_reason = FinishReason.KV_CAPACITY
                return None
            row = self._prefill_row(tokens, bucket)
            row_start = 0
        slot = self.slots.insert_prefill(row, tokens, s,
                                         self._request_key(req), shared,
                                         row_start=row_start)
        return slot, bucket, tokens

    def _block_size(self) -> int:
        """Steps for this dispatch: the configured block, unless some
        active row is within a block of its KV horizon (its offset may
        not cross max_seq); then single steps until it retires."""
        k = self.config.steps_per_sync
        if self._block_fn is None:
            return 1
        for req in self._by_slot.values():
            # offset = prompt_len - 1 + generated; K steps write offsets
            # up to offset + K - 1 <= max_seq - 1.
            if self.max_seq - req.prompt_len - len(req.generated) + 1 < k:
                return 1
        return k

    def _prepare_pages(self, k: int) -> None:
        """Paged mode, before a dispatch: every active slot gets pages
        for the ``k`` positions this dispatch writes.  The pool evicts
        unreferenced prefix pages on demand; if it is STILL dry, preempt
        the most recently admitted request (it resumes later, exactly).
        Admission feasibility guarantees a sole remaining request can
        always grow to its horizon."""
        while True:
            ok = True
            for slot, req in list(self._by_slot.items()):
                # Cap at the request's own horizon (what feasible()
                # budgeted): a block may over-generate up to k-1
                # positions past max_new, and those writes, whose tokens
                # retire() discards, fall through NULL table entries
                # into the trash page.
                need = min(req.prompt_len + len(req.generated) + k - 1,
                           req.prompt_len + req.max_new_tokens - 1,
                           self.max_seq)
                if not self.slots.ensure(slot, need):
                    ok = False
                    break
            if ok:
                return
            assert len(self._by_slot) > 1, (
                "page pool cannot hold a sole feasible request: allocator "
                "invariant broken")
            victim = max(self._by_slot,
                         key=lambda sl: (self._by_slot[sl].t_admitted,
                                         self._by_slot[sl].request_id))
            self._preempt(victim)

    def _preempt(self, slot: int) -> None:
        req = self._by_slot.pop(slot)
        # The slot's key is the sample-chain state: snapshot it so the
        # resumed stream continues exactly.
        req.resume_key = self.slots.snapshot_key(slot)
        req.resume_tokens = list(req.prompt) + list(req.generated)
        req.preemptions += 1
        req.state = RequestState.QUEUED
        req.slot = None
        self.slots.release(slot)
        self._tokens[slot] = self.config.pad_id
        self._queue.appendleft(req)

    def _decode_step(self) -> int:
        k = self._block_size()
        if self.paged:
            self._prepare_pages(k)
            self.slots.flush()
        fn = self._block_fn if k > 1 else self._step
        toks = fn(torch.from_numpy(self._tokens).to(self.device),
                  self.slots.cache, self.slots.keys,
                  self.slots.active_mask())
        toks_host = toks.cpu().numpy()          # THE host sync
        if k == 1:
            toks_host = toks_host[:, None]
        return self._commit_tokens(list(self._by_slot.items()), toks_host,
                                   self.clock())

    def _commit_tokens(self, rows, toks_host, now) -> int:
        """Append one dispatch's tokens to their requests: stream via
        ``on_token``, check EOS / budget / KV horizon, retire.  Tokens
        decoded past a retirement reason are discarded (bounded
        over-generation in block mode)."""
        retired = 0
        for slot, req in rows:
            done = False
            for token in toks_host[slot]:
                token = int(token)
                req.generated.append(token)
                if req.t_first_token is None:
                    req.t_first_token = now
                req.t_last_token = now
                if req.on_token is not None:
                    req.on_token(req, token)
                reason = None
                if token in req.eos_token_ids:
                    reason = FinishReason.EOS
                elif len(req.generated) >= req.max_new_tokens:
                    reason = FinishReason.LENGTH
                elif req.prompt_len + len(req.generated) > self.max_seq:
                    # the NEXT step would write KV past max_seq-1
                    reason = FinishReason.KV_CAPACITY
                if reason is not None:
                    self._retire(slot, now, reason)
                    retired += 1
                    done = True
                    break
            if not done:
                self._tokens[slot] = int(toks_host[slot, -1])
        return retired

    def _retire(self, slot: int, now: float,
                reason: FinishReason) -> None:
        req = self._by_slot.pop(slot)
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.t_finish = now
        self.slots.release(slot)
        self._tokens[slot] = self.config.pad_id
        self.finished.append(req)
