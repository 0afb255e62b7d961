"""Serving requests: the unit the continuous-batching scheduler moves
through queue -> slot -> retirement.

A copy of `triton_distributed_tpu/serving/request.py` (pure Python; the
port keeps its own so that it never imports the JAX package).  A
`Request` carries the immutable submission (prompt, generation budget,
EOS set, seed, streaming callback) plus the mutable lifecycle the
scheduler writes: state, slot, timestamps (arrival / admission / first
token / finish) and the generated tokens.  Timestamps come from the
scheduler's injectable clock, so tests replay deterministic arrival
schedules.  Fields of later slices (speculative decoding, the cluster's
lineage and shipped prefills, per-tenant costs) are carried, and the
port's scheduler refuses the ones it cannot serve yet.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Callable, List, Optional, Sequence, Tuple

_next_id = itertools.count()


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"


class FinishReason(enum.Enum):
    EOS = "eos"                  # sampled a token in `eos_token_ids`
    LENGTH = "length"            # hit `max_new_tokens`
    KV_CAPACITY = "kv_capacity"  # slot ran into the cache's max_seq
    STOPPED = "stopped"          # scheduler.stop() aborted it


class RejectReason(enum.Enum):
    QUEUE_FULL = "queue_full"
    PROMPT_TOO_LONG = "prompt_too_long"      # exceeds largest bucket
    EXCEEDS_KV_CAPACITY = "exceeds_kv_capacity"  # prompt+gen > max_seq
    STOPPED = "stopped"          # submitted after scheduler.stop()
    #: Load shed under KV pressure: the request was only admittable
    #: through a cached prompt prefix (suffix-only prefill), and that
    #: prefix was evicted — not just spilled — before admission.  The
    #: truthful degradation reason: with a `SpillPool` the prefix
    #: would have been restored and the request served.
    KV_PRESSURE = "kv_pressure_shed"


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int
    eos_token_ids: Tuple[int, ...] = ()
    #: Per-request RNG seed (the slot's sampling key starts from it) so a
    #: request samples the same tokens whichever slot or batch
    #: composition it lands in.
    seed: int = 0
    #: Scheduler-clock time the request becomes eligible for
    #: admission; None = eligible at submit time.
    arrival_time: Optional[float] = None
    #: Streaming hook, called as ``on_token(request, token)`` from the
    #: scheduler loop right after each token is decoded to host.
    on_token: Optional[Callable[["Request", int], None]] = None
    #: Cost-attribution / QoS label: which tenant this request is billed
    #: to.  Carried, not charged: cost accounting comes with the
    #: observability slice.
    tenant: str = "default"
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_next_id))

    # -- lifecycle (scheduler-owned) -----------------------------------
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[FinishReason] = None
    reject_reason: Optional[RejectReason] = None
    #: Prefill length bucket the prompt was padded to at admission.
    bucket: Optional[int] = None
    #: Preemption state (paged engine only): when the page pool runs
    #: dry mid-stream the scheduler may evict this request and requeue
    #: it.  ``resume_tokens`` = prompt + tokens generated so far (the
    #: re-prefill recomputes their KV), ``resume_key`` = the slot's
    #: sampling key at eviction, so the resumed stream continues the
    #: exact same sample chain.
    resume_tokens: Optional[List[int]] = None
    resume_key: Optional[object] = None
    preemptions: int = 0
    #: Speculative-decoding outcome (``SchedulerConfig.spec_k``, a later
    #: slice): draft tokens proposed / accepted; 0 without speculation.
    spec_proposed: int = 0
    spec_accepted: int = 0
    #: Request-lineage join key of the observability slice (carried).
    lineage_id: Optional[object] = None
    #: Disaggregated-prefill hook of the cluster slice: a prefilled-KV
    #: shipment to insert instead of a local prefill.  The port's
    #: scheduler refuses a request that carries one.
    shipped_kv: Optional[object] = None

    # -- SLO timestamps (scheduler clock, seconds) ---------------------
    t_arrival: Optional[float] = None
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    t_finish: Optional[float] = None

    def __post_init__(self):
        self.prompt = list(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        self.eos_token_ids = tuple(int(t) for t in self.eos_token_ids)

    # -- derived SLO metrics (None until the event happened) -----------

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def queue_wait(self) -> Optional[float]:
        if self.t_admitted is None or self.t_arrival is None:
            return None
        return self.t_admitted - self.t_arrival

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, measured from arrival (includes queue
        wait — the user-visible number)."""
        if self.t_first_token is None or self.t_arrival is None:
            return None
        return self.t_first_token - self.t_arrival

    @property
    def latency(self) -> Optional[float]:
        if self.t_finish is None or self.t_arrival is None:
            return None
        return self.t_finish - self.t_arrival

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED,
                              RequestState.REJECTED)

    def to_dict(self) -> dict:
        """JSON-friendly summary (flight-recorder / bench reporting).
        ``tenant`` rides along only when set to something non-default,
        so untenanted summaries stay byte-identical."""
        out = {
            "request_id": self.request_id,
            "state": self.state.value,
            "prompt_len": self.prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "generated": len(self.generated),
            "slot": self.slot,
            "bucket": self.bucket,
            "finish_reason": (self.finish_reason.value
                              if self.finish_reason else None),
            "reject_reason": (self.reject_reason.value
                              if self.reject_reason else None),
            "queue_wait_s": self.queue_wait,
            "ttft_s": self.ttft,
            "latency_s": self.latency,
            "preemptions": self.preemptions,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
        }
        if self.tenant != "default":
            out["tenant"] = self.tenant
        return out
