"""Seeded scheduler configurations through the JAX package's scheduler and
the port's, on the CPU toy model: equal greedy tokens and finish reasons,
with the float and the int8 KV cache.

Each case draws, from its own seed, a layout (slots or paged), slot count,
page size, decode capacity, prefill buckets, pool size (tight pools
preempt), prefix cache on or off, decode steps per host sync and a batch
of requests (some sharing a system prefix, staggered arrivals).  Case 0 is
the minimal case of a paged suffix prefill whose bucket runs past the
model's position table (41- and 57-token prompts sharing 40 tokens,
buckets (16, 32, 64), pages of 8), where the port once indexed past its
table.  The fixed cases of tests/test_torch_serving.py and
tests/test_torch_int8.py stay; these widen the configurations they reach.
"""

import jax
import numpy as np
import pytest

from triton_distributed_tpu.serving import (
    ContinuousBatchingScheduler as JaxScheduler)
from triton_distributed_tpu.serving import Request as JaxRequest
from triton_distributed_tpu.serving import SchedulerConfig as JaxSchedConfig
from triton_distributed_tpu.serving import ToyConfig as JaxToyConfig
from triton_distributed_tpu.serving import ToyModel as JaxToyModel
from triton_distributed_tpu_torch.serving import (
    ContinuousBatchingScheduler, Request, SchedulerConfig, ToyConfig,
    ToyModel)

TOY = dict(vocab_size=61, hidden=16, max_seq_len=64)
CASES = 20


@pytest.fixture(autouse=True)
def jax_observability_off(monkeypatch):
    """The port's scheduler is the JAX one as it runs with observability
    disabled, so the JAX side runs that way too."""
    monkeypatch.setenv("TDT_OBSERVABILITY", "0")


@pytest.fixture(autouse=True, scope="module")
def _fresh_observability_state():
    """Leave the JAX package's process-global flight ring, tracer,
    lineage and decision rings empty for the test files that run after
    this one in the same worker (as tests/test_torch_serving.py does)."""
    from triton_distributed_tpu.observability import feedback, get_tracer
    from triton_distributed_tpu.observability.lineage import (
        get_lineage_recorder)
    from triton_distributed_tpu.observability.recorder import (
        get_flight_recorder)
    yield
    feedback.clear_recent_decisions()
    get_lineage_recorder().clear()
    get_flight_recorder().clear()
    get_tracer().clear()


class Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module", params=["float", "int8"])
def toys(request):
    """(JAX toy, its params, the port's toy with the same params)."""
    cfg = dict(TOY, quantize_kv_cache=request.param == "int8")
    jm = JaxToyModel(JaxToyConfig(**cfg))
    params = jm.init_params(jax.random.key(0))
    tm = ToyModel(ToyConfig(**cfg), device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jm, params, tm


def past_position_table_case():
    rng = np.random.default_rng(11)
    prefix = [int(t) for t in rng.integers(1, 61, 40)]
    prompts = [prefix + [int(t) for t in rng.integers(1, 61, extra)]
               for extra in (1, 17)]
    kw = dict(kv_layout="paged", num_slots=2, max_seq=64,
              prefill_buckets=(16, 32, 64), page_size=8)
    return kw, [(p, 2, 0.01 * i) for i, p in enumerate(prompts)]


def drawn_case(seed):
    """A scheduler configuration and its requests (prompt, max_new_tokens,
    arrival time), all feasible: every prompt fits a bucket and every
    request's prompt plus new tokens fits the capacity and the pool."""
    rng = np.random.default_rng(1000 + seed)
    max_seq = int(rng.choice([32, 64]))
    page_size = int(rng.choice([4, 8, 16]))
    buckets = tuple(sorted({int(b) for b in rng.choice(
        [8, 16, 32, 64], size=int(rng.integers(1, 4)), replace=False)}
        | {max_seq}))
    kw = dict(kv_layout=str(rng.choice(["slots", "paged"])),
              num_slots=int(rng.integers(1, 5)), max_seq=max_seq,
              prefill_buckets=buckets, page_size=page_size,
              steps_per_sync=int(rng.choice([1, 1, 2])))
    sysp = [int(t) for t in rng.integers(1, 61, int(rng.integers(4, 25)))]
    reqs = []
    for i in range(int(rng.integers(2, 8))):
        new = int(rng.integers(1, 9))
        room = max_seq - new
        if rng.random() < 0.4 and len(sysp) + 1 <= room:
            prompt = sysp + [int(t) for t in rng.integers(
                1, 61, int(rng.integers(1, room - len(sysp) + 1)))]
        else:
            prompt = [int(t) for t in rng.integers(
                1, 61, int(rng.integers(1, room + 1)))]
        reqs.append((prompt, new, float(rng.choice([0.0, 0.001 * i,
                                                    rng.random() * 0.01]))))
    if kw["kv_layout"] == "paged":
        kw["prefix_cache"] = bool(rng.random() < 0.8)
        if rng.random() < 0.5:
            horizon = max(-(-(len(p) + n) // page_size) for p, n, _ in reqs)
            kw["num_pages"] = horizon + int(rng.integers(0, horizon + 1))
    return kw, reqs


def run(sched, reqs, request_cls):
    done = sched.run([request_cls(prompt=p, max_new_tokens=n,
                                  arrival_time=t) for p, n, t in reqs])
    return [(r.generated, r.finish_reason.value)
            for r in sorted(done, key=lambda r: r.request_id)]


@pytest.mark.parametrize("case", range(CASES))
def test_scheduler_configs_match_jax(toys, case):
    jm, params, tm = toys
    kw, reqs = past_position_table_case() if case == 0 else drawn_case(case)
    ck = Clock()
    want = run(JaxScheduler(jm, params, JaxSchedConfig(**kw), clock=ck.now,
                            clock_advance=ck.advance), reqs, JaxRequest)
    ck = Clock()
    got = run(ContinuousBatchingScheduler(
        tm, SchedulerConfig(**kw), clock=ck.now, clock_advance=ck.advance),
        reqs, Request)
    assert len(want) == len(reqs)
    assert got == want, kw
