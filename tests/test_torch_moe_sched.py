"""The MoE model in the port's scheduler against the JAX package's, on the
CPU: `ModelConfig.tiny_moe` with 8 experts, 2 a token, in f32, through
`ContinuousBatchingScheduler` with dense slots, with pages and prefix
hits, and with 9 pages that force a preemption.  Greedy tokens must be
equal for every request.

The JAX Qwen3 runs as tests/test_torch_serving.py runs it (1-device mesh,
``interpret=True``); the port runs its kernels' plain versions on CPU
tensors.  Routing is bit-equal between the two (tests/test_torch_moe.py),
so any difference in tokens is a fault, not rounding.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_distributed_tpu.serving import (
    ContinuousBatchingScheduler as JaxScheduler)
from triton_distributed_tpu.serving import Request as JaxRequest
from triton_distributed_tpu.serving import SchedulerConfig as JaxSchedConfig
from triton_distributed_tpu_torch import (
    ContinuousBatchingScheduler, ModelConfig, Qwen3, Request,
    SchedulerConfig)

MOE = dict(dtype="float32", num_experts=8, num_experts_per_tok=2)


@pytest.fixture(autouse=True)
def jax_observability_off(monkeypatch):
    """The port's scheduler is the JAX one as it runs with observability
    disabled, so the JAX side runs that way too."""
    monkeypatch.setenv("TDT_OBSERVABILITY", "0")


@pytest.fixture(autouse=True, scope="module")
def _fresh_observability_state():
    """Leave the JAX package's process-global rings empty for the test
    files that run after this one in the same worker (as
    tests/test_torch_serving.py does)."""
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


@pytest.fixture(scope="module")
def moe():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jm = JaxQwen3(JaxConfig.tiny_moe(**MOE), mesh, mode="fused",
                  interpret=True)
    params = jm.init_params(jax.random.key(0))
    tm = Qwen3(ModelConfig.tiny_moe(**MOE), device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jm, params, tm


def _tokens(done):
    return [r.generated for r in sorted(done, key=lambda r: r.request_id)]


@pytest.mark.parametrize("layout,num_pages", [
    ("slots", None),      # dense cache
    ("paged", None),      # page pool + prefix hits
    ("paged", 9),         # 9 pages of 8 for 3 slots: a preemption
])
def test_moe_scheduler_greedy_matches_jax(moe, layout, num_pages):
    jm, params, tm = moe
    rng = np.random.default_rng(3)
    prefix = [int(t) for t in rng.integers(1, 256, 16)]
    prompts = ([prefix + [int(t) for t in rng.integers(1, 256, n)]
                for n in (3, 9, 17)] + [[int(t) for t in
                                         rng.integers(1, 256, 5)]])
    gens = [12, 17, 9, 12]
    kw = dict(num_slots=3, max_seq=64, prefill_buckets=(16, 32, 64),
              page_size=8, num_pages=num_pages, kv_layout=layout)

    def reqs(cls):
        return [cls(prompt=p, max_new_tokens=g)
                for p, g in zip(prompts, gens)]

    ck = Clock()
    want = _tokens(JaxScheduler(jm, params, JaxSchedConfig(**kw),
                                clock=ck.now, clock_advance=ck.advance)
                   .run(reqs(JaxRequest)))
    ck = Clock()
    sched = ContinuousBatchingScheduler(tm, SchedulerConfig(**kw),
                                        clock=ck.now,
                                        clock_advance=ck.advance)
    got = _tokens(sched.run(reqs(Request)))
    assert got == want
    assert [len(g) for g in got] == gens
    if layout == "paged":
        assert sched.slots.radix.hit_tokens >= 2 * 16
    if num_pages:
        assert sum(r.preemptions for r in sched.finished) >= 1
