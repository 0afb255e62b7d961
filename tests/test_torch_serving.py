"""The port's serving stack against the JAX package on the CPU, and the
JAX package's serving invariants held within the port.

Against JAX (same weights, same requests, greedy): the page bookkeeping
(`PagedKVCache`, `PagePool`, `RadixCache`/`PagedKV`) step for step, and
the scheduler's tokens over `ToyModel` and over `Qwen3` tiny in f32.
The JAX Qwen3 runs as `tests/test_torch_model.py` runs it (1-device mesh,
``interpret=True``), so its paged decode goes through the Pallas
`flash_decode_paged` in interpret mode and the port's through the plain
version of its kernel.

Within the port (toy model, mirroring tests/test_serving.py and
tests/test_serving_paged.py): slots == paged, block == single step,
masked rows emit pad, sampled streams independent of batch composition,
exact preempt-resume, prefix pages shared not copied, LRU eviction,
infeasible requests rejected, spill restores bit-exactly, and a released
slot never disturbs the rows that keep decoding.  Sampled streams cannot
match JAX's threefry draws, so they are only held to these invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models.kv_cache import (
    PagedKVCache as JaxPagedKVCache)
from triton_distributed_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_distributed_tpu.serving import (
    ContinuousBatchingScheduler as JaxScheduler)
from triton_distributed_tpu.serving import PagedKV as JaxPagedKV
from triton_distributed_tpu.serving import PagePool as JaxPagePool
from triton_distributed_tpu.serving import Request as JaxRequest
from triton_distributed_tpu.serving import SchedulerConfig as JaxSchedConfig
from triton_distributed_tpu.serving import ToyConfig as JaxToyConfig
from triton_distributed_tpu.serving import ToyModel as JaxToyModel
from triton_distributed_tpu.serving import pad_prompt as jax_pad_prompt
from triton_distributed_tpu.serving import pick_bucket as jax_pick_bucket
from triton_distributed_tpu.serving import request_key as jax_request_key
from triton_distributed_tpu_torch import ModelConfig, Qwen3
from triton_distributed_tpu_torch.models.kv_cache import (
    NULL_PAGE, PagedKVCache, pages_for)
from triton_distributed_tpu_torch.serving import (
    ContinuousBatchingScheduler, FinishReason, PagedKV, PagePool,
    RejectReason, Request, SchedulerConfig, ToyConfig, ToyModel,
    masked_sample, pad_prompt, pick_bucket, request_key)

TOY = dict(vocab_size=61, hidden=16, max_seq_len=64)


@pytest.fixture(autouse=True)
def jax_observability_off(monkeypatch):
    """The port's scheduler is the JAX one as it runs with observability
    disabled, so the JAX side runs that way too."""
    monkeypatch.setenv("TDT_OBSERVABILITY", "0")


@pytest.fixture(autouse=True, scope="module")
def _fresh_observability_state():
    """Leave the JAX package's process-global flight ring, tracer,
    lineage and decision rings empty for the test files that run after
    this one in the same worker (the idiom of tests/test_cluster.py and
    tests/test_serving_spec.py): test_tracing.py and
    test_observability.py assert on them."""
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
def toy():
    """(JAX toy, its params, the port's toy with the same params)."""
    jm = JaxToyModel(JaxToyConfig(**TOY))
    params = jm.init_params(jax.random.key(0))
    tm = ToyModel(ToyConfig(**TOY), device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jm, params, tm


def rand_prompts(n, vocab=61, seed=0, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, rng.integers(lo, hi))]
            for _ in range(n)]


def port_sched(model, layout="slots", **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("prefill_buckets", (8, 16, 32, 64))
    ck = Clock()
    return ContinuousBatchingScheduler(
        model, SchedulerConfig(kv_layout=layout, **kw), clock=ck.now,
        clock_advance=ck.advance)


def jax_sched(model, params, layout="slots", **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("prefill_buckets", (8, 16, 32, 64))
    ck = Clock()
    return JaxScheduler(model, params,
                        JaxSchedConfig(kv_layout=layout, **kw),
                        clock=ck.now, clock_advance=ck.advance)


def tokens_of(done):
    return [r.generated for r in sorted(done, key=lambda r: r.request_id)]


def run_port(model, layout, reqs, **kw):
    sched = port_sched(model, layout, **kw)
    return sched, tokens_of(sched.run(reqs))


def shared_prefix_reqs(cls, n=4, sys_len=24, max_new=3, seed=21):
    rng = np.random.default_rng(seed)
    sysp = [int(t) for t in rng.integers(1, 61, sys_len)]
    return [cls(prompt=sysp + [1 + i, 2 + i], max_new_tokens=max_new,
                arrival_time=0.002 * i) for i in range(n)]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_bucketing_matches_jax():
    for n in (1, 8, 9, 64, 65):
        assert (pick_bucket(n, (8, 16, 32, 64))
                == jax_pick_bucket(n, (8, 16, 32, 64)))
    ids, s = pad_prompt([5, 6, 7], 8, pad_id=2)
    ids_j, s_j = jax_pad_prompt([5, 6, 7], 8, pad_id=2)
    assert s == s_j and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    with pytest.raises(ValueError):
        pad_prompt([1] * 9, 8)


def test_paged_cache_matches_jax():
    """Same pools and table: same bytes per page and logical views."""
    jc = JaxPagedKVCache.create(num_layers=2, num_pages=9, batch=3,
                                num_kv_heads=2, page_size=8, head_dim=16,
                                max_pages_per_seq=4, dtype=jnp.float32)
    tc = PagedKVCache.create(2, 9, 3, 2, 8, 16, 4, torch.float32,
                             device="cpu")
    assert tc.bytes_per_page() == jc.bytes_per_page()
    assert (tc.num_pages, tc.pages_per_seq, tc.max_seq, tc.batch) == (
        jc.num_pages, jc.pages_per_seq, jc.max_seq, jc.batch)
    rng = np.random.default_rng(4)
    pools = [rng.standard_normal((9, 2, 8, 16), dtype=np.float32)
             for _ in range(4)]
    table = rng.permutation(np.arange(1, 9))[:6].reshape(3, 2)
    table = np.concatenate([table, np.zeros((3, 2), int)], 1).astype(
        np.int32)
    jc = JaxPagedKVCache(ks=[jnp.asarray(p) for p in pools[:2]],
                         vs=[jnp.asarray(p) for p in pools[2:]],
                         page_table=jc.page_table, offset=jc.offset,
                         page_size=8).with_page_table(table.copy())
    for i in range(2):
        tc.ks[i].copy_(torch.from_numpy(pools[i]))
        tc.vs[i].copy_(torch.from_numpy(pools[2 + i]))
    tc.with_page_table(table)
    table[:] = 0                  # the device copy is independent of it
    for layer in range(2):
        for a, b in zip(tc.gather_logical(layer), jc.gather_logical(layer)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tc.set_offset(5)
    tc.inc_offset(2)
    tc.reset_slot(1)
    assert tc.offset.tolist() == [7, 0, 7]
    assert pages_for(0, 8) == 0 and pages_for(17, 8) == 3
    with pytest.raises(ValueError):
        PagedKVCache.create(1, 1, 1, 1, 8, 16, 1, device="cpu")


def test_page_pool_matches_jax():
    pools = (PagePool(7), JaxPagePool(7))
    for p in pools:
        a = p.alloc(3)
        assert p.alloc(4) is None
        p.incref(a[:1])
        p.decref(a)
        b = p.alloc(2)
        p.decref(b[1:])
    assert pools[0]._free == pools[1]._free
    np.testing.assert_array_equal(pools[0].refs, pools[1].refs)
    assert pools[0].used_pages == pools[1].used_pages == 2


def test_pagedkv_bookkeeping_matches_jax(toy):
    """The same insert/ensure/release/evict sequence on the JAX and the
    port's PagedKV gives identical host tables, refcounts, free lists,
    radix counters and logical K/V views."""
    jm, params, tm = toy
    jprefill = jax.jit(jm.make_prefill_fn())
    kvs = (JaxPagedKV(jm, 3, max_seq=64, page_size=8, num_pages=14),
           PagedKV(tm, 3, max_seq=64, page_size=8, num_pages=14))
    assert kvs[0].bytes_per_page == kvs[1].bytes_per_page
    rng = np.random.default_rng(7)
    sysp = [int(t) for t in rng.integers(1, 61, 17)]
    prompts = [sysp + [3, 4], sysp + [5] * 9, list(range(1, 30)),
               sysp[:8] + [9] * 20]
    slots = [[], []]

    def admit(i, tokens):
        bucket = pick_bucket(len(tokens), (8, 16, 32, 64))
        kv = kvs[i]
        shared = kv.match_prefix(tokens)
        assert kv.can_admit(tokens)
        if i == 0:
            ids, s = jax_pad_prompt(tokens, bucket)
            _, row = jprefill(params, ids, jm.create_cache(1, bucket))
            key = jax_request_key(0)
        else:
            ids, s = pad_prompt(tokens, bucket)
            row = tm.create_cache(1, bucket)
            tm.prefill(ids, row)
            key = request_key(0)
        slots[i].append(kv.insert_prefill(row, tokens, s, key, shared))

    def same():
        a, b = kvs
        assert slots[0] == slots[1]
        np.testing.assert_array_equal(a._table, b._table)
        np.testing.assert_array_equal(a.pool.refs, b.pool.refs)
        assert a.pool._free == b.pool._free
        assert a._free == b._free
        np.testing.assert_array_equal(a._active, b._active)
        for attr in ("cached_pages", "hit_tokens", "miss_tokens",
                     "evicted_pages", "_idle_pages"):
            assert getattr(a.radix, attr) == getattr(b.radix, attr), attr
        a.flush()
        b.flush()
        np.testing.assert_array_equal(np.asarray(a.cache.offset),
                                      b.cache.offset.numpy())
        # page 0 is trash (the JAX insert dumps discarded pages there,
        # the port skips them): compare the mapped positions
        mapped = np.repeat(a._table != NULL_PAGE, 8, axis=1)
        for x, y in zip(a.cache.gather_logical(0),
                        b.cache.gather_logical(0)):
            np.testing.assert_allclose(y.numpy()[:, 0][mapped],
                                       np.asarray(x)[:, 0][mapped],
                                       atol=1e-6, rtol=1e-6)

    for i in range(2):
        admit(i, prompts[0])
        admit(i, prompts[1])                       # hits the 2-page chain
    same()
    for kv, sl in zip(kvs, slots):
        assert kv.ensure(sl[1], 40)                # grows by private pages
        kv.release(sl[0])
    same()
    for i in range(2):
        admit(i, prompts[2])
        admit(i, prompts[3])                       # hits 1 page
        kvs[i].release(slots[i][1])
    same()
    freed = [kv.radix.evict(3) for kv in kvs]     # LRU leaves first
    assert freed[0] == freed[1] == 2               # all that is idle
    assert [kv.ensure(sl[2], 64) for kv, sl in zip(kvs, slots)] == [True,
                                                                    True]
    same()


def test_toy_scheduler_greedy_matches_jax(toy):
    """The toy through both schedulers: same greedy tokens in both
    layouts, with mid-flight arrivals and prefix hits."""
    jm, params, tm = toy
    prompts = rand_prompts(7, seed=1)
    gens = [3, 7, 4, 6, 2, 5, 8]

    def reqs(cls):
        out = [cls(prompt=p, max_new_tokens=g, arrival_time=0.001 * i)
               for i, (p, g) in enumerate(zip(prompts, gens))]
        return out + shared_prefix_reqs(cls)

    for layout in ("slots", "paged"):
        want = tokens_of(jax_sched(jm, params, layout).run(
            reqs(JaxRequest)))
        sched, got = run_port(tm, layout, reqs(Request))
        assert got == want, layout
    assert sched.slots.radix.hit_tokens == 3 * 16


@pytest.fixture(scope="module")
def qwen():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jm = JaxQwen3(JaxConfig.tiny(dtype="float32"), mesh, mode="fused",
                  interpret=True)
    params = jm.init_params(jax.random.key(0))
    tm = Qwen3(ModelConfig.tiny(dtype="float32"),
               device="cpu").load_jax_params(jax.tree.map(np.asarray,
                                                          params))
    return jm, params, tm


@pytest.mark.parametrize("layout,num_pages", [
    ("slots", None),      # dense cache: flash_decode
    ("paged", None),      # page pool + prefix hits: flash_decode_paged
    ("paged", 7),         # a pool tight enough to preempt
])
def test_qwen3_scheduler_greedy_matches_jax(qwen, layout, num_pages):
    """Qwen3 tiny, f32: the port's scheduler gives the JAX scheduler's
    greedy tokens for every request.  Three prompts share a 16-token
    prefix (two pages of 8)."""
    jm, params, tm = qwen
    rng = np.random.default_rng(3)
    prefix = [int(t) for t in rng.integers(1, 256, 16)]
    prompts = ([prefix + [int(t) for t in rng.integers(1, 256, n)]
                for n in (3, 9, 17)] + [[int(t) for t in
                                         rng.integers(1, 256, 5)]])
    gens = [6, 9, 5, 8]
    kw = dict(num_slots=2, max_seq=64, prefill_buckets=(16, 32, 64),
              page_size=8, num_pages=num_pages)

    def reqs(cls):
        return [cls(prompt=p, max_new_tokens=g)
                for p, g in zip(prompts, gens)]

    want = tokens_of(jax_sched(jm, params, layout, **kw).run(
        reqs(JaxRequest)))
    sched, got = run_port(tm, layout, reqs(Request), **kw)
    assert got == want
    assert [len(g) for g in got] == gens
    if layout == "paged":
        assert sched.slots.radix.hit_tokens >= 2 * 16
    if num_pages:
        assert any(r.preemptions for r in sched.finished)


# ---------------------------------------------------------------------------
# the JAX package's serving invariants, within the port (toy model)
# ---------------------------------------------------------------------------


def test_masked_sample_pad_and_keys():
    """Masked rows yield the pad id, never a sample of stale logits;
    active rows sample with their own key, and a key repeats its draw."""
    b, v, pad = 6, 16, 13
    logits = torch.zeros(b, v)
    logits[:, 1] = 100.0
    keys = np.stack([request_key(i) for i in range(b)])
    active = np.array([i % 2 == 0 for i in range(b)])
    for temperature in (0.0, 1.0, 5.0):
        out = masked_sample(logits, keys, active, pad,
                            temperature=temperature)
        assert out.dtype == torch.int32
        assert (out[1::2] == pad).all() and (out[::2] == 1).all()
    assert (keys[:, 1] == 0).all()          # sampling does not advance
    flat = torch.zeros(b, v)
    draws = [masked_sample(flat, keys, active, pad, temperature=1.0)
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    keys[:, 1] += 1
    assert not torch.equal(
        masked_sample(flat, keys, active, pad, temperature=1.0), draws[0])


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_slots_match_paged(toy, temperature):
    _, _, tm = toy
    prompts = rand_prompts(6, seed=5)

    def reqs():
        return [Request(prompt=p, max_new_tokens=3 + i, seed=100 + i,
                        arrival_time=0.001 * i)
                for i, p in enumerate(prompts)]

    _, a = run_port(tm, "slots", reqs(), temperature=temperature)
    _, b = run_port(tm, "paged", reqs(), temperature=temperature)
    _, c = run_port(tm, "paged", reqs(), temperature=temperature,
                    page_size=8)
    assert a == b == c


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_block_mode_matches_single_step(toy, layout):
    _, _, tm = toy
    prompts = rand_prompts(5, seed=2)

    def reqs():
        return [Request(prompt=p, max_new_tokens=6, seed=i,
                        arrival_time=i * 0.01)
                for i, p in enumerate(prompts)]

    outs = [run_port(tm, layout, reqs(), num_slots=2, steps_per_sync=k,
                     temperature=1.0)[1] for k in (1, 4)]
    assert outs[0] == outs[1]


def test_block_mode_eos_discards_overshoot(toy):
    _, _, tm = toy
    prompt = rand_prompts(1, seed=8)[0]
    first = run_port(tm, "slots", [Request(prompt=prompt,
                                           max_new_tokens=1)])[1][0][0]
    req = Request(prompt=prompt, max_new_tokens=10, eos_token_ids=(first,))
    port_sched(tm, steps_per_sync=4).run([req])
    assert req.finish_reason == FinishReason.EOS
    assert req.generated == [first]


def test_sampled_stream_independent_of_batch_composition(toy):
    """A request's sampled stream depends on (prompt, seed) only: alone,
    or in any slot beside others, on either layout."""
    _, _, tm = toy
    prompts = rand_prompts(6, seed=5)
    target = Request(prompt=prompts[0], max_new_tokens=8, seed=42)
    _, alone = run_port(tm, "slots", [target], temperature=1.0)
    for layout in ("slots", "paged"):
        reqs = [Request(prompt=p, max_new_tokens=3 + i, seed=i)
                for i, p in enumerate(prompts[1:])]
        target = Request(prompt=prompts[0], max_new_tokens=8, seed=42,
                         arrival_time=0.003)
        run_port(tm, layout, reqs[:2] + [target] + reqs[2:],
                 temperature=1.0)
        assert target.generated == alone[0]


def test_preempt_resume_token_exact_sampled(toy):
    """6 usable pages cannot hold three 39-position horizons: the newest
    request is preempted and resumes with its key chain, token-exact."""
    _, _, tm = toy

    def reqs():
        return [Request(prompt=[1 + i] * 10, max_new_tokens=30, seed=i)
                for i in range(3)]

    sched, got = run_port(tm, "paged", reqs(), num_pages=6,
                          temperature=1.0)
    _, want = run_port(tm, "slots", reqs(), temperature=1.0)
    assert got == want
    assert any(r.preemptions for r in sched.finished)


def test_prefix_sharing_shares_pages_not_copies(toy):
    """Concurrent same-prefix requests map the SAME physical page."""
    _, _, tm = toy
    sched = port_sched(tm, "paged", num_slots=4)
    sysp = [int(t) for t in np.random.default_rng(3).integers(1, 61, 16)]
    reqs = [Request(prompt=sysp + [10 + i, 20 + i], max_new_tokens=8)
            for i in range(4)]
    for r in reqs:
        assert sched.submit(r)
    sched.step()                                # admit all four
    live = [r.slot for r in reqs]
    first_pages = {int(sched.slots._table[s, 0]) for s in live}
    assert len(first_pages) == 1
    page = first_pages.pop()
    assert sched.slots.pool.refs[page] == 5     # 4 requests + the cache
    sched.drain()
    assert sched.slots.pool.refs[page] == 1     # the cache keeps it
    assert sched.slots.radix.hit_tokens == 3 * 16


def test_prefix_cache_survives_retirement_and_lru_evicts(toy):
    _, _, tm = toy
    sched = port_sched(tm, "paged", num_slots=2, num_pages=8)
    rng = np.random.default_rng(5)
    a = [int(t) for t in rng.integers(1, 61, 16)]
    b = [int(t) for t in rng.integers(1, 61, 16)]
    sched.run([Request(prompt=a + [1], max_new_tokens=2)])
    assert sched.slots.cached_prefix_pages == 1
    h0 = sched.slots.radix.hit_tokens
    sched.run([Request(prompt=a + [2], max_new_tokens=2)])
    assert sched.slots.radix.hit_tokens - h0 == 16
    sched.run([Request(prompt=b + [3], max_new_tokens=2)])
    assert sched.slots.cached_prefix_pages == 2
    sched.run([Request(prompt=[int(t) for t in rng.integers(1, 61, 30)],
                       max_new_tokens=34) for _ in range(2)])
    assert sched.slots.radix.evicted_pages > 0


def test_infeasible_requests_rejected(toy):
    _, _, tm = toy
    sched = port_sched(tm, "paged", num_pages=2)
    req = Request(prompt=[1] * 8, max_new_tokens=40)   # 3 pages > 2
    assert not sched.submit(req)
    assert req.reject_reason == RejectReason.EXCEEDS_KV_CAPACITY
    ok = Request(prompt=[1] * 8, max_new_tokens=24)    # 31 positions
    assert sched.submit(ok)
    sched.drain()
    assert ok.finish_reason == FinishReason.LENGTH
    slots = port_sched(tm, "slots", prefill_buckets=(8, 16))
    long_req = Request(prompt=[1] * 17, max_new_tokens=2)
    assert not slots.submit(long_req)
    assert long_req.reject_reason == RejectReason.PROMPT_TOO_LONG
    over = Request(prompt=[1] * 8, max_new_tokens=58)  # 66 > 64 + 1
    assert not slots.submit(over)
    assert over.reject_reason == RejectReason.EXCEEDS_KV_CAPACITY


def test_spill_restores_pages_bit_exact(toy):
    """An evicted prefix page parks in host memory and comes back
    bit-exactly on the next hit; tokens equal a run without pressure."""
    _, _, tm = toy
    rng = np.random.default_rng(9)
    sysp = [int(t) for t in rng.integers(1, 61, 16)]
    other = [int(t) for t in rng.integers(1, 61, 50)]    # 4 pages
    sched = port_sched(tm, "paged", num_slots=1, num_pages=4,
                       spill_pages=4)
    sched.run([Request(prompt=sysp + [7], max_new_tokens=2)])
    kv = sched.slots
    page = kv.radix.match(sysp)[0].page
    before = [t[page].clone() for t in kv.cache.ks + kv.cache.vs]
    sched.run([Request(prompt=other, max_new_tokens=6)])   # evicts it
    assert kv.spill.spilled_out == 1 and kv.radix.spilled_nodes == 1
    assert kv.radix.match(sysp)[0].spilled
    req = Request(prompt=sysp + [8], max_new_tokens=3)
    sched.run([req])
    assert kv.spill.spilled_in == 1
    node = kv.radix.match(sysp)[0]
    assert not node.spilled and kv.radix.hit_tokens == 16
    for t, want in zip(kv.cache.ks + kv.cache.vs, before):
        assert torch.equal(t[node.page], want)
    _, want = run_port(tm, "paged", [Request(prompt=sysp + [8],
                                             max_new_tokens=3)])
    assert req.generated == want[0]


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_released_slot_never_disturbs_other_rows(toy, layout):
    """A short request retires while others keep decoding; its masked
    row keeps issuing frozen-offset writes (into the trash page when
    paged), and the others' tokens equal their runs alone."""
    _, _, tm = toy
    prompts = rand_prompts(3, seed=12, lo=10, hi=20)
    alone = [run_port(tm, layout, [Request(prompt=p, max_new_tokens=12,
                                           seed=i)],
                      temperature=1.0)[1][0]
             for i, p in enumerate(prompts[:2])]
    streamed = []
    reqs = [Request(prompt=p, max_new_tokens=12, seed=i,
                    on_token=lambda r, t: streamed.append((r.seed, t)))
            for i, p in enumerate(prompts[:2])]
    short = Request(prompt=prompts[2], max_new_tokens=1, seed=9)
    sched = port_sched(tm, layout, temperature=1.0)
    sched.run([reqs[0], short, reqs[1]])
    assert short.finish_reason == FinishReason.LENGTH
    assert [r.generated for r in reqs] == alone
    assert [[t for s, t in streamed if s == i] for i in (0, 1)] == alone
    if layout == "paged":
        assert (sched.slots._table == NULL_PAGE).all()


def test_stop_aborts_live_and_queued(toy):
    _, _, tm = toy
    sched = port_sched(tm, num_slots=1)
    reqs = [Request(prompt=[1, 2, 3], max_new_tokens=20) for _ in range(2)]
    for r in reqs:
        sched.submit(r)
    sched.step()
    sched.stop()
    assert reqs[0].finish_reason == FinishReason.STOPPED
    assert reqs[1].reject_reason == RejectReason.STOPPED
    late = Request(prompt=[1], max_new_tokens=1)
    assert not sched.submit(late)
    assert late.reject_reason == RejectReason.STOPPED


def test_later_slices_raise(toy):
    _, _, tm = toy
    for kw, what in ((dict(spec_k=2), "spec_k"),
                     (dict(slo_tbt_ms=5.0), "slo_tbt_ms"),
                     (dict(kv_layout="paged", spill_disk_dir="d"),
                      "kvtier")):
        with pytest.raises(NotImplementedError, match=what):
            ContinuousBatchingScheduler(tm, SchedulerConfig(**kw))
    with pytest.raises(NotImplementedError, match="shipped_kv"):
        port_sched(tm).submit(Request(prompt=[1], max_new_tokens=1,
                                      shipped_kv=object()))
    # The int8 cache is ported: an int8 toy builds and decodes.
    q8 = ToyModel(ToyConfig(quantize_kv_cache=True, **TOY),
                  device="cpu").init_params(torch.Generator().manual_seed(0))
    cache = q8.create_cache(2, max_seq=16)
    assert cache.quantized and cache.ks[0].dtype == torch.int8
    q8.prefill(torch.tensor([[3, 4, 5], [6, 7, 8]]), cache)
    logits = q8.decode(torch.tensor([9, 10]), cache)
    assert logits.shape == (2, TOY["vocab_size"])
    assert bool(logits.isfinite().all()) and cache.offset.tolist() == [4, 4]
    with pytest.raises(ValueError, match="kv_layout"):
        port_sched(tm, "ring")
