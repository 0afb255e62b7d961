"""The port's int8 path against the JAX package on the CPU: `quantize_sym`,
`quantize_kv`, `matmul_w8a8`, the int8 `flash_decode`/`flash_decode_paged`,
the w8a8 `TPMLP`, Qwen3 tiny with an int8 KV cache (cache contents, logits,
greedy `Engine.serve`), and the int8 `ToyModel` behind the scheduler.

The JAX side runs its Pallas kernels in interpret mode (as its own tests
do); the port runs the plain PyTorch versions of its kernels (CPU
tensors).  Inputs come from numpy with fixed seeds.  Tolerances are
stated at each check with their reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.kernels import flash_decode as jax_fd
from triton_distributed_tpu.kernels import quantized as jax_quant
from triton_distributed_tpu.layers.tp_mlp import TPMLP as JaxTPMLP
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models.kv_cache import KVCache as JaxKVCache
from triton_distributed_tpu.models.kv_cache import (
    PagedKVCache as JaxPagedKVCache)
from triton_distributed_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_distributed_tpu.serving import (
    ContinuousBatchingScheduler as JaxScheduler)
from triton_distributed_tpu.serving import Request as JaxRequest
from triton_distributed_tpu.serving import SchedulerConfig as JaxSchedConfig
from triton_distributed_tpu.serving import ToyConfig as JaxToyConfig
from triton_distributed_tpu.serving import ToyModel as JaxToyModel
from triton_distributed_tpu_torch import (
    Engine, KVCache, ModelConfig, PagedKVCache, Qwen3)
from triton_distributed_tpu_torch.kernels.flash_decode import (
    flash_decode, flash_decode_paged, quantize_kv)
from triton_distributed_tpu_torch.kernels.quantized import (
    matmul_quantized, matmul_w8a8, quantize_sym)
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP
from triton_distributed_tpu_torch.serving import (
    ContinuousBatchingScheduler, Request, SchedulerConfig, ToyConfig,
    ToyModel)

TOY = dict(vocab_size=61, hidden=16, max_seq_len=64, quantize_kv_cache=True)


@pytest.fixture(autouse=True)
def jax_observability_off(monkeypatch):
    """The port's scheduler is the JAX one as it runs with observability
    disabled, so the JAX side runs that way too."""
    monkeypatch.setenv("TDT_OBSERVABILITY", "0")


@pytest.fixture(autouse=True, scope="module")
def _fresh_observability_state():
    """Leave the JAX package's process-global observability rings empty
    for the test files that run after this one in the same worker (as
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


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape, np.float32)
            * np.float32(scale))


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(seed, *shape):
    return np.random.default_rng(seed).integers(-127, 128, shape,
                                                dtype=np.int8)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _on_mesh(fn, *args):
    """Run a per-device JAX function on a 1-device mesh with axis 'tp'."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    return jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                         check_vma=False)(*args)


# ---------------------------------------------------------------------------
# bit-exact: quantization and the int8 GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_sym_bit_exact(dtype, axis):
    """Codes and scales equal the JAX function's bit for bit, bf16 inputs
    included (both frameworks round f32 -> bf16 to nearest even).  Half
    of row 0 holds exact halves of its scale, so ties are exercised."""
    x = _rand(1, 24, 40)
    x[0, :20] = np.arange(20) * 0.5
    x[0, 20] = 127.0
    x[:, 3] = 0.0
    x[5] = 0.0                          # an all-zero row: scale 1e-30/127
    want_q, want_s = jax_quant.quantize_sym(
        jnp.asarray(x).astype(getattr(jnp, dtype)), axis=axis)
    got_q, got_s = quantize_sym(_t(x).to(getattr(torch, dtype)), axis)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    _same(got_q, want_q)
    _same(got_s, want_s)


def test_quantize_kv_bit_exact():
    k, v = _rand(2, 2, 3, 20, 16), _rand(3, 2, 3, 20, 16, scale=7.0)
    want = jax_fd.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    got = quantize_kv(_t(k), _t(v))
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == w.shape
        _same(g, w)


@pytest.mark.parametrize("m,k,n,out_dtype,unit_scales", [
    (32, 64, 48, "float32", True),
    (32, 64, 48, "bfloat16", False),
    (37, 48, 40, "float32", False),       # ragged m and n
    (37, 48, 40, "bfloat16", True),
    (8, 128, 7, "float32", False),        # a decode batch, odd n
    (8, 128, 7, "bfloat16", False),
    (16, 2048, 24, "float32", True),      # deep k
    (16, 2048, 24, "float32", False),
])
def test_matmul_w8a8_bit_exact(m, k, n, out_dtype, unit_scales):
    """The plain version against the Pallas kernel (interpret mode): int32
    accumulation is exact on both sides and the epilogue multiplies in the
    same order, so the outputs are equal bit for bit; k=2048 is past the
    depth (1041) where an f32 accumulator would round.  Ragged m and n."""
    a, b = _codes(m, m, k), _codes(n, k, n)
    sa = np.ones(m, np.float32) if unit_scales else np.abs(_rand(4, m)) / 50
    sb = np.ones(n, np.float32) if unit_scales else np.abs(_rand(5, n)) / 50
    want = jax_quant.matmul_w8a8(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb),
        out_dtype=getattr(jnp, out_dtype), interpret=True)
    got = matmul_w8a8(_t(a), _t(b), _t(sa), _t(sb),
                      out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (m, n)
    _same(got.float(), np.asarray(want).astype(np.float32))


def test_matmul_quantized_matches_jax():
    a, b = _rand(6, 16, 64), _rand(7, 64, 32)
    want = jax_quant.matmul_quantized(jnp.asarray(a), jnp.asarray(b),
                                      interpret=True)
    _same(matmul_quantized(_t(a), _t(b)), want)


def test_tpmlp_quantize_params_bit_exact():
    params = {"gate_up": _rand(8, 64, 96), "down": _rand(9, 48, 64)}
    want = JaxTPMLP.quantize_params({n: jnp.asarray(p)
                                     for n, p in params.items()})
    got = TPMLP.quantize_params({n: _t(p) for n, p in params.items()})
    assert set(got) == set(want)
    for name in want:
        _same(got[name], want[name])


# ---------------------------------------------------------------------------
# int8 decode attention
# ---------------------------------------------------------------------------

#: f32 on both sides; the two differ only in the order of the sums and in
#: where the scales multiply (the JAX kernel scales a (G, bk) tile, the
#: plain version the whole row), so 1e-5.
DEC_TOL = dict(atol=1e-5, rtol=1e-5)


def _int8_cache(seed, b, hkv, s, d, kv_len):
    """Quantized K/V (through the port's quantize_kv, proven equal to
    JAX's above) whose scales past each row's length are stale: finite
    values far from the live ones."""
    k, v = _rand(seed, b, hkv, s, d), _rand(seed + 1, b, hkv, s, d)
    k_q, v_q, ks, vs = (t.numpy() for t in quantize_kv(_t(k), _t(v)))
    stale = np.arange(s)[None, None, :] >= kv_len[:, None, None]
    ks[np.broadcast_to(stale, ks.shape)] = 1e3
    vs[np.broadcast_to(stale, vs.shape)] = -1e3
    return k_q, v_q, ks, vs, stale


@pytest.mark.parametrize("group,block_k", [(1, 64), (4, 16), (2, 24)])
def test_int8_flash_decode_matches_jax(group, block_k):
    b, hkv, s, d = 3, 2, 64, 32
    kv_len = np.array([1, 37, s], np.int32)
    q = _rand(10 + group, b, hkv * group, d)
    k_q, v_q, ks, vs, stale = _int8_cache(20 + group, b, hkv, s, d, kv_len)
    out_j, lse_j = jax_fd.flash_decode(
        jnp.asarray(q), jnp.asarray(k_q), jnp.asarray(v_q),
        jnp.asarray(kv_len), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        block_k=block_k)
    args = (_t(q), _t(k_q), _t(v_q), _t(kv_len))
    out_t, lse_t = flash_decode(*args, k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **DEC_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **DEC_TOL)
    # NaN scales past kv_len (the JAX kernel would pass NaN through
    # p * v_scale there) leave the port's result bit for bit unchanged.
    ks[np.broadcast_to(stale, ks.shape)] = np.nan
    vs[np.broadcast_to(stale, vs.shape)] = np.nan
    out_n, lse_n = flash_decode(*args, k_scale=_t(ks), v_scale=_t(vs))
    assert torch.equal(out_n, out_t) and torch.equal(lse_n, lse_t)


@pytest.mark.parametrize("group,page_size", [(1, 8), (4, 16)])
def test_int8_flash_decode_paged_matches_jax(group, page_size):
    """Shuffled table, null tail: the plain version against the Pallas
    kernel, and against the port's dense int8 decode over the same logical
    codes and scales.  The null page holds codes of 127 and finite garbage
    scales for the JAX comparison, then NaN scales for the port alone."""
    b, hkv, d, t = 3, 2, 32, 6
    kv_len = np.array([1, 2 * page_size + 3, t * page_size], np.int32)
    need = [-(-int(n) // page_size) for n in kv_len]
    p = 1 + sum(need)
    q = _rand(30 + group, b, hkv * group, d)
    kp, vp = _codes(31, p, hkv, page_size, d), _codes(32, p, hkv, page_size, d)
    ksp = np.abs(_rand(33, p, hkv, page_size)) / 100
    vsp = np.abs(_rand(34, p, hkv, page_size)) / 100
    kp[0] = vp[0] = 127
    ksp[0], vsp[0] = 1e3, -1e3
    perm = np.random.default_rng(35).permutation(np.arange(1, p))
    table = np.zeros((b, t), np.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n]
        at += n
    out_j, lse_j = jax_fd.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(kv_len), k_scale=jnp.asarray(ksp),
        v_scale=jnp.asarray(vsp))
    cache = PagedKVCache(ks=[_t(kp)], vs=[_t(vp)], kss=[_t(ksp)],
                         vss=[_t(vsp)], page_table=_t(table),
                         offset=_t(kv_len), page_size=page_size)
    tq, tlen = _t(q), _t(kv_len)
    out_t, lse_t = flash_decode_paged(tq, kp := cache.ks[0], cache.vs[0],
                                      cache.page_table, tlen,
                                      k_scale=cache.kss[0],
                                      v_scale=cache.vss[0])
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **DEC_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **DEC_TOL)
    k_l, v_l, ks_l, vs_l = cache.gather_logical(0)
    out_d, lse_d = flash_decode(tq, k_l, v_l, tlen, k_scale=ks_l,
                                v_scale=vs_l)
    np.testing.assert_allclose(out_d.numpy(), out_t.numpy(), **DEC_TOL)
    np.testing.assert_allclose(lse_d.numpy(), lse_t.numpy(), **DEC_TOL)
    cache.kss[0][0] = cache.vss[0][0] = float("nan")
    out_n, lse_n = flash_decode_paged(tq, kp, cache.vs[0], cache.page_table,
                                      tlen, k_scale=cache.kss[0],
                                      v_scale=cache.vss[0])
    assert torch.equal(out_n, out_t) and torch.equal(lse_n, lse_t)


# ---------------------------------------------------------------------------
# the w8a8 MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [37])
def test_tpmlp_w8a8_matches_jax(m):
    """The w8a8 layer at world 1 against the JAX layer on a 1-device mesh,
    same quantized params, f32 activations.  The int8 GEMMs agree bit for
    bit; the f32 SiLU of the two frameworks differs in the last bit of
    some values, which moves h's row scale by an ulp where it sets the
    row's maximum: atol 1e-6 of the output scale."""
    hidden, ffn = 128, 256
    params = {"gate_up": _rand(40, hidden, 2 * ffn, scale=hidden ** -0.5),
              "down": _rand(41, ffn, hidden, scale=hidden ** -0.5)}
    x = _rand(42, m, hidden, scale=0.125)
    jmlp = JaxTPMLP(axis="tp", world_size=1, hidden=hidden, ffn=ffn,
                    mode="w8a8", interpret=True)
    qj = JaxTPMLP.quantize_params({n: jnp.asarray(p)
                                   for n, p in params.items()})
    want = np.asarray(_on_mesh(lambda x_, q_: jmlp(x_, q_), jnp.asarray(x),
                               qj))
    mlp = TPMLP(hidden, ffn, mode="w8a8", dtype=torch.float32,
                device="cpu").load_quantized(jax.tree.map(np.asarray, qj))
    with torch.inference_mode():
        got = mlp(_t(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (m, hidden)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    # And against the float layer within int8 quantization error: per-row
    # quantization of x, of h and per-channel of the weights each add about
    # 1% of RMS error at these widths (1.9% measured here), so the relative
    # L2 error stays under 3%.
    fmlp = TPMLP(hidden, ffn, mode="xla", dtype=torch.float32, device="cpu")
    fmlp.load_state_dict({n: _t(p) for n, p in params.items()})
    with torch.inference_mode():
        ref = fmlp(_t(x)).numpy()
    assert np.linalg.norm(got - ref) <= 0.03 * np.linalg.norm(ref)


def test_tpmlp_w8a8_init_and_guards():
    """init_params of a w8a8 layer quantizes the float layer's draws;
    load_quantized refuses wrong dtypes and float layers."""
    f = TPMLP(32, 48, mode="xla", dtype=torch.float32, device="cpu")
    q = TPMLP(32, 48, mode="w8a8", device="cpu")
    f.init_params(torch.Generator().manual_seed(3))
    q.init_params(torch.Generator().manual_seed(3))
    for name, t in TPMLP.quantize_params(dict(f.named_parameters())).items():
        assert torch.equal(getattr(q, name), t), name
    with pytest.raises(ValueError, match="gate_up_q"):
        q.load_quantized({"gate_up_q": torch.zeros(32, 96)})
    with pytest.raises(ValueError, match="w8a8"):
        f.load_quantized({})
    with pytest.raises(ValueError, match="w8a8"):
        Qwen3(ModelConfig.tiny(), mode="w8a8", device="cpu")


# ---------------------------------------------------------------------------
# Qwen3 tiny with an int8 KV cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen_int8():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jcfg = JaxConfig.tiny(dtype="float32", quantize_kv_cache=True)
    jm = JaxQwen3(jcfg, mesh, mode="fused", interpret=True)
    params = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tm = Qwen3(ModelConfig.tiny(dtype="float32", quantize_kv_cache=True),
               device="cpu").load_jax_params(tree)
    tf = Qwen3(ModelConfig.tiny(dtype="float32"),
               device="cpu").load_jax_params(tree)
    return jm, params, tm, tf


def _codes_close(got, want, what):
    """int8 codes of the same K/V quantized by the two frameworks: equal,
    or one apart where the f32 K/V of the two differ in the last bits and
    the scaled value lies on a rounding half.  Returns how many differ."""
    diff = np.abs(got.numpy().astype(np.int32)
                  - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, (what, int(diff.max()))
    return int((diff > 0).sum())


def test_int8_caches_match_jax():
    """create(quantized=True) and bytes_per_slot/page count the scales,
    as the JAX caches do."""
    jc = JaxKVCache.create(2, 3, 2, 8, 16, jnp.float32, quantized=True)
    tc = KVCache.create(2, 3, 2, 8, 16, torch.float32, device="cpu",
                        quantized=True)
    assert tc.quantized and tc.ks[0].dtype == torch.int8
    assert tuple(tc.kss[0].shape) == jc.kss[0].shape
    assert tc.bytes_per_slot() == jc.bytes_per_slot() == 2 * (
        2 * 2 * 8 * 16 + 2 * 2 * 8 * 4)
    jp = JaxPagedKVCache.create(num_layers=2, num_pages=5, batch=2,
                                num_kv_heads=2, page_size=8, head_dim=16,
                                max_pages_per_seq=3, quantized=True)
    tp = PagedKVCache.create(2, 5, 2, 2, 8, 16, 3, device="cpu",
                             quantized=True)
    assert tp.bytes_per_page() == jp.bytes_per_page()
    k, v = _rand(50, 3, 2, 5, 16), _rand(51, 3, 2, 5, 16)
    jc = jc.write_prefill(1, jnp.asarray(k), jnp.asarray(v))
    tc.write_prefill(1, _t(k), _t(v))
    for a, b in zip(tc.ks + tc.vs + tc.kss + tc.vss,
                    jc.ks + jc.vs + jc.kss + jc.vss):
        _same(a, b)


def test_int8_qwen3_logits_and_cache_match_jax(qwen_int8):
    """Prefill logits equal the float model's bit for bit (prefill never
    reads the cache) and the JAX model's within 1e-4 (f32, order of the
    sums, as tests/test_torch_model.py).  The int8 cache after prefill and
    after each of 3 decode steps: codes equal or one apart (counted),
    scales within 1e-5.  Decode logits within 1e-4 of JAX's: both read the
    same codes but for those one-apart ones, each worth a part in 254 of
    one position's K or V."""
    jm, params, tm, tf = qwen_int8
    b, s = 2, 16
    ids = np.random.default_rng(60).integers(0, 256, (b, s), dtype=np.int32)
    cache_j = jm.create_cache(b, max_seq=32)
    logits_j, cache_j = jax.jit(jm.make_prefill_fn())(params,
                                                     jnp.asarray(ids),
                                                     cache_j)
    cache_t = tm.create_cache(b, max_seq=32)
    logits_t = tm.prefill(_t(ids), cache_t)
    assert torch.equal(logits_t, tf.prefill(_t(ids), tf.create_cache(b, 32)))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=1e-4, rtol=1e-4)

    def compare_cache(what):
        flips = 0
        for i in range(len(cache_t.ks)):
            flips += _codes_close(cache_t.ks[i], cache_j.ks[i], what)
            flips += _codes_close(cache_t.vs[i], cache_j.vs[i], what)
            for a, w in ((cache_t.kss[i], cache_j.kss[i]),
                         (cache_t.vss[i], cache_j.vss[i])):
                np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=0)
        return flips

    flips = [compare_cache("prefill")]
    decode_j = jax.jit(jm.make_decode_fn())
    toks = np.argmax(np.asarray(logits_j), -1).astype(np.int32)
    for step in range(3):
        logits_j, cache_j = decode_j(params, jnp.asarray(toks), cache_j)
        logits_t = tm.decode(_t(toks), cache_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   atol=1e-4, rtol=1e-4)
        flips.append(compare_cache(f"decode {step}"))
        toks = np.argmax(np.asarray(logits_j), -1).astype(np.int32)
    assert cache_t.offset.tolist() == [s + 3] * b
    # 2 layers x 2 x (2 rows x 4 heads x 32 positions x 16) = 16,384 codes:
    # one-apart codes stay a small minority.
    assert max(flips) <= 16, flips


def test_int8_engine_serve_matches_jax(qwen_int8):
    jm, params, tm, tf = qwen_int8
    b, s, gen = 2, 16, 4
    ids = np.random.default_rng(61).integers(0, 256, (b, s), dtype=np.int32)
    want = np.asarray(JaxEngine(jm, temperature=0.0).serve(
        params, jnp.asarray(ids), gen))
    got = Engine(tm).serve(_t(ids), gen)
    _same(got, want)
    # Against the float cache, as tests/test_model_e2e.py holds the JAX
    # model: decode logits within 0.03 of their scale (rtol 0.05).
    cq, cf = tm.create_cache(b, 32), tf.create_cache(b, 32)
    lq, lf = tm.prefill(_t(ids), cq), tf.prefill(_t(ids), cf)
    for _ in range(3):
        toks = lf.argmax(-1).to(torch.int32)
        lq, lf = tm.decode(toks, cq), tf.decode(toks, cf)
        torch.testing.assert_close(lq, lf, rtol=0.05,
                                   atol=0.03 * float(lf.abs().max()))


# ---------------------------------------------------------------------------
# the int8 toy behind the scheduler
# ---------------------------------------------------------------------------


class Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _tokens(done):
    return [r.generated for r in sorted(done, key=lambda r: r.request_id)]


@pytest.fixture(scope="module")
def toy_int8():
    jm = JaxToyModel(JaxToyConfig(**TOY))
    params = jm.init_params(jax.random.key(0))
    tm = ToyModel(ToyConfig(**TOY), device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    return jm, params, tm


def _reqs(cls):
    rng = np.random.default_rng(70)
    sysp = [int(t) for t in rng.integers(1, 61, 24)]
    out = [cls(prompt=[int(t) for t in rng.integers(1, 61, n)],
               max_new_tokens=g, arrival_time=0.001 * i)
           for i, (n, g) in enumerate(zip((5, 13, 19, 8), (6, 3, 7, 5)))]
    return out + [cls(prompt=sysp + [1 + i, 2 + i], max_new_tokens=4,
                      arrival_time=0.002 * i) for i in range(3)]


def _preempting(cls):
    return [cls(prompt=[1 + i] * 10, max_new_tokens=30) for i in range(3)]


@pytest.mark.parametrize("case", ["mixed", "preempting"])
def test_int8_toy_scheduler_matches_jax(toy_int8, case):
    """Greedy tokens of the int8 toy: slots == paged (the invariant of
    tests/test_serving_paged.py), and both equal the JAX scheduler's in
    both layouts.  The preempting case (6 usable pages for three
    39-position horizons) resumes a request whose tokens still equal the
    slot run's: its re-prefilled K/V quantize to the same codes as the
    decode-written ones."""
    jm, params, tm = toy_int8
    make = _reqs if case == "mixed" else _preempting
    kw = dict(num_slots=3, prefill_buckets=(8, 16, 32, 64))
    tight = dict(num_pages=6) if case == "preempting" else {}
    got = {}
    for layout in ("slots", "paged"):
        extra = tight if layout == "paged" else {}
        ck = Clock()
        want = _tokens(JaxScheduler(
            jm, params, JaxSchedConfig(kv_layout=layout, **kw, **extra),
            clock=ck.now, clock_advance=ck.advance).run(make(JaxRequest)))
        ck = Clock()
        sched = ContinuousBatchingScheduler(
            tm, SchedulerConfig(kv_layout=layout, **kw, **extra),
            clock=ck.now, clock_advance=ck.advance)
        got[layout] = _tokens(sched.run(make(Request)))
        assert got[layout] == want, layout
        if layout == "paged" and case == "preempting":
            assert any(r.preemptions for r in sched.finished)
        if layout == "paged" and case == "mixed":
            assert sched.slots.radix.hit_tokens == 2 * 16   # one page each
    assert got["slots"] == got["paged"]


def test_int8_spill_restores_pages_bit_exact(toy_int8):
    """An evicted int8 prefix page parks its codes and scales in host
    memory and comes back bit for bit on the next hit; tokens equal a run
    without pressure."""
    _, _, tm = toy_int8

    def sched(**kw):
        ck = Clock()
        return ContinuousBatchingScheduler(
            tm, SchedulerConfig(kv_layout="paged", num_slots=1,
                                prefill_buckets=(8, 16, 32, 64), **kw),
            clock=ck.now, clock_advance=ck.advance)

    rng = np.random.default_rng(9)
    sysp = [int(t) for t in rng.integers(1, 61, 16)]
    other = [int(t) for t in rng.integers(1, 61, 50)]     # 4 pages
    s = sched(num_pages=4, spill_pages=4)
    s.run([Request(prompt=sysp + [7], max_new_tokens=2)])
    kv = s.slots
    page = kv.radix.match(sysp)[0].page
    pools = kv.cache.ks + kv.cache.vs + kv.cache.kss + kv.cache.vss
    before = [t[page].clone() for t in pools]
    assert set(kv._read_page(page)) == {"k0", "v0", "ks0", "vs0"}
    s.run([Request(prompt=other, max_new_tokens=6)])      # evicts it
    assert kv.spill.spilled_out == 1 and kv.radix.match(sysp)[0].spilled
    req = Request(prompt=sysp + [8], max_new_tokens=3)
    s.run([req])
    node = kv.radix.match(sysp)[0]
    assert kv.spill.spilled_in == 1 and not node.spilled
    for t, want in zip(pools, before, strict=True):
        assert torch.equal(t[node.page], want)
    want = _tokens(sched().run([Request(prompt=sysp + [8],
                                        max_new_tokens=3)]))
    assert req.generated == want[0]
