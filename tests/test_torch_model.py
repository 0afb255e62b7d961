"""The port's Qwen3 slice against the JAX package on the CPU: layers,
KV cache, prefill and decode logits, and greedy `Engine.serve` tokens.

The JAX side is `Qwen3(cfg, 1-device mesh, mode="fused",
interpret=True)`, so its attention runs the Pallas kernels in interpret
mode; the port runs the plain PyTorch versions of its kernels (CPU
tensors).  Weights come from the JAX parameter pytree through
`Qwen3.load_jax_params`.  Everything is f32, so the tolerance (1e-4) only
covers the order of the sums, through two layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.layers import tp_attn as jax_attn
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models.kv_cache import KVCache as JaxKVCache
from triton_distributed_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_distributed_tpu_torch import Engine, KVCache, ModelConfig, Qwen3
from triton_distributed_tpu_torch.layers import tp_attn
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP, gated_silu
from triton_distributed_tpu_torch.models.utils import sample_token

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jm = JaxQwen3(JaxConfig.tiny(dtype="float32"), mesh, mode="fused",
                  interpret=True)
    params = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tm = Qwen3(ModelConfig.tiny(dtype="float32"),
               device="cpu").load_jax_params(tree)
    return mesh, jm, params, tm


def _on_mesh(mesh, fn, *args):
    """Run a per-device JAX function on the 1-device mesh."""
    return jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                         check_vma=False)(*args)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def test_config_presets_match_jax():
    for name in ("tiny", "tiny_moe", "qwen3_0_6b", "qwen3_8b", "qwen3_32b"):
        assert (vars(getattr(ModelConfig, name)())
                == vars(getattr(JaxConfig, name)())), name
    assert (vars(ModelConfig.draft_of(ModelConfig.qwen3_8b()))
            == vars(JaxConfig.draft_of(JaxConfig.qwen3_8b())))


def test_norm_rope_and_gated_silu():
    x, w = _rand(1, 5, 128), _rand(2, 128)
    _close(tp_attn.rms_norm(_t(x), _t(w)),
           jax_attn.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.arange(12, dtype=np.int32) * 3
    cos_t, sin_t = tp_attn.rope_cos_sin(_t(pos), 16, 1e6)
    cos_j, sin_j = jax_attn.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    xr = _rand(3, 2, 3, 12, 16)
    _close(tp_attn.apply_rope(_t(xr), cos_t, sin_t),
           jax_attn.apply_rope(jnp.asarray(xr), cos_j, sin_j))
    from triton_distributed_tpu.kernels.allgather_group_gemm import (
        gated_silu as jax_gated_silu)
    gu = _rand(4, 6, 64)
    _close(gated_silu(_t(gu)), jax_gated_silu(jnp.asarray(gu)))


def test_attention_prefill_matches_jax(pair):
    mesh, jm, params, tm = pair
    b, s = 2, 12
    x = _rand(5, b * s, 128)
    lp = params["layers"][0]["attn"]
    out_j, (k_j, v_j) = _on_mesh(
        mesh, lambda x_, p_: jm.attn.prefill(x_, p_, b), jnp.asarray(x), lp)
    with torch.inference_mode():
        out_t, (k_t, v_t) = tm.layers[0].attn.prefill(_t(x), b)
    _close(out_t, out_j)
    _close(k_t, k_j)
    _close(v_t, v_j)


def test_attention_decode_matches_jax(pair):
    """Write-then-attend: the new K/V lands at each row's offset and
    attention reads offset + 1 positions."""
    mesh, jm, params, tm = pair
    b, hkv, smax, d = 2, 4, 16, 16
    x = _rand(6, b, 128)
    kc, vc = _rand(7, b, hkv, smax, d), _rand(8, b, hkv, smax, d)
    offset = np.array([3, 9], dtype=np.int32)
    lp = params["layers"][1]["attn"]

    def jax_decode(x_, p_, kc_, vc_, off_):
        out, (k_, v_), _ = jm.attn.decode(x_, p_, (kc_, vc_), off_)
        return out, k_, v_

    out_j, kc_j, vc_j = _on_mesh(mesh, jax_decode, jnp.asarray(x), lp,
                                 jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.asarray(offset))
    kc_t, vc_t = _t(kc), _t(vc)
    with torch.inference_mode():
        out_t = tm.layers[1].attn.decode(_t(x), (kc_t, vc_t), _t(offset))
    _close(out_t, out_j)
    _close(kc_t, kc_j)
    _close(vc_t, vc_j)


@pytest.mark.parametrize("mode", ["xla", "fused"])
def test_mlp_matches_jax(pair, mode):
    mesh, jm, params, tm = pair
    x = _rand(9, 10, 128)
    lp = params["layers"][0]["mlp"]
    out_j = _on_mesh(mesh, lambda x_, p_: jm.mlp(x_, p_), jnp.asarray(x),
                     lp)
    mlp = TPMLP(128, 256, mode=mode, dtype=torch.float32, device="cpu")
    mlp.load_state_dict(tm.layers[0].mlp.state_dict())
    with torch.inference_mode():
        _close(mlp(_t(x)), out_j)


def test_kv_cache_matches_jax():
    jc = JaxKVCache.create(2, 3, 2, 8, 16, jnp.float32)
    tc = KVCache.create(2, 3, 2, 8, 16, torch.float32, device="cpu")
    assert tc.bytes_per_slot() == jc.bytes_per_slot()
    assert all(float(k.abs().sum()) == 0 for k in tc.ks + tc.vs)
    k, v = _rand(10, 3, 2, 5, 16), _rand(11, 3, 2, 5, 16)
    jc = jc.write_prefill(1, jnp.asarray(k), jnp.asarray(v))
    tc.write_prefill(1, _t(k), _t(v))
    for a, b_ in zip(tc.ks + tc.vs, jc.ks + jc.vs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    tc.set_offset(5)
    tc.inc_offset(2)
    tc.reset_slot(1)
    jc = jc.set_offset(5).inc_offset(2).reset_slot(1)
    np.testing.assert_array_equal(tc.offset.numpy(), np.asarray(jc.offset))


def test_prefill_and_decode_logits_match_jax(pair):
    mesh, jm, params, tm = pair
    b, s = 2, 16
    ids = np.random.default_rng(12).integers(0, 256, (b, s), dtype=np.int32)
    cache_j = jm.create_cache(b, max_seq=32)
    logits_j, cache_j = jax.jit(jm.make_prefill_fn())(params,
                                                     jnp.asarray(ids),
                                                     cache_j)
    cache_t = tm.create_cache(b, max_seq=32)
    logits_t = tm.prefill(_t(ids), cache_t)
    assert logits_t.dtype == torch.float32 and logits_t.shape == (b, 256)
    _close(logits_t, logits_j)
    assert cache_t.offset.tolist() == [s, s]
    for a, b_ in zip(cache_t.ks + cache_t.vs, cache_j.ks + cache_j.vs):
        _close(a, b_)

    decode_j = jax.jit(jm.make_decode_fn())
    toks = np.argmax(np.asarray(logits_j), -1).astype(np.int32)
    for _ in range(2):
        logits_j, cache_j = decode_j(params, jnp.asarray(toks), cache_j)
        logits_t = tm.decode(_t(toks), cache_t)
        _close(logits_t, logits_j)
        toks = np.argmax(np.asarray(logits_j), -1).astype(np.int32)
    assert cache_t.offset.tolist() == list(np.asarray(cache_j.offset))


def test_engine_serve_greedy_tokens_match_jax(pair):
    mesh, jm, params, tm = pair
    b, s, gen = 2, 16, 4
    ids = np.random.default_rng(13).integers(0, 256, (b, s), dtype=np.int32)
    want = np.asarray(JaxEngine(jm, temperature=0.0).serve(
        params, jnp.asarray(ids), gen))
    got = Engine(tm).serve(_t(ids), gen)
    assert got.dtype == torch.int32 and got.shape == (b, gen)
    np.testing.assert_array_equal(got.numpy(), want)

    # A caller's cache is reused with its offset reset: same tokens.
    cache = tm.create_cache(b, max_seq=s + gen)
    cache.set_offset(7)
    np.testing.assert_array_equal(
        Engine(tm).serve(_t(ids), gen, cache=cache).numpy(), want)
    assert cache.offset.tolist() == [s + gen - 1] * b
    with pytest.raises(ValueError, match="cannot hold"):
        Engine(tm).serve(_t(ids), gen + 2, cache=cache)


def test_sampled_serve_invariants(pair):
    """Sampled streams cannot match JAX's bits; the port holds their
    invariants itself: shape, vocabulary range, determinism per seed."""
    _, _, _, tm = pair
    ids = torch.from_numpy(
        np.random.default_rng(14).integers(0, 256, (3, 8), dtype=np.int64))
    eng = Engine(tm, temperature=0.8, top_k=16, top_p=0.9)

    def run(seed):
        return eng.serve(ids, 5, generator=torch.Generator().manual_seed(seed))

    a = run(3)
    assert a.shape == (3, 5) and bool(((a >= 0) & (a < 256)).all())
    assert torch.equal(a, run(3))
    assert any(not torch.equal(a, run(seed)) for seed in range(4, 8))


def test_sample_token_truncation():
    """Greedy is argmax; top-p keeps the smallest prefix reaching its
    mass; top-k keeps the k largest."""
    logits = torch.log(torch.tensor([[0.85, 0.12, 0.02, 0.01]])).repeat(
        64, 1)
    assert sample_token(logits).tolist() == [0] * 64
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(8):
        seen.update(sample_token(logits, gen, 1.0, top_p=0.9).tolist())
    assert seen <= {0, 1}
    seen = set()
    for _ in range(8):
        seen.update(sample_token(logits / 10, gen, 1.0, top_k=3).tolist())
    assert seen <= {0, 1, 2} and len(seen) > 1
