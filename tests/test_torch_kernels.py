"""The port's kernels against the JAX package's Pallas kernels (interpret
mode, as tests/test_flash_attention.py runs them), on the same seeded
numpy inputs in f32.

On the CPU the port's wrappers compute their plain PyTorch versions, so
this holds those versions to the TPU kernels' semantics; the CUDA
kernels are held to the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).  Tolerance 1e-5: both sides
compute in f32 and differ only in the order of the sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention)
from triton_distributed_tpu.kernels.flash_decode import (
    flash_decode as jax_flash_decode)
from triton_distributed_tpu.kernels.flash_decode import (
    flash_decode_paged as jax_flash_decode_paged)
from triton_distributed_tpu_torch.kernels.flash_attention import (
    flash_attention)
from triton_distributed_tpu_torch.kernels.flash_decode import (
    flash_decode, flash_decode_paged)
from triton_distributed_tpu_torch.models.kv_cache import PagedKVCache

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,causal,kv_offset,block",
    [
        (2, 4, 4, 32, 32, True, 0, 1024),     # group 1, one block
        (2, 4, 2, 32, 32, False, 0, 1024),    # group 2, non-causal
        (1, 8, 2, 32, 48, True, 16, 1024),    # group 4, kv_offset 16
        (1, 4, 1, 40, 40, True, 0, 16),       # ragged Sq = Sk = 40
        (1, 4, 2, 40, 40, False, 0, 16),      # ragged, rectangular grid
        (1, 4, 2, 64, 64, True, 0, 16),       # packed causal schedule
        (1, 4, 4, 32, 48, True, 16, 16),      # packed, kv_offset 16
    ])
def test_flash_attention_matches_jax(b, h, hkv, sq, sk, causal, kv_offset,
                                     block):
    d = 32
    q, k, v = _inputs(sq * 7 + sk, (b, h, sq, d), (b, hkv, sk, d),
                      (b, hkv, sk, d))
    out_j, lse_j = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_offset=kv_offset, return_lse=True, block_q=block, block_k=block)
    out_t, lse_t = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_offset=kv_offset, return_lse=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


def test_flash_attention_default_returns_out_only():
    q, k, v = _inputs(3, (1, 2, 8, 16), (1, 1, 8, 16), (1, 1, 8, 16))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v))
    assert isinstance(out, torch.Tensor) and out.shape == (1, 2, 8, 16)


@pytest.mark.parametrize("group,block_k", [(1, 64), (4, 16), (2, 24)])
def test_flash_decode_matches_jax(group, block_k):
    b, hkv, s, d = 3, 2, 64, 32
    h = hkv * group
    q, kc, vc = _inputs(group, (b, h, d), (b, hkv, s, d), (b, hkv, s, d))
    kv_len = np.array([1, 37, s], dtype=np.int32)        # 1, mid, full
    out_j, lse_j = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kv_len), block_k=block_k)
    out_t, lse_t = flash_decode(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(kv_len))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


def test_flash_decode_ignores_cache_past_kv_len():
    """Positions at or past kv_len contribute exactly nothing, whatever
    the cache holds there."""
    q, kc, vc = _inputs(5, (2, 4, 16), (2, 2, 32, 16), (2, 2, 32, 16))
    kv_len = torch.tensor([5, 20], dtype=torch.int32)
    out, lse = flash_decode(torch.from_numpy(q), torch.from_numpy(kc),
                            torch.from_numpy(vc), kv_len)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[0, :, 5:] = 1e4
    vc2[1, :, 20:] = -1e4
    out2, lse2 = flash_decode(torch.from_numpy(q), torch.from_numpy(kc2),
                              torch.from_numpy(vc2), kv_len)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def _paged_inputs(seed, b, h, hkv, d, ps, t, kv_len):
    """Pools whose page 0 (the null page) holds garbage, a table mapping
    each row's pages below kv_len to a shuffled set of physical pages and
    the rest to page 0."""
    need = [-(-int(n) // ps) for n in kv_len]
    p = 1 + sum(need)
    q, kp, vp = _inputs(seed, (b, h, d), (p, hkv, ps, d), (p, hkv, ps, d))
    kp[0] = vp[0] = 1e4
    perm = np.random.default_rng(seed).permutation(np.arange(1, p))
    table = np.zeros((b, t), np.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n]
        at += n
    return q, kp, vp, table


@pytest.mark.parametrize("group,page_size", [(1, 8), (1, 16), (4, 8),
                                             (4, 16)])
def test_flash_decode_paged_matches_jax(group, page_size):
    """Shuffled table, a NULL tail past each row's length: the plain
    version against the Pallas kernel, and against the port's dense
    flash_decode over the same K/V gathered into logical order."""
    b, hkv, d, t = 3, 2, 32, 6
    kv_len = np.array([1, 2 * page_size + 3, t * page_size], np.int32)
    q, kp, vp, table = _paged_inputs(group * 10 + page_size, b,
                                     hkv * group, hkv, d, page_size, t,
                                     kv_len)
    out_j, lse_j = jax_flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(kv_len))
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv_len)
    cache = PagedKVCache(ks=[torch.from_numpy(kp)],
                         vs=[torch.from_numpy(vp)],
                         page_table=torch.from_numpy(table), offset=tkv,
                         page_size=page_size)
    out_t, lse_t = flash_decode_paged(tq, cache.ks[0], cache.vs[0],
                                      cache.page_table, tkv)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)
    out_d, lse_d = flash_decode(tq, *cache.gather_logical(0), tkv)
    np.testing.assert_allclose(out_d.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_d.numpy(), np.asarray(lse_j), **TOL)
