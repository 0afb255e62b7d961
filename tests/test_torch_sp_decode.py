"""The port's sequence-parallel flash-decode, low-latency all-gather and
``TPMLP(mode="fused_ar")`` against the JAX package on the CPU: the LSE
combine and its edge cases, `sp_flash_decode` (dense, ragged shards with
an empty one, int8) and `sp_flash_decode_paged`, `SpFlashDecodeAttention`,
`fast_allgather(_packed)`, and the fused_ar MLP at world 1 and 4 on the
setup of tests/test_layers.py::test_tp_mlp_fused_ar.

The JAX side runs as tests/test_flash_decode.py and tests/test_layers.py
run it: `shard_map` over the ``sp4_mesh`` / ``tp4_mesh`` fixtures (virtual
CPU devices), Pallas in interpret mode.  The port holds every rank in one
process: the KV shards are rank-stacked (W, B, Hkv, S_loc, D), the outputs
every rank's copy (W, ...), and on CPU tensors the kernels' plain versions
run.  The same seeded numpy inputs go to both.

Tolerances, f32 throughout: 1e-5 for the decode (the JAX kernel's online
softmax against the plain version's one-pass softmax, then the same
combine), 1e-4 through the MLP (two products and the all-reduce; the f32
sums' order differs); the combine's edge cases and the gathers exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.kernels import flash_decode as jfd
from triton_distributed_tpu.kernels import low_latency_allgather as jll
from triton_distributed_tpu.layers.sp_flash_decode_layer import (
    SpFlashDecodeAttention as JaxSpAttention)
from triton_distributed_tpu.layers.tp_mlp import TPMLP as JaxTPMLP
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch.kernels import flash_decode as fd
from triton_distributed_tpu_torch.kernels import low_latency_allgather as ll
from triton_distributed_tpu_torch.layers.sp_flash_decode_layer import (
    SpFlashDecodeAttention)
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP

DECODE = dict(atol=1e-5, rtol=1e-5)
LAYER = dict(atol=1e-4, rtol=1e-4)
WORLD, B, H, HKV, S_LOC, D = 4, 2, 8, 2, 32, 32


@pytest.fixture(autouse=True)
def jax_observability_off(monkeypatch):
    monkeypatch.setenv("TDT_OBSERVABILITY", "0")


@pytest.fixture(autouse=True, scope="module")
def _fresh_observability_state():
    """Leave the JAX package's process-global flight ring, tracer,
    lineage and decision rings empty for the test files that run after
    this one in the same worker (as tests/test_torch_tp.py does)."""
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
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _shards(a):
    """A (B, Hkv, W * S_loc, ...) cache -> the rank-stacked (W, B, Hkv,
    S_loc, ...) shards of the contiguous layout."""
    b, hkv = a.shape[:2]
    return np.ascontiguousarray(np.moveaxis(
        a.reshape(b, hkv, WORLD, S_LOC, *a.shape[3:]), 2, 0))


def _every_rank(got, want, tol):
    assert got.shape == (WORLD, *np.shape(want))
    for r in range(WORLD):
        _close(got[r], want, tol)


#: Filled positions of each rank's shard (a row each): full shards, a
#: ragged one, and an empty one.
FILL = np.array([S_LOC, S_LOC, 7, 0], np.int32)


# ---- the combine -----------------------------------------------------------

def test_combine_partials_matches_jax():
    outs, lses = _rand(1, 3, B, H, D), _rand(2, 3, B, H)
    lses[1, 0] = -1e30                     # one shard empty for a row
    want = jfd.combine_partials(jnp.asarray(outs), jnp.asarray(lses))
    _close(fd.combine_partials(_t(outs), _t(lses)), want, DECODE)


def test_combine_partials_all_empty_shards():
    """All-empty shards (every lse -inf) combine to 0, not NaN, on both
    sides: the gate keys on each shard's own lse."""
    outs = np.full((3, 2, 4, 8), np.nan, np.float32)
    lses = np.full((3, 2, 4), -1e30, np.float32)
    got = fd.combine_partials(_t(outs), _t(lses))
    want = np.asarray(jfd.combine_partials(jnp.asarray(outs),
                                           jnp.asarray(lses)))
    assert (got.numpy() == 0).all() and (want == 0).all()


def test_combine_partials_live_nan_propagates():
    """A live shard's NaN propagates on both sides, not replaced by a
    finite wrong answer."""
    outs = np.stack([np.full((1, 2, 4), np.nan, np.float32),
                     np.ones((1, 2, 4), np.float32)])
    lses = np.zeros((2, 1, 2), np.float32)
    got = fd.combine_partials(_t(outs), _t(lses))
    want = np.asarray(jfd.combine_partials(jnp.asarray(outs),
                                           jnp.asarray(lses)))
    assert torch.isnan(got).all() and np.isnan(want).all()


# ---- sp_flash_decode -------------------------------------------------------

def _decode_inputs(seed):
    q = _rand(seed, B, H, D, scale=0.5)
    k = _rand(seed + 1, B, HKV, WORLD * S_LOC, D, scale=0.5)
    v = _rand(seed + 2, B, HKV, WORLD * S_LOC, D)
    return q, k, v


@pytest.mark.parametrize("ragged", [False, True])
def test_sp_flash_decode_matches_jax(sp4_mesh, ragged):
    """Full shards, then ragged ones (the third partly filled, the last
    empty): every rank's combined output is JAX's."""
    q, k, v = _decode_inputs(10)
    fill = FILL if ragged else np.full(WORLD, S_LOC, np.int32)
    kv_len = np.repeat(fill[:, None], B, axis=1)            # (W, B)
    fn = shard_map_op(
        lambda qq, kk, vv, lens: jfd.sp_flash_decode(
            qq, kk, vv, lens[0], axis="sp", block_k=16),
        sp4_mesh,
        in_specs=(P(None, None, None), P(None, None, "sp", None),
                  P(None, None, "sp", None), P("sp", None)),
        out_specs=P(None, None, None))
    want = jax.jit(fn)(q, k, v, kv_len)
    got = fd.sp_flash_decode(_t(q), _t(_shards(k)), _t(_shards(v)),
                             _t(kv_len))
    _every_rank(got, want, DECODE)


def test_sp_flash_decode_int8_matches_jax(sp4_mesh):
    """Int8 shards with per-token scales (the port's `quantize_kv` on the
    whole cache, the same codes and scales on both sides)."""
    q, k, v = _decode_inputs(20)
    kq, vq, ks, vs = (t.numpy() for t in fd.quantize_kv(_t(k), _t(v)))
    kv_len = np.repeat(FILL[:, None], B, axis=1)
    fn = shard_map_op(
        lambda qq, kk, vv, kss, vss, lens: jfd.sp_flash_decode(
            qq, kk, vv, lens[0], axis="sp", k_scale=kss, v_scale=vss,
            block_k=16),
        sp4_mesh,
        in_specs=(P(None, None, None), P(None, None, "sp", None),
                  P(None, None, "sp", None), P(None, None, "sp"),
                  P(None, None, "sp"), P("sp", None)),
        out_specs=P(None, None, None))
    want = jax.jit(fn)(q, kq, vq, ks, vs, kv_len)
    got = fd.sp_flash_decode(_t(q), _t(_shards(kq)), _t(_shards(vq)),
                             _t(kv_len), k_scale=_t(_shards(ks)),
                             v_scale=_t(_shards(vs)))
    _every_rank(got, want, DECODE)


def test_sp_flash_decode_paged_matches_jax(sp4_mesh):
    """Each rank's shard in its own pool of pages of 8, placed by a
    shuffled table (page 0 null), ragged fills."""
    q, k, v = _decode_inputs(30)
    ps, t = 8, S_LOC // 8
    pages = 1 + B * t
    kp = np.zeros((WORLD, pages, HKV, ps, D), np.float32)
    vp = np.zeros_like(kp)
    tables = np.zeros((WORLD, B, t), np.int32)
    for r, (ks_, vs_) in enumerate(zip(_shards(k), _shards(v))):
        tables[r] = (1 + np.random.default_rng(40 + r).permutation(
            pages - 1)).reshape(B, t)
        for b in range(B):
            for j in range(t):
                kp[r, tables[r, b, j]] = ks_[b, :, j * ps:(j + 1) * ps]
                vp[r, tables[r, b, j]] = vs_[b, :, j * ps:(j + 1) * ps]
    kv_len = np.repeat(FILL[:, None], B, axis=1)
    fn = shard_map_op(
        lambda qq, kk, vv, tt, lens: jfd.sp_flash_decode_paged(
            qq, kk[0], vv[0], tt[0], lens[0], axis="sp"),
        sp4_mesh,
        in_specs=(P(None, None, None), P("sp", None, None, None, None),
                  P("sp", None, None, None, None), P("sp", None, None),
                  P("sp", None)),
        out_specs=P(None, None, None))
    want = jax.jit(fn)(q, kp, vp, tables, kv_len)
    got = fd.sp_flash_decode_paged(_t(q), _t(kp), _t(vp), _t(tables),
                                   _t(kv_len))
    _every_rank(got, want, DECODE)


def test_sp_attention_layer_matches_jax(sp4_mesh):
    """`SpFlashDecodeAttention` on ragged global lengths (one row leaves
    two shards empty)."""
    q, k, v = _decode_inputs(50)
    total = np.array([WORLD * S_LOC - 5, S_LOC + 3], np.int32)
    jlayer = JaxSpAttention(axis="sp", sp_size=WORLD, num_heads=H,
                            num_kv_heads=HKV, head_dim=D,
                            max_seq_per_rank=S_LOC)
    fn = shard_map_op(
        lambda qq, kk, vv, tl: jlayer(qq, kk, vv, tl), sp4_mesh,
        in_specs=(P(None, None, None), P(None, None, "sp", None),
                  P(None, None, "sp", None), P(None)),
        out_specs=P(None, None, None))
    want = jax.jit(fn)(q, k, v, total)
    layer = SpFlashDecodeAttention("sp", WORLD, H, HKV, D, S_LOC)
    got = layer(_t(q), _t(_shards(k)), _t(_shards(v)), _t(total))
    _every_rank(got, want, DECODE)
    np.testing.assert_array_equal(
        layer.local_kv_len(_t(total)[None], torch.arange(WORLD)[:, None]),
        [[S_LOC, S_LOC], [S_LOC, 3], [S_LOC, 0], [S_LOC - 5, 0]])


# ---- fast_allgather --------------------------------------------------------

def test_fast_allgather_matches_jax(sp4_mesh):
    """`fast_allgather` and `fast_allgather_packed` (two tensors, one
    launch): every rank's gathered rows are JAX's, bit for bit."""
    x, y = _rand(60, WORLD * 2, 40), _rand(61, WORLD * 3, 5)
    ctx = jll.create_fast_allgather_context("sp", WORLD)
    fn = shard_map_op(
        lambda a, b: (jll.fast_allgather(a, ctx),
                      *jll.fast_allgather_packed([a, b], ctx)),
        sp4_mesh, in_specs=(P("sp", None), P("sp", None)),
        out_specs=(P(None, None),) * 3)
    want = jax.jit(fn)(x, y)
    tctx = ll.create_fast_allgather_context("sp", WORLD)
    assert tctx.method.value == "push_all"
    tx, ty = _t(x).reshape(WORLD, 2, 40), _t(y).reshape(WORLD, 3, 5)
    got = [ll.fast_allgather(tx, tctx),
           *ll.fast_allgather_packed([tx, ty], tctx)]
    for g, w in zip(got, want):
        for r in range(WORLD):
            np.testing.assert_array_equal(g[r].numpy(), np.asarray(w))


# ---- TPMLP fused_ar --------------------------------------------------------

@pytest.mark.parametrize("world", [1, 4])
def test_tp_mlp_fused_ar_matches_jax(devices, world):
    """test_layers.py::test_tp_mlp_fused_ar's setup (hidden 128, ffn 256,
    16 replicated rows, f32), the JAX global weights loaded with
    `TPMLP.load_jax_params`; every rank's copy is JAX's output at world 4.
    At world 1 the JAX layer's ``auto`` all-reduce takes RING, whose
    reduce-scatter leaves its output unwritten at world 1, so the port
    (one-shot there, a copy) is held to that test's golden, sum over ranks
    of gated_silu(x @ gate_up_r) @ down_r, in JAX."""
    from triton_distributed_tpu.kernels.allgather_group_gemm import (
        gated_silu)

    m, hidden, ffn = 16, 128, 256
    jmlp = JaxTPMLP(axis="tp", world_size=world, hidden=hidden, ffn=ffn,
                    mode="fused_ar")
    key = jax.random.key(2)
    ranks = [jmlp.init_params(jax.random.fold_in(key, r), jnp.float32)
             for r in range(world)]
    gate_up = np.concatenate([np.asarray(p["gate_up"]) for p in ranks], 1)
    down = np.concatenate([np.asarray(p["down"]) for p in ranks], 0)
    x = _rand(3, m, hidden, scale=0.125)
    if world > 1:
        fn = shard_map_op(
            lambda xx, gu, dn: jmlp(xx, {"gate_up": gu, "down": dn}),
            Mesh(np.array(devices[:world]), ("tp",)),
            in_specs=(P(None, None), P(None, "tp"), P("tp", None)),
            out_specs=P(None, None))
        want = jax.jit(fn)(x, gate_up, down)
    else:
        want = gated_silu(jnp.asarray(x) @ gate_up) @ down
    mlp = TPMLP(hidden, ffn, mode="fused_ar", world_size=world,
                dtype=torch.float32, device="cpu")
    mlp.load_jax_params({"gate_up": gate_up, "down": down})
    with torch.inference_mode():
        got = mlp(_t(x))
    if world == 1:
        _close(got, want, LAYER)
        return
    assert torch.equal(mlp.gate_up[1], _t(np.asarray(ranks[1]["gate_up"])))
    assert torch.equal(mlp.down[2], _t(np.asarray(ranks[2]["down"])))
    _every_rank(got, want, LAYER)
