"""The port's tensor parallelism at world W against the JAX package on the
CPU: AllGather-GEMM and GEMM-ReduceScatter (both methods), `TPMLP` in
``xla`` and ``fused``, `TPAttention` prefill, decode and paged decode, the
tiny `Qwen3` at world 4 (prefill logits, decode steps, paged decode) and
`Engine.serve` against the JAX `Engine` at world 4, and `Qwen3.reshard`
against the world-1 model.

The JAX side runs as tests/test_layers.py and tests/test_model_e2e.py run
it: `shard_map` over the 8 virtual CPU devices (the ``tp4_mesh`` and
``tp8_mesh`` fixtures, or their first two devices), Pallas in interpret
mode.  The port holds every rank in one process (`parallel.mesh`): its
shards are rank-stacked tensors, and on CPU tensors its kernel wrappers
run their plain versions.  The same seeded numpy inputs go to both.

Tolerances: f32 1e-5 for one product (the order of the sums), 1e-4
through a layer or a model; bf16 atol = rtol = 1e-2 for outputs of
magnitude about 1, one bf16 ulp there (2^-7): both sides round the same
f32 sums once to bf16, and GEMM-ReduceScatter's partials once before
their f32 sum, as the JAX kernels do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.kernels.allgather_gemm import (
    AllGatherGEMMContext as JaxAGContext)
from triton_distributed_tpu.kernels.allgather_gemm import (
    ag_gemm as jax_ag_gemm)
from triton_distributed_tpu.kernels.gemm_reduce_scatter import (
    GEMMReduceScatterContext as JaxRSContext)
from triton_distributed_tpu.kernels.gemm_reduce_scatter import (
    gemm_rs as jax_gemm_rs)
from triton_distributed_tpu.kernels.matmul import MatmulConfig
from triton_distributed_tpu.layers.tp_attn import (
    TPAttention as JaxTPAttention)
from triton_distributed_tpu.layers.tp_mlp import TPMLP as JaxTPMLP
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models.kv_cache import (
    PagedKVCache as JaxPagedKVCache)
from triton_distributed_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch import (
    ContinuousBatchingScheduler, Engine, ModelConfig, PagedKVCache, Qwen3)
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    AllGatherGEMMContext, ag_gemm, kernel_body, ll_tile_n)
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    GEMMReduceScatterContext, gemm_rs)
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP
from triton_distributed_tpu_torch.layers.tp_attn import TPAttention
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP
from triton_distributed_tpu_torch.parallel import make_mesh

F32 = dict(atol=1e-5, rtol=1e-5)
LAYER = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=1e-2, rtol=1e-2)
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def jax_observability_off(monkeypatch):
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


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()
    return {w: Mesh(np.array(devs[:w]), ("tp",)) for w in (2, 4)}


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


def _stack_columns(w, world):
    """JAX global (in, W * c) column shards -> the port's (W, in, c)."""
    return w.reshape(w.shape[0], world, -1).transpose(1, 0, 2).copy()


# ---- the kernels' wrappers: K12 and K14 ----------------------------------

#: (world, rows a rank, dtype): world 2 in f32, world 4 in bf16 on a row
#: count that pads to the row tile.
KERNEL_CASES = [(2, 16, "float32"), (4, 5, "bfloat16")]
#: K12 also at the decode shape: one row a rank at world 4 in bf16 (JAX
#: pads it to 16 rows; the port's Hopper body gathers the 4 rows alone).
AG_CASES = KERNEL_CASES + [(4, 1, "bfloat16")]
#: K14 also on chunks the Hopper body leaves unpadded: one row a chunk (a
#: decode step) and 37, at worlds 2 and 4 in bf16 (JAX pads both to 16
#: rows).
RS_CASES = KERNEL_CASES + [(w, mc, "bfloat16") for w in (2, 4)
                           for mc in (1, 37)]


@pytest.mark.parametrize("method", ["fused", "ll"])
@pytest.mark.parametrize("world,m,dtype", AG_CASES)
def test_ag_gemm_matches_jax(meshes, world, m, dtype, method):
    """out_r = all_gather(a) @ b_r on every rank, and the gathered A."""
    k, n = 128, 128
    _, jdt, tdt = DTYPES[dtype]
    a = _rand(1, world * m, k)
    b = _rand(2, k, world * n, scale=k ** -0.5)
    ctx = JaxAGContext(axis="tp", world_size=world, method=method,
                       interpret=True)
    fn = shard_map_op(
        lambda x, w: jax_ag_gemm(x, w, ctx, return_gathered=True),
        meshes[world], in_specs=(P("tp", None), P(None, "tp")),
        out_specs=(P(None, "tp"), P(None, "tp")))
    want, want_g = jax.jit(fn)(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    out, gathered = ag_gemm(
        _t(a, tdt).reshape(world, m, k), _t(_stack_columns(b, world), tdt),
        AllGatherGEMMContext("tp", world, method), return_gathered=True)
    assert out.dtype == tdt and out.shape == (world, world * m, n)
    tol = F32 if dtype == "float32" else BF16
    for r in range(world):
        _close(out[r], np.asarray(want, np.float32)[:, r * n:(r + 1) * n],
               tol)
        _close(gathered[r],
               np.asarray(want_g, np.float32)[:, r * k:(r + 1) * k], F32)


def test_ag_gemm_body_by_operand():
    """K12's body follows the operands alone: bf16 on 16-byte rows takes
    the Hopper body, bf16 off them (k or n not a multiple of 8, or an
    operand off 16-byte alignment) the `mma.sync` tile, f32 the f32 tile."""
    bf16 = torch.bfloat16
    a, b = torch.zeros(4, 1, 4096, dtype=bf16), torch.zeros(4, 4096, 1536,
                                                           dtype=bf16)
    assert kernel_body(a, b) == "wgmma"
    assert kernel_body(a.float(), b.float()) == "f32"
    assert kernel_body(torch.zeros(3, 5, 100, dtype=bf16),
                       torch.zeros(3, 100, 77, dtype=bf16)) == "mma"
    assert kernel_body(torch.zeros(3, 5, 100, dtype=bf16),
                       torch.zeros(3, 100, 72, dtype=bf16)) == "mma"
    flat = torch.zeros(4 * 4096 + 1, dtype=bf16)
    assert kernel_body(flat[1:].view(4, 1, 4096), b) == "mma"


@pytest.mark.parametrize("n,blocks,want", [
    (1536, 33, 64), (6144, 33, 256), (1536, 16, 256), (4096, 66, 64),
    (2112, 33, 64), (2120, 33, 256), (4096, 33, 256), (4096, 16, 256),
    (4096, 132, 64)])
def test_ag_gemm_ll_tile_n(n, blocks, want):
    """The decode form's tile width: narrow (64) while its column tiles fit
    one wave of the rank's blocks.  Qwen3-8B's QKV (n 1536) and gate_up
    (6144) slices at world 4 (33 blocks a rank), 8 (16) and 2 (66); 4096
    columns at world 4, 8, 2 and on one rank's 132; and the edge at 33
    blocks: 33 narrow tiles, then 34."""
    assert ll_tile_n(n, blocks) == want


@pytest.mark.parametrize("method", ["fused", "ll"])
@pytest.mark.parametrize("world,mc,dtype", RS_CASES)
def test_gemm_rs_matches_jax(meshes, world, mc, dtype, method):
    """Rank c gets row chunk c of sum_r a_r @ b_r; the partials rounded
    to the activations' dtype before their f32 sum on both sides."""
    k, n = 128, 128
    _, jdt, tdt = DTYPES[dtype]
    mt = world * mc
    a = _rand(3, mt, world * k)
    b = _rand(4, world * k, n, scale=(world * k) ** -0.5)
    ctx = JaxRSContext(axis="tp", world_size=world, method=method,
                       interpret=True)
    fn = shard_map_op(lambda x, w: jax_gemm_rs(x, w, ctx), meshes[world],
                      in_specs=(P(None, "tp"), P("tp", None)),
                      out_specs=P("tp", None))
    want = jax.jit(fn)(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    got = gemm_rs(_t(_stack_columns(a, world), tdt),
                  _t(b, tdt).reshape(world, k, n),
                  GEMMReduceScatterContext("tp", world, method))
    assert got.dtype == tdt and got.shape == (world, mc, n)
    _close(got.reshape(mt, n), want, F32 if dtype == "float32" else BF16)


# ---- layers at world W ---------------------------------------------------

@pytest.mark.parametrize("mode", ["xla", "fused"])
@pytest.mark.parametrize("world", [2, 4])
def test_tp_mlp_matches_jax(meshes, world, mode):
    """`TPMLP` at world W on the JAX world-W weights (gate_up as [gate_r |
    up_r] a rank)."""
    hidden, ffn, m = 128, 256, 32
    x = _rand(5, m, hidden, scale=0.125)
    gate_up = _rand(6, hidden, 2 * ffn, scale=hidden ** -0.5)
    down = _rand(7, ffn, hidden, scale=hidden ** -0.5)
    jmlp = JaxTPMLP(axis="tp", world_size=world, hidden=hidden, ffn=ffn,
                    mode=mode, gemm=MatmulConfig(64, 128, 128),
                    interpret=True)
    fn = shard_map_op(
        lambda xx, gu, dn: jmlp(xx, {"gate_up": gu, "down": dn}),
        meshes[world],
        in_specs=(P("tp", None), P(None, "tp"), P("tp", None)),
        out_specs=P("tp", None))
    want = jax.jit(fn)(jnp.asarray(x), jnp.asarray(gate_up),
                       jnp.asarray(down))
    mlp = TPMLP(hidden, ffn, mode=mode, world_size=world,
                dtype=torch.float32, device="cpu")
    mlp.gate_up.copy_(_t(_stack_columns(gate_up, world)))
    mlp.down.copy_(_t(down).reshape(world, -1, hidden))
    got = mlp(_t(x).reshape(world, m // world, hidden))
    _close(got.reshape(m, hidden), want, LAYER)


#: The attention layer at world 2 in fused mode and at world 4 in xla mode;
#: the world-4 model below runs both modes.
ATTN_CASES = [(2, "fused"), (4, "xla")]


def _attn_pair(world, mode, seed):
    """A JAX `TPAttention` at world W and the port's on the same global
    weights, with non-trivial q/k norms."""
    hidden, heads, kv_heads, d = 128, 8, 4, 16
    jattn = JaxTPAttention(axis="tp", world_size=world, hidden=hidden,
                           num_heads=heads, num_kv_heads=kv_heads,
                           head_dim=d, qk_norm=True, mode=mode,
                           gemm=MatmulConfig(32, 64, 128), interpret=True)
    wqkv = _rand(seed, hidden, world * jattn.qkv_cols, scale=hidden ** -0.5)
    wo = _rand(seed + 1, heads * d, hidden, scale=hidden ** -0.5)
    qn = 1 + 0.1 * _rand(seed + 2, d)
    kn = 1 + 0.1 * _rand(seed + 3, d)
    params = {"wqkv": jnp.asarray(wqkv), "wo": jnp.asarray(wo),
              "q_norm": jnp.asarray(qn), "k_norm": jnp.asarray(kn)}
    attn = TPAttention(hidden, heads, kv_heads, d, world_size=world,
                       mode=mode, dtype=torch.float32, device="cpu")
    attn.wqkv.copy_(_t(_stack_columns(wqkv, world)))
    attn.wo.copy_(_t(wo).reshape(world, -1, hidden))
    attn.q_norm.copy_(_t(qn))
    attn.k_norm.copy_(_t(kn))
    specs = {"wqkv": P(None, "tp"), "wo": P("tp", None), "q_norm": P(None),
             "k_norm": P(None)}
    return jattn, params, specs, attn


@pytest.mark.parametrize("world,mode", ATTN_CASES)
def test_tp_attn_prefill_matches_jax(meshes, world, mode):
    """Prefill out (rows sharded) and the K/V for the cache (heads
    sharded, the global (B, Hkv, S, D) on the port's side)."""
    jattn, params, specs, attn = _attn_pair(world, mode, 10)
    b, s = 2, 16
    x = _rand(9, b * s, 128, scale=0.125)
    fn = shard_map_op(lambda xx, p: jattn.prefill(xx, p, batch=b),
                      meshes[world], in_specs=(P("tp", None), specs),
                      out_specs=(P("tp", None),
                                 (P(None, "tp", None, None),) * 2))
    want, (wk, wv) = jax.jit(fn)(jnp.asarray(x), params)
    got, (k, v) = attn.prefill(_t(x).reshape(world, -1, 128), b)
    _close(got.reshape(b * s, 128), want, LAYER)
    _close(k, wk, LAYER)
    _close(v, wv, LAYER)


@pytest.mark.parametrize("world,mode", ATTN_CASES)
def test_tp_attn_decode_matches_jax(meshes, world, mode):
    """Mid-sequence decode over a random cache at per-row offsets: out,
    and the cache written in place at each row's offset."""
    jattn, params, specs, attn = _attn_pair(world, mode, 20)
    b, s_max = 4, 32
    x = _rand(11, b, 128, scale=0.125)
    kc = _rand(12, b, 4, s_max, 16, scale=0.25)
    vc = _rand(13, b, 4, s_max, 16, scale=0.25)
    offset = np.array([5, 3, 7, 0], np.int32)

    def step(xx, p, k_, v_):
        out, (nk, nv), _ = jattn.decode(xx, p, (k_, v_), jnp.asarray(offset))
        return out, nk, nv

    cspec = P(None, "tp", None, None)
    fn = shard_map_op(step, meshes[world],
                      in_specs=(P("tp", None), specs, cspec, cspec),
                      out_specs=(P("tp", None), cspec, cspec))
    want, wk, wv = jax.jit(fn)(jnp.asarray(x), params, jnp.asarray(kc),
                               jnp.asarray(vc))
    k, v = _t(kc), _t(vc)
    got = attn.decode(_t(x).reshape(world, -1, 128), (k, v),
                      torch.from_numpy(offset))
    _close(got.reshape(b, 128), want, LAYER)
    _close(k, wk, LAYER)
    _close(v, wv, LAYER)


@pytest.mark.parametrize("world,mode", ATTN_CASES)
def test_tp_attn_decode_paged_matches_jax(meshes, world, mode):
    """Paged decode over shuffled pages: out, and the pools written in
    place at each row's page and slot."""
    jattn, params, specs, attn = _attn_pair(world, mode, 30)
    b, ps, t, pages = 4, 8, 3, 13
    x = _rand(14, b, 128, scale=0.125)
    kp = _rand(15, pages, 4, ps, 16, scale=0.25)
    vp = _rand(16, pages, 4, ps, 16, scale=0.25)
    table = (1 + np.random.default_rng(17).permutation(pages - 1)[:b * t]
             ).reshape(b, t).astype(np.int32)
    offset = np.array([9, 0, 17, 4], np.int32)

    def step(xx, p, k_, v_):
        out, (nk, nv), _ = jattn.decode_paged(
            xx, p, (k_, v_), jnp.asarray(table), jnp.asarray(offset))
        return out, nk, nv

    pspec = P(None, "tp", None, None)
    fn = shard_map_op(step, meshes[world],
                      in_specs=(P("tp", None), specs, pspec, pspec),
                      out_specs=(P("tp", None), pspec, pspec))
    want, wk, wv = jax.jit(fn)(jnp.asarray(x), params, jnp.asarray(kp),
                               jnp.asarray(vp))
    k, v = _t(kp), _t(vp)
    got = attn.decode_paged(_t(x).reshape(world, -1, 128), (k, v),
                            torch.from_numpy(table),
                            torch.from_numpy(offset))
    _close(got.reshape(b, 128), want, LAYER)
    _close(k, wk, LAYER)
    _close(v, wv, LAYER)


# ---- the tiny Qwen3 at world 4 -------------------------------------------

@pytest.fixture(scope="module", params=["fused", "xla"])
def tp_pair(request, tp4_mesh):
    """(a JAX `Engine` over the JAX Qwen3 at world 4, its params, the
    port's world-4 Qwen3 on the same pytree), f32, in mode
    ``request.param``.  The test of logits runs its prefill through the
    `Engine`, so `serve` reuses that compiled prefill (at the model's
    default cache length)."""
    jm = JaxQwen3(JaxConfig.tiny(dtype="float32"), tp4_mesh,
                  mode=request.param, interpret=True)
    params = jm.init_params(jax.random.key(0))
    tm = Qwen3(ModelConfig.tiny(dtype="float32"), request.param,
               mesh=make_mesh(4, device="cpu")).load_jax_params(
                   jax.tree.map(np.asarray, params))
    return JaxEngine(jm, temperature=0.0), params, tm


def test_qwen3_tp_logits_match_jax(tp_pair):
    """Prefill logits and 3 decode steps (the argmax fed back), and the
    caches; then 2 paged decode steps over the same K/V in shuffled
    pages."""
    engine, params, tm = tp_pair
    jm = engine.model
    b, s = 4, 16
    ids = np.random.default_rng(21).integers(0, 256, (b, s), dtype=np.int32)
    logits_j, cache_j = engine.prefill(params, jnp.asarray(ids),
                                       jm.create_cache(b))
    cache_t = tm.create_cache(b)
    _close(tm.prefill(torch.from_numpy(ids), cache_t), logits_j, LAYER)
    decode_j = jax.jit(jm.make_decode_fn())
    toks = np.argmax(np.asarray(logits_j), -1).astype(np.int32)
    for _ in range(3):
        logits_j, cache_j = decode_j(params, jnp.asarray(toks), cache_j)
        _close(tm.decode(torch.from_numpy(toks), cache_t), logits_j, LAYER)
        toks = np.argmax(np.asarray(logits_j), -1).astype(np.int32)
    for a, b_ in zip(cache_t.ks + cache_t.vs, cache_j.ks + cache_j.vs):
        _close(a, b_, LAYER)

    # Paged: the dense caches' first 32 positions scattered over shuffled
    # pages of 8, then two steps on both sides.
    ps, t, pages = 8, 4, 1 + b * 4
    table = (1 + np.random.default_rng(22).permutation(pages - 1)
             ).reshape(b, t).astype(np.int32)
    jc = JaxPagedKVCache.create(num_layers=2, num_pages=pages, batch=b,
                                num_kv_heads=4, page_size=ps, head_dim=16,
                                max_pages_per_seq=t, dtype=jnp.float32)
    tc = PagedKVCache.create(2, pages, b, 4, ps, 16, t, torch.float32,
                             device="cpu")

    def to_pages(dense):                      # (B, Hkv, S, D) -> pool
        pool = np.zeros((pages, 4, ps, 16), np.float32)
        blocks = dense[:, :, :t * ps].reshape(b, 4, t, ps, 16).transpose(
            0, 2, 1, 3, 4)
        pool[table.reshape(-1)] = blocks.reshape(b * t, 4, ps, 16)
        return pool

    ks = [to_pages(np.asarray(k)) for k in cache_j.ks]
    vs = [to_pages(np.asarray(v)) for v in cache_j.vs]
    jc = JaxPagedKVCache(ks=[jnp.asarray(p) for p in ks],
                         vs=[jnp.asarray(p) for p in vs],
                         page_table=jc.page_table, offset=jc.offset,
                         page_size=ps).with_page_table(table.copy())
    jc = jc.set_offset(s + 3)
    for i in range(2):
        tc.ks[i].copy_(torch.from_numpy(ks[i]))
        tc.vs[i].copy_(torch.from_numpy(vs[i]))
    tc.with_page_table(table)
    tc.set_offset(s + 3)
    paged_j = jax.jit(jm.make_paged_decode_fn(page_size=ps))
    for _ in range(2):
        logits_j, jc = paged_j(params, jnp.asarray(toks), jc)
        _close(tm.decode_paged(torch.from_numpy(toks), tc), logits_j, LAYER)
        toks = np.argmax(np.asarray(logits_j), -1).astype(np.int32)


def test_engine_serve_tp_matches_jax(tp_pair):
    """Greedy `Engine.serve` at world 4: the JAX `Engine`'s tokens."""
    engine, params, tm = tp_pair
    b, s, gen = 4, 16, 4
    ids = np.random.default_rng(23).integers(0, 256, (b, s), dtype=np.int32)
    want = np.asarray(engine.serve(params, jnp.asarray(ids), gen))
    got = Engine(tm).serve(torch.from_numpy(ids), gen)
    assert got.dtype == torch.int32 and got.shape == (b, gen)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- within the port -----------------------------------------------------

@pytest.mark.parametrize("world,mode,int8", [
    (2, "fused", False), (4, "fused", False), (2, "xla", False),
    (4, "xla", False), (4, "fused", True)])
def test_reshard_matches_world1(world, mode, int8):
    """A world-1 tiny model and its `reshard` at world W: prefill logits
    and 3 decode steps within 1e-4 (f32: only the order of the sums
    differs), the same greedy tokens, and the world-1 layout back from
    `to_jax_params`; also with an int8 KV cache."""
    cfg = ModelConfig.tiny(dtype="float32", quantize_kv_cache=int8)
    m1 = Qwen3(cfg, mode, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    mw = m1.reshard(world)
    assert mw.world_size == world and mw.mesh.device == torch.device("cpu")
    ids = torch.randint(0, cfg.vocab_size, (4, 16),
                        generator=torch.Generator().manual_seed(1))
    c1, cw = m1.create_cache(4, 32), mw.create_cache(4, 32)
    torch.testing.assert_close(mw.prefill(ids, cw), m1.prefill(ids, c1),
                               **LAYER)
    toks = torch.zeros(4, dtype=torch.int32)
    for _ in range(3):
        want = m1.decode(toks, c1)
        torch.testing.assert_close(mw.decode(toks, cw), want, **LAYER)
        toks = want.argmax(-1).to(torch.int32)
    assert torch.equal(Engine(mw).serve(ids, 4), Engine(m1).serve(ids, 4))
    # The JAX world-W pytree of the resharded model loads back unchanged.
    tree = mw.to_jax_params()
    again = Qwen3(cfg, mode, mesh=make_mesh(world, device="cpu"))
    again.load_jax_params(tree)
    for (name, a), b in zip(mw.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name


def test_unported_at_world_above_one_raises():
    """What world > 1 still lacks raises, naming its kernel; decode needs
    a batch the ranks split; the scheduler refuses a world-4 model.  The
    MoE layers (K10, K11) and the w8a8 mode (K13) run at world 2."""
    mesh = make_mesh(2, device="cpu")
    moe = Qwen3(ModelConfig.tiny_moe(), mesh=mesh)
    assert moe.layers[0].mlp.world_size == 2
    assert MoEMLP(64, 32, 4, world_size=2, device="cpu").down.shape == (
        2, 4, 16, 64)
    w8 = TPMLP(64, 32, mode="w8a8", world_size=2, device="cpu")
    w8.init_params(torch.Generator().manual_seed(0))
    assert w8.gate_up_q.shape == (2, 64, 32) and w8.down_scale.shape == (2,
                                                                         64)
    assert w8(torch.zeros(2, 3, 64, dtype=torch.bfloat16)).shape == (2, 3, 64)
    # fused_ar runs on K17 now: it builds at world 2 and sums its ranks.
    ar = TPMLP(64, 32, mode="fused_ar", world_size=2, dtype=torch.float32,
               device="cpu")
    assert ar.gate_up.shape == (2, 64, 32) and ar.down.shape == (2, 16, 64)
    assert ar(torch.zeros(3, 64)).shape == (2, 3, 64)
    m = Qwen3(ModelConfig.tiny(dtype="float32"), mesh=mesh).init_params(
        torch.Generator().manual_seed(0))
    m.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training duals"):
        m(torch.zeros(2, 8, dtype=torch.long))
    with pytest.raises(ValueError, match="does not split"):
        m.decode(torch.zeros(3, dtype=torch.int32), m.create_cache(3))
    with pytest.raises(NotImplementedError, match="scheduler"):
        ContinuousBatchingScheduler(m)
    with pytest.raises(ValueError, match="not the mesh's"):
        Qwen3(ModelConfig.tiny(), device="cuda", mesh=mesh)
