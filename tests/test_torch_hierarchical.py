"""The port's two-level (dcn x ici) collectives (`kernels/hierarchical.py`,
`fast_allgather_2d`, `ag_gemm` / `gemm_rs` on a `HierarchicalContext`,
`sp_ag_attention_2d`, `HierarchicalEPAll2AllLayer`) against the JAX
package on the CPU.

The JAX side runs as tests/test_hierarchical.py and
tests/test_sp_attention.py run it: `shard_map` over the ``dcn2_ici4_mesh``
fixture (the 8 virtual CPU devices as (dcn 2, ici 4)), Pallas in
interpret mode.  The port holds every rank in one process: rank g = dcn *
4 + ici is row g of a rank-stacked tensor, and on CPU tensors each ICI
stage runs its kernel's plain version.  The same seeded numpy inputs go
to both.  Each JAX op runs once (a module-scoped result where several
tests read it); the port's other cases are held to a float64 numpy
reference or to its own flat layer.

Tolerances: the gathers and the exchanges copy bytes: bit for bit.  The
reductions in f32 within 1e-5 (the ICI stage's sum and the slices' sum in
another order than JAX's psum).  The GEMMs as the TP tests' f32 bound,
1e-5.  The attention within 1e-4 in f32 (the port's plain chunk schedule
against the JAX kernel's tiles).  The EP round trip through identity
experts within 1e-5, as tests/test_torch_ep.py; the two-level layer's
dispatch and combine bit for bit equal to the port's flat layer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.kernels import hierarchical as jhier
from triton_distributed_tpu.kernels.allgather_gemm import (
    ag_gemm as jax_ag_gemm)
from triton_distributed_tpu.kernels.gemm_reduce_scatter import (
    gemm_rs as jax_gemm_rs)
from triton_distributed_tpu.kernels.low_latency_allgather import (
    fast_allgather_2d as jax_fast_allgather_2d)
from triton_distributed_tpu.kernels.sp_ag_attention import (
    sp_ag_attention_2d as jax_sp_ag_attention_2d)
from triton_distributed_tpu.layers.ep_a2a_layer import (
    HierarchicalEPAll2AllLayer as JaxHierLayer)
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch.kernels import hierarchical as hier
from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp
from triton_distributed_tpu_torch.kernels.allgather_gemm import ag_gemm
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs
from triton_distributed_tpu_torch.kernels.low_latency_allgather import (
    fast_allgather_2d)
from triton_distributed_tpu_torch.layers import (
    EPAll2AllLayer, HierarchicalEPAll2AllLayer)
from triton_distributed_tpu_torch.parallel import make_hierarchical_mesh

DCN, ICI = 2, 4
WORLD = DCN * ICI
BOTH = ("dcn", "ici")
EXACT = dict(atol=0, rtol=0)
F32 = dict(atol=1e-5, rtol=1e-5)
ATTN = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def jax_observability_off(monkeypatch):
    monkeypatch.setenv("TDT_OBSERVABILITY", "0")


@pytest.fixture(autouse=True, scope="module")
def _fresh_observability_state():
    """Leave the JAX package's process-global flight ring, tracer,
    lineage and decision rings empty for the test files that run after
    this one in the same worker (as tests/test_torch_ep.py does)."""
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


def _rng(seed):
    return np.random.default_rng(seed)


def _hctx(dcn=DCN, ici=ICI, **kw):
    return hier.HierarchicalContext("ici", "dcn", ici, dcn, **kw)


def _jax_hctx(**kw):
    return jhier.HierarchicalContext(ici_axis="ici", dcn_axis="dcn",
                                     ici_size=ICI, dcn_size=DCN, **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- the JAX results read by several tests -----------------------------

@pytest.fixture(scope="module")
def jax_a2a(dcn2_ici4_mesh):
    """hierarchical_all_to_all with scales (cap 8, hidden 128, 8 scale
    columns), as the JAX test: the inputs and JAX's three outputs."""
    cap, hidden, ns = 8, 128, 8
    rng = _rng(3)
    send = rng.standard_normal((WORLD, WORLD, cap, hidden)).astype(np.float32)
    counts = rng.integers(1, cap + 1, (WORLD, WORLD, 1)).astype(np.int32)
    scales = rng.standard_normal((WORLD, WORLD, cap, ns)).astype(np.float32)
    fn = shard_map_op(
        lambda s, c, sc: jhier.hierarchical_all_to_all(
            s[0], c[0], _jax_hctx(), send_scales=sc[0]),
        dcn2_ici4_mesh,
        in_specs=(P(BOTH, None, None, None), P(BOTH, None, None),
                  P(BOTH, None, None, None)),
        out_specs=(P(BOTH, None, None), P(BOTH, None), P(BOTH, None, None)))
    want = [np.asarray(t) for t in jax.jit(fn)(send, counts, scales)]
    return (send, counts, scales), want


@pytest.fixture(scope="module")
def jax_all_gather(dcn2_ici4_mesh):
    """all_gather_2d and fast_allgather_2d of one (W*m, n) input."""
    x = _rng(0).standard_normal((WORLD * 8, 128)).astype(np.float32)
    outs = {}
    for name, op in (("all_gather_2d", jhier.all_gather_2d),
                     ("fast_allgather_2d", jax_fast_allgather_2d)):
        fn = shard_map_op(functools.partial(op, hctx=_jax_hctx())
                          if name == "fast_allgather_2d"
                          else functools.partial(op, ctx=_jax_hctx()),
                          dcn2_ici4_mesh, in_specs=P(BOTH, None),
                          out_specs=P(None, None))
        outs[name] = np.asarray(jax.jit(fn)(x))
    return x, outs


# ---- the collectives ---------------------------------------------------

@pytest.mark.parametrize("name", ["all_gather_2d", "fast_allgather_2d"])
def test_all_gather_2d_matches_jax(jax_all_gather, name):
    x, outs = jax_all_gather
    op = hier.all_gather_2d if name == "all_gather_2d" else fast_allgather_2d
    got = op(_t(x).reshape(WORLD, -1, 128), _hctx())
    assert got.shape == (WORLD, *outs[name].shape)
    for g in range(WORLD):
        np.testing.assert_allclose(got[g].numpy(), outs[name], **EXACT)


def test_reduce_scatter_2d_matches_jax(dcn2_ici4_mesh):
    x = _rng(1).standard_normal((WORLD, WORLD * 8, 128)).astype(np.float32)
    fn = shard_map_op(lambda xx: jhier.reduce_scatter_2d(xx[0], _jax_hctx()),
                      dcn2_ici4_mesh, in_specs=P(BOTH, None, None),
                      out_specs=P(BOTH, None))
    want = np.asarray(jax.jit(fn)(x))
    got = hier.reduce_scatter_2d(_t(x), _hctx())
    np.testing.assert_allclose(got.reshape(-1, 128).numpy(), want, **F32)


def test_all_reduce_2d_matches_jax(dcn2_ici4_mesh):
    """m = 10, off the ICI size: the pad branch."""
    x = _rng(2).standard_normal((WORLD, 10, 128)).astype(np.float32)
    fn = shard_map_op(lambda xx: jhier.all_reduce_2d(xx[0], _jax_hctx()),
                      dcn2_ici4_mesh, in_specs=P(BOTH, None, None),
                      out_specs=P(None, None))
    want = np.asarray(jax.jit(fn)(x))
    got = hier.all_reduce_2d(_t(x), _hctx())
    for g in range(WORLD):
        np.testing.assert_allclose(got[g].numpy(), want, **F32)


@pytest.mark.parametrize("with_scales", [False, True])
def test_hierarchical_all_to_all_matches_jax(jax_a2a, with_scales):
    """Tokens, counts (and scales) bit for bit; the JAX outputs are block
    [r, g] = what rank g sent to rank r, as the port's."""
    (send, counts, scales), want = jax_a2a
    got = hier.hierarchical_all_to_all(
        _t(send), _t(counts), _hctx(),
        send_scales=_t(scales) if with_scales else None)
    assert len(got) == (3 if with_scales else 2)
    shapes = [send.shape, counts.shape, scales.shape]
    for g, w, s in zip(got, want, shapes):
        np.testing.assert_allclose(g.numpy(), w.reshape(s), **EXACT)
    np.testing.assert_allclose(got[0].numpy(), send.swapaxes(0, 1), **EXACT)


@pytest.mark.parametrize("dcn,ici", [(2, 4), (4, 2), (2, 2), (2, 1)])
def test_hierarchical_collectives_against_float64(dcn, ici):
    world = dcn * ici
    rng = _rng(10 + world + dcn)
    ctx = _hctx(dcn, ici)
    x = rng.standard_normal((world, 6, 24)).astype(np.float32)
    xr = rng.standard_normal((world, world * 3, 24)).astype(np.float32)
    full = x.reshape(-1, 24)
    for op in (hier.all_gather_2d, fast_allgather_2d):
        got = op(_t(x), ctx)
        for g in range(world):
            np.testing.assert_allclose(got[g].numpy(), full, **EXACT)
    np.testing.assert_allclose(
        hier.reduce_scatter_2d(_t(xr), ctx).numpy(),
        xr.astype(np.float64).sum(0).reshape(world, 3, 24), **F32)
    got = hier.all_reduce_2d(_t(x[:, :5]), ctx)
    for g in range(world):
        np.testing.assert_allclose(got[g].numpy(),
                                   x[:, :5].astype(np.float64).sum(0), **F32)
    send = rng.standard_normal((world, world, 4, 8)).astype(np.float32)
    counts = rng.integers(0, 5, (world, world, 1)).astype(np.int32)
    tok, cnt = hier.hierarchical_all_to_all(_t(send), _t(counts), ctx)
    np.testing.assert_allclose(tok.numpy(), send.swapaxes(0, 1), **EXACT)
    np.testing.assert_allclose(cnt.numpy(), counts.swapaxes(0, 1), **EXACT)


@pytest.mark.parametrize("rs_method", ["scatter_reduce", "ring"])
def test_hierarchical_ici_methods_agree_in_f32(rs_method):
    x = _rng(50).standard_normal((WORLD, WORLD * 4, 16)).astype(np.float32)
    got = hier.reduce_scatter_2d(_t(x), _hctx(rs_method=rs_method))
    np.testing.assert_allclose(
        got.numpy(), x.astype(np.float64).sum(0).reshape(WORLD, 4, 16), **F32)


def test_create_hierarchical_context_from_mesh():
    mesh = make_hierarchical_mesh(2, 4, device="cpu")
    assert mesh.axes == ("dcn", "ici") and mesh.sizes == (2, 4)
    ctx = hier.create_hierarchical_context(mesh, "ici", "dcn")
    assert (ctx.dcn_size, ctx.ici_size, ctx.world_size) == (2, 4, 8)
    assert [mesh.rank_of((d, i)) for d in range(2) for i in range(4)] == \
        list(range(8))
    with pytest.raises(ValueError, match="rank-stacked"):
        hier.all_gather_2d(torch.zeros(4, 2, 3), ctx)


# ---- the two-level GEMMs -----------------------------------------------

def test_ag_gemm_2d_matches_jax(dcn2_ici4_mesh):
    """With the gathered A; b column-sharded (rank g's (k, n) block)."""
    m, k, n = 8, 64, 128
    rng = _rng(12)
    a = rng.standard_normal((WORLD * m, k)).astype(np.float32)
    b = (rng.standard_normal((k, WORLD * n)) / 8).astype(np.float32)
    fn = shard_map_op(
        lambda aa, bb: jax_ag_gemm(aa, bb, _jax_hctx(), return_gathered=True),
        dcn2_ici4_mesh, in_specs=(P(BOTH, None), P(None, BOTH)),
        out_specs=(P(None, BOTH), P(None, None)))
    want, want_g = (np.asarray(t) for t in jax.jit(fn)(a, b))
    bt = _t(b).reshape(k, WORLD, n).transpose(0, 1).contiguous()
    got, got_g = ag_gemm(_t(a).reshape(WORLD, m, k), bt, _hctx(),
                         return_gathered=True)
    for g in range(WORLD):
        np.testing.assert_allclose(got[g].numpy(),
                                   want[:, g * n:(g + 1) * n], **F32)
        np.testing.assert_allclose(got_g[g].numpy(), want_g, **EXACT)


def test_gemm_rs_2d_matches_jax(dcn2_ici4_mesh):
    mt, k, n = WORLD * 8, WORLD * 16, 128
    rng = _rng(14)
    a = rng.standard_normal((mt, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / 8).astype(np.float32)
    fn = shard_map_op(lambda aa, bb: jax_gemm_rs(aa, bb, _jax_hctx()),
                      dcn2_ici4_mesh, in_specs=(P(None, BOTH), P(BOTH, None)),
                      out_specs=P(BOTH, None))
    want = np.asarray(jax.jit(fn)(a, b))
    at = _t(a).reshape(mt, WORLD, 16).transpose(0, 1).contiguous()
    got = gemm_rs(at, _t(b).reshape(WORLD, 16, n), _hctx())
    np.testing.assert_allclose(got.reshape(mt, n).numpy(), want, **F32)


@pytest.mark.parametrize("dcn,ici,gemm_method", [
    (2, 4, "auto"), (2, 4, "ll"), (4, 2, "fused"), (2, 2, "xla"),
    (2, 1, "auto")])
def test_two_level_gemms_against_float64(dcn, ici, gemm_method):
    world = dcn * ici
    rng = _rng(60 + world)
    ctx = _hctx(dcn, ici, gemm_method=gemm_method)
    a = rng.standard_normal((world, 5, 32)).astype(np.float32)
    b = (rng.standard_normal((world, 32, 12)) / 4).astype(np.float32)
    out, g = ag_gemm(_t(a), _t(b), ctx, return_gathered=True)
    full = a.reshape(-1, 32).astype(np.float64)
    for r in range(world):
        np.testing.assert_allclose(out[r].numpy(), full @ b[r], **F32)
        np.testing.assert_allclose(g[r].numpy(), full, **EXACT)
    a2 = rng.standard_normal((world, world * 3, 32)).astype(np.float32)
    got = gemm_rs(_t(a2), _t(b), ctx)
    want = np.einsum("rmk,rkn->mn", a2.astype(np.float64), b)
    np.testing.assert_allclose(got.reshape(-1, 12).numpy(), want, **F32)


# ---- SP attention and the EP layer -------------------------------------

def test_sp_ag_attention_2d_matches_jax(dcn2_ici4_mesh):
    """GQA 2, 16 rows a rank, f32: the JAX test's case."""
    b, h, hkv, s_loc, d = 1, 4, 2, 16, 32
    s = WORLD * s_loc
    rng = _rng(6)
    q, k, v = ((rng.standard_normal((b, n_h, s, d)) / 4).astype(np.float32)
               for n_h in (h, hkv, hkv))
    fn = shard_map_op(
        functools.partial(jax_sp_ag_attention_2d, hctx=_jax_hctx(),
                          block_q=16, block_k=16),
        dcn2_ici4_mesh, in_specs=(P(None, None, BOTH, None),) * 3,
        out_specs=P(None, None, BOTH, None))
    want = np.asarray(jax.jit(fn)(q, k, v))

    def shards(x):
        return _t(x).reshape(b, x.shape[1], WORLD, s_loc, d).movedim(
            2, 0).contiguous()

    got = sp.sp_ag_attention_2d(shards(q), shards(k), shards(v), _hctx())
    np.testing.assert_allclose(
        got.movedim(0, 2).reshape(b, h, s, d).numpy(), want, **ATTN)


@pytest.mark.parametrize("dcn,ici", [(2, 2), (4, 2), (2, 1)])
def test_sp_ag_attention_2d_against_world_one(dcn, ici):
    world, s_loc, d = dcn * ici, 8, 32
    rng = _rng(70 + world)
    q = torch.from_numpy((rng.standard_normal((world, 1, 4, s_loc, d)) / 4)
                         .astype(np.float32))
    k, v = (torch.from_numpy((rng.standard_normal((world, 1, 2, s_loc, d))
                              / 4).astype(np.float32)) for _ in range(2))
    got = sp.sp_ag_attention_2d(q, k, v, _hctx(dcn, ici))
    want = sp.sp_ag_attention_fused(q, k, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATTN)


def _ep_case(experts, topk, n_loc, hidden, seed):
    rng = _rng(seed)
    tokens = rng.standard_normal((WORLD * n_loc, hidden)).astype(np.float32)
    ids = rng.integers(0, experts, (WORLD * n_loc, topk)).astype(np.int32)
    logits = rng.standard_normal((WORLD * n_loc, topk)).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return tokens, ids, w.astype(np.float32)


def test_hierarchical_ep_layer_matches_jax_and_flat(devices):
    """The JAX test's case (16 experts, top 2, 8 tokens a rank, blocks of
    32): the port's two-level round trip against the JAX two-level layer
    (1e-5), its dispatch and combine bit for bit the port's flat layer's."""
    E, topk, n_loc, hidden, cap = 16, 2, 8, 64, 32
    tokens, ids, w = _ep_case(E, topk, n_loc, hidden, 6)
    jlayer = JaxHierLayer(axis="ici", ep_size=WORLD, num_experts=E,
                          topk=topk, max_tokens_per_rank=cap, hidden=hidden,
                          dcn_axis="dcn", dcn_size=DCN)

    def ep_step(tok, eid, ww):
        recv, _, counts, plan = jlayer.dispatch(tok, eid)
        return jlayer.combine(recv, counts, plan, ww, eid)

    mesh = Mesh(np.array(devices).reshape(DCN, ICI), BOTH)
    fn = shard_map_op(ep_step, mesh, in_specs=(P(BOTH, None),) * 3,
                      out_specs=P(BOTH, None))
    want = np.asarray(jax.jit(fn)(tokens, ids, w))

    def stack(x):
        return _t(x).reshape(WORLD, n_loc, *x.shape[1:])

    two = HierarchicalEPAll2AllLayer("ici", WORLD, E, topk, cap, hidden,
                                     dcn_axis="dcn", dcn_size=DCN)
    flat = EPAll2AllLayer("ep", WORLD, E, topk, cap, hidden)
    t, i, ww = stack(tokens), stack(ids), stack(w)
    d2, d1 = two.dispatch(t, i), flat.dispatch(t, i)
    for a, b in zip(d2[:3], d1[:3]):
        assert torch.equal(a, b)
    got = two.combine(d2[0], d2[2], d2[3], ww, i)
    assert torch.equal(got, flat.combine(d1[0], d1[2], d1[3], ww, i))
    np.testing.assert_allclose(got.reshape(-1, hidden).numpy(), want, **F32)
    assert two.ici_size == ICI
