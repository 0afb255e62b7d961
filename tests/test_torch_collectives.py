"""The port's collective library at world W against the JAX package on the
CPU: every method of all_gather (K15), reduce_scatter (K16) and all_reduce
(K17), their fallbacks, the straggler contexts, barrier and broadcast
(K18), and `ops.*` against `triton_distributed_tpu.ops`.

The JAX side runs as tests/test_allreduce.py and its neighbours run it:
`shard_map` over the ``tp4_mesh`` or ``tp8_mesh`` fixture (virtual CPU
devices), Pallas in interpret mode.  The port holds every rank in one
process (`parallel.mesh`): rank r's data is row r of a rank-stacked
tensor, and on CPU tensors the wrappers run their plain versions, each in
its method's order and rounding.  The same seeded numpy inputs go to both.

Tolerances: copies (all_gather, broadcast, barrier) are exact in every
dtype.  Sums in f32 within 1e-5 (atol = rtol; the order of the sums is the
method's on both sides).  Sums in bf16 within one bf16 ulp (rtol 2^-7):
each method rounds at the same places as its JAX kernel (one-shot,
two-shot and scatter-reduce once after an f32 sum in rank order, the
rings and the chain at every hop), so only XLA's interpret-mode float
arithmetic could differ.  ``auto`` is held to JAX in f32 only, where every
method agrees within 1e-5: the two packages' byte rules differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu import ops as jax_ops
from triton_distributed_tpu.kernels import allgather as jag
from triton_distributed_tpu.kernels import allreduce as jar
from triton_distributed_tpu.kernels import common_ops as jcommon
from triton_distributed_tpu.kernels import reduce_scatter as jrs
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch import ops
from triton_distributed_tpu_torch.kernels import allgather as ag
from triton_distributed_tpu_torch.kernels import allreduce as ar
from triton_distributed_tpu_torch.kernels import common_ops
from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
from triton_distributed_tpu_torch.parallel import make_mesh

F32 = dict(atol=1e-5, rtol=1e-5)
BF16_SUM = dict(atol=0.0, rtol=2.0 ** -7)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


@pytest.fixture(scope="module")
def meshes(devices):
    return {w: Mesh(np.array(devices[:w]), ("tp",)) for w in (1, 4, 8)}


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _exact(got, want):
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(F32 if dtype == "float32" else BF16_SUM))


def _jax_all_gather(mesh, x, **kw):
    ctx = jag.AllGatherContext(axis="tp", world_size=mesh.shape["tp"], **kw)
    fn = shard_map_op(lambda xs: jag.all_gather(xs[0], ctx), mesh,
                      in_specs=P("tp", None, None), out_specs=P(None, None))
    return jax.jit(fn)(x)


def _jax_reduce_scatter(mesh, x, **kw):
    ctx = jrs.ReduceScatterContext(axis="tp", world_size=mesh.shape["tp"],
                                   **kw)
    fn = shard_map_op(lambda xs: jrs.reduce_scatter(xs[0], ctx), mesh,
                      in_specs=P("tp", None, None), out_specs=P("tp", None))
    return jax.jit(fn)(x)


def _jax_all_reduce(mesh, x, **kw):
    ctx = jar.AllReduceContext(axis="tp", world_size=mesh.shape["tp"], **kw)
    fn = shard_map_op(lambda xs: jar.all_reduce(xs[0], ctx), mesh,
                      in_specs=P("tp", None, None), out_specs=P(None, None))
    return jax.jit(fn)(x)


# ---- K15 all_gather --------------------------------------------------------

#: (method, world, rows a rank, columns, dtype): every method at world 4 in
#: f32 and bf16, the ring at world 8 in f32, the bidirectional ring on odd
#: rows (its fallback to the ring) and on columns off 8.
AG_CASES = ([(m, 4, 8, 128, dt) for m in ("ring", "push_all", "bidir_ring",
                                          "xla")
             for dt in ("float32", "bfloat16")]
            + [("ring", 8, 4, 128, "float32"),
               ("bidir_ring", 4, 5, 128, "bfloat16"),
               ("bidir_ring", 4, 6, 100, "float32")])


@pytest.mark.parametrize("method,world,m,n,dtype", AG_CASES)
def test_all_gather_matches_jax(meshes, method, world, m, n, dtype):
    """Every rank's gathered rows are JAX's, bit for bit."""
    jx, tx = _pair(_rand(world * 10 + m, world, m, n), dtype)
    want = _jax_all_gather(meshes[world], jx,
                           method=jag.AllGatherMethod(method))
    got = ag.all_gather(tx, ag.AllGatherContext("tp", world, method))
    assert got.dtype == tx.dtype and got.shape == (world, world * m, n)
    for r in range(world):
        _exact(got[r], want)


# ---- K16 reduce_scatter ----------------------------------------------------

RS_CASES = ([(m, 4, 8, 128, dt) for m in ("scatter_reduce", "ring")
             for dt in ("float32", "bfloat16")]
            + [("xla", 4, 8, 128, "float32"), ("ring", 8, 4, 128, "float32"),
               ("scatter_reduce", 4, 3, 100, "bfloat16")])


@pytest.mark.parametrize("method,world,m,n,dtype", RS_CASES)
def test_reduce_scatter_matches_jax(meshes, method, world, m, n, dtype):
    """Rank c's chunk of the sum, each method in its JAX kernel's order and
    rounding (the ring rounds at every hop)."""
    jx, tx = _pair(_rand(world * 20 + m, world, world * m, n), dtype)
    want = _jax_reduce_scatter(meshes[world], jx,
                               method=jrs.ReduceScatterMethod(method))
    got = rs.reduce_scatter(tx, rs.ReduceScatterContext("tp", world, method))
    assert got.dtype == tx.dtype and got.shape == (world, m, n)
    _close(got.reshape(world * m, n), want, dtype)


def test_reduce_scatter_methods_round_differently():
    """In bf16 the ring's per-hop rounding and scatter-reduce's one
    rounding differ on some element (why each method is held to its own
    JAX counterpart), and agree in f32 to the order of the sums."""
    x = torch.from_numpy(_rand(5, 4, 4 * 64, 128))
    ring, once = (rs.reduce_scatter_reference(x.bfloat16(), m)
                  for m in ("ring", "scatter_reduce"))
    assert not torch.equal(ring, once)
    torch.testing.assert_close(rs.reduce_scatter_reference(x, "ring"),
                               rs.reduce_scatter_reference(x), **F32)


# ---- K17 all_reduce --------------------------------------------------------

#: Every method at world 4 in f32 and bf16 (xla in f32), the ring and the
#: chain at world 8 in f32, and the fallbacks: two-shot and the ring on
#: rows that do not split over the ranks (one-shot), columns off 8.
AR_CASES = ([(m, 4, 16, 128, dt)
             for m in ("one_shot", "two_shot", "ring", "chain")
             for dt in ("float32", "bfloat16")]
            + [("xla", 4, 16, 128, "float32"),
               ("ring", 8, 16, 128, "float32"),
               ("chain", 8, 16, 128, "float32"),
               ("two_shot", 4, 6, 100, "bfloat16"),
               ("ring", 4, 6, 128, "float32")])


@pytest.mark.parametrize("method,world,m,n,dtype", AR_CASES)
def test_all_reduce_matches_jax(meshes, method, world, m, n, dtype):
    """Every rank's copy of the sum, each method in its JAX kernel's order
    and rounding."""
    jx, tx = _pair(_rand(world * 30 + m, world, m, n), dtype)
    want = _jax_all_reduce(meshes[world], jx,
                           method=jar.AllReduceMethod(method))
    ctx = ar.AllReduceContext("tp", world, method)
    got = ar.all_reduce(tx, ctx)
    assert got.dtype == tx.dtype and got.shape == (world, m, n)
    if m % world:
        assert ar.resolve(tx, ctx) == ar.AllReduceMethod.ONE_SHOT
    for r in range(world):
        _close(got[r], want, dtype)


def test_all_reduce_chain_world1(meshes):
    """At world 1 the chain returns x itself, as JAX does."""
    a = _rand(1, 1, 8, 128)
    want = _jax_all_reduce(meshes[1], jnp.asarray(a),
                           method=jar.AllReduceMethod.CHAIN)
    x = torch.from_numpy(a)
    got = ar.all_reduce(x, ar.AllReduceContext("tp", 1, "chain"))
    assert got is x
    _exact(got[0], want)


def test_all_reduce_orders_in_bf16():
    """The chain sums from rank W-1 down, rounding at every hop, and
    one-shot in rank order with one rounding: the plain versions follow
    their kernels, so in bf16 they differ, and in f32 they agree."""
    x = torch.from_numpy(_rand(6, 4, 64, 128))
    chain = ar.all_reduce_reference(x.bfloat16(), "chain")[0].float()
    hops = x[3].bfloat16()
    for r in (2, 1, 0):
        hops = (hops.float() + x[r].bfloat16().float()).bfloat16()
    assert torch.equal(chain, hops.float())
    assert not torch.equal(chain, ar.all_reduce_reference(
        x.bfloat16(), "one_shot")[0].float())
    torch.testing.assert_close(ar.all_reduce_reference(x, "chain"),
                               ar.all_reduce_reference(x), **F32)


# ---- fault injection, auto -------------------------------------------------

@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter",
                                "all_reduce"])
def test_straggler_contexts_match_jax(meshes, op):
    """The ring of each op (two-shot for all_reduce) with a straggler
    rank on the JAX side (its interpret-mode thread sleeps) and
    for_correctness where JAX has it: the same result as the port's (whose
    CPU plain version has nothing to wait for)."""
    world = 4
    a = _rand(40, world, 16, 128)
    fault = dict(straggler=(2, 200_000))
    if op == "all_gather":
        want = _jax_all_gather(meshes[world], jnp.asarray(a),
                               method=jag.AllGatherMethod.RING,
                               for_correctness=True, **fault)
        got = ag.all_gather(torch.from_numpy(a), ag.AllGatherContext(
            "tp", world, "ring", for_correctness=True, **fault))
        _exact(got[1], want)
    elif op == "reduce_scatter":
        want = _jax_reduce_scatter(meshes[world], jnp.asarray(a),
                                   method=jrs.ReduceScatterMethod.RING,
                                   **fault)
        got = rs.reduce_scatter(torch.from_numpy(a), rs.ReduceScatterContext(
            "tp", world, "ring", **fault))
        _close(got.reshape(16, 128), want, "float32")
    else:
        want = _jax_all_reduce(meshes[world], jnp.asarray(a),
                               method=jar.AllReduceMethod.TWO_SHOT, **fault)
        got = ar.all_reduce(torch.from_numpy(a), ar.AllReduceContext(
            "tp", world, "two_shot", for_correctness=True, **fault))
        _close(got[3], want, "float32")


def test_auto_rules():
    """The port's byte rules: push_all / one-shot up to their cutoffs,
    then ring / two-shot; the reduce-scatter's scatter at every size;
    one-shot at world 1; the chain and the ring all-reduce only
    when named."""
    c = ag.AllGatherContext("tp", 4)
    assert c.resolve_method(c.PUSH_ALL_MAX_BYTES).value == "push_all"
    assert c.resolve_method(c.PUSH_ALL_MAX_BYTES + 1).value == "ring"
    assert rs.ReduceScatterContext("tp", 4).resolve_method().value == (
        "scatter_reduce")
    assert rs.ReduceScatterContext("tp", 4, "ring").resolve_method().value \
        == "ring"
    cut = ar.ONE_SHOT_MAX_BYTES
    assert ar.get_auto_allreduce_method(cut, 4).value == "one_shot"
    assert ar.get_auto_allreduce_method(cut + 1, 4).value == "two_shot"
    assert ar.get_auto_allreduce_method(1 << 30, 1).value == "one_shot"
    for nbytes in (1, cut, 1 << 30):
        assert ar.get_auto_allreduce_method(nbytes, 8).value in (
            "one_shot", "two_shot")


# ---- K18 barrier and broadcast --------------------------------------------

def test_barrier_matches_jax(meshes):
    a = _rand(50, 4, 8, 128)
    fn = shard_map_op(lambda xs: jcommon.barrier_all_on_axis(xs, "tp"),
                      meshes[4], in_specs=P("tp", None, None),
                      out_specs=P("tp", None, None))
    want = jax.jit(fn)(jnp.asarray(a))
    got = common_ops.barrier_all_on_axis(torch.from_numpy(a), "tp")
    _exact(got, want)


@pytest.mark.parametrize("root", [0, 2])
def test_broadcast_matches_jax(meshes, root):
    """Every rank gets the root's shard (ops.broadcast on both sides: the
    JAX op shard_maps `common_ops.broadcast`), the root an int here and a
    0-d tensor there."""
    jx, tx = _pair(_rand(60 + root, 4 * 8, 128), "bfloat16")
    want = jax_ops.broadcast(jx, root, meshes[4])
    got = ops.broadcast(tx.reshape(4, 8, 128), torch.tensor(root),
                        make_mesh(4, device="cpu"))
    _exact(got.reshape(32, 128), want)


# ---- ops.* -----------------------------------------------------------------

def test_ops_collectives_match_jax(meshes):
    """ops.all_gather, reduce_scatter and all_reduce (auto, f32) on the
    rank-stacked forms of the JAX global arrays."""
    mesh, world = make_mesh(4, device="cpu"), 4
    a = _rand(70, 4 * 8, 128)
    want = jax_ops.all_gather(jnp.asarray(a), meshes[4])
    got = ops.all_gather(torch.from_numpy(a).reshape(world, 8, 128), mesh)
    for r in range(world):
        _exact(got[r], want)
    p = _rand(71, world, 32, 128)
    want = jax_ops.reduce_scatter(jnp.asarray(p), meshes[4])
    got = ops.reduce_scatter(torch.from_numpy(p), mesh)
    _close(got.reshape(32, 128), want, "float32")
    want = jax_ops.all_reduce(jnp.asarray(p), meshes[4])
    got = ops.all_reduce(torch.from_numpy(p), mesh)
    for r in range(world):
        _close(got[r], want, "float32")


def test_ops_gemms_match_jax(meshes):
    """ops.ag_gemm (A row-sharded, B column-sharded -> C column-sharded)
    and ops.gemm_rs (A and B sharded on K -> C row-sharded)."""
    from triton_distributed_tpu.kernels.matmul import MatmulConfig

    mesh, world, m, k, n = make_mesh(4, device="cpu"), 4, 32, 128, 256
    a = _rand(80, m, k)
    b = _rand(81, k, n) * k ** -0.5
    kw = dict(method="fused", gemm=MatmulConfig(32, 128, 128))
    want = jax_ops.ag_gemm(jnp.asarray(a), jnp.asarray(b), meshes[4], **kw)
    got = ops.ag_gemm(torch.from_numpy(a).reshape(world, m // world, k),
                      torch.from_numpy(b).reshape(k, world, -1).transpose(
                          0, 1).contiguous(), mesh, method="fused")
    np.testing.assert_allclose(
        got.transpose(0, 1).reshape(m, n).numpy(), _np(want), **F32)
    want = jax_ops.gemm_rs(jnp.asarray(a), jnp.asarray(b), meshes[4], **kw)
    got = ops.gemm_rs(torch.from_numpy(a).reshape(m, world, -1).transpose(
        0, 1).contiguous(), torch.from_numpy(b).reshape(world, -1, n), mesh,
        method="fused")
    np.testing.assert_allclose(got.reshape(m, n).numpy(), _np(want), **F32)


def test_ops_unported_raise():
    mesh = make_mesh(4, device="cpu")
    x = torch.zeros(4, 4, 8)
    # K19 is ported: ops.all_to_all exchanges the blocks (block [r, p] is
    # what rank p sent to rank r).
    send = torch.arange(4 * 4 * 2 * 8, dtype=torch.float32).reshape(4, 4, 2,
                                                                    8)
    counts = torch.arange(16, dtype=torch.int32).reshape(4, 4, 1)
    recv, rcounts = ops.all_to_all(send, counts, mesh)
    assert torch.equal(recv, send.transpose(0, 1))
    assert torch.equal(rcounts, counts.transpose(0, 1))
    for fn in (ops.ag_gemm_diff, ops.gemm_rs_diff):
        with pytest.raises(NotImplementedError, match="training duals"):
            fn(x, x, mesh)
    with pytest.raises(ValueError, match="axis"):
        ops.all_gather(x, mesh, axis="sp")
