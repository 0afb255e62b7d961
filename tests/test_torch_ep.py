"""The port's expert-parallel AllToAll against the JAX package on the CPU:
`fast_all_to_all` (K19's plain version) with and without scales at world
4 and 8, `all_to_all_post_process`, `ops.all_to_all`, and
`EPAll2AllLayer`'s dispatch and combine, capacity drops included.

The JAX side runs as tests/test_all_to_all.py and tests/test_layers.py run
it: `shard_map` over the ``ep4_mesh`` / ``tp8_mesh`` fixtures (virtual CPU
devices), Pallas in interpret mode.  The port holds every rank in one
process (`parallel.mesh`): rank r's blocks are row r of a rank-stacked
tensor, and on CPU tensors the kernel's plain version runs.  The same
seeded numpy inputs go to both.

Tolerances: the exchange and the dispatch copy bytes, so they are held bit
for bit (atol = rtol = 0): tokens, counts, scales and the received expert
ids, every row of every capacity block (rows past a count are zeros on
both sides).  The round trip through identity experts sums each token's
top-k weighted copies in f32 on both sides in the same order: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu import ops as jax_ops
from triton_distributed_tpu.kernels import low_latency_all_to_all as ja2a
from triton_distributed_tpu.layers.ep_a2a_layer import (
    EPAll2AllLayer as JaxEPLayer)
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch import ops
from triton_distributed_tpu_torch.kernels import low_latency_all_to_all as a2a
from triton_distributed_tpu_torch.layers import EPAll2AllLayer
from triton_distributed_tpu_torch.parallel import make_mesh

EXACT = dict(atol=0, rtol=0)
ROUNDTRIP = dict(atol=1e-5, rtol=1e-5)


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


def _rng(seed):
    return np.random.default_rng(seed)


def _payloads(world, cap, hidden, ns, seed):
    rng = _rng(seed)
    send = rng.standard_normal((world, world, cap, hidden)).astype(np.float32)
    counts = rng.integers(1, cap + 1, (world, world, 1)).astype(np.int32)
    scales = (rng.standard_normal((world, world, cap, ns)).astype(np.float32)
              if ns else None)
    return send, counts, scales


def _jax_a2a(mesh, world, send, counts, scales):
    axis = list(mesh.axis_names)[0]
    cap, hidden = send.shape[2:]
    ctx = ja2a.AllToAllContext(axis=axis, world_size=world,
                               max_tokens_per_rank=cap, hidden=hidden)
    spec4, spec3 = P(axis, None, None, None), P(axis, None, None)
    if scales is None:
        fn = shard_map_op(lambda s, c: ja2a.fast_all_to_all(s[0], c[0], ctx),
                          mesh, in_specs=(spec4, spec3),
                          out_specs=(spec3, P(axis, None)))
        out = jax.jit(fn)(send, counts)
    else:
        fn = shard_map_op(
            lambda s, c, sc: ja2a.fast_all_to_all(s[0], c[0], ctx,
                                                  send_scales=sc[0]),
            mesh, in_specs=(spec4, spec3, spec4),
            out_specs=(spec3, P(axis, None), spec3))
        out = jax.jit(fn)(send, counts, scales)
    shapes = [send.shape, counts.shape] + (
        [] if scales is None else [scales.shape])
    return [np.asarray(o).reshape(s) for o, s in zip(out, shapes)]


@pytest.mark.parametrize("with_scales", [False, True])
@pytest.mark.parametrize("world,mesh_name", [(4, "ep4_mesh"), (8, "tp8_mesh")])
def test_fast_all_to_all_matches_jax(request, world, mesh_name, with_scales):
    """Tokens, counts and scales bit for bit: block [r, p] of the result is
    what rank p sent to rank r, on both sides."""
    mesh = request.getfixturevalue(mesh_name)
    send, counts, scales = _payloads(world, 8, 128, 3 if with_scales else 0,
                                     world + 10 * with_scales)
    want = _jax_a2a(mesh, world, send, counts, scales)
    ctx = a2a.create_all_to_all_context("ep", world, 8, 128)
    got = a2a.fast_all_to_all(
        torch.from_numpy(send), torch.from_numpy(counts), ctx,
        send_scales=None if scales is None else torch.from_numpy(scales))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **EXACT)
    np.testing.assert_array_equal(got[0].numpy(), send.swapaxes(0, 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_fast_all_to_all_is_bytes(dtype):
    """Any payload dtype comes back as the two rank axes swapped, with the
    xla method the same as auto (the plain version on the CPU)."""
    world, cap, hidden = 4, 5, 24
    g = torch.Generator().manual_seed(3)
    send = (torch.randn(world, world, cap, hidden, generator=g) * 50).to(dtype)
    counts = torch.randint(0, cap + 1, (world, world, 1), generator=g,
                           dtype=torch.int32)
    scales = torch.randn(world, world, cap, 1, generator=g)
    for method in a2a.METHODS:
        ctx = a2a.AllToAllContext("ep", world, cap, hidden, method=method)
        recv, rcounts, rscales = a2a.fast_all_to_all(send, counts, ctx,
                                                     send_scales=scales)
        assert torch.equal(recv, send.transpose(0, 1))
        assert torch.equal(rcounts, counts.transpose(0, 1))
        assert torch.equal(rscales, scales.transpose(0, 1))
        assert recv.dtype == dtype and recv.is_contiguous()


def test_fast_all_to_all_rejects_bad_operands():
    ctx = a2a.AllToAllContext("ep", 4, 8, 16)
    send = torch.zeros(4, 4, 8, 16)
    with pytest.raises(ValueError, match="int32"):
        a2a.fast_all_to_all(send, torch.zeros(4, 4, 1), ctx)
    with pytest.raises(ValueError, match="want send"):
        a2a.fast_all_to_all(send[:2], torch.zeros(2, 4, 1, dtype=torch.int32),
                            ctx)
    with pytest.raises(ValueError, match="scales"):
        a2a.fast_all_to_all(send, torch.zeros(4, 4, 1, dtype=torch.int32),
                            ctx, send_scales=torch.zeros(4, 4, 7, 1))
    with pytest.raises(ValueError, match="method"):
        a2a.fast_all_to_all(send, torch.zeros(4, 4, 1, dtype=torch.int32),
                            a2a.AllToAllContext("ep", 4, 8, 16, method="ll"))


@pytest.mark.parametrize("counts", [[2, 3], [0, 4], [4, 4], [3, 0],
                                    [6, 1], [1, 9]])
def test_post_process_matches_jax(counts):
    """Dense compaction, exact: the JAX test's case and edges (an empty
    block, full blocks, counts past the capacity)."""
    world, cap, hidden = 2, 4, 8
    recv = np.arange(world * cap * hidden, dtype=np.float32).reshape(
        world, cap, hidden) + 1
    rc = np.asarray(counts, np.int32).reshape(world, 1)
    want, want_total = ja2a.all_to_all_post_process(jnp.asarray(recv),
                                                    jnp.asarray(rc), cap)
    got, total = a2a.all_to_all_post_process(torch.from_numpy(recv),
                                             torch.from_numpy(rc), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(total) == int(want_total) and total.dtype == torch.int32


@pytest.mark.parametrize("with_scales", [False, True])
def test_ops_all_to_all_matches_jax(ep4_mesh, with_scales):
    world = 4
    send, counts, scales = _payloads(world, 6, 32, 2 if with_scales else 0,
                                     40 + with_scales)
    want = jax_ops.all_to_all(
        jnp.asarray(send), jnp.asarray(counts), ep4_mesh,
        send_scales=None if scales is None else jnp.asarray(scales))
    got = ops.all_to_all(
        torch.from_numpy(send), torch.from_numpy(counts),
        make_mesh(world, axis="ep", device="cpu"),
        send_scales=None if scales is None else torch.from_numpy(scales))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EXACT)


def _ep_case(ep, experts, topk, n_loc, hidden, seed):
    rng = _rng(seed)
    tokens = rng.standard_normal((ep * n_loc, hidden)).astype(np.float32)
    ids = rng.integers(0, experts, (ep * n_loc, topk)).astype(np.int32)
    logits = rng.standard_normal((ep * n_loc, topk)).astype(np.float32)
    w = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return tokens, ids, w.astype(np.float32)


def _layers(ep, experts, topk, cap, hidden):
    kw = dict(ep_size=ep, num_experts=experts, topk=topk,
              max_tokens_per_rank=cap, hidden=hidden)
    return JaxEPLayer(axis="ep", **kw), EPAll2AllLayer(axis="ep", **kw)


def _stack(x, ep):
    return torch.from_numpy(x).reshape(ep, -1, *x.shape[1:])


# (experts, topk, tokens a rank, capacity): the JAX layer test's setup,
# and a capacity small enough that pairs drop.
EP_CASES = [(8, 2, 8, 32), (8, 2, 12, 3), (16, 4, 6, 5)]


@pytest.mark.parametrize("experts,topk,n_loc,cap", EP_CASES)
def test_ep_dispatch_matches_jax(ep4_mesh, experts, topk, n_loc, cap):
    """recv_tokens, recv_expert and recv_counts bit for bit, every slot of
    every block (the capacity drops and stable slots of `route_capacity`
    on both sides)."""
    ep, hidden = 4, 64
    tokens, ids, _ = _ep_case(ep, experts, topk, n_loc, hidden, experts + cap)
    jlayer, layer = _layers(ep, experts, topk, cap, hidden)

    def dispatch(tok, eid):
        recv, recv_e, counts, _ = jlayer.dispatch(tok, eid)
        return recv, recv_e, counts

    fn = shard_map_op(dispatch, ep4_mesh,
                      in_specs=(P("ep", None), P("ep", None)),
                      out_specs=(P("ep", None, None), P("ep", None),
                                 P("ep", None)))
    want = jax.jit(fn)(tokens, ids)
    got = layer.dispatch(_stack(tokens, ep), _stack(ids, ep))
    shapes = [(ep, ep, cap, hidden), (ep, ep, cap), (ep, ep, 1)]
    for g, w, s in zip(got[:3], want, shapes):
        assert tuple(g.shape) == s
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(s),
                                   **EXACT)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32
    plan, kept = got[3]
    drops = int((~kept).sum())
    if cap < n_loc * topk // ep:
        assert drops > 0


@pytest.mark.parametrize("experts,topk,n_loc,cap", EP_CASES)
def test_ep_roundtrip_matches_jax(ep4_mesh, experts, topk, n_loc, cap):
    """dispatch -> identity experts -> combine against the JAX layer's
    round trip (f32, 1e-5), and, where nothing drops, the JAX test's
    property: every token comes back as tokens * sum(w)."""
    ep, hidden = 4, 64
    tokens, ids, w = _ep_case(ep, experts, topk, n_loc, hidden, 100 + cap)
    jlayer, layer = _layers(ep, experts, topk, cap, hidden)

    def roundtrip(tok, eid, ww):
        recv, _, counts, plan = jlayer.dispatch(tok, eid)
        return jlayer.combine(recv, counts, plan, ww, eid)

    fn = shard_map_op(roundtrip, ep4_mesh,
                      in_specs=(P("ep", None),) * 3, out_specs=P("ep", None))
    want = np.asarray(jax.jit(fn)(tokens, ids, w))
    t, i, ww = _stack(tokens, ep), _stack(ids, ep), _stack(w, ep)
    recv, _, counts, plan = layer.dispatch(t, i)
    got = layer.combine(recv, counts, plan, ww, i)
    assert got.shape == (ep, n_loc, hidden)
    np.testing.assert_allclose(got.reshape(-1, hidden).numpy(), want,
                               **ROUNDTRIP)
    if bool(plan[1].all()):
        np.testing.assert_allclose(got.reshape(-1, hidden).numpy(),
                                   tokens * w.sum(1, keepdims=True),
                                   **ROUNDTRIP)


def test_ep_layer_plan_and_refusals():
    """The send plan's rank-local tables, and the two-axis layer: the flat
    layer's routing over a (dcn 2, ici 2) mesh, its dispatch equal to the
    flat layer's bit for bit."""
    ep, experts, topk, n_loc, cap, hidden = 4, 8, 2, 8, 32, 16
    tokens, ids, _ = _ep_case(ep, experts, topk, n_loc, hidden, 7)
    _, layer = _layers(ep, experts, topk, cap, hidden)
    assert layer.experts_per_rank == 2
    i = _stack(ids, ep)
    _, recv_e, counts, (plan, kept) = layer.dispatch(_stack(tokens, ep), i)
    assert bool(kept.all())
    dest = i.long() // 2
    for r in range(ep):
        for p in range(ep):
            n = int((dest[r] == p).sum())
            assert int(plan.counts[r, p]) == n == int(counts[p, r, 0])
            rows = plan.dispatch_index[r, p]
            assert bool((rows[:n] < n_loc).all() and (rows[n:] == n_loc).all())
            assert torch.equal(recv_e[p, r, :n],
                               (i[r].reshape(-1)[(dest[r] == p).reshape(-1)]
                                % 2).to(torch.int32))
    with pytest.raises(ValueError, match="ep_size"):
        layer.dispatch(_stack(tokens, ep)[:2], i[:2])
    import triton_distributed_tpu_torch.layers.ep_a2a_layer as ep_mod
    hier = ep_mod.HierarchicalEPAll2AllLayer(
        "ici", ep, experts, topk, cap, hidden, dcn_size=2)
    assert isinstance(hier, ep_mod.EPAll2AllLayer) and hier.ici_size == 2
    got = hier.dispatch(_stack(tokens, ep), i)
    assert torch.equal(got[1], recv_e) and torch.equal(got[2], counts)
