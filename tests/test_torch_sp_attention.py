"""The port's sequence-parallel attention against the JAX package on the
CPU: `sp_ag_attention_fused` (K20's plain version; aligned and unaligned
chunks, ``return_lse``, caller ``q_offset``/``kv_base``, world 1),
`sp_ag_attention_gather` (K15's ring + K1), `sp_ring_attention` (K1),
`sp_ring_attention_zigzag` with the zigzag round trip, and the gradients of
`sp_ring_attention_diff` (K1 forward, K4/K5 backward) against `jax.grad`.

The JAX side runs as tests/test_sp_attention.py and tests/
test_flash_attention.py run it: `shard_map` over the ``sp4_mesh`` fixture
(virtual CPU devices), Pallas in interpret mode with blocks of 16.  The
port holds every rank in one process: the shards are rank-stacked (W, B,
H, S_loc, D), and on CPU tensors every kernel's plain version runs.  The
same seeded numpy inputs go to both, in f32.

Tolerance 1e-4 (atol = rtol) on outputs, lse and gradients: the two sides
take the same chunks in the same ring order and merge them with the same
formula, but JAX's flash kernels run an online softmax in blocks of 16
where the plain versions take one dense softmax a chunk, so the f32 sums
differ in order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.kernels import sp_ag_attention as jsp
from triton_distributed_tpu.kernels.flash_attention import (
    attention_reference)
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch.kernels import allgather as ag
from triton_distributed_tpu_torch.kernels import flash_attention as fa
from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp

TOL = dict(atol=1e-4, rtol=1e-4)
WORLD = 4
SEQ = P(None, None, "sp", None)


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


def _qkv(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) / 4).astype(np.float32)
                 for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))


def _shards(x, world=WORLD):
    """Global (B, H, S, D) -> the rank-stacked (W, B, H, S/W, D)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    b, h, s, d = t.shape
    return t.reshape(b, h, world, s // world, d).movedim(2, 0).contiguous()


def _unshard(t):
    """The rank-stacked (W, B, H, S_loc, ...) -> global (B, H, S, ...)."""
    t = t.movedim(0, 2)
    return t.reshape(*t.shape[:2], -1, *t.shape[4:]).numpy()


def _jax_run(mesh, fn, q, k, v, lse=False):
    out_specs = (SEQ, P(None, None, "sp")) if lse else SEQ
    f = shard_map_op(fn, mesh, in_specs=(SEQ,) * 3, out_specs=out_specs)
    return jax.jit(f)(q, k, v)


IMPLS = {
    "ring": (jsp.sp_ring_attention, sp.sp_ring_attention),
    "gather": (jsp.sp_ag_attention_gather, sp.sp_ag_attention_gather),
}


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("gqa", [1, 2])
def test_sp_attention_matches_jax(sp4_mesh, impl, gqa):
    """The ring and gather compositions against the same JAX function and
    against the dense causal golden (tests/test_sp_attention.py's
    setup)."""
    b, h, s_loc, d = 1, 2, 32, 32
    q, k, v = _qkv(gqa, b, h, h // gqa, WORLD * s_loc, d)
    jfn, fn = IMPLS[impl]
    want = _jax_run(sp4_mesh, functools.partial(jfn, axis="sp", block_q=16,
                                                block_k=16), q, k, v)
    got = fn(_shards(q), _shards(k), _shards(v), "sp")
    assert got.shape == (WORLD, b, h, s_loc, d)
    np.testing.assert_allclose(_unshard(got), np.asarray(want), **TOL)
    gold = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(_unshard(got), gold.numpy(), **TOL)


# (GQA group, rows a rank, caller offsets): aligned chunks; unaligned ones
# (24 rows, JAX's test_sp_attention_fused_unaligned_chunks); and a
# caller-given q_offset (rank r at r * S_loc + 5) with per-rank kv_base
# (3, 0, 7, 1), where chunks of the future become partly visible and
# rank 2's first rows see nothing of its own chunk.
FUSED_CASES = {"aligned": (1, 32, False), "unaligned": (2, 24, False),
               "offsets": (2, 32, True)}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_sp_fused_matches_jax(sp4_mesh, case):
    """`sp_ag_attention_fused` with ``return_lse`` (the lse in the layout
    the JAX wrapper returns) against JAX's, and out against the dense
    golden where the offsets are the default ones."""
    gqa, s_loc, offsets = FUSED_CASES[case]
    b, h, d = 1, 2, 32
    base = [3, 0, 7, 1]
    q, k, v = _qkv(s_loc + gqa, b, h, h // gqa, WORLD * s_loc, d)
    blk = 16 if s_loc % 16 == 0 else s_loc

    def jfn(q, k, v):
        kw = {}
        if offsets:
            my = jax.lax.axis_index("sp")
            kw = dict(q_offset=my * s_loc + 5,
                      kv_base=jnp.asarray(base, jnp.int32)[my])
        return jsp.sp_ag_attention_fused(q, k, v, "sp", block_q=blk,
                                         block_k=blk, return_lse=True, **kw)

    want_o, want_l = _jax_run(sp4_mesh, jfn, q, k, v, lse=True)
    kw = dict(q_offset=[r * s_loc + 5 for r in range(WORLD)],
              kv_base=torch.tensor(base)) if offsets else {}
    out, lse = sp.sp_ag_attention_fused(_shards(q), _shards(k), _shards(v),
                                        return_lse=True, **kw)
    assert lse.shape == (WORLD, b, h, s_loc) and lse.dtype == torch.float32
    np.testing.assert_allclose(_unshard(out), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(_unshard(lse), np.asarray(want_l), **TOL)
    if not offsets:
        gold = fa.flash_attention_reference(*map(torch.from_numpy,
                                                 (q, k, v)))
        np.testing.assert_allclose(_unshard(out), gold.numpy(), **TOL)


def test_sp_fused_world_one_matches_jax(devices):
    """At world 1 the fused path is one rectangular flash attention with
    ``kv_offset`` = q_offset - kv_base, as in JAX."""
    mesh1 = Mesh(np.array(devices[:1]), ("sp",))
    b, h, s, d = 2, 4, 40, 32
    q, k, v = _qkv(5, b, h, 2, s, d)
    fn = functools.partial(jsp.sp_ag_attention_fused, axis="sp", block_q=16,
                           block_k=16, q_offset=9, kv_base=2,
                           return_lse=True)
    want_o, want_l = _jax_run(mesh1, fn, q, k, v, lse=True)
    out, lse = sp.sp_ag_attention_fused(
        *(torch.from_numpy(x)[None] for x in (q, k, v)), q_offset=9,
        kv_base=2, return_lse=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(want_l), **TOL)


def test_zigzag_shard_matches_jax():
    x = np.arange(2 * 3 * 32 * 4, dtype=np.float32).reshape(2, 3, 32, 4)
    for axis_dim in (2, 0):
        n = x.shape[axis_dim] if axis_dim == 2 else 16
        xx = x if axis_dim == 2 else x.reshape(16, -1)[:n]
        want = np.asarray(jsp.zigzag_shard(jnp.asarray(xx), 4, axis_dim))
        got = sp.zigzag_shard(torch.from_numpy(xx), 4, axis_dim)
        np.testing.assert_array_equal(got.numpy(), want)
        back = sp.zigzag_unshard(got, 4, axis_dim)
        np.testing.assert_array_equal(back.numpy(), xx)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jsp.zigzag_unshard(jnp.asarray(want), 4,
                                                        axis_dim)))


@pytest.mark.parametrize("gqa", [1, 2])
def test_sp_ring_attention_zigzag_matches_jax(sp4_mesh, gqa):
    """The balanced layout through the zigzag round trip, against JAX's
    zigzag ring and the dense golden."""
    b, h, s_loc, d = 1, 2, 32, 32
    q, k, v = _qkv(20 + gqa, b, h, h // gqa, WORLD * s_loc, d)
    zq, zk, zv = (np.asarray(jsp.zigzag_shard(jnp.asarray(x), WORLD))
                  for x in (q, k, v))
    want = jsp.zigzag_unshard(_jax_run(
        sp4_mesh, functools.partial(jsp.sp_ring_attention_zigzag, axis="sp",
                                    block_q=16, block_k=16), zq, zk, zv),
        WORLD)
    tq, tk, tv = (sp.zigzag_shard(torch.from_numpy(x), WORLD)
                  for x in (q, k, v))
    got = sp.sp_ring_attention_zigzag(_shards(tq.numpy()), _shards(
        tk.numpy()), _shards(tv.numpy()))
    got = sp.zigzag_unshard(torch.from_numpy(_unshard(got)), WORLD).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    gold = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got, gold.numpy(), **TOL)


def test_sp_ring_attention_diff_grads_match_jax(sp4_mesh):
    """dq, dk, dv of sum(ring(q, k, v) * w) against `jax.grad` of the JAX
    ring (tests/test_flash_attention.py::
    test_ring_attention_differentiable's setup at GQA 2)."""
    b, h, hkv, s_loc, d = 1, 4, 2, 32, 32
    q, k, v = _qkv(12, b, h, hkv, WORLD * s_loc, d)
    w = np.random.default_rng(13).standard_normal(q.shape).astype(np.float32)
    ring = shard_map_op(
        functools.partial(jsp.sp_ring_attention_diff, axis="sp", block_q=16,
                          block_k=16),
        sp4_mesh, in_specs=(SEQ,) * 3, out_specs=SEQ)

    def loss(q, k, v):
        return jnp.sum(ring(q, k, v) * w)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    ts = [_shards(x).requires_grad_(True) for x in (q, k, v)]
    out = sp.sp_ring_attention_diff(*ts)
    (out * _shards(w)).sum().backward()
    for t, g, name in zip(ts, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_unshard(t.grad), np.asarray(g), **TOL,
                                   err_msg=name)
    gold = attention_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True)
    np.testing.assert_allclose(_unshard(out.detach()), np.asarray(gold),
                               **TOL)


def test_sp_launch_counts_and_refusals():
    """On the CPU the compositions launch no kernel (the two-level form
    over a (dcn 2, ici 2) mesh included); the gather's one K15 call goes
    through `all_gather` (counted only on the card)."""
    from triton_distributed_tpu_torch.kernels.hierarchical import (
        HierarchicalContext)
    q, k, v = (_shards(x) for x in _qkv(1, 1, 2, 2, WORLD * 16, 32))
    before = (fa.flash_attention.launches, ag.all_gather.launches,
              sp.sp_ag_attention_fused.launches)
    for fn in (sp.sp_ring_attention, sp.sp_ring_attention_zigzag,
               sp.sp_ag_attention_gather, sp.sp_ag_attention_fused):
        assert torch.isfinite(fn(q, k, v)).all()
    two = sp.sp_ag_attention_2d(q, k, v, HierarchicalContext("sp", "dcn",
                                                             2, 2))
    assert torch.isfinite(two).all()
    assert (fa.flash_attention.launches, ag.all_gather.launches,
            sp.sp_ag_attention_fused.launches) == before
    with pytest.raises(ValueError, match="does not match"):
        sp.sp_ag_attention_fused(q, k[:, :, :, :8], v[:, :, :, :8])
    with pytest.raises(ValueError, match="q_offset"):
        sp.sp_ag_attention_fused(q, k, v, q_offset=[0, 1])
