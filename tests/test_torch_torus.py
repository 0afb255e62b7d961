"""The port's process-grid collectives (`kernels/torus.py`: K21a-c's
wrappers and their plain versions) against the JAX package on the CPU.

The JAX side runs as tests/test_torus.py and tests/test_torus3.py run it:
`shard_map` over the 8 virtual CPU devices reshaped to the grid, Pallas in
interpret mode, the torus schedule forced (``method="torus"``).  The port
holds every rank in one process (`parallel.mesh`): rank g's shard is row g
of a rank-stacked tensor, g row-major over the grid's axes, and on CPU
tensors the wrappers run their plain versions.  The same seeded numpy
inputs go to both.

The JAX kernels in interpret mode are slow (a torus reduce-scatter about
11 s a call, the AG-GEMM about 21 s), so each (op, grid) runs once, in a
module-scoped fixture at the JAX tests' own small shapes; the port's other
cases are held to its plain versions' own invariants or to a float64
numpy reference, which cost nothing.

Tolerances: the all-gathers copy bytes, so they are held bit for bit. The
reduce-scatter adds one hop at a time in f32 and rounds to the dtype after
each add in the JAX lane, stage and step order, as the port's plain
version does: f32 within 1e-5; bf16 within one bf16 ulp of the output's
scale (2^-7 of max |out|).  Against a float64 sum: f32 1e-5 (W <= 8
terms).  The GEMMs within the TP tests' bounds (tests/test_torch_tp.py):
f32 1e-5 for one product.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.kernels import torus as jtorus
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import torus
from triton_distributed_tpu_torch.kernels.allgather_gemm import ag_gemm
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs
from triton_distributed_tpu_torch.parallel import make_mesh

EXACT = dict(atol=0, rtol=0)
F32 = dict(atol=1e-5, rtol=1e-5)
AXES = ("x", "y", "z")


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


def _world(sizes):
    return math.prod(sizes)


def _ctx(sizes, **kw):
    return torus.TorusContext(AXES[:len(sizes)], tuple(sizes), **kw)


def _jax_ctx(sizes, **kw):
    kw.setdefault("method", "torus")
    return jtorus.TorusContext(axes=AXES[:len(sizes)], sizes=tuple(sizes),
                               **kw)


def _mesh(devices, sizes):
    return Mesh(np.array(devices[:_world(sizes)]).reshape(sizes),
                AXES[:len(sizes)])


def _bf16_ulp(ref):
    return float(np.abs(ref).max()) * 2.0 ** -7


# ---- the JAX results, one a (op, grid) ----------------------------------

@pytest.fixture(scope="module")
def jax_all_gather(devices):
    """all_gather_torus on (2, 4), (4, 2) and (2, 2, 2): x (W*m, n) per
    case, with its JAX output."""
    out = {}
    for sizes, m, n, dtype in (((2, 4), 6, 128, jnp.float32),
                               ((4, 2), 8, 128, jnp.float32),
                               ((2, 2, 2), 8, 256, jnp.bfloat16)):
        axes = AXES[:len(sizes)]
        x = _rng(1).standard_normal((8 * m, n)).astype(np.float32)
        xj = jnp.asarray(x).astype(dtype)
        fn = shard_map_op(
            lambda xx, s=sizes: jtorus.all_gather_torus(xx, _jax_ctx(s)),
            _mesh(devices, sizes), in_specs=P(axes, None),
            out_specs=P(None, None))
        out[sizes] = (np.array(xj.astype(jnp.float32)),
                      np.asarray(jax.jit(fn)(xj).astype(jnp.float32)), dtype)
    return out


@pytest.fixture(scope="module")
def jax_reduce_scatter(devices):
    """reduce_scatter_torus on (2, 4) in f32 (m = 6, off the 4 pieces) and
    on (2, 2, 2) in bf16 (m = 8, off the 6 pieces): the partials (W, W*m,
    n) and the JAX output (W*m, n)."""
    out = {}
    for sizes, m, dtype in (((2, 4), 6, jnp.float32),
                            ((2, 2, 2), 8, jnp.bfloat16)):
        axes = AXES[:len(sizes)]
        x = _rng(2).standard_normal((8, 8 * m, 128)).astype(np.float32)
        xj = jnp.asarray(x).astype(dtype)
        fn = shard_map_op(
            lambda xx, s=sizes: jtorus.reduce_scatter_torus(xx[0],
                                                            _jax_ctx(s)),
            _mesh(devices, sizes), in_specs=P(axes, None, None),
            out_specs=P(axes, None))
        out[sizes] = (np.array(xj.astype(jnp.float32)),
                      np.asarray(jax.jit(fn)(xj).astype(jnp.float32)), dtype)
    return out


# ---- the schedule and the context --------------------------------------

def test_lane_schedules_match_jax():
    for nd in (2, 3):
        assert torus.lane_schedules(nd) == jtorus.lane_schedules(nd)


@pytest.mark.parametrize("sizes", [(2, 4), (1, 8), (2, 2, 1), (1, 1)])
def test_context_active_axes_match_jax(sizes):
    assert _ctx(sizes).active() == _jax_ctx(sizes).active()
    assert _ctx(sizes).world_size == _jax_ctx(sizes).world_size
    assert _ctx(sizes).resolve_method() == "torus"
    assert _ctx(sizes, method="xla").resolve_method() == "xla"
    with pytest.raises(ValueError, match="method"):
        _ctx(sizes, method="ring").resolve_method()


def test_paired_ag_id_distinct():
    assert cids.paired_ag_id(cids.ALLGATHER) == cids.ALLREDUCE_RING_AG
    user = cids.allocate()
    ag = cids.paired_ag_id(user)
    assert ag != user and ag == cids.paired_ag_id(user)
    assert ag not in cids.builtin_ids().values()


def test_mesh_grid_helpers():
    mesh = make_mesh({"x": 2, "y": 4}, device="cpu")
    assert (mesh.world_size, mesh.axes, mesh.sizes) == (8, ("x", "y"),
                                                         (2, 4))
    assert [mesh.coord(g, "x") for g in range(8)] == [0] * 4 + [1] * 4
    assert [mesh.coord(g, "y") for g in range(8)] == [0, 1, 2, 3] * 2
    assert mesh.rank_of((1, 2)) == 6
    assert mesh.groups("x") == [(0, 4), (1, 5), (2, 6), (3, 7)]
    assert mesh.groups("y") == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert make_mesh(4, device="cpu").axes == ("tp",)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh({"x": 4, "y": 4}, device="cpu")


# ---- against JAX -------------------------------------------------------

@pytest.mark.parametrize("sizes", [(2, 4), (4, 2), (2, 2, 2)])
def test_all_gather_torus_matches_jax(jax_all_gather, sizes):
    x, want, dtype = jax_all_gather[sizes]
    world = _world(sizes)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = torch.from_numpy(x).to(tdtype).reshape(world, -1, x.shape[1])
    got = torus.all_gather_torus(xt, _ctx(sizes))
    assert got.shape == (world, *want.shape)
    for g in range(world):
        np.testing.assert_allclose(got[g].float().numpy(), want, **EXACT)


@pytest.mark.parametrize("sizes", [(2, 4), (2, 2, 2)])
def test_reduce_scatter_torus_matches_jax(jax_reduce_scatter, sizes):
    x, want, dtype = jax_reduce_scatter[sizes]
    world = _world(sizes)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = torus.reduce_scatter_torus(torch.from_numpy(x).to(tdtype),
                                     _ctx(sizes))
    assert got.shape == (world, x.shape[1] // world, x.shape[2])
    got = got.reshape(-1, x.shape[2]).float().numpy()
    if tdtype == torch.float32:
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, atol=_bf16_ulp(want), rtol=0)


def test_all_reduce_torus_matches_jax(devices):
    """(4, 2), m = 10: the rows padded to 16 for the reduce-scatter."""
    sizes, m, n = (4, 2), 10, 128
    x = _rng(3).standard_normal((8, m, n)).astype(np.float32)
    fn = shard_map_op(
        lambda xx: jtorus.all_reduce_torus(xx[0], _jax_ctx(sizes)),
        _mesh(devices, sizes), in_specs=P(AXES[:2], None, None),
        out_specs=P(None, None))
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = torus.all_reduce_torus(torch.from_numpy(x), _ctx(sizes))
    for g in range(8):
        np.testing.assert_allclose(got[g].numpy(), want, **F32)


def test_ag_gemm_torus_matches_jax(devices):
    """ag_gemm on a (2, 4) TorusContext, m = 6 (rows padded to 4 pieces
    of 8), with the gathered A: b column-sharded, rank g's (k, n) block."""
    sizes, m, k, n = (2, 4), 6, 64, 128
    axes = AXES[:2]
    rng = _rng(4)
    a = rng.standard_normal((8 * m, k)).astype(np.float32)
    b = (rng.standard_normal((k, 8 * n)) / np.sqrt(k)).astype(np.float32)
    from triton_distributed_tpu.kernels.allgather_gemm import (
        ag_gemm as jax_ag_gemm)
    fn = shard_map_op(
        lambda aa, bb: jax_ag_gemm(aa, bb, _jax_ctx(sizes),
                                   return_gathered=True),
        _mesh(devices, sizes), in_specs=(P(axes, None), P(None, axes)),
        out_specs=(P(None, axes), P(None, None)))
    want, want_g = (np.asarray(t) for t in jax.jit(fn)(jnp.asarray(a),
                                                       jnp.asarray(b)))
    at = torch.from_numpy(a).reshape(8, m, k)
    bt = torch.from_numpy(b).reshape(k, 8, n).transpose(0, 1).contiguous()
    got, got_g = ag_gemm(at, bt, _ctx(sizes), return_gathered=True)
    for g in range(8):
        np.testing.assert_allclose(got[g].numpy(), want[:, g * n:(g + 1) * n],
                                   **F32)
        np.testing.assert_allclose(got_g[g].numpy(), want_g, **EXACT)


def test_gemm_rs_torus_matches_jax(devices):
    """gemm_rs on a (2, 2, 2) TorusContext: a column-sharded (rank g's k
    columns), b row-sharded; the partial products, then the torus
    reduce-scatter."""
    sizes, mt, k, n = (2, 2, 2), 8 * 8, 8 * 16, 128
    axes = AXES[:3]
    rng = _rng(5)
    a = rng.standard_normal((mt, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    from triton_distributed_tpu.kernels.gemm_reduce_scatter import (
        gemm_rs as jax_gemm_rs)
    fn = shard_map_op(
        lambda aa, bb: jax_gemm_rs(aa, bb, _jax_ctx(sizes)),
        _mesh(devices, sizes), in_specs=(P(None, axes), P(axes, None)),
        out_specs=P(axes, None))
    want = np.asarray(jax.jit(fn)(jnp.asarray(a), jnp.asarray(b)))
    at = torch.from_numpy(a).reshape(mt, 8, 16).transpose(0, 1).contiguous()
    bt = torch.from_numpy(b).reshape(8, 16, n)
    got = gemm_rs(at, bt, _ctx(sizes))
    np.testing.assert_allclose(got.reshape(mt, n).numpy(), want, **F32)


# ---- the port's cases, held to float64 or to the plain versions ---------

GRIDS = [(2, 4), (4, 2), (2, 2, 2), (2, 2), (1, 8), (8, 1), (2, 2, 1)]


@pytest.mark.parametrize("m", [6, 8, 13])
@pytest.mark.parametrize("sizes", GRIDS)
def test_torus_collectives_against_float64(sizes, m):
    world = _world(sizes)
    rng = _rng(10 + m)
    x = rng.standard_normal((world, m, 24)).astype(np.float32)
    xr = rng.standard_normal((world, world * m, 24)).astype(np.float32)
    ctx = _ctx(sizes)
    ag = torus.all_gather_torus(torch.from_numpy(x), ctx)
    for g in range(world):
        np.testing.assert_allclose(ag[g].numpy(), x.reshape(-1, 24),
                                   **EXACT)
    rs = torus.reduce_scatter_torus(torch.from_numpy(xr), ctx)
    np.testing.assert_allclose(
        rs.numpy(), xr.astype(np.float64).sum(0).reshape(world, m, 24),
        **F32)
    ar = torus.all_reduce_torus(torch.from_numpy(x), ctx)
    for g in range(world):
        np.testing.assert_allclose(ar[g].numpy(),
                                   x.astype(np.float64).sum(0), **F32)


@pytest.mark.parametrize("sizes", [(2, 4), (4, 2), (2, 2, 2)])
def test_reduce_scatter_torus_plain_bf16_order(sizes):
    """In bf16 the torus order differs from K16's rank-order sum: the
    plain version rounds after every ring add.  Held to a float64 sum
    within the W - 1 roundings' bound, and to the xla method (rank-order
    f32 sum, rounded once) within the same."""
    world = _world(sizes)
    x = torch.from_numpy(_rng(20).standard_normal(
        (world, world * 16, 32)).astype(np.float32)).to(torch.bfloat16)
    got = torus.reduce_scatter_torus(x, _ctx(sizes)).float()
    exact = x.double().sum(0).reshape(world, 16, 32)
    bound = (world - 1) * float(exact.abs().max()) * 2.0 ** -8
    assert float((got.double() - exact).abs().max()) <= bound
    xla = torus.reduce_scatter_torus(x, _ctx(sizes, method="xla")).float()
    assert float((got - xla).abs().max()) <= bound


@pytest.mark.parametrize("sizes,m", [((2, 4), 6), ((2, 2, 2), 12),
                                     ((4, 2), 5), ((1, 4), 8), ((1, 1), 3)])
def test_ag_gemm_torus_against_float64(sizes, m):
    world = _world(sizes)
    rng = _rng(30 + m)
    a = rng.standard_normal((world, m, 32)).astype(np.float32)
    b = (rng.standard_normal((world, 32, 20)) / np.sqrt(32)).astype(
        np.float32)
    out, g = torus.ag_gemm_torus(torch.from_numpy(a), torch.from_numpy(b),
                                 _ctx(sizes), return_gathered=True)
    full = a.reshape(-1, 32).astype(np.float64)
    for r in range(world):
        np.testing.assert_allclose(out[r].numpy(), full @ b[r], **F32)
        np.testing.assert_allclose(g[r].numpy(), full, **EXACT)


@pytest.mark.parametrize("sizes", [(2, 4), (2, 2, 2), (1, 4)])
def test_gemm_rs_torus_against_float64(sizes):
    world = _world(sizes)
    rng = _rng(40)
    a = rng.standard_normal((world, world * 3, 16)).astype(np.float32)
    b = (rng.standard_normal((world, 16, 12)) / 4).astype(np.float32)
    got = gemm_rs(torch.from_numpy(a), torch.from_numpy(b), _ctx(sizes))
    want = np.einsum("rmk,rkn->mn", a.astype(np.float64), b)
    np.testing.assert_allclose(got.reshape(-1, 12).numpy(), want, **F32)


def test_torus_wrappers_refuse_bad_shapes():
    ctx = _ctx((2, 4))
    with pytest.raises(ValueError, match="rank-stacked"):
        torus.all_gather_torus(torch.zeros(4, 3, 2), ctx)
    with pytest.raises(ValueError, match="rank-stacked"):
        torus.reduce_scatter_torus(torch.zeros(8, 12, 2), ctx)
    with pytest.raises(ValueError, match="want a_shard"):
        torus.ag_gemm_torus(torch.zeros(8, 3, 4), torch.zeros(8, 5, 2), ctx)
    with pytest.raises(ValueError, match="W | M"):
        torus.gemm_rs_torus(torch.zeros(8, 12, 4), torch.zeros(8, 4, 2), ctx)
