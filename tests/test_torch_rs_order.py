"""The sum orders of the scatter-then-sum body (``kernels/csrc/
reduce_scatter.cu`` `scatter_sum_kernel`) on the CPU: K21b's table
(`kernels/torus.py` `rs_order`) and K16 ``scatter_reduce``'s
(`kernels/reduce_scatter.py` `scatter_reduce_order`), evaluated by a plain
torch copy of the kernel's fold (`evaluate`: three accumulators a lane, the
k-th source into level 0, a finished chain into the next level, the first
operand of a chain taken as it is, every later add in f32 and rounded to the
dtype for K21b, once at the end for K16).

They are held bit for bit to the plain versions the card's kernels are held
to (`reduce_scatter_torus_plain`, `reduce_scatter_reference`) on every grid
of `tests/test_torch_gpu.py`'s TORUS_CASES and at worlds 1 to 8, and
K21b's to the JAX package's `reduce_scatter_torus` on (2, 2) and (2, 2, 2),
run as `tests/test_torch_torus.py` runs it (`shard_map` over the virtual
CPU devices, Pallas in interpret mode, ``method="torus"``), once a grid in
a module-scoped fixture (the interpret mode costs seconds a call).
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
from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
from triton_distributed_tpu_torch.kernels import torus

AXES = ("x", "y", "z")
DTYPES = (torch.bfloat16, torch.float32)
#: tests/test_torch_gpu.py TORUS_CASES: (sizes, rows a rank, columns), the
#: chains of 4 on (2, 4) and (4, 2), rows on and off the 2 nd pieces (the
#: last pieces short or empty).
TORUS_CASES = [((2, 2), 8, 64), ((2, 4), 6, 40), ((4, 2), 13, 72),
               ((2, 2, 2), 12, 48), ((2, 2, 2), 8, 24), ((2, 2, 2), 100, 40),
               ((2, 4), 70, 24)]


@pytest.fixture(autouse=True)
def jax_observability_off(monkeypatch):
    monkeypatch.setenv("TDT_OBSERVABILITY", "0")


def evaluate(x, order, piece_rows: int, round_each: bool):
    """The kernel's evaluation of a sum order on x (W, W*m, n): for lane q
    (rows [q piece_rows, (q + 1) piece_rows) of a chunk) and destination g,
    the sources ``srcs[q][g]`` folded through three levels, a level-l chain
    of ``lens[q][l]`` (one past the lane's own levels) finished into level
    l + 1; the last level's value rounded to x's dtype."""
    lens, srcs = order
    world = x.shape[0]
    m = x.shape[1] // world
    xr = x.reshape(world, world, m, -1)         # [source, chunk, row, col]
    out = torch.empty((world, m, xr.shape[-1]), dtype=x.dtype)

    def rnd(t):
        return t.to(x.dtype).float() if round_each else t

    for q, (lane_lens, lane_srcs) in enumerate(zip(lens, srcs)):
        rows = slice(q * piece_rows, min((q + 1) * piece_rows, m))
        chain = (*lane_lens, 1, 1)[:3]
        for g in range(world):
            acc, count = [None] * 3, [0] * 3
            for s in lane_srcs[g]:
                v, level = xr[s, g, rows].float(), 0
                while True:
                    acc[level] = v if count[level] == 0 else rnd(acc[level]
                                                                 + v)
                    count[level] += 1
                    if level == 2 or count[level] < chain[level]:
                        break
                    count[level], v, level = 0, acc[level], level + 1
            out[g, rows] = acc[2].to(x.dtype)
    return out


def _x(seed, world, m, n, dtype):
    gen = np.random.default_rng(seed)
    return torch.from_numpy(gen.standard_normal((world, world * m, n))
                            .astype(np.float32)).to(dtype)


def _rs_order(sizes, x):
    m = x.shape[1] // x.shape[0]
    return torus.rs_order(sizes), torus._pieces(m, len(sizes), x.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes,m,n", TORUS_CASES)
def test_rs_order_evaluates_the_plain_version(sizes, m, n, dtype):
    """K21b's table, folded as the kernel folds it, equals
    `reduce_scatter_torus_plain` bit for bit."""
    x = _x(m * 10 + n, math.prod(sizes), m, n, dtype)
    order, ms = _rs_order(sizes, x)
    got = evaluate(x, order, ms, round_each=True)
    assert torch.equal(got, torus.reduce_scatter_torus_plain(x, sizes))


@pytest.mark.parametrize("sizes", [(2, 2), (2, 4), (4, 2), (2, 2, 2)])
def test_rs_order_tables_are_permutations_along_the_lanes(sizes):
    """Each lane's chain lengths are its stages' axis sizes (product W),
    each destination's row a permutation of the ranks, the destination
    itself last (every chain ends at position c), and the innermost chain
    walks one axis in the lane's direction."""
    lens, srcs = torus.rs_order(sizes)
    nd, world = len(sizes), math.prod(sizes)
    scheds = torus.lane_schedules(nd)
    assert len(lens) == len(srcs) == 2 * nd
    for sched, lane_lens, lane_srcs in zip(scheds, lens, srcs):
        a, d = sched[nd - 1]                    # stage 0's axis
        assert lane_lens == tuple(sizes[sched[nd - 1 - t][0]]
                                  for t in range(nd))
        assert math.prod(lane_lens) == world
        for g, row in enumerate(lane_srcs):
            assert sorted(row) == list(range(world)) and row[-1] == g
            pos = np.unravel_index(g, sizes)
            first = [int(np.unravel_index(s, sizes)[a]) for s in
                     row[-lane_lens[0]:]]
            assert first == [(pos[a] + j * d) % sizes[a]
                             for j in range(1, sizes[a] + 1)]
    count, lens3, srcs3 = rs.order_args(lens, srcs)
    assert count == 2 * nd and len(lens3) == count * rs.ORDER_LEVELS
    assert len(srcs3) == count * world * world


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,m,n", [(1, 5, 24), (2, 37, 100), (3, 9, 96),
                                       (4, 6, 77), (8, 13, 40)])
def test_scatter_reduce_order_is_the_reference(world, m, n, dtype):
    """K16's trivial table (one lane, rank order, one level of W), folded
    with one rounding at the end, equals `reduce_scatter_reference(x,
    "scatter_reduce")` bit for bit."""
    x = _x(world * 100 + m, world, m, n, dtype)
    order = rs.scatter_reduce_order(world)
    got = evaluate(x, order, m, round_each=False)
    assert torch.equal(got, rs.reduce_scatter_reference(x, "scatter_reduce"))
    assert order == (((world,),), (tuple(tuple(range(world))
                                         for _ in range(world)),))


@pytest.fixture(scope="module")
def jax_reduce_scatter(devices):
    """JAX `reduce_scatter_torus` on (2, 2) in bf16 (m = 6, off the 4
    pieces) and on (2, 2, 2) in f32 (m = 8, off the 6 pieces): the partials
    (W, W*m, 128) and the JAX output (W*m, 128), as float32 numpy."""
    out = {}
    for sizes, m, dtype in (((2, 2), 6, jnp.bfloat16),
                            ((2, 2, 2), 8, jnp.float32)):
        world, axes = math.prod(sizes), AXES[:len(sizes)]
        x = np.random.default_rng(3).standard_normal(
            (world, world * m, 128)).astype(np.float32)
        xj = jnp.asarray(x).astype(dtype)
        mesh = Mesh(np.array(devices[:world]).reshape(sizes), axes)
        ctx = jtorus.TorusContext(axes=axes, sizes=sizes, method="torus")
        fn = shard_map_op(
            lambda xx, c=ctx: jtorus.reduce_scatter_torus(xx[0], c), mesh,
            in_specs=P(axes, None, None), out_specs=P(axes, None))
        out[sizes] = (np.array(xj.astype(jnp.float32)),
                      np.asarray(jax.jit(fn)(xj).astype(jnp.float32)),
                      torch.bfloat16 if dtype == jnp.bfloat16
                      else torch.float32)
    return out


@pytest.mark.parametrize("sizes", [(2, 2), (2, 2, 2)])
def test_rs_order_matches_jax(jax_reduce_scatter, sizes):
    """K21b's table, folded as the kernel folds it, equals the JAX
    package's `reduce_scatter_torus` bit for bit."""
    x, want, dtype = jax_reduce_scatter[sizes]
    xt = torch.from_numpy(x).to(dtype)
    order, ms = _rs_order(sizes, xt)
    got = evaluate(xt, order, ms, round_each=True)
    np.testing.assert_array_equal(got.reshape(-1, x.shape[2]).float().numpy(),
                                  want)
