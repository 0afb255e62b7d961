"""K11's Hopper body on the CPU: the unit list that
`allgather_group_gemm.unit_list` builds from the routing's counts, held
against the JAX kernel's ``count_of`` semantics (a row tile of an expert's
bucket computes when the count exceeds its first row, and is written as
zeros otherwise: `triton_distributed_tpu/kernels/grouped_gemm.py`
`emit_grouped_matmul`), with the body's row tile of 64
(`grouped_gemm.row_tile(.., "wgmma")`).

For worlds 2, 4 and 8 and capacities 16, 64, 96 and 128, on counts that
hold empty experts, experts live in one chunk only, full buckets, counts
on a row tile's edge and random ones:
- every live (chunk, expert, row tile, column tile) is in exactly one unit;
- every (expert, row tile, column tile) of a rank lies in one run of
  consecutive units of that (expert, column tile), so the rank loads its
  weight tile once for all the chunks' rows;
- every dead row tile is in no unit, and the plain version writes it as
  zeros (and every live one not).
One JAX run of the kernel in interpret mode (world 4, cap 128, f32, row
tiles of 64: the JAX config cuts a bucket into tiles that divide it, so
not at cap 96) shows which row tiles it zeroes: exactly the ones no unit
holds.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.kernels.allgather_group_gemm import (
    AGGroupGEMMContext as JaxAGGroupContext)
from triton_distributed_tpu.kernels.allgather_group_gemm import (
    ag_group_gemm as jax_ag_group_gemm)
from triton_distributed_tpu.kernels.matmul import MatmulConfig
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
    UNIT_BOXES, UNIT_N, UNIT_ROWS, ag_group_gemm_plain, kernel_body,
    unit_list)
from triton_distributed_tpu_torch.kernels.grouped_gemm import (
    grouped_matmul_counts_reference, row_tile)

EXPERTS = 12
NO_BOX = 0xFFFF


@pytest.fixture(autouse=True)
def jax_observability_off(monkeypatch):
    monkeypatch.setenv("TDT_OBSERVABILITY", "0")


@pytest.fixture(autouse=True, scope="module")
def _fresh_observability_state():
    """Leave the JAX package's process-global rings empty for the test
    files that run after this one in the same worker."""
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


def _counts(pattern, world, cap, seed=0):
    """(W, EXPERTS) counts.  ``mixed``: random experts beside an empty one,
    two live in one chunk only (a token, a full bucket), a full one, and
    counts on and just past a row tile's edge; ``empty`` and ``full``: every
    bucket so."""
    if pattern == "empty":
        return torch.zeros((world, EXPERTS), dtype=torch.int32)
    if pattern == "full":
        return torch.full((world, EXPERTS), cap, dtype=torch.int32)
    gen = np.random.default_rng(seed + 10 * world + cap)
    c = gen.integers(0, cap + 1, (world, EXPERTS))
    c[:, 3] = 0                                   # an empty expert
    c[:, 4] = 0
    c[world // 2, 4] = 1                          # one chunk, one token
    c[:, 5] = 0
    c[world - 1, 5] = cap                         # one chunk, full
    c[:, 6] = cap                                 # full everywhere
    c[:, 7] = min(cap, UNIT_ROWS)                 # on a row tile's edge
    c[:, 8] = min(cap, UNIT_ROWS + 1)             # just past it
    return torch.from_numpy(c.astype(np.int32))


def _count_of_live(counts, cap, block_m):
    """The JAX kernel's rule: row tile i of chunk c's bucket e computes iff
    count_of(e) > i * block_m (grouped_gemm.py `valid`)."""
    rt = -(-cap // block_m)
    return {(c, e, i) for c in range(counts.shape[0])
            for e in range(counts.shape[1]) for i in range(rt)
            if int(counts[c, e]) > i * block_m}


def _decode(units, ntiles):
    out = []
    for t in range(int(ntiles[0])):
        e, col, lo, hi = (int(v) & 0xFFFFFFFF for v in units[t])
        codes = [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
        out.append((e, col, codes))
    return out


@pytest.mark.parametrize("pattern", ["mixed", "empty", "full"])
@pytest.mark.parametrize("cap", [16, 64, 96, 128])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_unit_list_schedule(world, cap, pattern):
    """Each live (chunk, expert, row tile, column tile) in exactly one
    unit, each weight tile in one run, dead row tiles in none."""
    n = 3 * UNIT_N - 8                            # 3 column tiles, ragged
    counts = _counts(pattern, world, cap)
    units, ntiles = unit_list(counts, world, EXPERTS, cap, n)
    nt, rt = -(-n // UNIT_N), -(-cap // UNIT_ROWS)
    per = world * rt
    assert units.dtype == torch.int32 and ntiles.dtype == torch.int32
    assert units.shape == (EXPERTS * nt * -(-per // UNIT_BOXES), 4)
    decoded = _decode(units, ntiles)
    live = _count_of_live(counts, cap, row_tile(cap, torch.bfloat16,
                                                "wgmma"))
    assert row_tile(cap, torch.bfloat16, "wgmma") == UNIT_ROWS

    seen = []
    runs = {}                                     # (e, col) -> unit indices
    for t, (e, col, codes) in enumerate(decoded):
        n_live = sum(code != NO_BOX for code in codes)
        assert 1 <= n_live <= UNIT_BOXES
        assert all(code == NO_BOX for code in codes[n_live:])  # packed
        assert 0 <= e < EXPERTS and 0 <= col < nt
        runs.setdefault((e, col), []).append(t)
        for code in codes[:n_live]:
            seen.append((code & 7, e, code >> 3, col))
    # Every live box once for each column tile, nothing else.
    assert len(seen) == len(set(seen))
    assert set(seen) == {(c, e, i, col) for c, e, i in live
                         for col in range(nt)}
    # Units are expert-major, then column tile; an (e, column tile) is one
    # run of ceil(live boxes / 4) consecutive units, so the rank's blocks
    # that hold it load its weight tile once for all its row tiles.
    assert [u[:2] for u in decoded] == sorted(u[:2] for u in decoded)
    for (e, col), ts in runs.items():
        assert ts == list(range(ts[0], ts[0] + len(ts)))
        boxes = sum(1 for c, ee, i in live if ee == e)
        assert len(ts) == -(-boxes // UNIT_BOXES)
    for e in range(EXPERTS):
        for i in range(rt):
            for col in range(nt):
                held = [t for t in runs.get((e, col), [])
                        if any(code != NO_BOX and code >> 3 == i
                               for code in decoded[t][2])]
                if any(ee == e and ii == i for _, ee, ii in live):
                    assert held and held == list(range(held[0],
                                                       held[-1] + 1))
                else:
                    assert not held
    assert int(ntiles[0]) == sum(len(ts) for ts in runs.values())


@pytest.mark.parametrize("cap", [16, 64, 96, 128])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_plain_version_zeroes_the_dead_row_tiles(world, cap):
    """K11's plain version on bf16 16-byte rows (the Hopper body's
    operands) writes zeros into exactly the row tiles that no unit holds,
    garbage rows past the counts and all; K8's count-skipping reference
    keeps its own row tile."""
    e, k, n = EXPERTS, 16, 24
    gen = torch.Generator().manual_seed(world * 1000 + cap)
    a = torch.rand((world, e, cap, k), generator=gen).add_(0.5).to(
        torch.bfloat16)
    b = torch.rand((world, e, k, n), generator=gen).add_(0.5).to(
        torch.bfloat16)
    assert kernel_body(a, b) == "wgmma"
    counts = _counts("mixed", world, cap, seed=1)
    out = ag_group_gemm_plain(a, b, counts)
    covered = {(c, ee, code >> 3) for ee, _, codes in
               _decode(*unit_list(counts, world, e, cap, n))
               for code in codes if code != NO_BOX for c in [code & 7]}
    for c in range(world):
        for ee in range(e):
            for i in range(-(-cap // UNIT_ROWS)):
                rows = out[:, c, ee, i * UNIT_ROWS:(i + 1) * UNIT_ROWS]
                if (c, ee, i) in covered:
                    assert bool((rows != 0).all()), (c, ee, i)
                else:
                    assert not bool(rows.any()), (c, ee, i)
    # K8's reference: the bf16 tile that fits the bucket (16, 64, 128).
    k8 = grouped_matmul_counts_reference(a[0], b[0], counts[0])
    tile = {16: 16, 64: 64, 96: 128, 128: 128}[cap]
    assert row_tile(cap, torch.bfloat16) == tile
    for ee in range(e):
        rows = -(-int(counts[0, ee]) // tile) * tile
        assert not bool(k8[ee, rows:].any())
        assert bool((k8[ee, :rows] != 0).all())


def test_unit_list_matches_jax_count_of(tp4_mesh):
    """The JAX kernel with 64-row tiles (world 4, cap 128, f32, interpret
    mode) zeroes exactly the row tiles that no unit of the list holds."""
    world, e, cap, k, n = 4, EXPERTS, 128, 64, 32
    counts = _counts("mixed", world, cap, seed=2).numpy()
    rng = np.random.default_rng(3)
    buckets = (rng.random((world, e, cap, k)) + 0.5).astype(np.float32)
    w = (rng.random((e, k, world * n)) + 0.5).astype(np.float32)
    ctx = JaxAGGroupContext(axis="tp", world_size=world, num_experts=e,
                            gemm=MatmulConfig(UNIT_ROWS, 32, 64),
                            interpret=True)
    fn = shard_map_op(
        lambda bb, ww, cc: jax_ag_group_gemm(bb[0], ww, ctx, counts=cc),
        tp4_mesh, in_specs=(P("tp", None, None, None), P(None, None, "tp"),
                            P(None, None)),
        out_specs=P(None, None, None, "tp"))
    want = np.asarray(jax.jit(fn)(buckets, w, counts))  # (W, E, cap, W n)
    covered = {(code & 7, ee, code >> 3) for ee, _, codes in
               _decode(*unit_list(torch.from_numpy(counts), world, e, cap,
                                  n))
               for code in codes if code != NO_BOX}
    for c in range(world):
        for ee in range(e):
            for i in range(-(-cap // UNIT_ROWS)):
                rows = want[c, ee, i * UNIT_ROWS:(i + 1) * UNIT_ROWS]
                assert bool((rows != 0).all()) == ((c, ee, i) in covered)
                assert bool((rows == 0).all()) == ((c, ee, i) not in covered)
