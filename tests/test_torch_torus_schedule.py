"""K21c's flat tile list on the Hopper body (`kernels/torus.py`
`ag_gemm_pieces`) against the JAX package's own schedule.

The JAX side is `_ag_gemm_torus_kernel` over `_emit_torus_ag`, run as plain
Python for one rank at a time: the module's `jax`, `dl`, `pltpu` and
`emit_matmul` are replaced by recorders, so ``axis_index`` gives the rank's
coordinates, every ref's ``.at[...]`` gives its index, and the run leaves
the slabs it waited for (``dl.wait_recv`` on ``phase_sems.at[p, q, c]``)
and the pieces it multiplied (``emit_matmul`` on ``g_ref.at[cell + (q,)]``)
in the order it issued them.  Nothing is traced or compiled.

A piece's arrival word is the one of the (phase, lane, ring position) of
the slab that brought it: 1 + that index in row-major (nd, L, maxw) order,
the layout of the JAX kernel's ``phase_sems`` after the entry barrier's
word 0.  The own pieces wait on none (0).  A piece's run is the JAX
kernel's consumption round that multiplied it: ``consume_local`` is run 0,
and each later round's ``consume_piece`` calls (the pieces multiplied
between two batches of waits) the next run.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels import torus as jtorus
from triton_distributed_tpu_torch.kernels import torus

GRIDS = [(2, 2), (2, 4), (4, 2), (2, 2, 2)]


class _Ref:
    """A ref whose ``.at[idx]`` is (name, the index tuple)."""

    def __init__(self, name):
        self.name = name

    @property
    def at(self):
        return self

    def __getitem__(self, idx):
        return self.name, idx if isinstance(idx, tuple) else (idx,)


def _jax_schedule(monkeypatch, sizes, ms):
    """For every rank, the JAX kernel's multiplications in order, each as
    (cell coordinates, lane, (phase, lane, ring position) of the slab it
    came in, or None for an own piece, its round)."""
    axes = ("x", "y", "z")[:len(sizes)]
    pos = {}
    events = []
    lax = types.SimpleNamespace(axis_index=lambda a: pos[a],
                                rem=lambda a, b: a % b)
    nothing = lambda *a, **k: None  # noqa: E731
    dl = types.SimpleNamespace(
        maybe_straggle=nothing, correctness_delay=nothing,
        entry_barrier=nothing, local_copy=nothing, wait_send=nothing,
        peer_id=lambda axis, index: (axis, index),
        wait_recv=lambda ref, sem: events.append(("wait", ref[1], sem[1])))
    pltpu = types.SimpleNamespace(
        make_async_remote_copy=lambda **kw: types.SimpleNamespace(
            start=nothing),
        DeviceIdType=types.SimpleNamespace(MESH="mesh"))
    monkeypatch.setattr(jtorus, "jax", types.SimpleNamespace(lax=lax))
    monkeypatch.setattr(jtorus, "dl", dl)
    monkeypatch.setattr(jtorus, "pltpu", pltpu)
    monkeypatch.setattr(jtorus, "emit_matmul",
                        lambda g, b, o, **kw: events.append(("mm", g[1],
                                                             None)))
    ctx = jtorus.TorusContext(axes, tuple(sizes), method="torus")
    world = int(np.prod(sizes))
    out = []
    for g in range(world):
        coords = np.unravel_index(g, sizes)
        pos.clear()
        pos.update({a: int(c) for a, c in zip(axes, coords)})
        events.clear()
        jtorus._ag_gemm_torus_kernel(
            ctx, axes, tuple(sizes), ms, 8, 8, *map(
                _Ref, ("x", "b", "g", "out", "local", "send", "phase")))
        waited, muls = [], []
        rnd, last = 0, "mm"
        for kind, idx, sem in events:
            if kind == "wait":
                waited.append((idx, sem))
                last = kind
                continue
            if last == "wait":
                rnd += 1
            last = kind
            *cell, q = idx
            if tuple(cell) == tuple(int(c) for c in coords):
                muls.append((tuple(cell), q, None, rnd))
                continue
            # The slab that brought it: waited for before, same lane, every
            # fixed coordinate the cell's.
            came = [sem for slab, sem in waited
                    if slab[-1] == q and all(
                        isinstance(i, slice) or i == c
                        for i, c in zip(slab[:-1], cell))]
            assert len(came) == 1, (g, idx, came)
            muls.append((tuple(cell), q, came[0], rnd))
        out.append(muls)
    return out


@pytest.mark.parametrize("m", [12, 100, 512])
@pytest.mark.parametrize("sizes", GRIDS)
def test_ag_gemm_pieces_follow_the_jax_schedule(monkeypatch, sizes, m):
    """Rank by rank: the port's pieces are the JAX kernel's multiplications
    in its order, the empty ones dropped; every (cell, lane) with rows
    exactly once, the own pieces first; each piece's rows those of its
    lane; each waits on the word of the (phase, lane, ring position) whose
    slab brought it to the JAX kernel; each piece's run the round in which
    the JAX kernel multiplies it."""
    nd, world = len(sizes), int(np.prod(sizes))
    lanes, maxw = 2 * nd, max(sizes)
    ms = torus._pieces(m, nd, torch.bfloat16)
    assert ms == jtorus.round_up_rows(-(-m // lanes), jnp.bfloat16)
    rows = [max(0, min(ms, m - q * ms)) for q in range(lanes)]
    table = torus.ag_gemm_pieces(sizes, m, ms)
    assert len(table) == world
    for g, (mine, muls) in enumerate(zip(table, _jax_schedule(
            monkeypatch, sizes, ms))):
        want = []
        for cell, q, slab, rnd in muls:
            if rows[q] == 0:
                continue
            word = 0 if slab is None else 1 + int(np.ravel_multi_index(
                slab, (nd, lanes, maxw)))
            want.append((int(np.ravel_multi_index(cell, sizes)), q, q * ms,
                         rows[q], word, rnd))
        assert mine == want, g
        assert sorted((c, q) for c, q, *_ in mine) == [
            (c, q) for c in range(world) for q in range(lanes) if rows[q]]
        own = sum(1 for r in rows if r)
        assert all(c == g and w == 0 and r == 0
                   for c, _, _, _, w, r in mine[:own])
        assert all(c != g and w > 0 and r > 0
                   for c, _, _, _, w, r in mine[own:])


@pytest.mark.parametrize("sizes,m", [((2, 2), 512), ((2, 4), 6),
                                     ((2, 2, 2), 100)])
def test_piece_args_pack_every_rank(sizes, m):
    """The kernel's arguments: one lane list and one list of runs for every
    rank (both rank-independent), each rank's cells and words in its row,
    every word inside the instance's signal words; each run's first piece,
    the runs in order, none empty, at most the kernel's 8."""
    nd = len(sizes)
    ms = torus._pieces(m, nd, torch.bfloat16)
    table = torus.ag_gemm_pieces(sizes, m, ms)
    count, lanes, cells, waits, runs, starts = torus._piece_args(
        tuple(sizes), m, ms)
    world = len(table)
    assert count == len(table[0]) <= world * 2 * nd
    for g, rank in enumerate(table):
        assert [q for _, q, *_ in rank] == list(lanes)
        assert [c for c, *_ in rank] == list(cells[g * count:(g + 1) * count])
        assert [p[4] for p in rank] == list(
            waits[g * count:(g + 1) * count])
        run_of = [p[5] for p in rank]
        assert run_of == sorted(run_of)
        assert [run_of[i] for i in starts] == sorted(set(run_of))
    assert list(starts)[0] == 0 and len(starts) == runs <= 8
    words = 1 + nd * 2 * nd * max(sizes)
    assert max(waits) < words
