"""The plans of K18's barrier and broadcast and K17 ``two_shot`` on the CPU
(``kernels/csrc/common_ops.cu``, ``csrc/scatter_sum.cuh``), as their
plain-Python models give them (`common_ops.barrier_plan`,
`common_ops.broadcast_plan`, `allreduce.two_shot_plan`): which block copies
which range of which chunk to which rank, and which word each block adds to
and waits on.

`run` executes a plan of one call at epoch 0 in an order the waits allow
and tracks, for every event, the copies that happen before it (program
order, and every add to a word before a wait on it, since each wait's
target is the sum of the adds its word receives in the call).  For W in
2..8, every root and P in {1, 3, 7} of a bank of 66 words (as residency
caps it), at W = 2 and 8 also P in {1, 3, 7} of a bank of 256 and P = 66
of 66, and at W = 2 and 4 P = 256 (`GRID`), it holds that

- no block waits forever, and every wait's target is its word's adds;
- every output element (and receive slot) is written exactly once, with
  the right value (the root's x; the sum of the partials in rank order);
- every read of a buffer another block writes comes after that write (the
  waits are paired to the writers), and every write into a rank's output
  happens before some block of that rank ends;
- every word's adds in a call sum to the same multiple of P for every
  root, and every word a block may wait on gets them.

The sizes are small, ragged and aligned, some with empty chunks or parts.
"""

import collections

import numpy as np
import pytest

from triton_distributed_tpu_torch.kernels import allreduce, common_ops
from triton_distributed_tpu_torch.language.core import (
    MAX_BLOCKS, owned_words, share)

WORLDS = range(2, 9)
#: (P, bank): blocks a rank, and the most a launch of the kernel can have
#: (the words of a bank in use; the card's residency caps it, e.g. 66 at
#: W = 4 for two-shot on an H100).
BLOCKS = ((1, 256), (3, 256), (7, 256), (256, 256), (1, 66), (3, 66),
          (7, 66), (66, 66))
#: (W, P, bank) of the broadcast and two-shot plans, kept to a few seconds
#: (a run's cost grows with W P and W^2 bank): P in {1, 3, 7} of a bank of
#: 66 at every W; of the whole bank of MAX_BLOCKS, and P = 66 filling a bank
#: of 66, at W = 2 and 8; P = MAX_BLOCKS (one word a block) at W = 2 and 4.
GRID = ([(w, p, 66) for w in WORLDS for p in (1, 3, 7)]
        + [(w, p, bank) for w in (2, 8)
           for p, bank in ((1, 256), (3, 256), (7, 256), (66, 66))]
        + [(w, 256, 256) for w in (2, 4)])


def run(plan, bufs):
    """Execute ``plan`` on ``bufs`` ({name: (W, n) float64 arrays}, NaN where
    nothing was written) and check it.  Returns ({(rank, word): adds},
    {name: (W, n) writer ids}); raises AssertionError on a deadlock, a read
    of something not yet known written, or a second write."""
    world = max(r for r, _ in plan) + 1
    writer = {k: np.full(v.shape, -1, dtype=np.int64) for k, v in bufs.items()}
    adds = collections.defaultdict(int)
    for evs in plan.values():
        for ev in evs:
            if ev[0] == "add":
                for q, word, n in ev[1]:
                    adds[(q, word)] += n
    adds = dict(adds)
    waits = {}                           # (block, event) -> word keys
    for block, evs in plan.items():
        for i, ev in enumerate(evs):
            if ev[0] == "wait":
                for w, t in ev[1]:
                    assert adds.get((block[0], w), 0) == t, (block, w, t)
                waits[(block, i)] = [(block[0], w) for w, t in ev[1] if t]
    waited = {k for keys in waits.values() for k in keys}
    notes = {}                           # (block, event) -> waited words
    for block, evs in plan.items():
        for i, ev in enumerate(evs):
            if ev[0] == "add":
                notes[(block, i)] = [((q, w), n) for q, w, n in ev[1]
                                     if (q, w) in waited]
    arrived = dict.fromkeys(adds, 0)     # adds made so far
    add_masks = dict.fromkeys(adds, 0)   # copies known to precede them
    whole = set()                        # words that got all their adds
    pos = dict.fromkeys(plan, 0)
    mask = dict.fromkeys(plan, 0)        # copies known to precede (bits)
    parked = {}                          # (rank, word) -> blocks waiting
    ready = sorted(plan)
    ends, n_writes = {}, 0

    def read(block, src, n):
        name, rank, off = src
        if name == "x" or n == 0:
            return bufs[name][rank, off:off + n]
        ids = writer[name][rank, off:off + n]
        assert ids.min() >= 0, f"{block} reads {src} before any write"
        for i in np.unique(ids).tolist():
            assert mask[block] >> i & 1, (
                f"{block} reads {src} without waiting for write {i}")
        return bufs[name][rank, off:off + n]

    def write(block, dst, vals):
        nonlocal n_writes
        name, rank, off = dst
        n = len(vals)
        if n == 0:
            return
        assert writer[name][rank, off:off + n].max() < 0, (
            f"{block} writes {dst} a second time")
        writer[name][rank, off:off + n] = n_writes
        bufs[name][rank, off:off + n] = vals
        mask[block] |= 1 << n_writes
        n_writes += 1

    while ready:
        block = ready.pop()
        evs = plan[block]
        while pos[block] < len(evs):
            ev = evs[pos[block]]
            if ev[0] == "wait":
                keys = waits[(block, pos[block])]
                short = next((k for k in keys if k not in whole), None)
                if short is not None:
                    parked.setdefault(short, []).append(block)
                    break
                m = mask[block]
                for key in keys:
                    m |= add_masks[key]
                mask[block] = m
            elif ev[0] == "add":
                m = mask[block]
                for key, n in notes[(block, pos[block])]:
                    add_masks[key] |= m
                    arrived[key] += n
                    if arrived[key] == adds[key]:
                        whole.add(key)
                        ready += parked.pop(key, [])
            elif ev[0] == "copy":
                vals = read(block, ev[1], ev[3]).copy()
                for dst in ev[2]:
                    write(block, dst, vals)
            else:                                            # "sum"
                acc = np.zeros(ev[3])
                for src in ev[1]:
                    acc = acc + read(block, src, ev[3])
                for dst in ev[2]:
                    write(block, dst, acc)
            pos[block] += 1
        else:
            ends[block] = mask[block]
    stuck = [blk for blk in plan if blk not in ends]
    assert not stuck, f"deadlock: {stuck[:4]} wait forever"
    seen = [0] * world                   # copies before a rank's ends
    for (r, _), m in ends.items():
        seen[r] |= m
    for q in range(world):
        for i in np.unique(writer["out"][q]).tolist():
            assert seen[q] >> i & 1, f"rank {q} ends before write {i}"
    return adds, writer


def word_multiples(adds, blocks):
    """{(rank, word): adds / P}, every total a whole multiple of P."""
    out = {}
    for key, n in adds.items():
        assert n % blocks == 0, (key, n, blocks)
        out[key] = n // blocks
    return out


def seeded(world, n, seed):
    return np.random.default_rng(seed).integers(
        -64, 64, size=(world, n)).astype(np.float64)


@pytest.mark.parametrize("world,blocks,bank", GRID)
def test_broadcast_plan(world, blocks, bank):
    """Every root: each rank's out is the root's x, each element written
    once; each block's wait is paired to the root's block that wrote its
    part; the words' adds are the same multiples of P whichever rank is the
    root."""
    for nbytes in (40, 16 * world * 5, 16 * world * 5 + 10):
        totals = None
        for root in range(world):
            x = seeded(world, nbytes, world * 1000 + root + nbytes)
            bufs = {"x": x, "out": np.full((world, nbytes), np.nan)}
            adds, writer = run(common_ops.broadcast_plan(
                nbytes, world, root, blocks, bank), bufs)
            assert np.array_equal(bufs["out"], np.broadcast_to(
                x[root], (world, nbytes)))
            assert (writer["out"] >= 0).all()
            mult = word_multiples(adds, blocks)
            assert totals is None or mult == totals, (root, nbytes)
            totals = mult
        # Word 0: W - 1 peers; the arrival bank: the root's block, at every
        # rank, its own included.
        for q in range(world):
            assert totals[(q, 0)] == world - 1
            for g in range(bank):
                assert totals[(q, common_ops.ARRIVAL_WORD + g)] == 1
        assert len(totals) == world * (1 + bank)


@pytest.mark.parametrize("blocks", sorted({p for p, _ in BLOCKS}))
@pytest.mark.parametrize("world", [1, *WORLDS])
def test_barrier_plan(world, blocks):
    """Each rank's out is its x, each element written once by its own
    rank; word 0 gets W - 1 adds of P a call (one from block 0 of each
    peer), not (W - 1) P adds of one."""
    for nbytes in (40, 16 * 37 + 10, 16 * 64):
        x = seeded(world, nbytes, world + nbytes)
        bufs = {"x": x, "out": np.full((world, nbytes), np.nan)}
        plan = common_ops.barrier_plan(nbytes, world, blocks)
        adds, _ = run(plan, bufs)
        assert np.array_equal(bufs["out"], x)
        for q in range(world):
            assert adds.get((q, 0), 0) == (world - 1) * blocks
        remote = [a for evs in plan.values() for e in evs if e[0] == "add"
                  for a in e[1]]
        assert len(remote) == world * (world - 1)


@pytest.mark.parametrize("world,blocks,bank",
                         [(1, p, bank) for p, bank in BLOCKS] + GRID)
def test_two_shot_plan(world, blocks, bank):
    """Every rank's out is the sum of the partials in rank order, each
    element written once; the foreign chunks land in the receive slots once
    (the own chunk is never copied); each block's waits cover exactly the
    blocks that wrote its range."""
    banks = {(q, base + s * MAX_BLOCKS + g): 1 for q in range(world)
             for s in range(world) if s != q for g in range(bank)
             for base in (2, allreduce.OUT_WORD)}
    for chunk in (3, 8 * 5, 8 * 5 + 3):
        elems = world * chunk
        x = seeded(world, elems, world * 100 + chunk)
        bufs = {"x": x, "out": np.full((world, elems), np.nan),
                "rbuf": np.full((world, elems), np.nan)}
        adds, writer = run(allreduce.two_shot_plan(elems, world, blocks,
                                                   bank), bufs)
        total = x[0].copy()
        for r in range(1, world):
            total = total + x[r]
        assert np.array_equal(bufs["out"], np.broadcast_to(
            total, (world, elems)))
        assert (writer["out"] >= 0).all()
        for r in range(world):
            slot = writer["rbuf"][r].reshape(world, chunk)
            assert (slot[r] < 0).all() and (np.delete(slot, r, 0) >= 0).all()
        mult = word_multiples(adds, blocks)
        assert {k: n for k, n in mult.items() if k[1] >= 2} == banks


def test_shares_tile_the_payload():
    """`share` over the parts tiles n in whole units but the last part's
    tail; `owned_words` over the blocks tiles the bank."""
    for n in (1, 15, 16, 40, 1000, 16 * 37 + 10):
        for unit in (8, 16):
            for parts in (*WORLDS, *{p for p, _ in BLOCKS}):
                got = [share(n, unit, i, parts) for i in range(parts)]
                assert got[0][0] == 0 and got[-1][1] == n
                assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
                assert all(lo % unit == 0 for lo, _ in got)
    for blocks, bank in BLOCKS:
        words = sorted(g for b in range(blocks)
                       for g in owned_words(b, blocks, bank))
        assert words == list(range(bank))
