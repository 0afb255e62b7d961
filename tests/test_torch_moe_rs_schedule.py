"""K10's Hopper body on the CPU: the stores of `moe_reduce_rs.wgmma_stores`,
the plain model of what the body writes into its packed stage (for each
unit of `allgather_group_gemm.unit_list` and each live box, the bucket rows
below the count, each to row ``base[c, e] + 64 i + j`` of chunk c's stage),
held against `moe_utils.plan_chunks` plans and K10's plain version.

For worlds 2, 4 and 8, capacities 16, 64, 96 and 128 (pack blocks 16, 64,
32 and 128) and random routing, every pair to one expert, and a chunk
whose pairs were all dropped:
- every kept pair's stage row (`moe_utils.combine_pairs`) is written exactly
  once for every column tile, and no other row is written;
- no write leaves chunk c's T B rows, lands on another expert's packed
  blocks, or comes from a bucket row at or past the count;
- the stage built box by box from the model (every other row NaN), then the
  combine and the rank-order sum, equals `moe_reduce_rs_fused_plain` bit for
  bit in f32.
"""

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.kernels import moe_utils
from triton_distributed_tpu_torch.kernels.grouped_gemm import (
    grouped_matmul_reference, packed_combine_reference)
from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
    moe_reduce_rs_fused_plain, wgmma_stores)
from triton_distributed_tpu_torch.kernels.reduce_scatter import (
    sum_in_rank_order)

EXPERTS, TOPK, ROWS, K, N = 6, 4, 40, 16, 136  # N: two column tiles of 128


def _drop_chunk(plan, c):
    """``plan`` with every pair of chunk c dropped: no counts, blocks or
    kept pairs there."""
    mc = plan.combine_blocks.shape[3]
    f = {name: t.clone() for name, t in plan._asdict().items()}
    f["dispatch_index"][c] = mc
    f["slot_of_pair"][c] = -1
    for name in ("counts", "block_expert", "block_slot", "n_blocks",
                 "combine_blocks"):
        f[name][c] = 0
    return type(plan)(**f)


def _plan(case, world, cap):
    rng = np.random.default_rng(world * 1000 + cap)
    n = world * ROWS
    if case == "one expert":
        ids = np.full((n, TOPK), EXPERTS - 1)
    else:
        ids = np.argsort(rng.random((n, EXPERTS)), -1)[:, :TOPK]
    w = rng.random((n, TOPK)).astype(np.float32)
    plan = moe_utils.plan_chunks(torch.from_numpy(ids).to(torch.int32),
                                 torch.from_numpy(w), world, EXPERTS, cap)
    return _drop_chunk(plan, world - 1) if case == "empty chunk" else plan


@pytest.mark.parametrize("case", ["random", "one expert", "empty chunk"])
@pytest.mark.parametrize("cap", [16, 64, 96, 128])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_wgmma_stores_cover_the_kept_pairs(world, cap, case):
    plan = _plan(case, world, cap)
    block = plan.pack_block_size
    trows = plan.num_blocks_static * block
    st = wgmma_stores(plan.counts, world, EXPERTS, cap, N, block)
    blocks_e, off = moe_utils._block_offsets(plan.counts.long(), block)
    c, e, slot, row = st["chunk"], st["expert"], st["slot"], st["row"]
    # Inside the chunk's stage, the expert's packed blocks and its count.
    assert bool((row >= 0).all() and (row < trows).all())
    assert bool((row >= off[c, e] * block).all())
    assert bool((row < (off[c, e] + blocks_e[c, e]) * block).all())
    assert bool((slot < plan.counts[c, e]).all())
    assert bool((row - slot == off[c, e] * block).all())
    # Each counted row once a column tile; with the kept pairs' rows among
    # them (every counted slot holds a kept pair).
    rows, _ = moe_utils.combine_pairs(plan, TOPK)
    for col in range(-(-N // 128)):
        mine = st["col"] == col
        key = c[mine] * trows + row[mine]
        assert key.unique().numel() == key.numel()
        want = (torch.arange(world)[:, None, None] * trows
                + rows.long())[rows >= 0]
        assert torch.equal(key.sort().values, want.sort().values)
    if case == "empty chunk":
        assert not bool((c == world - 1).any())


@pytest.mark.parametrize("world,cap,case", [
    (2, 16, "random"), (4, 64, "random"), (4, 96, "empty chunk"),
    (8, 64, "random"), (4, 128, "one expert")])
def test_stage_from_the_stores_gives_the_plain_version(world, cap, case):
    plan = _plan(case, world, cap)
    block = plan.pack_block_size
    trows = plan.num_blocks_static * block
    gen = torch.Generator().manual_seed(world + cap)
    a = torch.randn((world, world, EXPERTS, cap, K), generator=gen)
    b = torch.randn((world, EXPERTS, K, N), generator=gen)
    rows, wts = moe_utils.combine_pairs(plan, TOPK)
    st = wgmma_stores(plan.counts, world, EXPERTS, cap, N, block)
    partials = []
    for r in range(world):
        stage = torch.full((world, trows, N), float("nan"))
        for ch in range(world):
            dense = grouped_matmul_reference(a[r, ch], b[r], torch.float32)
            for col in range(-(-N // 128)):
                m = (st["chunk"] == ch) & (st["col"] == col)
                cols = slice(128 * col, 128 * col + 128)
                stage[ch, st["row"][m], cols] = dense[
                    st["expert"][m], st["slot"][m], cols]
        partials.append(torch.stack([
            packed_combine_reference(stage[ch], rows[ch], wts[ch])
            for ch in range(world)]))
    got = torch.stack([sum_in_rank_order(torch.stack(partials)[:, ch])
                       for ch in range(world)])
    want = moe_reduce_rs_fused_plain(a, b, plan, rows, wts)
    assert bool(got.isfinite().all())
    assert torch.equal(got, want)
