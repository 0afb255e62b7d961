"""The order in which the bf16 flash backward's persistent blocks take
their items (K4: a (batch, query head, 128 query rows) item walks K/V
stages of 64 keys; K5: a (batch, KV head, 64 keys) item walks the Q/dO
stages of 64 rows of each query head of its group), held on the CPU:
`flash_attention.bwd_items` is the numbering the kernels compute
(csrc/flash_attention_bwd.cu `Dq::item`, `Dkv::item`), `snake` the blocks'
rounds (`item_of`).

Over batches, GQA groups 1-8, Sq and Sk ragged and at the tiles' edges,
causal or not, and kv_offset negative, zero and positive:
- every item appears exactly once;
- items come heaviest first;
- each item's count of stages equals the count of tiles that hold a
  visible (query row, key) pair under the plain causal mask (query row i
  sees keys <= i + kv_offset, as in `flash_attention_backward_reference`),
  times the group for K5;
- the snake hands every item to exactly one block.
No item is split, so no range needs covering twice.
"""

import pytest
import torch

from triton_distributed_tpu_torch.kernels.flash_attention import (
    BWD_DKV_TILE, BWD_DQ_TILE, bwd_balance, bwd_items, snake)

LENGTHS = [(1, 1), (63, 64), (64, 64), (65, 65), (127, 129), (128, 128),
           (129, 255), (255, 129), (256, 256), (300, 700), (700, 300)]
OFFSETS = [-128, -70, 0, 64, 2048]
#: (batch, KV heads, group)
HEADS = [(1, 1, 1), (2, 2, 3), (1, 1, 8), (3, 2, 4)]


def _keep(sq, sk, causal, kv_offset):
    """The plain version's mask: (sq, sk), query row i sees key j when
    j <= i + kv_offset (every key when not causal)."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool)
    qpos = torch.arange(sq)[:, None] + kv_offset
    kpos = torch.arange(sk)[None, :]
    return kpos <= qpos


def _want(which, b, hkv, group, sq, sk, causal, kv_offset):
    """(batch, head, first) -> stages, from the mask."""
    keep = _keep(sq, sk, causal, kv_offset)
    want = {}
    if which == "dq":
        rows, keys = BWD_DQ_TILE
        for q0 in range(0, sq, rows):
            n = sum(bool(keep[q0:q0 + rows, k0:k0 + keys].any())
                    for k0 in range(0, sk, keys))
            for bi in range(b):
                for hh in range(hkv * group):
                    want[(bi, hh, q0)] = n
    else:
        keys, rows = BWD_DKV_TILE
        for k0 in range(0, sk, keys):
            n = sum(bool(keep[q0:q0 + rows, k0:k0 + keys].any())
                    for q0 in range(0, sq, rows))
            for bi in range(b):
                for hk in range(hkv):
                    want[(bi, hk, k0)] = group * n
    return want


def _cases():
    for sq, sk in LENGTHS:
        yield sq, sk, False, 0
        for off in OFFSETS:
            yield sq, sk, True, off


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("sq,sk,causal,kv_offset", list(_cases()))
def test_bwd_items_cover_the_mask_heaviest_first(which, sq, sk, causal,
                                                 kv_offset):
    for b, hkv, group in HEADS:
        h = hkv * group
        items = bwd_items(which, b, h, hkv, sq, sk, causal, kv_offset)
        keys = [it[:3] for it in items]
        assert len(set(keys)) == len(keys), "an item appears twice"
        want = _want(which, b, hkv, group, sq, sk, causal, kv_offset)
        assert set(keys) == set(want), "items missing or extra"
        got = {it[:3]: it[3] for it in items}
        assert got == want, (b, h, hkv)
        stages = [it[3] for it in items]
        assert stages == sorted(stages, reverse=True), "not heaviest first"


@pytest.mark.parametrize("n_items,blocks", [(1, 1), (5, 5), (7, 3),
                                            (512, 132), (256, 132),
                                            (133, 132), (264, 132)])
def test_snake_hands_each_item_to_one_block(n_items, blocks):
    taken = snake(n_items, blocks)
    assert len(taken) == blocks
    flat = sorted(it for per in taken for it in per)
    assert flat == list(range(n_items))
    for r in range(max(len(per) for per in taken)):
        # A round's items are consecutive, forwards and backwards in turn.
        row = [per[r] for per in taken if len(per) > r]
        step = 1 if r % 2 == 0 else -1
        assert all(b - a == step for a, b in zip(row, row[1:])), r


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("b,sq", [(4, 512), (1, 2048)])
def test_bwd_training_shapes_are_balanced(which, b, sq):
    """At the training shapes (32/8 heads, causal) the busiest block's
    stage times stay within 5% of the mean: no item sets the time."""
    worst, mean = bwd_balance(which, b, 32, 8, sq, sq)
    assert worst <= 1.05 * mean, (worst, mean)
