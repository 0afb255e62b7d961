"""K7 (`matmul_w8a8`) and K11-int8 (`ag_group_gemm_w8a8`) on the int8 Hopper
tile, the parts the CPU can hold: K7's tile and k-split planner, the
weights' K-major layout (read in place, or one counted copy), the layers'
storage of their int8 weights, and K11-int8's plain version zeroing by the
Hopper body's 64-row boxes.  The layers' parity with the JAX layers on the
same numpy weights is held by tests/test_torch_int8.py and
tests/test_torch_w8a8_tp.py; the kernels themselves by the ``gpu`` tests of
tests/test_torch_gpu.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.kernels import quantized
from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
    ag_group_gemm_w8a8_plain)
from triton_distributed_tpu_torch.kernels.grouped_gemm import (
    grouped_matmul_w8a8_reference)
from triton_distributed_tpu_torch.kernels.quantized import (
    H100_SMS, K_STAGE, MIN_SPLIT_STAGES, W8A8_TILES, k_major, matmul_w8a8,
    matmul_w8a8_reference, plan_w8a8, quantize_sym)
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP

#: (m, k, n): Qwen3-8B's W8A8 MLP at 2048 and 8 rows, world 4's down a
#: rank, a mid-sized prefill, and ragged and tiny edges.
PLAN_SHAPES = [(2048, 4096, 24576), (2048, 12288, 4096), (8, 4096, 24576),
               (8, 12288, 4096), (2048, 3072, 4096), (512, 12288, 4096),
               (300, 4096, 1000), (37, 1024, 999), (130, 208, 640),
               (33, 8192, 1000), (1, 16, 1), (64, 64, 64), (65, 128, 128),
               (8, 3072, 4096), (16, 100_000, 16)]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_w8a8_tiles_and_k_ranges(m, k, n):
    """Every shape gets one of the kernel's tiles (64 x 128 up to 64 rows,
    128 x 256 above), k is split only when the tiles fill less than a wave
    of SMs, into units within one wave and ranges of at least
    `MIN_SPLIT_STAGES`, and the k ranges cover [0, k) exactly once, in
    order, none empty, none past the stages a range holds."""
    plan = plan_w8a8(m, n, k)
    assert (plan.rows, plan.tn) == W8A8_TILES[0 if m > 64 else 1]
    tiles = -(-m // plan.rows) * -(-n // plan.tn)
    if plan.split > 1:
        assert tiles * plan.split <= H100_SMS
        assert plan.per >= MIN_SPLIT_STAGES
    else:
        assert (tiles * 2 > H100_SMS
                or -(-k // K_STAGE) < 2 * MIN_SPLIT_STAGES)
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.split
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 < k1 and k1 - k0 <= plan.per * K_STAGE
        assert k0 % K_STAGE == 0


def test_plan_w8a8_splits_the_decode_weight_stream():
    """The prefill shapes and the 8-row gate_up (192 column tiles) keep k
    whole; the 8-row down projection, 32 column tiles of 128, splits k in
    4 ranges of 24 stages: 128 units, one wave."""
    for m, k, n in PLAN_SHAPES[:3] + PLAN_SHAPES[4:5]:
        assert plan_w8a8(m, n, k).split == 1
    assert plan_w8a8(8, 4096, 12288) == quantized.W8A8Plan(64, 128, 4, 24)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_w8a8_same_bits_either_layout(out_dtype):
    """The plain path gives the same bits for b_q given (k, n) contiguous or
    as the transposed view of a contiguous (n, k) tensor (the layers'
    storage); the view is what the kernel reads in place."""
    rng = np.random.default_rng(3)
    m, k, n = 37, 208, 100
    a_q, sa = quantize_sym(torch.from_numpy(rng.standard_normal(
        (m, k)).astype(np.float32)), 1)
    b_q, sb = quantize_sym(torch.from_numpy(rng.standard_normal(
        (k, n)).astype(np.float32)), 0)
    view = b_q.t().contiguous().t()
    assert not view.is_contiguous() and view.t().is_contiguous()
    got = matmul_w8a8(a_q, view, sa, sb, out_dtype=out_dtype)
    want = matmul_w8a8(a_q, b_q, sa, sb, out_dtype=out_dtype)
    assert torch.equal(got, want)
    assert torch.equal(want, matmul_w8a8_reference(a_q, b_q, sa, sb,
                                                   out_dtype))


def test_k_major_reads_the_stored_layout_in_place():
    """`k_major` returns the stored (n, k) tensor itself for a K-major
    b_q and one counted copy for a (k, n) contiguous one."""
    b = torch.arange(24, dtype=torch.int8).reshape(4, 6)
    before = matmul_w8a8.transposes
    stored = b.t().contiguous()
    same = k_major(stored.t())
    assert same.data_ptr() == stored.data_ptr() and same.is_contiguous()
    assert matmul_w8a8.transposes == before
    copy = k_major(b)
    assert copy.is_contiguous() and torch.equal(copy, b.t())
    assert matmul_w8a8.transposes == before + 1
    quantized.matmul_w8a8.transposes = before


def _k_major(t) -> bool:
    return t.transpose(-1, -2).is_contiguous() and not t.is_contiguous()


@pytest.mark.parametrize("world", [1, 4])
def test_tpmlp_w8a8_stores_k7_weights_k_major(world):
    """`TPMLP(mode="w8a8")` keeps the weights K7 reads K-major (both at
    world 1, ``down_q`` at world W; ``gate_up_q`` at world W feeds K13 and
    stays (k, n)), with the JAX layout's shapes; `quantize_params` returns
    the JAX layout, contiguous, and numpy arrays load unchanged."""
    hidden, ffn = 32, 48
    mlp = TPMLP(hidden, ffn, mode="w8a8", world_size=world, device="cpu")
    lead = (world,) if world > 1 else ()
    f = ffn // world
    assert mlp.gate_up_q.shape == (*lead, hidden, 2 * f)
    assert mlp.down_q.shape == (*lead, f, hidden)
    assert _k_major(mlp.down_q)
    assert _k_major(mlp.gate_up_q) == (world == 1)
    rng = np.random.default_rng(world)
    floats = {"gate_up": torch.from_numpy(rng.standard_normal(
        (*lead, hidden, 2 * f)).astype(np.float32)),
              "down": torch.from_numpy(rng.standard_normal(
                  (*lead, f, hidden)).astype(np.float32))}
    q = TPMLP.quantize_params(floats)
    assert all(t.is_contiguous() for t in q.values())
    mlp.load_quantized({k: v.numpy() for k, v in q.items()})
    for name, want in q.items():
        assert torch.equal(getattr(mlp, name), want), name
    assert _k_major(mlp.down_q)
    other = TPMLP(hidden, ffn, mode="w8a8", world_size=world, device="cpu")
    other.load_state_dict(mlp.state_dict())
    assert torch.equal(other.down_q, mlp.down_q) and _k_major(other.down_q)


def test_moe_mlp_w8a8_stores_k11_weights_k_major():
    """`MoEMLP(mode="w8a8")` at world 4 keeps ``gate_up_q`` (K11-int8's)
    K-major with the rank-stacked JAX shape, ``down_q`` (K10's) as (k, n);
    the global JAX-layout parameters load and come back unchanged."""
    h, ffn, e, world = 16, 8, 4, 4
    layer = MoEMLP(h, ffn, e, mode="w8a8", world_size=world,
                   dtype=torch.float32, device="cpu")
    assert layer.gate_up_q.shape == (world, e, h, 2 * ffn // world)
    assert _k_major(layer.gate_up_q) and layer.down_q.is_contiguous()
    rng = np.random.default_rng(7)
    params = {"router": rng.standard_normal((h, e)).astype(np.float32),
              "gate_up": rng.standard_normal((e, h, 2 * ffn)).astype(
                  np.float32),
              "down": rng.standard_normal((e, ffn, h)).astype(np.float32)}
    q = MoEMLP.quantize_params({k: torch.from_numpy(v)
                                for k, v in params.items()})
    assert q["gate_up_q"].shape == (e, h, 2 * ffn)
    layer.load_jax_params({k: v.numpy() for k, v in q.items()})
    assert _k_major(layer.gate_up_q)
    back = layer.jax_params()
    for name, want in q.items():
        assert torch.equal(back[name], want), name
    deq = MoEMLP.dequantize_params(layer.params())
    assert deq["gate_up"].is_contiguous() and deq["down"].is_contiguous()


def test_ag_group_gemm_w8a8_plain_zeroes_by_hopper_box():
    """The plain version zeroes the 64-row boxes (the Hopper body's row
    tile) that start at or past a bucket's count and keeps every row of a
    box that holds a token, for weights in either layout."""
    world, e, cap, k, n = 2, 3, 160, 32, 24
    rng = np.random.default_rng(5)
    a_q, sa = quantize_sym(torch.from_numpy(rng.standard_normal(
        (world, e, cap, k)).astype(np.float32)), -1)
    w_q, sw = quantize_sym(torch.from_numpy(rng.standard_normal(
        (world, e, k, n)).astype(np.float32)), 2)
    counts = torch.tensor([[0, 64, 65], [150, 1, 128]])
    got = ag_group_gemm_w8a8_plain(a_q, sa, w_q, sw, torch.float32, counts)
    same = ag_group_gemm_w8a8_plain(
        a_q, sa, w_q.transpose(-1, -2).contiguous().transpose(-1, -2), sw,
        torch.float32, counts)
    assert torch.equal(got, same)
    for r in range(world):
        for c in range(world):
            full = grouped_matmul_w8a8_reference(a_q[c], w_q[r], sa[c], sw[r],
                                                 torch.float32)
            for x in range(e):
                live = -(-int(counts[c, x]) // 64) * 64
                assert torch.equal(got[r, c, x, :live], full[x, :live])
                assert not got[r, c, x, live:].any()
