"""The port's int8 tensor parallelism at world 4 against the JAX package on
the CPU: AllGather-GroupGEMM on int8 buckets (K11-int8's plain version)
and AllGather-GEMM on int8 rows (K13's plain version), both bit for bit;
MoE-Reduce-RS with int8 weights (K10's plain version); `MoEMLP` in
``w8a8`` mode at world 4; `TPMLP` in ``w8a8`` mode at world 2 and 4.

The JAX side runs as tests/test_quantized.py and tests/test_layers.py run
it: `shard_map` over the conftest's virtual CPU devices, Pallas in
interpret mode.  The same seeded numpy inputs go to both.

Bit for bit where both sides accumulate int8 products exactly in int32
and apply the same f32 epilogue (float(acc) * sa) * sb to the same
quantized operands; 1e-4 (f32) where a combine or a sum over the ranks
follows, whose order differs, or where each side quantizes for itself
(jitted, JAX multiplies by 1/127 where the port divides by 127, so a
scale can differ by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.kernels import moe_utils as jax_moe_utils
from triton_distributed_tpu.kernels.allgather_gemm import (
    AllGatherGEMMContext as JaxAGContext)
from triton_distributed_tpu.kernels.allgather_gemm import (
    ag_gemm_w8a8 as jax_ag_gemm_w8a8)
from triton_distributed_tpu.kernels.allgather_group_gemm import (
    AGGroupGEMMContext as JaxAGGroupContext)
from triton_distributed_tpu.kernels.allgather_group_gemm import (
    ag_group_gemm_w8a8 as jax_ag_group_gemm_w8a8)
from triton_distributed_tpu.kernels.moe_reduce_rs import (
    MoEReduceRSContext as JaxMoERSContext)
from triton_distributed_tpu.kernels.moe_reduce_rs import (
    moe_reduce_rs_fused as jax_moe_reduce_rs_fused)
from triton_distributed_tpu.kernels.quantized import (
    quantize_sym as jax_quantize_sym)
from triton_distributed_tpu.layers.moe_mlp import MoEMLP as JaxMoEMLP
from triton_distributed_tpu.layers.tp_mlp import TPMLP as JaxTPMLP
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch.kernels import moe_utils
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    AllGatherGEMMContext, ag_gemm_w8a8, ag_gemm_w8a8_plain)
from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
    AGGroupGEMMContext, ag_group_gemm_w8a8, ag_group_gemm_w8a8_plain)
from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
    MoEReduceRSContext, moe_reduce_rs_fused)
from triton_distributed_tpu_torch.kernels.quantized import quantize_sym
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP
from triton_distributed_tpu_torch.layers.tp_attn import (
    stack_columns, stack_rows)
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP

LAYER = dict(atol=1e-4, rtol=1e-4)


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


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


def _jax_quantized(mesh, x, spec):
    """JAX's per-token quantization of each rank's shard as its kernels
    see it: jitted inside `shard_map` (XLA multiplies by 1/127 there, so a
    scale can sit an ulp from the eager function's and the port's)."""
    fn = shard_map_op(lambda v: jax_quantize_sym(v, axis=-1), mesh,
                      in_specs=(spec,), out_specs=(spec, P(*spec[:-1])))
    q, s = jax.jit(fn)(x)
    return torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))


@pytest.mark.parametrize("with_counts", [False, True])
def test_ag_group_gemm_w8a8_matches_jax_bitwise(tp4_mesh, with_counts):
    """Every rank's int8 grouped product of the gathered buckets with its
    column shard, and the dequant epilogue: the plain version on JAX's
    quantized buckets is bit for bit the JAX kernel's output (f32), with
    and without the counts; the wrapper, quantizing itself, within 1e-4."""
    world, e, cap, k, n = 4, 4, 32, 128, 32
    counts = np.random.default_rng(14).integers(0, cap + 1, (world, e))
    counts = counts.astype(np.int32)
    buckets = _rand(12, world, e, cap, k, scale=0.25) * (
        np.arange(cap)[None, None, :, None] < counts[:, :, None, None])
    w = _rand(13, e, k, world * n, scale=0.25)
    w_q, sw = jax_quantize_sym(jnp.asarray(w), axis=1)      # (E, W n)
    ctx = JaxAGGroupContext(axis="tp", world_size=world, num_experts=e,
                            interpret=True)
    fn = shard_map_op(
        lambda bk, wq, sws, ct: jax_ag_group_gemm_w8a8(
            bk[0], wq, sws, ctx, counts=ct if with_counts else None),
        tp4_mesh, in_specs=(P("tp", None, None, None), P(None, None, "tp"),
                            P(None, "tp"), P(None, None)),
        out_specs=P(None, None, None, "tp"))
    want = np.asarray(jax.jit(fn)(buckets, w_q, sw, counts))
    wq_t = stack_columns(torch.from_numpy(np.array(w_q)), world)
    sw_t = stack_columns(torch.from_numpy(np.array(sw)), world)
    counts_t = torch.from_numpy(counts) if with_counts else None
    bq, sa = _jax_quantized(tp4_mesh, buckets, P("tp", None, None, None))
    plain = ag_group_gemm_w8a8_plain(bq, sa, wq_t, sw_t, torch.float32,
                                     counts_t)
    got = ag_group_gemm_w8a8(
        torch.from_numpy(buckets), wq_t.contiguous(), sw_t.contiguous(),
        AGGroupGEMMContext("tp", world, e), counts=counts_t)
    assert got.dtype == torch.float32 and got.shape == (world, world, e,
                                                        cap, n)
    for r in range(world):
        np.testing.assert_array_equal(plain[r].numpy(),
                                      want[..., r * n:(r + 1) * n])
        _close(got[r], want[..., r * n:(r + 1) * n], LAYER)


@pytest.mark.parametrize("m_loc", [10, 32])
def test_ag_gemm_w8a8_matches_jax_bitwise(tp4_mesh, m_loc):
    """K13's plain version on JAX's quantized rows (every rank's int8
    product with its column shard, the dequant epilogue) is bit for bit
    the JAX ring's output (f32), ragged rows too; the wrapper (its own
    quantization, rows padded to 32) within 1e-4."""
    world, k, n = 4, 128, 64
    a = _rand(20, world * m_loc, k, scale=0.25)
    b = _rand(21, k, world * n, scale=0.25)
    b_q, sb = jax_quantize_sym(jnp.asarray(b), axis=0)
    ctx = JaxAGContext(axis="tp", world_size=world, method="fused",
                       interpret=True)
    fn = shard_map_op(lambda x, w, s: jax_ag_gemm_w8a8(x, w, s, ctx),
                      tp4_mesh, in_specs=(P("tp", None), P(None, "tp"),
                                          P("tp")),
                      out_specs=P(None, "tp"))
    want = np.asarray(jax.jit(fn)(a, b_q, sb))            # (W m, W n)
    bq_t = stack_columns(torch.from_numpy(np.array(b_q)), world)
    sb_t = torch.from_numpy(np.array(sb)).reshape(world, n)
    aq, sa = _jax_quantized(tp4_mesh, a, P("tp", None))
    plain = ag_gemm_w8a8_plain(aq.reshape(world, m_loc, k), bq_t,
                               sa.reshape(world, m_loc), sb_t, torch.float32)
    got = ag_gemm_w8a8(torch.from_numpy(a).reshape(world, m_loc, k),
                       bq_t.contiguous(), sb_t,
                       AllGatherGEMMContext("tp", world))
    assert got.shape == (world, world * m_loc, n)
    for r in range(world):
        np.testing.assert_array_equal(plain[r].numpy(),
                                      want[:, r * n:(r + 1) * n])
        _close(got[r], want[:, r * n:(r + 1) * n], LAYER)


def test_ag_gemm_w8a8_world1_and_methods():
    """At world 1 it is `matmul_w8a8` on the quantized rows; only the ring
    (``auto``/``fused``) is accepted, as the JAX wrapper asserts."""
    from triton_distributed_tpu_torch.kernels.quantized import (
        matmul_w8a8_reference)

    a = torch.from_numpy(_rand(22, 12, 64))
    b_q, sb = quantize_sym(torch.from_numpy(_rand(23, 64, 48)), 0)
    a_q, sa = quantize_sym(a, 1)
    got = ag_gemm_w8a8(a, b_q, sb, AllGatherGEMMContext("tp", 1, "fused"))
    assert torch.equal(got, matmul_w8a8_reference(a_q, b_q, sa, sb,
                                                  torch.float32))
    with pytest.raises(ValueError, match="fused ring only"):
        ag_gemm_w8a8(a, b_q, sb, AllGatherGEMMContext("tp", 4, "ll"))


def test_moe_reduce_rs_fused_w8a8_matches_jax(tp4_mesh):
    """Int8 down weights with global (E, n) scales, the activated buckets
    quantized per token on each rank's K shard: within 1e-4 of the JAX
    w8a8 fused epilogue."""
    world, e, cap, mc, k, n = 4, 4, 32, 32, 64, 48
    buckets = _rand(15, world, e, cap, world * k, scale=0.125)
    wdown = _rand(16, e, world * k, n, scale=0.125)
    wq, sw = jax_quantize_sym(jnp.asarray(wdown), axis=1)
    rng = np.random.default_rng(17)
    ids = rng.integers(0, e, (world * mc, 2)).astype(np.int32)
    tw = rng.random((world * mc, 2)).astype(np.float32)
    tw /= tw.sum(-1, keepdims=True)
    jplan = jax_moe_utils.plan_chunks(jnp.asarray(ids), jnp.asarray(tw),
                                      world, e, cap)
    ctx = JaxMoERSContext(axis="tp", world_size=world, num_experts=e,
                          topk=2, interpret=True)
    fn = shard_map_op(
        lambda bk, w_, s_: jax_moe_reduce_rs_fused(bk, w_, jplan, ctx,
                                                   weight_scales=s_),
        tp4_mesh, in_specs=(P(None, None, None, "tp"), P(None, "tp", None),
                            P(None, None)),
        out_specs=P("tp", None))
    want = np.asarray(jax.jit(fn)(buckets, wq, sw))
    plan = moe_utils.plan_chunks(torch.from_numpy(ids), torch.from_numpy(tw),
                                 world, e, cap)
    got = moe_reduce_rs_fused(
        stack_columns(torch.from_numpy(buckets), world).contiguous(),
        stack_rows(torch.from_numpy(np.array(wq)), world).contiguous(),
        plan, MoEReduceRSContext("tp", world, e, 2),
        weight_scales=torch.from_numpy(np.array(sw)))
    _close(got.reshape(world * mc, n), want, LAYER)


def test_moe_mlp_w8a8_world4_matches_jax(tp4_mesh):
    """`MoEMLP(mode="w8a8")` at world 4 on `quantize_params` of the global
    weights (the port's quantization bit for bit the JAX one): within 1e-4
    of the JAX layer; and at 12 rows a rank (the dequantized xla path)."""
    world, h, ffn, e = 4, 64, 64, 4
    rng = np.random.default_rng(31)
    params = {"router": (rng.standard_normal((h, e)) / 8).astype(np.float32),
              "gate_up": (rng.standard_normal((e, h, 2 * ffn)) / 8
                          ).astype(np.float32),
              "down": (rng.standard_normal((e, ffn, h)) / 8
                       ).astype(np.float32)}
    jlayer = JaxMoEMLP(axis="tp", world_size=world, hidden=h, ffn=ffn,
                       num_experts=e, topk=2, mode="w8a8", interpret=True)
    qparams = jlayer.quantize_params({k: jnp.asarray(v)
                                      for k, v in params.items()})
    ported = MoEMLP.quantize_params({k: torch.from_numpy(v)
                                     for k, v in params.items()})
    for name, leaf in qparams.items():
        np.testing.assert_array_equal(ported[name].numpy(), np.asarray(leaf))
    layer = MoEMLP(h, ffn, e, topk=2, mode="w8a8", world_size=world,
                   dtype=torch.float32, device="cpu").load_jax_params(
                       jax.tree.map(np.asarray, qparams))
    for mc in (32, 12):
        x = _rand(30 + mc, world * mc, h, scale=0.25)
        fn = shard_map_op(lambda xx, pp: jlayer(xx, pp), tp4_mesh,
                          in_specs=(P("tp", None),
                                    jlayer.global_param_specs_w8a8()),
                          out_specs=P("tp", None))
        want = np.asarray(jax.jit(fn)(x, qparams))
        got = layer(torch.from_numpy(x).reshape(world, mc, h))
        _close(got.reshape(world * mc, h), want, LAYER)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_mlp_w8a8_matches_jax(world):
    """`TPMLP(mode="w8a8")` at world W, each rank's shard quantized apart
    (as the JAX layer quantizes inside `shard_map`): K13, gated SiLU, K7 a
    rank, the f32 sum over the ranks; within 1e-4 of the JAX layer, tighter
    than the JAX test's int8-error bound against the float layer."""
    hidden, ffn, m = 128, 256, 32
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    x = _rand(40, m, hidden, scale=0.125)
    gate_up = _rand(41, hidden, 2 * ffn, scale=hidden ** -0.5)
    down = _rand(42, ffn, hidden, scale=hidden ** -0.5)
    jmlp = JaxTPMLP(axis="tp", world_size=world, hidden=hidden, ffn=ffn,
                    mode="w8a8", interpret=True)
    fn = shard_map_op(
        lambda xx, gu, dn: jmlp(xx, JaxTPMLP.quantize_params(
            {"gate_up": gu, "down": dn})),
        mesh, in_specs=(P("tp", None), P(None, "tp"), P("tp", None)),
        out_specs=P("tp", None))
    want = np.asarray(jax.jit(fn)(x, gate_up, down))
    mlp = TPMLP(hidden, ffn, mode="w8a8", world_size=world,
                dtype=torch.float32, device="cpu")
    mlp.load_quantized(TPMLP.quantize_params({
        "gate_up": stack_columns(torch.from_numpy(gate_up), world),
        "down": stack_rows(torch.from_numpy(down), world)}))
    assert mlp.gate_up_q.shape == (world, hidden, 2 * ffn // world)
    assert mlp.down_scale.shape == (world, hidden)
    got = mlp(torch.from_numpy(x).reshape(world, m // world, hidden))
    assert got.shape == (world, m // world, hidden)
    _close(got.reshape(m, hidden), want, LAYER)
