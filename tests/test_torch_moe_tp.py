"""The port's MoE tensor parallelism at world 4 against the JAX package on
the CPU: the packed routing plan (`moe_utils.plan_chunks`, bit for bit),
AllGather-GroupGEMM (K11's plain version), the fused and the staged
MoE-Reduce-RS (K10's plain version), `MoEMLP` at world 4 in ``xla`` and
``fused`` with its decode-shaped fallback, and the tiny MoE `Qwen3` at
world 4 in mode ``fused`` (prefill logits, greedy `Engine.serve`, the
parameter round trip).

The JAX side runs as tests/test_moe_fused.py, tests/test_ag_moe.py and
tests/test_moe_packed.py run it: `shard_map` over the conftest's virtual
CPU devices (``tp4_mesh``), Pallas in interpret mode.  The port holds
every rank in one process (`parallel.mesh`): its shards are rank-stacked
tensors, and on CPU tensors its kernel wrappers run their plain versions.
The same seeded numpy inputs go to both.

Tolerances, all f32: 1e-5 for one grouped product (the order of its
sums), 1e-4 through the fused epilogue, a layer or the model, as the JAX
package's own tests hold them; the routing plan and every count exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.kernels import moe_utils as jax_moe_utils
from triton_distributed_tpu.kernels.allgather_group_gemm import (
    AGGroupGEMMContext as JaxAGGroupContext)
from triton_distributed_tpu.kernels.allgather_group_gemm import (
    ag_group_gemm as jax_ag_group_gemm)
from triton_distributed_tpu.kernels.matmul import MatmulConfig
from triton_distributed_tpu.kernels.moe_reduce_rs import (
    MoEReduceRSContext as JaxMoERSContext)
from triton_distributed_tpu.kernels.moe_reduce_rs import (
    moe_reduce_rs as jax_moe_reduce_rs)
from triton_distributed_tpu.kernels.moe_reduce_rs import (
    moe_reduce_rs_fused as jax_moe_reduce_rs_fused)
from triton_distributed_tpu.layers.moe_mlp import MoEMLP as JaxMoEMLP
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_distributed_tpu.ops import shard_map_op
from triton_distributed_tpu_torch import Engine, ModelConfig, Qwen3
from triton_distributed_tpu_torch.kernels import moe_utils
from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
    AGGroupGEMMContext, ag_group_gemm)
from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
    MoEReduceRSContext, moe_reduce_rs, moe_reduce_rs_fused)
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP
from triton_distributed_tpu_torch.layers.tp_attn import stack_columns
from triton_distributed_tpu_torch.parallel import make_mesh

F32 = dict(atol=1e-5, rtol=1e-5)
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


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


# ---- the packed plan -------------------------------------------------------

def _ids(case, world, mc, e, topk, seed):
    rng = np.random.default_rng(seed)
    n = world * mc
    if case == "random":
        ids = rng.integers(0, e, (n, topk))
    elif case == "empty":                 # experts 1 and 3 get nothing
        ids = np.array([0, 2])[rng.integers(0, 2, (n, topk))]
    elif case == "one":                   # every pair to the last expert
        ids = np.full((n, topk), e - 1)
    else:                                 # 16 pairs each: full blocks
        ids = (np.arange(n) // 16 % e)[:, None].repeat(topk, 1)
    w = rng.random((n, topk)).astype(np.float32)
    return ids.astype(np.int32), w / w.sum(-1, keepdims=True)


#: (case, world, mc, experts, topk, capacity, block): the cases of
#: tests/test_moe_packed.py (an empty expert, every pair to one expert,
#: occupancy exactly at a block boundary and one past it) and random
#: routing at world 4, with the default block and an explicit one.
PLAN_CASES = [("random", 4, 32, 4, 2, 16, None),
              ("random", 2, 64, 16, 4, 32, None),
              ("empty", 1, 32, 4, 2, 16, None),
              ("one", 1, 64, 4, 2, 16, None),
              ("boundary", 1, 32, 2, 1, 32, 16),
              ("boundary", 4, 48, 3, 1, 32, 16),
              ("random", 4, 32, 8, 2, 64, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,world,mc,e,topk,cap,block", PLAN_CASES)
def test_plan_chunks_bitwise(case, world, mc, e, topk, cap, block, dtype):
    """Every field of the plan, and the dense combine tensor, bit for bit:
    dispatch_index, counts, slot_of_pair, block_expert, block_slot,
    n_blocks, combine_blocks (in f32 and in bf16)."""
    ids, w = _ids(case, world, mc, e, topk, seed=mc + e)
    want = jax_moe_utils.plan_chunks(jnp.asarray(ids), jnp.asarray(w), world,
                                     e, cap, dtype=getattr(jnp, dtype),
                                     block=block)
    got = moe_utils.plan_chunks(torch.from_numpy(ids), torch.from_numpy(w),
                                world, e, cap, dtype=getattr(torch, dtype),
                                block=block)
    for field in want._fields:
        a = getattr(got, field)
        b = np.asarray(getattr(want, field))
        assert tuple(a.shape) == b.shape, field
        np.testing.assert_array_equal(a.float().numpy(), b.astype(np.float32),
                                      err_msg=field)
    assert got.pack_block_size == want.pack_block_size
    assert got.num_blocks_static == want.num_blocks_static
    np.testing.assert_array_equal(
        moe_utils.dense_combine_mats(got, cap).float().numpy(),
        np.asarray(jax_moe_utils.dense_combine_mats(want, cap), np.float32))


@pytest.mark.parametrize("case,world,mc,e,topk,cap,block", PLAN_CASES)
def test_combine_pairs_match_combine_tokens(case, world, mc, e, topk, cap,
                                            block):
    """Each token's pairs read off the plan (stage rows in ascending
    expert order, their weights) combine a packed stage into exactly what
    the gather combine gives on the dense expert output."""
    ids, w = _ids(case, world, mc, e, topk, seed=mc + e)
    plan = moe_utils.plan_chunks(torch.from_numpy(ids), torch.from_numpy(w),
                                 world, e, cap, block=block)
    rows, weights = moe_utils.combine_pairs(plan, topk)
    eo = torch.from_numpy(_rand(5, world, e, cap, 8))
    bsz = plan.pack_block_size
    for c in range(world):
        stage = eo[c].reshape(-1, 8)[
            (plan.block_expert[c].long()[:, None] * cap
             + plan.block_slot[c].long()[:, None] * bsz
             + torch.arange(bsz)).reshape(-1)]
        want = moe_utils.combine_tokens(
            eo[c], torch.from_numpy(ids).reshape(world, mc, topk)[c],
            plan.slot_of_pair[c], torch.from_numpy(w).reshape(
                world, mc, topk)[c])
        got = torch.zeros(mc, 8)
        for k in range(topk):
            r = rows[c, :, k]
            got += torch.where((r >= 0)[:, None],
                               weights[c, :, k, None] * stage[r.clamp(min=0)],
                               0.0)
        torch.testing.assert_close(got, want, **F32)
        ordered = rows[c, :, 1:] >= rows[c, :, :-1]
        assert bool((ordered | (rows[c, :, 1:] < 0)).all())


@pytest.mark.parametrize("n_pairs,e,cap,block", [
    (64, 4, 16, 16), (4096, 64, 128, 128), (4096, 8, 512, 128),
    (8, 64, 16, 16), (4096, 128, 64, 64)])
def test_packed_block_bound(n_pairs, e, cap, block):
    """The static block budget equals the JAX package's, within both of its
    bounds and room for every pair on one expert."""
    t = moe_utils.packed_block_bound(n_pairs, e, cap, block)
    assert t == jax_moe_utils.packed_block_bound(n_pairs, e, cap, block)
    assert 1 <= t <= e * (cap // block) and cap // block <= t
    assert moe_utils.pack_block(cap) == jax_moe_utils.pack_block(cap)


# ---- K11: AllGather-GroupGEMM ---------------------------------------------

@pytest.mark.parametrize("with_counts", [False, True])
def test_ag_group_gemm_matches_jax(tp4_mesh, with_counts):
    """Every rank's gathered buckets through its column shard: f32 within
    1e-5 of the JAX kernel, with and without the counts."""
    world, e, cap, k, n = 4, 4, 16, 64, 32
    buckets = _rand(1, world, e, cap, k, scale=0.125)
    counts = np.random.default_rng(2).integers(0, cap + 1, (world, e))
    counts = counts.astype(np.int32)
    # Rows past the count are padding: zeros.
    buckets *= (np.arange(cap)[None, None, :, None]
                < counts[:, :, None, None])
    w = _rand(3, e, k, world * n, scale=0.125)
    ctx = JaxAGGroupContext(axis="tp", world_size=world, num_experts=e,
                            gemm=MatmulConfig(8, 32, 64), interpret=True)
    fn = shard_map_op(
        lambda bb, ww, cc: jax_ag_group_gemm(
            bb[0], ww, ctx, counts=cc if with_counts else None),
        tp4_mesh, in_specs=(P("tp", None, None, None), P(None, None, "tp"),
                            P(None, None)),
        out_specs=P(None, None, None, "tp"))
    want = np.asarray(jax.jit(fn)(buckets, w, counts))   # (W, E, cap, W n)
    got = ag_group_gemm(_t(buckets), _t(stack_columns(torch.from_numpy(w),
                                                      world)),
                        AGGroupGEMMContext("tp", world, e),
                        counts=_t(counts, torch.int32) if with_counts
                        else None)
    assert got.shape == (world, world, e, cap, n)
    for r in range(world):
        _close(got[r], want[..., r * n:(r + 1) * n], F32)


def test_ag_group_gemm_counts_skip_exactly():
    """With the counts, the row tiles past them are zeros and every other
    row is the full compute's, exactly (the padded rows are zeros), on
    buckets whose experts 2 and 3 are empty and expert 1 partial."""
    world, e, cap, k, n = 4, 4, 16, 64, 32
    counts = torch.tensor([[cap, 4, 0, 0]] * world, dtype=torch.int32)
    rows = torch.arange(cap)[None, None, :, None]
    buckets = torch.from_numpy(_rand(7, world, e, cap, k)) * (
        rows < counts[:, :, None, None])
    w = torch.from_numpy(_rand(8, world, e, k, n))
    ctx = AGGroupGEMMContext("tp", world, e)
    full = ag_group_gemm(buckets, w, ctx)
    skipped = ag_group_gemm(buckets, w, ctx, counts=counts)
    assert torch.equal(skipped, full)
    assert not bool(skipped[:, :, 2:].any())


# ---- K10: MoE-Reduce-RS -----------------------------------------------------

def _moe_rs_operands(seed, world, mc, e, topk, cap, k, n):
    ids, w = _ids("random", world, mc, e, topk, seed)
    buckets = _rand(seed + 1, world, e, cap, world * k, scale=0.125)
    wdown = _rand(seed + 2, e, world * k, n, scale=0.125)
    return ids, w, buckets, wdown


def _port_buckets(buckets, world):
    """JAX (chunk, E, cap, W k) with rank r's K shard r -> the port's (W
    rank, W chunk, E, cap, k)."""
    return stack_columns(torch.from_numpy(buckets), world).contiguous()


def _port_down(wdown, world):
    """JAX (E, W k, n) row shards -> (W, E, k, n)."""
    return torch.from_numpy(wdown).reshape(
        wdown.shape[0], world, -1, wdown.shape[-1]).transpose(0, 1)


@pytest.mark.parametrize("topk", [1, 2])
def test_moe_reduce_rs_fused_matches_jax(tp4_mesh, topk):
    """Rank c gets chunk c's combine of the sum over the ranks: the fused
    plain version within 1e-4 of the JAX fused kernel and of the port's
    staged composition (K8, the gather combine, K16)."""
    world, e, cap, mc, k, n = 4, 4, 16, 32, 64, 48
    ids, w, buckets, wdown = _moe_rs_operands(11 + topk, world, mc, e, topk,
                                              cap, k, n)
    jplan = jax_moe_utils.plan_chunks(jnp.asarray(ids), jnp.asarray(w),
                                      world, e, cap)
    ctx = JaxMoERSContext(axis="tp", world_size=world, num_experts=e,
                          topk=topk, gemm=MatmulConfig(16, 48, 64),
                          interpret=True)
    fn = shard_map_op(
        lambda bk, wd: jax_moe_reduce_rs_fused(bk, wd, jplan, ctx),
        tp4_mesh, in_specs=(P(None, None, None, "tp"), P(None, "tp", None)),
        out_specs=P("tp", None))
    want = np.asarray(jax.jit(fn)(buckets, wdown))
    plan = moe_utils.plan_chunks(torch.from_numpy(ids), torch.from_numpy(w),
                                 world, e, cap)
    pctx = MoEReduceRSContext("tp", world, e, topk)
    got = moe_reduce_rs_fused(_port_buckets(buckets, world),
                              _port_down(wdown, world).contiguous(), plan,
                              pctx)
    assert got.shape == (world, mc, n)
    _close(got.reshape(world * mc, n), want, LAYER)
    # The staged golden, chunk by chunk: its routing is the chunk's.
    staged = []
    for c in range(world):
        sub = ids.reshape(world, mc, topk)[c]
        routing = moe_utils.route_capacity(torch.from_numpy(sub), e, cap)
        staged.append(moe_reduce_rs(
            _port_buckets(buckets, world)[:, c].contiguous(),
            _port_down(wdown, world).contiguous(), torch.from_numpy(sub),
            routing.slot_of_pair,
            torch.from_numpy(w.reshape(world, mc, topk)[c]), pctx))
    # staged[c] (W, mc / W, n): chunk c's tokens scattered over the ranks.
    _close(torch.stack(staged).reshape(world * mc, n), want, LAYER)


def test_moe_reduce_rs_staged_matches_jax(tp4_mesh):
    """The staged golden (K8, combine, K16's scatter_reduce) against the
    JAX `moe_reduce_rs` on routing of all tokens."""
    world, e, cap, nt, k, n = 4, 4, 32, 64, 32, 48
    ids, w = _ids("random", 1, nt, e, 2, seed=21)
    buckets = _rand(22, e, cap, world * k, scale=0.125)
    wdown = _rand(23, e, world * k, n, scale=0.125)
    routing = jax_moe_utils.route_capacity(jnp.asarray(ids), e, cap)
    ctx = JaxMoERSContext(axis="tp", world_size=world, num_experts=e,
                          topk=2, interpret=True)
    fn = shard_map_op(
        lambda bk, wd: jax_moe_reduce_rs(bk, wd, jnp.asarray(ids),
                                         routing.slot_of_pair,
                                         jnp.asarray(w), ctx),
        tp4_mesh, in_specs=(P(None, None, "tp"), P(None, "tp", None)),
        out_specs=P("tp", None))
    want = np.asarray(jax.jit(fn)(buckets, wdown))
    got = moe_reduce_rs(
        stack_columns(torch.from_numpy(buckets), world).contiguous(),
        _port_down(wdown, world).contiguous(), torch.from_numpy(ids),
        torch.from_numpy(np.array(routing.slot_of_pair)),
        torch.from_numpy(w), MoEReduceRSContext("tp", world, e, 2))
    _close(got.reshape(nt, n), want, LAYER)


# ---- the layer at world 4 ---------------------------------------------------

def _moe_params(seed, h, ffn, e):
    return {"router": _rand(seed, h, e, scale=h ** -0.5),
            "gate_up": _rand(seed + 1, e, h, 2 * ffn, scale=h ** -0.5),
            "down": _rand(seed + 2, e, ffn, h, scale=h ** -0.5)}


def _jax_layer_out(tp4_mesh, layer, x, params, specs):
    fn = shard_map_op(lambda xx, pp: layer(xx, pp), tp4_mesh,
                      in_specs=(P("tp", None), specs),
                      out_specs=P("tp", None))
    return np.asarray(jax.jit(fn)(x, params))


#: (mode, topk, rows a rank): both modes at topk 1 and 2 (32 rows a rank:
#: the fused kernels), and fused at 12 rows a rank (12 % 8 != 0 in f32:
#: the xla path, as the JAX layer falls back).
LAYER_CASES = [("xla", 1, 32), ("xla", 2, 32), ("fused", 1, 32),
               ("fused", 2, 32), ("fused", 2, 12)]


@pytest.mark.parametrize("mode,topk,mc", LAYER_CASES)
def test_moe_mlp_world4_matches_jax(tp4_mesh, mode, topk, mc):
    world, h, ffn, e = 4, 64, 64, 4
    params = _moe_params(30 + topk, h, ffn, e)
    x = _rand(33, world * mc, h, scale=0.25)
    jlayer = JaxMoEMLP(axis="tp", world_size=world, hidden=h, ffn=ffn,
                       num_experts=e, topk=topk, mode=mode,
                       gemm=MatmulConfig(16, 32, 64), interpret=True)
    want = _jax_layer_out(tp4_mesh, jlayer, x, params,
                          jlayer.global_param_specs())
    layer = MoEMLP(h, ffn, e, topk=topk, mode=mode, world_size=world,
                   dtype=torch.float32, device="cpu").load_jax_params(params)
    got = layer(_t(x).reshape(world, mc, h))
    assert got.shape == (world, mc, h)
    _close(got.reshape(world * mc, h), want, LAYER)


def test_moe_mlp_world4_paths_and_refusals():
    """At world 4 ``fused`` launches K11 and K10 only on a row count the
    kernels tile (else the xla path, as JAX); the fused and xla paths
    agree; the global layout round-trips; a gradient is refused."""
    world, h, ffn, e = 4, 64, 64, 4
    params = _moe_params(40, h, ffn, e)
    layers = {m: MoEMLP(h, ffn, e, mode=m, world_size=world,
                        dtype=torch.float32, device="cpu").load_jax_params(
                            params) for m in ("xla", "fused")}
    assert layers["fused"].gate_up.shape == (world, e, h, 2 * ffn // world)
    assert layers["fused"].down.shape == (world, e, ffn // world, h)
    for name, leaf in layers["fused"].jax_params().items():
        np.testing.assert_array_equal(leaf.numpy(), params[name])
    x = torch.from_numpy(_rand(41, world, 16, h, scale=0.25))
    torch.testing.assert_close(layers["fused"](x), layers["xla"](x), **LAYER)
    layers["fused"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training duals"):
        layers["fused"](x)
    with pytest.raises(ValueError, match="does not split"):
        MoEMLP(h, 30, e, world_size=world, device="cpu")


# ---- the tiny MoE Qwen3 at world 4 ------------------------------------------

@pytest.fixture(scope="module")
def moe_tp_pair(tp4_mesh):
    """The JAX tiny MoE Qwen3 at world 4 in mode fused, its params and its
    `Engine`, and the port's world-4 model on the same pytree, f32."""
    cfg = dict(num_layers=2, dtype="float32")
    jm = JaxQwen3(JaxConfig.tiny_moe(**cfg), tp4_mesh, mode="fused",
                  interpret=True)
    params = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tm = Qwen3(ModelConfig.tiny_moe(**cfg), "fused",
               mesh=make_mesh(4, device="cpu")).load_jax_params(tree)
    return JaxEngine(jm, temperature=0.0), params, tree, tm


def test_qwen3_moe_tp_logits_and_serve_match_jax(moe_tp_pair):
    """Prefill logits of 4 x 16 tokens (16 rows a rank: the fused kernels)
    within 1e-4 of the JAX fused model's; greedy `Engine.serve` (decode at
    one row a rank: the xla path) gives the JAX `Engine`'s tokens."""
    engine, params, _, tm = moe_tp_pair
    jm = engine.model
    b, s, gen = 4, 16, 4
    ids = np.random.default_rng(51).integers(0, 256, (b, s), dtype=np.int32)
    want, _ = engine.prefill(params, jnp.asarray(ids), jm.create_cache(b))
    _close(tm.prefill(torch.from_numpy(ids), tm.create_cache(b)), want,
           LAYER)
    tokens = np.asarray(engine.serve(params, jnp.asarray(ids), gen))
    got = Engine(tm).serve(torch.from_numpy(ids), gen)
    np.testing.assert_array_equal(got.numpy(), tokens)


def test_qwen3_moe_tp_params_round_trip(moe_tp_pair):
    """Every leaf of the JAX world-4 pytree (the expert axis included)
    comes back unchanged from `to_jax_params`; an MoE model refuses
    `reshard`."""
    _, _, tree, tm = moe_tp_pair
    back = tm.to_jax_params()
    flat = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))
    m1 = Qwen3(ModelConfig.tiny_moe(dtype="float32"), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        m1.reshard(4)
