"""The port's MoE slice against the JAX package on the CPU: routing tables,
the grouped GEMM and matmul plain versions, `ag_gemm` at world 1, the
`MoEMLP` layer in every mode, and the tiny Qwen3-MoE models' logits,
greedy `Engine.serve` tokens and gradients.

The JAX side runs on a 1-device mesh with its Pallas kernels in interpret
mode (`Qwen3(..., mode="fused", interpret=True)`, whose MoE layer takes its
``xla`` form at world 1); the port runs the plain PyTorch versions of its
kernels (CPU tensors).  The CUDA kernels are held to those plain versions
on the card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: routing tables, quantization and the int8 grouped GEMM bit for
bit; f32 products 1e-5 (the order of the sums); bf16 outputs one bf16 ulp
(1e-2 relative: both sides round the same f32 sums once); the layer and
the models' logits 1e-4 (f32 through two layers); gradients 1e-5 relative
L2 a leaf, as tests/test_torch_training.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.kernels import moe_utils as jax_moe_utils
from triton_distributed_tpu.kernels.allgather_gemm import (
    AllGatherGEMMContext as JaxAGContext, ag_gemm as jax_ag_gemm)
from triton_distributed_tpu.kernels.grouped_gemm import (
    grouped_matmul as jax_grouped_matmul,
    grouped_matmul_w8a8 as jax_grouped_matmul_w8a8)
from triton_distributed_tpu.kernels.matmul import matmul as jax_matmul
from triton_distributed_tpu.layers.moe_mlp import MoEMLP as JaxMoEMLP
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_distributed_tpu_torch import (
    ContinuousBatchingScheduler, Engine, ModelConfig, Qwen3, Request,
    SchedulerConfig)
from triton_distributed_tpu_torch.kernels import moe_utils
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    AllGatherGEMMContext, ag_gemm)
from triton_distributed_tpu_torch.kernels.grouped_gemm import (
    grouped_matmul, grouped_matmul_diff, grouped_matmul_w8a8)
from triton_distributed_tpu_torch.kernels.matmul import matmul
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP, route

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
LAYER_TOL = dict(atol=1e-4, rtol=1e-4)
REL_L2 = 1e-5

#: The two tiny MoE configurations: `tiny_moe`, and one with hidden (128)
#: != heads x head_dim (256), a GQA group of 8 and 4 of 8 experts a token,
#: as Qwen3-30B-A3B has (2048 != 32 x 128, group 8, 8 of 128 experts).
CONFIGS = {
    "tiny_moe": {},
    "gqa8": dict(head_dim=32, num_kv_heads=1, num_experts=8,
                 num_experts_per_tok=4),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _on_mesh(mesh, fn, *args):
    return jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                         check_vma=False)(*args)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


@pytest.fixture(autouse=True, scope="module")
def _fresh_observability_state():
    """Leave the JAX package's process-global flight ring, tracer, lineage
    and decision rings empty (JAX's `Engine.serve` records into them) for
    the test files that run after this one in the same worker:
    test_tracing.py and test_observability.py assert on them."""
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


# ---- routing tables --------------------------------------------------------

#: (n_tokens, topk, E, capacity, skewed): no drops; drops on a skewed
#: assignment (expert 0 wanted by most tokens); drops everywhere.
ROUTE_CASES = [(24, 2, 4, 16, False), (40, 2, 4, 8, True),
               (33, 4, 8, 4, False)]


def _expert_ids(n, topk, e, skewed, seed):
    """Distinct experts per token, as a top-k gives; skewed puts expert 0
    first for 3 tokens in 4."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(e)[:topk] for _ in range(n)])
    if skewed:
        for i in range(n):
            if i % 4 and 0 not in ids[i]:
                ids[i, 0] = 0
    return ids.astype(np.int32)


@pytest.mark.parametrize("n,topk,e,cap,skewed", ROUTE_CASES)
def test_route_capacity_matches_jax(n, topk, e, cap, skewed):
    ids = _expert_ids(n, topk, e, skewed, seed=n)
    want = jax_moe_utils.route_capacity(jnp.asarray(ids), e, cap)
    got = moe_utils.route_capacity(_t(ids), e, cap)
    for field in ("dispatch_index", "slot_of_pair", "counts"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.int32, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    np.testing.assert_array_equal(
        moe_utils.histogram(_t(ids), e).numpy(),
        np.asarray(jax_moe_utils.histogram(jnp.asarray(ids), e)))
    if skewed:
        assert int((got.slot_of_pair < 0).sum()) > 0, "expected drops"


@pytest.mark.parametrize("n,topk,e,cap,skewed", ROUTE_CASES)
def test_gather_and_combine_match_jax(n, topk, e, cap, skewed):
    ids = _expert_ids(n, topk, e, skewed, seed=n + 1)
    x = _rand(n, n, 16)
    r = moe_utils.route_capacity(_t(ids), e, cap)
    jr = jax_moe_utils.route_capacity(jnp.asarray(ids), e, cap)
    buckets = moe_utils.gather_tokens(_t(x), r.dispatch_index)
    np.testing.assert_array_equal(
        buckets.numpy(),
        np.asarray(jax_moe_utils.gather_tokens(jnp.asarray(x),
                                               jr.dispatch_index)))
    out = _rand(n + 2, e, cap, 16)
    w = np.abs(_rand(n + 3, n, topk))
    got = moe_utils.combine_tokens(_t(out), _t(ids), r.slot_of_pair, _t(w))
    want = jax_moe_utils.combine_tokens(jnp.asarray(out), jnp.asarray(ids),
                                        jr.slot_of_pair, jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("world", [1, 2])
def test_plan_chunks_matches_jax(world):
    ids = _expert_ids(40, 2, 4, True, seed=world)
    w = np.abs(_rand(world, 40, 2))
    want = jax_moe_utils.plan_chunks(jnp.asarray(ids), jnp.asarray(w),
                                     world, 4, 8)
    got = moe_utils.plan_chunks(_t(ids), _t(w), world, 4, 8)
    for field in ("dispatch_index", "counts", "slot_of_pair"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def _jax_moe(mode="xla", **kw):
    d = dict(axis="tp", world_size=1, hidden=128, ffn=64, num_experts=8,
             topk=2, mode=mode, interpret=True)
    d.update(kw)
    return JaxMoEMLP(**d)


def test_route_matches_jax_and_ties_go_to_the_lower_index():
    jm = _jax_moe(topk=3)
    x, router = _rand(40, 24, 128), _rand(41, 128, 8) * 128 ** -0.5
    want_ids, want_w = jm._route(jnp.asarray(x), jnp.asarray(router))
    ids, w = route(_t(x), _t(router), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), **F32_TOL)
    # A zero router: every probability ties, lax.top_k takes 0, 1, 2.
    zero = np.zeros((128, 8), np.float32)
    want_ids, want_w = jm._route(jnp.asarray(x), jnp.asarray(zero))
    ids, w = route(_t(x), _t(zero), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert ids.tolist() == [[0, 1, 2]] * 24
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), **F32_TOL)


@pytest.mark.parametrize("tokens", [1, 4, 8, 100, 2048])
@pytest.mark.parametrize("mode", ["xla", "fused", "w8a8"])
def test_capacity_matches_jax(tokens, mode):
    jm = _jax_moe(mode, num_experts=128, topk=8)
    layer = MoEMLP(2048, 768, 128, topk=8, mode=mode, device="meta")
    assert layer.capacity(tokens) == jm.capacity(tokens)


def test_quantize_params_matches_jax():
    jm = _jax_moe("w8a8")
    params = {"router": _rand(50, 128, 8), "gate_up": _rand(51, 8, 128, 128),
              "down": _rand(52, 8, 64, 128)}
    want = jm.quantize_params(jax.tree.map(jnp.asarray, params))
    got = MoEMLP.quantize_params(jax.tree.map(_t, params))
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    deq_want = jm.dequantize_params(want, jnp.float32)
    deq_got = MoEMLP.dequantize_params(got, torch.float32)
    for name in deq_got:
        np.testing.assert_array_equal(deq_got[name].numpy(),
                                      np.asarray(deq_want[name]),
                                      err_msg=name)


# ---- the grouped GEMM, matmul and ag_gemm plain versions ------------------

@pytest.mark.parametrize("dtype,out_dtype", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "float32")])
@pytest.mark.parametrize("e,m,k,n", [(4, 16, 64, 96), (3, 37, 100, 77),
                                     (1, 24, 48, 40)])
def test_grouped_matmul_plain_matches_jax(dtype, out_dtype, e, m, k, n):
    a, b = _rand(60, e, m, k), _rand(61, e, k, n) * k ** -0.5
    want = jax_grouped_matmul(
        jnp.asarray(a, dtype), jnp.asarray(b, dtype), interpret=True,
        out_dtype=None if out_dtype is None else jnp.dtype(out_dtype))
    tdt = getattr(torch, dtype)
    got = grouped_matmul(_t(a).to(tdt), _t(b).to(tdt),
                         None if out_dtype is None
                         else getattr(torch, out_dtype))
    assert str(got.dtype) == f"torch.{want.dtype}"
    tol = BF16_TOL if want.dtype == jnp.bfloat16 else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    if e == 1:
        want = jax_matmul(jnp.asarray(a[0], dtype), jnp.asarray(b[0], dtype),
                          interpret=True)
        got = matmul(_t(a[0]).to(tdt), _t(b[0]).to(tdt))
        tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("e,m,k,n", [(4, 32, 64, 96), (2, 40, 48, 200)])
def test_grouped_matmul_w8a8_plain_matches_jax_bit_for_bit(out_dtype, e, m,
                                                           k, n):
    rng = np.random.default_rng(e * m)
    a_q = rng.integers(-127, 128, (e, m, k), dtype=np.int8)
    b_q = rng.integers(-127, 128, (e, k, n), dtype=np.int8)
    sa = np.abs(_rand(70, e, m)) / 127
    sb = np.abs(_rand(71, e, n)) / 127
    want = jax_grouped_matmul_w8a8(*map(jnp.asarray, (a_q, b_q, sa, sb)),
                                   out_dtype=jnp.dtype(out_dtype),
                                   interpret=True)
    got = grouped_matmul_w8a8(*map(_t, (a_q, b_q, sa, sb)),
                              out_dtype=getattr(torch, out_dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("method", ["xla", "fused", "ll", "auto"])
def test_ag_gemm_world1_matches_jax(method):
    x, w = _rand(80, 20, 64), _rand(81, 64, 40)
    want, want_a = jax_ag_gemm(
        jnp.asarray(x), jnp.asarray(w),
        JaxAGContext(axis="tp", world_size=1, method=method, interpret=True),
        return_gathered=True)
    ctx = AllGatherGEMMContext("tp", 1, method)
    got, got_a = ag_gemm(_t(x), _t(w), ctx, return_gathered=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    assert ctx.resolve_method(20, torch.float32) == (
        "xla" if method == "auto" else method)
    torch.testing.assert_close(ag_gemm(_t(x), _t(w), ctx), got)


def test_ag_gemm_refuses_more_than_one_gpu():
    # At world 4 the operands are rank-stacked (tests/test_torch_tp.py):
    # world-1 operands are refused.
    ctx = AllGatherGEMMContext("tp", 4, "fused")
    with pytest.raises(ValueError, match="want a_shard"):
        ag_gemm(torch.zeros(4, 8), torch.zeros(8, 8), ctx)
    with pytest.raises(ValueError, match="method"):
        AllGatherGEMMContext("tp", 1, "ring").resolve_method(4, torch.float32)


def test_grouped_matmul_diff_grads_match_jax():
    a, b, g = _rand(90, 3, 12, 16), _rand(91, 3, 16, 8), _rand(92, 3, 12, 8)

    def loss(a_, b_):
        return jnp.sum(jnp.einsum("emk,ekn->emn", a_, b_) * g)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    (grouped_matmul_diff(at, bt) * _t(g)).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want[0]),
                               **F32_TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want[1]),
                               **F32_TOL)


# ---- the MoE layer -----------------------------------------------------------

@pytest.mark.parametrize("mode", ["xla", "fused", "w8a8"])
def test_moe_mlp_matches_jax(mesh, mode):
    """Capacity factor 0.25: 16 slots an expert (32 for w8a8) for 64
    tokens x top-2 of 8 experts, 16 pairs an expert on average, so the
    float modes drop pairs, as JAX's do."""
    jm = _jax_moe(mode, capacity_factor=0.25)
    fparams = jax.tree.map(np.asarray, _jax_moe().init_params(
        jax.random.key(3), jnp.float32))
    params = (jax.tree.map(np.asarray, jm.quantize_params(fparams))
              if mode == "w8a8" else fparams)
    x = _rand(100, 64, 128)
    want = jax.jit(lambda x_, p_: _on_mesh(mesh, jm, x_, p_))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    layer = MoEMLP(128, 64, 8, topk=2, capacity_factor=0.25, mode=mode,
                   dtype=torch.float32, device="cpu")
    layer.load_state_dict(jax.tree.map(_t, params))
    with torch.inference_mode():
        got = layer(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    ids, _ = route(_t(x), layer.router, 2)
    drops = moe_utils.route_capacity(ids, 8, layer.capacity(64))
    assert mode == "w8a8" or int((drops.slot_of_pair < 0).sum()) > 0


def test_moe_mlp_init_and_refusals():
    layer = MoEMLP(64, 32, 4, topk=2, mode="w8a8", device="cpu")
    layer.init_params(torch.Generator().manual_seed(0))
    assert layer.router.dtype == torch.float32
    assert layer.gate_up_q.dtype == torch.int8
    assert layer.gate_up_scale.shape == (4, 64)
    assert layer(torch.randn(5, 64, dtype=torch.bfloat16)).shape == (5, 64)
    with pytest.raises(ValueError, match="mode"):
        MoEMLP(64, 32, 4, mode="fused_ar", device="cpu")
    # At world 2 the layer builds with rank-stacked weights (K10 and K11
    # are ported); what stays refused at world > 1 is training.
    tp = MoEMLP(64, 32, 4, world_size=2, dtype=torch.float32, device="cpu")
    tp.init_params(torch.Generator().manual_seed(1))
    assert tp.gate_up.shape == (2, 4, 64, 32) and tp.down.shape == (2, 4, 16,
                                                                     64)
    assert tp(torch.randn(2, 16, 64)).shape == (2, 16, 64)


# ---- models ------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def moe_pair(request, mesh):
    """The JAX and port models of one config on the same weights, and the
    JAX side's prefill logits and greedy tokens."""
    kw = CONFIGS[request.param]
    jm = JaxQwen3(JaxConfig.tiny_moe(dtype="float32", **kw), mesh,
                  mode="fused", interpret=True)
    params = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tm = Qwen3(ModelConfig.tiny_moe(dtype="float32", **kw),
               device="cpu").load_jax_params(tree)
    ids = np.random.default_rng(13).integers(0, 256, (2, 16),
                                             dtype=np.int32)
    logits, _ = jax.jit(jm.make_prefill_fn())(params, jnp.asarray(ids),
                                              jm.create_cache(2, max_seq=32))
    tokens = JaxEngine(jm, temperature=0.0).serve(params, jnp.asarray(ids),
                                                  4)
    return dict(jm=jm, params=params, tree=tree, tm=tm, ids=ids,
                logits=np.asarray(logits), tokens=np.asarray(tokens))


def test_moe_model_prefill_and_serve_match_jax(moe_pair):
    tm, ids = moe_pair["tm"], moe_pair["ids"]
    logits = tm.prefill(_t(ids), tm.create_cache(2, max_seq=32))
    np.testing.assert_allclose(logits.numpy(), moe_pair["logits"],
                               **LAYER_TOL)
    np.testing.assert_array_equal(Engine(tm).serve(_t(ids), 4).numpy(),
                                  moe_pair["tokens"])


def test_moe_model_with_int8_kv_cache_matches_jax(mesh):
    """The int8 KV cache composes with MoE layers unchanged: greedy
    `Engine.serve` tokens of the tiny MoE model with
    ``quantize_kv_cache=True`` equal JAX's."""
    cfg = dict(dtype="float32", quantize_kv_cache=True)
    jm = JaxQwen3(JaxConfig.tiny_moe(**cfg), mesh, mode="fused",
                  interpret=True)
    params = jm.init_params(jax.random.key(1))
    tm = Qwen3(ModelConfig.tiny_moe(**cfg), device="cpu").load_jax_params(
        jax.tree.map(np.asarray, params))
    ids = np.random.default_rng(17).integers(0, 256, (2, 16),
                                             dtype=np.int32)
    want = JaxEngine(jm, temperature=0.0).serve(params, jnp.asarray(ids), 4)
    assert tm.create_cache(2).quantized
    np.testing.assert_array_equal(Engine(tm).serve(_t(ids), 4).numpy(),
                                  np.asarray(want))


def test_moe_model_params_round_trip(moe_pair):
    tree = moe_pair["tm"].to_jax_params()
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = jax.tree_util.tree_flatten_with_path(moe_pair["tree"])[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w,
                                      err_msg=jax.tree_util.keystr(path))
    router = moe_pair["tm"].layers[0].mlp.router
    assert router.dtype == torch.float32
    bf16 = Qwen3(dataclasses.replace(moe_pair["tm"].config,
                                     dtype="bfloat16"), device="cpu")
    bf16.load_jax_params(moe_pair["tree"])
    assert bf16.layers[0].mlp.router.dtype == torch.float32
    assert bf16.layers[0].mlp.gate_up.dtype == torch.bfloat16
    assert torch.equal(bf16.layers[0].mlp.router, router)


def test_moe_model_scheduler_slots_equal_paged(moe_pair):
    tm = moe_pair["tm"]
    gen = torch.Generator().manual_seed(2)
    prefix = torch.randint(1, 256, (16,), generator=gen).tolist()
    prompts = [prefix + torch.randint(1, 256, (n,), generator=gen).tolist()
               for n in (3, 9, 20)] + [[5, 6, 7]]
    outs = []
    for layout in ("slots", "paged"):
        sched = ContinuousBatchingScheduler(tm, SchedulerConfig(
            num_slots=2, max_seq=64, prefill_buckets=(16, 32, 64),
            page_size=8, kv_layout=layout))
        done = sched.run([Request(prompt=p, max_new_tokens=6)
                          for p in prompts])
        outs.append([r.generated for r in
                     sorted(done, key=lambda r: r.request_id)])
    assert outs[0] == outs[1]
    assert all(len(t) == 6 for t in outs[0])


def _ce(logits, targets):
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(targets)),
                                                targets])


def test_moe_model_grads_match_jax(moe_pair, mesh):
    """Gradients of a last-position cross-entropy with respect to every
    leaf (routers and experts included) against `jax.grad` through
    ``prefill_shard(params, ids, None)``."""
    jm, params = moe_pair["jm"], moe_pair["params"]
    ids = np.random.default_rng(31).integers(0, 256, (2, 24)).astype(
        np.int32)
    targets = np.array([5, 200], np.int32)

    def loss_jax(p_):
        logits, _ = _on_mesh(mesh, lambda pp, ii: jm.prefill_shard(pp, ii,
                                                                   None),
                             p_, ids)
        return _ce(logits, targets)

    loss0, grads = jax.jit(jax.value_and_grad(loss_jax))(params)
    grads = jax.tree.map(np.asarray, grads)
    grads["embed"] = grads["embed"] + grads.pop("lm_head").T  # tied head
    model = Qwen3(moe_pair["tm"].config, device="cpu").load_jax_params(
        moe_pair["tree"]).requires_grad_(True)
    loss = F.cross_entropy(model(_t(ids)), _t(targets).long())
    np.testing.assert_allclose(loss.item(), float(loss0), **LAYER_TOL)
    loss.backward()
    got = jax.tree_util.tree_flatten_with_path(model.to_jax_params(
        grad=True))[0]
    want = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        name = jax.tree_util.keystr(path)
        assert np.abs(w).max() > 0, name
        err = (np.linalg.norm(np.float64(g) - w)
               / max(np.linalg.norm(np.float64(w)), 1e-30))
        assert err <= REL_L2, f"{name}: rel_l2 {err:.3e}"
