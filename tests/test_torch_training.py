"""The port's training path against the JAX package's on the CPU: the flash
attention backward (K4/K5's plain version), the attention and MLP layers'
gradients, and the tiny Qwen3's gradient of every parameter and one SGD
step, all in f32 from the same seeded numpy inputs.

The JAX side runs `flash_attention_diff` (its Pallas forward and backward
in interpret mode, as tests/test_flash_attention.py runs them) and
`jax.grad` through `Qwen3.prefill_shard(params, ids, None)` on a 1-device
mesh; the port runs `flash_attention_diff`'s plain versions (CPU tensors)
under torch autograd.  The CUDA kernels are held to those plain versions
on the card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: the flash gradients 1e-5 absolute and relative (both sides in
f32; the JAX kernels pre-scale q into the exp2 domain and sum in another
order: measured up to 2.2e-6 on gradients of magnitude 1-5); layer and
model gradients a relative L2 error of 1e-5 per leaf (measured up to
2.1e-6 through the two layers), and 1e-4 on the losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu.kernels.flash_attention import (
    flash_attention_diff as jax_flash_attention_diff)
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_distributed_tpu_torch import ModelConfig, Qwen3
from triton_distributed_tpu_torch.kernels import flash_attention as fa
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP

FLASH_TOL = dict(atol=1e-5, rtol=1e-5)
REL_L2 = 1e-5
LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
LR = 0.1


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _leaf(x):
    return torch.from_numpy(np.array(x)).requires_grad_(True)


def _rel_l2(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= REL_L2, f"{name}: rel_l2 {err:.3e} > {REL_L2}"


def _flash_grads(q, k, v, w, u, kv_offset, causal, bq, bk, row_lo=0):
    """dq, dk, dv of sum(out[:, :, row_lo:] * w[:, :, row_lo:]) (+ sum(lse
    * u) when ``u`` is given) from JAX and from the port."""
    def loss_jax(q_, k_, v_):
        out, lse = jax_flash_attention_diff(
            q_, k_, v_, kv_offset, causal=causal, return_lse=True,
            block_q=bq, block_k=bk)
        total = jnp.sum(out[:, :, row_lo:] * w[:, :, row_lo:])
        return total if u is None else total + jnp.sum(lse * u)

    want = jax.jit(jax.grad(loss_jax, argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt = _leaf(q), _leaf(k), _leaf(v)
    out, lse = fa.flash_attention_diff(qt, kt, vt, kv_offset, causal=causal,
                                       return_lse=True)
    total = (out[:, :, row_lo:] * torch.from_numpy(w[:, :, row_lo:])).sum()
    if u is not None:
        total = total + (lse * torch.from_numpy(u)).sum()
    got = torch.autograd.grad(total, (qt, kt, vt))
    return [g.numpy() for g in got], [np.asarray(g) for g in want]


# The cases of tests/test_flash_attention.py (the JAX backward's own
# tests): (b, h, hkv, sq, sk, d, causal, kv_offset, block_q, block_k).
FLASH_CASES = {
    "basic-noncausal": (1, 2, 2, 256, 256, 64, False, 0, 128, 128),
    "basic-causal": (1, 2, 2, 256, 256, 64, True, 0, 128, 128),
    "gqa": (1, 4, 2, 128, 128, 32, True, 0, 64, 64),
    "kv_offset": (1, 2, 2, 128, 128, 32, True, 128, 64, 64),
    "ragged-kv": (1, 2, 2, 128, 192, 32, True, 64, 64, 128),
    "ragged-q-noncausal": (1, 2, 2, 96, 128, 32, False, 0, 64, 64),
    "ragged-q-causal": (1, 2, 2, 96, 128, 32, True, 0, 64, 64),
    "ragged-both": (1, 2, 2, 96, 160, 32, True, 32, 64, 64),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_matches_jax(case):
    b, h, hkv, sq, sk, d, causal, off, bq, bk = FLASH_CASES[case]
    q, k, v, w = _inputs(sum(FLASH_CASES[case]), (b, h, sq, d),
                         (b, hkv, sk, d), (b, hkv, sk, d), (b, h, sq, d))
    got, want = _flash_grads(q, k, v, w, None, off, causal, bq, bk)
    for g, j, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, j, **FLASH_TOL, err_msg=name)


def test_flash_backward_fully_masked_rows_finite():
    """kv_offset -64: rows 0..63 see no key (lse at the sentinel).  The loss
    weighs only the attended rows; the gradients are finite and equal
    JAX's."""
    q, k, v, w = _inputs(11, *[(1, 2, 128, 32)] * 4)
    got, want = _flash_grads(q, k, v, np.ones_like(w), None, -64, True, 64,
                             64, row_lo=64)
    for g, j, name in zip(got, want, ("dq", "dk", "dv")):
        assert np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, j, **FLASH_TOL, err_msg=name)


def test_flash_backward_masked_rows_do_not_leak():
    """A nonzero cotangent on the fully masked rows contributes nothing:
    the gradients equal those with those rows' cotangent zeroed, and
    JAX's.  (Autograd through the dense reference would leak here: it
    gives a masked row a uniform softmax.)"""
    q, k, v, w = _inputs(13, *[(1, 2, 128, 32)] * 4)
    got, want = _flash_grads(q, k, v, w, None, -64, True, 64, 64)
    zeroed, _ = _flash_grads(q, k, v, w, None, -64, True, 64, 64, row_lo=64)
    for g, j, z, name in zip(got, want, zeroed, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, j, **FLASH_TOL, err_msg=name)
        np.testing.assert_allclose(g, z, atol=1e-6, rtol=1e-6, err_msg=name)
    dq_masked = got[0][:, :, :64]
    assert np.all(dq_masked == 0)


def test_flash_backward_lse_cotangent():
    """return_lse with a nonzero lse cotangent (folded into delta), GQA,
    ragged, shifted diagonal."""
    q, k, v, w = _inputs(17, (1, 4, 96, 32), (1, 2, 160, 32),
                         (1, 2, 160, 32), (1, 4, 96, 32))
    (u,) = _inputs(18, (1, 4, 96))
    got, want = _flash_grads(q, k, v, w, u, 32, True, 64, 64)
    for g, j, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, j, **FLASH_TOL, err_msg=name)


def test_flash_attention_diff_without_grad_is_the_forward():
    """No input requires a gradient: the forward alone, nothing saved."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(19, *[(1, 2, 40, 32)] * 3))
    out = fa.flash_attention_diff(q, k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, fa.flash_attention(q, k, v), atol=0,
                               rtol=0)


# ---- layers and model ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_pair():
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    jm = JaxQwen3(JaxConfig.tiny(dtype="float32"), mesh, mode="fused",
                  interpret=True)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    return mesh, jm, params


def _on_mesh(mesh, fn, *args):
    return jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                         check_vma=False)(*args)


def _port_model(params):
    model = Qwen3(ModelConfig.tiny(dtype="float32"), device="cpu")
    return model.load_jax_params(params).requires_grad_(True)


def test_attention_prefill_grads_match_jax(jax_pair):
    mesh, jm, params = jax_pair
    b, s = 2, 24
    x, w = _inputs(21, (b * s, 128), (b * s, 128))
    lp = params["layers"][0]["attn"]

    def loss_jax(x_, p_):
        out, _ = _on_mesh(mesh, lambda xx, pp: jm.attn.prefill(xx, pp, b),
                          x_, p_)
        return jnp.sum(out * w)

    gx, gp = jax.jit(jax.grad(loss_jax, argnums=(0, 1)))(x, lp)
    attn = _port_model(params).layers[0].attn
    xt = _leaf(x)
    out, _ = attn.prefill(xt, b)
    (out * torch.from_numpy(w)).sum().backward()
    _rel_l2(xt.grad, gx, "x")
    for name in ("wqkv", "wo", "q_norm", "k_norm"):
        _rel_l2(getattr(attn, name).grad, gp[name], name)


@pytest.mark.parametrize("mode", ["xla", "fused"])
def test_mlp_grads_match_jax(jax_pair, mode):
    mesh, jm, params = jax_pair
    jmlp = dataclasses.replace(jm.mlp, mode=mode)
    x, w = _inputs(23, (48, 128), (48, 128))
    lp = params["layers"][1]["mlp"]

    def loss_jax(x_, p_):
        out = _on_mesh(mesh, lambda xx, pp: jmlp(xx, pp, training=True), x_,
                       p_)
        return jnp.sum(out * w)

    gx, gp = jax.jit(jax.grad(loss_jax, argnums=(0, 1)))(x, lp)
    mlp = TPMLP(128, 256, mode=mode, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        mlp.gate_up.copy_(torch.from_numpy(np.array(lp["gate_up"])))
        mlp.down.copy_(torch.from_numpy(np.array(lp["down"])))
    mlp.requires_grad_(True)
    xt = _leaf(x)
    (mlp(xt) * torch.from_numpy(w)).sum().backward()
    _rel_l2(xt.grad, gx, "x")
    _rel_l2(mlp.gate_up.grad, gp["gate_up"], "gate_up")
    _rel_l2(mlp.down.grad, gp["down"], "down")


def test_w8a8_mlp_refuses_a_gradient():
    mlp = TPMLP(128, 256, mode="w8a8", dtype=torch.float32, device="cpu")
    mlp.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(8, 128)
    with torch.no_grad():
        assert mlp(x.requires_grad_(True)).shape == (8, 128)
    with pytest.raises(NotImplementedError, match="no backward"):
        mlp(x.requires_grad_(True))


def _ce(logits, targets):
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(targets)),
                                                targets])


@pytest.fixture(scope="module")
def jax_training(jax_pair):
    """The JAX loss and gradients at the initial parameters, and the loss
    after one SGD step of LR on the tied embeddings' summed gradient."""
    mesh, jm, params = jax_pair
    ids = np.random.default_rng(31).integers(0, 256, (2, 48)).astype(
        np.int32)
    targets = np.array([5, 200], np.int32)

    def loss_jax(p_):
        logits, _ = _on_mesh(mesh, lambda pp, ii: jm.prefill_shard(pp, ii,
                                                                   None),
                             p_, ids)
        return _ce(logits, targets)

    value_and_grad = jax.jit(jax.value_and_grad(loss_jax))
    loss0, grads = value_and_grad(params)
    grads = jax.tree.map(np.asarray, grads)
    # `tiny` ties the head to the embeddings: one tensor, whose gradient is
    # the gather's and the head's together.
    tied = grads["embed"] + grads.pop("lm_head").T
    grads["embed"] = tied
    stepped = jax.tree.map(lambda p_, g_: p_ - LR * g_,
                           {k: v for k, v in params.items() if k != "lm_head"},
                           grads)
    stepped["lm_head"] = stepped["embed"].T
    loss1, _ = value_and_grad(stepped)
    return ids, targets, float(loss0), grads, float(loss1)


def test_model_grads_match_jax(jax_pair, jax_training):
    _, _, params = jax_pair
    ids, targets, loss0, grads, _ = jax_training
    model = _port_model(params)
    logits = model(torch.from_numpy(ids))
    assert logits.dtype == torch.float32 and logits.shape == (2, 256)
    loss = F.cross_entropy(logits, torch.from_numpy(targets).long())
    np.testing.assert_allclose(loss.item(), loss0, **LOSS_TOL)
    loss.backward()
    got = model.to_jax_params(grad=True)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    assert len(flat_got) == 2 * 8 + 2
    for (path, g), (_, j) in zip(flat_got, flat_want):
        assert np.abs(j).max() > 0, path
        _rel_l2(g, j, jax.tree_util.keystr(path))


def test_sgd_step_matches_jax(jax_pair, jax_training):
    _, _, params = jax_pair
    ids, targets, loss0, _, loss1 = jax_training
    model = _port_model(params)
    ids_t = torch.from_numpy(ids)
    tgt = torch.from_numpy(targets).long()
    F.cross_entropy(model(ids_t), tgt).backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= LR * p.grad
        after = F.cross_entropy(model(ids_t), tgt).item()
    assert loss1 < loss0 - 1.0, "the step should lower the loss"
    np.testing.assert_allclose(after, loss1, **LOSS_TOL)


def test_to_jax_params_round_trips(jax_pair):
    _, _, params = jax_pair
    tree = _port_model(params).to_jax_params()
    for (path, got), (_, want) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(got, want,
                                      err_msg=jax.tree_util.keystr(path))


def test_inference_launches_and_saves_nothing_new(jax_pair, monkeypatch):
    """With every weight requiring a gradient, prefill under inference mode
    and ``model(ids)`` under no_grad run the forward once per layer, never
    the backward, and save no tensor for one; with grad on, the forward
    saves and one backward runs per layer.  The logits are the same."""
    _, _, params = jax_pair
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention, fa.flash_attention_backward

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention", count("fwd", fwd))
    monkeypatch.setattr(fa, "flash_attention_backward", count("bwd", bwd))
    model = _port_model(params)
    ids = torch.from_numpy(np.random.default_rng(37).integers(
        0, 256, (2, 16)))
    saved = []

    def run(fn):
        calls.update(fwd=0, bwd=0)
        saved.clear()
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            return fn()

    ref = run(lambda: model.prefill(ids, model.create_cache(2, 16)))
    assert calls == {"fwd": 2, "bwd": 0} and not saved
    with torch.no_grad():
        out = run(lambda: model(ids))
    assert calls == {"fwd": 2, "bwd": 0} and not saved
    assert out.grad_fn is None and torch.equal(out, ref)
    out = run(lambda: model(ids))
    assert calls == {"fwd": 2, "bwd": 0} and saved
    assert torch.equal(out.detach(), ref)
    out.sum().backward()
    assert calls == {"fwd": 2, "bwd": 2}
