"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without a CUDA device.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: bf16 out atol=rtol=1e-2 (about one bf16 ulp at magnitude 1:
the kernel rounds its f32 result to bf16), f32 out 1e-4 (order of the
sums, exp2 against exp), lse 1e-3 (f32 on both sides).  The int8 GEMM
is held bit for bit: int32 accumulation is exact and the epilogue
multiplies in the plain version's order.  The flash backward (K4/K5) is
held row by row, since under the causal mask dk and dv shrink along the
keys: |got - ref| <= tol * (|ref| + rms(ref's row) + floor * rms(ref))
(the last term for rows whose exact value is zero, where ds cancels) and
rel_l2 <= rel_tol per output; tol 2e-2, rel_tol 1e-2 and floor 0.1 in
bf16 (p and ds are rounded to bf16 before their products, as in the TPU
kernels, and the outputs to bf16; the kernels need about 1.0e-2 and
2.4e-3 on an H100), 1e-4, 1e-5 and floor 1 in f32.  The grouped GEMM
(K8) and the matmul (K6, its one-group case) are held the same way (a
row's scale is its rms): bf16 out tol 2e-2 and rel_l2 1e-2 (one bf16
rounding of an f32 sum whose products are exact), f32 out 1e-4 and 1e-5
(the order of the sums); the int8 grouped GEMM (K9) bit for bit, as K7.
The collective GEMMs at world W (K12 `ag_gemm`, K14 `gemm_rs`, W ranks in
one launch on the one card) are held the same way against their plain
versions in f32 from the same inputs; K14's bf16 partials are rounded to
bf16 before their sum, which the bf16 bound covers.  On the Hopper body
(bf16 on 16-byte rows) a row of K12 or K14 is held bit for bit across the
call's rows, the tile and the method.
"""


import math

import pytest
import torch

from triton_distributed_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_backward,
    flash_attention_backward_reference, flash_attention_diff,
    flash_attention_reference)
from triton_distributed_tpu_torch.kernels.flash_decode import (
    DECODE_CHUNK, flash_decode, flash_decode_paged,
    flash_decode_paged_reference, flash_decode_reference, gather_pages,
    quantize_kv)
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    AllGatherGEMMContext, ag_gemm, ag_gemm_plain)
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    GEMMReduceScatterContext, gemm_rs, gemm_rs_plain)
from triton_distributed_tpu_torch.kernels.grouped_gemm import (
    grouped_matmul, grouped_matmul_reference, grouped_matmul_w8a8,
    grouped_matmul_w8a8_reference)
from triton_distributed_tpu_torch.kernels.matmul import (
    matmul, matmul_reference)
from triton_distributed_tpu_torch.kernels.quantized import (
    matmul_w8a8, matmul_w8a8_reference, quantize_sym)

pytestmark = pytest.mark.gpu

OUT_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
           torch.float32: dict(atol=1e-4, rtol=1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, dtype, device, *shape):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,causal,kv_offset",
    [
        (2, 8, 8, 128, 128, True, 0),
        (1, 8, 4, 100, 100, True, 0),       # ragged, group 2
        (2, 8, 2, 64, 192, True, 128),      # kv_offset, group 4
        (1, 4, 1, 77, 150, False, 0),       # non-causal, ragged both
        (1, 4, 2, 65, 65, True, 0),         # one row past a tile
        (1, 16, 2, 300, 300, True, 0),      # GQA 8, ragged
    ])
def test_flash_attention_kernel(cuda, dtype, d, b, h, hkv, sq, sk, causal,
                                kv_offset):
    gen = torch.Generator(device=cuda).manual_seed(sq * 31 + sk)
    q = _randn(gen, dtype, cuda, b, h, sq, d)
    k = _randn(gen, dtype, cuda, b, hkv, sk, d)
    v = _randn(gen, dtype, cuda, b, hkv, sk, d)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, kv_offset=kv_offset,
                               return_lse=True)
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_reference(
        q.float(), k.float(), v.float(), causal=causal, kv_offset=kv_offset,
        return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, **OUT_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_decode_kernel(cuda, dtype, d, group):
    b, hkv, s = 4, 2, 300
    gen = torch.Generator(device=cuda).manual_seed(group * 7 + d)
    q = _randn(gen, dtype, cuda, b, hkv * group, d)
    kc = _randn(gen, dtype, cuda, b, hkv, s, d)
    vc = _randn(gen, dtype, cuda, b, hkv, s, d)
    kv_len = torch.tensor([1, 17, 150, s], dtype=torch.int32, device=cuda)
    before = flash_decode.launches
    out, lse = flash_decode(q, kc, vc, kv_len)
    assert flash_decode.launches == before + 1
    ref, ref_lse = flash_decode_reference(q.float(), kc.float(), vc.float(),
                                          kv_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, **OUT_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


def _paged_of(gen, cache, kv_len, ps):
    """The pools and table holding a dense cache's positions below kv_len
    in shuffled pages; the null page and every unmapped position hold
    garbage (1e4, or codes 127 and NaN scales)."""
    k, v, ks, vs = cache
    b, hkv, s = k.shape[:3]
    t = -(-s // ps)
    need = [-(-int(n) // ps) for n in kv_len.tolist()]
    perm = 1 + torch.randperm(sum(need), generator=gen, device=k.device)
    table = torch.zeros((b, t), dtype=torch.int32, device=k.device)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n].to(torch.int32)
        at += n
    mapped = table != 0
    pools = []
    for x, fill in ((k, 127 if ks is not None else 1e4),
                    (v, 127 if ks is not None else -1e4),
                    (ks, float("nan")), (vs, float("nan"))):
        if x is None:
            pools.append(None)
            continue
        tail = x.shape[3:]
        padded = torch.full((b, hkv, t * ps, *tail), fill, dtype=x.dtype,
                            device=x.device)
        padded[:, :, :s] = x
        blocks = padded.reshape(b, hkv, t, ps, *tail).transpose(1, 2)
        pool = torch.full((1 + sum(need), hkv, ps, *tail), fill,
                          dtype=x.dtype, device=x.device)
        pool[table[mapped].long()] = blocks[mapped]
        pools.append(pool)
    return pools, table


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("page_size", [16, 24])
def test_flash_decode_paged_kernel(cuda, dtype, d, group, page_size):
    """Against the plain version, and bit for bit against the dense
    kernel over the same logical K/V (shared body)."""
    b, hkv, s = 4, 2, 300
    gen = torch.Generator(device=cuda).manual_seed(group * 7 + d + page_size)
    q = _randn(gen, dtype, cuda, b, hkv * group, d)
    kc = _randn(gen, dtype, cuda, b, hkv, s, d)
    vc = _randn(gen, dtype, cuda, b, hkv, s, d)
    kv_len = torch.tensor([1, 17, 150, s], dtype=torch.int32, device=cuda)
    (kp, vp, _, _), table = _paged_of(gen, (kc, vc, None, None), kv_len,
                                      page_size)
    before = flash_decode_paged.launches
    out, lse = flash_decode_paged(q, kp, vp, table, kv_len)
    assert flash_decode_paged.launches == before + 1
    ref, ref_lse = flash_decode_paged_reference(q.float(), kp.float(),
                                                vp.float(), table, kv_len)
    dense, dense_lse = flash_decode(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, **OUT_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert torch.equal(out, dense) and torch.equal(lse, dense_lse)


BWD_TOL = {torch.bfloat16: (2e-2, 1e-2, 0.1),
           torch.float32: (1e-4, 1e-5, 1.0)}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [100, 200, 1100])
@pytest.mark.parametrize("kv_offset", [0, 37, -5])
def test_flash_attention_kernel_ragged_lengths(cuda, d, s, kv_offset):
    """Lengths off the 128-row tile and the 128-key stage, with shifted
    diagonals: K1 against its plain version, row by row.  Rows that see no
    key (i + kv_offset < 0) only need lse ~ -inf."""
    from triton_distributed_tpu_torch.kernels.flash_attention import LSE_DEAD

    gen = torch.Generator(device=cuda).manual_seed(s * 7 + d + kv_offset)
    q = _randn(gen, torch.bfloat16, cuda, 2, 8, s, d)
    k = _randn(gen, torch.bfloat16, cuda, 2, 2, s + 29, d)
    v = _randn(gen, torch.bfloat16, cuda, 2, 2, s + 29, d)
    out, lse = flash_attention(q, k, v, kv_offset=kv_offset, return_lse=True)
    ref, ref_lse = flash_attention_reference(
        q.float(), k.float(), v.float(), kv_offset=kv_offset, return_lse=True)
    torch.cuda.synchronize()
    live = max(0, -kv_offset)
    torch.testing.assert_close(out[:, :, live:].float(), ref[:, :, live:],
                               **OUT_TOL[torch.bfloat16])
    torch.testing.assert_close(lse[:, :, live:], ref_lse[:, :, live:],
                               atol=1e-3, rtol=0)
    assert bool((lse[:, :, :live] <= LSE_DEAD).all())


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_row_alone_matches_batch(cuda, d):
    """A (batch, head)'s rows alone give the bits they get in a call with
    more batches and heads: a row depends on its own q, K and V only."""
    gen = torch.Generator(device=cuda).manual_seed(40 + d)
    q = _randn(gen, torch.bfloat16, cuda, 3, 8, 333, d)
    k = _randn(gen, torch.bfloat16, cuda, 3, 2, 333, d)
    v = _randn(gen, torch.bfloat16, cuda, 3, 2, 333, d)
    for off in (0, 37):
        out, lse = flash_attention(q, k, v, kv_offset=off, return_lse=True)
        for b, h in ((0, 0), (2, 5), (1, 7)):
            hk = h // 4
            one, one_lse = flash_attention(
                q[b:b + 1, h:h + 1].contiguous(),
                k[b:b + 1, hk:hk + 1].contiguous(),
                v[b:b + 1, hk:hk + 1].contiguous(), kv_offset=off,
                return_lse=True)
            torch.cuda.synchronize()
            assert torch.equal(one[0, 0], out[b, h]), (off, b, h)
            assert torch.equal(one_lse[0, 0], lse[b, h]), (off, b, h)


_TIMEOUT_SCRIPT = """
import shutil, sys, tempfile
from pathlib import Path
import torch
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import allgather as ag

tmp = Path(tempfile.mkdtemp(prefix="spin_timeout_"))
shutil.copytree(_build.CSRC, tmp / "csrc")
src = tmp / "csrc" / "all_gather.cu"
src.write_text("#define TDT_SPIN_BUDGET_CYCLES 200000000LL\\n"
               + src.read_text())
_build.CSRC, _build.BUILD_DIR = tmp / "csrc", tmp / "build"
x = torch.ones((4, 64, 256), dtype=torch.bfloat16, device="cuda")
ctx = ag.AllGatherContext("tp", 4, "ring", straggler=(1, 4_000_000_000))
ag.all_gather(x, ctx)
try:
    _build.synchronize()
except RuntimeError as e:
    print(e)
    sys.exit(0)
print("no timeout")
sys.exit(1)
"""


def test_spin_timeout_names_the_wait(cuda, tmp_path):
    """A wait that outlasts its budget traps and the host names it: K15
    built with a 0.1 s budget, rank 1 straggling 2 s, in a process of its
    own (the trap kills its CUDA context)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    res = subprocess.run(
        [sys.executable, "-c", _TIMEOUT_SCRIPT], capture_output=True,
        text=True, timeout=300, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": str(root)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "a wait timed out: " in res.stdout, res.stdout
    assert any(name in res.stdout for name in (
        "barrier_neighbors (WAIT_BARRIER_NEIGHBORS)",
        "all_gather ring arrival (WAIT_ALL_GATHER_RING)")), res.stdout


def _assert_rows_close(name, got, ref, tol, rel_tol, floor):
    err = (got.float() - ref).abs()
    row = ref.pow(2).mean(-1, keepdim=True).sqrt()
    floor = floor * ref.pow(2).mean().sqrt()
    ratio = float((err / (ref.abs() + row + floor).clamp_min(
        torch.finfo(torch.float32).tiny)).max())
    rel = float(err.norm() / ref.norm())
    assert ratio <= tol and rel <= rel_tol, (
        f"{name}: max err/(|ref| + rms_row + floor*rms) {ratio:.3e}, rel_l2 "
        f"{rel:.3e}")


def _bwd_inputs(cuda, dtype, b, h, hkv, sq, sk, d, causal, kv_offset, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = _randn(gen, dtype, cuda, b, h, sq, d)
    k = _randn(gen, dtype, cuda, b, hkv, sk, d)
    v = _randn(gen, dtype, cuda, b, hkv, sk, d)
    do = _randn(gen, dtype, cuda, b, h, sq, d)
    out, lse = flash_attention(q, k, v, causal=causal, kv_offset=kv_offset,
                               return_lse=True)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,causal,kv_offset",
    [
        (2, 8, 8, 128, 128, True, 0),
        (1, 8, 4, 100, 100, True, 0),       # ragged, group 2
        (2, 8, 2, 64, 192, True, 128),      # kv_offset, group 4
        (1, 4, 1, 77, 150, False, 0),       # non-causal, ragged both
        (1, 4, 2, 65, 65, True, 0),         # one row past a tile
        (1, 8, 2, 130, 130, True, -70),     # fully masked rows 0..69
        (1, 8, 2, 129, 129, True, 0),       # one row / key past a stage
        (1, 8, 2, 255, 255, True, 0),       # one short of two stages
        (1, 8, 4, 128, 255, False, 0),      # stage edges, non-causal
        (1, 8, 2, 255, 129, True, 128),     # ragged both, shifted
        (4, 32, 8, 512, 512, True, 0),      # the training shape, group 4
        (1, 8, 2, 2048, 2048, True, 2048),  # a ring step over shards of 2048
        (1, 8, 2, 256, 512, True, 256),     # a shifted ring step
    ])
def test_flash_backward_kernels(cuda, dtype, d, b, h, hkv, sq, sk, causal,
                                kv_offset):
    """K4/K5 against the plain version on the same inputs (the forward's
    out and lse from K1), a nonzero lse cotangent included; fully masked
    rows get exactly zero dq; two runs are bit-identical; the pair counts
    one launch, K4 and K5 one each, and one on the bf16 bodies
    (``wgmma_launches``) in bf16 only."""
    q, k, v, out, lse, do = _bwd_inputs(cuda, dtype, b, h, hkv, sq, sk, d,
                                        causal, kv_offset, sq * 7 + sk + d)
    dlse = torch.randn(lse.shape, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(5))
    counts = (flash_attention_backward.launches,
              flash_attention_backward.dq_launches,
              flash_attention_backward.dkv_launches,
              flash_attention_backward.wgmma_launches)
    got = flash_attention_backward(q, k, v, out, lse, do, dlse,
                                   causal=causal, kv_offset=kv_offset)
    bf16 = dtype == torch.bfloat16
    assert (flash_attention_backward.launches,
            flash_attention_backward.dq_launches,
            flash_attention_backward.dkv_launches,
            flash_attention_backward.wgmma_launches) == (
                counts[0] + 1, counts[1] + 1, counts[2] + 1,
                counts[3] + bf16)
    again = flash_attention_backward(q, k, v, out, lse, do, dlse,
                                     causal=causal, kv_offset=kv_offset)
    ref = flash_attention_backward_reference(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(), dlse,
        causal=causal, kv_offset=kv_offset)
    torch.cuda.synchronize()
    for name, g, a, r in zip(("dq", "dk", "dv"), got, again, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert torch.equal(g, a), f"{name}: two runs differ"
        assert bool(g.isfinite().all()), name
        _assert_rows_close(name, g, r, *BWD_TOL[dtype])
    if kv_offset < 0:
        dead = lse <= -1e29
        assert bool(dead.any())
        assert bool((got[0][dead] == 0).all())


def test_flash_attention_diff_launches(cuda):
    """Under autograd: K1 once in the forward, K4/K5 once in the backward,
    the gradients those of `flash_attention_backward` bit for bit; without
    a gradient, K1 alone."""
    q, k, v, _, _, do = _bwd_inputs(cuda, torch.bfloat16, 2, 8, 2, 96, 96,
                                    128, True, 0, 3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention_backward.launches
    out, lse = flash_attention_diff(*leaves, return_lse=True)
    assert (flash_attention.launches, flash_attention_backward.launches) == (
        f0 + 1, b0)
    # The cotangent arrives non-contiguous, as through the layer's reshape.
    grads = torch.autograd.grad(out, leaves,
                                do.transpose(2, 3).contiguous()
                                .transpose(2, 3))
    assert flash_attention_backward.launches == b0 + 1
    want = flash_attention_backward(q, k, v, out.detach(), lse.detach(),
                                    do.contiguous())
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        flash_attention_diff(*leaves)
    assert flash_attention.launches == f0 + 2
    assert flash_attention_backward.launches == b0 + 2


def test_tiny_model_grads_gpu_match_cpu(cuda):
    """The training path on the card (K1, K4, K5, cuBLAS in f32) against
    the CPU (plain versions): every parameter's gradient of a last-position
    cross-entropy within 1e-4 relative L2, one K4/K5 pair per layer."""
    import torch.nn.functional as F

    from triton_distributed_tpu_torch import ModelConfig, Qwen3

    cfg = ModelConfig.tiny(dtype="float32", head_dim=64)
    cpu = Qwen3(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Qwen3(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 40),
                        generator=torch.Generator().manual_seed(1))
    targets = torch.tensor([3, 200])
    before = flash_attention_backward.launches
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        model.requires_grad_(True)
        F.cross_entropy(model(ids.to(dev)), targets.to(dev)).backward()
    assert flash_attention_backward.launches == before + cfg.num_layers
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        rel = float((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm())
        assert rel <= 1e-4, f"{name}: rel_l2 {rel:.3e}"


def test_flash_backward_rejects_unsupported_inputs(cuda):
    q, k, v, out, lse, do = _bwd_inputs(cuda, torch.bfloat16, 1, 2, 2, 64,
                                        64, 64, True, 0, 9)
    with pytest.raises(ValueError, match="do must be"):
        flash_attention_backward(q, k, v, out, lse,
                                 do.transpose(2, 3).contiguous()
                                 .transpose(2, 3))
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_backward(q, k, v, out, lse.double(), do)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_backward(*(t[..., :32].contiguous()
                                   for t in (q, k, v, out)), lse,
                                 do[..., :32].contiguous())


def test_kernels_reject_unsupported_inputs(cuda):
    q = torch.zeros(1, 2, 8, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3), q.transpose(2, 3),
                        q.transpose(2, 3))
    qd = torch.zeros(1, 6, 64, device=cuda, dtype=torch.bfloat16)
    kc = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="group"):
        flash_decode(qd, kc, kc, torch.ones(1, dtype=torch.int32,
                                            device=cuda))
    qd = torch.zeros(1, 4, 64, device=cuda, dtype=torch.bfloat16)
    kp = torch.zeros(3, 2, 16, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="page_table"):
        flash_decode_paged(qd, kp, kp,
                           torch.zeros(1, 2, dtype=torch.int64,
                                       device=cuda),
                           torch.ones(1, dtype=torch.int32, device=cuda))


def test_tiny_model_gpu_matches_cpu(cuda):
    """The whole slice on the card (kernels) against the CPU (plain
    versions), f32, greedy: same tokens, logits within 1e-3."""
    from triton_distributed_tpu_torch import Engine, ModelConfig, Qwen3

    cfg = ModelConfig.tiny(dtype="float32", head_dim=64)
    cpu = Qwen3(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Qwen3(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 24),
                        generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(
        gpu.prefill(ids.to(cuda), gpu.create_cache(2)).cpu(),
        cpu.prefill(ids, cpu.create_cache(2)), atol=1e-3, rtol=1e-3)
    assert torch.equal(Engine(gpu).serve(ids.to(cuda), 6).cpu(),
                       Engine(cpu).serve(ids, 6))


def test_tiny_scheduler_gpu_matches_cpu(cuda):
    """The scheduler over the tiny f32 model on the card (K1, K2, K3)
    against the CPU (plain versions), both layouts, greedy: same tokens,
    and the paged run goes through the paged kernel."""
    from triton_distributed_tpu_torch import (
        ContinuousBatchingScheduler, ModelConfig, Qwen3, Request,
        SchedulerConfig)

    cfg = ModelConfig.tiny(dtype="float32", head_dim=64)
    cpu = Qwen3(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Qwen3(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    prefix = torch.randint(1, cfg.vocab_size, (16,), generator=gen).tolist()
    prompts = [prefix + torch.randint(1, cfg.vocab_size, (n,),
                                      generator=gen).tolist()
               for n in (3, 9, 20)]
    outs = []
    for model in (cpu, gpu):
        for layout in ("slots", "paged"):
            sched = ContinuousBatchingScheduler(model, SchedulerConfig(
                num_slots=2, max_seq=64, prefill_buckets=(16, 32, 64),
                page_size=8, kv_layout=layout))
            before = flash_decode_paged.launches
            done = sched.run([Request(prompt=p, max_new_tokens=6)
                              for p in prompts])
            if model is gpu and layout == "paged":
                assert flash_decode_paged.launches > before
            outs.append([r.generated for r in
                         sorted(done, key=lambda r: r.request_id)])
    assert all(o == outs[0] for o in outs)


def _int8_kv(gen, device, b, hkv, s, d, kv_len):
    """An int8 cache (codes and scales through quantize_kv) whose scales
    past each row's length are NaN, as a reused slot's may be stale."""
    k_q, v_q, ks, vs = quantize_kv(_randn(gen, torch.float32, device, b, hkv,
                                          s, d),
                                   _randn(gen, torch.float32, device, b, hkv,
                                          s, d))
    past = (torch.arange(s, device=device)[None, :]
            >= kv_len[:, None])[:, None, :].expand_as(ks)
    ks[past] = float("nan")
    vs[past] = float("nan")
    return k_q, v_q, ks, vs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_decode_int8_kernel(cuda, dtype, d, group):
    """K2q against its plain version; NaN scales past kv_len never reach
    the result."""
    b, hkv, s = 4, 2, 300
    gen = torch.Generator(device=cuda).manual_seed(group * 11 + d)
    q = _randn(gen, dtype, cuda, b, hkv * group, d)
    kv_len = torch.tensor([1, 17, 150, s], dtype=torch.int32, device=cuda)
    k_q, v_q, ks, vs = _int8_kv(gen, cuda, b, hkv, s, d, kv_len)
    before = flash_decode.int8_launches
    out, lse = flash_decode(q, k_q, v_q, kv_len, k_scale=ks, v_scale=vs)
    assert flash_decode.int8_launches == before + 1
    ref, ref_lse = flash_decode_reference(q.float(), k_q, v_q, kv_len,
                                          k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert out.dtype == dtype and bool(out.isfinite().all())
    torch.testing.assert_close(out.float(), ref, **OUT_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("page_size", [16, 24])
def test_flash_decode_paged_int8_kernel(cuda, dtype, group, page_size):
    """K3q against its plain version, and bit for bit against K2q over the
    same logical codes and scales.  The null page holds codes of 127 and
    NaN scales, and every unmapped page too."""
    b, hkv, s, d = 4, 2, 300, 128
    gen = torch.Generator(device=cuda).manual_seed(group * 13 + page_size)
    q = _randn(gen, dtype, cuda, b, hkv * group, d)
    kv_len = torch.tensor([1, 17, 150, s], dtype=torch.int32, device=cuda)
    k_q, v_q, ks, vs = _int8_kv(gen, cuda, b, hkv, s, d, kv_len)
    (kp, vp, ksp, vsp), table = _paged_of(gen, (k_q, v_q, ks, vs), kv_len,
                                          page_size)
    before = flash_decode_paged.int8_launches
    out, lse = flash_decode_paged(q, kp, vp, table, kv_len, k_scale=ksp,
                                  v_scale=vsp)
    assert flash_decode_paged.int8_launches == before + 1
    ref, ref_lse = flash_decode_paged_reference(
        q.float(), kp, vp, table, kv_len, k_scale=ksp, v_scale=vsp)
    dense, dense_lse = flash_decode(q, k_q, v_q, kv_len, k_scale=ks,
                                    v_scale=vs)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, **OUT_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert torch.equal(out, dense) and torch.equal(lse, dense_lse)
    assert torch.equal(gather_pages(ksp, table)[:, :, :s][
        ~ks.isnan()], ks[~ks.isnan()])


# The split-KV body (csrc/decode_body.cuh) cuts each row into chunks of
# DECODE_CHUNK positions and combines a row's chunks in order, inside the
# launch; a row's result must not depend on the batch, the capacity or the
# layout.
CH = DECODE_CHUNK


def _decode_cache(gen, device, dtype, quant, b, hkv, s, d, kv_len):
    """(k, v, k_scale, v_scale) dense caches: float in ``dtype`` (scales
    None), or int8 codes with NaN scales past kv_len."""
    if quant:
        return _int8_kv(gen, device, b, hkv, s, d, kv_len)
    return (_randn(gen, dtype, device, b, hkv, s, d),
            _randn(gen, dtype, device, b, hkv, s, d), None, None)


def _decode(q, cache, kv_len, table=None):
    k, v, ks, vs = cache
    if table is None:
        return flash_decode(q, k, v, kv_len, k_scale=ks, v_scale=vs)
    return flash_decode_paged(q, k, v, table, kv_len, k_scale=ks,
                              v_scale=vs)


def _decode_reference(q, cache, kv_len, table=None):
    k, v, ks, vs = cache
    if ks is None:
        k, v = k.float(), v.float()
    if table is None:
        return flash_decode_reference(q.float(), k, v, kv_len, k_scale=ks,
                                      v_scale=vs)
    return flash_decode_paged_reference(q.float(), k, v, table, kv_len,
                                        k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page_size", [1, 16, 24])
def test_flash_decode_chunk_edges(cuda, dtype, quant, page_size):
    """Rows at CH - 1, CH, CH + 1 positions, several chunks and the full
    capacity (not a multiple of CH): dense and paged against the plain
    version, and bit for bit against each other."""
    b, hkv, g, d, s = 5, 2, 4, 128, 4 * CH + 37
    gen = torch.Generator(device=cuda).manual_seed(page_size * 5 + quant)
    q = _randn(gen, dtype, cuda, b, hkv * g, d)
    kv_len = torch.tensor([CH - 1, CH, CH + 1, 3 * CH + 5, s],
                          dtype=torch.int32, device=cuda)
    cache = _decode_cache(gen, cuda, dtype, quant, b, hkv, s, d, kv_len)
    pools, table = _paged_of(gen, cache, kv_len, page_size)
    counter = "int8_launches" if quant else "launches"
    before = (getattr(flash_decode, counter),
              getattr(flash_decode_paged, counter))
    dense = _decode(q, cache, kv_len)
    paged = _decode(q, pools, kv_len, table)
    assert (getattr(flash_decode, counter),
            getattr(flash_decode_paged, counter)) == tuple(
                n + 1 for n in before)
    ref, ref_lse = _decode_reference(q, cache, kv_len)
    torch.cuda.synchronize()
    assert bool(dense[0].isfinite().all())
    torch.testing.assert_close(dense[0].float(), ref, **OUT_TOL[dtype])
    torch.testing.assert_close(dense[1], ref_lse, atol=1e-3, rtol=0)
    assert torch.equal(paged[0], dense[0]) and torch.equal(paged[1],
                                                           dense[1])


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_flash_decode_capacity_far_above_lengths(cuda, quant, paged):
    """A capacity of 16,384 positions over rows of 1..700: every chunk past
    a row's length exits, and each row's out and lse are bit for bit those
    of a capacity that just holds the longest row."""
    b, hkv, g, d, wide, tight = 3, 2, 4, 128, 16384, 704
    gen = torch.Generator(device=cuda).manual_seed(41 + quant + 2 * paged)
    q = _randn(gen, torch.bfloat16, cuda, b, hkv * g, d)
    kv_len = torch.tensor([1, 200, 700], dtype=torch.int32, device=cuda)
    cache = _decode_cache(gen, cuda, torch.bfloat16, quant, b, hkv, wide, d,
                          kv_len)
    short = tuple(None if x is None else x[:, :, :tight].contiguous()
                  for x in cache)
    if paged:
        cache, table = _paged_of(gen, cache, kv_len, 16)
        short, short_table = _paged_of(gen, short, kv_len, 16)
    else:
        table = short_table = None
    got = _decode(q, cache, kv_len, table)
    want = _decode(q, short, kv_len, short_table)
    ref, ref_lse = _decode_reference(q, short, kv_len, short_table)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0].float(), ref,
                               **OUT_TOL[torch.bfloat16])
    torch.testing.assert_close(got[1], ref_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_flash_decode_row_alone_matches_batch(cuda, quant, paged):
    """Each row of an 8-row batch at the scheduler's lengths (1 .. 2048)
    run alone (B = 1) gives out and lse bit for bit those of the batch, and
    two back-to-back calls of the batch are bit-identical."""
    lens = (1, 15, 16, 17, 513, 1000, 1928, 2048)
    b, hkv, g, d, s = len(lens), 2, 4, 128, 2048
    gen = torch.Generator(device=cuda).manual_seed(7 + quant + 2 * paged)
    q = _randn(gen, torch.bfloat16, cuda, b, hkv * g, d)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    cache = _decode_cache(gen, cuda, torch.bfloat16, quant, b, hkv, s, d,
                          kv_len)
    table = None
    if paged:
        cache, table = _paged_of(gen, cache, kv_len, 16)
    batch = _decode(q, cache, kv_len, table)
    again = _decode(q, cache, kv_len, table)
    torch.cuda.synchronize()
    assert torch.equal(batch[0], again[0]) and torch.equal(batch[1],
                                                           again[1])
    for i in range(b):
        if paged:
            alone = _decode(q[i:i + 1], cache, kv_len[i:i + 1],
                            table[i:i + 1].contiguous())
        else:
            alone = _decode(q[i:i + 1], tuple(
                None if x is None else x[i:i + 1] for x in cache),
                kv_len[i:i + 1])
        assert torch.equal(alone[0], batch[0][i:i + 1]), f"row {i} out"
        assert torch.equal(alone[1], batch[1][i:i + 1]), f"row {i} lse"


@pytest.mark.parametrize("layout", ["k_major", "kn"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (8, 4096, 512),       # a decode batch, k split
    (300, 1024, 640),     # ragged m, several 128-row tiles
    (37, 208, 136),       # ragged m and n, k not a multiple of 128
    (130, 64, 100),       # n not a multiple of 16
    (33, 8192, 999),      # odd n, a ragged 64-row k split
    (8, 12288, 4096),     # the 8-row down projection: k in 4 ranges
    (1, 16, 1),
])
def test_matmul_w8a8_kernel(cuda, out_dtype, m, k, n, layout):
    """K7 against its exact plain version: equal bit for bit, on the int8
    Hopper tile, over 3 back-to-back calls; b read in place when stored
    K-major, through one counted copy a call when (k, n) contiguous."""
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    if layout == "k_major":
        b = b.t().contiguous().t()
    copies = 3 * (not b.t().is_contiguous())  # (k, 1) is K-major too
    sa = torch.rand(m, generator=gen, device=cuda) / 100
    sb = torch.rand(n, generator=gen, device=cuda) / 100
    before = (matmul_w8a8.launches, matmul_w8a8.wgmma_launches,
              matmul_w8a8.transposes)
    outs = [matmul_w8a8(a, b, sa, sb, out_dtype=out_dtype) for _ in range(3)]
    assert (matmul_w8a8.launches, matmul_w8a8.wgmma_launches,
            matmul_w8a8.transposes) == (before[0] + 3, before[1] + 3,
                                        before[2] + copies)
    want = matmul_w8a8_reference(a, b, sa, sb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    for out in outs:
        assert out.dtype == out_dtype and torch.equal(out, want)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 24576), (2048, 3072, 4096)])
def test_matmul_w8a8_kernel_every_plan(cuda, m, k, n):
    """K7 gives the same bits on every tile and k split the planner can
    choose (int32 sums are exact in any order): each (tile, split) launched
    through `quantized._launch` against the plain version."""
    from triton_distributed_tpu_torch.kernels import quantized

    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    bt = torch.randint(-127, 128, (n, k), generator=gen, device=cuda,
                       dtype=torch.int8)
    sa = torch.rand(m, generator=gen, device=cuda) / 100
    sb = torch.rand(n, generator=gen, device=cuda) / 100
    want = matmul_w8a8_reference(a, bt.t(), sa, sb)
    stages = -(-k // quantized.K_STAGE)
    for rows, tn in quantized.W8A8_TILES:
        for split in (1, 2, 3, 8):
            per = -(-stages // split)
            if (split - 1) * per >= stages:
                continue
            out = torch.empty((m, n), dtype=torch.bfloat16, device=cuda)
            quantized._launch(a, bt, sa, sb, out,
                              quantized.W8A8Plan(rows, tn, split, per))
            torch.cuda.synchronize()
            assert torch.equal(out, want), (rows, tn, split)


def test_int8_kernels_reject_unsupported_inputs(cuda):
    a = torch.zeros(4, 24, dtype=torch.int8, device=cuda)
    b = torch.zeros(24, 16, dtype=torch.int8, device=cuda)
    ones = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        matmul_w8a8(a, b, ones[:4], ones)
    with pytest.raises(ValueError, match="int8"):
        matmul_w8a8(a[:, :16].float(), b[:16], ones[:4], ones)
    qd = torch.zeros(1, 4, 64, device=cuda, dtype=torch.bfloat16)
    kc = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.int8)
    sc = torch.ones(1, 2, 16, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="both"):
        flash_decode(qd, kc, kc, one, k_scale=sc)
    with pytest.raises(ValueError, match="k_scale"):
        flash_decode(qd, kc, kc, one, k_scale=sc[:, :1], v_scale=sc[:, :1])
    with pytest.raises(ValueError, match="cache must be"):
        flash_decode(qd, kc, kc, one)


def test_w8a8_mlp_kernel_matches_plain(cuda):
    """The w8a8 layer on the card (K7 twice) equals its plain version on
    the same card bit for bit: the same quantization ops feed both GEMMs."""
    from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP, mlp_w8a8

    mlp = TPMLP(256, 512, mode="w8a8", device=cuda)
    mlp.init_params(torch.Generator(device=cuda).manual_seed(0))
    x = _randn(torch.Generator(device=cuda).manual_seed(1), torch.bfloat16,
               cuda, 37, 256)
    before = (matmul_w8a8.launches, matmul_w8a8.transposes)
    got = mlp(x)
    # Both weights stored K-major: read in place, no copy.
    assert (matmul_w8a8.launches, matmul_w8a8.transposes) == (
        before[0] + 2, before[1])
    want = mlp_w8a8(x, mlp.gate_up_q, mlp.gate_up_scale, mlp.down_q,
                    mlp.down_scale, matmul=matmul_w8a8_reference)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_tiny_int8_model_gpu_matches_cpu(cuda):
    """Qwen3 tiny f32 with an int8 cache on the card (K1, K2q) against the
    CPU (plain versions): greedy tokens equal, prefill logits within 1e-3,
    and the cache's codes equal or one apart (f32 K/V of the two devices
    may differ in the last bits on a rounding half)."""
    from triton_distributed_tpu_torch import Engine, ModelConfig, Qwen3

    cfg = ModelConfig.tiny(dtype="float32", head_dim=64,
                           quantize_kv_cache=True)
    cpu = Qwen3(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Qwen3(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (2, 24),
                        generator=torch.Generator().manual_seed(1))
    cg, cc = gpu.create_cache(2), cpu.create_cache(2)
    torch.testing.assert_close(gpu.prefill(ids.to(cuda), cg).cpu(),
                               cpu.prefill(ids, cc), atol=1e-3, rtol=1e-3)
    for a, b in zip(cg.ks + cg.vs, cc.ks + cc.vs):
        assert int((a.cpu().int() - b.int()).abs().max()) <= 1
    before = flash_decode.int8_launches
    assert torch.equal(Engine(gpu).serve(ids.to(cuda), 6).cpu(),
                       Engine(cpu).serve(ids, 6))
    assert flash_decode.int8_launches == before + 5 * cfg.num_layers


def test_tiny_int8_scheduler_gpu_matches_cpu(cuda):
    """The scheduler over the tiny f32 int8 model on the card (K1, K2q,
    K3q) against the CPU, both layouts, greedy: same tokens."""
    from triton_distributed_tpu_torch import (
        ContinuousBatchingScheduler, ModelConfig, Qwen3, Request,
        SchedulerConfig)

    cfg = ModelConfig.tiny(dtype="float32", head_dim=64,
                           quantize_kv_cache=True)
    cpu = Qwen3(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Qwen3(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    prefix = torch.randint(1, cfg.vocab_size, (16,), generator=gen).tolist()
    prompts = [prefix + torch.randint(1, cfg.vocab_size, (n,),
                                      generator=gen).tolist()
               for n in (3, 9, 20)]
    outs = []
    for model in (cpu, gpu):
        for layout in ("slots", "paged"):
            sched = ContinuousBatchingScheduler(model, SchedulerConfig(
                num_slots=2, max_seq=64, prefill_buckets=(16, 32, 64),
                page_size=8, kv_layout=layout))
            before = flash_decode_paged.int8_launches
            done = sched.run([Request(prompt=p, max_new_tokens=6)
                              for p in prompts])
            if model is gpu and layout == "paged":
                assert flash_decode_paged.int8_launches > before
            outs.append([r.generated for r in
                         sorted(done, key=lambda r: r.request_id)])
    assert all(o == outs[0] for o in outs)


# ---- the MoE slice: K6, K8, K9 -------------------------------------------

GEMM_TOL = {torch.bfloat16: (2e-2, 1e-2, 0.0), torch.float32: (1e-4, 1e-5, 0.0)}

#: (E, m, k, n): a decode bucket (16 rows) and 64 rows (the 64-row wgmma
#: tile), a prefill bucket (the 128-row wgmma tile), ragged m, n and k on
#: 16-byte rows, k and n off 16-byte rows (bf16: the mma.sync tile, loads
#: by element), one group; then the wgmma tile's edges: m off 64 with
#: E > 1 on each tile shape (a box past m must not read the next group's
#: rows), k off the 64-deep stage, n off the 256-wide tile, and one group
#: at K6's width (Qwen3-8B's gate_up).
GROUPED_SHAPES = [(8, 16, 256, 384), (4, 64, 128, 256), (3, 256, 512, 640),
                  (5, 37, 136, 200), (3, 70, 100, 77), (1, 130, 64, 96),
                  (6, 40, 128, 256), (4, 100, 256, 512), (2, 128, 200, 256),
                  (2, 64, 128, 264), (1, 128, 4096, 24576)]


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,m,k,n", GROUPED_SHAPES)
def test_grouped_matmul_kernel(cuda, dtype, out_dtype, e, m, k, n):
    """K8 against its plain version, row by row; two launches are
    bit-identical and each counts once."""
    gen = torch.Generator(device=cuda).manual_seed(e * 1000 + m + k + n)
    a = _randn(gen, dtype, cuda, e, m, k)
    b = _randn(gen, dtype, cuda, e, k, n) * k ** -0.5
    before = grouped_matmul.launches
    got = grouped_matmul(a, b, out_dtype)
    again = grouped_matmul(a, b, out_dtype)
    assert grouped_matmul.launches == before + 2
    ref = grouped_matmul_reference(a, b, torch.float32)
    torch.cuda.synchronize()
    want_dtype = out_dtype or dtype
    assert got.dtype == want_dtype and got.shape == (e, m, n)
    assert torch.equal(got, again)
    _assert_rows_close("grouped_matmul", got, ref, *GEMM_TOL[want_dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(8, 512, 1024), (200, 256, 384),
                                   (33, 72, 40)])
def test_matmul_kernel_and_ag_gemm(cuda, dtype, m, k, n):
    """K6 (the one-group grouped GEMM) through `matmul` and through
    ``ag_gemm(method="fused"|"ll")`` at world 1, each one launch counted
    by `matmul` alone; ``"xla"`` and ``"auto"`` launch nothing."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = _randn(gen, dtype, cuda, m, k)
    b = _randn(gen, dtype, cuda, k, n) * k ** -0.5
    ref = matmul_reference(a, b, torch.float32)
    before = (matmul.launches, grouped_matmul.launches)
    outs = [matmul(a, b)]
    for method in ("fused", "ll"):
        out, gathered = ag_gemm(a, b, AllGatherGEMMContext("tp", 1, method),
                                return_gathered=True)
        assert gathered is a
        outs.append(out)
    assert (matmul.launches, grouped_matmul.launches) == (before[0] + 3,
                                                          before[1])
    for method in ("xla", "auto"):
        outs.append(ag_gemm(a, b, AllGatherGEMMContext("tp", 1, method)))
    assert matmul.launches == before[0] + 3
    torch.cuda.synchronize()
    for out in outs:
        assert out.dtype == dtype and out.shape == (m, n)
        _assert_rows_close("matmul", out, ref, *GEMM_TOL[dtype])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,m,k,n", [(8, 32, 256, 384), (3, 256, 512, 640),
                                     (5, 37, 144, 200), (1, 40, 64, 96)])
def test_grouped_matmul_w8a8_kernel(cuda, out_dtype, e, m, k, n):
    """K9 bit for bit against its exact plain version (quantized as
    `MoEMLP.quantize_params` does), twice, each launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(e + m + k + n)
    a_q, sa = quantize_sym(_randn(gen, torch.float32, cuda, e, m, k), 2)
    b_q, sb = quantize_sym(_randn(gen, torch.float32, cuda, e, k, n), 1)
    before = grouped_matmul_w8a8.launches
    got = grouped_matmul_w8a8(a_q, b_q, sa, sb, out_dtype=out_dtype)
    again = grouped_matmul_w8a8(a_q, b_q, sa, sb, out_dtype=out_dtype)
    assert grouped_matmul_w8a8.launches == before + 2
    want = grouped_matmul_w8a8_reference(a_q, b_q, sa, sb,
                                         out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert torch.equal(got, again)
    # Group e alone through K7 (the same body): the same bits.
    g = e - 1
    assert torch.equal(matmul_w8a8(a_q[g].contiguous(), b_q[g].contiguous(),
                                   sa[g].contiguous(), sb[g].contiguous(),
                                   out_dtype=out_dtype), got[g])


def test_moe_kernels_reject_unsupported_inputs(cuda):
    a = torch.zeros(2, 16, 64, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(2, 64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 or both float32"):
        grouped_matmul(a, b.float())
    with pytest.raises(ValueError, match="bfloat16 or both float32"):
        grouped_matmul(a.half(), b.half())
    with pytest.raises(ValueError, match="contiguous"):
        grouped_matmul(a, b.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="bad shapes"):
        grouped_matmul(a, b[:1])
    with pytest.raises(ValueError, match="out dtype"):
        grouped_matmul(a, b, torch.float16)
    with pytest.raises(ValueError, match="bad shapes"):
        matmul(a[0], b)
    aq = torch.zeros(2, 16, 40, device=cuda, dtype=torch.int8)
    bq = torch.zeros(2, 40, 32, device=cuda, dtype=torch.int8)
    sa = torch.ones(2, 16, device=cuda)
    sb = torch.ones(2, 32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        grouped_matmul_w8a8(aq, bq, sa, sb)
    with pytest.raises(ValueError, match="scale_b"):
        grouped_matmul_w8a8(aq[:, :, :32].contiguous(),
                            bq[:, :32].contiguous(), sa, sb[:, :16])
    with pytest.raises(ValueError, match="want a_shard"):
        ag_gemm(a[0], b[0], AllGatherGEMMContext("tp", 2, "fused"))


def _tiny_moe_pair(cuda, **kw):
    from triton_distributed_tpu_torch import ModelConfig, Qwen3

    cfg = ModelConfig.tiny_moe(dtype="float32", head_dim=64, **kw)
    cpu = Qwen3(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Qwen3(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    return cfg, cpu, gpu


def test_tiny_moe_engine_gpu_matches_cpu(cuda):
    """The MoE slice on the card (K1, K2, K8) against the CPU (plain
    versions), f32, greedy: same tokens, logits within 1e-3, and the exact
    launches of `Engine.serve`: per layer one K1 for the prefill, one K2 a
    decode step, two K8 for each of them."""
    from triton_distributed_tpu_torch import Engine

    cfg, cpu, gpu = _tiny_moe_pair(cuda)
    ids = torch.randint(0, cfg.vocab_size, (2, 24),
                        generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(
        gpu.prefill(ids.to(cuda), gpu.create_cache(2)).cpu(),
        cpu.prefill(ids, cpu.create_cache(2)), atol=1e-3, rtol=1e-3)
    gen, nl = 6, cfg.num_layers
    before = (flash_attention.launches, flash_decode.launches,
              grouped_matmul.launches, matmul.launches)
    got = Engine(gpu).serve(ids.to(cuda), gen).cpu()
    after = (flash_attention.launches, flash_decode.launches,
             grouped_matmul.launches, matmul.launches)
    assert [x - y for x, y in zip(after, before)] == [
        nl, nl * (gen - 1), 2 * nl * gen, 0]
    assert torch.equal(got, Engine(cpu).serve(ids, gen))


def test_tiny_moe_scheduler_gpu_matches_cpu(cuda):
    """The scheduler over the tiny f32 MoE model on the card and on the
    CPU, both layouts, greedy: same tokens everywhere."""
    from triton_distributed_tpu_torch import (
        ContinuousBatchingScheduler, Request, SchedulerConfig)

    cfg, cpu, gpu = _tiny_moe_pair(cuda)
    gen = torch.Generator().manual_seed(2)
    prefix = torch.randint(1, cfg.vocab_size, (16,), generator=gen).tolist()
    prompts = [prefix + torch.randint(1, cfg.vocab_size, (n,),
                                      generator=gen).tolist()
               for n in (3, 9, 20)]
    outs = []
    for model in (cpu, gpu):
        for layout in ("slots", "paged"):
            sched = ContinuousBatchingScheduler(model, SchedulerConfig(
                num_slots=2, max_seq=64, prefill_buckets=(16, 32, 64),
                page_size=8, kv_layout=layout))
            done = sched.run([Request(prompt=p, max_new_tokens=6)
                              for p in prompts])
            outs.append([r.generated for r in
                         sorted(done, key=lambda r: r.request_id)])
    assert all(o == outs[0] for o in outs)


def test_tiny_moe_grads_gpu_match_cpu(cuda):
    """Gradients of every leaf of a tiny f32 MoE model (router, experts,
    attention) on the card (K1, K4, K5, K8 forward, torch.bmm backward)
    against the CPU's, within 1e-4 relative L2."""
    import torch.nn.functional as F

    cfg, cpu, gpu = _tiny_moe_pair(cuda)
    ids = torch.randint(0, cfg.vocab_size, (2, 40),
                        generator=torch.Generator().manual_seed(1))
    targets = torch.tensor([3, 200])
    before = grouped_matmul.launches
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        model.requires_grad_(True)
        F.cross_entropy(model(ids.to(dev)), targets.to(dev)).backward()
    assert grouped_matmul.launches == before + 2 * cfg.num_layers
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        rel = float((pg.grad.cpu() - pc.grad).norm() / pc.grad.norm())
        assert rel <= 1e-4, f"{name}: rel_l2 {rel:.3e}"


def test_moe_layer_w8a8_gpu_matches_cpu(cuda):
    """`MoEMLP` in xla and in w8a8 mode (dequantized onto K8 at world 1)
    on the card against the CPU, f32, two K8 launches a call."""
    from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP

    def pair(mode):
        return [MoEMLP(128, 64, 8, topk=2, mode=mode, dtype=torch.float32,
                       device=dev) for dev in ("cpu", cuda)]

    f_cpu, f_gpu = pair("xla")
    f_cpu.init_params(torch.Generator().manual_seed(5))
    f_gpu.load_state_dict(f_cpu.state_dict())
    q_cpu, q_gpu = pair("w8a8")
    qparams = MoEMLP.quantize_params(f_cpu.params())
    q_cpu.load_state_dict(qparams)
    q_gpu.load_state_dict(qparams)
    x = torch.randn(40, 128, generator=torch.Generator().manual_seed(6))
    before = grouped_matmul.launches
    with torch.inference_mode():
        for cpu_layer, gpu_layer in ((f_cpu, f_gpu), (q_cpu, q_gpu)):
            torch.testing.assert_close(gpu_layer(x.to(cuda)).cpu(),
                                       cpu_layer(x), atol=1e-4, rtol=1e-4)
    assert grouped_matmul.launches == before + 4


# ---- tensor parallelism at world W: K12, K14 ------------------------------

#: (world, m, k, n): Qwen3-8B's QKV at a 64-row shard (the 128-row tile,
#: the ring), a decode row a rank (16-row padding, the 64-row tile in ll),
#: ragged rows at world 2, world 8, and k and n off 16-byte rows at an odd
#: world (loads and copies by element).
TP_SHAPES = [(4, 64, 256, 384), (4, 1, 512, 256), (2, 37, 136, 200),
             (8, 16, 128, 96), (3, 5, 100, 77)]
#: K12 alone, beside TP_SHAPES: Qwen3-8B's decode QKV slice at one row a
#: rank (ll on the narrow 64 x 64 tile, 24 of the rank's 33 blocks), a
#: prefill of several
#: waves with m and n off the tile, and world 8 at 16 rows a rank with n =
#: 1536 (16 blocks a rank).
AG_SHAPES = TP_SHAPES + [(4, 1, 4096, 1536), (4, 200, 512, 1000),
                         (8, 16, 1024, 1536)]


@pytest.mark.parametrize("method", ["fused", "ll"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world,m,k,n", AG_SHAPES)
def test_ag_gemm_kernel(cuda, method, dtype, world, m, k, n):
    """K12 against its plain version, row by row, over 5 back-to-back calls
    with fresh inputs (stale signals would show); the gathered A exactly;
    one launch a call, on the Hopper body exactly when the operands are
    bf16 on 16-byte rows (f32 and the off-16-byte case keep the first
    bodies)."""
    gen = torch.Generator(device=cuda).manual_seed(world * 1000 + m + k + n)
    ctx = AllGatherGEMMContext("tp", world, method)
    before = (ag_gemm.launches, ag_gemm.wgmma_launches)
    for _ in range(5):
        a = _randn(gen, dtype, cuda, world, m, k)
        b = _randn(gen, dtype, cuda, world, k, n) * k ** -0.5
        out, gathered = ag_gemm(a, b, ctx, return_gathered=True)
        ref = ag_gemm_plain(a.float(), b.float())
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (world, world * m, n)
        assert torch.equal(gathered, a.reshape(1, world * m, k).expand(
            world, -1, -1))
        _assert_rows_close("ag_gemm", out, ref, *GEMM_TOL[dtype])
    wgmma = dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
    assert (ag_gemm.launches - before[0],
            ag_gemm.wgmma_launches - before[1]) == (5, 5 if wgmma else 0)


@pytest.mark.parametrize("world,k,n", [(4, 4096, 1536), (4, 4096, 6144),
                                       (8, 1024, 1536)])
def test_ag_gemm_decode_row_alone(cuda, world, k, n):
    """The decode form (ll at one row a rank, on the narrow tile where the
    wide one leaves blocks idle) is deterministic and a row's result
    depends on its own row only: rank 0's row gives the same bits whatever
    the other ranks' rows hold."""
    gen = torch.Generator(device=cuda).manual_seed(world + k + n)
    ctx = AllGatherGEMMContext("tp", world, "ll")
    a = _randn(gen, torch.bfloat16, cuda, world, 1, k)
    b = _randn(gen, torch.bfloat16, cuda, world, k, n) * k ** -0.5
    out = ag_gemm(a, b, ctx)
    again = ag_gemm(a, b, ctx)
    other = a.clone()
    other[1:] = _randn(gen, torch.bfloat16, cuda, world - 1, 1, k)
    moved = ag_gemm(other, b, ctx)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out[:, 0], moved[:, 0])


@pytest.mark.parametrize("world,k,n", [(4, 4096, 1536), (4, 512, 1000),
                                       (2, 1024, 4096), (4, 4096, 6144)])
def test_ag_gemm_row_independent_of_batch_and_method(cuda, world, k, n):
    """On the Hopper body a row's bits do not depend on how many rows the
    call holds or on the method: every rank's first row alone (the narrow
    decode tile, or the wide one for gate_up's 6144 columns), inside 16
    rows a rank (the 64-row tile), 17 (the 128-row tile at world 4) and
    200 (several waves), in ``ll`` and ``fused``, gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(world * 7 + k + n)
    a = _randn(gen, torch.bfloat16, cuda, world, 200, k)
    b = _randn(gen, torch.bfloat16, cuda, world, k, n) * k ** -0.5
    first = None
    for rows in (1, 16, 17, 200):
        for method in ("ll", "fused"):
            wg0 = ag_gemm.wgmma_launches
            out = ag_gemm(a[:, :rows].contiguous(), b,
                          AllGatherGEMMContext("tp", world, method))
            assert ag_gemm.wgmma_launches == wg0 + 1
            row = out.reshape(world, world, rows, n)[:, :, 0]
            if first is None:
                first = row
            assert torch.equal(row, first), (rows, method)


#: K14 alone, beside TP_SHAPES: Qwen3-8B's decode O and down slices at
#: one row a chunk (ll on the 64 x 256 tile at world 4), 17 rows a chunk
#: at world 4 with n off the tile (the 128-row tile in ll, the 64-row one
#: in fused) and 600 rows a chunk (several waves of the 128-row tile).
RS_SHAPES = TP_SHAPES + [(4, 1, 1024, 4096), (4, 1, 3072, 4096),
                         (4, 17, 512, 1000), (4, 600, 256, 512)]


@pytest.mark.parametrize("method", ["fused", "ll"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world,m,k,n", RS_SHAPES)
def test_gemm_rs_kernel(cuda, method, dtype, world, m, k, n):
    """K14 against its plain version (f32 partials, summed in f32), row by
    row, over 5 back-to-back calls with fresh inputs; one launch a call, on
    the Hopper body exactly when the operands are bf16 on 16-byte rows.
    ``m`` rows a chunk."""
    gen = torch.Generator(device=cuda).manual_seed(world * 1000 + m + k + n)
    ctx = GEMMReduceScatterContext("tp", world, method)
    before = (gemm_rs.launches, gemm_rs.wgmma_launches)
    for _ in range(5):
        a = _randn(gen, dtype, cuda, world, world * m, k)
        b = _randn(gen, dtype, cuda, world, k, n) * (world * k) ** -0.5
        out = gemm_rs(a, b, ctx)
        ref = gemm_rs_plain(a.float(), b.float())
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (world, m, n)
        _assert_rows_close("gemm_rs", out, ref, *GEMM_TOL[dtype])
    wgmma = dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
    assert (gemm_rs.launches - before[0],
            gemm_rs.wgmma_launches - before[1]) == (5, 5 if wgmma else 0)


@pytest.mark.parametrize("world,k,n", [(4, 1024, 4096), (4, 3072, 4096),
                                       (2, 512, 1000), (8, 256, 1536)])
def test_gemm_rs_row_independent_of_batch_and_method(cuda, world, k, n):
    """On the Hopper body a chunk row's bits do not depend on how many rows
    the call holds, the tile width or the method: the partials are the
    same bits whatever tile computed them, and their sum is the plain
    version's bf16 rounding and rank-order f32 sum.  Every chunk's first
    row alone (ll on the 64-row tile), inside 16 rows a chunk (the 64-row
    tile), 17 (the 128-row one in ll) and 200, in ``ll`` and ``fused``,
    gives the same bits, and every call is within the bf16 bound of the
    plain version row by row."""
    gen = torch.Generator(device=cuda).manual_seed(world * 11 + k + n)
    a = _randn(gen, torch.bfloat16, cuda, world, world, 200, k)
    b = _randn(gen, torch.bfloat16, cuda, world, k, n) * (world * k) ** -0.5
    first = None
    for rows in (1, 16, 17, 200):
        x = a[:, :, :rows].reshape(world, world * rows, k).contiguous()
        for method in ("ll", "fused"):
            wg0 = gemm_rs.wgmma_launches
            out = gemm_rs(x, b, GEMMReduceScatterContext("tp", world, method))
            assert gemm_rs.wgmma_launches == wg0 + 1
            _assert_rows_close("gemm_rs", out,
                               gemm_rs_plain(x.float(), b.float()),
                               *GEMM_TOL[torch.bfloat16])
            row = out[:, 0]
            if first is None:
                first = row
            assert torch.equal(row, first), (rows, method)


@pytest.mark.parametrize("n", [4096, 2048])
def test_gemm_rs_decode_ll_equals_fused(cuda, n):
    """The decode form gives the bits of ``fused`` and the rounding and
    the rank order of the plain version: the decode O slice at one row a
    chunk at world 4, Qwen3-8B's (n 4096) and Qwen3-30B-A3B's (n 2048)."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    a = _randn(gen, torch.bfloat16, cuda, 4, 4, 1024)
    b = _randn(gen, torch.bfloat16, cuda, 4, 1024, n) * 4096 ** -0.5
    want = gemm_rs(a, b, GEMMReduceScatterContext("tp", 4, "fused"))
    got = gemm_rs(a, b, GEMMReduceScatterContext("tp", 4, "ll"))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _assert_rows_close("gemm_rs", got, gemm_rs_plain(a.float(), b.float()),
                       *GEMM_TOL[torch.bfloat16])


def test_tp_kernels_reject_unsupported_inputs(cuda):
    a = torch.zeros(4, 16, 64, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(4, 64, 32, device=cuda, dtype=torch.bfloat16)
    ag, rs = (AllGatherGEMMContext("tp", 4, "fused"),
              GEMMReduceScatterContext("tp", 4, "fused"))
    with pytest.raises(ValueError, match="bfloat16 or both float32"):
        ag_gemm(a, b.float(), ag)
    with pytest.raises(ValueError, match="contiguous"):
        gemm_rs(a, b.transpose(1, 2).contiguous().transpose(1, 2), rs)
    with pytest.raises(ValueError, match="W | M"):
        gemm_rs(a[:, :15], b, rs)
    with pytest.raises(ValueError, match="want a_shard"):
        ag_gemm(a[:2], b, ag)


def test_tiny_tp_model_gpu_matches_cpu(cuda):
    """A tiny f32 Qwen3 at world 4 in mode fused: the card (K12, K14, K1,
    K2) against the CPU (plain versions): prefill logits within 1e-3, then
    `Engine.serve` with the same greedy tokens and the exact launches: per
    layer and forward two K12 and two K14, ll in decode."""
    from triton_distributed_tpu_torch import Engine, ModelConfig, Qwen3
    from triton_distributed_tpu_torch.parallel import make_mesh

    cfg = ModelConfig.tiny(dtype="float32", head_dim=64)
    cpu = Qwen3(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)).reshard(4)
    gpu = Qwen3(cfg, mesh=make_mesh(4, device=cuda))
    gpu.load_state_dict(cpu.state_dict())
    # 96 rows a rank: 384 gathered rows take the ring ("fused") in
    # prefill; a decode row a rank takes "ll".
    ids = torch.randint(0, cfg.vocab_size, (4, 96),
                        generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(
        gpu.prefill(ids.to(cuda), gpu.create_cache(4)).cpu(),
        cpu.prefill(ids, cpu.create_cache(4)), atol=1e-3, rtol=1e-3)
    gen, nl = 6, cfg.num_layers
    counters = (ag_gemm, gemm_rs)
    before = [c.launches for c in counters] + [c.ll_launches
                                                for c in counters]
    got = Engine(gpu).serve(ids.to(cuda), gen).cpu()
    after = [c.launches for c in counters] + [c.ll_launches
                                               for c in counters]
    assert [x - y for x, y in zip(after, before)] == [
        2 * nl * gen, 2 * nl * gen, 2 * nl * (gen - 1), 2 * nl * (gen - 1)]
    assert torch.equal(got, Engine(cpu).serve(ids, gen))


# ---- the collective library at world W: K15, K16, K17, K18 ---------------

#: (world, rows a rank, columns): rows off the row tile and columns off 8
#: (copies and sums by element), a row count that splits over the ranks
#: and one that does not (two-shot and the ring fall back to one-shot),
#: world 1 (one-shot is a copy, the chain returns x).
COLL_SHAPES = [(2, 37, 100), (4, 64, 128), (4, 6, 77), (8, 16, 64),
               (8, 13, 40), (3, 9, 96), (1, 5, 24)]
COLL_METHODS = {
    "all_gather": ("ring", "push_all", "bidir_ring"),
    "reduce_scatter": ("scatter_reduce", "ring"),
    "all_reduce": ("one_shot", "two_shot", "ring", "chain"),
}


def _collective(op, method, world, x, **faults):
    """Run ``op`` by ``method`` on x and its plain version; the plain one
    in the method the kernel path resolves to (fallbacks included)."""
    from triton_distributed_tpu_torch.kernels import allgather as ag
    from triton_distributed_tpu_torch.kernels import allreduce as ar
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs

    if op == "all_gather":
        ctx = ag.AllGatherContext("tp", world, method, **faults)
        return ag.all_gather(x, ctx), ag.all_gather_reference(x)
    if op == "reduce_scatter":
        ctx = rs.ReduceScatterContext("tp", world, method, **faults)
        plain = method if world > 1 else "scatter_reduce"
        return (rs.reduce_scatter(x, ctx),
                rs.reduce_scatter_reference(x, plain))
    ctx = ar.AllReduceContext("tp", world, method, **faults)
    return ar.all_reduce(x, ctx), ar.all_reduce_reference(
        x, ar.resolve(x, ctx))


def _cases():
    for op, methods in COLL_METHODS.items():
        for method in methods:
            for world, m, n in COLL_SHAPES:
                if op == "reduce_scatter" and method == "ring" and world < 2:
                    continue
                yield op, method, world, m, n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("op,method,world,m,n", list(_cases()))
def test_collective_kernel_bit_exact(cuda, op, method, dtype, world, m, n):
    """Each K15-K17 method against its plain version, bit for bit (copies,
    and f32 sums in the method's fixed order and rounding), over 5
    back-to-back calls with fresh inputs, queued before any check (a stale
    signal would let a call read the last call's data)."""
    gen = torch.Generator(device=cuda).manual_seed(world * 100 + m + n)
    rows = world * m if op == "reduce_scatter" else m
    ins = [_randn(gen, dtype, cuda, world, rows, n) for _ in range(5)]
    runs = [_collective(op, method, world, x) for x in ins]
    torch.cuda.synchronize()
    for got, want in runs:
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want), (op, method, world, m, n)


@pytest.mark.parametrize("op,method", [
    (op, method) for op, ms in COLL_METHODS.items() for method in ms])
def test_collective_kernel_under_faults(cuda, op, method):
    """A straggler rank (about 1 ms of cycles) and for_correctness's
    staggered start leave every method's result bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    world, m, n = 4, 32, 64
    rows = world * m if op == "reduce_scatter" else m
    for faults in ({"straggler": (1, 2_000_000)},
                   {"for_correctness": True}):
        x = _randn(gen, torch.bfloat16, cuda, world, rows, n)
        got, want = _collective(op, method, world, x, **faults)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (op, method, faults)


def test_collective_launch_counts(cuda):
    """One launch of the op's own kernel a call, counted by method; the
    ring all-reduce launches K16 and K15 and no K17; the chain at world 1
    launches nothing."""
    from triton_distributed_tpu_torch.kernels.allgather import all_gather
    from triton_distributed_tpu_torch.kernels.allreduce import all_reduce
    from triton_distributed_tpu_torch.kernels.reduce_scatter import (
        reduce_scatter)

    x = torch.ones(4, 8, 32, device=cuda)
    counts = lambda: (all_gather.launches, reduce_scatter.launches,  # noqa
                      all_reduce.launches)
    before = counts()
    for method in COLL_METHODS["all_reduce"]:
        _collective("all_reduce", method, 4, x)
    _collective("all_reduce", "chain", 1, x[:1])
    _collective("all_gather", "push_all", 4, x)
    _collective("reduce_scatter", "ring", 4, x)
    got = tuple(a - b for a, b in zip(counts(), before))
    assert got == (2, 2, 3), got
    assert all_reduce.method_launches["two_shot"] >= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_barrier_and_broadcast_kernels(cuda, dtype, world):
    """K18: the barrier returns x, and the broadcast every rank's copy of
    the root's x, for every root (an int or a 0-d device tensor), bit for
    bit; one launch each, counted in ``common_ops.launches`` and by
    kernel."""
    from triton_distributed_tpu_torch.kernels import common_ops

    gen = torch.Generator(device=cuda).manual_seed(world)
    before = common_ops.launches
    by_kernel = dict(common_ops.method_launches)
    runs = []
    for root in range(world):
        x = _randn(gen, dtype, cuda, world, 7, 33)
        r = torch.tensor(root, device=cuda) if root % 2 else root
        runs.append((common_ops.broadcast(x, r, "tp", world),
                     common_ops.broadcast_reference(x, root)))
        runs.append((common_ops.barrier_all_on_axis(
            x, straggler=(root, 100_000)), x.clone()))
    torch.cuda.synchronize()
    for got, want in runs:
        assert torch.equal(got, want)
    assert common_ops.launches == before + 2 * world
    for fn in ("barrier_all_on_axis", "broadcast"):
        assert common_ops.method_launches[fn] == by_kernel.get(fn, 0) + world


#: K18 and K17 ``two_shot`` over alternating payloads: (small, large) rows
#: x columns a rank, aligned (16-byte rows: bulk copies) and ragged (rows
#: and columns off every unit: thread copies); the rows a multiple of W for
#: two-shot, which otherwise falls back to one-shot.
REDESIGNED_SHAPES = {"aligned": lambda w: ((w * 4, 64), (w * 256, 1024)),
                     "ragged": lambda w: ((w * 3, 77), (w * 37, 1001))}


@pytest.mark.parametrize("shape", list(REDESIGNED_SHAPES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("op", ["broadcast", "barrier", "two_shot"])
def test_redesigned_collectives_back_to_back(cuda, op, world, dtype, shape):
    """100 back-to-back calls of K18's broadcast or barrier or K17
    ``two_shot`` on one instance, alternating a small payload (few blocks a
    rank) and a large one (many), so P changes from call to call; the
    broadcast's root cycling through every rank, as an int and as a 0-d
    device tensor; a straggler rank in every 10th call and for_correctness
    in every 7th; all queued before any check.  Each result equals its
    plain version bit for bit; one launch a call, counted by kernel."""
    from triton_distributed_tpu_torch.kernels import allreduce as ar
    from triton_distributed_tpu_torch.kernels import common_ops

    gen = torch.Generator(device=cuda).manual_seed(world * 10 + len(shape))
    sizes = REDESIGNED_SHAPES[shape](world)
    ins = [_randn(gen, dtype, cuda, world, *sizes[i % 2]) for i in range(100)]
    counts = lambda: (common_ops.launches,  # noqa: E731
                      ar.all_reduce.method_launches["two_shot"])
    before = counts()
    runs = []
    for i, x in enumerate(ins):
        faults = ({"straggler": ((i // 10) % world, 200_000)} if i % 10 == 0
                  else {"for_correctness": True} if i % 7 == 0 else {})
        if op == "broadcast":
            root = i % world
            r = torch.tensor(root, device=cuda) if i % 2 else root
            runs.append((common_ops.broadcast(x, r, "tp", world, **faults),
                         lambda x=x, root=root:
                         common_ops.broadcast_reference(x, root)))
        elif op == "barrier":
            runs.append((common_ops.barrier_all_on_axis(x, **faults),
                         lambda x=x: x.clone()))
        else:
            ctx = ar.AllReduceContext("tp", world, "two_shot", **faults)
            assert ar.resolve(x, ctx) == ar.AllReduceMethod.TWO_SHOT
            runs.append((ar.all_reduce(x, ctx), lambda x=x:
                         ar.all_reduce_reference(x, "two_shot")))
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(counts(), before))
    assert got == ((0, 100) if op == "two_shot" else (100, 0)), got
    for i, (out, plain) in enumerate(runs):
        want = plain()
        assert out.dtype == dtype and out.shape == want.shape
        assert torch.equal(out, want), (op, world, shape, i)


def test_sp_flash_decode_kernels(cuda):
    """SP decode at world 4 (one K2, K2q or K3 launch over every rank's
    shard, then one K15) against world-1 decode over the whole cache, on
    ragged totals that leave shards empty, dense, int8 and paged."""
    from triton_distributed_tpu_torch.kernels.allgather import all_gather
    from triton_distributed_tpu_torch.kernels.flash_decode import (
        sp_flash_decode, sp_flash_decode_paged)

    gen = torch.Generator(device=cuda).manual_seed(3)
    world, b, h, hkv, d, s_loc, ps = 4, 4, 8, 2, 128, 64, 16
    q = _randn(gen, torch.bfloat16, cuda, b, h, d)
    k = _randn(gen, torch.bfloat16, cuda, b, hkv, world * s_loc, d)
    v = _randn(gen, torch.bfloat16, cuda, b, hkv, world * s_loc, d)
    total = torch.tensor([1, 65, 128, 256], dtype=torch.int32, device=cuda)
    ranks = torch.arange(world, device=cuda)[:, None]
    local = (total[None] - ranks * s_loc).clamp(0, s_loc).to(torch.int32)
    shard = lambda t: t.reshape(b, hkv, world, s_loc, d).permute(  # noqa
        2, 0, 1, 3, 4).contiguous()
    want, _ = flash_decode(q, k, v, total)
    kq, vq, ks, vs = quantize_kv(k, v)
    want_q, _ = flash_decode(q, kq, vq, total, k_scale=ks, v_scale=vs)
    before = (flash_decode.launches, flash_decode.int8_launches,
              flash_decode_paged.launches, all_gather.launches)
    got = sp_flash_decode(q, shard(k), shard(v), local.contiguous())
    sscale = lambda t: t.reshape(b, hkv, world, s_loc).permute(  # noqa
        2, 0, 1, 3).contiguous()
    got_q = sp_flash_decode(q, shard(kq), shard(vq), local.contiguous(),
                            k_scale=sscale(ks), v_scale=sscale(vs))
    # Paged: each rank's shard in its own pool of pages of 16, shuffled.
    t = s_loc // ps
    perm = 1 + torch.randperm(b * t, generator=torch.Generator().manual_seed(
        4)).to(cuda)
    table = perm.reshape(b, t).to(torch.int32)
    pools = []
    for src in (shard(k), shard(v)):
        pool = torch.zeros(world, 1 + b * t, hkv, ps, d, device=cuda,
                           dtype=torch.bfloat16)
        blocks = src.reshape(world, b, hkv, t, ps, d).transpose(2, 3)
        pool[:, table.reshape(-1).long()] = blocks.reshape(
            world, b * t, hkv, ps, d)
        pools.append(pool)
    tables = table.expand(world, b, t).contiguous()
    got_p = sp_flash_decode_paged(q, pools[0], pools[1], tables,
                                  local.contiguous())
    torch.cuda.synchronize()
    after = (flash_decode.launches, flash_decode.int8_launches,
             flash_decode_paged.launches, all_gather.launches)
    assert tuple(a - b_ for a, b_ in zip(after, before)) == (1, 1, 1, 3)
    for g, w in ((got, want), (got_q, want_q), (got_p, want)):
        assert g.shape == (world, b, h, d)
        for r in range(world):
            torch.testing.assert_close(g[r].float(), w.float(),
                                       **OUT_TOL[torch.bfloat16])
        assert torch.equal(g, g[:1].expand_as(g))


def test_tp_mlp_fused_ar_kernel(cuda):
    """`TPMLP(mode="fused_ar")` at world 4 on the card: one K17 launch a
    call, every rank's copy equal, and the result against the layer on the
    CPU (plain versions) within 1e-4 in f32."""
    from triton_distributed_tpu_torch.kernels.allreduce import all_reduce
    from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP

    cpu = TPMLP(128, 512, mode="fused_ar", world_size=4,
                dtype=torch.float32, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = TPMLP(128, 512, mode="fused_ar", world_size=4,
                dtype=torch.float32, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    before = all_reduce.launches
    for m in (4, 64):
        x = torch.randn(m, 128, generator=torch.Generator().manual_seed(m))
        with torch.inference_mode():
            got = gpu(x.to(cuda))
            want = cpu(x)
        assert torch.equal(got, got[:1].expand_as(got))
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert all_reduce.launches == before + 2


# ---- MoE and int8 tensor parallelism at world W: K10, K11, K13 ------------

def _plan_case(case, world, mc, e, topk, cap, device):
    """Routing ids and weights (world * mc, topk) of a named case: random,
    two experts only (the rest empty), every pair to one expert, or
    experts filled to exact multiples of the pack block."""
    from triton_distributed_tpu_torch.kernels.moe_utils import pack_block

    gen = torch.Generator().manual_seed(world * 100 + mc + e + cap)
    n = world * mc
    if case == "random":
        ids = torch.stack([torch.randperm(e, generator=gen)[:topk]
                           for _ in range(n)])
    elif case == "empty":
        ids = torch.tensor([0, 2])[torch.randint(0, 2, (n, topk),
                                                 generator=gen)]
    elif case == "one":
        ids = torch.full((n, topk), e - 1)
    else:                                       # the block boundary
        ids = (torch.arange(n) // pack_block(cap) % e)[:, None].expand(
            n, topk)
    w = torch.softmax(torch.randn(n, topk, generator=gen), -1)
    return ids.to(torch.int32).to(device), w.to(device)


#: (world, experts, capacity, k, n, dtype): a decode-sized bucket at world
#: 2, 64-row buckets at world 4, f32 at world 8, ragged k and n on 16-byte
#: rows with 96-row buckets (two row boxes, the second cut at the
#: capacity), k and n off 16-byte rows (the first body, loads by element);
#: then the main path's shape (layer 0's world-4 Qwen3-30B-A3B prefill
#: buckets: 128 experts of cap 64, k 2048, n 384 a rank), world 8 (eight
#: chunks: two units an expert) and cap 128 (two row boxes a chunk).
AG_GROUP_CASES = [(2, 8, 16, 256, 384, torch.bfloat16),
                  (4, 8, 64, 128, 192, torch.bfloat16),
                  (8, 4, 32, 64, 64, torch.float32),
                  (4, 5, 96, 136, 200, torch.bfloat16),
                  (4, 5, 96, 60, 90, torch.bfloat16),
                  (4, 128, 64, 2048, 384, torch.bfloat16),
                  (8, 16, 64, 256, 384, torch.bfloat16),
                  (4, 8, 128, 512, 384, torch.bfloat16)]


def _ag_group_counts(gen, cuda, world, e, cap):
    """Routing counts (W, E) of the K11 cases: random, with one bucket
    empty and one full; from 4 experts on also an expert empty in every
    chunk, one live in one chunk only and one full everywhere; from 64 on
    skewed (most buckets a few tokens, as random weights route)."""
    counts = torch.randint(0, cap + 1, (world, e), generator=gen,
                           device=cuda)
    if e >= 64:
        counts = (torch.rand((world, e), generator=gen, device=cuda) ** 4
                  * (cap + 1)).long()
    counts[0, 0], counts[-1, -1] = 0, cap
    if e >= 4:
        counts[:, 1] = 0
        counts[:, 2] = 0
        counts[world // 2, 2] = 1
        counts[:, 3] = cap
    return counts


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("world,e,cap,k,n,dtype", AG_GROUP_CASES)
def test_ag_group_gemm_kernel(cuda, with_counts, world, e, cap, k, n,
                              dtype):
    """K11 against its plain version (f32 from the same inputs, zero in the
    row tiles past the counts), row by row, over 3 back-to-back calls with
    fresh inputs; rows past the counts hold garbage in the input and must
    come out zero; a rerun is bit-identical; one launch a call; bf16 on
    16-byte rows takes the Hopper body (``wgmma_launches``), whose live
    rows equal K8's on the same bucket and weights bit for bit (m64n128k16
    against m64n256k16: the tile promise)."""
    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        AGGroupGEMMContext, ag_group_gemm, ag_group_gemm_plain, kernel_body)
    from triton_distributed_tpu_torch.kernels.grouped_gemm import (
        row_tile, zero_past_counts)

    gen = torch.Generator(device=cuda).manual_seed(world * 100 + cap + n)
    ctx = AGGroupGEMMContext("tp", world, e)
    before = (ag_group_gemm.launches, ag_group_gemm.wgmma_launches)
    for _ in range(3):
        a = _randn(gen, dtype, cuda, world, e, cap, k)
        b = _randn(gen, dtype, cuda, world, e, k, n) * k ** -0.5
        counts = (_ag_group_counts(gen, cuda, world, e, cap)
                  if with_counts else None)
        body = kernel_body(a, b)
        out = ag_group_gemm(a, b, ctx, counts=counts)
        ref = ag_group_gemm_plain(a.float(), b.float())
        if counts is not None:
            ref = zero_past_counts(ref, counts, row_tile(cap, dtype, body))
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (world, world, e, cap, n)
        _assert_rows_close("ag_group_gemm", out, ref, *GEMM_TOL[dtype])
    assert body == ("wgmma" if dtype == torch.bfloat16 and k % 8 == 0
                    and n % 8 == 0 else "mma" if dtype == torch.bfloat16
                    else "f32")
    if body == "wgmma":
        live = torch.ones((world, e, cap), dtype=torch.bool, device=cuda)
        if counts is not None:
            tile = row_tile(cap, dtype, body)
            live = (torch.arange(cap, device=cuda)
                    < (counts[..., None] + tile - 1) // tile * tile)
        for r in range(world):
            k8 = torch.stack([grouped_matmul(a[c], b[r])
                              for c in range(world)])
            assert torch.equal(out[r][live], k8[live]), r
    assert torch.equal(out, ag_group_gemm(a, b, ctx, counts=counts))
    assert (ag_group_gemm.launches - before[0],
            ag_group_gemm.wgmma_launches - before[1]) == (
        4, 4 if body == "wgmma" else 0)


def _k11_variant(tmp_path, name, line):
    """K11's library built from a copy of the sources with ``line``
    inserted at the start of the Hopper body's crew (`k11_crew`)."""
    import shutil

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import allgather_group_gemm

    src = tmp_path / name / "csrc"
    shutil.copytree(_build.CSRC, src)
    cu = src / "ag_group_gemm.cu"
    anchor = "  comm::crew_entry_barrier(t, p.sig, target, /*neighbors_only=*/true, c);\n"
    text = cu.read_text()
    assert text.count(anchor) == 1
    cu.write_text(text.replace(anchor, line + "\n" + anchor))
    path = _build.build(["ag_group_gemm"], csrc=src,
                        build_dir=tmp_path / name / "build")["ag_group_gemm"]
    return _build.load_path(path, allgather_group_gemm._SIGNATURES)


def test_ag_group_gemm_wgmma_under_faults(cuda, tmp_path, monkeypatch):
    """K11's Hopper body with its ring slowed: rank 1's crew spinning about
    1 ms of cycles before the ring, then every rank's crew staggered
    (`correctness_delay`), each a build of the sources with that line in
    the crew; bit for bit the plain build's outputs, over 2 calls each with
    skewed counts at world 4 and 8; then 50 back-to-back calls of the
    plain build on one instance, each equal to its own first run."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        AGGroupGEMMContext, ag_group_gemm)

    gen = torch.Generator(device=cuda).manual_seed(43)
    cases = []
    for world, e, cap in ((4, 32, 64), (8, 16, 96)):
        ctx = AGGroupGEMMContext("tp", world, e)
        for _ in range(2):
            a = _randn(gen, torch.bfloat16, cuda, world, e, cap, 256)
            b = _randn(gen, torch.bfloat16, cuda, world, e, 256, 384) / 16
            counts = _ag_group_counts(gen, cuda, world, e, cap)
            cases.append((a, b, counts, ctx,
                          ag_group_gemm(a, b, ctx, counts=counts)))
    torch.cuda.synchronize()
    faults = {"straggler": "  comm::inject_faults(t, comm::Faults{1, "
                           "2000000, 0});",
              "for_correctness": "  comm::inject_faults(t, comm::Faults{-1, "
                                 "0, 1});"}
    for name, line in faults.items():
        lib = _k11_variant(tmp_path, name, line)
        with monkeypatch.context() as m:
            m.setitem(_build._loaded, "ag_group_gemm", lib)
            wg0 = ag_group_gemm.wgmma_launches
            outs = [ag_group_gemm(a, b, ctx, counts=counts)
                    for a, b, counts, ctx, _ in cases]
            torch.cuda.synchronize()
            assert ag_group_gemm.wgmma_launches == wg0 + len(cases)
        for out, (*_, want) in zip(outs, cases):
            assert torch.equal(out, want), name
    a, b, counts, ctx, want = cases[0]
    outs = [ag_group_gemm(a, b, ctx, counts=counts) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(out, want) for out in outs)


#: (world, experts, capacity (a multiple of 32), k, n): world 8 (eight live
#: boxes an expert, two units), cap 160 (three row boxes, the last partly
#: past cap), k 64 (half a stage), k 208 (a stage and a part), n 100 (off
#: 16-byte rows) and 200 (a partial column tile).
AG_GROUP_W8A8_CASES = [(2, 8, 32, 256, 384), (4, 4, 64, 128, 96),
                       (8, 4, 32, 64, 64), (4, 3, 160, 64, 100),
                       (4, 4, 96, 208, 200)]


@pytest.mark.parametrize("layout", ["k_major", "kn"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world,e,cap,k,n", AG_GROUP_W8A8_CASES)
def test_ag_group_gemm_w8a8_kernel(cuda, out_dtype, world, e, cap, k, n,
                                   layout):
    """K11-int8 bit for bit against its plain version (the wrapper on CPU
    copies), with counts (a zero count, a full bucket), over 3 back-to-back
    calls; one launch a call, each on the int8 Hopper tile; weights read in
    place when stored K-major, through one counted copy a call when (k, n)
    contiguous."""
    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        AGGroupGEMMContext, ag_group_gemm_w8a8)

    gen = torch.Generator(device=cuda).manual_seed(world * 10 + cap + n)
    ctx = AGGroupGEMMContext("tp", world, e)
    before = (ag_group_gemm_w8a8.launches, ag_group_gemm_w8a8.wgmma_launches,
              ag_group_gemm_w8a8.transposes)
    for _ in range(3):
        a = _randn(gen, torch.bfloat16, cuda, world, e, cap, k)
        wq, ws = quantize_sym(_randn(gen, torch.float32, cuda, world, e, k,
                                     n), 2)
        if layout == "k_major":
            wq = wq.transpose(-1, -2).contiguous().transpose(-1, -2)
        counts = torch.randint(0, cap + 1, (world, e), generator=gen,
                               device=cuda)
        counts[0, 0], counts[-1, -1] = 0, cap
        out = ag_group_gemm_w8a8(a, wq, ws, ctx, counts=counts,
                                 out_dtype=out_dtype)
        ref = ag_group_gemm_w8a8(a.cpu(), wq.cpu(), ws.cpu(), ctx,
                                 counts=counts.cpu(), out_dtype=out_dtype)
        assert torch.equal(out.cpu(), ref)
    assert (ag_group_gemm_w8a8.launches, ag_group_gemm_w8a8.wgmma_launches,
            ag_group_gemm_w8a8.transposes) == (
                before[0] + 3, before[1] + 3,
                before[2] + 3 * (layout == "kn"))


#: (world, mc, experts, topk, capacity, k, n, dtype, routing case); bf16
#: on 16-byte rows takes the Hopper body: world 8 (eight live boxes an
#: expert, two units), cap 128 (two row boxes a bucket), k 96 (a stage and
#: a half), n 200 (a partial column tile), a chunk whose pairs were all
#: dropped; n 100 (off 16-byte rows) and f32 the first body.
MOE_RS_CASES = [
    (2, 32, 8, 2, 16, 128, 256, torch.bfloat16, "random"),
    (4, 64, 8, 2, 32, 64, 128, torch.bfloat16, "empty"),
    (4, 32, 4, 2, 64, 64, 96, torch.float32, "one"),
    (8, 16, 4, 1, 16, 32, 64, torch.float32, "boundary"),
    (4, 48, 6, 3, 32, 40, 100, torch.bfloat16, "random"),
    (8, 32, 4, 2, 64, 64, 128, torch.bfloat16, "random"),
    (4, 128, 4, 2, 128, 128, 256, torch.bfloat16, "one"),
    (4, 64, 8, 2, 64, 96, 256, torch.bfloat16, "random"),
    (2, 64, 8, 2, 64, 128, 200, torch.bfloat16, "boundary"),
    (4, 64, 8, 4, 64, 192, 256, torch.bfloat16, "dropped chunk"),
]


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


def _moe_rs_inputs(cuda, world, mc, e, topk, cap, k, n, dtype, case, gen):
    from triton_distributed_tpu_torch.kernels.moe_utils import plan_chunks

    dropped = case == "dropped chunk"
    ids, w = _plan_case("random" if dropped else case, world, mc, e, topk,
                        cap, cuda)
    plan = plan_chunks(ids, w, world, e, cap)
    if dropped:
        plan = _drop_chunk(plan, 1)
    a = _randn(gen, dtype, cuda, world, world, e, cap, k)
    b = _randn(gen, dtype, cuda, world, e, k, n) * (world * k) ** -0.5
    return plan, a, b


def _cpu_plan(plan):
    return type(plan)(*(t.cpu() for t in plan))


@pytest.mark.parametrize("world,mc,e,topk,cap,k,n,dtype,case", MOE_RS_CASES)
def test_moe_reduce_rs_fused_kernel(cuda, world, mc, e, topk, cap, k, n,
                                    dtype, case):
    """K10 against its plain version (the wrapper on CPU copies: tiles
    rounded to the activations' dtype, the combine in ascending expert
    order, partials rounded, the rank-order f32 sum) row by row, over 3
    back-to-back calls; a rerun is bit-identical; one launch a call, of
    the Hopper body (``wgmma_launches``) for bf16 on 16-byte rows only."""
    from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
        MoEReduceRSContext, kernel_body, moe_reduce_rs_fused)

    gen = torch.Generator(device=cuda).manual_seed(world * 10 + mc + n)
    ctx = MoEReduceRSContext("tp", world, e, topk)
    before = (moe_reduce_rs_fused.launches,
              moe_reduce_rs_fused.wgmma_launches)
    for _ in range(3):
        plan, a, b = _moe_rs_inputs(cuda, world, mc, e, topk, cap, k, n,
                                    dtype, case, gen)
        out = moe_reduce_rs_fused(a, b, plan, ctx)
        ref = moe_reduce_rs_fused(a.cpu(), b.cpu(), _cpu_plan(plan), ctx)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (world, mc, n)
        _assert_rows_close("moe_reduce_rs_fused", out.cpu(), ref.float(),
                           *GEMM_TOL[dtype])
    assert torch.equal(out, moe_reduce_rs_fused(a, b, plan, ctx))
    body = kernel_body(a, b)
    assert body == ("wgmma" if dtype == torch.bfloat16 and n % 8 == 0
                    else "mma" if dtype == torch.bfloat16 else "f32")
    assert (moe_reduce_rs_fused.launches - before[0],
            moe_reduce_rs_fused.wgmma_launches - before[1]) == (
        4, 4 if body == "wgmma" else 0)


@pytest.mark.parametrize("world,mc,e,topk,cap,k,n,dtype,case", [
    (4, 64, 8, 2, 32, 64, 128, torch.bfloat16, "random"),
    (2, 32, 4, 2, 64, 128, 256, torch.float32, "empty"),
    (8, 16, 4, 2, 32, 32, 64, torch.bfloat16, "one")])
def test_moe_reduce_rs_fused_w8a8_kernel(cuda, world, mc, e, topk, cap, k,
                                         n, dtype, case):
    """K10 with int8 weights against its plain version, row by row (the
    int8 products are exact and the epilogue the same, so only the
    roundings that follow could differ)."""
    from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
        MoEReduceRSContext, moe_reduce_rs_fused)

    gen = torch.Generator(device=cuda).manual_seed(world + mc + cap)
    ctx = MoEReduceRSContext("tp", world, e, topk)
    plan, a, b = _moe_rs_inputs(cuda, world, mc, e, topk, cap, k, n, dtype,
                                case, gen)
    full = b.float().permute(1, 0, 2, 3).reshape(e, world * k, n)
    bq, bs = quantize_sym(full, 1)                 # global (E, n) scales
    bq = bq.reshape(e, world, k, n).transpose(0, 1).contiguous()
    before = (moe_reduce_rs_fused.launches,
              moe_reduce_rs_fused.wgmma_launches)
    out = moe_reduce_rs_fused(a, bq, plan, ctx, weight_scales=bs)
    ref = moe_reduce_rs_fused(a.cpu(), bq.cpu(), _cpu_plan(plan), ctx,
                              weight_scales=bs.cpu())
    assert (moe_reduce_rs_fused.launches - before[0],
            moe_reduce_rs_fused.wgmma_launches - before[1]) == (1, 0)
    _assert_rows_close("moe_reduce_rs_fused int8", out.cpu(), ref.float(),
                       *GEMM_TOL[dtype])


def test_moe_reduce_rs_fused_back_to_back(cuda):
    """K10's Hopper body over 100 back-to-back calls on one instance,
    alternating two plans (random routing at cap 64; every pair to one
    expert at cap 128, two row boxes a bucket), queued before any check:
    each bit for bit the single call's output on the same operands."""
    from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
        MoEReduceRSContext, moe_reduce_rs_fused)

    gen = torch.Generator(device=cuda).manual_seed(77)
    world, e, topk = 4, 8, 2
    ctx = MoEReduceRSContext("tp", world, e, topk)
    sets = [_moe_rs_inputs(cuda, world, 64, e, topk, 64, 192, 256,
                           torch.bfloat16, "random", gen),
            _moe_rs_inputs(cuda, world, 128, e, topk, 128, 192, 256,
                           torch.bfloat16, "one", gen)]
    single = []
    for plan, a, b in sets:
        single.append(moe_reduce_rs_fused(a, b, plan, ctx))
        torch.cuda.synchronize()
    wg0 = moe_reduce_rs_fused.wgmma_launches
    outs = [moe_reduce_rs_fused(sets[i % 2][1], sets[i % 2][2],
                                sets[i % 2][0], ctx) for i in range(100)]
    torch.cuda.synchronize()
    assert moe_reduce_rs_fused.wgmma_launches == wg0 + 100
    assert all(torch.equal(out, single[i % 2]) for i, out in enumerate(outs))


#: (world, rows a rank, k, n): a prefill shard, a decode row a rank (32-row
#: padding), ragged rows and n at world 2, world 8.
AG_W8A8_CASES = [(4, 64, 256, 384), (4, 2, 512, 256), (2, 37, 128, 200),
                 (8, 16, 64, 96)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("world,m,k,n", AG_W8A8_CASES)
def test_ag_gemm_w8a8_kernel(cuda, dtype, world, m, k, n):
    """K13 bit for bit against its plain version (the wrapper on CPU
    copies) over 3 back-to-back calls; one launch a call."""
    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        ag_gemm_w8a8)

    gen = torch.Generator(device=cuda).manual_seed(world * 7 + m + n)
    ctx = AllGatherGEMMContext("tp", world)
    before = ag_gemm_w8a8.launches
    for _ in range(3):
        a = _randn(gen, dtype, cuda, world, m, k)
        bq, bs = quantize_sym(_randn(gen, torch.float32, cuda, world, k, n),
                              1)
        out = ag_gemm_w8a8(a, bq, bs, ctx)
        ref = ag_gemm_w8a8(a.cpu(), bq.cpu(), bs.cpu(), ctx)
        assert out.dtype == dtype and out.shape == (world, world * m, n)
        assert torch.equal(out.cpu(), ref)
    assert ag_gemm_w8a8.launches == before + 3


def test_tp_mlp_w8a8_kernel(cuda):
    """`TPMLP(mode="w8a8")` at world 4 on the card (K13, then K7 a rank)
    against the CPU (plain versions), row by row at the bf16 bound (the
    gated SiLU between the two products rounds on each device's own
    exp); one K13 and four K7 a call."""
    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        ag_gemm_w8a8)
    from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP

    layers = [TPMLP(256, 512, mode="w8a8", world_size=4, device=d)
              for d in ("cpu", cuda)]
    layers[0].init_params(torch.Generator().manual_seed(3))
    layers[1].load_state_dict(layers[0].state_dict())
    x = torch.randn(4, 24, 256, generator=torch.Generator().manual_seed(4)
                    ).to(torch.bfloat16)
    before = (ag_gemm_w8a8.launches, matmul_w8a8.launches)
    got = layers[1](x.to(cuda)).cpu()
    assert (ag_gemm_w8a8.launches, matmul_w8a8.launches) == (
        before[0] + 1, before[1] + 4)
    _assert_rows_close("TPMLP w8a8", got, layers[0](x).float(),
                       *GEMM_TOL[torch.bfloat16])


def test_moe_tp_kernels_reject_unsupported_inputs(cuda):
    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        ag_gemm_w8a8)
    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        AGGroupGEMMContext, ag_group_gemm, ag_group_gemm_w8a8)

    a = torch.zeros(4, 4, 16, 64, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(4, 4, 64, 32, device=cuda, dtype=torch.bfloat16)
    ctx = AGGroupGEMMContext("tp", 4, 4)
    with pytest.raises(ValueError, match="bfloat16 or both float32"):
        ag_group_gemm(a, b.float(), ctx)
    with pytest.raises(ValueError, match="want buckets"):
        ag_group_gemm(a[:2], b, ctx)
    with pytest.raises(ValueError, match="multiple of 32"):
        ag_group_gemm_w8a8(a, b.to(torch.int8), torch.ones(4, 4, 32,
                                                            device=cuda), ctx)
    with pytest.raises(ValueError, match="fused ring only"):
        ag_gemm_w8a8(a[0], b[0].to(torch.int8), torch.ones(4, 32,
                                                           device=cuda),
                     AllGatherGEMMContext("tp", 4, "ll"))


def test_tiny_moe_tp_model_gpu_matches_cpu(cuda):
    """A tiny f32 MoE Qwen3 at world 4 in mode fused: the card (K11, K10,
    K12, K14, K1, K2, K8) against the CPU (plain versions): prefill logits
    within 1e-3, then `Engine.serve` with the same greedy tokens and the
    exact launches: per layer one K11 and one K10 in the prefill (32 rows a
    rank), the decode row a rank on the xla path, two K8 a rank."""
    from triton_distributed_tpu_torch import Engine, ModelConfig, Qwen3
    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        ag_group_gemm)
    from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
        moe_reduce_rs_fused)
    from triton_distributed_tpu_torch.parallel import make_mesh

    cfg = ModelConfig.tiny_moe(dtype="float32", head_dim=64)
    cpu = Qwen3(cfg, mesh=make_mesh(4, device="cpu")).init_params(
        torch.Generator().manual_seed(0))
    gpu = Qwen3(cfg, mesh=make_mesh(4, device=cuda))
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (4, 32),
                        generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(
        gpu.prefill(ids.to(cuda), gpu.create_cache(4)).cpu(),
        cpu.prefill(ids, cpu.create_cache(4)), atol=1e-3, rtol=1e-3)
    gen, nl = 5, cfg.num_layers
    counters = (ag_group_gemm, moe_reduce_rs_fused, grouped_matmul)
    before = [c.launches for c in counters]
    got = Engine(gpu).serve(ids.to(cuda), gen).cpu()
    assert [c.launches - b for c, b in zip(counters, before)] == [
        nl, nl, 2 * 4 * nl * (gen - 1)]
    assert torch.equal(got, Engine(cpu).serve(ids, gen))


# ---- K19 (fast_all_to_all) and K20 (sp_ag_attention_fused) ------------------
# K19 copies bytes: held bit for bit against its plain version (the two
# rank axes swapped) in every dtype, on ragged blocks (rows and bytes off
# 16, f32 scale rows of one value) and aligned ones.  K20 is held row by row
# against its plain version (the TPU kernel's chunk-by-chunk schedule in
# f32): bf16 tol 2e-2 and rel_l2 1e-2 (P and the output rounded to bf16,
# the chunks folded in another order), f32 1e-4 and 1e-4; lse within 1e-3.

A2A_CASES = [(w, cap, hid) for w in (2, 4, 8)
             for cap, hid in ((37, 1001), (64, 256))]


def _a2a_payload(gen, device, world, cap, hidden, dtype, ns):
    send = (torch.randn(world, world, cap, hidden, generator=gen,
                        device=device) * 40).clamp(-127, 127).to(dtype)
    counts = torch.randint(0, cap + 1, (world, world, 1), generator=gen,
                           device=device, dtype=torch.int32)
    scales = (torch.randn(world, world, cap, ns, generator=gen,
                          device=device) if ns else None)
    return send, counts, scales


@pytest.mark.parametrize("ns", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("world,cap,hidden", A2A_CASES)
def test_all_to_all_kernel_bit_exact(cuda, world, cap, hidden, dtype, ns):
    """K19 over 5 back-to-back calls with fresh inputs, queued before any
    check, each bit for bit equal to the plain version; one launch a
    call."""
    from triton_distributed_tpu_torch.kernels import low_latency_all_to_all \
        as a2a

    gen = torch.Generator(device=cuda).manual_seed(world * 1000 + cap + ns)
    ctx = a2a.AllToAllContext("ep", world, cap, hidden)
    before = a2a.fast_all_to_all.launches
    ins = [_a2a_payload(gen, cuda, world, cap, hidden, dtype, ns)
           for _ in range(5)]
    outs = [a2a.fast_all_to_all(s, c, ctx, send_scales=sc)
            for s, c, sc in ins]
    torch.cuda.synchronize()
    assert a2a.fast_all_to_all.launches == before + 5
    for args, got in zip(ins, outs):
        want = a2a.fast_all_to_all_reference(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_all_to_all_kernel_under_faults(cuda):
    from triton_distributed_tpu_torch.kernels import low_latency_all_to_all \
        as a2a

    gen = torch.Generator(device=cuda).manual_seed(19)
    for faults in ({"straggler": (1, 2_000_000)}, {"for_correctness": True}):
        args = _a2a_payload(gen, cuda, 4, 64, 256, torch.bfloat16, 1)
        ctx = a2a.AllToAllContext("ep", 4, 64, 256, **faults)
        got = a2a.fast_all_to_all(args[0], args[1], ctx, send_scales=args[2])
        torch.cuda.synchronize()
        for g, w in zip(got, a2a.fast_all_to_all_reference(*args)):
            assert torch.equal(g, w), faults


def test_ep_layer_kernel_matches_plain(cuda):
    """`EPAll2AllLayer` on the card (two K19 launches a round trip) against
    the same layer on the CPU: routing tables and dispatch bit for bit, the
    combine of identity experts within one bf16 rounding (its f32 sum over
    the top-k may run in another order)."""
    from triton_distributed_tpu_torch.kernels import low_latency_all_to_all \
        as a2a
    from triton_distributed_tpu_torch.layers import EPAll2AllLayer

    ep, e, topk, n, cap, h = 4, 16, 4, 24, 20, 128
    g = torch.Generator().manual_seed(5)
    x = torch.randn(ep, n, h, generator=g).to(torch.bfloat16)
    ids = torch.randint(0, e, (ep, n, topk), generator=g)
    w = torch.softmax(torch.randn(ep, n, topk, generator=g), -1)
    layer = EPAll2AllLayer("ep", ep, e, topk, cap, h)
    cpu = layer.dispatch(x, ids)
    before = a2a.fast_all_to_all.launches
    dev = layer.dispatch(x.to(cuda), ids.to(cuda))
    out = layer.combine(dev[0], dev[2], dev[3], w.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert a2a.fast_all_to_all.launches == before + 2
    for c, d in zip(cpu[:3], dev[:3]):
        assert torch.equal(c, d.cpu())
    assert torch.equal(cpu[3][0].slot_of_pair, dev[3][0].slot_of_pair.cpu())
    want = layer.combine(cpu[0], cpu[2], cpu[3], w, ids)
    torch.testing.assert_close(out.cpu().float(), want.float(), atol=1e-6,
                               rtol=2.0 ** -7)


SP_K20_GPU_CASES = [
    (world, *case) for world in (2, 4, 8) for case in (
        (1, 8, 2, 256, 128, torch.bfloat16),    # GQA 4
        (2, 4, 4, 24, 128, torch.bfloat16),     # GQA 1, S_loc 24
        (1, 4, 1, 100, 64, torch.bfloat16),     # d 64, ragged tiles
        (1, 4, 2, 100, 64, torch.float32),
        (1, 2, 2, 130, 128, torch.float32),
        (1, 8, 2, 200, 128, torch.bfloat16),    # S_loc off the 128-row tile
        (1, 8, 1, 200, 64, torch.bfloat16))]    # d 64, GQA 8


def _sp_hold(out, lse, ref_o, ref_l, dtype):
    tol, rel = (2e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    _rows_close(out, ref_o, tol, rel, 0.1)
    torch.testing.assert_close(lse, ref_l, atol=1e-3, rtol=0)


def _rows_close(got, want, tol, rel_tol, floor):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    row = w.pow(2).mean(-1, keepdim=True).sqrt()
    lim = tol * (w.abs() + row + floor * w.pow(2).mean().sqrt())
    assert bool((err <= lim).all()), float((err / lim).max())
    assert float(err.norm() / w.norm()) <= rel_tol


@pytest.mark.parametrize("world,b,h,hkv,s_loc,d,dtype", SP_K20_GPU_CASES)
def test_sp_ag_attention_fused_kernel(cuda, world, b, h, hkv, s_loc, d,
                                      dtype):
    """K20 over 3 back-to-back calls with fresh inputs against its plain
    version, row by row; rank 0 (which attends only its own chunk) bit for
    bit equal to K1 on that chunk, since both run the tile body of
    `flash_body.cuh`."""
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp

    gen = torch.Generator(device=cuda).manual_seed(world + s_loc + d)
    before = sp.sp_ag_attention_fused.launches
    ins = [tuple(_randn(gen, dtype, cuda, world, b, n, s_loc, d)
                 for n in (h, hkv, hkv)) for _ in range(3)]
    outs = [sp.sp_ag_attention_fused(*args, return_lse=True)
            for args in ins]
    torch.cuda.synchronize()
    assert sp.sp_ag_attention_fused.launches == before + 3
    for (q, k, v), (out, lse) in zip(ins, outs):
        assert out.dtype == dtype and lse.shape == (world, b, h, s_loc)
        _sp_hold(out, lse, *sp.sp_ag_attention_fused_reference(q, k, v),
                 dtype)
        k1, k1_lse = flash_attention(q[0], k[0], v[0], return_lse=True)
        assert torch.equal(k1, out[0]) and torch.equal(k1_lse, lse[0])


def test_sp_ag_attention_fused_offsets_and_faults(cuda):
    """Caller offsets (chunks of the future partly visible, rows of rank 2
    that see nothing of their own chunk), a straggler rank and
    for_correctness."""
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp

    gen = torch.Generator(device=cuda).manual_seed(20)
    world, s_loc = 4, 96
    kw = dict(q_offset=[r * s_loc + 5 for r in range(world)],
              kv_base=[3, 0, 7, 1])
    for extra in ({}, {"straggler": (1, 2_000_000)},
                  {"for_correctness": True}):
        q, k, v = (_randn(gen, torch.bfloat16, cuda, world, 1, n, s_loc, 128)
                   for n in (8, 2, 2))
        out, lse = sp.sp_ag_attention_fused(q, k, v, return_lse=True, **kw,
                                            **extra)
        torch.cuda.synchronize()
        _sp_hold(out, lse, *sp.sp_ag_attention_fused_reference(q, k, v,
                                                               **kw),
                 torch.bfloat16)


def test_sp_ag_attention_fused_back_to_back(cuda):
    """100 back-to-back K20 calls with fresh inputs, queued before any
    check, each against its plain version."""
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp

    gen = torch.Generator(device=cuda).manual_seed(21)
    before = sp.sp_ag_attention_fused.launches
    runs = []
    for _ in range(100):
        args = tuple(_randn(gen, torch.bfloat16, cuda, 4, 1, n, 200, 128)
                     for n in (8, 2, 2))
        runs.append((args, sp.sp_ag_attention_fused(*args,
                                                    return_lse=True)))
    torch.cuda.synchronize()
    assert sp.sp_ag_attention_fused.launches == before + 100
    for args, (out, lse) in runs:
        _sp_hold(out, lse, *sp.sp_ag_attention_fused_reference(*args),
                 torch.bfloat16)


def test_sp_compositions_kernels(cuda):
    """The ring, zigzag and gather compositions and K20 at world 4 against
    world-1 K1 over the whole sequence, row by row, with their launch
    counts: W, 3 W and W K1 launches (the gather also one K15), one K20."""
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp
    from triton_distributed_tpu_torch.kernels.allgather import all_gather

    gen = torch.Generator(device=cuda).manual_seed(21)
    world, s = 4, 1024
    qg, kg, vg = (_randn(gen, torch.bfloat16, cuda, 1, n, s, 128)
                  for n in (8, 2, 2))

    def shards(t):
        return t.reshape(1, t.shape[1], world, -1, 128).movedim(
            2, 0).contiguous()

    def unshard(t):
        return t.movedim(0, 2).reshape(1, t.shape[2], s, 128)

    ref = flash_attention(qg, kg, vg)
    q, k, v = shards(qg), shards(kg), shards(vg)
    zs = [shards(sp.zigzag_shard(t, world)) for t in (qg, kg, vg)]
    runs = {"fused": (lambda: sp.sp_ag_attention_fused(q, k, v), 0, 1, 0),
            "ring": (lambda: sp.sp_ring_attention(q, k, v), world, 0, 0),
            "gather": (lambda: sp.sp_ag_attention_gather(q, k, v), world, 0,
                       1),
            "zigzag": (lambda: sp.sp_ring_attention_zigzag(*zs), 3 * world,
                       0, 0)}
    for name, (fn, n_k1, n_k20, n_k15) in runs.items():
        before = (flash_attention.launches, sp.sp_ag_attention_fused.launches,
                  all_gather.launches)
        out = fn()
        torch.cuda.synchronize()
        assert (flash_attention.launches - before[0],
                sp.sp_ag_attention_fused.launches - before[1],
                all_gather.launches - before[2]) == (n_k1, n_k20, n_k15), name
        out = unshard(out)
        if name == "zigzag":
            out = sp.zigzag_unshard(out, world)
        _rows_close(out, ref, 5e-2, 1e-2, 0.1)


def test_sp_ring_attention_diff_kernels(cuda):
    """Ring training at world 4: gradients through K1/K4/K5 and the merge
    against `flash_attention_diff` at world 1, row by row."""
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp

    gen = torch.Generator(device=cuda).manual_seed(22)
    world, s = 4, 512
    qg, kg, vg, wg = (_randn(gen, torch.bfloat16, cuda, 1, n, s, 128)
                      for n in (8, 2, 2, 8))

    def shards(t):
        return t.reshape(1, t.shape[1], world, -1, 128).movedim(
            2, 0).contiguous()

    leaves = [shards(t).requires_grad_(True) for t in (qg, kg, vg)]
    (sp.sp_ring_attention_diff(*leaves).float()
     * shards(wg).float()).sum().backward()
    flat = [t.clone().requires_grad_(True) for t in (qg, kg, vg)]
    (flash_attention_diff(*flat).float() * wg.float()).sum().backward()
    for leaf, ref in zip(leaves, flat):
        got = leaf.grad.movedim(0, 2).reshape(ref.shape)
        _rows_close(got, ref.grad, 5e-2, 2e-2, 0.1)


def test_ep_sp_kernels_reject_unsupported_inputs(cuda):
    from triton_distributed_tpu_torch.kernels import low_latency_all_to_all \
        as a2a
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp

    send = torch.zeros(4, 4, 8, 16, device=cuda)
    counts = torch.zeros(4, 4, 1, dtype=torch.int32, device=cuda)
    ctx = a2a.AllToAllContext("ep", 4, 8, 16)
    with pytest.raises(ValueError, match="contiguous"):
        a2a.fast_all_to_all(send.transpose(2, 3), counts, ctx)
    with pytest.raises(ValueError, match="CUDA"):
        a2a.fast_all_to_all(send, counts.cpu(), ctx)
    q = torch.zeros(4, 1, 2, 16, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        sp.sp_ag_attention_fused(q, q, q)


# ---- the process grid: K21 (torus.cu) and the hierarchical ops ------------

#: (sizes, rows a rank, columns): the two-axis grids both ways round, the
#: three-axis one, rows on and off the 2 * nd pieces (the last pieces short
#: or empty), columns off 8.
TORUS_CASES = [((2, 2), 8, 64), ((2, 4), 6, 40), ((4, 2), 13, 72),
               ((2, 2, 2), 12, 48), ((2, 2, 2), 8, 24), ((2, 2, 2), 100, 40),
               ((2, 4), 70, 24)]


def _torus_ctx(sizes, **kw):
    from triton_distributed_tpu_torch.kernels.torus import TorusContext
    return TorusContext(("x", "y", "z")[:len(sizes)], sizes, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sizes,m,n", TORUS_CASES)
def test_torus_collectives_bit_exact(cuda, dtype, sizes, m, n):
    """K21a and K21b against their plain versions (the CPU's run of the
    same wrappers) bit for bit, and `all_reduce_torus` (K21b then K21a),
    over 5 back-to-back calls each with fresh inputs, queued before any
    check; one launch of each kernel a call."""
    from triton_distributed_tpu_torch.kernels import torus

    ctx = _torus_ctx(sizes)
    world = ctx.world_size
    gen = torch.Generator(device=cuda).manual_seed(world * 100 + m + n)
    before = (torus.all_gather_torus.launches,
              torus.reduce_scatter_torus.launches)
    runs = []
    for _ in range(5):
        x = _randn(gen, dtype, cuda, world, m, n)
        xr = _randn(gen, dtype, cuda, world, world * m, n)
        runs.append((x, xr, torus.all_gather_torus(x, ctx),
                     torus.reduce_scatter_torus(xr, ctx),
                     torus.all_reduce_torus(x, ctx)))
    torch.cuda.synchronize()
    assert (torus.all_gather_torus.launches - before[0],
            torus.reduce_scatter_torus.launches - before[1]) == (10, 10)
    for x, xr, ag, rs, ar in runs:
        assert torch.equal(ag.cpu(), torus.all_gather_torus(x.cpu(), ctx))
        assert torch.equal(rs.cpu(), torus.reduce_scatter_torus(xr.cpu(),
                                                                ctx))
        assert torch.equal(ar.cpu(), torus.all_reduce_torus(x.cpu(), ctx))


def test_torus_collectives_under_faults_and_repeats(cuda):
    """A straggler rank (about 1 ms of cycles), for_correctness, and 100
    back-to-back calls of each kernel on the (2, 4) grid with fresh
    inputs: bit for bit every time."""
    from triton_distributed_tpu_torch.kernels import torus

    gen = torch.Generator(device=cuda).manual_seed(31)
    world, m, n = 8, 16, 64
    for kw in ({"straggler": (5, 2_000_000)}, {"for_correctness": True}, {}):
        ctx = _torus_ctx((2, 4), **kw)
        reps = 100 if not kw else 2
        ins = [(_randn(gen, torch.bfloat16, cuda, world, m, n),
                _randn(gen, torch.bfloat16, cuda, world, world * m, n))
               for _ in range(reps)]
        outs = [(torus.all_gather_torus(x, ctx),
                 torus.reduce_scatter_torus(xr, ctx)) for x, xr in ins]
        torch.cuda.synchronize()
        for (x, xr), (ag, rs) in zip(ins, outs):
            assert torch.equal(ag, torus.all_gather_torus_plain(x)), kw
            assert torch.equal(rs, torus.reduce_scatter_torus_plain(
                xr, (2, 4))), kw


def test_torus_degenerate_grids_run_single_axis_kernels(cuda):
    """A (1, 4) grid runs K15 and K16, a (2, 2, 1) grid K21 on two axes."""
    from triton_distributed_tpu_torch.kernels import torus
    from triton_distributed_tpu_torch.kernels.allgather import all_gather
    from triton_distributed_tpu_torch.kernels.reduce_scatter import (
        reduce_scatter)

    gen = torch.Generator(device=cuda).manual_seed(32)
    x = _randn(gen, torch.float32, cuda, 4, 8, 32)
    xr = _randn(gen, torch.float32, cuda, 4, 32, 32)
    counts = lambda: (all_gather.launches, reduce_scatter.launches,  # noqa
                      torus.all_gather_torus.launches,
                      torus.reduce_scatter_torus.launches)
    for sizes, want in (((1, 4), (1, 1, 0, 0)), ((2, 2, 1), (0, 0, 1, 1))):
        ctx = _torus_ctx(sizes)
        before = counts()
        ag, rs = torus.all_gather_torus(x, ctx), torus.reduce_scatter_torus(
            xr, ctx)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == want
        assert torch.equal(ag.cpu(), torus.all_gather_torus(x.cpu(), ctx))
        assert torch.equal(rs.cpu(), torus.reduce_scatter_torus(xr.cpu(),
                                                                ctx))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sizes,m,k,n", [((2, 2), 64, 256, 384),
                                         ((2, 4), 6, 128, 96),
                                         ((2, 2, 2), 12, 64, 136),
                                         ((2, 2, 2), 100, 64, 72)])
def test_ag_gemm_torus_kernel(cuda, dtype, sizes, m, k, n):
    """K21c against its plain version row by row (as K12), the gathered A
    exactly, over 5 back-to-back calls; one launch a call; and through
    `ag_gemm` on the TorusContext."""
    from triton_distributed_tpu_torch.kernels import torus

    ctx = _torus_ctx(sizes)
    world = ctx.world_size
    gen = torch.Generator(device=cuda).manual_seed(world + m + k + n)
    before = torus.ag_gemm_torus.launches
    for i in range(5):
        a = _randn(gen, dtype, cuda, world, m, k)
        b = _randn(gen, dtype, cuda, world, k, n) * k ** -0.5
        fn = ag_gemm if i else torus.ag_gemm_torus
        out, gathered = fn(a, b, ctx, return_gathered=True)
        ref = torus.ag_gemm_torus_plain(a.float(), b.float())
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (world, world * m, n)
        assert torch.equal(gathered, a.reshape(1, world * m, k).expand(
            world, -1, -1))
        _assert_rows_close("ag_gemm_torus", out, ref, *GEMM_TOL[dtype])
    assert torus.ag_gemm_torus.launches == before + 5


#: (sizes, rows a rank, k, n) of K21c's Hopper body: Qwen3-8B's world-4
#: prefill gate_up at a quarter of its k and n on (2, 2); a decode-like m =
#: 6 on (2, 4) (16-row pieces, the 64-row tile); on (2, 2, 2) m = 512
#: (96-row pieces on the 128-row tile: every a box reads the next lane's
#: rows), m = 100 (32-row pieces, the last short, two empty) and m = 12
#: (one lane of 12 rows, the others empty: 8 tiles a rank, P = 8 of which
#: 6 blocks have crews); n off the 256-column tile.
TORUS_WGMMA_CASES = [((2, 2), 512, 1024, 1536), ((2, 4), 6, 128, 96),
                     ((4, 2), 64, 256, 264), ((2, 2, 2), 512, 256, 520),
                     ((2, 2, 2), 100, 256, 264), ((2, 2, 2), 12, 64, 136)]


@pytest.mark.parametrize("sizes,m,k,n", TORUS_WGMMA_CASES)
def test_ag_gemm_torus_wgmma_matches_k12(cuda, sizes, m, k, n):
    """K21c's bf16 launches run the Hopper body (``wgmma_launches`` one a
    call) and give K12 ``fused``'s bits at world W on the same inputs (the
    same tile and k order a row), over 5 back-to-back calls with fresh
    inputs queued before any check; the gathered A exact; within the
    row-by-row bound of the plain version."""
    from triton_distributed_tpu_torch.kernels import torus

    ctx = _torus_ctx(sizes)
    world = ctx.world_size
    gen = torch.Generator(device=cuda).manual_seed(world * 3 + m + k + n)
    before = (torus.ag_gemm_torus.launches,
              torus.ag_gemm_torus.wgmma_launches)
    runs = []
    for _ in range(5):
        a = _randn(gen, torch.bfloat16, cuda, world, m, k)
        b = _randn(gen, torch.bfloat16, cuda, world, k, n) * k ** -0.5
        runs.append((a, b, *torus.ag_gemm_torus(a, b, ctx,
                                                return_gathered=True)))
    torch.cuda.synchronize()
    assert (torus.ag_gemm_torus.launches - before[0],
            torus.ag_gemm_torus.wgmma_launches - before[1]) == (5, 5)
    k12 = AllGatherGEMMContext("tp", world, "fused")
    for a, b, out, gathered in runs:
        assert out.shape == (world, world * m, n)
        assert torch.equal(gathered, a.reshape(1, world * m, k).expand(
            world, -1, -1))
        assert torch.equal(out, ag_gemm(a, b, k12))
        _assert_rows_close("ag_gemm_torus (wgmma)", out,
                           torus.ag_gemm_torus_plain(a.float(), b.float()),
                           *GEMM_TOL[torch.bfloat16])


@pytest.mark.parametrize("sizes", [(2, 4), (2, 2, 2)])
def test_ag_gemm_torus_wgmma_under_faults(cuda, sizes):
    """K21c's Hopper body under a straggler rank (about 1 ms of cycles)
    and for_correctness, then 50 back-to-back calls on one instance: bit
    for bit equal to K12 ``fused`` every time; f32 calls and bf16 off
    16-byte rows stay on the first body (no ``wgmma_launches``) and
    within its bound."""
    from triton_distributed_tpu_torch.kernels import torus

    world = _torus_ctx(sizes).world_size
    gen = torch.Generator(device=cuda).manual_seed(41 + world)
    m, k, n = 100, 256, 264
    k12 = AllGatherGEMMContext("tp", world, "fused")
    for kw, reps in (({"straggler": (world - 3, 2_000_000)}, 2),
                     ({"for_correctness": True}, 2), ({}, 50)):
        ctx = _torus_ctx(sizes, **kw)
        ins = [(_randn(gen, torch.bfloat16, cuda, world, m, k),
                _randn(gen, torch.bfloat16, cuda, world, k, n) * k ** -0.5)
               for _ in range(reps)]
        wg0 = torus.ag_gemm_torus.wgmma_launches
        outs = [torus.ag_gemm_torus(a, b, ctx, return_gathered=True)
                for a, b in ins]
        torch.cuda.synchronize()
        assert torus.ag_gemm_torus.wgmma_launches == wg0 + reps, kw
        for (a, b), (out, gathered) in zip(ins, outs):
            assert torch.equal(out, ag_gemm(a, b, k12)), kw
            assert torch.equal(gathered, a.reshape(1, world * m, k).expand(
                world, -1, -1)), kw
    ctx = _torus_ctx(sizes)
    for dtype, kk, nn in ((torch.float32, k, n), (torch.bfloat16, 60, n),
                          (torch.bfloat16, k, 90)):
        a = _randn(gen, dtype, cuda, world, m, kk)
        b = _randn(gen, dtype, cuda, world, kk, nn) * kk ** -0.5
        before = (torus.ag_gemm_torus.launches,
                  torus.ag_gemm_torus.wgmma_launches)
        out = torus.ag_gemm_torus(a, b, ctx)
        torch.cuda.synchronize()
        assert (torus.ag_gemm_torus.launches - before[0],
                torus.ag_gemm_torus.wgmma_launches - before[1]) == (1, 0)
        _assert_rows_close("ag_gemm_torus (first body)", out,
                           torus.ag_gemm_torus_plain(a.float(), b.float()),
                           *GEMM_TOL[dtype])


#: The scatter-then-sum body (``csrc/reduce_scatter.cu``): K21b on every
#: TORUS_CASES grid and K16 ``scatter_reduce`` on the COLL_SHAPES of worlds
#: 2, 4 and 8, with no fault, a straggler rank (about 1 ms of cycles) and
#: for_correctness.  K16's ring, K17, K14's first body and K10 keep their
#: own tests above (`test_collective_kernel_bit_exact`, `test_gemm_rs_kernel`
#: in f32, `test_moe_reduce_rs_fused_kernel`).
SUM_CASES = ([("torus", s, m, n) for s, m, n in TORUS_CASES]
             + [("flat", (w,), m, n) for w, m, n in COLL_SHAPES
                if w in (2, 4, 8)])
SUM_FAULTS = {"none": {}, "straggler": {"straggler": (1, 2_000_000)},
              "for_correctness": {"for_correctness": True}}


def _scatter_sum(kind, sizes, x, collective_id=None, **faults):
    """K21b or K16 ``scatter_reduce`` on x, and a function of a CPU copy of
    x giving its plain version."""
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
    from triton_distributed_tpu_torch.kernels import torus

    ids = {} if collective_id is None else {"collective_id": collective_id}
    if kind == "torus":
        return (torus.reduce_scatter_torus(x, _torus_ctx(sizes, **ids,
                                                         **faults)),
                lambda xc: torus.reduce_scatter_torus_plain(xc, sizes))
    ctx = rs.ReduceScatterContext("tp", sizes[0], "scatter_reduce", **ids,
                                  **faults)
    return (rs.reduce_scatter(x, ctx),
            lambda xc: rs.reduce_scatter_reference(xc, "scatter_reduce"))


def _sum_launches():
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
    from triton_distributed_tpu_torch.kernels import torus

    return (torus.reduce_scatter_torus.launches, rs.reduce_scatter.launches,
            rs.reduce_scatter.method_launches["scatter_reduce"])


@pytest.mark.parametrize("fault", list(SUM_FAULTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,sizes,m,n", SUM_CASES)
def test_scatter_sum_bit_exact_back_to_back(cuda, kind, sizes, m, n, dtype,
                                            fault):
    """K21b and K16 ``scatter_reduce`` against their plain versions (the
    CPU's), bit for bit, over 100 back-to-back calls with fresh inputs
    queued before any check; one launch of the body a call, counted by
    the caller's wrapper alone."""
    world = math.prod(sizes)
    gen = torch.Generator(device=cuda).manual_seed(world * 1000 + m + n)
    ins = [_randn(gen, dtype, cuda, world, world * m, n) for _ in range(100)]
    before = _sum_launches()
    runs = [_scatter_sum(kind, sizes, x, **SUM_FAULTS[fault]) for x in ins]
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(_sum_launches(), before))
    assert got == ((100, 0, 0) if kind == "torus" else (0, 100, 100)), got
    for x, (out, plain) in zip(ins, runs):
        assert out.dtype == dtype and out.shape == (world, m, n)
        assert torch.equal(out.cpu(), plain(x.cpu())), (kind, sizes, fault)


@pytest.mark.parametrize("kind,sizes", [("torus", (2, 2)),
                                        ("torus", (2, 2, 2)),
                                        ("flat", (4,)), ("flat", (8,))])
def test_scatter_sum_alternating_shapes_one_id(cuda, kind, sizes):
    """Calls alternating a small shape (one block a rank) and a large one
    (many blocks a rank, a larger receive buffer) on one collective id
    share one instance, its epoch and its signal words: bit for bit every
    time."""
    from triton_distributed_tpu_torch import collective_ids as cids
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
    from triton_distributed_tpu_torch.language import core

    world = math.prod(sizes)
    cid = cids.allocate()
    gen = torch.Generator(device=cuda).manual_seed(world + len(sizes))
    shapes = [(world * 3, 40), (world * 512, 1024)]
    ins = [_randn(gen, torch.bfloat16, cuda, world, *shapes[i % 2])
           for i in range(20)]
    runs = [_scatter_sum(kind, sizes, x, collective_id=cid) for x in ins]
    torch.cuda.synchronize()
    for x, (out, plain) in zip(ins, runs):
        assert torch.equal(out.cpu(), plain(x.cpu())), (kind, x.shape)
    insts = [inst for key, inst in core._instances.items()
             if key[1] == cid]
    assert len(insts) == 1 and insts[0].words == rs.SUM_WORDS
    assert insts[0].epoch >= 20


def test_gemm_rs_torus_kernels(cuda):
    """`gemm_rs` on a TorusContext: W K6 launches and one K21b, equal to
    the CPU's run of the same composition within K14's bound."""
    from triton_distributed_tpu_torch.kernels import torus

    gen = torch.Generator(device=cuda).manual_seed(33)
    ctx = _torus_ctx((2, 4))
    a = _randn(gen, torch.bfloat16, cuda, 8, 64, 128)
    b = _randn(gen, torch.bfloat16, cuda, 8, 128, 96) * 128 ** -0.5
    before = (matmul.launches, torus.reduce_scatter_torus.launches)
    out = gemm_rs(a, b, ctx)
    torch.cuda.synchronize()
    assert (matmul.launches - before[0],
            torus.reduce_scatter_torus.launches - before[1]) == (8, 1)
    ref = gemm_rs_plain(a.float(), b.float())
    _assert_rows_close("gemm_rs_torus", out, ref, *GEMM_TOL[torch.bfloat16])


def test_hierarchical_ops_kernels(cuda):
    """The two-level ops at (dcn 2, ici 4) on the card against the CPU's
    run of the same functions: the gathers and the exchange bit for bit,
    the reductions bit for bit (K16's order and the slices' f32 sum are
    the plain versions'), the GEMMs row by row; dcn launches of the ICI
    kernel for each collective stage."""
    from triton_distributed_tpu_torch.kernels import hierarchical as hier
    from triton_distributed_tpu_torch.kernels.allgather import all_gather
    from triton_distributed_tpu_torch.kernels.low_latency_all_to_all import (
        fast_all_to_all)
    from triton_distributed_tpu_torch.kernels.low_latency_allgather import (
        fast_allgather_2d)

    gen = torch.Generator(device=cuda).manual_seed(34)
    ctx = hier.HierarchicalContext("ici", "dcn", 4, 2)
    x = _randn(gen, torch.bfloat16, cuda, 8, 12, 64)
    xr = _randn(gen, torch.bfloat16, cuda, 8, 96, 64)
    before = (all_gather.launches, fast_all_to_all.launches)
    got = {"ag": hier.all_gather_2d(x, ctx),
           "fast": fast_allgather_2d(x, ctx),
           "rs": hier.reduce_scatter_2d(xr, ctx),
           "ar": hier.all_reduce_2d(x[:, :10].contiguous(), ctx)}
    send = _randn(gen, torch.float32, cuda, 8, 8, 16, 32)
    counts = torch.randint(1, 17, (8, 8, 1), generator=gen, device=cuda,
                           dtype=torch.int32)
    scales = _randn(gen, torch.float32, cuda, 8, 8, 16, 3)
    got["a2a"] = hier.hierarchical_all_to_all(send, counts, ctx, scales)
    torch.cuda.synchronize()
    assert (all_gather.launches - before[0],
            fast_all_to_all.launches - before[1]) == (2 + 2 + 2, 2)
    want = {"ag": hier.all_gather_2d(x.cpu(), ctx),
            "fast": fast_allgather_2d(x.cpu(), ctx),
            "rs": hier.reduce_scatter_2d(xr.cpu(), ctx),
            "ar": hier.all_reduce_2d(x[:, :10].cpu(), ctx),
            "a2a": hier.hierarchical_all_to_all(send.cpu(), counts.cpu(),
                                                ctx, scales.cpu())}
    for name in ("ag", "fast", "rs", "ar"):
        assert torch.equal(got[name].cpu(), want[name]), name
    for g, w in zip(got["a2a"], want["a2a"]):
        assert torch.equal(g.cpu(), w)
    a = _randn(gen, torch.bfloat16, cuda, 8, 64, 128)
    b = _randn(gen, torch.bfloat16, cuda, 8, 128, 96) * 128 ** -0.5
    _assert_rows_close("ag_gemm 2d", ag_gemm(a, b, ctx),
                       ag_gemm_plain(a.float(), b.float()),
                       *GEMM_TOL[torch.bfloat16])
    a2 = _randn(gen, torch.bfloat16, cuda, 8, 128, 64)
    _assert_rows_close("gemm_rs 2d", gemm_rs(a2, b[:, :64], ctx),
                       gemm_rs_plain(a2.float(), b[:, :64].float()),
                       *GEMM_TOL[torch.bfloat16])


def test_hierarchical_sp_attention_and_ep_kernels(cuda):
    """`sp_ag_attention_2d` at (dcn 2, ici 2) against world-1 K1 over the
    whole sequence, row by row, with dcn * dcn K20 launches; the
    two-level EP layer's dispatch bit for bit the flat layer's."""
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp
    from triton_distributed_tpu_torch.kernels.hierarchical import (
        HierarchicalContext)
    from triton_distributed_tpu_torch.layers import (
        EPAll2AllLayer, HierarchicalEPAll2AllLayer)

    gen = torch.Generator(device=cuda).manual_seed(35)
    world, s = 4, 1024
    qg, kg, vg = (_randn(gen, torch.bfloat16, cuda, 1, n, s, 128)
                  for n in (8, 2, 2))

    def shards(t):
        return t.reshape(1, t.shape[1], world, -1, 128).movedim(
            2, 0).contiguous()

    before = sp.sp_ag_attention_fused.launches
    out = sp.sp_ag_attention_2d(shards(qg), shards(kg), shards(vg),
                                HierarchicalContext("sp", "dcn", 2, 2))
    torch.cuda.synchronize()
    assert sp.sp_ag_attention_fused.launches == before + 4
    _rows_close(out.movedim(0, 2).reshape(1, 8, s, 128),
                flash_attention(qg, kg, vg), 5e-2, 1e-2, 0.1)
    flat = EPAll2AllLayer("ep", 8, 32, 4, 64, 128)
    two = HierarchicalEPAll2AllLayer("ici", 8, 32, 4, 64, 128, dcn_size=2)
    x = _randn(gen, torch.bfloat16, cuda, 8, 16, 128)
    ids = torch.randint(0, 32, (8, 16, 4), generator=gen, device=cuda)
    a, b = flat.dispatch(x, ids), two.dispatch(x, ids)
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)
