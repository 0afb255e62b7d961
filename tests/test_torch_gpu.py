"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without a CUDA device.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: bf16 out atol=rtol=1e-2 (about one bf16 ulp at magnitude 1:
the kernel rounds its f32 result to bf16), f32 out 1e-4 (order of the
sums, exp2 against exp), lse 1e-3 (f32 on both sides).
"""

import pytest
import torch

from triton_distributed_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from triton_distributed_tpu_torch.kernels.flash_decode import (
    flash_decode, flash_decode_paged, flash_decode_paged_reference,
    flash_decode_reference)

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


def _scatter_to_pages(gen, kc, vc, kv_len, ps):
    """A pool holding the dense caches' positions below kv_len in
    shuffled physical pages (page 0 filled with garbage), and its table;
    pages past a row's length map to page 0."""
    b, hkv, s, d = kc.shape
    t = -(-s // ps)
    need = [-(-int(n) // ps) for n in kv_len.tolist()]
    p = 1 + sum(need)
    perm = 1 + torch.randperm(p - 1, generator=gen, device=kc.device)
    table = torch.zeros((b, t), dtype=torch.int32, device=kc.device)
    kp = torch.full((p, hkv, ps, d), 1e4, dtype=kc.dtype, device=kc.device)
    vp = torch.full_like(kp, -1e4)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n].to(torch.int32)
        at += n
        for j in range(n):
            lo, hi = j * ps, min((j + 1) * ps, s)
            pg = int(table[i, j])
            kp[pg, :, :hi - lo] = kc[i, :, lo:hi]
            vp[pg, :, :hi - lo] = vc[i, :, lo:hi]
    return kp, vp, table


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
    kp, vp, table = _scatter_to_pages(gen, kc, vc, kv_len, page_size)
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
