"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without a CUDA device.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: bf16 out atol=rtol=1e-2 (about one bf16 ulp at magnitude 1:
the kernel rounds its f32 result to bf16), f32 out 1e-4 (order of the
sums, exp2 against exp), lse 1e-3 (f32 on both sides).  The int8 GEMM
is held bit for bit: int32 accumulation is exact and the epilogue
multiplies in the plain version's order.
"""

import pytest
import torch

from triton_distributed_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from triton_distributed_tpu_torch.kernels.flash_decode import (
    flash_decode, flash_decode_paged, flash_decode_paged_reference,
    flash_decode_reference, gather_pages, quantize_kv)
from triton_distributed_tpu_torch.kernels.quantized import (
    matmul_w8a8, matmul_w8a8_reference)

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
    t = -(-s // page_size)
    need = [-(-int(n) // page_size) for n in kv_len.tolist()]
    p = 1 + sum(need)
    perm = 1 + torch.randperm(p - 1, generator=gen, device=cuda)
    table = torch.zeros((b, t), dtype=torch.int32, device=cuda)
    kp = torch.full((p, hkv, page_size, d), 127, dtype=torch.int8,
                    device=cuda)
    vp = torch.full_like(kp, 127)
    ksp = torch.full((p, hkv, page_size), float("nan"), device=cuda)
    vsp = torch.full_like(ksp, float("nan"))
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n].to(torch.int32)
        at += n
        for j in range(n):
            lo, hi = j * page_size, min((j + 1) * page_size, s)
            pg = int(table[i, j])
            kp[pg, :, :hi - lo] = k_q[i, :, lo:hi]
            vp[pg, :, :hi - lo] = v_q[i, :, lo:hi]
            ksp[pg, :, :hi - lo] = ks[i, :, lo:hi]
            vsp[pg, :, :hi - lo] = vs[i, :, lo:hi]
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


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (8, 4096, 512),       # a decode batch
    (300, 1024, 640),     # ragged m, several tiles
    (37, 208, 136),       # ragged m and n, k not a multiple of 64
    (130, 64, 100),       # n not a multiple of 16: byte loads of b
    (1, 16, 1),
])
def test_matmul_w8a8_kernel(cuda, out_dtype, m, k, n):
    """K7 against its exact plain version: equal bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    sa = torch.rand(m, generator=gen, device=cuda) / 100
    sb = torch.rand(n, generator=gen, device=cuda) / 100
    before = matmul_w8a8.launches
    out = matmul_w8a8(a, b, sa, sb, out_dtype=out_dtype)
    assert matmul_w8a8.launches == before + 1
    want = matmul_w8a8_reference(a, b, sa, sb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert out.dtype == out_dtype and torch.equal(out, want)


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
    before = matmul_w8a8.launches
    got = mlp(x)
    assert matmul_w8a8.launches == before + 2
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
