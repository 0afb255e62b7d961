#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits
non-zero):

1. device: name, count, compute capability, power limit; requires sm_90;
2. build: compiles every CUDA kernel of the main path from
   ``triton_distributed_tpu_torch/kernels/csrc`` with nvcc;
3. kernels vs plain: each kernel against its plain PyTorch version, in
   f32 from the same bf16 inputs, at the main path's shapes and edge
   cases;
4. main path: Qwen3-8B at full width and depth with seeded random bf16
   weights; ``Engine.serve`` answers 4 requests of 512 prompt tokens with
   32 greedy tokens each, with the kernel launch counts checked, then a
   teacher-forcing check of decode against prefill;
5. times: each kernel, its bound, its plain version and the PyTorch
   library call for the same function, then prefill and decode times;
6. profile: one traced prefill and eight traced decode steps, with the
   device's busy share and the kernels that take its time.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

#: Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3
#: and bf16 tensor-core FLOP/s.  Bounds are stated against these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

KERNEL_SOURCES = {
    "flash_attention": (
        "triton_distributed_tpu_torch/kernels/csrc/flash_attention.cu",
        "triton_distributed_tpu/kernels/flash_attention.py:564"),
    "flash_decode": (
        "triton_distributed_tpu_torch/kernels/csrc/flash_decode.cu",
        "triton_distributed_tpu/kernels/flash_decode.py:195"),
}

BATCH, PROMPT, GEN_LEN, CACHE_SEQ = 4, 512, 32, 1024

#: Device cycles (about 50 ms at the H100's 1.98 GHz boost clock) that the
#: stream spins before a timed run.  Every timed run below is queued by the
#: host well within that, so its launches run back to back and the events
#: time the device, not the host's launch rate.
QUEUE_AHEAD_CYCLES = 100_000_000


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return smi.splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    measured with CUDA events after ``warmup`` calls, with the calls
    queued ahead of the device (QUEUE_AHEAD_CYCLES)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_pairs(sq: int, sk: int, causal: bool, kv_offset: int) -> int:
    """(query, key) pairs a causal or full attention must score."""
    if not causal:
        return sq * sk
    return sum(min(max(i + kv_offset + 1, 0), sk) for i in range(sq))


def profile_phase(label: str, fn, card: str, top: int = 6) -> None:
    """One traced call of ``fn`` under torch.profiler: its host time, the
    summed device time of its kernels (one stream, so no overlap), the
    device's busy share of the host time, and the kernels that took
    most of it.  Tracing adds host time, so the share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_host = wall_ms(fn)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    if not dev_us:
        print(f"[profile] {label}: no device events recorded; busy share "
              "not measured")
        return
    kern.sort(key=lambda e: -e.self_device_time_total)
    tops = "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms "
        f"({e.self_device_time_total / dev_us:.0%})" for e in kern[:top])
    print(f"[profile] {label}: host {t_host:.2f} ms (traced), device "
          f"{dev_us / 1e3:.2f} ms, busy {dev_us / 1e3 / t_host:.0%}; "
          f"{card}; top kernels: {tops}")


def check_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    print(f"  {name}: max_abs_err={worst:.3e} (atol={atol}, rtol={rtol}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch import (
        Engine, ModelConfig, Qwen3, is_hopper)
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)
    from triton_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode, flash_decode_reference)
    import torch.nn.functional as F

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {name} count={torch.cuda.device_count()} "
          f"capability={torch.cuda.get_device_capability(0)} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(card)
    if not is_hopper():
        raise RuntimeError(f"{name} is not a Hopper (sm_90) GPU")

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build(list(KERNEL_SOURCES))
    print(f"[build] {len(paths)} kernels in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()))

    # -- 3. kernels vs plain --------------------------------------------
    print("[kernels vs plain] out: atol=rtol=1e-2 (about one bf16 ulp at "
          "magnitude 1; the kernel rounds its f32 result to bf16), "
          "lse: atol=1e-3 (both f32)")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    errs = {"flash_attention": 0.0, "flash_decode": 0.0}
    fa_cases = [
        ("prefill 4x32x512x128 causal", 4, 32, 8, 512, 512, True, 0),
        ("ragged Sq=Sk=300 causal", 2, 8, 2, 300, 300, True, 0),
        ("kv_offset=128 Sq=128 Sk=256", 2, 8, 4, 128, 256, True, 128),
        ("non-causal Sq=200 Sk=333", 2, 8, 8, 200, 333, False, 0),
    ]
    fa_main = None
    for label, b, h, hkv, sq, sk, causal, off in fa_cases:
        q, k, v = randn(b, h, sq, 128), randn(b, hkv, sk, 128), randn(
            b, hkv, sk, 128)
        out, lse = flash_attention(q, k, v, causal=causal, kv_offset=off,
                                   return_lse=True)
        ref, ref_lse = flash_attention_reference(
            q.float(), k.float(), v.float(), causal=causal, kv_offset=off,
            return_lse=True)
        torch.cuda.synchronize()
        e = check_close(f"flash_attention {label} out", out, ref, 1e-2, 1e-2)
        check_close(f"flash_attention {label} lse", lse, ref_lse, 1e-3, 0.0)
        errs["flash_attention"] = max(errs["flash_attention"], e)
        if fa_main is None:
            fa_main = (q, k, v)

    def decode_case(label, q, kc, vc, kv_len):
        out, lse = flash_decode(q, kc, vc, kv_len)
        ref, ref_lse = flash_decode_reference(q.float(), kc.float(),
                                              vc.float(), kv_len)
        torch.cuda.synchronize()
        e = check_close(f"flash_decode {label} out", out, ref, 1e-2, 1e-2)
        check_close(f"flash_decode {label} lse", lse, ref_lse, 1e-3, 0.0)
        errs["flash_decode"] = max(errs["flash_decode"], e)

    kc, vc = randn(BATCH, 8, CACHE_SEQ, 128), randn(BATCH, 8, CACHE_SEQ, 128)
    decode_case("q 4x32x128, cache 4x8x1024x128, kv_len=[1,513,700,1024]",
                randn(BATCH, 32, 128), kc, vc,
                torch.tensor([1, 513, 700, 1024], dtype=torch.int32,
                             device=dev))
    del kc, vc

    # -- 4. main path ---------------------------------------------------
    cfg = ModelConfig.qwen3_8b()
    t0 = time.perf_counter()
    wgen = torch.Generator(device=dev).manual_seed(0)
    model = Qwen3(cfg).init_params(wgen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main path] Qwen3-8B: {cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {n_params / 1e9:.3f} B parameters, "
          f"{cfg.dtype}; random weights (seed 0) in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = Engine(model)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=wgen, device=dev)
    cache = model.create_cache(BATCH, max_seq=CACHE_SEQ)

    served = []
    flash_attention.launches = 0
    flash_decode.launches = 0
    t_serve = wall_ms(lambda: served.append(
        engine.serve(prompts, GEN_LEN, cache=cache)))
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    print(f"[main path] Engine.serve {BATCH} requests x {PROMPT} prompt "
          f"tokens, gen_len {GEN_LEN}, greedy: {t_serve:.1f} ms (first "
          f"call); launches {launches}")
    want = {"flash_attention": cfg.num_layers,
            "flash_decode": cfg.num_layers * (GEN_LEN - 1)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    with torch.inference_mode():
        tokens = served[0]
        if tokens.shape != (BATCH, GEN_LEN):
            raise AssertionError(f"tokens shape {tuple(tokens.shape)}")
        if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError("tokens outside the vocabulary")

        # Teacher forcing: decode at position PROMPT must give the logits
        # of a prefill over PROMPT + 1 tokens.  In bf16 the two paths round
        # at different places (M=4 against M=2052 products, decode against
        # prefill attention kernels) through 36 layers, so the tolerance is
        # set from this run's own bf16 error: an f32 copy of the same
        # weights gives the exact logits, and decode may differ from the
        # bf16 prefill by at most 3x the bf16 prefill's distance from them
        # (two independent errors of that size differ by about 1.4x).
        seq = torch.cat([prompts, tokens[:, :1].long()], dim=1)
        logits_p = model.prefill(prompts, cache)
        logits_d = model.decode(tokens[:, 0], cache)
        tf_cache = model.create_cache(BATCH, max_seq=CACHE_SEQ)
        logits_f = model.prefill(seq, tf_cache)
        del tf_cache
        exact = Qwen3(dataclasses.replace(cfg, dtype="float32"))
        exact.load_state_dict(model.state_dict())
        logits_x = exact.prefill(seq, None)
        del exact
        for nm, lg in (("prefill", logits_p), ("decode", logits_d),
                       ("prefill+1", logits_f), ("f32 prefill+1", logits_x)):
            if lg.dtype != torch.float32 or not bool(lg.isfinite().all()):
                raise AssertionError(f"{nm} logits not finite f32")
        if not torch.equal(logits_p.argmax(-1).to(torch.int32), tokens[:, 0]):
            raise AssertionError("first token != argmax of prefill logits")

        def rel_l2(a, b):
            return float((a - b).norm() / b.norm())

        tf_err = rel_l2(logits_d, logits_f)
        floor = rel_l2(logits_f, logits_x)
        agree = float((logits_d.argmax(-1) == logits_f.argmax(-1)).float()
                      .mean())
        print(f"[main path] teacher forcing, decode@{PROMPT} vs prefill of "
              f"{PROMPT + 1} tokens: rel_l2={tf_err:.3e} (max_abs "
              f"{float((logits_d - logits_f).abs().max()):.3e}, max|logit| "
              f"{float(logits_f.abs().max()):.3f}, argmax agreement "
              f"{agree:.2f}); bf16 error of the prefill against f32 "
              f"weights and activations: rel_l2={floor:.3e}, decode against "
              f"f32: {rel_l2(logits_d, logits_x):.3e}; tolerance "
              f"{3 * floor:.3e} (3x the bf16 error)")
        if not tf_err <= 3 * floor:
            raise AssertionError("teacher-forcing logits disagree")

    # -- 5. times -------------------------------------------------------
    print(f"[times] card: {card}; CUDA events, mean over back-to-back "
          "calls after warm-up")
    records = []

    q, k, v = fa_main
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = flash_attention(q, k, v)
    ms = time_ms(lambda: flash_attention(q, k, v), 50)
    plain = time_ms(lambda: flash_attention_reference(q, k, v), 5)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 50)
    lse_bytes = b * h * sq * 4
    bms, by = bound(nbytes(q, k, v, out) + lse_bytes,
                    4 * b * h * attention_pairs(sq, sk, True, 0) * d)
    records.append(("flash_attention", ms, plain, bms, by, lib))

    # flash_decode at a main-path decode state: the cache after the
    # teacher-forcing decode, every row filled to PROMPT + 1 positions.
    # Timed over the 36 layers' caches in turn, as a decode step reads
    # them, so K/V come from device memory and not from the 50 MB L2.
    layers = list(zip(cache.ks, cache.vs))
    kc, vc = layers[0]
    kv_len = cache.offset.clone()
    L = int(kv_len[0])
    qd = randn(BATCH, cfg.num_heads, cfg.head_dim)
    decode_case(f"main-path state kv_len={L}", qd, kc, vc, kv_len)
    out, _ = flash_decode(qd, kc, vc, kv_len)
    q4 = qd[:, :, None, :]

    def per_layer_ms(call, reps):
        return time_ms(lambda: [call(k_, v_) for k_, v_ in layers],
                       reps) / len(layers)

    ms = per_layer_ms(lambda k_, v_: flash_decode(qd, k_, v_, kv_len), 5)
    plain = per_layer_ms(
        lambda k_, v_: flash_decode_reference(qd, k_, v_, kv_len), 1)
    lib = per_layer_ms(lambda k_, v_: F.scaled_dot_product_attention(
        q4, k_[:, :, :L], v_[:, :, :L], enable_gqa=True), 5)
    kv_bytes = 2 * int(kv_len.sum()) * kc.shape[1] * d * kc.element_size()
    bms, by = bound(nbytes(qd, kv_len, out) + kv_bytes + BATCH * cfg.num_heads * 4,
                    4 * cfg.num_heads * d * int(kv_len.sum()))
    records.append(("flash_decode", ms, plain, bms, by, lib))

    kernels = []
    for nm, ms, plain, bms, by, lib in records:
        src, repl = KERNEL_SOURCES[nm]
        print(f"[times] {nm}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, "
              f"{bms / ms:.1%} of bound), plain {plain:.4f} ms, library "
              f"{lib:.4f} ms; {card}")
        kernels.append({"name": nm, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[nm],
                        "max_abs_err": errs[nm], "ms": ms,
                        "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                        "library_ms": lib})

    with torch.inference_mode():
        serve1 = sorted(wall_ms(lambda: engine.serve(prompts, 1, cache=cache))
                        for _ in range(3))[1]
        serve_n = sorted(wall_ms(lambda: engine.serve(prompts, GEN_LEN,
                                                      cache=cache))
                         for _ in range(3))[1]
    step_ms = (serve_n - serve1) / (GEN_LEN - 1)
    print(f"[times] Engine.serve (median of 3, host clock): prefill+first "
          f"token {serve1:.2f} ms ({BATCH * PROMPT / serve1 * 1e3:.0f} "
          f"prompt tokens/s); decode {step_ms:.3f} ms/step "
          f"({BATCH / step_ms * 1e3:.1f} tokens/s); whole serve "
          f"{serve_n:.2f} ms ({BATCH * GEN_LEN / serve_n * 1e3:.1f} "
          f"generated tokens/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")

    # -- 6. where the time goes ----------------------------------------
    with torch.inference_mode():
        profile_phase("prefill", lambda: model.prefill(prompts, cache),
                      card)
        profile_phase("decode x8", lambda: [
            model.decode(tokens[:, 0], cache) for _ in range(8)], card)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
