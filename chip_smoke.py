#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits
non-zero):

1. device: name, count, compute capability, power limit; requires sm_90;
2. build: compiles every CUDA kernel of the main paths from
   ``triton_distributed_tpu_torch/kernels/csrc`` with nvcc, one process
   per source, all started together;
3. kernels vs plain: each kernel against its plain PyTorch version, in
   f32 from the same bf16 inputs, at the main paths' shapes and edge
   cases; the paged decode kernels also bit for bit against the dense
   ones over the same logical K/V (float and int8); the int8 GEMM bit for
   bit against its exact plain version at the Qwen3-8B MLP shapes; the
   flash backward (K4 dq, K5 dk/dv) at the training shapes in bf16 and
   on ragged and negative-offset cases in f32, each output held row by
   row and in relative L2;
4. Engine path: Qwen3-8B at full width and depth with seeded random bf16
   weights; ``Engine.serve`` answers 4 requests of 512 prompt tokens with
   32 greedy tokens each, with the kernel launch counts checked, then a
   teacher-forcing check of decode against prefill; then the same model
   with an int8 KV cache (``quantize_kv_cache=True``, the same weights):
   the same requests, its prefill logits equal to the float model's and
   its first 3 decode steps (fed the float run's tokens) within
   0.03 max|logits| of the float model's;
5. scheduler path: the same model behind ``ContinuousBatchingScheduler``
   (8 slots, 2048 positions, pages of 16), 16 requests (6 sharing a
   512-token prefix) served three ways: dense slots, paged with the
   prefix cache, and paged with a 200-page pool that forces preemption;
   then with the int8 cache two ways, slots and paged with the prefix
   cache; tokens, prefix hits, launch counts and preemption checked;
   wall time, generated and prompt tokens/s, decode ms per step;
6. W8A8 layer path: ``TPMLP(4096, 12288, mode="w8a8")`` at 2048 and 8
   rows against its plain version and against the bf16 ``xla`` layer on
   the float weights;
7. times: each kernel, its bound, its plain version and the PyTorch
   library call for the same function, then prefill and decode times,
   int8 against float decode in alternating windows;
8. profile: one traced prefill and eight traced decode steps of the
   Engine path (float and int8), and eight traced scheduler steps of each
   scheduler, with the device's busy share and the kernels that take its
   time;
9. training path: gradients of a 2-layer model of Qwen3-8B's widths on
   the card (kernels) in f32 and in bf16 against the CPU's f32 (plain
   versions), per leaf; then
   Qwen3-8B at full width and depth in bf16 (the same weights as phases
   4-8, which no longer need them) takes 3 SGD steps on 4 sequences of
   512 tokens (cross-entropy of the last position's logits against seeded
   targets): loss, ms per forward+backward, tokens/s, peak memory, exact
   K1/K4/K5 launches per step, finite gradients, a falling loss; one
   traced training step.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time

import torch

#: Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3,
#: bf16 tensor-core FLOP/s and int8 tensor-core OP/s.  Bounds are stated
#: against these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12

#: Library -> its CUDA source (``kernels/csrc/<library>.cu``).
KERNEL_SOURCES = {
    lib: f"triton_distributed_tpu_torch/kernels/csrc/{lib}.cu"
    for lib in ("flash_attention", "flash_decode", "flash_decode_paged",
                "matmul_w8a8", "flash_attention_bwd")}

_TPU = "triton_distributed_tpu/kernels/"
#: The kernels of the JSON record: name -> (library it is built into, the
#: wrapper's launch counter, the TPU kernel it replaces).  The int8 decode
#: kernels (K2q, K3q) are the float ones' libraries with an int8 cache;
#: their wrappers count them apart.  K4 and K5 launch as a pair from one
#: wrapper, which counts each kernel apart (and the pair in ``launches``).
KERNELS = {
    "flash_attention": ("flash_attention", "launches",
                        _TPU + "flash_attention.py:564"),
    "flash_decode": ("flash_decode", "launches", _TPU + "flash_decode.py:195"),
    "flash_decode_paged": ("flash_decode_paged", "launches",
                           _TPU + "flash_decode.py:310"),
    "flash_decode_int8": ("flash_decode", "int8_launches",
                          _TPU + "flash_decode.py:195"),
    "flash_decode_paged_int8": ("flash_decode_paged", "int8_launches",
                                _TPU + "flash_decode.py:310"),
    "matmul_w8a8": ("matmul_w8a8", "launches", _TPU + "quantized.py:120"),
    "flash_attention_bwd_dq": ("flash_attention_bwd", "dq_launches",
                               _TPU + "flash_attention.py:948"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd", "dkv_launches",
                                _TPU + "flash_attention.py:987"),
}

BATCH, PROMPT, GEN_LEN, CACHE_SEQ = 4, 512, 32, 1024

#: Scheduler path: 8 slots of 2048 positions, pages of 16.  Traffic: 6
#: requests share a 512-token system prefix (totals all in bucket 1024,
#: so the donor's and the consumers' prefix K/V are computed at the same
#: shape), 10 have unique prompts; max_new_tokens cycles 16..64.
SLOTS, MAX_SEQ, PAGE = 8, 2048, 16
SYS_PREFIX = 512
SHARED_TOTALS = (612, 672, 732, 792, 852, 912)
UNIQUE_LENS = (40, 100, 200, 300, 450, 700, 1000, 1100, 1500, 1800)
MAX_NEW_CYCLE = (16, 32, 48, 64)
TIGHT_PAGES = 200

#: K3's main-path decode state: 8 rows at these lengths (1 position, a
#: page less one, a page, a page plus one, ..., the full 2048).
K3_KV_LEN = (1, 15, 16, 17, 513, 1000, 1928, 2048)

#: The W8A8 layer path: Qwen3-8B's MLP widths; rows of a prefill bucket
#: and of a decode batch of 8 slots (and a ragged count for K7's check).
MLP_HIDDEN, MLP_FFN = 4096, 12288
W8A8_ROWS = (2048, 8)

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


def bound(bytes_moved: float, ops: float, peak: float = PEAK_BF16_FLOPS):
    """The least time (ms) for ``bytes_moved`` at the HBM rate and ``ops``
    at ``peak``, and which of the two sets it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_pairs(sq: int, sk: int, causal: bool, kv_offset: int) -> int:
    """(query, key) pairs a causal or full attention must score."""
    if not causal:
        return sq * sk
    return sum(min(max(i + kv_offset + 1, 0), sk) for i in range(sq))


#: Substrings of a device kernel's name -> its kind in a profile's
#: breakdown (first match wins); the port's own kernels first.
KERNEL_KINDS = (
    ("port kernels", ("flash_fwd_", "bwd_dq_", "bwd_dkv_", "decode_kernel",
                      "w8a8_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass")),
    ("elementwise and reductions", ("elementwise", "reduce", "index",
                                    "embedding", "softmax", "cat")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile_phase(label: str, fn, card: str, top: int = 6) -> None:
    """One traced call of ``fn`` under torch.profiler: its host time, the
    summed device time of its kernels (one stream, so no overlap), the
    device's busy share of the host time, the device time by kernel kind,
    and the kernels that took most of it.  Tracing adds host time, so
    the share is a lower bound."""
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
    kinds = {}
    for e in kern:
        kind = kernel_kind(e.key)
        kinds[kind] = kinds.get(kind, 0) + e.self_device_time_total
    by_kind = ", ".join(f"{k} {v / 1e3:.2f} ms ({v / dev_us:.0%})"
                        for k, v in sorted(kinds.items(),
                                           key=lambda kv: -kv[1]))
    tops = "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms "
        f"({e.self_device_time_total / dev_us:.0%})" for e in kern[:top])
    print(f"[profile] {label}: host {t_host:.2f} ms (traced), device "
          f"{dev_us / 1e3:.2f} ms, busy {dev_us / 1e3 / t_host:.0%}; "
          f"{card}; by kind: {by_kind}; top kernels: {tops}")


def check_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    print(f"  {name}: max_abs_err={worst:.3e} (atol={atol}, rtol={rtol}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return worst


def check_rows(name, got, want, tol, rel_tol, floor):
    """``got`` against ``want`` with a bound that scales with each row (the
    last dim), not with the tensor's maximum: |err| <= tol * (|ref| +
    rms(ref's row) + floor * rms(ref)), the last term for rows whose exact
    value is zero (a query row that sees one key: its ds cancels, leaving
    the rounding of dp - delta); and rel_l2 <= ``rel_tol`` over the
    tensor.  Returns max |err|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    row = w.pow(2).mean(-1, keepdim=True).sqrt()
    floor = floor * w.pow(2).mean().sqrt()
    ratio = float((err / (w.abs() + row + floor).clamp_min(
        torch.finfo(torch.float32).tiny)).max()) if err.numel() else 0.0
    rel = float(err.norm() / w.norm()) if float(w.norm()) else float(
        err.norm())
    worst = float(err.max()) if err.numel() else 0.0
    ok = ratio <= tol and rel <= rel_tol
    print(f"  {name}: max_abs_err={worst:.3e}, max err/(|ref| + rms_row + "
          f"floor*rms)={ratio:.3e} (tol {tol}), rel_l2={rel:.3e} (tol "
          f"{rel_tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return worst


def shuffled_table(gen, kv_len, ps: int, t: int, device):
    """A (B, T) int32 page table mapping each row's pages below its
    length to distinct physical pages in shuffled order (page 0, the null
    page, everywhere else), and the pool size it needs (null included)."""
    need = [-(-int(n) // ps) for n in kv_len]
    perm = 1 + torch.randperm(sum(need), generator=gen, device=device)
    table = torch.zeros((len(need), t), dtype=torch.int32, device=device)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n].to(torch.int32)
        at += n
    return table, 1 + sum(need)


def scatter_to_pool(cache, table, num_pages: int, ps: int, fill: float):
    """The pool holding a dense (B, Hkv, S, ...) cache's pages (K/V, or
    their scales) where ``table`` maps them; unmapped pages (the null page
    among them) hold ``fill``."""
    b, hkv, s = cache.shape[:3]
    tail = cache.shape[3:]
    t = table.shape[1]
    padded = torch.full((b, hkv, t * ps, *tail), fill, dtype=cache.dtype,
                        device=cache.device)
    padded[:, :, :s] = cache
    blocks = padded.reshape(b, hkv, t, ps, *tail).transpose(1, 2)
    pool = torch.full((num_pages, hkv, ps, *tail), fill, dtype=cache.dtype,
                      device=cache.device)
    mapped = table != 0
    pool[table[mapped].long()] = blocks[mapped]
    return pool


def scheduler_traffic(vocab: int, seed: int):
    """The 16 requests of the scheduler path as (prompt, max_new_tokens),
    shared-prefix and unique prompts interleaved; token ids avoid the pad
    id 0."""
    gen = torch.Generator().manual_seed(seed)

    def ids(n):
        return torch.randint(1, vocab, (n,), generator=gen).tolist()

    prefix = ids(SYS_PREFIX)
    shared = [prefix + ids(n - SYS_PREFIX) for n in SHARED_TOTALS]
    unique = [ids(n) for n in UNIQUE_LENS]
    order = [p for pair in zip(shared, unique) for p in pair]
    order += unique[len(shared):]
    return [(p, MAX_NEW_CYCLE[i % len(MAX_NEW_CYCLE)])
            for i, p in enumerate(order)]


def drive_scheduler(sched, traffic, request_cls, queued_state):
    """Submit the traffic and step the scheduler until it drains (what
    ``run()`` does), timing each step on the host (a step ends in the
    host sync of its tokens).  Returns the requests and the run's record:
    wall ms, per-step (ms, admitted, decoded), prompt tokens prefilled
    (resumes included), and each preempted request's token count at its
    first preemption."""
    reqs = [request_cls(prompt=p, max_new_tokens=n) for p, n in traffic]
    steps, prompt_tokens, first_preempt = [], 0, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        if not sched.submit(r):
            raise AssertionError(f"request rejected: {r.reject_reason}")
    while sched.has_work():
        waiting = {i: len(r.resume_tokens or r.prompt)
                   for i, r in enumerate(reqs) if r.state is queued_state}
        ts = time.perf_counter()
        info = sched.step()
        steps.append(((time.perf_counter() - ts) * 1e3, info["admitted"],
                      info["active"] > 0))
        for i, r in enumerate(reqs):
            if i in waiting and r.state is not queued_state:
                prompt_tokens += waiting[i]
            if r.preemptions and i not in first_preempt:
                first_preempt[i] = len(r.generated)
    torch.cuda.synchronize()
    return reqs, {"wall_ms": (time.perf_counter() - t0) * 1e3,
                  "steps": steps, "prompt_tokens": prompt_tokens,
                  "first_preempt": first_preempt}


#: Training path: 3 SGD steps of this rate on Qwen3-8B (the target logit
#: moves by about TRAIN_LR / BATCH * hidden = 10 a step through the head's
#: gradient alone), and the 2-layer gradient check's tokens and per-leaf
#: rel_l2 bounds against the CPU's f32 (measured on an H100: f32 about
#: 5e-6, bf16 at most 2.3e-2, the q/k norms' weights).
TRAIN_STEPS, TRAIN_LR = 3, 1e-2
GRAD_CHECK_TOKENS = 128
GRAD_REL_L2 = {"f32": 1e-4, "bf16": 5e-2}


def last_position_loss(model, ids, targets):
    """Cross-entropy of the last position's logits (the differentiable
    prefill, ``model(ids)``) against ``targets``."""
    return torch.nn.functional.cross_entropy(model(ids), targets)


@torch.no_grad()
def sgd_step(params, lr: float) -> None:
    """p -= lr * p.grad in one pass per tensor: PyTorch computes a bf16
    add in f32 and rounds the sum once, so no update is lost to a bf16
    product first."""
    for p in params:
        p.add_(p.grad, alpha=-lr)


def train_model_gradients(cfg, dev, card: str) -> None:
    """Gradients of a 2-layer model of ``cfg``'s widths (random bf16
    weights, seed 7) for 1 x GRAD_CHECK_TOKENS tokens, on the card (K1, K4,
    K5, cuBLAS) in f32 and in bf16, each against the same weights' f32
    gradients on the CPU (the plain versions), per leaf within
    GRAD_REL_L2 of its dtype in relative L2: f32 on both sides differs only in the
    order of the sums; bf16 rounds every activation and gradient too."""
    from triton_distributed_tpu_torch import Qwen3
    from triton_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention_backward)

    two = dataclasses.replace(cfg, num_layers=2)
    small = dataclasses.replace(two, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16 = Qwen3(two).init_params(gen)
    f32 = Qwen3(small)
    f32.load_state_dict(bf16.state_dict())
    cpu = Qwen3(small, device="cpu")
    cpu.load_state_dict(f32.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (1, GRAD_CHECK_TOKENS),
                        generator=gen, device=dev)
    targets = torch.randint(0, cfg.vocab_size, (1,), generator=gen,
                            device=dev)
    losses = {}
    for tag, m in (("CPU", cpu), ("f32", f32), ("bf16", bf16)):
        d = "cpu" if m is cpu else dev
        m.requires_grad_(True)
        before = (flash_attention_backward.dq_launches,
                  flash_attention_backward.dkv_launches)
        loss = last_position_loss(m, ids.to(d), targets.to(d))
        loss.backward()
        losses[tag] = float(loss)
        launched = (flash_attention_backward.dq_launches - before[0],
                    flash_attention_backward.dkv_launches - before[1])
        want = (0, 0) if m is cpu else (two.num_layers, two.num_layers)
        if launched != want:
            raise AssertionError(f"2-layer check {tag}: K4/K5 launched "
                                 f"{launched}, want {want}")
    torch.cuda.synchronize()
    for tag, m in (("f32", f32), ("bf16", bf16)):
        rels = {}
        for (name, pc), pg in zip(cpu.named_parameters(), m.parameters()):
            if not bool(pg.grad.isfinite().all()):
                raise AssertionError(f"2-layer check {tag}: {name} gradient "
                                     "not finite")
            rels[name] = float((pg.grad.float().cpu() - pc.grad).norm()
                               / pc.grad.norm())
        worst = max(rels, key=rels.get)
        ok = rels[worst] <= GRAD_REL_L2[tag]
        print(f"[training path] 2-layer {tag} model of Qwen3-8B's widths, "
              f"1 x {GRAD_CHECK_TOKENS} tokens, last-position cross-entropy: "
              f"loss card {losses[tag]:.6f}, CPU f32 {losses['CPU']:.6f}; "
              f"gradients of all {len(rels)} leaves (K4 and K5 launched "
              f"{two.num_layers} times each) against the CPU's plain "
              f"versions: worst rel_l2 {rels[worst]:.3e} ({worst}), median "
              f"{sorted(rels.values())[len(rels) // 2]:.3e}; bound "
              f"{GRAD_REL_L2[tag]} {'ok' if ok else 'FAIL'}; {card}")
        if not ok:
            raise AssertionError(f"2-layer {tag} gradient check failed")
    del bf16, f32, cpu
    gc.collect()
    torch.cuda.empty_cache()


def train_steps(model, cfg, ids, counted, expect, short, dev,
                card: str) -> None:
    """TRAIN_STEPS SGD steps of ``model`` on ``ids`` against seeded
    targets, each forward+backward counted (exact K1/K4/K5 launches, one of
    each per layer), with finite gradients and a falling loss; then one
    traced step."""
    targets = torch.randint(0, cfg.vocab_size, (ids.shape[0],),
                            generator=torch.Generator(device=dev)
                            .manual_seed(0), device=dev)
    model.requires_grad_(True)
    params = list(model.parameters())
    nl = cfg.num_layers
    want = expect(flash_attention=nl, flash_attention_bwd_dq=nl,
                  flash_attention_bwd_dkv=nl)
    print(f"[training path] Qwen3-8B, {nl} layers, bf16, seed-0 weights; "
          f"{ids.shape[0]} x {ids.shape[1]} tokens; loss = cross-entropy of "
          f"the last position's logits against seeded targets; SGD lr "
          f"{TRAIN_LR} computed in f32, rounded once to bf16")
    losses = []
    for step in range(TRAIN_STEPS):
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        got, t = [], []

        def fwd_bwd():
            loss = last_position_loss(model, ids, targets)
            loss.backward()
            got.append(loss.detach())

        launches = counted(lambda: t.append(wall_ms(fwd_bwd)))
        loss = float(got[0])
        peak = torch.cuda.max_memory_allocated() / 2**30
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(p.grad.isfinite().all())]
        t_sgd = wall_ms(lambda: sgd_step(params, TRAIN_LR))
        print(f"[training path] step {step}: loss {loss:.6f}; "
              f"forward+backward {t[0]:.2f} ms (host clock around a sync), "
              f"{ids.numel() / t[0] * 1e3:.0f} tokens/s; SGD update "
              f"{t_sgd:.2f} ms; peak memory "
              f"{peak:.2f} GiB; launches {short(launches)}; gradients of "
              f"{len(params)} leaves "
              f"{'finite' if not bad else 'NOT finite: ' + str(bad[:3])}; "
              f"{card}")
        if launches != want:
            raise AssertionError(f"training launch counts {launches} != "
                                 f"{want}")
        if bad or loss != loss:
            raise AssertionError("training produced non-finite values")
        losses.append(loss)
    print(f"[training path] loss over {TRAIN_STEPS} steps: "
          + " -> ".join(f"{x:.6f}" for x in losses)
          + (" (falls)" if losses[-1] < losses[0] else " (DOES NOT FALL)"))
    if not losses[-1] < losses[0]:
        raise AssertionError("the training loss does not fall")

    def step():
        model.zero_grad(set_to_none=True)
        last_position_loss(model, ids, targets).backward()
        sgd_step(params, TRAIN_LR)

    profile_phase("training step (forward, backward, SGD)", step, card,
                  top=14)
    profile_phase("training forward+backward", lambda: last_position_loss(
        model, ids, targets).backward(), card, top=14)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch import (
        Engine, ModelConfig, Qwen3, is_hopper)
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels.flash_attention import (
        _launch_bwd, flash_attention, flash_attention_backward,
        flash_attention_backward_reference, flash_attention_reference)
    from triton_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode, flash_decode_paged, flash_decode_paged_reference,
        flash_decode_reference, gather_pages, quantize_kv)
    from triton_distributed_tpu_torch.kernels.quantized import (
        matmul_w8a8, matmul_w8a8_reference, quantize_sym)
    from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP, mlp_w8a8
    from triton_distributed_tpu_torch.serving import (
        DEFAULT_PREFILL_BUCKETS, ContinuousBatchingScheduler, Request,
        RequestState, SchedulerConfig)
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

    errs = dict.fromkeys(KERNELS, 0.0)
    fa_cases = [
        ("prefill 4x32x512x128 causal", 4, 32, 8, 512, 512, True, 0),
        ("bucket 2048 1x32x2048x128 causal", 1, 32, 8, 2048, 2048, True, 0),
        ("ragged Sq=Sk=300 causal", 2, 8, 2, 300, 300, True, 0),
        ("kv_offset=128 Sq=128 Sk=256", 2, 8, 4, 128, 256, True, 128),
        ("non-causal Sq=200 Sk=333", 2, 8, 8, 200, 333, False, 0),
    ]
    fa_timed = []
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
        fa_timed.append((label, q, k, v, causal, off))

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

    def paged_case(label, q, kp, vp, table, kv_len):
        out, lse = flash_decode_paged(q, kp, vp, table, kv_len)
        ref, ref_lse = flash_decode_paged_reference(
            q.float(), kp.float(), vp.float(), table, kv_len)
        torch.cuda.synchronize()
        e = check_close(f"flash_decode_paged {label} out", out, ref, 1e-2,
                        1e-2)
        check_close(f"flash_decode_paged {label} lse", lse, ref_lse, 1e-3,
                    0.0)
        errs["flash_decode_paged"] = max(errs["flash_decode_paged"], e)
        return out, lse

    # K3 at the scheduler path's decode state: 8 rows, 36 layers of pools,
    # each row's pages shuffled over the pool, the null page (and every
    # page past a row's length) holding 1e4 so a stray read would show.
    k3_len = torch.tensor(K3_KV_LEN, dtype=torch.int32, device=dev)
    k3_table, k3_pages = shuffled_table(gen, K3_KV_LEN, PAGE, MAX_SEQ // PAGE,
                                        dev)
    k3_pools = []
    for _ in range(36):
        kp, vp = (randn(k3_pages, 8, PAGE, 128) for _ in range(2))
        kp[0] = vp[0] = 1e4
        k3_pools.append((kp, vp))
    k3_q = randn(SLOTS, 32, 128)
    paged_case(f"q 8x32x128, pool {k3_pages}x8x16x128 (shuffled pages, "
               f"null page 1e4), kv_len={list(K3_KV_LEN)}", k3_q,
               *k3_pools[0], k3_table, k3_len)
    # Page sizes 16 and 24 (not a power of two), each bit for bit against
    # the dense kernel over the same logical K/V.
    kc, vc = randn(SLOTS, 8, MAX_SEQ, 128), randn(SLOTS, 8, MAX_SEQ, 128)
    dense = flash_decode(k3_q, kc, vc, k3_len)
    for ps in (PAGE, 24):
        table, pages = shuffled_table(gen, K3_KV_LEN, ps, -(-MAX_SEQ // ps),
                                      dev)
        kp = scatter_to_pool(kc, table, pages, ps, 1e4)
        vp = scatter_to_pool(vc, table, pages, ps, -1e4)
        got = paged_case(f"page_size {ps}, dense 8x8x2048x128 scattered",
                         k3_q, kp, vp, table, k3_len)
        same = all(torch.equal(a, b) for a, b in zip(got, dense))
        print(f"  flash_decode_paged page_size {ps} vs flash_decode on the "
              f"same logical K/V: out and lse {'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("paged decode differs from dense decode")
    del kc, vc, kp, vp, dense

    # K2q and K3q: the same two kernels over an int8 cache with per-token
    # scales, out atol=rtol=1e-2 and lse 1e-3 as above.  Scales past each
    # row's length are NaN (a reused slot's may be stale), as are the null
    # page's and every unmapped page's, with codes of 127.
    def int8_cache(*shape, kv_len):
        k_q, v_q, ks, vs = quantize_kv(randn(*shape), randn(*shape))
        past = (torch.arange(shape[2], device=dev)[None, :]
                >= kv_len[:, None])[:, None, :].expand_as(ks)
        ks[past] = float("nan")
        vs[past] = float("nan")
        return k_q, v_q, ks, vs

    def int8_case(name, label, got, ref):
        torch.cuda.synchronize()
        e = check_close(f"{name} {label} out", got[0], ref[0], 1e-2, 1e-2)
        check_close(f"{name} {label} lse", got[1], ref[1], 1e-3, 0.0)
        if not bool(got[0].isfinite().all()):
            raise AssertionError(f"{name} {label}: non-finite out")
        errs[name] = max(errs[name], e)
        return got

    k2q_len = torch.tensor([1, 513, 700, 1024], dtype=torch.int32,
                           device=dev)
    kq, vq, ksq, vsq = int8_cache(BATCH, 8, CACHE_SEQ, 128, kv_len=k2q_len)
    q = randn(BATCH, 32, 128)
    int8_case("flash_decode_int8",
              "q 4x32x128, int8 cache 4x8x1024x128, kv_len=[1,513,700,1024], "
              "NaN scales past kv_len",
              flash_decode(q, kq, vq, k2q_len, k_scale=ksq, v_scale=vsq),
              flash_decode_reference(q.float(), kq, vq, k2q_len,
                                     k_scale=ksq, v_scale=vsq))
    del kq, vq, ksq, vsq

    # K3q at K3's main-path state: 36 layers of int8 pools over the same
    # shuffled table; then bit for bit against K2q at page sizes 16, 24.
    k3q_pools = []
    for _ in range(36):
        kp, vp = (quantize_sym(randn(k3_pages, 8, PAGE, 128), 3)
                  for _ in range(2))
        for code, sc in (kp, vp):
            code[0] = 127
            sc[0] = float("nan")
        k3q_pools.append((kp[0], vp[0], kp[1], vp[1]))
    int8_case("flash_decode_paged_int8",
              f"q 8x32x128, int8 pool {k3_pages}x8x16x128 (shuffled pages, "
              f"null page codes 127, scales NaN), kv_len={list(K3_KV_LEN)}",
              flash_decode_paged(k3_q, *k3q_pools[0][:2], k3_table, k3_len,
                                 k_scale=k3q_pools[0][2],
                                 v_scale=k3q_pools[0][3]),
              flash_decode_paged_reference(
                  k3_q.float(), *k3q_pools[0][:2], k3_table, k3_len,
                  k_scale=k3q_pools[0][2], v_scale=k3q_pools[0][3]))
    kq, vq, ksq, vsq = int8_cache(SLOTS, 8, MAX_SEQ, 128, kv_len=k3_len)
    dense = flash_decode(k3_q, kq, vq, k3_len, k_scale=ksq, v_scale=vsq)
    for ps in (PAGE, 24):
        table, pages = shuffled_table(gen, K3_KV_LEN, ps, -(-MAX_SEQ // ps),
                                      dev)
        pools = [scatter_to_pool(t, table, pages, ps, fill)
                 for t, fill in ((kq, 127), (vq, 127),
                                 (ksq, float("nan")), (vsq, float("nan")))]
        got = int8_case(
            "flash_decode_paged_int8",
            f"page_size {ps}, int8 dense 8x8x2048x128 scattered",
            flash_decode_paged(k3_q, *pools[:2], table, k3_len,
                               k_scale=pools[2], v_scale=pools[3]),
            flash_decode_paged_reference(k3_q.float(), *pools[:2], table,
                                         k3_len, k_scale=pools[2],
                                         v_scale=pools[3]))
        same = all(torch.equal(a, b) for a, b in zip(got, dense))
        print(f"  flash_decode_paged_int8 page_size {ps} vs flash_decode_int8 "
              f"on the same logical codes and scales: out and lse "
              f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("int8 paged decode differs from int8 dense "
                                 "decode")
    del kq, vq, ksq, vsq, dense, pools

    # K7 at the Qwen3-8B MLP shapes: activations quantized per row from
    # bf16, weights per output channel from N(0, 1/hidden) bf16 draws.
    # Against the exact plain version: f32 out bit-identical, bf16 out
    # equal after the cast (int32 accumulation is exact and the epilogue
    # multiplies in the same order).
    w8 = {}
    for nm, (k, n) in (("gate_up", (MLP_HIDDEN, 2 * MLP_FFN)),
                       ("down", (MLP_FFN, MLP_HIDDEN))):
        w8[nm] = quantize_sym(randn(k, n) * k ** -0.5, 0)
    w8_rows = {}
    for m in W8A8_ROWS + (37,):
        for nm, (b_q, sb) in w8.items():
            a_q, sa = quantize_sym(randn(m, b_q.shape[0]), 1)
            w8_rows[(m, nm)] = (a_q, b_q, sa, sb)
            for out_dtype in (torch.float32, torch.bfloat16):
                got = matmul_w8a8(a_q, b_q, sa, sb, out_dtype=out_dtype)
                want = matmul_w8a8_reference(a_q, b_q, sa, sb,
                                             out_dtype=out_dtype)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                print(f"  matmul_w8a8 {nm} ({m}x{b_q.shape[0]})@"
                      f"({b_q.shape[0]}x{b_q.shape[1]}) out {out_dtype}: "
                      f"{'bit-identical' if same else 'DIFFER'} to the exact "
                      "plain version")
                if not same:
                    raise AssertionError("matmul_w8a8 differs from its plain "
                                         "version")

    # K4 (dq) and K5 (dk, dv): the flash backward on K1's out and lse and a
    # random cotangent, against the plain version on the same inputs, held
    # row by row (`check_rows`; under the causal mask dk and dv shrink
    # along the keys, so a bound on the tensor's maximum is loose for late
    # keys): tol 2e-2, rel_l2 1e-2 and floor 0.1 in bf16 (p and ds are
    # rounded to bf16 before their products, as in the TPU kernels, and
    # the outputs to bf16; the kernels need about 8.5e-3 and 2.4e-3); 1e-4,
    # 1e-5 and floor 1 in f32 (a zero row's cancelled ds is off by the f32
    # rounding of dp, about 1e-5 of rms(dq)).
    print("[kernels vs plain] flash backward: |err| <= tol * (|ref| + "
          "rms_row(ref) + floor * rms(ref)) and rel_l2 bound; bf16 tol "
          "2e-2, rel_l2 1e-2, floor 0.1; f32 tol 1e-4, rel_l2 1e-5, floor 1")

    def bwd_case(label, dtype, b, h, hkv, sq, sk, off):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype)
                       for shape in ((b, h, sq, 128), (b, hkv, sk, 128),
                                     (b, hkv, sk, 128), (b, h, sq, 128)))
        out, lse = flash_attention(q, k, v, kv_offset=off, return_lse=True)
        got = flash_attention_backward(q, k, v, out, lse, do, kv_offset=off)
        ref = flash_attention_backward_reference(
            q.float(), k.float(), v.float(), out.float(), lse, do.float(),
            kv_offset=off)
        torch.cuda.synchronize()
        tols = (2e-2, 1e-2, 0.1) if dtype == torch.bfloat16 else (1e-4, 1e-5,
                                                                  1.0)
        for nm, key, g_, r_ in zip(("dq", "dk", "dv"),
                                   ("flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv",
                                    "flash_attention_bwd_dkv"), got, ref):
            if not bool(g_.isfinite().all()):
                raise AssertionError(f"flash backward {label} {nm}: "
                                     "non-finite")
            e = check_rows(f"flash_attention_backward {label} {nm}", g_, r_,
                           *tols)
            errs[key] = max(errs[key], e)
        return q, k, v, out, lse, do

    bwd_timed = [
        ("4x32/8x512x128", bwd_case("training 4x32/8x512x128 causal bf16",
                                    torch.bfloat16, 4, 32, 8, 512, 512, 0)),
        ("1x32/8x2048x128", bwd_case("bucket 1x32/8x2048x128 causal bf16",
                                     torch.bfloat16, 1, 32, 8, 2048, 2048,
                                     0)),
    ]
    bwd_case("ragged Sq=Sk=300 causal f32", torch.float32, 2, 8, 2, 300, 300,
             0)
    bwd_case("kv_offset=-70 Sq=Sk=200 causal f32 (rows 0-69 fully masked)",
             torch.float32, 1, 8, 2, 200, 200, -70)

    # -- 4. Engine path -------------------------------------------------
    cfg = ModelConfig.qwen3_8b()
    t0 = time.perf_counter()
    wgen = torch.Generator(device=dev).manual_seed(0)
    model = Qwen3(cfg).init_params(wgen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[engine path] Qwen3-8B: {cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {n_params / 1e9:.3f} B parameters, "
          f"{cfg.dtype}; random weights (seed 0) in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = Engine(model)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=wgen, device=dev)
    cache = model.create_cache(BATCH, max_seq=CACHE_SEQ)

    wrappers = {"flash_attention": flash_attention,
                "flash_decode": flash_decode,
                "flash_decode_paged": flash_decode_paged,
                "matmul_w8a8": matmul_w8a8,
                "flash_attention_bwd": flash_attention_backward}
    total_launches = dict.fromkeys(KERNELS, 0)

    def counted(fn):
        """Run ``fn`` with every kernel's launch count set to 0 just before
        it, add the counts read just after to the totals of the main
        paths, and return them."""
        for lib, attr, _ in KERNELS.values():
            setattr(wrappers[lib], attr, 0)
        fn()
        got = {nm: getattr(wrappers[lib], attr)
               for nm, (lib, attr, _) in KERNELS.items()}
        for nm, n in got.items():
            total_launches[nm] += n
        return got

    def expect(**nonzero):
        return {nm: nonzero.get(nm, 0) for nm in KERNELS}

    def short(counts):
        return {nm: n for nm, n in counts.items() if n}

    served = []
    t_serve = []
    launches = counted(lambda: t_serve.append(wall_ms(lambda: served.append(
        engine.serve(prompts, GEN_LEN, cache=cache)))))
    print(f"[engine path] Engine.serve {BATCH} requests x {PROMPT} prompt "
          f"tokens, gen_len {GEN_LEN}, greedy: {t_serve[0]:.1f} ms (first "
          f"call); launches {short(launches)}")
    want = expect(flash_attention=cfg.num_layers,
                  flash_decode=cfg.num_layers * (GEN_LEN - 1))
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
        print(f"[engine path] teacher forcing, decode@{PROMPT} vs prefill of "
              f"{PROMPT + 1} tokens: rel_l2={tf_err:.3e} (max_abs "
              f"{float((logits_d - logits_f).abs().max()):.3e}, max|logit| "
              f"{float(logits_f.abs().max()):.3f}, argmax agreement "
              f"{agree:.2f}); bf16 error of the prefill against f32 "
              f"weights and activations: rel_l2={floor:.3e}, decode against "
              f"f32: {rel_l2(logits_d, logits_x):.3e}; tolerance "
              f"{3 * floor:.3e} (3x the bf16 error)")
        if not tf_err <= 3 * floor:
            raise AssertionError("teacher-forcing logits disagree")

    # -- 4b. int8 Engine path -------------------------------------------
    # The same weights (shared, not copied) behind an int8 KV cache.
    cfg_q = dataclasses.replace(cfg, quantize_kv_cache=True)
    model_q = Qwen3(cfg_q)
    model_q.load_state_dict(model.state_dict(), assign=True)
    engine_q = Engine(model_q)
    cache_q = model_q.create_cache(BATCH, max_seq=CACHE_SEQ)
    served_q, t_serve = [], []
    launches = counted(lambda: t_serve.append(wall_ms(lambda: served_q.append(
        engine_q.serve(prompts, GEN_LEN, cache=cache_q)))))
    tokens_q = served_q[0]
    print(f"[engine path int8] Engine.serve, int8 KV cache, the same "
          f"{BATCH} x {PROMPT} prompts, gen_len {GEN_LEN}: {t_serve[0]:.1f} "
          f"ms (first call); launches {short(launches)}; tokens equal to the "
          f"float run's: {int((tokens_q == tokens).sum())} of "
          f"{tokens.numel()}")
    want = expect(flash_attention=cfg.num_layers,
                  flash_decode_int8=cfg.num_layers * (GEN_LEN - 1))
    if launches != want:
        raise AssertionError(f"int8 launch counts {launches} != {want}")
    if tokens_q.shape != (BATCH, GEN_LEN) or not bool(
            ((tokens_q >= 0) & (tokens_q < cfg.vocab_size)).all()):
        raise AssertionError("int8 tokens: bad shape or outside the "
                             "vocabulary")
    bytes_q = cache_q.bytes_per_slot() // CACHE_SEQ
    bytes_f = cache.bytes_per_slot() // CACHE_SEQ
    nl, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    print(f"[engine path int8] KV cache bytes per token: int8 {bytes_q} = "
          f"{nl} layers x 2 (K, V) x {hkv} heads x ({hd} B of codes + 4 B "
          f"of scale); bf16 {bytes_f} = {nl} x 2 x {hkv} x {hd} x 2 B")
    if (bytes_q != nl * 2 * hkv * (hd + 4)
            or bytes_f != nl * 2 * hkv * hd * 2):
        raise AssertionError("cache bytes per token")
    with torch.inference_mode():
        # Prefill never reads the cache: logits equal the float model's bit
        # for bit.  Then 3 decode steps fed the float run's tokens against
        # the float cache's.  Through 36 layers of random bf16 weights a
        # perturbation grows as phase 4's bf16 error does, so the int8
        # cache's logits are held as phase 4 holds teacher forcing: rel_l2
        # within 3x this run's bf16 error (`floor`).  The JAX test's
        # tolerance for its 2-layer f32 model (0.03 max|logits| + 0.05
        # |logit|, tests/test_model_e2e.py) is counted, not held.  Step 0
        # is also held against phase 4's f32 logits of the same position.
        cf = model.create_cache(BATCH, max_seq=CACHE_SEQ)
        lf = model.prefill(prompts, cf)
        lq = model_q.prefill(prompts, cache_q)
        if not torch.equal(lf, lq):
            raise AssertionError("int8-cache prefill logits differ from the "
                                 "float model's")
        print("[engine path int8] prefill logits: bit-identical to the float "
              "model's")
        for step in range(3):
            lf = model.decode(tokens[:, step], cf)
            lq = model_q.decode(tokens[:, step], cache_q)
            err = (lq - lf).abs()
            beyond = int((err > 0.03 * float(lf.abs().max())
                          + 0.05 * lf.abs()).sum())
            rel = rel_l2(lq, lf)
            ok = rel <= 3 * floor
            if step == 0:
                exact_rel = rel_l2(lq, logits_x)
                ok = ok and exact_rel <= 3 * floor
            print(f"[engine path int8] decode step {step} (float run's "
                  f"tokens): against the float cache's logits rel_l2 "
                  f"{rel:.3e} (tolerance {3 * floor:.3e}, 3x the bf16 error), "
                  f"max_abs_err {float(err.max()):.4f} (max|logit| "
                  f"{float(lf.abs().max()):.3f}; {beyond} of {err.numel()} "
                  f"beyond 0.03 max|logits| + 0.05|logit|), argmax agreement "
                  f"{float((lq.argmax(-1) == lf.argmax(-1)).float().mean()):.2f}"
                  + (f"; against the f32 logits rel_l2 {exact_rel:.3e} (the "
                     f"float cache's {rel_l2(lf, logits_x):.3e})"
                     if step == 0 else "") + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("int8-cache decode logits disagree")
        del cf, logits_x

    # -- 5. scheduler path ---------------------------------------------
    traffic = scheduler_traffic(cfg.vocab_size, seed=1)
    base = dict(num_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                prefill_buckets=DEFAULT_PREFILL_BUCKETS, temperature=0.0)
    kv_per_token = 2 * nl * cfg.num_kv_heads * cfg.head_dim * 2
    print(f"[scheduler path] {len(traffic)} requests: {len(SHARED_TOTALS)} "
          f"share a {SYS_PREFIX}-token prefix (totals {SHARED_TOTALS}), "
          f"unique prompts {UNIQUE_LENS}; max_new_tokens cycling "
          f"{MAX_NEW_CYCLE}; {SLOTS} slots x {MAX_SEQ} positions, pages of "
          f"{PAGE}; KV {kv_per_token} B per token bf16, {bytes_q} int8, "
          "greedy")
    runs, kept = {}, {}
    for label, mdl, extra in (
            ("slots", model, dict(kv_layout="slots")),
            ("paged", model, dict(kv_layout="paged")),
            ("paged-200", model, dict(kv_layout="paged",
                                      num_pages=TIGHT_PAGES)),
            ("int8 slots", model_q, dict(kv_layout="slots")),
            ("int8 paged", model_q, dict(kv_layout="paged"))):
        sched = ContinuousBatchingScheduler(mdl,
                                            SchedulerConfig(**base, **extra))
        torch.cuda.reset_peak_memory_stats()
        out = []
        got = counted(lambda: out.extend(drive_scheduler(
            sched, traffic, Request, RequestState.QUEUED)))
        reqs, rec = out
        steps = rec["steps"]
        n_decode = sum(1 for _, _, dec in steps if dec)
        n_prefill = len(traffic) + sum(r.preemptions for r in reqs)
        dec = ("flash_decode" if extra["kv_layout"] == "slots"
               else "flash_decode_paged") + ("_int8" if mdl is model_q else "")
        want = expect(flash_attention=nl * n_prefill, **{dec: nl * n_decode})
        pure = sorted(ms for ms, adm, dec in steps if dec and not adm)
        step_ms = pure[len(pure) // 2]
        adm_ms = sum(ms for ms, adm, _ in steps if adm) - step_ms * sum(
            1 for _, adm, dec in steps if adm and dec)
        n_gen = sum(len(r.generated) for r in reqs)
        hits = (sched.slots.radix.hit_tokens
                if extra["kv_layout"] == "paged" else 0)
        print(f"[scheduler path] {label}: run {rec['wall_ms']:.1f} ms "
              f"(host clock), {n_gen} tokens generated "
              f"({n_gen / rec['wall_ms'] * 1e3:.1f} tokens/s), "
              f"{rec['prompt_tokens']} prompt tokens prefilled at admission "
              f"({rec['prompt_tokens'] / adm_ms * 1e3:.0f} tokens/s over "
              f"{adm_ms:.1f} ms: admitting steps less one decode step "
              f"each), {n_decode} decode steps at {step_ms:.2f} ms/step "
              f"(median host time of the steps that admit nothing), "
              f"{n_prefill} prefills, preemptions "
              f"{sum(r.preemptions for r in reqs)}, prefix hits {hits} "
              f"tokens, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {short(got)}; {card}")
        if got != want:
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        for i, r in enumerate(reqs):
            if (r.finish_reason is None or r.finish_reason.value != "length"
                    or len(r.generated) != r.max_new_tokens):
                raise AssertionError(f"{label}: request {i} finished "
                                     f"{r.finish_reason} with "
                                     f"{len(r.generated)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r.generated):
                raise AssertionError(f"{label}: request {i} left the "
                                     "vocabulary")
        runs[label] = (reqs, rec)
        if label != "paged-200":
            kept[label] = sched         # for the steady-state phase 8
        del sched

    for q8 in ("", "int8 "):
        slot_tokens = [r.generated for r in runs[q8 + "slots"][0]]
        paged_tokens = [r.generated for r in runs[q8 + "paged"][0]]
        for i, (a, b) in enumerate(zip(slot_tokens, paged_tokens)):
            if a != b:
                j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
                raise AssertionError(f"{q8}slots and paged differ: request "
                                     f"{i} at token {j}: {a[j]} != {b[j]}")
        print(f"[scheduler path] {q8}slots and {q8}paged runs: equal tokens "
              f"for all {len(slot_tokens)} requests")
        hits = kept[q8 + "paged"].slots.radix.hit_tokens
        if hits < (len(SHARED_TOTALS) - 1) * SYS_PREFIX:
            raise AssertionError(f"{q8}prefix hits {hits} < "
                                 f"{(len(SHARED_TOTALS) - 1) * SYS_PREFIX}")
    float_tokens = [r.generated for r in runs["paged"][0]]
    print(f"[scheduler path] int8 against float cache: "
          f"{sum(a == b for a, b in zip(paged_tokens, float_tokens))} of "
          f"{len(float_tokens)} requests with equal tokens, "
          f"{sum(x == y for a, b in zip(paged_tokens, float_tokens) for x, y in zip(a, b))}"
          f" of {sum(len(b) for b in float_tokens)} tokens equal position "
          "by position")
    paged_tokens = float_tokens
    tight, tight_rec = runs["paged-200"]
    if not tight_rec["first_preempt"]:
        raise AssertionError("the 200-page run never preempted")
    for i, n in sorted(tight_rec["first_preempt"].items()):
        a, b = tight[i].generated[:n], paged_tokens[i][:n]
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            raise AssertionError(f"preempted request {i} differs from the "
                                 f"paged run before its preemption, at "
                                 f"token {j}: {a[j]} != {b[j]}")
    print(f"[scheduler path] paged-200: preempted requests "
          f"{sorted(tight_rec['first_preempt'])}, tokens before the first "
          f"preemption equal the paged run's "
          f"({sorted(tight_rec['first_preempt'].values())} tokens); after "
          f"it, resumes re-prefill prompt + generated (bf16 rounding differs "
          f"from decode-written K/V), equal tokens "
          f"{sum(a.generated == b for a, b in zip(tight, paged_tokens))} of "
          f"{len(tight)}")
    del runs

    # -- 6. W8A8 layer path --------------------------------------------
    # TPMLP at Qwen3-8B's widths, bf16: the xla layer on float weights
    # (N(0, 1/hidden), seed 3) and the w8a8 layer on their quantization.
    mlp_f = TPMLP(MLP_HIDDEN, MLP_FFN, mode="xla", device=dev)
    mlp_f.init_params(torch.Generator(device=dev).manual_seed(3))
    mlp_q = TPMLP(MLP_HIDDEN, MLP_FFN, mode="w8a8", device=dev)
    mlp_q.load_quantized(TPMLP.quantize_params(
        {"gate_up": mlp_f.gate_up, "down": mlp_f.down}))
    qparams = [mlp_q.gate_up_q, mlp_q.gate_up_scale, mlp_q.down_q,
               mlp_q.down_scale]
    mlp_x = {}
    with torch.inference_mode():
        for m in W8A8_ROWS:
            x = randn(m, MLP_HIDDEN)
            mlp_x[m] = x
            out = []
            launches = counted(lambda: out.append(mlp_q(x)))
            plain = mlp_w8a8(x, *qparams, matmul=matmul_w8a8_reference)
            ref = mlp_f(x)
            torch.cuda.synchronize()
            same = torch.equal(out[0], plain)
            # Against the bf16 layer: the int8 error is set by the per-row
            # quantization of h (12288 heavy-tailed values a row, a step of
            # max|h_row| / 127), about 3.5% relative L2 at these widths on
            # the CPU; held to 5%.  The elements beyond the JAX test's
            # tolerance at its 128/256 widths (0.015 max|ref| + 0.05|ref|,
            # tests/test_layers.py) are counted, not held.
            err = (out[0].float() - ref.float()).abs()
            rmax = float(ref.float().abs().max())
            beyond = int((err > 0.015 * rmax + 0.05 * ref.float().abs()).sum())
            rel = float((out[0].float() - ref.float()).norm()
                        / ref.float().norm())
            ok = rel <= 0.05
            print(f"[w8a8 layer] TPMLP({MLP_HIDDEN}, {MLP_FFN}, "
                  f"mode='w8a8') on {m} rows: launches {short(launches)}; "
                  f"{'bit-identical' if same else 'DIFFERS'} to its plain "
                  f"version; against the bf16 xla layer on the float weights "
                  f"rel_l2 {rel:.3e} (held to 5e-2), max_abs_err "
                  f"{float(err.max()):.4e} = {float(err.max()) / rmax:.4f} "
                  f"max|ref|, {beyond} of {err.numel()} elements beyond "
                  f"0.015 max|ref| + 0.05|ref| {'ok' if ok else 'FAIL'}")
            if launches != expect(matmul_w8a8=2):
                raise AssertionError(f"w8a8 launch counts {launches}")
            if not same or not ok:
                raise AssertionError("w8a8 layer disagrees")

    # -- 7. times -------------------------------------------------------
    print(f"[times] card: {card}; CUDA events, mean over back-to-back "
          "calls after warm-up")
    records = []

    def attention_times(q, k, v, causal, off, reps):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        out = flash_attention(q, k, v, causal=causal, kv_offset=off)
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                             kv_offset=off), reps)
        plain = time_ms(lambda: flash_attention_reference(
            q, k, v, causal=causal, kv_offset=off), 3)
        if off:
            # SDPA's causal mask is top-left aligned: pass the shifted
            # diagonal as a boolean mask.
            mask = (torch.arange(sk, device=dev)[None, :]
                    <= torch.arange(sq, device=dev)[:, None] + off)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), reps)
        else:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps)
        bms, by = bound(nbytes(q, k, v, out) + b * h * sq * 4,
                        4 * b * h * attention_pairs(sq, sk, causal, off) * d)
        return ms, plain, bms, by, lib

    fa_rows = {}
    for key, idx in (("K1a", 0), ("K1b", 1), ("K1c", 3)):
        label, q, k, v, causal, off = fa_timed[idx]
        fa_rows[key] = (label,) + attention_times(q, k, v, causal, off, 50)
    records.append(("flash_attention",) + fa_rows["K1a"][1:])
    for key, (label, ms, plain, bms, by, lib) in fa_rows.items():
        print(f"[times] flash_attention {key} ({label}): {ms:.4f} ms (bound "
              f"{bms:.4f} ms by {by}, {bms / ms:.1%} of bound), plain "
              f"{plain:.4f} ms, SDPA {lib:.4f} ms; {card}")
    del fa_timed

    # flash_decode at the Engine path's decode state: the cache after the
    # teacher-forcing decode, every row filled to PROMPT + 1 positions.
    # Timed over the 36 layers' caches in turn, as a decode step reads
    # them, so K/V come from device memory and not from the 50 MB L2.
    layers = list(zip(cache.ks, cache.vs))
    kc, vc = layers[0]
    kv_len = cache.offset.clone()
    L = int(kv_len[0])
    qd = randn(BATCH, cfg.num_heads, cfg.head_dim)
    decode_case(f"Engine-path state kv_len={L}", qd, kc, vc, kv_len)
    out, _ = flash_decode(qd, kc, vc, kv_len)
    q4 = qd[:, :, None, :]
    d = cfg.head_dim

    def per_layer_ms(call, layers, reps):
        """Device ms of ``call(*layer)`` per layer, the layers in turn."""
        return time_ms(lambda: [call(*t) for t in layers],
                       reps) / len(layers)

    ms = per_layer_ms(lambda k_, v_: flash_decode(qd, k_, v_, kv_len),
                      layers, 5)
    plain = per_layer_ms(
        lambda k_, v_: flash_decode_reference(qd, k_, v_, kv_len), layers, 1)
    lib = per_layer_ms(lambda k_, v_: F.scaled_dot_product_attention(
        q4, k_[:, :, :L], v_[:, :, :L], enable_gqa=True), layers, 5)
    kv_bytes = 2 * int(kv_len.sum()) * kc.shape[1] * d * kc.element_size()
    bms, by = bound(nbytes(qd, kv_len, out) + kv_bytes
                    + BATCH * cfg.num_heads * 4,
                    4 * cfg.num_heads * d * int(kv_len.sum()))
    records.append(("flash_decode", ms, plain, bms, by, lib))

    # flash_decode_paged at the scheduler path's decode state (phase 3's
    # 36 layers of pools, the same table for every layer as in a decode
    # step).  The SDPA yardstick reads the same K/V gathered beforehand
    # into dense (8, 8, 2048, 128) copies with a length mask; the gather
    # is not timed.
    out, _ = flash_decode_paged(k3_q, *k3_pools[0], k3_table, k3_len)
    ms = per_layer_ms(lambda k_, v_: flash_decode_paged(
        k3_q, k_, v_, k3_table, k3_len), k3_pools, 5)
    plain = per_layer_ms(lambda k_, v_: flash_decode_paged_reference(
        k3_q, k_, v_, k3_table, k3_len), k3_pools, 1)
    dense = [(gather_pages(k_, k3_table), gather_pages(v_, k3_table))
             for k_, v_ in k3_pools]
    mask = (torch.arange(MAX_SEQ, device=dev)[None, :]
            < k3_len[:, None])[:, None, None, :]
    q4 = k3_q[:, :, None, :]
    lib = per_layer_ms(lambda k_, v_: F.scaled_dot_product_attention(
        q4, k_, v_, attn_mask=mask, enable_gqa=True), dense, 5)
    del dense
    n_pos = int(k3_len.sum())
    n_pages = sum(-(-n // PAGE) for n in K3_KV_LEN)
    kv_bytes = 2 * n_pos * 8 * d * 2
    bms, by = bound(nbytes(k3_q, k3_len, out) + kv_bytes + SLOTS * 32 * 4
                    + 4 * n_pages, 4 * 32 * d * n_pos)
    records.append(("flash_decode_paged", ms, plain, bms, by, lib))
    del k3_pools

    # K2q at the int8 Engine path's decode state, the same kv_len and q as
    # K2 above: codes and scales from the int8 prefill and decode.  The SDPA
    # yardstick reads bf16 copies dequantized beforehand (not timed).
    layers_q = [cache_q.layer(i) for i in range(cfg.num_layers)]
    kq, vq, ksq, vsq = layers_q[0]
    out, _ = int8_case(
        "flash_decode_int8", f"int8 Engine-path state kv_len={L}",
        flash_decode(qd, kq, vq, kv_len, k_scale=ksq, v_scale=vsq),
        flash_decode_reference(qd.float(), kq, vq, kv_len, k_scale=ksq,
                               v_scale=vsq))

    ms = per_layer_ms(lambda k_, v_, ks_, vs_: flash_decode(
        qd, k_, v_, kv_len, k_scale=ks_, v_scale=vs_), layers_q, 5)
    plain = per_layer_ms(lambda k_, v_, ks_, vs_: flash_decode_reference(
        qd, k_, v_, kv_len, k_scale=ks_, v_scale=vs_), layers_q, 1)
    dq = [tuple((c[:, :, :L].float() * sc[:, :, :L, None]).to(torch.bfloat16)
                for c, sc in ((k_, ks_), (v_, vs_)))
          for k_, v_, ks_, vs_ in layers_q]
    q4 = qd[:, :, None, :]
    lib = per_layer_ms(lambda k_, v_: F.scaled_dot_product_attention(
        q4, k_, v_, enable_gqa=True), dq, 5)
    del dq
    n_pos = int(kv_len.sum())
    bms, by = bound(nbytes(qd, kv_len, out) + 2 * n_pos * 8 * d
                    + 2 * n_pos * 8 * 4 + BATCH * cfg.num_heads * 4,
                    4 * cfg.num_heads * d * n_pos)
    records.append(("flash_decode_int8", ms, plain, bms, by, lib))

    # K3q at the scheduler path's decode state: phase 3's 36 layers of int8
    # pools over K3's table; SDPA over dense bf16 copies gathered and
    # dequantized beforehand (not timed), with the length mask.
    out, _ = flash_decode_paged(k3_q, *k3q_pools[0][:2], k3_table, k3_len,
                                k_scale=k3q_pools[0][2],
                                v_scale=k3q_pools[0][3])
    ms = per_layer_ms(lambda k_, v_, ks_, vs_: flash_decode_paged(
        k3_q, k_, v_, k3_table, k3_len, k_scale=ks_, v_scale=vs_),
        k3q_pools, 5)
    plain = per_layer_ms(lambda k_, v_, ks_, vs_: flash_decode_paged_reference(
        k3_q, k_, v_, k3_table, k3_len, k_scale=ks_, v_scale=vs_),
        k3q_pools, 1)
    dq = [tuple((gather_pages(c, k3_table).float()
                 * gather_pages(sc, k3_table).nan_to_num()[..., None])
                .to(torch.bfloat16) for c, sc in ((k_, ks_), (v_, vs_)))
          for k_, v_, ks_, vs_ in k3q_pools]
    q4 = k3_q[:, :, None, :]
    lib = per_layer_ms(lambda k_, v_: F.scaled_dot_product_attention(
        q4, k_, v_, attn_mask=mask, enable_gqa=True), dq, 5)
    del dq
    n_pos = int(k3_len.sum())
    bms, by = bound(nbytes(k3_q, k3_len, out) + 2 * n_pos * 8 * d
                    + 2 * n_pos * 8 * 4 + SLOTS * 32 * 4 + 4 * n_pages,
                    4 * 32 * d * n_pos)
    records.append(("flash_decode_paged_int8", ms, plain, bms, by, lib))
    del k3q_pools

    # K7 at the W8A8 layer path's shapes (its 2048 and 8 rows, gate_up out
    # bf16 and down out f32, as the layer calls it).  Yardstick: one
    # torch._int_mm (cuBLASLt int8) plus the same epilogue; _int_mm takes
    # more than 16 rows, so the 8-row calls are padded to 32 (the pad made
    # beforehand, not timed).  The record is gate_up at 2048 rows.
    k7_rows = {}
    for m in W8A8_ROWS:
        for nm, out_dtype in (("gate_up", torch.bfloat16),
                              ("down", torch.float32)):
            a_q, b_q, sa, sb = w8_rows[(m, nm)]
            kk, n = b_q.shape
            ms = time_ms(lambda: matmul_w8a8(a_q, b_q, sa, sb,
                                             out_dtype=out_dtype), 20)
            plain = time_ms(lambda: matmul_w8a8_reference(
                a_q, b_q, sa, sb, out_dtype=out_dtype), 2, warmup=1)
            mp = max(m, 32)
            a_p = torch.zeros((mp, kk), dtype=torch.int8, device=dev)
            a_p[:m] = a_q
            sa_p = torch.ones(mp, device=dev)
            sa_p[:m] = sa
            lib = time_ms(lambda: (torch._int_mm(a_p, b_q).float()
                                   * sa_p[:, None] * sb[None, :]
                                   ).to(out_dtype), 20)
            bms, by = bound(m * kk + kk * n + 4 * (m + n)
                            + m * n * torch.finfo(out_dtype).bits // 8,
                            2 * m * n * kk, PEAK_INT8_OPS)
            k7_rows[(m, nm)] = (ms, plain, bms, by, lib)
            print(f"[times] matmul_w8a8 {nm} ({m}x{kk})@({kk}x{n}) out "
                  f"{out_dtype}: {ms:.4f} ms ({2 * m * n * kk / ms / 1e9:.1f}"
                  f" TOP/s; bound {bms:.4f} ms by {by}, {bms / ms:.1%} of "
                  f"bound), plain (float64) {plain:.4f} ms, _int_mm"
                  f"{' on 32 padded rows' if mp != m else ''} + epilogue "
                  f"{lib:.4f} ms; {card}")
    records.append(("matmul_w8a8",) + k7_rows[(2048, "gate_up")])
    with torch.inference_mode():
        for m, x in mlp_x.items():
            print(f"[times] TPMLP w8a8 layer on {m} rows: "
                  f"{time_ms(lambda: mlp_q(x), 10):.4f} ms, bf16 xla layer "
                  f"(cuBLAS) {time_ms(lambda: mlp_f(x), 10):.4f} ms; {card}")
    del mlp_f, mlp_q, qparams, w8, w8_rows

    # K4 (with its delta prologue) and K5 (reading K4's delta) each alone,
    # and the wrapper's pair, at both training shapes.  The plain version
    # and the yardstick, SDPA's backward (causal, GQA; its forward run
    # beforehand), compute dq, dk and dv together, so the records of K4 and
    # K5 carry the pair's time beside them and say so.  The record is the
    # 4x512 shape.
    for label, (q, k, v, out, lse, do) in bwd_timed:
        b, h, sq, d = q.shape
        sk = k.shape[2]
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        k4 = time_ms(lambda: _launch_bwd(
            "dq", (q, k, v, do, out, lse, None, delta, dq), True, 0,
            d ** -0.5), 20)
        k5 = time_ms(lambda: _launch_bwd(
            "dkv", (q, k, v, do, lse, delta, dk, dv), True, 0, d ** -0.5),
            20)
        pair = time_ms(lambda: flash_attention_backward(q, k, v, out, lse,
                                                        do), 20)
        plain = time_ms(lambda: flash_attention_backward_reference(
            q, k, v, out, lse, do), 2, warmup=1)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           enable_gqa=True)
        lib = time_ms(lambda: torch.autograd.grad(o, leaves, do,
                                                  retain_graph=True), 20)
        flops = 2 * b * h * attention_pairs(sq, sk, True, 0) * d
        io = nbytes(q, k, v, do, lse, delta)
        b4, by4 = bound(io + nbytes(out, dq), 3 * flops)
        b5, by5 = bound(io + nbytes(dk, dv), 4 * flops)
        print(f"[times] flash backward {label} causal bf16: K4 (dq) "
              f"{k4:.4f} ms (bound {b4:.4f} ms by {by4}, {b4 / k4:.1%} of "
              f"bound); K5 (dk, dv) {k5:.4f} ms (bound {b5:.4f} ms by {by5}, "
              f"{b5 / k5:.1%} of bound); delta + K4 + K5 {pair:.4f} ms; "
              f"plain {plain:.4f} ms; SDPA backward {lib:.4f} ms; {card}")
        if label.startswith("4x"):
            whole = {"pair_ms": pair, "plain_and_library_compute":
                     "dq, dk and dv together (the whole backward): compare "
                     "them with pair_ms, delta + K4 + K5"}
            records.append(("flash_attention_bwd_dq", k4, plain, b4, by4,
                            lib, whole))
            records.append(("flash_attention_bwd_dkv", k5, plain, b5, by5,
                            lib, whole))
        del o, leaves
    del bwd_timed

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
          f"generated tokens/s); {card}")
    with torch.inference_mode():
        serve1 = sorted(wall_ms(lambda: engine_q.serve(prompts, 1,
                                                       cache=cache_q))
                        for _ in range(3))[1]
        serve_n = sorted(wall_ms(lambda: engine_q.serve(prompts, GEN_LEN,
                                                        cache=cache_q))
                         for _ in range(3))[1]
    step_ms = (serve_n - serve1) / (GEN_LEN - 1)
    print(f"[times] Engine.serve int8 cache (median of 3, host clock): "
          f"prefill+first token {serve1:.2f} ms; decode {step_ms:.3f} "
          f"ms/step ({BATCH / step_ms * 1e3:.1f} tokens/s); whole serve "
          f"{serve_n:.2f} ms; {card}")
    # Float against int8 decode in one call: 8-step windows in the order
    # float, int8, int8, float (host clock around a sync), each from the
    # same state (every row at PROMPT + 1 positions, the first token).
    window = {"float": [], "int8": []}
    with torch.inference_mode():
        for label in ("float", "int8", "int8", "float"):
            mdl, c = (model, cache) if label == "float" else (model_q,
                                                              cache_q)
            c.set_offset(PROMPT + 1)
            mdl.decode(tokens[:, 0], c)
            window[label].append(wall_ms(lambda: [
                mdl.decode(tokens[:, 0], c) for _ in range(8)]) / 8)
    print(f"[times] Engine decode, 4 rows at {PROMPT + 1} positions, host "
          f"ms/step over 8-step windows in the order float, int8, int8, "
          f"float: " + "; ".join(f"{label} {a:.2f}, {b:.2f}" for label, (a, b)
                                 in window.items()) + f"; {card}")

    # -- 8. where the time goes ----------------------------------------
    with torch.inference_mode():
        profile_phase("Engine prefill", lambda: model.prefill(prompts, cache),
                      card)
        profile_phase("Engine decode x8", lambda: [
            model.decode(tokens[:, 0], cache) for _ in range(8)], card)
        cache_q.set_offset(PROMPT + 1)
        profile_phase("Engine int8 decode x8", lambda: [
            model_q.decode(tokens[:, 0], cache_q) for _ in range(8)], card)
    # Steady decode of the four kept schedulers of phase 5 (float and int8,
    # slots and paged) at the same state: the same 8 fresh requests
    # (prompts of 40..512 tokens) fill each one's slots in one admitting
    # step; then 8-step windows on the host clock, two per scheduler in a
    # mirrored order, then one profile of each (a warm-up window and a
    # traced one).  33 decode steps each, below every request's 64 tokens.
    steady = [p[:512] for p, _ in scheduler_traffic(cfg.vocab_size,
                                                    seed=2)[:SLOTS]]
    for sched in kept.values():
        for p in steady:
            sched.submit(Request(prompt=p, max_new_tokens=64))
        sched.step()
    window = {label: [] for label in kept}
    order = list(kept) + list(kept)[::-1]
    for label in order:
        window[label].append(wall_ms(
            lambda: [kept[label].step() for _ in range(8)]) / 8)
    print(f"[profile] scheduler decode, 8 rows, host ms/step over 8-step "
          f"windows in the order {', '.join(order)}: "
          + "; ".join(f"{label} {a:.2f}, {b:.2f}" for label, (a, b)
                      in window.items()) + f"; {card}")
    for label, sched in kept.items():
        profile_phase(f"scheduler {label} x8",
                      lambda: [sched.step() for _ in range(8)], card)

    # -- 9. training path ---------------------------------------------
    # The serving phases are done: free their caches and schedulers, and
    # let the training phase move the weights.
    del kept, sched, cache, cache_q, c, mdl, model_q, engine_q, engine
    del layers, layers_q, kc, vc, kq, vq, ksq, vsq
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[training path] device memory held before training: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (the bf16 "
          f"weights: {n_params * 2 / 2**30:.2f} GiB)")
    train_model_gradients(cfg, dev, card)
    train_steps(model, cfg, prompts, counted, expect, short, dev, card)
    del model

    kernels = []
    for nm, ms, plain, bms, by, lib, *extra in records:
        lib_name, _, repl = KERNELS[nm]
        extra = extra[0] if extra else {}
        pair = (f" (pair {extra['pair_ms']:.4f} ms; plain and library are "
                "the whole backward)" if extra else "")
        print(f"[times] {nm}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, "
              f"{bms / ms:.1%} of bound){pair}, plain {plain:.4f} ms, "
              f"library {lib:.4f} ms; launches on the main paths "
              f"{total_launches[nm]}; {card}")
        kernels.append({"name": nm, "route": "cuda",
                        "source": KERNEL_SOURCES[lib_name],
                        "replaces": repl, "launches": total_launches[nm],
                        "max_abs_err": errs[nm], "ms": ms,
                        "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                        "library_ms": lib, **extra})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
