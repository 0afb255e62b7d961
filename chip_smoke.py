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
   ones over the same logical K/V (float and int8), and each row of K3's
   and K3q's main-path state run alone bit for bit against the same row in
   the batch; the int8 GEMM bit for
   bit against its exact plain version at the Qwen3-8B MLP shapes; the
   flash backward (K4 dq, K5 dk/dv) at the training shapes in bf16 and
   on ragged and negative-offset cases in f32, each output held row by
   row and in relative L2; the grouped GEMM (K8) at the Qwen3-30B-A3B
   expert shapes (prefill and decode buckets) and on ragged and f32
   cases, with the same rows bit for bit inside buckets of 16, 64 and 256
   rows an expert (its two wgmma tiles) and over two launches, and the
   matmul (K6) through ``ag_gemm(method="fused" | "ll")``
   at the Qwen3-8B MLP shape, row by row; the int8 grouped GEMM (K9) bit
   for bit against its exact plain version on `MoEMLP.quantize_params`
   output;
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
   the float weights; then ``ag_gemm(method="fused" | "ll")`` at world 1
   (K6) at 2048 and 8 rows against the "xla" method;
7. times: each kernel, its bound, its plain version and the PyTorch
   library call for the same function, K3 at a capacity 16 times its
   rows' need, the host time of a K3 and of a K8 call, then prefill and
   decode times, int8 against float decode in alternating windows;
8. profile: one traced prefill and eight traced decode steps of the
   Engine path (float and int8), and eight traced scheduler steps of each
   scheduler, with the device's busy share, the kernels that take its
   time and, for the schedulers, the device time a step;
9. TP path: tensor parallelism at world 4, the 4 ranks in one process on
   the one card: K12 (``ag_gemm``) and K14 (``gemm_rs``) against their
   plain versions row by row in both methods at the Qwen3-8B shapes
   (prefill 512 rows a rank, decode 1), at world 2 (ragged, bf16) and 8
   (ragged, f32), and over 100 back-to-back calls of each with fresh
   inputs; a 2-layer f32 model of Qwen3-8B's widths at world 4, card
   against CPU; the 8B weights resharded to world 4 (``Qwen3.reshard``) in
   mode ``fused`` through ``Engine.serve`` of phase 4's requests with
   exact K1/K2/K12/K14 launches, its prefill logits and 3 decode steps
   within 3x phase 4's bf16 error of the world-1 logits; K12/K14 times
   with bounds, plain versions and library yardsticks, world-4 prefill
   and decode beside world 1 in alternating windows, profiles; the
   world-4 copy freed after;
10. training path: gradients of a 2-layer model of Qwen3-8B's widths on
   the card (kernels) in f32 and in bf16 against the CPU's f32 (plain
   versions), per leaf; then
   Qwen3-8B at full width and depth in bf16 (the same weights as phases
   4-9, which no longer need them) takes 3 SGD steps on 4 sequences of
   512 tokens (cross-entropy of the last position's logits against seeded
   targets): loss, ms per forward+backward, tokens/s, peak memory, exact
   K1/K4/K5 launches per step, finite gradients, a falling loss; one
   traced training step;
11. MoE path (the 8B model freed first): a 2-layer f32 model of
   Qwen3-30B-A3B's widths, card (kernels) against CPU (plain versions):
   logits per sequence and every token's top-8 expert set; then
   Qwen3-30B-A3B at full width and depth (48 layers, 128 experts, 8 a
   token) with seeded random bf16 weights: ``Engine.serve`` of 4 x 512
   prompt tokens to 32 greedy tokens with exact K1/K2/K8 launches;
   teacher forcing of decode against prefill with the router's choices
   compared (flips and capacity drops counted, the clean positions held);
   phase 5's traffic through both scheduler layouts with equal tokens;
   layer 0's experts quantized and run on K9 against the bf16 layer; K8
   and K9 times on layer 0's weights; prefill, decode, tokens/s, peak
   memory and profiles;
12. MoE TP path (the world-1 MoE model freed first): K11
   (``ag_group_gemm``), its int8 form, K10 (``moe_reduce_rs_fused``, bf16
   and int8 weights) and K13 (``ag_gemm_w8a8``) against their plain
   versions at world 2, 4 and 8 (the int8 GEMMs bit for bit, the rest row
   by row) on Qwen3-30B-A3B's prefill and decode chunks and three edge
   routings, and over 100 back-to-back calls each; a 2-layer f32 model of
   its widths at world 4, card against CPU; Qwen3-30B-A3B built at world
   4 in mode ``fused`` through ``Engine.serve`` of 4 x 512 prompt tokens
   to 32 with exact K11/K10/K12/K14/K1/K2/K8 launches, every layer's
   fused output within 3x the xla layer's bf16 error of an f32 reference
   where the local and gathered routings agree; ``MoEMLP(mode="w8a8")``
   and ``TPMLP(4096, 12288, mode="w8a8")`` at world 4 within 5% of bf16;
   kernel times with bounds, plain versions and library yardsticks,
   world-4 prefill and decode, a traced prefill;
13. collective path (the device holds little from here on): the
   collective library at world W on the one card, K15 (``all_gather``),
   K16 (``reduce_scatter``), K17 (``all_reduce``) and K18
   (``barrier_all_on_axis``, ``broadcast``): every method at world 2, 4
   and 8 in bf16 and f32 bit for bit against its plain version, on ragged
   and aligned shapes (the fallbacks taken), under a straggler rank and
   for_correctness, and over 100 back-to-back calls each; the main path
   with exact launches: ``TPMLP(4096, 12288, mode="fused_ar")`` at world 4
   on 2048 and 4 rows (bit for bit against its plain version after the same
   bf16 partials, within 3x the xla layer's bf16 error of the fused and xla
   layers, the ranks' copies equal), `SpFlashDecodeAttention` at world 4 on
   Qwen3-8B's heads over 32,768 tokens (B = 1, ragged B = 4), int8 and
   paged SP decode against world-1 decode, ``ops.reduce_scatter``,
   ``ops.broadcast`` and the barrier; times of every method at the
   fused_ar and SP payloads with bounds, plain versions and library
   yardsticks, the ``auto`` sweep, fused_ar against fused, SP decode
   against world-1 decode;
14. EP path: expert parallelism at world 4 on Qwen3-30B-A3B's MoE widths
   (hidden 2048, 128 experts of 768, top 8; 32 experts a rank): K19
   (``fast_all_to_all``) bit for bit against its plain version at world 2,
   4 and 8 in bf16, f32 and int8 with and without scales, under a
   straggler and over 100 back-to-back calls; the main path with exact
   launches: 512 seeded tokens a rank through ``EPAll2AllLayer.dispatch``
   (K19), layer 0's local experts on K8 and ``combine`` (K19); the
   identity round trip bit for bit against the layer on the plain
   exchange, the expert round trip within 3x the bf16 error of
   ``MoEMLP(mode="xla")`` at world 1 against f32, a decode-sized case; K19
   times with its byte bound;
15. SP attention path: Qwen3-8B's heads (32/8 of 128) over 32,768 tokens
   at world 4: K20 (``sp_ag_attention_fused``) against its plain version
   at world 2, 4 and 8 (GQA 1 and 4, S_loc 24, f32, caller offsets, a
   straggler, 100 back-to-back calls), rank 0 bit for bit equal to K1; the
   main path with exact launches through the fused (K20), gather (K15 +
   K1), ring (K1) and zigzag (K1) compositions, each held row by row to
   world-1 ``flash_attention`` over the whole sequence; ring training
   (``sp_ring_attention_diff`` on 4 x 2,048 tokens) with its gradients
   held to world 1 and exact K1/K4/K5 launches; K20 against its bound,
   its plain version and SDPA over the whole sequence, beside the
   compositions;
16. grid path: the process grid of two and three axes, the ranks in this
   process on the one card: K21a (``all_gather_torus``) and K21b
   (``reduce_scatter_torus``) bit for bit against their plain versions on
   the (2, 2), (2, 4), (4, 2) and (2, 2, 2) grids in bf16 and f32, under a
   straggler, for_correctness and 100 back-to-back calls, a (1, 4) grid on
   K15/K16, K21c (``ag_gemm_torus``) row by row; the main path with exact
   launches: K21a/K21b/``all_reduce_torus`` at 2048 x 4096 bf16 a rank on
   (2, 2) and (2, 2, 2), ``ag_gemm`` / ``gemm_rs`` on a TorusContext at
   Qwen3-8B's prefill gate_up and down, and at (dcn 2, ici 2) the
   hierarchical collectives, the two-level GEMMs,
   ``HierarchicalEPAll2AllLayer`` on the EP path's traffic (bit for bit
   the flat layer's) and ``sp_ag_attention_2d`` over 32,768 tokens
   (against world-1 K1); times against bounds, plain versions and library
   calls, beside K15/K16/K17/K12/K14/K20 over the flat world.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
                "matmul_w8a8", "flash_attention_bwd", "grouped_matmul",
                "grouped_matmul_w8a8", "ag_gemm", "gemm_rs", "all_gather",
                "reduce_scatter", "all_reduce", "common_ops", "ag_group_gemm",
                "moe_reduce_rs", "ag_gemm_w8a8", "all_to_all",
                "sp_ag_attention", "torus")}

_TPU = "triton_distributed_tpu/kernels/"
#: The kernels of the JSON record: name -> (library it is built into, the
#: wrapper that launches it, the wrapper's launch counter, the TPU kernel
#: it replaces).  The int8 decode kernels (K2q, K3q) are the float ones'
#: libraries with an int8 cache; their wrappers count them apart.  K4 and
#: K5 launch as a pair from one wrapper, which counts each kernel apart (and
#: the pair in ``launches``).  K6 is K8's library with one group, launched
#: and counted by its own wrapper, `matmul`.  K18 is two kernels of one
#: library, the barrier and the broadcast, counted together by their
#: module (`kernels.common_ops.launches`).
KERNELS = {
    "flash_attention": ("flash_attention", "flash_attention", "launches",
                        _TPU + "flash_attention.py:564"),
    "flash_decode": ("flash_decode", "flash_decode", "launches",
                     _TPU + "flash_decode.py:195"),
    "flash_decode_paged": ("flash_decode_paged", "flash_decode_paged",
                           "launches", _TPU + "flash_decode.py:310"),
    "flash_decode_int8": ("flash_decode", "flash_decode", "int8_launches",
                          _TPU + "flash_decode.py:195"),
    "flash_decode_paged_int8": ("flash_decode_paged", "flash_decode_paged",
                                "int8_launches", _TPU + "flash_decode.py:310"),
    "matmul_w8a8": ("matmul_w8a8", "matmul_w8a8", "launches",
                    _TPU + "quantized.py:120"),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               "flash_attention_backward", "dq_launches",
                               _TPU + "flash_attention.py:948"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                "flash_attention_backward", "dkv_launches",
                                _TPU + "flash_attention.py:987"),
    "matmul": ("grouped_matmul", "matmul", "launches", _TPU + "matmul.py:138"),
    "grouped_matmul": ("grouped_matmul", "grouped_matmul", "launches",
                       _TPU + "grouped_gemm.py:71"),
    "grouped_matmul_w8a8": ("grouped_matmul_w8a8", "grouped_matmul_w8a8",
                            "launches", _TPU + "grouped_gemm.py:266"),
    "ag_gemm": ("ag_gemm", "ag_gemm", "launches",
                _TPU + "allgather_gemm.py:329"),
    "gemm_rs": ("gemm_rs", "gemm_rs", "launches",
                _TPU + "gemm_reduce_scatter.py:292"),
    "all_gather": ("all_gather", "all_gather", "launches",
                   _TPU + "allgather.py:301"),
    "reduce_scatter": ("reduce_scatter", "reduce_scatter", "launches",
                       _TPU + "reduce_scatter.py:295"),
    "all_reduce": ("all_reduce", "all_reduce", "launches",
                   _TPU + "allreduce.py:373"),
    "barrier_broadcast": ("common_ops", "common_ops", "launches",
                          _TPU + "common_ops.py:91"),
    "ag_group_gemm": ("ag_group_gemm", "ag_group_gemm", "launches",
                      _TPU + "allgather_group_gemm.py:172"),
    "ag_group_gemm_w8a8": ("ag_group_gemm", "ag_group_gemm_w8a8", "launches",
                           _TPU + "allgather_group_gemm.py:297"),
    "moe_reduce_rs_fused": ("moe_reduce_rs", "moe_reduce_rs_fused",
                            "launches", _TPU + "moe_reduce_rs.py:396"),
    "ag_gemm_w8a8": ("ag_gemm_w8a8", "ag_gemm_w8a8", "launches",
                     _TPU + "allgather_gemm.py:440"),
    "all_to_all": ("all_to_all", "fast_all_to_all", "launches",
                   _TPU + "low_latency_all_to_all.py:211"),
    "sp_ag_attention_fused": ("sp_ag_attention", "sp_ag_attention_fused",
                              "launches", _TPU + "sp_ag_attention.py:520"),
    "all_gather_torus": ("torus", "all_gather_torus", "launches",
                         _TPU + "torus.py:359"),
    "reduce_scatter_torus": ("torus", "reduce_scatter_torus", "launches",
                             _TPU + "torus.py:613"),
    "ag_gemm_torus": ("torus", "ag_gemm_torus", "launches",
                      _TPU + "torus.py:727"),
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

#: Qwen3-30B-A3B as `ModelConfig` fields, from its published config
#: (huggingface.co/Qwen/Qwen3-30B-A3B, config.json): hidden 2048, 48
#: layers, 32 query and 4 KV heads of 128, 128 experts of 768 with 8 a
#: token (renormalized, every layer sparse), vocabulary 151936, untied
#: head.  The package has no preset for it, as the JAX package has none.
#: Expert capacity is the port's (and the JAX package's) capacity padding
#: with factor 2; the published model routes without a capacity.
MOE_FIELDS = dict(
    vocab_size=151936, hidden_size=2048, intermediate_size=6144,
    num_layers=48, num_heads=32, num_kv_heads=4, head_dim=128,
    rms_norm_eps=1e-6, rope_theta=1e6, qk_norm=True,
    tie_word_embeddings=False, max_seq_len=40960, num_experts=128,
    num_experts_per_tok=8, moe_intermediate_size=768)
#: `MoEMLP.capacity` of the Engine path's 4 x 512 prefill, of a decode
#: batch of up to 8 rows, and of the latter in w8a8 (32-row alignment).
MOE_PREFILL_CAP, MOE_DECODE_CAP, MOE_W8A8_DECODE_CAP = 256, 16, 32
#: The MoE path's 2-layer f32 check, card against CPU: sequences x tokens,
#: decode steps after the prefill, and the bound on each sequence's logits
#: in relative L2 (f32 on both sides; only the order of the sums differs).
MOE_CHECK_SHAPE, MOE_CHECK_STEPS, MOE_CHECK_REL_L2 = (2, 128), 2, 1e-4
#: The int8 experts against the bf16 layer, relative L2 (as phase 6).
MOE_W8A8_REL_L2 = 5e-2

#: The TP path: Qwen3-8B at world 4 (4 ranks in one process on the one
#: card); its 2-layer f32 check, card against CPU (sequences x tokens,
#: decode steps, the bound on each sequence's logits in relative L2, f32
#: on both sides); back-to-back calls of each collective kernel and
#: method with fresh inputs; and the row-by-row bounds of the collective
#: GEMMs against their plain versions (as K6 and K8: one bf16 rounding of
#: an f32 sum; K14's partials are rounded to bf16 before their sum too).
TP_WORLD = 4
TP_CHECK_SHAPE, TP_CHECK_STEPS, TP_CHECK_REL_L2 = (4, 64), 3, 1e-4
TP_REPEATS = 100
TP_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-5)}

#: Calls of K8's wrapper whose host time is averaged.
HOST_CALLS = 500

#: Device cycles (about 50 ms at the H100's 1.98 GHz boost clock) that the
#: stream spins before a timed run.  Every timed run below is queued by the
#: host well within that, so its launches run back to back and the events
#: time the device, not the host's launch rate.
QUEUE_AHEAD_CYCLES = 100_000_000


def kernel_entry(mangled: str) -> str:
    """A kernel's mangled name without the anonymous namespace that every
    kernel of a library shares (at the top or inside ``tdt``) and without
    the leading ``_ZN``, cut to 64 characters: its own name and template
    arguments."""
    m = re.search(r"(\d+)_GLOBAL__N_", mangled)
    if m:
        mangled = mangled[:m.start()] + mangled[m.end(1) + int(m.group(1)):]
    return mangled.removeprefix("_ZN")[:64]


def serialized_wgmma(path) -> tuple[int, int]:
    """ptxas's lines in a library's build log that say it serialized a
    kernel's `wgmma`s: those for a function call in the kernel (info
    C7510), and all of them (any reason)."""
    log = path.with_suffix(".log").read_text()
    return (log.count("C7510"),
            log.count("wgmma.mma_async instructions are serialized"))


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
                      "w8a8_kernel", "grouped_tile_", "wgmma_grouped_",
                      "ag_gemm_", "gemm_rs_", "ag_group_gemm_",
                      "moe_reduce_rs_")),
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


def profile_phase(label: str, fn, card: str, top: int = 6,
                  steps: int = 0) -> None:
    """One traced call of ``fn`` under torch.profiler: its host time, the
    summed device time of its kernels (one stream, so no overlap), the
    device's busy share of the host time, the device time by kernel kind,
    and the kernels that took most of it; with ``steps`` (the decode steps
    ``fn`` runs), the device time a step and the decode kernels' share of
    it.  Tracing adds host time, so the share is a lower bound."""
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
    if steps:
        dec = [e for e in kern if "decode_kernel" in e.key]
        dec_us = sum(e.self_device_time_total for e in dec)
        print(f"[profile] {label}: device {dev_us / 1e3 / steps:.3f} ms a "
              f"step, of which the decode kernels (K2/K3) "
              f"{dec_us / 1e3 / steps:.3f} ms in "
              f"{sum(e.count for e in dec) / steps:.0f} launches; host "
              f"{t_host / steps:.2f} ms a step (traced); {card}")


def check_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    print(f"  {name}: max_abs_err={worst:.3e} (atol={atol}, rtol={rtol}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return worst


def row_errors(got, want, floor):
    """max |err|, max err / (|ref| + rms(ref's row) + floor * rms(ref))
    and rel_l2 of ``got`` against ``want`` (see `check_rows`)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    row = w.pow(2).mean(-1, keepdim=True).sqrt()
    floor = floor * w.pow(2).mean().sqrt()
    ratio = float((err / (w.abs() + row + floor).clamp_min(
        torch.finfo(torch.float32).tiny)).max()) if err.numel() else 0.0
    rel = float(err.norm() / w.norm()) if float(w.norm()) else float(
        err.norm())
    worst = float(err.max()) if err.numel() else 0.0
    return worst, ratio, rel


def check_rows(name, got, want, tol, rel_tol, floor):
    """``got`` against ``want`` with a bound that scales with each row (the
    last dim), not with the tensor's maximum: |err| <= tol * (|ref| +
    rms(ref's row) + floor * rms(ref)), the last term for rows whose exact
    value is zero (a query row that sees one key: its ds cancels, leaving
    the rounding of dp - delta); and rel_l2 <= ``rel_tol`` over the
    tensor.  Returns max |err|."""
    worst, ratio, rel = row_errors(got, want, floor)
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


class RouterTap:
    """Within a ``with`` block, records for every call of the given MoE
    layers each token's top-k expert set (sorted) and its number of pairs
    dropped by capacity, recomputed from the layer's input as the layer
    routes it (forward pre-hooks), and the call's tokens per expert."""

    def __init__(self, mlps):
        self.mlps = list(mlps)
        self.calls = []
        self.counts = []
        self._handles = []

    def _hook(self, mlp, args):
        from triton_distributed_tpu_torch.kernels.moe_utils import (
            route_capacity)
        from triton_distributed_tpu_torch.layers.moe_mlp import route

        x = args[0]
        if x.dim() == 3:
            # World W: every chunk of mc rows routed with its own capacity
            # (the ids are a row's own, wherever it is routed).
            from triton_distributed_tpu_torch.kernels.moe_utils import (
                histogram, plan_chunks)
            w, mc, h = x.shape
            ids, wts = route(x.reshape(-1, h), mlp.router, mlp.topk)
            plan = plan_chunks(ids, wts, w, mlp.num_experts,
                               mlp.capacity(mc))
            slots = plan.slot_of_pair.reshape(ids.shape)
            counts = histogram(ids, mlp.num_experts)
        else:
            ids, _ = route(x, mlp.router, mlp.topk)
            r = route_capacity(ids, mlp.num_experts,
                               mlp.capacity(x.shape[0]))
            slots, counts = r.slot_of_pair, r.counts
        self.calls.append((ids.sort(dim=-1).values, (slots < 0).sum(-1)))
        self.counts.append(counts)

    def __enter__(self):
        self._handles = [m.register_forward_pre_hook(self._hook)
                         for m in self.mlps]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def moe_card_vs_cpu(cfg, dev, card: str) -> None:
    """A 2-layer f32 model of ``cfg``'s widths (random weights, seed 7):
    the prefill of MOE_CHECK_SHAPE tokens and MOE_CHECK_STEPS decode steps
    (fed the card's greedy tokens) on the card (K1, K2, K8) against the CPU
    (plain versions): each sequence's logits within MOE_CHECK_REL_L2, and
    every token's top-8 expert set and dropped pairs equal in every layer
    call (a differing set is a discontinuity of the routing, not a
    rounding, and fails the check)."""
    from triton_distributed_tpu_torch import Qwen3

    two = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(7)
    card_m = Qwen3(two).init_params(gen)
    cpu_m = Qwen3(two, device="cpu")
    cpu_m.load_state_dict(card_m.state_dict())
    b, s = MOE_CHECK_SHAPE
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    runs, feed = {}, []
    for tag, m, d in (("card", card_m, dev), ("CPU", cpu_m, "cpu")):
        with torch.inference_mode(), RouterTap(
                layer.mlp for layer in m.layers) as tap:
            cache = m.create_cache(b, max_seq=s + MOE_CHECK_STEPS)
            logits = [m.prefill(ids.to(d), cache)]
            for step in range(MOE_CHECK_STEPS):
                if m is card_m:
                    feed.append(logits[-1].argmax(-1))
                logits.append(m.decode(feed[step].to(d), cache))
        runs[tag] = ([lg.float().cpu() for lg in logits],
                     [(i.cpu(), dr.cpu()) for i, dr in tap.calls])
    worst = max(rel_l2(g[i], c[i]) for g, c in zip(runs["card"][0],
                                                   runs["CPU"][0])
                for i in range(b))
    sets = sum(int((ic != ig).any(-1).sum()) for (ig, _), (ic, _) in zip(
        runs["card"][1], runs["CPU"][1]))
    drops = [sum(int(dr.sum()) for _, dr in runs[t][1]) for t in runs]
    n_sets = sum(ig.shape[0] for ig, _ in runs["card"][1])
    ok = worst <= MOE_CHECK_REL_L2 and sets == 0 and drops[0] == drops[1]
    print(f"[moe path] 2-layer f32 model of Qwen3-30B-A3B's widths, {b} x "
          f"{s} tokens + {MOE_CHECK_STEPS} decode steps, card (kernels) vs "
          f"CPU (plain versions): worst per-sequence logits rel_l2 "
          f"{worst:.3e} (bound {MOE_CHECK_REL_L2}); top-"
          f"{cfg.num_experts_per_tok} expert sets that differ: {sets} of "
          f"{n_sets}; pairs dropped by capacity card "
          f"{drops[0]}, CPU {drops[1]} {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("MoE 2-layer card vs CPU check failed")
    del card_m, cpu_m
    gc.collect()
    torch.cuda.empty_cache()


def f32_prefill(model, ids):
    """Last-position logits of a prefill of ``ids`` with ``model``'s bf16
    weights in f32, converted one layer at a time (the whole model in f32
    would not fit beside the bf16 one), and the router tap's calls."""
    from triton_distributed_tpu_torch.layers.tp_attn import rms_norm
    from triton_distributed_tpu_torch.models.qwen import Qwen3Layer

    cfg = model.config
    layer32 = Qwen3Layer(cfg, "fused", torch.float32, model.device)
    b, s = ids.shape
    with torch.no_grad(), RouterTap([layer32.mlp]) as tap:
        x = model.embed[ids.long()].float().reshape(b * s, -1)
        for layer in model.layers:
            layer32.load_state_dict(layer.state_dict())
            x, _ = layer32.prefill(x, b)
        x = rms_norm(x, model.ln_f.float(), cfg.rms_norm_eps)
        logits = torch.matmul(x.reshape(b, s, -1)[:, -1],
                              model.lm_head.float())
    return logits, tap.calls


def moe_experts_w8a8(buckets, q, gmm):
    """The int8 expert products of JAX `MoEMLP._fwd_w8a8` without its ring:
    buckets (E, cap, h) quantized per token, gate_up on ``gmm`` (K9 or its
    plain version) out in the buckets' dtype, gated SiLU, quantized per
    token, down out in f32.  ``q``: `MoEMLP.quantize_params` output."""
    from triton_distributed_tpu_torch.kernels.quantized import quantize_sym
    from triton_distributed_tpu_torch.layers.tp_mlp import gated_silu

    a_q, sa = quantize_sym(buckets, 2)
    inter = gmm(a_q, q["gate_up_q"], sa, q["gate_up_scale"],
                out_dtype=buckets.dtype)
    h_q, sh = quantize_sym(gated_silu(inter), 2)
    return gmm(h_q, q["down_q"], sh, q["down_scale"],
               out_dtype=torch.float32)


def moe_path(dev, card: str, counted, expect, short, records,
             errs) -> None:
    """Phase 10: Qwen3-30B-A3B at full width and depth (MOE_FIELDS), seeded
    random bf16 weights made on the card: the 2-layer f32 check first, then
    `Engine.serve` with exact launches, teacher forcing with the routing
    compared, both scheduler layouts on phase 5's traffic, the int8 experts
    (K9) on layer 0's quantized weights, kernel and path times, and
    profiles."""
    from triton_distributed_tpu_torch import (
        ContinuousBatchingScheduler, Engine, ModelConfig, Qwen3, Request,
        SchedulerConfig)
    from triton_distributed_tpu_torch.kernels.grouped_gemm import (
        grouped_matmul, grouped_matmul_reference, grouped_matmul_w8a8,
        grouped_matmul_w8a8_reference)
    from triton_distributed_tpu_torch.kernels.moe_utils import (
        combine_tokens, gather_tokens, route_capacity)
    from triton_distributed_tpu_torch.kernels.quantized import quantize_sym
    from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP, route
    from triton_distributed_tpu_torch.layers.tp_mlp import gated_silu
    from triton_distributed_tpu_torch.serving import (
        DEFAULT_PREFILL_BUCKETS, RequestState)

    cfg = ModelConfig(**MOE_FIELDS)
    moe_card_vs_cpu(cfg, dev, card)

    t0 = time.perf_counter()
    wgen = torch.Generator(device=dev).manual_seed(0)
    model = Qwen3(cfg).init_params(wgen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    nl, ne, topk = cfg.num_layers, cfg.num_experts, cfg.num_experts_per_tok
    mlp0 = model.layers[0].mlp
    w8_caps = MoEMLP(cfg.hidden_size, cfg.moe_intermediate_size, ne,
                     topk=topk, mode="w8a8", device="meta")
    caps = (mlp0.capacity(BATCH * PROMPT), mlp0.capacity(SLOTS),
            w8_caps.capacity(SLOTS))
    print(f"[moe path] Qwen3-30B-A3B: {nl} layers, hidden {cfg.hidden_size}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, {ne} "
          f"experts of {cfg.moe_intermediate_size}, {topk} a token; "
          f"{n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card (bf16, "
          f"routers f32); random weights (seed 0) in "
          f"{time.perf_counter() - t0:.1f} s; expert capacity: prefill "
          f"{BATCH} x {PROMPT} {caps[0]}, decode (<= {SLOTS} rows) "
          f"{caps[1]}, w8a8 decode {caps[2]}")
    if caps != (MOE_PREFILL_CAP, MOE_DECODE_CAP, MOE_W8A8_DECODE_CAP):
        raise AssertionError(f"capacities {caps}")

    # -- Engine.serve ---------------------------------------------------
    engine = Engine(model)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=wgen, device=dev)
    cache = model.create_cache(BATCH, max_seq=CACHE_SEQ)
    torch.cuda.reset_peak_memory_stats()
    served, t_serve = [], []
    launches = counted(lambda: t_serve.append(wall_ms(lambda: served.append(
        engine.serve(prompts, GEN_LEN, cache=cache)))))
    tokens = served[0]
    print(f"[moe path] Engine.serve {BATCH} requests x {PROMPT} prompt tokens, "
          f"gen_len {GEN_LEN}, greedy: {t_serve[0]:.1f} ms (first call); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {short(launches)}")
    want = expect(flash_attention=nl, flash_decode=nl * (GEN_LEN - 1),
                  grouped_matmul=2 * nl * GEN_LEN)
    if launches != want:
        raise AssertionError(f"MoE launch counts {launches} != {want}")
    if tokens.shape != (BATCH, GEN_LEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("MoE tokens: bad shape or outside the "
                             "vocabulary")

    # -- teacher forcing, with the routing compared ----------------------
    # Decode at position PROMPT against a prefill of PROMPT + 1 tokens (as
    # phase 4), each layer's router recomputed from its input.  bf16
    # rounds differently on the two paths, and a difference near a tie
    # flips a top-8 choice, which carries into every later layer; pairs the
    # prefill dropped by capacity differ from decode too (decode never
    # drops: at most 8 rows for 16 slots).  So the flips and drops are
    # counted, and the positions with neither in any layer are held to
    # phase 4's bound: 3x this run's bf16 error (the bf16 prefill against
    # the same weights in f32, converted a layer at a time).
    mlps = [layer.mlp for layer in model.layers]
    with torch.inference_mode():
        with RouterTap(mlps) as tap_p:
            logits_p = model.prefill(prompts, cache)
        with RouterTap(mlps) as tap_d:
            logits_d = model.decode(tokens[:, 0], cache)
        seq = torch.cat([prompts, tokens[:, :1].long()], dim=1)
        tf_cache = model.create_cache(BATCH, max_seq=CACHE_SEQ)
        with RouterTap(mlps) as tap_f:
            logits_f = model.prefill(seq, tf_cache)
        del tf_cache
    logits_x, calls_x = f32_prefill(model, seq)
    for nm, lg in (("prefill", logits_p), ("decode", logits_d),
                   ("prefill+1", logits_f), ("f32 prefill+1", logits_x)):
        if lg.dtype != torch.float32 or not bool(lg.isfinite().all()):
            raise AssertionError(f"MoE {nm} logits not finite f32")
    if not torch.equal(logits_p.argmax(-1).to(torch.int32), tokens[:, 0]):
        raise AssertionError("MoE first token != argmax of prefill logits")
    last = torch.arange(BATCH, device=dev) * (PROMPT + 1) + PROMPT
    flips = torch.zeros(nl, BATCH, dtype=torch.bool, device=dev)
    dropped = torch.zeros_like(flips)
    for li, ((ids_d, drop_d), (ids_f, drop_f)) in enumerate(
            zip(tap_d.calls, tap_f.calls)):
        if int(drop_d.sum()):
            raise AssertionError("MoE decode dropped a pair")
        flips[li] = (ids_d != ids_f[last]).any(-1)
        dropped[li] = drop_f[last] > 0
    clean = ~(flips | dropped).any(0)
    drops_p = sum(int(dr.sum()) for _, dr in tap_p.calls)
    drops_f = sum(int(dr.sum()) for _, dr in tap_f.calls)
    flips_x = sum(float((ib != ix).any(-1).float().mean())
                  for (ib, _), (ix, _) in zip(tap_f.calls, calls_x)) / nl
    floor = rel_l2(logits_f, logits_x)
    per_pos = [rel_l2(logits_d[i], logits_f[i]) for i in range(BATCH)]
    held = [i for i in range(BATCH) if bool(clean[i])]
    ok = all(per_pos[i] <= 3 * floor for i in held)
    def load(counts):
        """(experts with a token, largest count) of each layer call."""
        return [(int((c > 0).sum()), int(c.max())) for c in counts]

    load_p = load(tap_p.counts)
    drop_layers = [int(dr.sum()) for _, dr in tap_p.calls]
    print(f"[moe path] expert load of the {BATCH} x {PROMPT} prefill "
          f"(capacity {caps[0]}, {BATCH * PROMPT * topk // ne} pairs an "
          f"expert on average), (experts hit, most pairs an expert) by "
          f"layer: {load_p[:4]} ... {load_p[-2:]}; pairs dropped by layer: "
          f"{drop_layers[:4]} ... {drop_layers[-2:]}")
    print(f"[moe path] routing: pairs dropped by capacity, prefill "
          f"{BATCH} x {PROMPT} {drops_p} of {BATCH * PROMPT * topk * nl} "
          f"(all layers), prefill of {PROMPT + 1} {drops_f}; decode@{PROMPT} "
          f"vs prefill+1 at the same positions: top-{topk} sets that differ "
          f"{int(flips.sum())} of {nl * BATCH} (layer, position) pairs "
          f"(first flip at layer "
          f"{[int(f.nonzero()[0]) if bool(f.any()) else None for f in flips.t()]}"
          f" per position), positions with a prefill drop "
          f"{int(dropped.any(0).sum())}; bf16 prefill+1 vs f32: "
          f"{flips_x:.2%} of top-{topk} sets differ (mean over layers)")
    print(f"[moe path] teacher forcing, decode@{PROMPT} vs prefill of "
          f"{PROMPT + 1} tokens: rel_l2 per position "
          f"{[f'{r:.3e}' for r in per_pos]} (argmax agreement "
          f"{float((logits_d.argmax(-1) == logits_f.argmax(-1)).float().mean()):.2f}); "
          f"bf16 error of the prefill against f32: rel_l2 {floor:.3e}; "
          f"positions with no flip and no drop in any layer: {held}, held "
          f"to {3 * floor:.3e} (3x the bf16 error) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("MoE teacher-forcing logits disagree")
    del logits_x, calls_x, tap_p, tap_d, tap_f

    # -- scheduler --------------------------------------------------------
    traffic = scheduler_traffic(cfg.vocab_size, seed=1)
    base = dict(num_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
                prefill_buckets=DEFAULT_PREFILL_BUCKETS, temperature=0.0)
    runs = {}
    for layout in ("slots", "paged"):
        sched = ContinuousBatchingScheduler(model, SchedulerConfig(
            **base, kv_layout=layout))
        torch.cuda.reset_peak_memory_stats()
        out = []
        got = counted(lambda: out.extend(drive_scheduler(
            sched, traffic, Request, RequestState.QUEUED)))
        reqs, rec = out
        steps = rec["steps"]
        n_decode = sum(1 for _, _, dec in steps if dec)
        n_prefill = len(traffic) + sum(r.preemptions for r in reqs)
        dec = "flash_decode" if layout == "slots" else "flash_decode_paged"
        want = expect(flash_attention=nl * n_prefill,
                      grouped_matmul=2 * nl * (n_prefill + n_decode),
                      **{dec: nl * n_decode})
        pure = sorted(ms for ms, adm, dec_ in steps if dec_ and not adm)
        n_gen = sum(len(r.generated) for r in reqs)
        hits = sched.slots.radix.hit_tokens if layout == "paged" else 0
        print(f"[moe path] scheduler {layout}: run {rec['wall_ms']:.1f} ms "
              f"(host clock), {n_gen} tokens generated "
              f"({n_gen / rec['wall_ms'] * 1e3:.1f} tokens/s), "
              f"{rec['prompt_tokens']} prompt tokens prefilled, {n_decode} "
              f"decode steps at {pure[len(pure) // 2]:.2f} ms/step (median "
              f"of the steps that admit nothing), {n_prefill} prefills, "
              f"preemptions {sum(r.preemptions for r in reqs)}, prefix hits "
              f"{hits} tokens, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {short(got)}; {card}")
        if got != want:
            raise AssertionError(f"MoE {layout}: launch counts {got} != "
                                 f"{want}")
        for i, r in enumerate(reqs):
            if (r.finish_reason is None or r.finish_reason.value != "length"
                    or len(r.generated) != r.max_new_tokens
                    or not all(0 <= t < cfg.vocab_size
                               for t in r.generated)):
                raise AssertionError(f"MoE {layout}: request {i} finished "
                                     f"{r.finish_reason} with "
                                     f"{len(r.generated)} tokens")
        runs[layout] = [r.generated for r in reqs]
        if layout == "paged" and hits < (len(SHARED_TOTALS) - 1) * SYS_PREFIX:
            raise AssertionError(f"MoE prefix hits {hits}")
        del sched
    for i, (a, b) in enumerate(zip(runs["slots"], runs["paged"])):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            raise AssertionError(f"MoE slots and paged differ: request {i} "
                                 f"at token {j}: {a[j]} != {b[j]}")
    print(f"[moe path] scheduler slots and paged runs: equal tokens for all "
          f"{len(runs['slots'])} requests")

    # -- int8 experts (K9) on layer 0's quantized weights ----------------
    # Layer 0's MoE input from the Engine path's prefill and from a decode
    # step, routed at the w8a8 capacities; the expert products on K9
    # (counted), bit for bit against their exact plain version, and the
    # combined output against the bf16 layer's (K8) within
    # MOE_W8A8_REL_L2.
    grab = []
    hook = mlp0.register_forward_pre_hook(
        lambda mod, args: grab.append(args[0].clone()))
    with torch.inference_mode():
        model.prefill(prompts, cache)
        model.decode(tokens[:, 0], cache)
    hook.remove()
    x_in = dict(zip(("prefill", "decode"), grab))
    q0 = MoEMLP.quantize_params(mlp0.params())
    k9_in = {}
    with torch.inference_mode():
        for label, x in x_in.items():
            cap = w8_caps.capacity(x.shape[0])
            ids, w = route(x, mlp0.router, topk)
            r = route_capacity(ids, ne, cap)
            buckets = gather_tokens(x, r.dispatch_index)
            out = []
            launches = counted(lambda: out.append(moe_experts_w8a8(
                buckets, q0, grouped_matmul_w8a8)))
            plain = moe_experts_w8a8(buckets, q0,
                                     grouped_matmul_w8a8_reference)
            got = combine_tokens(out[0], ids, r.slot_of_pair, w).to(x.dtype)
            ref = mlp0(x)
            torch.cuda.synchronize()
            same = torch.equal(out[0], plain)
            rel = rel_l2(got, ref)
            ok = same and rel <= MOE_W8A8_REL_L2
            print(f"[moe path] int8 experts of layer 0 on {x.shape[0]} "
                  f"tokens (capacity {cap}): launches {short(launches)}; "
                  f"{'bit-identical' if same else 'DIFFER'} to the exact "
                  f"plain version; combined output against the bf16 layer "
                  f"rel_l2 {rel:.3e} (bound {MOE_W8A8_REL_L2}) "
                  f"{'ok' if ok else 'FAIL'}")
            if launches != expect(grouped_matmul_w8a8=2) or not ok:
                raise AssertionError("MoE int8 experts disagree")
            k9_in[label] = quantize_sym(buckets, 2)

    # -- kernel times at the path's shapes --------------------------------
    # K8 on layer 0's weights and the Engine path's buckets (prefill 256
    # rows an expert, decode 16); yardstick torch.bmm (cuBLAS, f32
    # accumulation; out_dtype=f32 for down).  K9 on layer 0's quantized
    # gate_up (prefill 256, decode 32); yardstick a loop of torch._int_mm
    # over the experts plus the same epilogue (no single call computes it).
    # Bounds count every expert's weights: the buckets are dense.
    with torch.inference_mode():
        for label, x in x_in.items():
            cap = mlp0.capacity(x.shape[0])
            ids, _ = route(x, mlp0.router, topk)
            buckets = gather_tokens(x, route_capacity(ids, ne,
                                                      cap).dispatch_index)
            act = gated_silu(grouped_matmul(buckets, mlp0.gate_up))
            for nm, a, b, out_dtype in (
                    ("gate_up", buckets, mlp0.gate_up, torch.bfloat16),
                    ("down", act, mlp0.down, torch.float32)):
                _, m, k = a.shape
                n = b.shape[2]
                ms = time_ms(lambda: grouped_matmul(a, b, out_dtype), 20)
                plain = time_ms(lambda: grouped_matmul_reference(
                    a, b, out_dtype), 3)
                lib = time_ms(lambda: torch.bmm(a, b, out_dtype=out_dtype)
                              if out_dtype != a.dtype else torch.bmm(a, b),
                              20)
                flops = 2 * ne * m * k * n
                bms, by = bound(nbytes(a, b) + ne * m * n
                                * torch.finfo(out_dtype).bits // 8, flops)
                print(f"[times] grouped_matmul (K8) {label} {nm} ({ne}x{m}x"
                      f"{k})@({ne}x{k}x{n}) out {out_dtype}: {ms:.4f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s, "
                      f"{nbytes(b) / ms / 1e6:.0f} GB/s of weights; bound "
                      f"{bms:.4f} ms by {by}, {bms / ms:.1%} of bound), plain "
                      f"(f32) {plain:.4f} ms, torch.bmm {lib:.4f} ms; {card}")
                if (label, nm) == ("decode", "gate_up"):
                    records.append(("grouped_matmul", ms, plain, bms, by,
                                    lib))
        for label, (a_q, sa) in k9_in.items():
            b_q, sb = q0["gate_up_q"], q0["gate_up_scale"]
            _, m, k = a_q.shape
            n = b_q.shape[2]
            ms = time_ms(lambda: grouped_matmul_w8a8(a_q, b_q, sa, sb), 20)
            plain = time_ms(lambda: grouped_matmul_w8a8_reference(
                a_q, b_q, sa, sb), 2, warmup=1)

            def int_mm_loop():
                acc = torch.stack([torch._int_mm(a_q[e], b_q[e])
                                   for e in range(ne)])
                return (acc.float() * sa[:, :, None]
                        * sb[:, None, :]).to(torch.bfloat16)

            lib = time_ms(int_mm_loop, 10)
            bms, by = bound(nbytes(a_q, b_q, sa, sb) + ne * m * n * 2,
                            2 * ne * m * k * n, PEAK_INT8_OPS)
            print(f"[times] grouped_matmul_w8a8 (K9) {label} gate_up "
                  f"({ne}x{m}x{k})@({ne}x{k}x{n}) out bf16: {ms:.4f} ms "
                  f"({nbytes(b_q) / ms / 1e6:.0f} GB/s of weights; bound "
                  f"{bms:.4f} ms by {by}, {bms / ms:.1%} of bound), plain "
                  f"(float64) {plain:.4f} ms, {ne} x torch._int_mm + "
                  f"epilogue {lib:.4f} ms; {card}")
            if label == "decode":
                records.append((
                    "grouped_matmul_w8a8", ms, plain, bms, by, None,
                    {"library_loop_ms": lib,
                     "library_note": f"no single PyTorch call computes it; "
                     f"library_loop_ms is a loop of {ne} torch._int_mm "
                     "calls plus the epilogue"}))
    del q0, k9_in, x_in, grab

    # -- path times and profiles -----------------------------------------
    with torch.inference_mode():
        serve1 = sorted(wall_ms(lambda: engine.serve(prompts, 1, cache=cache))
                        for _ in range(3))[1]
        torch.cuda.reset_peak_memory_stats()
        serve_n = sorted(wall_ms(lambda: engine.serve(prompts, GEN_LEN,
                                                      cache=cache))
                         for _ in range(3))[1]
    step_ms = (serve_n - serve1) / (GEN_LEN - 1)
    print(f"[times] MoE Engine.serve (median of 3, host clock): prefill+first "
          f"token {serve1:.2f} ms ({BATCH * PROMPT / serve1 * 1e3:.0f} prompt "
          f"tokens/s); decode {step_ms:.3f} ms/step "
          f"({BATCH / step_ms * 1e3:.1f} tokens/s); whole serve "
          f"{serve_n:.2f} ms ({BATCH * GEN_LEN / serve_n * 1e3:.1f} generated "
          f"tokens/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    with torch.inference_mode():
        profile_phase("MoE Engine prefill", lambda: model.prefill(prompts,
                                                                  cache),
                      card, top=10)
        profile_phase("MoE Engine decode x8", lambda: [
            model.decode(tokens[:, 0], cache) for _ in range(8)], card,
            top=10)
    del model, engine, cache, mlp0, mlps
    gc.collect()
    torch.cuda.empty_cache()


#: The MoE TP path: Qwen3-30B-A3B (MOE_FIELDS) at world MOE_TP_WORLD in mode
#: ``fused``.  Its kernels are checked at these worlds on a prefill chunk
#: (512 rows a rank: capacity 64, blocks of 64) and a decode chunk (16 rows:
#: capacity 16, 32 in w8a8) under random routing, and at world 4 on the
#: prefill chunk under three routings of their own: two experts only (the
#: rest empty), every pair to one expert, and experts filled to whole
#: blocks.  The 2-layer f32 check's shape (64 rows a rank: the fused kernels
#: in prefill; a decode row a rank takes the xla path) and decode steps.
#: The W8A8 entry points: `MoEMLP` on 2048 and 64 rows, `TPMLP(4096, 12288)`
#: (W8A8_ROWS) against their bf16 layers within MOE_W8A8_REL_L2.
MOE_TP_WORLD = 4
MOE_TP_WORLDS = (2, 4, 8)
MOE_TP_ROWS = {"prefill": 512, "decode": 16}
MOE_TP_CASES = ("two experts", "one expert", "whole blocks")
MOE_TP_CHECK_SHAPE, MOE_TP_CHECK_STEPS = (4, 64), 2
MOE_W8A8_LAYER_ROWS = (2048, 64)


def moe_tp_routing(case, world, mc, e, topk, block, gen, dev):
    """Routing ids and weights (world * mc, topk) of a named case: random
    distinct experts a token, two experts only, every pair to the last
    expert, or runs of ``block`` consecutive pairs to one expert each (every
    occupied expert's count a whole number of blocks)."""
    n = world * mc
    if case == "random":
        ids = torch.rand(n, e, generator=gen, device=dev).argsort(-1)[:, :topk]
    elif case == "two experts":
        ids = torch.randint(0, 2, (n, topk), generator=gen, device=dev) * 2
    elif case == "one expert":
        ids = torch.full((n, topk), e - 1, device=dev)
    else:
        ids = (torch.arange(n * topk, device=dev) // block % e).reshape(
            n, topk)
    w = torch.softmax(torch.randn(n, topk, generator=gen, device=dev), -1)
    return ids.to(torch.int32), w


def moe_tp_reference(mlp, x):
    """An f32 plain reference of a world-W MoE layer (JAX `_fwd_xla` in f32
    with library products, no kernels): x (W, mc, h) -> (W, mc, h) f32."""
    from triton_distributed_tpu_torch.kernels.moe_utils import plan_chunks
    from triton_distributed_tpu_torch.layers.moe_mlp import (
        gather_chunks, route)
    from triton_distributed_tpu_torch.layers.tp_mlp import gated_silu

    world, mc, h = x.shape
    e, topk = mlp.num_experts, mlp.topk
    cap = mlp.capacity(mc)
    xf = x.float()
    ids, w = route(xf.reshape(-1, h), mlp.router, topk)
    plan = plan_chunks(ids, w, world, e, cap)
    buckets = gather_chunks(xf, plan.dispatch_index).transpose(0, 1).reshape(
        e, world * cap, h)
    kept = plan.slot_of_pair >= 0
    slot = torch.where(kept, plan.slot_of_pair, 0).long()
    wk = torch.where(kept, w.reshape(world, mc, topk), 0.0)
    chunk = torch.arange(world, device=x.device)[:, None, None]
    out = torch.zeros_like(xf)
    for r in range(world):
        act = gated_silu(torch.bmm(buckets, mlp.gate_up[r].float()))
        part = torch.bmm(act, mlp.down[r].float()).reshape(
            e, world, cap, h).transpose(0, 1)
        vals = part[chunk, ids.reshape(world, mc, topk).long(), slot]
        out += (vals * wk[..., None]).sum(2)
    return out


def moe_tp_bound(kind, world, counts, e_occ, cap, k, n, mc=0, pairs=0,
                 int8=False):
    """The least time of one K11 or K10 call and what sets it, for this
    run's routing: ``counts`` (W, E) the tokens of every chunk's buckets,
    ``e_occ`` the experts that hold a token in some chunk.  K11: each
    rank's occupied bucket rows read once and received by the W - 1 others,
    the occupied experts' weight shards, the dense output written; the
    products of the occupied rows only.  K10: every rank's occupied rows of
    every chunk and its weight shards read, W - 1 partials put and the
    output written; the products of the occupied rows and the combine's
    ``pairs`` weighted rows.  bf16 or (int8) 1-byte operands."""
    ab = 1 if int8 else 2
    rows = int(counts.sum())
    if kind == "ag_group_gemm":
        moved = (world * rows * k * ab + world * e_occ * k * n * ab
                 + world * world * counts.shape[1] * cap * n * 2)
        ops = 2 * world * rows * k * n
    else:
        moved = (world * rows * k * ab + world * e_occ * k * n * ab
                 + world * world * mc * n * 2)
        ops = 2 * world * rows * k * n + 2 * world * pairs * n
    return bound(moved, ops, PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS)


def moe_tp_path(dev, card: str, counted, expect, short, records,
                errs) -> None:
    """The MoE TP path: Qwen3-30B-A3B at world MOE_TP_WORLD in mode
    ``fused``, the W ranks in this process on the one card: every layer's
    prefill MoE on K11 (`ag_group_gemm`) then K10 (`moe_reduce_rs_fused`),
    attention on K12/K14 and K1/K2, decode's MoE (one row a rank) on the
    xla path (K8); with the W8A8 entry points on K11-int8, K10 with int8
    weights and K13 (`ag_gemm_w8a8`).

    1. K11, K11-int8, K10 (bf16 and int8 weights) and K13 against their
       plain versions at worlds 2, 4 and 8 (K11 and K10 row by row, the
       int8 GEMMs bit for bit, K10 with int8 weights row by row): on the
       prefill and decode chunks and, at world 4, on the edge routings;
       then TP_REPEATS back-to-back calls of each at the decode chunk
       with fresh inputs, queued before any is checked;
    2. a 2-layer f32 model of Qwen3-30B-A3B's widths at world 4, card
       against CPU: logits, every top-8 set and every drop;
    3. the model at full width and depth with seeded bf16 weights made on
       the card: `Engine.serve` of 4 x 512 prompt tokens to 32 with exact
       launches, finite logits, peak memory; each layer's MoE input from the
       prefill through the fused and the xla layer: top-8 flips between the
       local routing and the gathered one, and, where none flips, the fused
       layer within 3x the xla layer's bf16 error of an f32 plain reference;
    4. the W8A8 entry points: `MoEMLP(mode="w8a8")` on layer 0's quantized
       weights at 2048 and 64 rows, `TPMLP(4096, 12288, mode="w8a8")` at 2048
       and 8 rows (its K13 output bit for bit), each within MOE_W8A8_REL_L2
       of its bf16 layer;
    5. times of K11, K11-int8, K10 and K13 with bounds, plain versions and
       library yardsticks; world-4 prefill and decode; a traced prefill.

    On one card every put is a copy inside one HBM: the times say what the
    kernels and the copies cost here, not what NVLink would carry."""
    from triton_distributed_tpu_torch import Engine, ModelConfig, Qwen3
    from triton_distributed_tpu_torch.kernels import moe_utils
    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        AllGatherGEMMContext, ag_gemm, ag_gemm_w8a8, ag_gemm_w8a8_plain)
    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        AGGroupGEMMContext, ag_group_gemm, ag_group_gemm_plain,
        ag_group_gemm_w8a8, ag_group_gemm_w8a8_plain)
    from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
        gemm_rs)
    from triton_distributed_tpu_torch.kernels.grouped_gemm import (
        row_tile, zero_past_counts)
    from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
        MoEReduceRSContext, moe_reduce_rs_fused, moe_reduce_rs_fused_plain)
    from triton_distributed_tpu_torch.kernels.quantized import quantize_sym
    from triton_distributed_tpu_torch.language.core import (
        release_symmetric_buffers)
    from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP, route
    from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP, gated_silu
    from triton_distributed_tpu_torch.parallel import make_mesh

    cfg = ModelConfig(**MOE_FIELDS)
    w, nl = MOE_TP_WORLD, cfg.num_layers
    e, topk, h = cfg.num_experts, cfg.num_experts_per_tok, cfg.hidden_size
    ffn = cfg.moe_intermediate_size
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(8642)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def caps(world, mc):
        """(bf16 capacity, w8a8 capacity) of a chunk of mc rows."""
        return tuple(MoEMLP(h, ffn, e, topk=topk, mode=m, world_size=world,
                            device="meta").capacity(mc)
                     for m in ("fused", "w8a8"))

    def plan_for(case, world, mc, cap):
        ids, wts = moe_tp_routing(case, world, mc, e, topk,
                                  moe_utils.pack_block(cap), gen, dev)
        return moe_utils.plan_chunks(ids, wts, world, e, cap)

    def global_int8(down):
        """int8 down weights with (E, n) scales over the whole K."""
        world, _, k, n = down.shape
        q, s = quantize_sym(down.float().transpose(0, 1).reshape(
            e, world * k, n), 1)
        return q.reshape(e, world, k, n).transpose(0, 1).contiguous(), s

    def k11(world, mc, case, int8, wts=None):
        """One K11 (or K11-int8) call on fresh buckets: its output, its
        plain version (a callable) and the weights (``wts``, or fresh)."""
        cap = caps(world, mc)[int8]
        plan = plan_for(case, world, mc, cap)
        a = randn(world, e, cap, h)
        ctx = AGGroupGEMMContext("tp", world, e)
        n = 2 * ffn // world
        if int8:
            wq, ws = wts if wts else quantize_sym(
                randn(world, e, h, n, dtype=f32), 2)
            out = ag_group_gemm_w8a8(a, wq, ws, ctx, counts=plan.counts)
            a_q, sa = quantize_sym(a, -1)
            return out, lambda: ag_group_gemm_w8a8_plain(
                a_q, sa, wq, ws, bf16, plan.counts), (wq, ws)
        b = wts if wts is not None else randn(world, e, h, n) * h ** -0.5
        out = ag_group_gemm(a, b, ctx, counts=plan.counts)
        return out, lambda: zero_past_counts(
            ag_group_gemm_plain(a.float(), b.float()), plan.counts,
            row_tile(cap, bf16)), b

    def k10(world, mc, case, int8, wts=None):
        cap = caps(world, mc)[int8]
        plan = plan_for(case, world, mc, cap)
        k = ffn // world
        act = randn(world, world, e, cap, k)
        ctx = MoEReduceRSContext("tp", world, e, topk)
        rows, pw = moe_utils.combine_pairs(plan, topk)
        if int8:
            dq, ds = wts if wts else global_int8(
                randn(world, e, k, h) * ffn ** -0.5)
            out = moe_reduce_rs_fused(act, dq, plan, ctx, weight_scales=ds)
            a_q, sa = quantize_sym(act, -1)
            return out, lambda: moe_reduce_rs_fused_plain(
                a_q, dq, plan, rows, pw.to(bf16), sa, ds), (dq, ds)
        down = (wts if wts is not None
                else randn(world, e, k, h) * ffn ** -0.5)
        out = moe_reduce_rs_fused(act, down, plan, ctx)
        return out, lambda: moe_reduce_rs_fused_plain(
            act, down, plan, rows, pw.to(bf16)), down

    def k13(world, rows, case, int8, wts=None):
        del case, int8
        n = 2 * MLP_FFN // world
        x = randn(world, rows // world, MLP_HIDDEN)
        bq, bs = wts if wts else quantize_sym(
            randn(world, MLP_HIDDEN, n, dtype=f32), 1)
        out = ag_gemm_w8a8(x, bq, bs, AllGatherGEMMContext("tp", world))
        a_q, sa = quantize_sym(x, -1)
        return out, lambda: ag_gemm_w8a8_plain(a_q, bq, sa, bs, bf16), (bq,
                                                                         bs)

    # name -> (runner, int8 form, held bit for bit)
    kernels = {"ag_group_gemm": (k11, False, False),
               "ag_group_gemm_w8a8": (k11, True, True),
               "moe_reduce_rs_fused": (k10, False, False),
               "moe_reduce_rs_fused int8": (k10, True, False),
               "ag_gemm_w8a8": (k13, False, True)}

    def check(name, out, plain_fn, exact, label):
        torch.cuda.synchronize()
        ref = plain_fn()
        rec = name.split()[0]
        if exact:
            same = torch.equal(out, ref)
            print(f"  {name} {label} {tuple(out.shape)}: "
                  f"{'bit-identical' if same else 'DIFFER'} to the plain "
                  "version")
            if not same:
                raise AssertionError(f"{name} {label}: kernel disagrees with "
                                     "its plain version")
            return
        errs[rec] = max(errs[rec], check_rows(
            f"{name} {label} {tuple(out.shape)}", out, ref.float(),
            *TP_TOL[bf16], 0.1))

    # -- 1. kernels vs plain ---------------------------------------------
    print(f"[moe tp path] K11, K11-int8, K10 (bf16 and int8 weights) and "
          f"K13 against their plain versions; bf16 row bound {TP_TOL[bf16]} "
          f"with floor 0.1, the int8 GEMMs bit for bit; Qwen3-30B-A3B's "
          f"widths (K13: Qwen3-8B's MLP); the ranks of a world in one launch "
          f"on the one card")
    for world in MOE_TP_WORLDS:
        for label, mc in MOE_TP_ROWS.items():
            for name, (fn, int8, exact) in kernels.items():
                rows = mc
                if fn is k13:
                    rows = W8A8_ROWS[label != "prefill"]
                out, plain_fn, _ = fn(world, rows, "random", int8)
                check(name, out, plain_fn, exact,
                      f"world {world} {label} ({rows} rows"
                      f"{'' if fn is k13 else ' a rank'})")
                del out, plain_fn
    for case in MOE_TP_CASES:
        for name, (fn, int8, exact) in kernels.items():
            if fn is k13:
                continue
            out, plain_fn, _ = fn(w, MOE_TP_ROWS["prefill"], case, int8)
            check(name, out, plain_fn, exact, f"world {w} prefill, {case}")
            del out, plain_fn
    for world in MOE_TP_WORLDS:
        for name, (fn, int8, exact) in kernels.items():
            # Fresh inputs every call; one set of weights for all of them.
            rows = W8A8_ROWS[1] if fn is k13 else MOE_TP_ROWS["decode"]
            runs = [fn(world, rows, "random", int8)]
            runs += [fn(world, rows, "random", int8, runs[0][2])
                     for _ in range(TP_REPEATS - 1)]
            torch.cuda.synchronize()
            bad = 0
            for out, plain_fn, _ in runs:
                ref = plain_fn()
                if exact:
                    bad += not torch.equal(out, ref)
                else:
                    _, ratio, rel = row_errors(out, ref.float(), 0.1)
                    bad += not (ratio <= TP_TOL[bf16][0]
                                and rel <= TP_TOL[bf16][1])
            print(f"  {name} world {world}: {TP_REPEATS} back-to-back calls "
                  f"with fresh inputs, queued before any check: {bad} "
                  f"disagree {'ok' if not bad else 'FAIL'}")
            if bad:
                raise AssertionError(f"{name}: a back-to-back call disagrees "
                                     "with its plain version")
            del runs
            torch.cuda.empty_cache()
    release_symmetric_buffers()
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2. card vs CPU, 2 layers in f32 ----------------------------------
    two = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    card_m = Qwen3(two, "fused", mesh=make_mesh(w)).init_params(
        torch.Generator(device=dev).manual_seed(9))
    cpu_m = Qwen3(two, "fused", mesh=make_mesh(w, device="cpu"))
    cpu_m.load_state_dict(card_m.state_dict())
    b, s = MOE_TP_CHECK_SHAPE
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    runs, feed = {}, []
    fused0 = (ag_group_gemm.launches, moe_reduce_rs_fused.launches)
    with torch.inference_mode():
        for tag, m, d in (("card", card_m, dev), ("CPU", cpu_m, "cpu")):
            with RouterTap(layer.mlp for layer in m.layers) as tap:
                cache = m.create_cache(b, max_seq=s + MOE_TP_CHECK_STEPS)
                logits = [m.prefill(ids.to(d), cache)]
                for step in range(MOE_TP_CHECK_STEPS):
                    if m is card_m:
                        feed.append(logits[-1].argmax(-1).to(torch.int32))
                    logits.append(m.decode(feed[step].to(d), cache))
            runs[tag] = ([lg.float().cpu() for lg in logits],
                         [(i.cpu(), dr.cpu()) for i, dr in tap.calls])
    fused = (ag_group_gemm.launches - fused0[0],
             moe_reduce_rs_fused.launches - fused0[1])
    worst = max(rel_l2(g[i], c[i]) for g, c in zip(runs["card"][0],
                                                   runs["CPU"][0])
                for i in range(b))
    sets = sum(int((ic != ig).any(-1).sum()) for (ig, _), (ic, _) in zip(
        runs["card"][1], runs["CPU"][1]))
    drops = [sum(int(dr.sum()) for _, dr in runs[t][1]) for t in runs]
    n_sets = sum(ig.shape[0] for ig, _ in runs["card"][1])
    ok = (worst <= MOE_CHECK_REL_L2 and sets == 0 and drops[0] == drops[1]
          and fused == (two.num_layers,) * 2)
    print(f"[moe tp path] 2-layer f32 model of Qwen3-30B-A3B's widths at "
          f"world {w}, {b} x {s} tokens + {MOE_TP_CHECK_STEPS} decode steps, "
          f"card (K11, K10 in prefill, K8 in decode) vs CPU (plain versions):"
          f" worst per-sequence logits rel_l2 {worst:.3e} (bound "
          f"{MOE_CHECK_REL_L2}); top-{topk} sets that differ: {sets} of "
          f"{n_sets}; pairs dropped by capacity card {drops[0]}, CPU "
          f"{drops[1]}; K11, K10 launches {fused} (want "
          f"{two.num_layers} each) {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("MoE TP 2-layer card vs CPU check failed")
    del card_m, cpu_m, runs
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3. Qwen3-30B-A3B at world 4 through Engine.serve -------------------
    t0 = time.perf_counter()
    model = Qwen3(cfg, "fused", mesh=make_mesh(w)).init_params(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    mlp0 = model.layers[0].mlp
    print(f"[moe tp path] Qwen3-30B-A3B at world {w} (mode 'fused', {w} ranks "
          f"in one process on the one card): {n_params / 1e9:.3f} B "
          f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
          f"card, random weights (seed 0) in {time.perf_counter() - t0:.1f} "
          f"s; expert capacity a chunk: prefill ({PROMPT} rows a rank) "
          f"{mlp0.capacity(BATCH * PROMPT // w)}, pack block "
          f"{moe_utils.pack_block(mlp0.capacity(BATCH * PROMPT // w))}")
    engine = Engine(model)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                            device=dev)
    cache = model.create_cache(BATCH, max_seq=CACHE_SEQ)
    torch.cuda.reset_peak_memory_stats()
    served, t_serve = [], []
    ll0 = (ag_gemm.ll_launches, gemm_rs.ll_launches)
    wg0 = ag_gemm.wgmma_launches
    launches = counted(lambda: t_serve.append(wall_ms(lambda: served.append(
        engine.serve(prompts, GEN_LEN, cache=cache)))))
    ll = (ag_gemm.ll_launches - ll0[0], gemm_rs.ll_launches - ll0[1])
    wg12 = ag_gemm.wgmma_launches - wg0
    tokens = served[0]
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expect(flash_attention=nl, flash_decode=nl * (GEN_LEN - 1),
                  ag_gemm=nl * GEN_LEN, gemm_rs=nl * GEN_LEN,
                  grouped_matmul=2 * w * nl * (GEN_LEN - 1),
                  ag_group_gemm=nl, moe_reduce_rs_fused=nl)
    print(f"[moe tp path] Engine.serve at world {w}, {BATCH} requests x "
          f"{PROMPT} prompt tokens, gen_len {GEN_LEN}, greedy: "
          f"{t_serve[0]:.1f} ms (first call); launches {short(launches)} "
          f"(want {short(want)}: per layer one K11 and one K10 in prefill, "
          f"K12/K14 once a forward, ll in decode {ll}, decode's MoE on the "
          f"xla path, two K8 a rank); K12 on the wgmma body {wg12} of "
          f"{launches['ag_gemm']}; peak memory {peak:.2f} GiB; {card}")
    if launches != want or ll != (nl * (GEN_LEN - 1),) * 2:
        raise AssertionError(f"MoE TP launch counts {launches}, ll {ll} != "
                             f"{want}")
    if wg12 != launches["ag_gemm"]:
        raise AssertionError(f"MoE TP: {launches['ag_gemm'] - wg12} K12 "
                             "launches left the wgmma body")
    if tokens.shape != (BATCH, GEN_LEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("MoE TP tokens: bad shape or outside the "
                             "vocabulary")

    # Each layer's MoE input from a prefill, through the fused and the
    # xla layer and an f32 plain reference.
    grab = []
    hooks = [layer.mlp.register_forward_pre_hook(
        lambda mod, args: grab.append(args[0].clone()))
        for layer in model.layers]
    with torch.inference_mode():
        logits = model.prefill(prompts, cache)
    for hk in hooks:
        hk.remove()
    if not bool(logits.isfinite().all()) or logits.dtype != f32:
        raise AssertionError("MoE TP prefill logits not finite f32")
    flips, held, worst_ratio, rels = [], 0, 0.0, []
    with torch.inference_mode():
        for layer, x in zip(model.layers, grab):
            mlp = layer.mlp
            local = torch.cat([route(x[r], mlp.router, topk)[0]
                               for r in range(w)]).sort(-1).values
            gathered = route(x.reshape(-1, h), mlp.router,
                             topk)[0].sort(-1).values
            flips.append(int((local != gathered).any(-1).sum()))
            ref = moe_tp_reference(mlp, x)
            rel_f = rel_l2(mlp(x), ref)
            rel_x = rel_l2(mlp.forward_xla(x, mlp.params()), ref)
            rels.append((rel_f, rel_x))
            if not flips[-1]:
                held += 1
                worst_ratio = max(worst_ratio, rel_f / rel_x)
    ok = held > 0 and worst_ratio <= 3
    print(f"[moe tp path] each layer's MoE input from the prefill: top-{topk} "
          f"sets that differ between the local routing ({PROMPT} rows a "
          f"rank) and the gathered one ({BATCH * PROMPT} rows), by layer "
          f"{flips[:6]} ... {flips[-3:]} ({sum(flips)} of "
          f"{nl * BATCH * PROMPT} token-layers); rel_l2 against an f32 plain "
          f"reference (fused, xla) {[(f'{a:.2e}', f'{b_:.2e}') for a, b_ in rels[:3]]}"
          f" ...; layers without a flip: {held} of {nl}, held to 3x the xla "
          f"layer's bf16 error: worst ratio {worst_ratio:.3f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("MoE TP layer outputs disagree")
    x0 = grab[0]
    del grab

    # -- 4. the W8A8 entry points -----------------------------------------
    q0 = MoEMLP.quantize_params(mlp0.jax_params())
    mlp8 = MoEMLP(h, ffn, e, topk=topk, mode="w8a8", world_size=w,
                  device=dev).load_jax_params(q0)
    del q0
    with torch.inference_mode():
        for rows in MOE_W8A8_LAYER_ROWS:
            x = x0[:, :rows // w].contiguous()
            out = []
            got = counted(lambda: out.append(mlp8(x)))
            rel = rel_l2(out[0], mlp0(x))
            ok = rel <= MOE_W8A8_REL_L2 and got == expect(
                ag_group_gemm_w8a8=1, moe_reduce_rs_fused=1)
            print(f"[moe tp path] MoEMLP(mode='w8a8') at world {w} on layer "
                  f"0's quantized weights, {rows} rows: launches "
                  f"{short(got)}; against the bf16 fused layer rel_l2 "
                  f"{rel:.3e} (bound {MOE_W8A8_REL_L2}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("MoE w8a8 layer disagrees")
    tp_f = TPMLP(MLP_HIDDEN, MLP_FFN, world_size=w, device=dev)
    tp_f.init_params(torch.Generator(device=dev).manual_seed(11))
    tp_q = TPMLP(MLP_HIDDEN, MLP_FFN, mode="w8a8", world_size=w, device=dev)
    tp_q.load_quantized(TPMLP.quantize_params({"gate_up": tp_f.gate_up,
                                               "down": tp_f.down}))
    k13_in = {}
    with torch.inference_mode():
        for rows in W8A8_ROWS:
            x = randn(w, rows // w, MLP_HIDDEN)
            out = []
            got = counted(lambda: out.append(tp_q(x)))
            rel = rel_l2(out[0], tp_f(x))
            k13 = ag_gemm_w8a8(x, tp_q.gate_up_q, tp_q.gate_up_scale,
                               AllGatherGEMMContext("tp", w))
            a_q, sa = quantize_sym(x, -1)
            same = torch.equal(k13, ag_gemm_w8a8_plain(
                a_q, tp_q.gate_up_q, sa, tp_q.gate_up_scale, bf16))
            ok = same and rel <= MOE_W8A8_REL_L2 and got == expect(
                ag_gemm_w8a8=1, matmul_w8a8=w)
            print(f"[moe tp path] TPMLP({MLP_HIDDEN}, {MLP_FFN}, mode='w8a8') "
                  f"at world {w}, {rows} rows: launches {short(got)}; K13 "
                  f"{'bit-identical' if same else 'DIFFER'} to its plain "
                  f"version; against the bf16 fused layer rel_l2 {rel:.3e} "
                  f"(bound {MOE_W8A8_REL_L2}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("TPMLP w8a8 at world 4 disagrees")
            k13_in[rows] = x
    del tp_f

    # -- 5. times -----------------------------------------------------------
    print(f"[times] K11 / K11-int8 / K10 / K13 at world {w} on one card (every "
          f"put a copy inside one HBM, no NVLink); CUDA events; bounds count "
          f"this run's occupied rows and experts; {card}")
    with torch.inference_mode():
        buckets, plan = mlp0._route_bucket_plan(x0, mlp0.router)
        counts = plan.counts
        e_occ = int((counts.sum(0) > 0).sum())
        cap = buckets.shape[2]
        n_gu = mlp0.gate_up.shape[-1]
        ctx = AGGroupGEMMContext("tp", w, e)
        inter = ag_group_gemm(buckets, mlp0.gate_up, ctx, counts=counts)
        act = gated_silu(inter)
        rs_ctx = MoEReduceRSContext("tp", w, e, topk)
        rows, pw = moe_utils.combine_pairs(plan, topk)
        kept = int((plan.slot_of_pair >= 0).sum())
        note = ("{}; GEMM only, no gather (one card: the collective's copies "
                "stay in one HBM)")
        # K11
        ms = time_ms(lambda: ag_group_gemm(buckets, mlp0.gate_up, ctx,
                                           counts=counts), 20)
        plain = time_ms(lambda: ag_group_gemm_plain(buckets, mlp0.gate_up,
                                                    counts), 2, warmup=1)
        gathered_b = buckets.transpose(0, 1).reshape(1, e, w * cap, h)
        lib = time_ms(lambda: torch.matmul(gathered_b, mlp0.gate_up), 20)
        bms, by = moe_tp_bound("ag_group_gemm", w, counts, e_occ, cap, h,
                               n_gu)
        print(f"[times] ag_group_gemm (K11) prefill layer 0 buckets "
              f"{tuple(buckets.shape)} @ {tuple(mlp0.gate_up.shape)}, "
              f"{int(counts.sum())} occupied rows of {w * e * cap}, {e_occ} "
              f"experts hit: {ms:.4f} ms (bound {bms:.4f} ms by {by}, "
              f"{bms / ms:.1%} of bound), plain {plain:.4f} ms, torch.matmul "
              f"of the gathered buckets with every rank's weights {lib:.4f} "
              f"ms; {card}")
        records.append(("ag_group_gemm", ms, plain, bms, by, lib, {
            "shape": "prefill layer 0", "library_note": note.format(
                "torch.matmul of the gathered buckets (E, W cap, h) with the "
                "ranks' weights")}))
        # K11-int8
        ms = time_ms(lambda: ag_group_gemm_w8a8(
            buckets, mlp8.gate_up_q, mlp8.gate_up_scale, ctx, counts=counts),
            20)
        bq, sa = quantize_sym(buckets, -1)
        plain = time_ms(lambda: ag_group_gemm_w8a8_plain(
            bq, sa, mlp8.gate_up_q, mlp8.gate_up_scale, bf16, counts), 2,
            warmup=1)
        gq = bq.transpose(0, 1).reshape(e, w * cap, h)

        def int_mm_loop():
            return torch.stack([torch.stack([
                torch._int_mm(gq[x], mlp8.gate_up_q[r, x]) for x in range(e)])
                for r in range(w)])

        lib8 = time_ms(int_mm_loop, 3)
        bms, by = moe_tp_bound("ag_group_gemm", w, counts, e_occ, cap, h,
                               n_gu, int8=True)
        print(f"[times] ag_group_gemm_w8a8 (K11-int8) the same buckets on "
              f"layer 0's int8 weights: {ms:.4f} ms (bound {bms:.4f} ms by "
              f"{by}, {bms / ms:.1%} of bound), plain (float64) {plain:.4f} "
              f"ms, {w} x {e} torch._int_mm {lib8:.4f} ms; {card}")
        records.append(("ag_group_gemm_w8a8", ms, plain, bms, by, None, {
            "shape": "prefill layer 0", "library_loop_ms": lib8,
            "library_note": f"no single PyTorch call computes it; "
            f"library_loop_ms is a loop of {w} x {e} torch._int_mm calls "
            "(no epilogue, no gather)"}))
        # K10
        ms = time_ms(lambda: moe_reduce_rs_fused(act, mlp0.down, plan,
                                                 rs_ctx), 20)
        plain = time_ms(lambda: moe_reduce_rs_fused_plain(
            act, mlp0.down, plan, rows, pw.to(bf16)), 2, warmup=1)

        cm = moe_utils.dense_combine_mats(plan, cap).to(bf16).permute(
            0, 2, 1, 3).reshape(w, -1, e * cap)        # (chunk, mc, E cap)

        def bmm_combine():
            dense = torch.matmul(act, mlp0.down[:, None])   # every expert
            part = torch.matmul(cm, dense.reshape(w, w, e * cap, h))
            return part.float().sum(0).to(bf16)

        lib10 = time_ms(bmm_combine, 3)
        bms, by = moe_tp_bound("moe_reduce_rs", w, counts, e_occ, cap,
                               act.shape[-1], h, mc=x0.shape[1], pairs=kept)
        print(f"[times] moe_reduce_rs_fused (K10) prefill layer 0 act "
              f"{tuple(act.shape)} @ {tuple(mlp0.down.shape)}, "
              f"{int(plan.n_blocks.sum())} occupied blocks of "
              f"{plan.pack_block_size} rows, {kept} kept pairs: {ms:.4f} ms "
              f"(bound {bms:.4f} ms by {by}, {bms / ms:.1%} of bound), plain "
              f"{plain:.4f} ms, torch.matmul over every expert + the dense "
              f"one-hot combine product + the rank sum {lib10:.4f} ms; "
              f"{card}")
        records.append(("moe_reduce_rs_fused", ms, plain, bms, by, None, {
            "shape": "prefill layer 0", "library_loop_ms": lib10,
            "library_note": "no single PyTorch call computes it; "
            "library_loop_ms is torch.matmul of every rank's buckets with "
            "its down shard (every expert), torch.matmul of the dense "
            "one-hot combine weights with those products, and the sum over "
            "the ranks"}))
        # K13
        x = k13_in[W8A8_ROWS[0]]
        ag_ctx = AllGatherGEMMContext("tp", w)
        ms = time_ms(lambda: ag_gemm_w8a8(x, tp_q.gate_up_q,
                                          tp_q.gate_up_scale, ag_ctx), 20)
        a_q, sa = quantize_sym(x, -1)
        plain = time_ms(lambda: ag_gemm_w8a8_plain(
            a_q, tp_q.gate_up_q, sa, tp_q.gate_up_scale, bf16), 2, warmup=1)
        full_q = a_q.reshape(-1, MLP_HIDDEN)
        b_cat = tp_q.gate_up_q.transpose(0, 1).reshape(MLP_HIDDEN, -1)
        s_cat = tp_q.gate_up_scale.reshape(-1)
        sa_full = sa.reshape(-1)
        lib13 = time_ms(lambda: (torch._int_mm(full_q, b_cat).float()
                                 * sa_full[:, None] * s_cat[None, :]).to(
                                     bf16), 20)
        n13 = tp_q.gate_up_q.shape[-1]
        m13 = x.shape[1]
        bms, by = bound(w * m13 * MLP_HIDDEN + w * (w - 1) * m13 * MLP_HIDDEN
                        + w * MLP_HIDDEN * n13 + w * w * m13 * n13 * 2
                        + nbytes(sa, tp_q.gate_up_scale),
                        2 * w * w * m13 * MLP_HIDDEN * n13, PEAK_INT8_OPS)
        print(f"[times] ag_gemm_w8a8 (K13) {W8A8_ROWS[0]} rows x "
              f"{MLP_HIDDEN} @ ({w}, {MLP_HIDDEN}, {n13}) int8: {ms:.4f} ms "
              f"(bound {bms:.4f} ms by {by}, {bms / ms:.1%} of bound), plain "
              f"(float64) {plain:.4f} ms, torch._int_mm of the gathered rows "
              f"with every rank's columns + epilogue {lib13:.4f} ms; {card}")
        records.append(("ag_gemm_w8a8", ms, plain, bms, by, lib13, {
            "shape": f"TPMLP gate_up, {W8A8_ROWS[0]} rows",
            "library_note": note.format("torch._int_mm of the gathered int8 "
                                        "rows with the ranks' columns + the "
                                        "epilogue")}))
        del buckets, inter, act, plan, bq, gq, cm, k13_in, tp_q, mlp8

    # world-4 prefill and decode, and a traced prefill
    with torch.inference_mode():
        serve1 = sorted(wall_ms(lambda: engine.serve(prompts, 1, cache=cache))
                        for _ in range(3))[1]
        serve_n = sorted(wall_ms(lambda: engine.serve(prompts, GEN_LEN,
                                                      cache=cache))
                         for _ in range(3))[1]
    step_ms = (serve_n - serve1) / (GEN_LEN - 1)
    print(f"[times] MoE Engine.serve at world {w} (median of 3, host clock; "
          f"{w} ranks on the one card): prefill+first token {serve1:.2f} ms "
          f"({BATCH * PROMPT / serve1 * 1e3:.0f} prompt tokens/s); decode "
          f"{step_ms:.3f} ms/step; whole serve {serve_n:.2f} ms; beside the "
          f"world-1 [times] MoE Engine.serve line of this run; {card}")
    with torch.inference_mode():
        profile_phase(f"MoE TP world {w} prefill",
                      lambda: model.prefill(prompts, cache), card, top=8)
    del model, engine, cache, mlp0, x0
    release_symmetric_buffers()
    gc.collect()
    torch.cuda.empty_cache()


def tp_collective_bound(op: str, world: int, rows: int, k: int, n: int,
                        esize: int):
    """The least time of one K12 or K14 call and what sets it: the bytes of
    the A shards, of every chunk a rank receives (the gathered rows of
    K12, the partials of K14), of B and of the output once each, and the
    GEMM's operations.  ``rows``: K12's rows a rank, K14's M."""
    if op == "ag_gemm":
        flops = 2 * world * (world * rows) * k * n
        moved = (world * rows * k + world * (world - 1) * rows * k
                 + world * k * n + world * world * rows * n)
    else:
        mc = rows // world
        flops = 2 * world * rows * k * n
        moved = (world * rows * k + world * (world - 1) * mc * n
                 + world * k * n + world * mc * n)
    return bound(moved * esize, flops)


def ag_gemm_variants():
    """`scripts/torch_ag_gemm_variants.py` of this checkout, which builds
    K12's ablations from a copy of the sources."""
    path = Path(__file__).resolve().parent / "scripts" / \
        "torch_ag_gemm_variants.py"
    spec = importlib.util.spec_from_file_location("torch_ag_gemm_variants",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tp_path(model, cfg, prompts, tokens, floor, dev, card: str, counted,
            expect, short, records, errs) -> None:
    """The TP path: Qwen3-8B at world TP_WORLD in mode ``fused``, the W
    ranks in this process on the one card (`parallel.make_mesh`), every
    projection of every layer on K12 (`ag_gemm`) or K14 (`gemm_rs`).

    1. K12 and K14 against their plain versions, row by row in f32 from the
       same inputs, in both methods: at the Qwen3-8B shapes of world 4
       (prefill 512 rows a rank, decode 1), at world 2 on a ragged row
       count in bf16 and at world 8 on a ragged one in f32; then
       TP_REPEATS back-to-back calls of each kernel and method with fresh
       inputs, queued before any is checked (a stale signal would let a
       call read the last call's data);
    2. a 2-layer f32 model of Qwen3-8B's widths at world 4, card (kernels)
       against CPU (plain versions): prefill and decode logits;
    3. the 8B model's weights resharded to world 4 (``model.reshard``):
       ``Engine.serve`` of the Engine path's requests with exact launches
       (two K12 and two K14 a layer and forward: ``fused`` in prefill,
       ``ll`` in decode); its prefill logits and 3 decode steps (fed the
       world-1 run's ``tokens``) within 3x the world-1 run's bf16 error
       (``floor``) of the world-1 logits;
    4. K12 and K14 times per method at the prefill and decode shapes with
       their bounds, plain versions and library yardsticks; K12 at decode
       without its GEMM (`scripts/torch_ag_gemm_variants.py`'s ``nogemm``
       build), the protocol alone; world-4 prefill and decode beside world 1 in
       alternating windows; one traced prefill and eight traced decode
       steps.

    Every K12 call reports the body it ran (the `wgmma` + TMA ring on bf16
    16-byte rows, else the first bodies), checked against `kernel_body`;
    the world-4 `Engine.serve` runs every K12 launch on the `wgmma` body.

    On one card every put is a copy inside one HBM: the times say what the
    GEMMs and the copies cost here, not what NVLink overlap would buy.  The
    world-4 copy of the weights and the symmetric buffers are freed at the
    end."""
    from triton_distributed_tpu_torch import Engine, Qwen3
    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        AllGatherGEMMContext, ag_gemm, ag_gemm_plain, kernel_body)
    from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
        GEMMReduceScatterContext, gemm_rs, gemm_rs_plain)
    from triton_distributed_tpu_torch.language.core import (
        release_symmetric_buffers)
    from triton_distributed_tpu_torch.parallel import make_mesh

    w, nl = TP_WORLD, cfg.num_layers
    bf16, f32 = torch.bfloat16, torch.float32
    h, d = cfg.hidden_size, cfg.head_dim
    qkv_loc = (cfg.num_heads + 2 * cfg.num_kv_heads) * d // w
    o_loc = cfg.num_heads * d // w
    f_loc = cfg.intermediate_size // w
    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def run(op, world, method, a, b):
        if op == "ag_gemm":
            return ag_gemm(a, b, AllGatherGEMMContext("tp", world, method))
        return gemm_rs(a, b, GEMMReduceScatterContext("tp", world, method))

    def plain(op, a, b):
        return (ag_gemm_plain if op == "ag_gemm" else gemm_rs_plain)(a, b)

    def operands(op, world, rows, k, n, dtype):
        """K12: rows a rank; K14: M.  b scaled so that outputs are about 1."""
        scale = (k if op == "ag_gemm" else world * k) ** -0.5
        return randn(world, rows, k, dtype=dtype), randn(
            world, k, n, dtype=dtype) * scale

    # -- 1. kernels vs plain
    print(f"[tp path] K12 ag_gemm and K14 gemm_rs against their plain "
          f"versions (f32 from the same inputs), row by row; bf16 tol "
          f"{TP_TOL[bf16]}, f32 {TP_TOL[f32]}; the ranks of a world in one "
          "launch on the one card")
    m_pre, m_dec = BATCH * PROMPT // w, BATCH // w
    cases = [
        ("prefill QKV", "ag_gemm", w, m_pre, h, qkv_loc, bf16),
        ("prefill gate_up", "ag_gemm", w, m_pre, h, 2 * f_loc, bf16),
        ("decode QKV", "ag_gemm", w, m_dec, h, qkv_loc, bf16),
        ("decode gate_up", "ag_gemm", w, m_dec, h, 2 * f_loc, bf16),
        ("prefill O", "gemm_rs", w, BATCH * PROMPT, o_loc, h, bf16),
        ("prefill down", "gemm_rs", w, BATCH * PROMPT, f_loc, h, bf16),
        ("decode O", "gemm_rs", w, BATCH, o_loc, h, bf16),
        ("decode down", "gemm_rs", w, BATCH, f_loc, h, bf16),
        ("ragged", "ag_gemm", 2, 100, 1024, 768, bf16),
        ("ragged", "gemm_rs", 2, 2 * 100, 1024, 768, bf16),
        ("ragged f32", "ag_gemm", 8, 37, 512, 384, f32),
        ("ragged f32", "gemm_rs", 8, 8 * 37, 512, 384, f32),
        ("off 16-byte rows", "ag_gemm", 3, 5, 100, 77, bf16),
    ]
    timed = {}
    for label, op, world, rows, k, n, dtype in cases:
        a, b = operands(op, world, rows, k, n, dtype)
        ref = plain(op, a.float(), b.float())
        for method in ("fused", "ll"):
            wg0 = ag_gemm.wgmma_launches
            out = run(op, world, method, a, b)
            torch.cuda.synchronize()
            body = ""
            if op == "ag_gemm":
                took = ag_gemm.wgmma_launches - wg0
                want_body = kernel_body(a, b)
                body = f", body {'wgmma' if took else want_body}"
                if (took == 1) != (want_body == "wgmma"):
                    raise AssertionError(f"ag_gemm {label} {method}: "
                                         f"{took} wgmma launches for a "
                                         f"{want_body} operand")
            e = check_rows(f"{op} {label} world {world} {method} "
                           f"a{tuple(a.shape)} b{tuple(b.shape)} {dtype}"
                           f"{body}", out, ref, *TP_TOL[dtype], 0.0)
            errs[op] = max(errs[op], e)
        if world == w:
            timed[(op, label)] = (a, b, rows, k, n)
        del ref
    for op, rows in (("ag_gemm", 16), ("gemm_rs", w * 16)):
        for method in ("fused", "ll"):
            ins = [operands(op, w, rows, 1024, 512, bf16)
                   for _ in range(TP_REPEATS)]
            outs = [run(op, w, method, a, b) for a, b in ins]
            torch.cuda.synchronize()
            worst = [row_errors(o, plain(op, a.float(), b.float()), 0.0)
                     for (a, b), o in zip(ins, outs)]
            ratio = max(x[1] for x in worst)
            rel = max(x[2] for x in worst)
            ok = ratio <= TP_TOL[bf16][0] and rel <= TP_TOL[bf16][1]
            print(f"  {op} {method} world {w}: {TP_REPEATS} back-to-back "
                  f"calls with fresh inputs, queued before any check: worst "
                  f"err/(|ref| + rms_row)={ratio:.3e}, worst rel_l2="
                  f"{rel:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{op} {method}: a back-to-back call "
                                     "disagrees with its plain version")
            del ins, outs
    # A row's bits on the Hopper body whatever the call's rows and method:
    # rank r's first row alone (the narrow decode tile), inside 16 rows a
    # rank (the 64-row tile) and 17 (the 128-row tile), ll and fused.
    for label in ("decode QKV", "decode gate_up"):
        k, n = timed[("ag_gemm", label)][3:]
        a, b = operands("ag_gemm", w, 17, k, n, bf16)
        first, same = None, []
        for rows in (1, 16, 17):
            for method in ("ll", "fused"):
                row = run("ag_gemm", w, method, a[:, :rows].contiguous(),
                          b).reshape(w, w, rows, n)[:, :, 0]
                first = row if first is None else first
                same.append(torch.equal(row, first))
        print(f"  ag_gemm {label} world {w} k {k} n {n}: a row alone, in 16 "
              f"and in 17 rows a rank, ll and fused: bit for bit "
              f"{'ok' if all(same) else 'FAIL'}")
        if not all(same):
            raise AssertionError(f"ag_gemm {label}: a row's bits depend on "
                                 "the other rows or the method")

    # -- 2. card vs CPU, 2 layers in f32
    two = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    card_m = Qwen3(two, mesh=make_mesh(w)).init_params(
        torch.Generator(device=dev).manual_seed(9))
    cpu_m = Qwen3(two, mesh=make_mesh(w, device="cpu"))
    cpu_m.load_state_dict(card_m.state_dict())
    b, s = TP_CHECK_SHAPE
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    runs, feed = {}, []
    before = (ag_gemm.launches, gemm_rs.launches)
    with torch.inference_mode():
        for tag, m, dd in (("card", card_m, dev), ("CPU", cpu_m, "cpu")):
            cache = m.create_cache(b, max_seq=s + TP_CHECK_STEPS)
            logits = [m.prefill(ids.to(dd), cache)]
            for step in range(TP_CHECK_STEPS):
                if m is card_m:
                    feed.append(logits[-1].argmax(-1).to(torch.int32))
                logits.append(m.decode(feed[step].to(dd), cache))
            runs[tag] = [lg.float().cpu() for lg in logits]
    launched = (ag_gemm.launches - before[0], gemm_rs.launches - before[1])
    worst = max(rel_l2(g[i], c[i]) for g, c in zip(runs["card"], runs["CPU"])
                for i in range(b))
    n_calls = 2 * two.num_layers * (1 + TP_CHECK_STEPS)
    ok = worst <= TP_CHECK_REL_L2 and launched == (n_calls, n_calls)
    print(f"[tp path] 2-layer f32 model of Qwen3-8B's widths at world {w}, "
          f"{b} x {s} tokens + {TP_CHECK_STEPS} decode steps, card (K12, "
          f"K14 in f32) vs CPU (plain versions): worst per-sequence logits "
          f"rel_l2 {worst:.3e} (bound {TP_CHECK_REL_L2}); K12, K14 launches "
          f"{launched} (want {n_calls} each) {'ok' if ok else 'FAIL'}; "
          f"{card}")
    if not ok:
        raise AssertionError("TP 2-layer card vs CPU check failed")
    del card_m, cpu_m, runs
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3. Qwen3-8B at world 4
    t0 = time.perf_counter()
    model4 = model.reshard(w)
    torch.cuda.synchronize()
    print(f"[tp path] Qwen3-8B resharded to world {w} (mode "
          f"{model4.mode!r}, {w} ranks in one process on the one card) in "
          f"{time.perf_counter() - t0:.1f} s; device memory held "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    engine4 = Engine(model4)
    cache4 = model4.create_cache(BATCH, max_seq=CACHE_SEQ)
    served, t_serve = [], []
    ll0 = (ag_gemm.ll_launches, gemm_rs.ll_launches)
    wg0 = ag_gemm.wgmma_launches
    torch.cuda.reset_peak_memory_stats()
    launches = counted(lambda: t_serve.append(wall_ms(lambda: served.append(
        engine4.serve(prompts, GEN_LEN, cache=cache4)))))
    ll = (ag_gemm.ll_launches - ll0[0], gemm_rs.ll_launches - ll0[1])
    wg12 = ag_gemm.wgmma_launches - wg0
    tokens4 = served[0]
    print(f"[tp path] Engine.serve at world {w}, {BATCH} requests x {PROMPT} "
          f"prompt tokens, gen_len {GEN_LEN}, greedy: {t_serve[0]:.1f} ms "
          f"(first call); launches {short(launches)}, of which ll: K12 "
          f"{ll[0]}, K14 {ll[1]}; K12 on the wgmma body {wg12}; tokens "
          f"equal to the world-1 run's: "
          f"{int((tokens4 == tokens).sum())} of {tokens.numel()}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = expect(flash_attention=nl, flash_decode=nl * (GEN_LEN - 1),
                  ag_gemm=2 * nl * GEN_LEN, gemm_rs=2 * nl * GEN_LEN)
    if launches != want or ll != (2 * nl * (GEN_LEN - 1),) * 2:
        raise AssertionError(f"TP launch counts {launches}, ll {ll} != "
                             f"{want}")
    if wg12 != launches["ag_gemm"]:
        raise AssertionError(f"TP: {launches['ag_gemm'] - wg12} K12 "
                             "launches left the wgmma body")
    if tokens4.shape != (BATCH, GEN_LEN) or not bool(
            ((tokens4 >= 0) & (tokens4 < cfg.vocab_size)).all()):
        raise AssertionError("world-4 tokens: bad shape or outside the "
                             "vocabulary")
    with torch.inference_mode():
        c1 = model.create_cache(BATCH, max_seq=CACHE_SEQ)
        c4 = model4.create_cache(BATCH, max_seq=CACHE_SEQ)
        pairs = [("prefill", model.prefill(prompts, c1),
                  model4.prefill(prompts, c4))]
        for step in range(3):
            pairs.append((f"decode step {step}",
                          model.decode(tokens[:, step], c1),
                          model4.decode(tokens[:, step], c4)))
        for label, l1, l4 in pairs:
            rel = rel_l2(l4, l1)
            ok = bool(l4.isfinite().all()) and rel <= 3 * floor
            agree = float((l4.argmax(-1) == l1.argmax(-1)).float().mean())
            print(f"[tp path] world {w} against world 1, {label} (the "
                  f"world-1 run's tokens): logits rel_l2 {rel:.3e} "
                  f"(tolerance {3 * floor:.3e}, 3x the world-1 bf16 error), "
                  f"max_abs_err {float((l4 - l1).abs().max()):.4f}, argmax "
                  f"agreement {agree:.2f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"world-{w} {label} logits disagree")
    del pairs

    # -- 4. times
    print(f"[times] K12 ag_gemm / K14 gemm_rs at world {w} on one card "
          "(every put a copy inside one HBM, no NVLink); CUDA events; "
          f"library: one bf16 cuBLAS product, GEMM only, no gather or "
          f"scatter; {card}")
    k12 = {}
    for (op, label), (a, b, rows, k, n) in timed.items():
        ms = {method: time_ms(lambda: run(op, w, method, a, b), 20)
              for method in ("fused", "ll")}
        if op == "ag_gemm":
            k12[label] = ms
        plain_ms = time_ms(lambda: plain(op, a, b), 3)
        if op == "ag_gemm":
            full = a.reshape(-1, k)
            lib = time_ms(lambda: torch.matmul(full, b), 20)
            lib_name = "torch.matmul of the gathered A with the stacked B"
        else:
            lib = time_ms(lambda: torch.bmm(a, b).view(w, w, -1, n).sum(0),
                          20)
            lib_name = "torch.bmm + sum over the ranks"
        bms, by = tp_collective_bound(op, w, rows, k, n, a.element_size())
        print(f"[times] {op} {label} a{tuple(a.shape)} b{tuple(b.shape)}: "
              f"fused {ms['fused']:.4f} ms, ll {ms['ll']:.4f} ms (bound "
              f"{bms:.4f} ms by {by}, {bms / ms['fused']:.1%} / "
              f"{bms / ms['ll']:.1%} of bound), plain {plain_ms:.4f} ms, "
              f"{lib_name} {lib:.4f} ms; {card}")
        if label in ("prefill gate_up", "prefill down"):
            records.append((op, ms["fused"], plain_ms, bms, by, lib,
                            {"method": "fused", "shape": label,
                             "ll_ms": ms["ll"],
                             "library_note": lib_name + ", no gather or "
                             "scatter (one card: the collective's copies "
                             "stay in one HBM)"}))
    variants = ag_gemm_variants()
    path, tmp = variants.build_variant("nogemm")
    undo = variants.use_variant(path, True)
    try:
        for label in ("decode QKV", "decode gate_up"):
            a, b = timed[("ag_gemm", label)][:2]
            bare = {method: time_ms(lambda: run("ag_gemm", w, method, a, b),
                                    20)
                    for method in ("fused", "ll")}
            print(f"[times] K12 {label} a{tuple(a.shape)} "
                  f"b{tuple(b.shape)} without its GEMM (the protocol "
                  "alone: entry barrier, copies, signals, arrival "
                  f"waits, launch): fused {bare['fused']:.4f} ms, ll "
                  f"{bare['ll']:.4f} ms, beside the full call's "
                  f"{k12[label]['fused']:.4f} / {k12[label]['ll']:.4f} "
                  "ms: the GEMM and its epilogue "
                  f"{1 - bare['fused'] / k12[label]['fused']:.0%} / "
                  f"{1 - bare['ll'] / k12[label]['ll']:.0%} of the call; "
                  f"{card}")
            k12[label]["protocol"] = bare
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    for rec in records:
        if rec[0] == "ag_gemm":
            rec[6].update({"body": "wgmma", **{
                f"{label} {method}_ms".replace(" ", "_"): v
                for label, ms in k12.items() for method, v in ms.items()
                if method != "protocol"}})
    del timed

    window = {"world 1": [], f"world {w}": []}
    with torch.inference_mode():
        for label in ("world 1", f"world {w}", f"world {w}", "world 1"):
            mdl, c = (model, c1) if label == "world 1" else (model4, c4)
            pre = wall_ms(lambda: mdl.prefill(prompts, c))
            c.set_offset(PROMPT + 1)
            mdl.decode(tokens[:, 0], c)
            dec = wall_ms(lambda: [mdl.decode(tokens[:, 0], c)
                                   for _ in range(8)]) / 8
            window[label].append((pre, dec))
    print(f"[times] Qwen3-8B prefill ({BATCH} x {PROMPT}, last-position "
          f"logits) ms and decode ms/step ({BATCH} rows at {PROMPT + 1} "
          f"positions, 8-step windows), host clock, in the order world 1, "
          f"world {w}, world {w}, world 1: "
          + "; ".join(f"{label} prefill {a[0]:.2f}, {b_[0]:.2f}, decode "
                      f"{a[1]:.2f}, {b_[1]:.2f}"
                      for label, (a, b_) in window.items())
          + f" (world {w}: {w} ranks on the one card); {card}")
    with torch.inference_mode():
        profile_phase(f"TP world {w} prefill",
                      lambda: model4.prefill(prompts, c4), card)
        profile_phase(f"TP world {w} decode x8", lambda: [
            model4.decode(tokens[:, 0], c4) for _ in range(8)], card)
    del model4, engine4, cache4, c4, c1, served
    release_symmetric_buffers()
    gc.collect()
    torch.cuda.empty_cache()


#: The collective path: K15-K18 against their plain versions at these
#: worlds, on a ragged shape (rows off any tile, columns off 8) and an
#: aligned one (rows a rank x columns; K16 takes world x rows); TP_REPEATS
#: back-to-back calls of each method; a straggler rank of about 1 ms of
#: cycles (the H100's 1.98 GHz boost clock).
COLL_WORLDS = (2, 4, 8)
COLL_SHAPES = ((37, 1001), (64, 1024))
COLL_STRAGGLER = (1, 2_000_000)
COLL_METHODS = (("all_gather", "ring"), ("all_gather", "push_all"),
                ("all_gather", "bidir_ring"),
                ("reduce_scatter", "scatter_reduce"),
                ("reduce_scatter", "ring"), ("all_reduce", "one_shot"),
                ("all_reduce", "two_shot"), ("all_reduce", "ring"),
                ("all_reduce", "chain"), ("barrier", None),
                ("broadcast", None))
#: The TPU kernel each method replaces (`triton_distributed_tpu/kernels/`);
#: the ring all-reduce is K16's ring, then K15's ring.
COLL_SITES = {
    ("all_gather", "ring"): "allgather.py:301",
    ("all_gather", "push_all"): "allgather.py:301",
    ("all_gather", "bidir_ring"): "allgather.py:283",
    ("reduce_scatter", "scatter_reduce"): "reduce_scatter.py:295",
    ("reduce_scatter", "ring"): "reduce_scatter.py:314",
    ("all_reduce", "one_shot"): "allreduce.py:373",
    ("all_reduce", "two_shot"): "allreduce.py:352",
    ("all_reduce", "chain"): "allreduce.py:330",
    ("all_reduce", "ring"): "reduce_scatter.py:314 + allgather.py:301",
    ("barrier", None): "common_ops.py:52",
    ("broadcast", None): "common_ops.py:91",
}
#: ``TPMLP(mode="fused_ar")`` at Qwen3-8B's MLP widths and world 4: a
#: prefill bucket's rows and a decode batch's.
FUSED_AR_ROWS = (2048, 4)
#: SpFlashDecodeAttention at world 4 on Qwen3-8B's attention geometry:
#: 32 query and 8 KV heads of 128 over the model's native 32,768-token
#: context (8,192 a rank); B = 4 with ragged totals, two shards empty for
#: the first row; pages of 16.
SP_WORLD, SP_CONTEXT, SP_PAGE = 4, 32768, 16
SP_RAGGED = (1, 8193, 16384, 32768)
#: Rows (x 4096 bf16 columns) a rank of the `auto` sweep: 8 KiB to 32 MiB.
SWEEP_ROWS = (1, 4, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def collective_bound(op: str, world: int, shard_bytes: int):
    """The least time of one K15-K18 call on rank-stacked x of
    ``shard_bytes`` a rank and what sets it: each rank's input read once,
    every chunk a rank must receive written once, each output written once
    (`tp_collective_bound`'s count; a copy or a sum is bound by bytes), a
    chunk received into the output counted once, as output.  all_gather:
    W x in, W W x out; reduce_scatter: W x in, (W - 1) / W x received a
    rank, x / W out a rank; all_reduce: the least any method receives, the
    reduce-scatter half's (W - 1) / W x a rank (the all-gather half's
    chunks land in the output), and W x out; broadcast: the root's x in, W
    x out; the barrier: W x in and out."""
    s, w = shard_bytes, world
    moved = {
        "all_gather": w * s + w * w * s,
        "reduce_scatter": w * s + (w - 1) * s + s,
        "all_reduce": w * s + (w - 1) * s + w * s,
        "broadcast": s + w * s,
        "barrier": 2 * w * s,
    }[op]
    return bound(moved, 0)


def collective_path(dev, card: str, counted, expect, short, records,
                    errs) -> None:
    """The collective path: the collective library at world W, the W ranks
    in this process on the one card (`parallel.make_mesh`).

    1. K15 (`all_gather`), K16 (`reduce_scatter`), K17 (`all_reduce`) and
       K18 (`barrier_all_on_axis`, `broadcast`) against their plain
       versions, bit for bit (copies, and f32 sums in each method's fixed
       order and rounding): every method at world 2, 4 and 8 in bf16 and
       f32, on a ragged and an aligned shape (the two-shot's and the ring
       all-reduce's fallback to one-shot, the bidirectional ring's to the
       ring, taken on the ragged one), under a straggler rank and with
       for_correctness, and TP_REPEATS back-to-back calls of each with
       fresh inputs, queued before any is checked;
    2. the main path, with every launch count set to 0 before and read
       after: ``TPMLP(4096, 12288, mode="fused_ar", world_size=4)`` on
       FUSED_AR_ROWS replicated rows, `SpFlashDecodeAttention` at world 4
       over the 32,768-token context (B = 1 and ragged B = 4),
       `sp_flash_decode` over an int8 cache and `sp_flash_decode_paged`,
       and `ops.reduce_scatter`, `ops.broadcast` and `barrier_all_on_axis`;
       one K17 a layer call, one decode kernel and one K15 a decode call;
    3. the layer against its plain version bit for bit (the same bf16
       partials), against the ``fused`` (K12, K14) and ``xla`` layers in
       relative L2 within 3x the xla layer's bf16 error against an f32
       reference, its four ranks' copies equal; the decodes against
       world-1 decode over the whole cache;
    4. times: every method at the fused_ar payloads and the SP payload with
       bounds, plain versions and library yardsticks, the `auto` sweep
       (PERF.md takes the cutoffs from it), fused_ar against fused in
       alternating windows, SP decode against world-1 decode.

    On one card every put is a copy inside one HBM: the times say what the
    protocol and the copies cost here, not what NVLink would."""
    import torch.nn.functional as F

    from triton_distributed_tpu_torch import ops
    from triton_distributed_tpu_torch.kernels import common_ops
    from triton_distributed_tpu_torch.kernels import flash_decode as fd_mod
    from triton_distributed_tpu_torch.kernels.allgather import (
        AllGatherContext, all_gather, all_gather_reference)
    from triton_distributed_tpu_torch.kernels.allreduce import (
        AllReduceContext, all_reduce, all_reduce_reference, resolve)
    from triton_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode, flash_decode_paged, quantize_kv, sp_flash_decode,
        sp_flash_decode_paged)
    from triton_distributed_tpu_torch.kernels.reduce_scatter import (
        ReduceScatterContext, reduce_scatter, reduce_scatter_reference)
    from triton_distributed_tpu_torch.language.core import (
        release_symmetric_buffers)
    from triton_distributed_tpu_torch.layers.sp_flash_decode_layer import (
        SpFlashDecodeAttention)
    from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP, gated_silu
    from triton_distributed_tpu_torch.parallel import make_mesh

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(777)
    t_phase = time.perf_counter()

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def call(op, method, world, x, root=None, **faults):
        """(the kernel's result, a function computing its plain version)."""
        if op == "all_gather":
            return (all_gather(x, AllGatherContext("tp", world, method,
                                                   **faults)),
                    lambda: all_gather_reference(x))
        if op == "reduce_scatter":
            return (reduce_scatter(x, ReduceScatterContext(
                "tp", world, method, **faults)),
                lambda: reduce_scatter_reference(x, method))
        if op == "all_reduce":
            ctx = AllReduceContext("tp", world, method, **faults)
            return all_reduce(x, ctx), lambda: all_reduce_reference(
                x, resolve(x, ctx))
        if op == "barrier":
            return (common_ops.barrier_all_on_axis(x, **faults),
                    lambda: common_ops.barrier_reference(x))
        return (common_ops.broadcast(x, root, "tp", world, **faults),
                lambda: common_ops.broadcast_reference(x, int(root)))

    def operand(op, world, m, n, dtype):
        return randn(world, world * m if op == "reduce_scatter" else m, n,
                     dtype=dtype)

    def root_for(op, world, i):
        """Broadcast roots cycle over the ranks, every other one a 0-d
        device tensor."""
        if op != "broadcast":
            return None
        r = i % world
        return torch.tensor(r, device=dev) if i % 2 else r

    def check_exact(label, got, want):
        ok = got.dtype == want.dtype and got.shape == want.shape and bool(
            torch.equal(got, want))
        if not ok:
            err = float((got.float() - want.float()).abs().max())
            print(f"  {label}: FAIL, max_abs_err {err:.3e} (want 0)")
            raise AssertionError(f"{label}: kernel disagrees with its plain "
                                 "version")

    # -- 1. kernels vs plain, bit for bit
    n_checked = 0
    t0 = time.perf_counter()
    for world in COLL_WORLDS:
        for dtype in (bf16, f32):
            for m, n in COLL_SHAPES:
                runs = []
                for i, (op, method) in enumerate(COLL_METHODS):
                    x = operand(op, world, m, n, dtype)
                    runs.append((op, method, *call(
                        op, method, world, x, root_for(op, world, i))))
                torch.cuda.synchronize()
                for op, method, got, plain in runs:
                    check_exact(f"{op} {method} world {world} {dtype} "
                                f"({m}, {n})", got, plain())
                    n_checked += 1
    print(f"[collective path] K15-K18, every method at world "
          f"{'/'.join(map(str, COLL_WORLDS))} in bf16 and f32 on rows x "
          f"columns {COLL_SHAPES} a rank (K16: world x rows; the ragged "
          f"shape takes the two-shot's and the ring all-reduce's fallback to "
          f"one-shot and the bidirectional ring's to the ring): {n_checked} "
          f"calls bit for bit equal to their plain versions "
          f"({time.perf_counter() - t0:.1f} s)")
    w = SP_WORLD
    for label, faults in (("straggler", {"straggler": COLL_STRAGGLER}),
                          ("for_correctness", {"for_correctness": True})):
        runs = []
        for i, (op, method) in enumerate(COLL_METHODS):
            x = operand(op, w, *COLL_SHAPES[1], bf16)
            runs.append((op, method, *call(op, method, w, x,
                                           root_for(op, w, i), **faults)))
        torch.cuda.synchronize()
        for op, method, got, plain in runs:
            check_exact(f"{op} {method} {label}", got, plain())
    print(f"[collective path] every method at world {w} in bf16 under a "
          f"straggler (rank {COLL_STRAGGLER[0]} spins {COLL_STRAGGLER[1]} "
          f"cycles, about 1 ms) and under for_correctness (rank r spins "
          f"(r + 1) x 100000 cycles): bit for bit ok")
    for i, (op, method) in enumerate(COLL_METHODS):
        ins = [operand(op, w, *COLL_SHAPES[1], bf16)
               for _ in range(TP_REPEATS)]
        outs = [call(op, method, w, x, root_for(op, w, i + j))
                for j, x in enumerate(ins)]
        torch.cuda.synchronize()
        for got, plain in outs:
            check_exact(f"{op} {method} back-to-back", got, plain())
        del ins, outs
    print(f"[collective path] every method at world {w}: {TP_REPEATS} "
          f"back-to-back calls with fresh inputs, queued before any check: "
          f"bit for bit ok")
    for nm in ("all_gather", "reduce_scatter", "all_reduce",
               "barrier_broadcast"):
        errs[nm] = 0.0

    # -- 2. the main path
    h, ffn = MLP_HIDDEN, MLP_FFN
    mlps = {mode: TPMLP(h, ffn, mode=mode, world_size=w, device=dev)
            for mode in ("fused_ar", "fused", "xla")}
    mlps["fused_ar"].init_params(torch.Generator(device=dev).manual_seed(11))
    for mode in ("fused", "xla"):
        mlps[mode].load_state_dict(mlps["fused_ar"].state_dict())
    xs = {m: randn(m, h) for m in FUSED_AR_ROWS}
    cfg8 = dict(heads=32, kv_heads=8, d=128)
    s_loc = SP_CONTEXT // w
    layer = SpFlashDecodeAttention("sp", w, cfg8["heads"], cfg8["kv_heads"],
                                   cfg8["d"], s_loc)

    def kv(b):
        return (randn(b, cfg8["kv_heads"], SP_CONTEXT, cfg8["d"]),
                randn(b, cfg8["kv_heads"], SP_CONTEXT, cfg8["d"]))

    def shards(t):
        """(B, Hkv, S, ...) -> the contiguous layout's (W, B, Hkv, S/W,
        ...)."""
        return t.reshape(*t.shape[:2], w, s_loc, *t.shape[3:]).movedim(
            2, 0).contiguous()

    q1, q4 = randn(1, cfg8["heads"], cfg8["d"]), randn(4, cfg8["heads"],
                                                       cfg8["d"])
    k1, v1 = kv(1)
    k4, v4 = kv(4)
    total1 = torch.tensor([SP_CONTEXT], dtype=torch.int32, device=dev)
    total4 = torch.tensor(SP_RAGGED, dtype=torch.int32, device=dev)
    ranks = torch.arange(w, device=dev)[:, None]
    local1 = layer.local_kv_len(total1[None], ranks).to(torch.int32)
    local4 = layer.local_kv_len(total4[None], ranks).to(torch.int32)
    k1s, v1s, k4s, v4s = shards(k1), shards(v1), shards(k4), shards(v4)
    k1q, v1q, ks1, vs1 = quantize_kv(k1, v1)
    k1qs, v1qs, ks1s, vs1s = (shards(t) for t in (k1q, v1q, ks1, vs1))
    # Paged: rank r's shard of each row in its own pool, pages shuffled.
    t_pages = s_loc // SP_PAGE
    tables, pools_k, pools_v, n_pages = [], [], [], 1 + 4 * t_pages
    for r in range(w):
        table, _ = shuffled_table(gen, local4[r].tolist(), SP_PAGE, t_pages,
                                  dev)
        tables.append(table)
        pools_k.append(scatter_to_pool(k4s[r], table, n_pages, SP_PAGE, 0.0))
        pools_v.append(scatter_to_pool(v4s[r], table, n_pages, SP_PAGE, 0.0))
    tables = torch.stack(tables)
    pools_k, pools_v = torch.stack(pools_k), torch.stack(pools_v)
    mesh = make_mesh(w, device=dev)
    rs_in = randn(w, w * 64, 1024)
    bc_in = randn(w, 64, 1024)
    got, gathers = {}, []

    def capturing_all_gather(payload, ctx):
        """The SP decodes' K15 call, its (input, output) kept to be held
        against `all_gather_reference` at the main path's payload."""
        out = all_gather(payload, ctx)
        gathers.append((payload, out))
        return out

    def main_path():
        with torch.inference_mode():
            for m, x in xs.items():
                got[("fused_ar", m)] = mlps["fused_ar"](x)
            got["sp1"] = layer(q1, k1s, v1s, total1)
            got["sp4"] = layer(q4, k4s, v4s, total4)
            got["sp1_int8"] = sp_flash_decode(q1, k1qs, v1qs, local1,
                                              k_scale=ks1s, v_scale=vs1s)
            got["sp4_paged"] = sp_flash_decode_paged(q4, pools_k, pools_v,
                                                     tables, local4)
            got["rs"] = ops.reduce_scatter(rs_in, mesh)
            got["bc"] = ops.broadcast(bc_in, 2, mesh)
            got["barrier"] = common_ops.barrier_all_on_axis(bc_in)
        torch.cuda.synchronize()

    fd_mod.all_gather = capturing_all_gather
    try:
        launches = counted(main_path)
    finally:
        fd_mod.all_gather = all_gather
    want = expect(all_reduce=len(FUSED_AR_ROWS), flash_decode=2,
                  flash_decode_int8=1, flash_decode_paged=1, all_gather=4,
                  reduce_scatter=1, barrier_broadcast=2)
    print(f"[collective path] main path: TPMLP(fused_ar) at {FUSED_AR_ROWS} "
          f"rows, SP decode B=1 and B=4 (layer), int8 and paged, "
          f"ops.reduce_scatter, ops.broadcast, barrier_all_on_axis; "
          f"launches {short(launches)}")
    if launches != want:
        raise AssertionError(f"collective path launches {short(launches)} "
                             f"!= {short(want)}")
    check_exact("ops.reduce_scatter", got["rs"],
                reduce_scatter_reference(rs_in))
    check_exact("ops.broadcast", got["bc"],
                common_ops.broadcast_reference(bc_in, 2))
    check_exact("barrier_all_on_axis", got["barrier"], bc_in)

    # -- 3. the layer and the decodes against their references
    with torch.inference_mode():
        for m, x in xs.items():
            out = got[("fused_ar", m)]
            mlp = mlps["fused_ar"]
            partial = torch.matmul(gated_silu(torch.matmul(x, mlp.gate_up)),
                                   mlp.down)
            ctx = AllReduceContext("tp", w)
            method = resolve(partial, ctx).value
            check_exact(f"TPMLP fused_ar {m} rows vs plain ({method})",
                        out, all_reduce_reference(partial, method))
            same = bool(torch.equal(out, out[:1].expand_as(out)))
            xf = x.float()
            ref = sum((F.silu(xf @ g[:, :ffn // w].float())
                       * (xf @ g[:, ffn // w:].float())) @ d.float()
                      for g, d in zip(mlp.gate_up, mlp.down))
            fused = mlps["fused"](x.reshape(w, m // w, h)).reshape(m, h)
            xla = mlps["xla"](x.reshape(w, m // w, h)).reshape(m, h)
            floor = rel_l2(xla, ref)
            rels = {"xla": rel_l2(out[0], xla), "fused": rel_l2(out[0], fused),
                    "f32": rel_l2(out[0], ref)}
            ok = same and all(v <= 3 * floor for v in rels.values())
            print(f"[collective path] TPMLP({h}, {ffn}, fused_ar, world {w}) "
                  f"on {m} rows: auto all-reduce {method}, bit for bit equal "
                  f"to its plain version, ranks' copies equal {same}; rel_l2 "
                  f"vs xla {rels['xla']:.3e}, vs fused {rels['fused']:.3e}, "
                  f"vs f32 {rels['f32']:.3e} (bound {3 * floor:.3e}, 3x the "
                  f"xla layer's bf16 error {floor:.3e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("fused_ar layer check failed")
        refs = {"sp1": flash_decode(q1, k1, v1, total1)[0],
                "sp4": flash_decode(q4, k4, v4, total4)[0],
                "sp1_int8": flash_decode(q1, k1q, v1q, total1, k_scale=ks1,
                                         v_scale=vs1)[0]}
        refs["sp4_paged"] = refs["sp4"]
    # Each SP decode three ways: (a) its K15 call at the main path's payload
    # (W x B*H rows of D + 1 f32, padded to 16 bytes) bit for bit against
    # the plain all-gather; (b) its output against an f64 LSE combine of the
    # partials it gathered, each shard gated by its own filled length, to
    # within one bf16 rounding (2^-8 |ref|, doubled for the f32 combine's
    # own rounding before it), which a dropped, mis-weighted or unmasked
    # shard breaks on most elements; (c) end to end against
    # world-1 decode over the whole cache, row-scaled (`check_rows`: tol
    # 5e-2 of |ref| + the row's rms, rel_l2 1e-2), room for the shards'
    # partials being rounded to bf16 once more than world-1's output.
    lens = {"sp1": local1, "sp4": local4, "sp1_int8": local1,
            "sp4_paged": local4}
    if len(gathers) != len(refs):
        raise AssertionError(f"SP decodes made {len(gathers)} K15 calls, "
                             f"want {len(refs)}")
    d = cfg8["d"]
    for (key, ref), (payload, gathered) in zip(refs.items(), gathers):
        out = got[key]
        check_exact(f"K15 push_all on the SP payload {key} "
                    f"{tuple(payload.shape)} f32", gathered,
                    all_gather_reference(payload))
        b = ref.shape[0]
        parts = payload.double().reshape(w, b, cfg8["heads"], -1)
        live = (lens[key] > 0)[..., None]                   # (W, B, 1)
        lse = torch.where(live, parts[..., d], float("-inf"))
        wts = torch.exp(lse - lse.max(0).values)
        comb = (wts[..., None] * torch.where(live[..., None], parts[..., :d],
                                             0.0)).sum(0)
        comb = comb / wts.sum(0)[..., None]
        err = (out[0].double() - comb).abs()
        lim = 2.0 ** -7 * comb.abs() + 1e-6 * comb.pow(2).mean().sqrt()
        ok = bool((err <= lim).all())
        print(f"  SP decode {key}: K15 on its payload "
              f"{tuple(payload.shape)} bit for bit equal to its plain "
              f"version; output against the f64 LSE combine of the "
              f"gathered partials: max_abs_err {float(err.max()):.3e}, "
              f"max err/(2^-7 |ref|) {float((err / lim).max()):.3f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"SP decode {key}: combine disagrees with "
                                 "the LSE combine of its partials")
        same = bool(torch.equal(out, out[:1].expand_as(out)))
        e = check_rows(f"SP decode {key} world {w} vs world-1 decode "
                       f"(ranks' copies equal {same})", out[0], ref,
                       5e-2, 1e-2, 0.1)
        if not same or not bool(out.isfinite().all()):
            raise AssertionError(f"SP decode {key}: ranks differ or non-"
                                 "finite")
        errs["flash_decode"] = max(errs["flash_decode"], e)
    del refs, gathers

    # -- 4. times
    print(f"[times] K15-K18 at world {w} on one card (every put a copy "
          f"inside one HBM, no NVLink); CUDA events; bounds count each "
          f"rank's x read once, every chunk it must receive and each output "
          f"written once at 3.35 TB/s; {card}")
    libraries = {
        "all_gather": ("x.reshape(1, W*m, n).expand(W, -1, -1).contiguous()",
                       lambda x: x.reshape(1, -1, x.shape[-1]).expand(
                           w, -1, -1).contiguous()),
        "reduce_scatter": ("x.view(W, W, m, n).sum(0, dtype=f32).to(x.dtype)",
                           lambda x: x.view(w, w, -1, x.shape[-1]).sum(
                               0, dtype=f32).to(x.dtype)),
        "all_reduce": ("x.sum(0, dtype=f32).to(x.dtype).expand(W, m, n)"
                       ".contiguous()",
                       lambda x: x.sum(0, dtype=f32).to(x.dtype).expand(
                           w, -1, -1).contiguous()),
        "broadcast": ("x[root].expand(W, m, n).contiguous()",
                      lambda x: x[2].expand(w, -1, -1).contiguous()),
        "barrier": ("x.clone()", lambda x: x.clone()),
    }
    payloads = [(f"{m}x{h} bf16", m, h, bf16) for m in FUSED_AR_ROWS]
    payloads.append(("SP payload 32x132 f32", 32, 132, f32))
    rows_by_op = {}
    for label, m, n, dtype in payloads:
        for op in ("all_gather", "reduce_scatter", "all_reduce", "broadcast",
                   "barrier"):
            if op == "reduce_scatter" and label.startswith("SP"):
                continue
            x = randn(w, m, n, dtype=dtype)
            shard = x[0].numel() * x.element_size()
            methods = [mt for o, mt in COLL_METHODS if o == op]
            root = 2 if op == "broadcast" else None
            ms = {mt: time_ms(lambda: call(op, mt, w, x, root)[0], 20)
                  for mt in methods}
            plain = time_ms(lambda: call(op, methods[0], w, x, root)[1](), 5)
            lib_name, lib_fn = libraries[op]
            lib = time_ms(lambda: lib_fn(x), 20)
            bms, by = collective_bound(op, w, shard)
            times = ", ".join(f"{mt or op} {t:.4f} ms ({bms / t:.1%} of "
                              "bound)" for mt, t in ms.items())
            print(f"[times] {op} world {w} x{tuple(x.shape)} {label}: "
                  f"{times}; bound {bms:.4f} ms by {by}; plain {plain:.4f} "
                  f"ms; library ({lib_name}) {lib:.4f} ms; {card}")
            rows_by_op[(op, label)] = (ms, plain, bms, by, lib, lib_name)
    # K15-K17 records: the method `auto` takes at the prefill payload;
    # K18's: the broadcast, the barrier's time beside it.
    m0 = f"{FUSED_AR_ROWS[0]}x{h} bf16"
    auto = {"all_gather": AllGatherContext("tp", w).resolve_method(
                FUSED_AR_ROWS[0] * h * 2).value,
            "reduce_scatter": ReduceScatterContext(
                "tp", w).resolve_method().value,
            "all_reduce": resolve(xs[FUSED_AR_ROWS[0]].expand(w, -1, -1),
                                  AllReduceContext("tp", w)).value,
            "broadcast": None}
    for op, method in auto.items():
        ms, plain, bms, by, lib, lib_name = rows_by_op[(op, m0)]
        extra = {"method": method or "broadcast", "shape": m0,
                 "replaces": _TPU + COLL_SITES[(op, method)],
                 "method_ms": {mt or op: t for mt, t in ms.items()},
                 "library_note": lib_name + " (one card: no NVLink)"}
        if op == "broadcast":
            extra["barrier_ms"] = rows_by_op[("barrier", m0)][0][None]
            extra["barrier_replaces"] = _TPU + COLL_SITES[("barrier", None)]
        records.append(("barrier_broadcast" if op == "broadcast" else op,
                        ms[method], plain, bms, by, lib, extra))

    print(f"[times] auto sweep at world {w}, bf16 x (rows, {h}) a rank, ms "
          f"per method (CUDA events); {card}")
    for rows in SWEEP_ROWS:
        line = []
        for op in ("all_gather", "reduce_scatter", "all_reduce"):
            x = operand(op, w, rows, h, bf16)
            for o, mt in COLL_METHODS:
                if o == op:
                    t = time_ms(lambda: call(op, mt, w, x)[0], 10)
                    line.append(f"{op}.{mt} {t:.4f}")
            del x
        print(f"[sweep] {rows} rows ({rows * h * 2} bytes a rank): "
              + ", ".join(line))

    window = {"fused_ar": [], "fused": []}
    with torch.inference_mode():
        for m, x in xs.items():
            xr = x.reshape(w, m // w, h)
            for mode in ("fused_ar", "fused", "fused", "fused_ar"):
                arg = x if mode == "fused_ar" else xr
                window[mode].append((m, time_ms(lambda: mlps[mode](arg),
                                                10)))
    print(f"[times] TPMLP({h}, {ffn}) at world {w}, ms per call (CUDA "
          f"events) in the order fused_ar, fused, fused, fused_ar for each "
          f"row count: " + "; ".join(
              f"{mode} " + ", ".join(f"{m} rows {t:.4f}" for m, t in ts)
              for mode, ts in window.items()) + f"; {card}")
    with torch.inference_mode():
        t_sp = time_ms(lambda: layer(q1, k1s, v1s, total1), 20)
        t_w1 = time_ms(lambda: flash_decode(q1, k1, v1, total1), 20)
        q_ranks = q1.expand(w, -1, -1).contiguous()
        t_local = time_ms(lambda: flash_decode(
            q_ranks, k1s.reshape(w, cfg8["kv_heads"], s_loc, cfg8["d"]),
            v1s.reshape(w, cfg8["kv_heads"], s_loc, cfg8["d"]),
            local1.reshape(w)), 20)
        t_sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            q1[:, :, None], k1, v1, enable_gqa=True), 20)
    bms, by = bound(nbytes(q1, k1, v1) + nbytes(q1),
                    4 * cfg8["heads"] * SP_CONTEXT * cfg8["d"])
    print(f"[times] SP decode B=1 over {SP_CONTEXT} tokens (Qwen3-8B heads, "
          f"world {w}, {s_loc} a rank): layer {t_sp:.4f} ms (K2 over every "
          f"shard in one launch {t_local:.4f} ms, then K15 and the combine); "
          f"world-1 flash_decode {t_w1:.4f} ms; bound {bms:.4f} ms by {by} "
          f"({bms / t_sp:.1%} / {bms / t_w1:.1%} of bound); SDPA (library) "
          f"{t_sdpa:.4f} ms; {card}")
    del mlps, xs, got, k1, v1, k4, v4, k1s, v1s, k4s, v4s, pools_k, pools_v
    release_symmetric_buffers()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[collective path] the phase took "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)")


#: The EP path: Qwen3-30B-A3B's MoE (MOE_FIELDS: hidden 2048, 128 experts
#: of 768, top-8) split over EP_WORLD ranks (32 experts a rank) on the one
#: card; EP_TOKENS tokens a rank, each (source, destination) block holding
#: every pair a rank could send (EP_TOKENS x 8: nothing drops); a decode
#: batch of EP_DECODE = (tokens a rank, block capacity).  K19 is held bit
#: for bit at these worlds on a ragged block (rows and bytes off 16) and an
#: aligned one, with no scales, one f32 scale a row and three.
EP_WORLD, EP_TOKENS, EP_DECODE = 4, 512, (4, 32)
EP_WORLDS = (2, 4, 8)
EP_A2A_SHAPES = ((37, 1001), (64, 2048))


def ep_experts(recv, recv_counts, recv_expert, gate_up, down, moe_utils,
               grouped_matmul, gated_silu):
    """The EP path's expert pass (harness code, not a package module): the
    rows each rank received, masked by their counts, bucketed per local
    expert with `route_capacity` at a capacity where none drops; rank r's
    local expert e is global expert r * E/W + e, so every rank's buckets
    go through one K8 launch a product (gate_up, the gated SiLU, down).
    Returns the processed rows in arrival layout (W, W, cap, hidden), zeros
    past the counts."""
    w, _, cap, h = recv.shape
    e = gate_up.shape[0]
    rows = recv.reshape(-1, h)
    valid = (torch.arange(cap, device=recv.device)[None, None, :]
             < recv_counts)                                 # (W, W, cap)
    rank = torch.arange(w, device=recv.device)[:, None, None]
    gid = torch.where(valid, rank * (e // w) + recv_expert.long(), e)
    counts = moe_utils.histogram(gid, e + 1)[:e]
    cap_e = max(16, -(-int(counts.max()) // 16) * 16)
    routing = moe_utils.route_capacity(gid.reshape(-1, 1), e + 1, cap_e)
    index = routing.dispatch_index[:e]
    buckets = moe_utils.gather_tokens(rows, index)
    y = grouped_matmul(gated_silu(grouped_matmul(buckets, gate_up)), down)
    out = rows.new_zeros((rows.shape[0] + 1, h))
    out[index.reshape(-1).long()] = y.reshape(-1, h)
    return out[:-1].view(w, w, cap, h), cap_e


def ep_path(dev, card: str, counted, expect, short, records, errs) -> None:
    """The EP path: expert parallelism at world EP_WORLD, the ranks in this
    process on the one card (`EPAll2AllLayer` over K19,
    `fast_all_to_all`), at Qwen3-30B-A3B's MoE widths.

    1. K19 against its plain version (the two rank axes swapped) bit for
       bit at worlds 2, 4 and 8 in bf16, f32 and int8 on a ragged and an
       aligned block, with no scales, one f32 scale a row (the EP layer's
       expert ids) and three; under a straggler rank and for_correctness;
       and over TP_REPEATS back-to-back calls with fresh inputs, queued
       before any is checked;
    2. the main path, with every launch count set to 0 before and read
       after: 512 seeded bf16 tokens a rank routed by the port's
       `moe_mlp.route` on a seeded (2048, 128) f32 router (top 8),
       `dispatch` (K19), layer 0's 32 local experts a rank on K8
       (`ep_experts`), `combine` (K19): two K19 and two K8 launches;
    3. the identity round trip on the card bit for bit against the same
       layer over `fast_all_to_all_reference`, and the tokens * sum(w)
       property; the expert round trip against `MoEMLP(mode="xla")` at world
       1 on the same 2,048 tokens and weights with a capacity at which
       nothing drops, both within 3x that layer's bf16 error of an f32
       reference; the decode-sized case (4 tokens a rank, capacity 32) the
       same ways;
    4. times: K19 at the dispatch's payload against its byte bound, its
       plain version and one copy (`send.transpose(0, 1).contiguous()`),
       K19 at the decode size, and the whole dispatch -> experts -> combine.

    On one card every put is a copy inside one HBM: the times say what the
    kernel and the copies cost here, not what NVLink would carry."""
    from triton_distributed_tpu_torch.kernels import moe_utils
    from triton_distributed_tpu_torch.kernels.grouped_gemm import (
        grouped_matmul)
    from triton_distributed_tpu_torch.kernels.low_latency_all_to_all import (
        AllToAllContext, fast_all_to_all, fast_all_to_all_reference)
    from triton_distributed_tpu_torch.language.core import (
        release_symmetric_buffers)
    from triton_distributed_tpu_torch.layers import EPAll2AllLayer
    from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP, route
    from triton_distributed_tpu_torch.layers.tp_mlp import gated_silu

    bf16, f32 = torch.bfloat16, torch.float32
    h, e = MOE_FIELDS["hidden_size"], MOE_FIELDS["num_experts"]
    topk, ffn = MOE_FIELDS["num_experts_per_tok"], MOE_FIELDS[
        "moe_intermediate_size"]
    w, n = EP_WORLD, EP_TOKENS
    gen = torch.Generator(device=dev).manual_seed(4321)
    t_phase = time.perf_counter()

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def payload(world, cap, hid, dtype, ns):
        send = (randn(world, world, cap, hid, dtype=f32) * 40).clamp(
            -127, 127).to(dtype)
        counts = torch.randint(0, cap + 1, (world, world, 1), generator=gen,
                               device=dev, dtype=torch.int32)
        scales = (None if not ns else randn(world, world, cap, ns,
                                            dtype=f32))
        return send, counts, scales

    def check_exact(label, got, want):
        for g, x in zip(got, want):
            if g.dtype != x.dtype or g.shape != x.shape or not bool(
                    torch.equal(g, x)):
                raise AssertionError(f"{label}: K19 disagrees with its "
                                     "plain version")

    def a2a(world, send, counts, scales, **faults):
        ctx = AllToAllContext("ep", world, send.shape[2], send.shape[3],
                              **faults)
        return fast_all_to_all(send, counts, ctx, send_scales=scales)

    # -- 1. K19 against its plain version, bit for bit
    runs = []
    for world in EP_WORLDS:
        for dtype in (bf16, f32, torch.int8):
            for (cap, hid), ns in ((EP_A2A_SHAPES[0], 1),
                                   (EP_A2A_SHAPES[1], 0),
                                   (EP_A2A_SHAPES[1], 3)):
                args = payload(world, cap, hid, dtype, ns)
                runs.append((f"world {world} {dtype} ({cap}, {hid}) ns {ns}",
                             args, a2a(world, *args)))
    torch.cuda.synchronize()
    for label, args, got in runs:
        check_exact(label, got, fast_all_to_all_reference(*args))
    for label, faults in (("straggler", {"straggler": COLL_STRAGGLER}),
                          ("for_correctness", {"for_correctness": True})):
        args = payload(w, *EP_A2A_SHAPES[1], bf16, 1)
        got = a2a(w, *args, **faults)
        torch.cuda.synchronize()
        check_exact(label, got, fast_all_to_all_reference(*args))
    ins = [payload(w, *EP_A2A_SHAPES[1], bf16, 1) for _ in range(TP_REPEATS)]
    outs = [a2a(w, *args) for args in ins]
    torch.cuda.synchronize()
    for args, got in zip(ins, outs):
        check_exact("back-to-back", got, fast_all_to_all_reference(*args))
    del ins, outs, runs
    errs["all_to_all"] = 0.0
    print(f"[ep path] K19 at world {'/'.join(map(str, EP_WORLDS))} in bf16, "
          f"f32 and int8 on blocks (cap, hidden) {EP_A2A_SHAPES} with 0, 1 "
          f"and 3 scale columns, under a straggler (rank "
          f"{COLL_STRAGGLER[0]} spins {COLL_STRAGGLER[1]} cycles) and "
          f"for_correctness, and {TP_REPEATS} back-to-back calls with fresh "
          f"inputs queued before any check: bit for bit equal to the plain "
          f"version")

    # -- 2. the main path
    x = randn(w, n, h)
    router = randn(h, e, dtype=f32) * h ** -0.5
    gate_up = randn(e, h, 2 * ffn) * h ** -0.5
    down = randn(e, ffn, h) * ffn ** -0.5
    routed = [route(x[r], router, topk) for r in range(w)]
    ids = torch.stack([i for i, _ in routed])
    wts = torch.stack([p for _, p in routed])
    layer = EPAll2AllLayer("ep", w, e, topk, n * topk, h)
    got = {}

    def roundtrip(lay, xx, ii, ww, experts):
        recv, recv_e, recv_c, plan = lay.dispatch(xx, ii)
        if experts:
            out, cap_e = ep_experts(recv, recv_c, recv_e, gate_up, down,
                                    moe_utils, grouped_matmul, gated_silu)
            got["cap_e"] = cap_e
        else:
            out = recv
        return (recv, recv_e, recv_c), lay.combine(out, recv_c, plan, ww, ii)

    def main_path():
        with torch.inference_mode():
            got["ep"] = roundtrip(layer, x, ids, wts, True)
        torch.cuda.synchronize()

    launches = counted(main_path)
    want = expect(all_to_all=2, grouped_matmul=2)
    print(f"[ep path] main path: {w} ranks x {n} tokens of hidden {h}, top "
          f"{topk} of {e} experts ({e // w} a rank), blocks of {n * topk} "
          f"rows: dispatch, layer 0's experts on K8 (capacity "
          f"{got['cap_e']}, none dropped), combine; launches "
          f"{short(launches)}")
    if launches != want:
        raise AssertionError(f"ep path launches {short(launches)} != "
                             f"{short(want)}")

    # -- 3. checks
    class PlainLayer(EPAll2AllLayer):
        def _exchange(self, send_tokens, counts, cid, send_scales=None):
            return fast_all_to_all_reference(send_tokens, counts,
                                             send_scales)

    def identity_check(label, xx, ii, ww, cap):
        lay = EPAll2AllLayer("ep", w, e, topk, cap, h)
        plain = PlainLayer("ep", w, e, topk, cap, h)
        with torch.inference_mode():
            kd, kout = roundtrip(lay, xx, ii, ww, False)
            pd, pout = roundtrip(plain, xx, ii, ww, False)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, b)) for a, b in zip(kd + (kout,),
                                                            pd + (pout,)))
        prop = (xx.float() * ww.sum(-1, keepdim=True)).to(bf16)
        err = float((kout.float() - prop.float()).abs().max())
        ok = same and bool(torch.allclose(kout.float(), prop.float(),
                                          atol=1e-6, rtol=2.0 ** -7))
        print(f"[ep path] {label} identity round trip (capacity {cap}): "
              f"dispatch and combine bit for bit equal to the layer on the "
              f"plain exchange {same}; against tokens * sum(w) max_abs_err "
              f"{err:.3e} (rtol 2^-7, one bf16 rounding) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ep path {label} identity round trip")

    identity_check("prefill", x, ids, wts, n * topk)
    xd = randn(w, EP_DECODE[0], h)
    rd = [route(xd[r], router, topk) for r in range(w)]
    idd = torch.stack([i for i, _ in rd])
    wd = torch.stack([p for _, p in rd])
    identity_check("decode", xd, idd, wd, EP_DECODE[1])

    def world1_check(label, xx, ii, ww, out_ep):
        """The EP round trip against `MoEMLP(mode="xla")` at world 1 on the
        same tokens and weights, both held to an f32 reference."""
        flat, fi, fw = xx.reshape(-1, h), ii.reshape(-1, topk), ww.reshape(
            -1, topk)
        counts = moe_utils.histogram(fi, e)
        cap = max(16, -(-int(counts.max()) // 16) * 16)
        mlp = MoEMLP(h, ffn, e, topk=topk, mode="xla", device=dev,
                     capacity_factor=cap / (flat.shape[0] * topk / e))
        if mlp.capacity(flat.shape[0]) < int(counts.max()):
            raise AssertionError("world-1 capacity drops pairs")
        with torch.no_grad():
            mlp.router.copy_(router)
            mlp.gate_up.copy_(gate_up)
            mlp.down.copy_(down)
            xla = mlp(flat)
            routing = moe_utils.route_capacity(fi, e, cap)
            b = moe_utils.gather_tokens(flat.float(), routing.dispatch_index)
            y = torch.bmm(gated_silu(torch.bmm(b, gate_up.float())),
                          down.float())
            ref = moe_utils.combine_tokens(y, fi, routing.slot_of_pair, fw)
        floor = rel_l2(xla, ref)
        rels = {"f32": rel_l2(out_ep.reshape(-1, h), ref),
                "xla": rel_l2(out_ep.reshape(-1, h), xla)}
        ok = all(v <= 3 * floor for v in rels.values()) and bool(
            out_ep.isfinite().all())
        print(f"[ep path] {label} expert round trip vs MoEMLP(xla) at world "
              f"1 on the same {flat.shape[0]} tokens (capacity {cap}, none "
              f"dropped): rel_l2 vs f32 {rels['f32']:.3e}, vs xla "
              f"{rels['xla']:.3e} (bound {3 * floor:.3e}, 3x the xla "
              f"layer's bf16 error {floor:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ep path {label} expert round trip")

    world1_check("prefill", x, ids, wts, got["ep"][1])
    with torch.inference_mode():
        dec = roundtrip(EPAll2AllLayer("ep", w, e, topk, EP_DECODE[1], h),
                        xd, idd, wd, True)
    world1_check("decode", xd, idd, wd, dec[1])

    # -- 4. times
    ctx = AllToAllContext("ep", w, n * topk, h)
    with torch.inference_mode():
        recv, recv_e, recv_c, plan = layer.dispatch(x, ids)
        # The dispatch's own exchange: send blocks, counts, expert ids.
        send = recv.transpose(0, 1).contiguous()
        counts = recv_c.transpose(0, 1).contiguous()
        scales = recv_e.float()[..., None].transpose(0, 1).contiguous()
        ms = time_ms(lambda: fast_all_to_all(send, counts, ctx,
                                             send_scales=scales), 20)
        plain = time_ms(lambda: fast_all_to_all_reference(send, counts,
                                                          scales), 20)
        lib = time_ms(lambda: send.transpose(0, 1).contiguous(), 20)
        bms, by = bound(2 * nbytes(send, counts, scales), 0)
        sd, scd = (t[:, :, :EP_DECODE[1]].contiguous()
                   for t in (send, scales))
        cd = counts.clamp_max(EP_DECODE[1])
        ctx_d = AllToAllContext("ep", w, EP_DECODE[1], h)
        ms_d = time_ms(lambda: fast_all_to_all(sd, cd, ctx_d,
                                               send_scales=scd), 50)
        bms_d, _ = bound(2 * nbytes(sd, cd, scd), 0)
        t_rt = time_ms(lambda: roundtrip(layer, x, ids, wts, True), 5)
        t_disp = time_ms(lambda: layer.dispatch(x, ids), 10)
    print(f"[times] K19 fast_all_to_all at world {w} on the dispatch's "
          f"payload ({tuple(send.shape)} bf16 + counts + one f32 expert id a "
          f"row, {nbytes(send, counts, scales) / 2**20:.1f} MiB in all): "
          f"{ms:.4f} ms (bound {bms:.4f} ms by {by}: every send block read "
          f"once and every receive block written once at 3.35 TB/s, "
          f"{bms / ms:.1%} of bound); plain {plain:.4f} ms; one copy "
          f"(send.transpose(0, 1).contiguous()) {lib:.4f} ms; decode blocks "
          f"{tuple(sd.shape)} {ms_d:.4f} ms (bound {bms_d:.4f}); {card}")
    print(f"[times] EP round trip at world {w} ({n} tokens a rank): "
          f"dispatch {t_disp:.4f} ms, dispatch -> experts (K8 x2) -> combine "
          f"{t_rt:.4f} ms (CUDA events; the expert pass reads its bucket "
          f"capacity back to the host once a call); {card}")
    records.append(("all_to_all", ms, plain, bms, by, lib, {
        "shape": f"{tuple(send.shape)} bf16 + counts + scales (W, W, "
                 f"{n * topk}, 1) f32",
        "library_note": "send.transpose(0, 1).contiguous(), tokens only "
                        "(one card: no NVLink)",
        "decode_ms": ms_d, "decode_bound_ms": bms_d}))
    del x, gate_up, down, got, send, recv, dec
    release_symmetric_buffers()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ep path] the phase took {time.perf_counter() - t_phase:.1f} s "
          "(host clock)")


#: The SP attention path: Qwen3-8B's attention (32 query and 8 KV heads of
#: 128) over its native 32,768-token context at SP_WORLD = 4 (8,192 rows a
#: rank), B = 1, bf16; ring training on 4 x SP_TRAIN_ROWS.  K20 against its
#: plain version at these worlds on (label, B, H, Hkv, S_loc, D, dtype):
SP_ATTN_CONTEXT, SP_TRAIN_ROWS = 32768, 2048
SP_K20_CASES = (("GQA 4", 1, 8, 2, 256, 128, torch.bfloat16),
                ("GQA 1 S_loc 24", 2, 4, 4, 24, 128, torch.bfloat16),
                ("f32 d64 S_loc 100", 1, 4, 2, 100, 64, torch.float32))


def sp_path(dev, card: str, counted, expect, short, records, errs) -> None:
    """The SP attention path: sequence-parallel causal prefill at world
    SP_WORLD, the ranks in this process on the one card.

    1. K20 (`sp_ag_attention_fused`) against its plain version (the TPU
       kernel's chunk-by-chunk schedule in f32) at worlds 2, 4 and 8 on
       SP_K20_CASES, and with caller offsets (q_offset r * S_loc + 5,
       kv_base (3, 0, 7, 1)): out row by row, lse within 1e-3; rank 0's
       output bit for bit equal to K1's on its own chunk (the shared tile
       body); under a straggler and for_correctness, and TP_REPEATS
       back-to-back calls with fresh inputs, queued before any check;
    2. the main path, with every launch count set to 0 before and read
       after: 32,768 tokens of Qwen3-8B's heads at world 4 through
       `sp_ag_attention_fused` (one K20), `sp_ag_attention_gather` (one K15
       ring, one K1 a rank), `sp_ring_attention` (one K1 a step) and
       `sp_ring_attention_zigzag` (three K1 a step);
    3. every output row by row against world-1 `flash_attention` over the
       whole sequence (K1), K20's lse within 1e-3 of K1's, K20 against its
       plain version;
    4. training: `sp_ring_attention_diff` on 4 x SP_TRAIN_ROWS tokens, the
       q, k and v gradients of sum(out * w) row by row against
       `flash_attention_diff` at world 1 over the whole sequence, with
       exact K1/K4/K5 launches;
    5. times: K20 against its bound (the causal pairs' operations at 989
       TFLOP/s, or its bytes), its plain version, and one PyTorch call over
       the whole sequence (`F.scaled_dot_product_attention`, causal, no
       ring); each composition and world-1 K1 beside it.

    On one card the ranks share the SMs: in the natural layout rank r
    attends r + 1 chunks, so the last rank's blocks set K20's time."""
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import flash_attention as fa
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp
    from triton_distributed_tpu_torch.language.core import (
        release_symmetric_buffers)

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(2468)
    t_phase = time.perf_counter()

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def shards(t, world):
        """Global (B, H, S, D) -> the rank-stacked (W, B, H, S/W, D)."""
        b, hh, s, d = t.shape
        return t.reshape(b, hh, world, s // world, d).movedim(
            2, 0).contiguous()

    def unshard(t):
        t = t.movedim(0, 2)
        return t.reshape(*t.shape[:2], -1, *t.shape[4:])

    def k20_case(world, b, hh, hkv, s_loc, d, dtype, **kw):
        q = randn(world, b, hh, s_loc, d, dtype=dtype)
        k = randn(world, b, hkv, s_loc, d, dtype=dtype)
        v = randn(world, b, hkv, s_loc, d, dtype=dtype)
        return (q, k, v), sp.sp_ag_attention_fused(q, k, v, return_lse=True,
                                                   **kw)

    def hold(label, args, got, kw, dtype):
        ref_o, ref_l = sp.sp_ag_attention_fused_reference(
            *args, kw.get("q_offset"), kw.get("kv_base", 0))
        tol = (2e-2, 1e-2) if dtype == bf16 else (1e-4, 1e-4)
        e = check_rows(f"K20 {label} out", got[0], ref_o, *tol, 0.1)
        check_close(f"K20 {label} lse", got[1], ref_l, 1e-3, 0.0)
        return e

    # -- 1. K20 against its plain version
    offsets = dict(q_offset=[r * 256 + 5 for r in range(SP_WORLD)],
                   kv_base=[3, 0, 7, 1])
    runs = []
    for world in COLL_WORLDS:
        for label, b, hh, hkv, s_loc, d, dtype in SP_K20_CASES:
            runs.append((f"world {world} {label}", dtype, {},
                         *k20_case(world, b, hh, hkv, s_loc, d, dtype)))
    runs.append((f"world {SP_WORLD} offsets", bf16, offsets,
                 *k20_case(SP_WORLD, 1, 8, 2, 256, 128, bf16, **offsets)))
    for label, faults in (("straggler", {"straggler": COLL_STRAGGLER}),
                          ("for_correctness", {"for_correctness": True})):
        runs.append((f"world {SP_WORLD} GQA 4 {label}", bf16, {},
                     *k20_case(SP_WORLD, 1, 8, 2, 256, 128, bf16, **faults)))
    torch.cuda.synchronize()
    err = 0.0
    for label, dtype, kw, args, got in runs:
        err = max(err, hold(label, args, got, kw, dtype))
        if not kw:
            q, k, v = args
            k1 = fa.flash_attention(q[0], k[0], v[0], return_lse=True)
            if not (torch.equal(k1[0], got[0][0])
                    and torch.equal(k1[1], got[1][0])):
                raise AssertionError(f"K20 {label}: rank 0 differs from K1 "
                                     "on its own chunk")
    ins = [k20_case(SP_WORLD, 1, 8, 2, 256, 128, bf16)
           for _ in range(TP_REPEATS)]
    torch.cuda.synchronize()
    for args, got in ins:
        ref_o, ref_l = sp.sp_ag_attention_fused_reference(*args)
        _, ratio, rel = row_errors(got[0], ref_o, 0.1)
        if ratio > 2e-2 or rel > 1e-2 or not bool(torch.allclose(
                got[1], ref_l, atol=1e-3, rtol=0.0)):
            raise AssertionError("K20 back-to-back call disagrees with its "
                                 "plain version")
    del ins, runs
    errs["sp_ag_attention_fused"] = err
    print(f"[sp path] K20 at world {'/'.join(map(str, COLL_WORLDS))} on "
          f"{[c[0] for c in SP_K20_CASES]}, with caller offsets, under a "
          f"straggler and for_correctness, and {TP_REPEATS} back-to-back "
          f"calls queued before any check: within tolerance of its plain "
          f"version; rank 0 bit for bit equal to K1 on its own chunk")

    # -- 2. the main path: 32,768 tokens of Qwen3-8B's heads at world 4
    w, hh, hkv, d = SP_WORLD, 32, 8, 128
    s_loc = SP_ATTN_CONTEXT // w
    qg = randn(1, hh, SP_ATTN_CONTEXT, d)
    kg = randn(1, hkv, SP_ATTN_CONTEXT, d)
    vg = randn(1, hkv, SP_ATTN_CONTEXT, d)
    q, k, v = (shards(t, w) for t in (qg, kg, vg))
    qz, kz, vz = (shards(sp.zigzag_shard(t, w), w) for t in (qg, kg, vg))
    got = {}

    def main_path():
        with torch.inference_mode():
            got["fused"] = sp.sp_ag_attention_fused(q, k, v,
                                                    return_lse=True)
            got["gather"] = sp.sp_ag_attention_gather(q, k, v)
            got["ring"] = sp.sp_ring_attention(q, k, v)
            got["zigzag"] = sp.sp_ring_attention_zigzag(qz, kz, vz)
        torch.cuda.synchronize()

    launches = counted(main_path)
    want = expect(sp_ag_attention_fused=1, all_gather=1,
                  flash_attention=w + w + 3 * w)
    print(f"[sp path] main path: {SP_ATTN_CONTEXT} tokens at world {w} "
          f"({s_loc} a rank), {hh}/{hkv} heads of {d}, bf16: fused (K20), "
          f"gather (K15 + K1), ring (K1), zigzag (K1); launches "
          f"{short(launches)}")
    if launches != want:
        raise AssertionError(f"sp path launches {short(launches)} != "
                             f"{short(want)}")

    # -- 3. against world-1 attention over the whole sequence
    with torch.inference_mode():
        ref, ref_lse = fa.flash_attention(qg, kg, vg, return_lse=True)
        outs = {"fused": unshard(got["fused"][0]),
                "gather": unshard(got["gather"]),
                "ring": unshard(got["ring"]),
                "zigzag": sp.zigzag_unshard(unshard(got["zigzag"]), w)}
        for name, out in outs.items():
            check_rows(f"SP {name} {SP_ATTN_CONTEXT} tokens vs world-1 "
                       "flash_attention", out, ref, 5e-2, 1e-2, 0.1)
        check_close("SP fused lse vs world-1 flash_attention lse",
                    unshard(got["fused"][1]), ref_lse, 1e-3, 0.0)
        plain_o, plain_l = sp.sp_ag_attention_fused_reference(q, k, v)
        e = check_rows(f"K20 {SP_ATTN_CONTEXT} tokens vs its plain version",
                       got["fused"][0], plain_o, 2e-2, 1e-2, 0.1)
        check_close("K20 lse vs its plain version", got["fused"][1],
                    plain_l, 1e-3, 0.0)
        errs["sp_ag_attention_fused"] = max(errs["sp_ag_attention_fused"], e)
    del plain_o, plain_l, outs

    # -- 4. ring training against world 1
    st = SP_TRAIN_ROWS * w
    qt, kt, vt = (randn(1, n_h, st, d) for n_h in (hh, hkv, hkv))
    wt = randn(1, hh, st, d)
    leaves = [shards(t, w).requires_grad_(True) for t in (qt, kt, vt)]
    ring_out = []

    def ring_step():
        out = sp.sp_ring_attention_diff(*leaves)
        (out.float() * shards(wt, w).float()).sum().backward()
        ring_out.append(out.detach())
        torch.cuda.synchronize()

    launches = counted(ring_step)
    want = expect(flash_attention=w, flash_attention_bwd_dq=w,
                  flash_attention_bwd_dkv=w)
    flat = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out1 = fa.flash_attention_diff(*flat)
    (out1.float() * wt.float()).sum().backward()
    print(f"[sp path] ring training: sp_ring_attention_diff on {w} x "
          f"{SP_TRAIN_ROWS} tokens, launches {short(launches)}")
    if launches != want:
        raise AssertionError(f"sp ring training launches {short(launches)} "
                             f"!= {short(want)}")
    check_rows("ring training out vs world-1 flash_attention_diff",
               unshard(ring_out[0]), out1.detach(), 5e-2, 1e-2, 0.1)
    for name, leaf, ref_leaf in zip(("dq", "dk", "dv"), leaves, flat):
        check_rows(f"ring training {name} vs world 1", unshard(leaf.grad),
                   ref_leaf.grad, 5e-2, 2e-2, 0.1)
    del leaves, flat, out1, ring_out

    # -- 5. times.  The ring's cost: the consumers alone (no ring, no
    # arrival wait) on the chunks the calls before left in the ring buffers.
    with torch.inference_mode():
        ms = time_ms(lambda: sp.sp_ag_attention_fused(q, k, v), 5)
        scale = d ** -0.5
        q_off = [r * s_loc for r in range(w)]
        consumers = time_ms(lambda: sp._launch(
            q, k, v, q_off, [0] * w, scale, sp.cids.SP_AG_FUSED, None, False,
            0, ring=False), 5)
        plain = time_ms(lambda: sp.sp_ag_attention_fused_reference(q, k, v),
                        1, warmup=1)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, is_causal=True, enable_gqa=True), 5)
        comp = {
            "gather": time_ms(lambda: sp.sp_ag_attention_gather(q, k, v), 5),
            "ring": time_ms(lambda: sp.sp_ring_attention(q, k, v), 5),
            "zigzag": time_ms(lambda: sp.sp_ring_attention_zigzag(qz, kz,
                                                                  vz), 5),
            "world-1 K1": time_ms(lambda: fa.flash_attention(qg, kg, vg), 5)}
    pairs = attention_pairs(SP_ATTN_CONTEXT, SP_ATTN_CONTEXT, True, 0)
    bms, by = bound(nbytes(q, k, v, q) + 4 * q[..., 0].numel(),
                    4 * hh * pairs * d)
    # Rank W-1's causal share of the pairs, on its 1/W of the card's SMs.
    last = attention_pairs(s_loc, SP_ATTN_CONTEXT, True, (w - 1) * s_loc)
    rank_ms = 4 * hh * last * d / (PEAK_BF16_FLOPS / w) * 1e3
    flop = 4 * hh * pairs * d
    print(f"[times] K20 sp_ag_attention_fused at world {w} over "
          f"{SP_ATTN_CONTEXT} tokens (Qwen3-8B heads, {s_loc} a rank, W ranks "
          f"sharing one card's SMs and HBM, no NVLink): {ms:.4f} ms, "
          f"{flop / ms / 1e9:.1f} TFLOP/s (bound {bms:.4f} ms by {by}, "
          f"{bms / ms:.1%} of bound; {pairs} causal pairs a head; rank "
          f"{w - 1}'s bound {rank_ms:.4f} ms, its {last / pairs:.2%} of the "
          f"pairs on 1/{w} of the card, {rank_ms / ms:.1%} of it); the "
          f"consumers alone on arrived chunks {consumers:.4f} ms (the ring "
          f"{ms - consumers:.4f} ms); plain {plain:.4f} ms; SDPA causal over "
          f"the whole sequence (library) {lib:.4f} ms; "
          + ", ".join(f"{nm} {t:.4f} ms" for nm, t in comp.items())
          + f" ({flop / comp['world-1 K1'] / 1e9:.1f} TFLOP/s); {card}")
    records.append(("sp_ag_attention_fused", ms, plain, bms, by, lib, {
        "shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16",
        "library_note": "F.scaled_dot_product_attention causal over the "
                        "whole sequence (no ring)",
        "composition_ms": comp, "rank_bound_ms": rank_ms,
        "consumers_ms": consumers}))
    del q, k, v, qz, kz, vz, qg, kg, vg, got
    release_symmetric_buffers()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[sp path] the phase took {time.perf_counter() - t_phase:.1f} s "
          "(host clock)")


#: The grid path: collectives over a process grid of several axes, the
#: ranks in this process on the one card.  K21a/K21b (`all_gather_torus`,
#: `reduce_scatter_torus`) and `all_reduce_torus` on 2048 x 4096 bf16 a
#: rank (K15's and K16's payload) over the timed grids; the checked grids
#: and shapes (rows, columns: rows off the 2 * nd pieces, columns off 8);
#: K21c (`ag_gemm_torus`) at Qwen3-8B's prefill gate_up (512 rows of 4096
#: a rank, B 4096 x 6144 a rank, K12's shape) and `gemm_rs_torus` at its
#: prefill down (2048 x 3072 a rank, B 3072 x 4096); the hierarchical
#: ops at (dcn, ici) = GRID_HIER.
GRID_ROWS, GRID_COLS = 2048, 4096
GRID_TIMED = ((2, 2), (2, 2, 2))
GRID_CHECKED = ((2, 2), (2, 4), (4, 2), (2, 2, 2))
GRID_CHECK_SHAPES = ((13, 72), (64, 1024))
GRID_GEMM = {"ag": (512, 4096, 6144), "rs": (2048, 3072, 4096)}
GRID_HIER = (2, 2)


def grid_path(dev, card: str, counted, expect, short, records, errs) -> None:
    """The grid path: the two- and three-axis process grid, W ranks in this
    process on the one card.

    1. K21a and K21b (`torus.cu`) bit for bit against their plain versions
       (the gathered copy; the JAX lane, stage and step order of the ring
       adds, rounded to the dtype at each) on GRID_CHECKED in bf16 and f32
       at GRID_CHECK_SHAPES, `all_reduce_torus` bit for bit against the
       same composition of the plain versions; under a straggler and
       for_correctness, and TP_REPEATS back-to-back calls with fresh
       inputs queued before any check; a (1, 4) grid runs K15 and K16;
       K21c row by row against its plain version (as K12) with the
       gathered A exact;
    2. the main path, with every launch count set to 0 before and read
       after: K21a, K21b and `all_reduce_torus` on GRID_ROWS x GRID_COLS
       bf16 a rank over GRID_TIMED; `ag_gemm` and `gemm_rs` on a (2, 2)
       `TorusContext` at GRID_GEMM; at (dcn, ici) = GRID_HIER
       `all_gather_2d`, `reduce_scatter_2d`, `all_reduce_2d`,
       `fast_allgather_2d`, `ag_gemm` / `gemm_rs` on the
       `HierarchicalContext`, `HierarchicalEPAll2AllLayer` on the EP
       path's traffic (dispatch, layer 0's experts on K8, combine) and
       `sp_ag_attention_2d` on the SP path's 32,768 tokens;
    3. every output against its plain version or reference: the torus
       collectives and the hierarchical ones bit for bit (the latter
       against the same ops with the ICI stage's plain versions), the
       GEMMs row by row, the EP layer bit for bit equal to the flat
       `EPAll2AllLayer` on the same routing, the attention row by row
       against world-1 K1 (as the SP path's compositions);
    4. times: K21a/K21b/K21c against their bounds, plain versions and the
       library calls, beside K15, K16, K17 and K12 over the same flat
       world; the hierarchical ops, the EP round trip beside the flat
       layer's, and `sp_ag_attention_2d` beside K20 at world 4 and K1.

    On one card every put is a copy inside one HBM and the ranks share
    the SMs: the schedule's use of several links at once buys nothing
    here, and the times say what the kernels and their copies cost."""
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import flash_attention as fa
    from triton_distributed_tpu_torch.kernels import hierarchical as hier
    from triton_distributed_tpu_torch.kernels import moe_utils
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp
    from triton_distributed_tpu_torch.kernels import torus
    from triton_distributed_tpu_torch.kernels.allgather import (
        AllGatherContext, all_gather)
    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        AllGatherGEMMContext, ag_gemm, ag_gemm_plain)
    from triton_distributed_tpu_torch.kernels.allreduce import (
        AllReduceContext, all_reduce)
    from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
        GEMMReduceScatterContext, gemm_rs, gemm_rs_plain)
    from triton_distributed_tpu_torch.kernels.grouped_gemm import (
        grouped_matmul)
    from triton_distributed_tpu_torch.kernels.low_latency_allgather import (
        fast_allgather_2d)
    from triton_distributed_tpu_torch.kernels.matmul import matmul_reference
    from triton_distributed_tpu_torch.kernels.reduce_scatter import (
        ReduceScatterContext, reduce_scatter)
    from triton_distributed_tpu_torch.language.core import (
        release_symmetric_buffers)
    from triton_distributed_tpu_torch.layers import (
        EPAll2AllLayer, HierarchicalEPAll2AllLayer)
    from triton_distributed_tpu_torch.layers.moe_mlp import route
    from triton_distributed_tpu_torch.layers.tp_mlp import gated_silu

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(1357)
    t_phase = time.perf_counter()

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def ctx_of(sizes, **kw):
        return torus.TorusContext(("x", "y", "z")[:len(sizes)], sizes, **kw)

    def world_of(sizes):
        return math.prod(sizes)

    def plain_all_reduce(x, sizes):
        """`all_reduce_torus` of the plain versions (rows padded to W)."""
        w = x.shape[0]
        pad = (-x.shape[1]) % w
        xp = torch.cat([x, x.new_zeros((w, pad, *x.shape[2:]))], 1)
        full = torus.all_gather_torus_plain(
            torus.reduce_scatter_torus_plain(xp, sizes))
        return full[:, :x.shape[1]]

    def exact(label, got, want):
        if got.dtype != want.dtype or got.shape != want.shape or not bool(
                torch.equal(got, want)):
            raise AssertionError(f"{label}: kernel disagrees with its plain "
                                 "version")

    def torus_ops(sizes, x, xr, **kw):
        ctx = ctx_of(sizes, **kw)
        return (torus.all_gather_torus(x, ctx),
                torus.reduce_scatter_torus(xr, ctx),
                torus.all_reduce_torus(x, ctx))

    def hold_torus(label, sizes, x, xr, got):
        exact(f"K21a {label}", got[0], torus.all_gather_torus_plain(x))
        exact(f"K21b {label}", got[1],
              torus.reduce_scatter_torus_plain(xr, sizes))
        exact(f"all_reduce_torus {label}", got[2], plain_all_reduce(x, sizes))

    # -- 1. the kernels against their plain versions
    runs = []
    for sizes in GRID_CHECKED:
        w = world_of(sizes)
        for dtype in (bf16, f32):
            for m, n in GRID_CHECK_SHAPES:
                x, xr = randn(w, m, n, dtype=dtype), randn(w, w * m, n,
                                                           dtype=dtype)
                runs.append((f"{sizes} {dtype} {m}x{n}", sizes, x, xr,
                             torus_ops(sizes, x, xr)))
    for label, faults in (("straggler", {"straggler": (5, COLL_STRAGGLER[1])}),
                          ("for_correctness", {"for_correctness": True})):
        x, xr = randn(8, 64, 1024), randn(8, 512, 1024)
        runs.append((f"(2, 4) {label}", (2, 4), x, xr,
                     torus_ops((2, 4), x, xr, **faults)))
    torch.cuda.synchronize()
    for label, sizes, x, xr, got in runs:
        hold_torus(label, sizes, x, xr, got)
    ins = [(randn(8, 64, 1024), randn(8, 512, 1024))
           for _ in range(TP_REPEATS)]
    outs = [torus_ops((2, 2, 2), x, xr) for x, xr in ins]
    torch.cuda.synchronize()
    for (x, xr), got in zip(ins, outs):
        hold_torus("(2, 2, 2) back-to-back", (2, 2, 2), x, xr, got)
    del runs, ins, outs
    before = (all_gather.launches, reduce_scatter.launches,
              torus.all_gather_torus.launches)
    x, xr = randn(4, 64, 1024), randn(4, 256, 1024)
    got = torus_ops((1, 4), x, xr)
    torch.cuda.synchronize()
    exact("(1, 4) all-gather (K15)", got[0], torus.all_gather_torus_plain(x))
    if (all_gather.launches - before[0], reduce_scatter.launches - before[1],
            torus.all_gather_torus.launches - before[2]) != (2, 2, 0):
        raise AssertionError("a (1, 4) grid did not run K15 and K16")
    gemm_err = 0.0
    for sizes, m, k, n in (((2, 2), 64, 256, 384), ((2, 4), 6, 128, 96),
                           ((2, 2, 2), 12, 64, 136)):
        w = world_of(sizes)
        for dtype in (bf16, f32):
            a = randn(w, m, k, dtype=dtype)
            b = randn(w, k, n, dtype=dtype) * k ** -0.5
            out, g = torus.ag_gemm_torus(a, b, ctx_of(sizes),
                                         return_gathered=True)
            torch.cuda.synchronize()
            exact(f"K21c {sizes} gathered A", g,
                  torus.all_gather_torus_plain(a))
            gemm_err = max(gemm_err, check_rows(
                f"K21c {sizes} {dtype} ({m}, {k}) @ ({k}, {n})", out,
                torus.ag_gemm_torus_plain(a.float(), b.float()),
                *TP_TOL[dtype], 0.0))
    errs["all_gather_torus"] = errs["reduce_scatter_torus"] = 0.0
    errs["ag_gemm_torus"] = gemm_err
    print(f"[grid path] K21a, K21b and all_reduce_torus on grids "
          f"{GRID_CHECKED} in bf16 and f32 at {GRID_CHECK_SHAPES}, under a "
          f"straggler (rank 5 spins {COLL_STRAGGLER[1]} cycles) and "
          f"for_correctness, and {TP_REPEATS} back-to-back calls on (2, 2, 2)"
          f" with fresh inputs queued before any check: bit for bit equal to "
          f"their plain versions; a (1, 4) grid ran K15 and K16; K21c row by "
          f"row (max_abs_err {gemm_err:.3e}), its gathered A exact")

    # -- 2. the main path
    h = GRID_COLS
    xs = {s: randn(world_of(s), GRID_ROWS, h) for s in GRID_TIMED}
    hw = world_of(GRID_HIER)
    dcn, ici = GRID_HIER
    hctx = hier.HierarchicalContext("ici", "dcn", ici, dcn)
    tctx = ctx_of((2, 2))
    ma, ka, na = GRID_GEMM["ag"]
    mr, kr, nr = GRID_GEMM["rs"]
    a_ag, b_ag = randn(4, ma, ka), randn(4, ka, na) * ka ** -0.5
    a_rs, b_rs = randn(4, mr, kr), randn(4, kr, nr) * (4 * kr) ** -0.5
    xh = randn(hw, GRID_ROWS, h)
    # The EP path's traffic at world 4 (two slices of two).
    moe_h, e = MOE_FIELDS["hidden_size"], MOE_FIELDS["num_experts"]
    topk, ffn = MOE_FIELDS["num_experts_per_tok"], MOE_FIELDS[
        "moe_intermediate_size"]
    xe = randn(EP_WORLD, EP_TOKENS, moe_h)
    router = randn(moe_h, e, dtype=f32) * moe_h ** -0.5
    gate_up = randn(e, moe_h, 2 * ffn) * moe_h ** -0.5
    down = randn(e, ffn, moe_h) * ffn ** -0.5
    routed = [route(xe[r], router, topk) for r in range(EP_WORLD)]
    ids = torch.stack([i for i, _ in routed])
    wts = torch.stack([p for _, p in routed])
    cap = EP_TOKENS * topk
    hlayer = HierarchicalEPAll2AllLayer("ici", EP_WORLD, e, topk, cap, moe_h,
                                        dcn_size=dcn)
    flayer = EPAll2AllLayer("ep", EP_WORLD, e, topk, cap, moe_h)
    # The SP path's sequence at (dcn, ici): 32,768 tokens, B = 1.
    hh, hkv, d = 32, 8, 128
    qg, kg, vg = (randn(1, nh, SP_ATTN_CONTEXT, d) for nh in (hh, hkv, hkv))

    def shards(t, world):
        b, nh, s, dd = t.shape
        return t.reshape(b, nh, world, s // world, dd).movedim(
            2, 0).contiguous()

    q, k, v = (shards(t, hw) for t in (qg, kg, vg))
    got = {}

    def ep_round(lay):
        recv, recv_e, recv_c, plan = lay.dispatch(xe, ids)
        out, _ = ep_experts(recv, recv_c, recv_e, gate_up, down, moe_utils,
                            grouped_matmul, gated_silu)
        return (recv, recv_e, recv_c), lay.combine(out, recv_c, plan, wts,
                                                   ids)

    def main_path():
        with torch.inference_mode():
            for s, x in xs.items():
                c = ctx_of(s)
                got[("ag", s)] = torus.all_gather_torus(x, c)
                got[("rs", s)] = torus.reduce_scatter_torus(x, c)
                got[("ar", s)] = torus.all_reduce_torus(x, c)
            got["ag_gemm"] = ag_gemm(a_ag, b_ag, tctx)
            got["gemm_rs"] = gemm_rs(a_rs, b_rs, tctx)
            got["ag2d"] = hier.all_gather_2d(xh, hctx)
            got["rs2d"] = hier.reduce_scatter_2d(xh, hctx)
            got["ar2d"] = hier.all_reduce_2d(xh, hctx)
            got["fast2d"] = fast_allgather_2d(xh, hctx)
            got["ag_gemm2d"] = ag_gemm(a_ag, b_ag, hctx)
            got["gemm_rs2d"] = gemm_rs(a_rs, b_rs, hctx)
            got["ep"] = ep_round(hlayer)
            got["sp2d"] = sp.sp_ag_attention_2d(q, k, v, hctx)
        torch.cuda.synchronize()

    wg0 = ag_gemm.wgmma_launches
    launches = counted(main_path)
    wg12 = ag_gemm.wgmma_launches - wg0
    want = expect(all_gather_torus=2 * len(GRID_TIMED),
                  reduce_scatter_torus=2 * len(GRID_TIMED) + 1,
                  ag_gemm_torus=1, matmul=4, all_gather=3 * dcn,
                  reduce_scatter=2 * dcn, ag_gemm=dcn * dcn,
                  gemm_rs=dcn * dcn, all_to_all=2 * dcn, grouped_matmul=2,
                  sp_ag_attention_fused=dcn * dcn)
    print(f"[grid path] main path: K21a/K21b/all_reduce_torus on {GRID_ROWS}"
          f"x{h} bf16 a rank over grids {GRID_TIMED}; ag_gemm {GRID_GEMM['ag']}"
          f" and gemm_rs {GRID_GEMM['rs']} a rank on a (2, 2) TorusContext; "
          f"at (dcn, ici) = {GRID_HIER}: the four hierarchical collectives, "
          f"the two GEMMs, HierarchicalEPAll2AllLayer ({EP_TOKENS} tokens a "
          f"rank, top {topk} of {e}) and sp_ag_attention_2d over "
          f"{SP_ATTN_CONTEXT} tokens; launches {short(launches)}; K12 "
          f"(_ag_gemm_2d) on the wgmma body {wg12} of {launches['ag_gemm']}")
    if launches != want:
        raise AssertionError(f"grid path launches {short(launches)} != "
                             f"{short(want)}")
    if wg12 != launches["ag_gemm"]:
        raise AssertionError("grid path: a K12 launch of _ag_gemm_2d left "
                             "the wgmma body")

    # -- 3. checks
    with torch.inference_mode():
        for s, x in xs.items():
            exact(f"K21a {s} main path", got[("ag", s)],
                  torus.all_gather_torus_plain(x))
            exact(f"K21b {s} main path", got[("rs", s)],
                  torus.reduce_scatter_torus_plain(x, s))
            exact(f"all_reduce_torus {s} main path", got[("ar", s)],
                  plain_all_reduce(x, s))
        e21c = check_rows("K21c main path (2, 2) gate_up", got["ag_gemm"],
                          ag_gemm_plain(a_ag.float(), b_ag.float()),
                          *TP_TOL[bf16], 0.0)
        errs["ag_gemm_torus"] = max(errs["ag_gemm_torus"], e21c)
        # The compositions' plain versions, in their roundings: each rank's
        # partial rounded to bf16 (K6's, K14's), then K21b's ring adds or
        # K14's rank-order sum and the slices' f32 ring.
        plain_rs = torus.reduce_scatter_torus_plain(torch.stack(
            [matmul_reference(a_rs[r], b_rs[r]) for r in range(4)]), (2, 2))
        check_rows("gemm_rs_torus main path (2, 2) down vs its plain version "
                   "(K6 partials in bf16, K21b's ring adds)", got["gemm_rs"],
                   plain_rs, *TP_TOL[bf16], 0.0)
        mi = a_rs.shape[1] // dcn
        acc = None
        for st in range(dcn):
            part = torch.cat([gemm_rs_plain(
                a_rs[hctx.slice_rows(dd), (dd + 2 * dcn - 1 - st) % dcn * mi:
                     ((dd + 2 * dcn - 1 - st) % dcn + 1) * mi],
                b_rs[hctx.slice_rows(dd)]) for dd in range(dcn)]).float()
            acc = part if acc is None else torch.roll(
                acc.reshape(dcn, ici, *acc.shape[1:]), 1, dims=0).reshape(
                    acc.shape) + part
        plain_rs2d = acc.to(bf16)
        plain_h = hier.HierarchicalContext("ici", "dcn", ici, dcn,
                                           ag_method="xla", rs_method="xla")
        for key, fn in (("ag2d", hier.all_gather_2d),
                        ("rs2d", hier.reduce_scatter_2d),
                        ("ar2d", hier.all_reduce_2d),
                        ("fast2d", hier.all_gather_2d)):
            exact(f"{key} main path", got[key], fn(xh, plain_h))
        check_rows("ag_gemm on the HierarchicalContext", got["ag_gemm2d"],
                   ag_gemm_plain(a_ag.float(), b_ag.float()), *TP_TOL[bf16],
                   0.0)
        check_rows("gemm_rs on the HierarchicalContext vs its plain version "
                   "(K14's per slice, the slices' f32 ring)", got["gemm_rs2d"],
                   plain_rs2d, *TP_TOL[bf16], 0.0)
        flat = ep_round(flayer)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, b)) for a, b in zip(
            got["ep"][0] + (got["ep"][1],), flat[0] + (flat[1],)))
        print(f"[grid path] HierarchicalEPAll2AllLayer at (dcn, ici) = "
              f"{GRID_HIER}: the exchanged blocks, counts, expert ids and the "
              f"combine bit for bit equal to EPAll2AllLayer's on the same "
              f"routing: {same}")
        if not same:
            raise AssertionError("the two-level EP layer differs from the "
                                 "flat layer")
        ref = fa.flash_attention(qg, kg, vg)
        out2d = got["sp2d"].movedim(0, 2).reshape(ref.shape)
        check_rows(f"sp_ag_attention_2d {SP_ATTN_CONTEXT} tokens vs world-1 "
                   "flash_attention", out2d, ref, 5e-2, 1e-2, 0.1)
    print("[grid path] the torus and hierarchical collectives bit for bit "
          "against their plain versions on the main path")

    # -- 4. times
    libs = {"all_gather": lambda x: x.reshape(1, -1, x.shape[-1]).expand(
                x.shape[0], -1, -1).contiguous(),
            "reduce_scatter": lambda x: x.view(x.shape[0], x.shape[0], -1,
                                               x.shape[-1]).sum(
                0, dtype=f32).to(x.dtype)}
    rows = {}
    with torch.inference_mode():
        for s, x in xs.items():
            w = world_of(s)
            c = ctx_of(s)
            shard = x[0].numel() * x.element_size()
            t = {"ag": time_ms(lambda: torus.all_gather_torus(x, c), 20),
                 "rs": time_ms(lambda: torus.reduce_scatter_torus(x, c), 20),
                 "ar": time_ms(lambda: torus.all_reduce_torus(x, c), 20),
                 "K15": time_ms(lambda: all_gather(x, AllGatherContext(
                     "tp", w)), 20),
                 "K16": time_ms(lambda: reduce_scatter(
                     x, ReduceScatterContext("tp", w)), 20),
                 "K17": time_ms(lambda: all_reduce(x, AllReduceContext(
                     "tp", w)), 20),
                 "ag_plain": time_ms(lambda: torus.all_gather_torus_plain(x),
                                     5),
                 "rs_plain": time_ms(
                     lambda: torus.reduce_scatter_torus_plain(x, s), 3),
                 "ag_lib": time_ms(lambda: libs["all_gather"](x), 20),
                 "rs_lib": time_ms(lambda: libs["reduce_scatter"](x), 20)}
            b_ag_ms, b_ag_by = collective_bound("all_gather", w, shard)
            b_rs_ms, b_rs_by = collective_bound("reduce_scatter", w, shard)
            b_ar_ms, _ = collective_bound("all_reduce", w, shard)
            rows[s] = (t, (b_ag_ms, b_ag_by), (b_rs_ms, b_rs_by))
            print(f"[times] grid {s} (W = {w}) on {tuple(x.shape)} bf16 (W "
                  f"ranks sharing one card's SMs and HBM, every put a copy "
                  f"inside it, no NVLink): K21a all_gather_torus "
                  f"{t['ag']:.4f} ms (bound {b_ag_ms:.4f} ms by {b_ag_by}, "
                  f"{b_ag_ms / t['ag']:.1%}), plain {t['ag_plain']:.4f}, "
                  f"library (expand().contiguous()) {t['ag_lib']:.4f}, K15 "
                  f"over the flat world (auto) {t['K15']:.4f}; K21b "
                  f"reduce_scatter_torus {t['rs']:.4f} ms (bound "
                  f"{b_rs_ms:.4f} ms, {b_rs_ms / t['rs']:.1%}), plain "
                  f"{t['rs_plain']:.4f}, library (f32 sum over the ranks) "
                  f"{t['rs_lib']:.4f}, K16 flat (auto) {t['K16']:.4f}; "
                  f"all_reduce_torus {t['ar']:.4f} ms (bound {b_ar_ms:.4f}), "
                  f"K17 flat (auto) {t['K17']:.4f}; {card}")
        k21c = time_ms(lambda: ag_gemm(a_ag, b_ag, tctx), 10)
        k21c_plain = time_ms(lambda: torus.ag_gemm_torus_plain(a_ag, b_ag), 2,
                             warmup=1)
        full_a = a_ag.reshape(1, -1, ka)
        k21c_lib = time_ms(lambda: torch.matmul(full_a, b_ag), 10)
        k12 = time_ms(lambda: ag_gemm(a_ag, b_ag, AllGatherGEMMContext(
            "tp", 4, "fused")), 10)
        grs = time_ms(lambda: gemm_rs(a_rs, b_rs, tctx), 10)
        k14 = time_ms(lambda: gemm_rs(a_rs, b_rs, GEMMReduceScatterContext(
            "tp", 4, "fused")), 10)
        hier_t = {
            "all_gather_2d": time_ms(lambda: hier.all_gather_2d(xh, hctx), 10),
            "reduce_scatter_2d": time_ms(
                lambda: hier.reduce_scatter_2d(xh, hctx), 10),
            "all_reduce_2d": time_ms(lambda: hier.all_reduce_2d(xh, hctx),
                                     10),
            "fast_allgather_2d": time_ms(lambda: fast_allgather_2d(xh, hctx),
                                         10),
            "ag_gemm 2d": time_ms(lambda: ag_gemm(a_ag, b_ag, hctx), 5),
            "gemm_rs 2d": time_ms(lambda: gemm_rs(a_rs, b_rs, hctx), 5),
            "EP round trip 2d": time_ms(lambda: ep_round(hlayer), 3),
            "EP round trip flat": time_ms(lambda: ep_round(flayer), 3),
            "sp_ag_attention_2d": time_ms(
                lambda: sp.sp_ag_attention_2d(q, k, v, hctx), 2),
            "K20 world 4": time_ms(lambda: sp.sp_ag_attention_fused(q, k, v),
                                   2),
            "K1 world 1": time_ms(lambda: fa.flash_attention(qg, kg, vg), 2),
            "SDPA": time_ms(lambda: F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=True, enable_gqa=True), 2)}
    bms_c, by_c = tp_collective_bound("ag_gemm", 4, ma, ka, na, 2)
    print(f"[times] K21c ag_gemm on a (2, 2) TorusContext, a {tuple(a_ag.shape)}"
          f" b {tuple(b_ag.shape)} bf16: {k21c:.4f} ms (bound {bms_c:.4f} ms "
          f"by {by_c}, {bms_c / k21c:.1%}); plain {k21c_plain:.4f}; library "
          f"(torch.matmul of the gathered A, no gather) {k21c_lib:.4f}; K12 "
          f"fused at world 4 {k12:.4f}; gemm_rs on the (2, 2) TorusContext "
          f"(4 K6 + K21b) {grs:.4f} ms, K14 fused at world 4 {k14:.4f}; "
          f"{card}")
    print(f"[times] hierarchical at (dcn, ici) = {GRID_HIER} on {tuple(xh.shape)}"
          f" bf16 and the GEMM, EP and SP shapes above (CUDA events): "
          + ", ".join(f"{nm} {t:.4f} ms" for nm, t in hier_t.items())
          + f"; {card}")
    s0 = GRID_TIMED[0]
    t0, (b_ag_ms, b_ag_by), (b_rs_ms, b_rs_by) = rows[s0]
    note = ("W ranks in one launch on one card: no NVLink; (2, 2, 2) "
            "beside it")
    t1 = rows[GRID_TIMED[1]][0]
    records.append(("all_gather_torus", t0["ag"], t0["ag_plain"], b_ag_ms,
                    b_ag_by, t0["ag_lib"], {
                        "shape": f"grid {s0}, {tuple(xs[s0].shape)} bf16",
                        "library_note": "x.reshape(1, W*m, n).expand(W, -1, "
                                        "-1).contiguous(); " + note,
                        "grid_2x2x2_ms": t1["ag"], "k15_flat_ms": t0["K15"],
                        "k15_flat_2x2x2_ms": t1["K15"]}))
    records.append(("reduce_scatter_torus", t0["rs"], t0["rs_plain"], b_rs_ms,
                    b_rs_by, t0["rs_lib"], {
                        "shape": f"grid {s0}, {tuple(xs[s0].shape)} bf16",
                        "library_note": "x.view(W, W, m, n).sum(0, dtype=f32)"
                                        ".to(bf16); " + note,
                        "grid_2x2x2_ms": t1["rs"], "k16_flat_ms": t0["K16"],
                        "k16_flat_2x2x2_ms": t1["K16"],
                        "all_reduce_torus_ms": t0["ar"],
                        "k17_flat_ms": t0["K17"]}))
    records.append(("ag_gemm_torus", k21c, k21c_plain, bms_c, by_c, k21c_lib, {
        "shape": f"(2, 2) grid, a {tuple(a_ag.shape)} b {tuple(b_ag.shape)} "
                 "bf16",
        "library_note": "torch.matmul of the gathered A with the stacked B "
                        "(GEMM only, no gather)",
        "k12_fused_ms": k12, "gemm_rs_torus_ms": grs, "k14_fused_ms": k14,
        "hierarchical_ms": hier_t}))
    del xs, xh, got, a_ag, b_ag, a_rs, b_rs, q, k, v, qg, kg, vg, xe
    del gate_up, down, flat
    release_symmetric_buffers()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[grid path] the phase took {time.perf_counter() - t_phase:.1f} s "
          "(host clock)")


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
        DECODE_CHUNK, flash_decode, flash_decode_paged,
        flash_decode_paged_reference, flash_decode_reference, gather_pages,
        quantize_kv)
    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        AllGatherGEMMContext, ag_gemm, ag_gemm_w8a8)
    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        ag_group_gemm, ag_group_gemm_w8a8)
    from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
        gemm_rs)
    from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
        moe_reduce_rs_fused)
    from triton_distributed_tpu_torch.kernels import common_ops
    from triton_distributed_tpu_torch.kernels.allgather import all_gather
    from triton_distributed_tpu_torch.kernels.allreduce import all_reduce
    from triton_distributed_tpu_torch.kernels.low_latency_all_to_all import (
        fast_all_to_all)
    from triton_distributed_tpu_torch.kernels.sp_ag_attention import (
        sp_ag_attention_fused)
    from triton_distributed_tpu_torch.kernels.reduce_scatter import (
        reduce_scatter)
    from triton_distributed_tpu_torch.kernels.torus import (
        ag_gemm_torus, all_gather_torus, reduce_scatter_torus)
    from triton_distributed_tpu_torch.kernels.grouped_gemm import (
        grouped_matmul, grouped_matmul_reference, grouped_matmul_w8a8,
        grouped_matmul_w8a8_reference)
    from triton_distributed_tpu_torch.kernels.matmul import (
        matmul, matmul_reference)
    from triton_distributed_tpu_torch.kernels.quantized import (
        matmul_w8a8, matmul_w8a8_reference, quantize_sym)
    from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP
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
    for lib in ("flash_attention", "flash_decode", "flash_decode_paged",
                "grouped_matmul", "ag_gemm", "all_to_all", "sp_ag_attention",
                "torus"):
        print(f"[build] ptxas {lib}: " + "; ".join(
            f"{kernel_entry(k)} {regs} registers, spill stores {st} B, "
            f"loads {ld} B, static shared {sm} B"
            for k, regs, st, ld, sm in _build.resource_usage(lib))
            + "; ptxas lines of wgmma serialized: for a call (C7510) "
            "{}, for any reason {}".format(*serialized_wgmma(paths[lib])))
    print(f"[build] decode kernels: chunks of {DECODE_CHUNK} positions, "
          "dynamic shared memory (the stage buffers) "
          + ", ".join(f"{nm} {2 * DECODE_CHUNK * 128 * size // 1024} KB"
                      for nm, size in (("bf16", 2), ("f32", 4), ("int8", 1)))
          + " at D = 128")

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
    k3_batch = paged_case(f"q 8x32x128, pool {k3_pages}x8x16x128 "
                          f"(shuffled pages, null page 1e4), "
                          f"kv_len={list(K3_KV_LEN)}", k3_q, *k3_pools[0],
                          k3_table, k3_len)

    def rows_alone(name, batch, call):
        """Each row of K3's main-path state run alone (B = 1), bit for bit
        against the same row in the batch, and the batch run again."""
        again = call(slice(None))
        if not all(torch.equal(a, b) for a, b in zip(again, batch)):
            raise AssertionError(f"{name}: two calls of the batch differ")
        for i in range(len(K3_KV_LEN)):
            got = call(slice(i, i + 1))
            if not all(torch.equal(a, b[i:i + 1])
                       for a, b in zip(got, batch)):
                raise AssertionError(f"{name}: row {i} (kv_len "
                                     f"{K3_KV_LEN[i]}) alone differs from "
                                     "the same row in the batch")
        print(f"  {name}: each of the {len(K3_KV_LEN)} rows run alone "
              "(B = 1) bit-identical to the batch, out and lse; the batch "
              "again bit-identical")

    rows_alone("flash_decode_paged", k3_batch, lambda r: flash_decode_paged(
        k3_q[r], *k3_pools[0], k3_table[r].contiguous(), k3_len[r]))
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
    k3q_batch = int8_case(
        "flash_decode_paged_int8",
        f"q 8x32x128, int8 pool {k3_pages}x8x16x128 (shuffled pages, null "
        f"page codes 127, scales NaN), kv_len={list(K3_KV_LEN)}",
        flash_decode_paged(k3_q, *k3q_pools[0][:2], k3_table, k3_len,
                           k_scale=k3q_pools[0][2], v_scale=k3q_pools[0][3]),
        flash_decode_paged_reference(
            k3_q.float(), *k3q_pools[0][:2], k3_table, k3_len,
            k_scale=k3q_pools[0][2], v_scale=k3q_pools[0][3]))
    rows_alone("flash_decode_paged_int8", k3q_batch,
               lambda r: flash_decode_paged(
                   k3_q[r], *k3q_pools[0][:2], k3_table[r].contiguous(),
                   k3_len[r], k_scale=k3q_pools[0][2],
                   v_scale=k3q_pools[0][3]))
    del k3_batch, k3q_batch
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

    # K8 at the Qwen3-30B-A3B expert shapes in bf16 (random bucket rows,
    # N(0, 1/k) weights): the 4 x 512 prefill bucket (capacity(2048) = 256
    # rows an expert) and the decode bucket (16 rows), gate_up out bf16 and
    # down out f32 as the MoE layer calls them; then ragged and f32 cases.
    # K6 through ag_gemm(method="fused" | "ll") at world 1 at the Qwen3-8B
    # MLP's gate_up shape, 2048 and 8 rows.  Held row by row
    # (`check_rows`): bf16 out tol 2e-2, rel_l2 1e-2, floor 0.1 (one bf16
    # rounding of an f32 sum of exact products); f32 out 1e-4, 1e-5, floor
    # 1 (the order of the sums).
    print("[kernels vs plain] grouped GEMM (K8) and matmul (K6): row by "
          "row, bf16 out tol 2e-2, rel_l2 1e-2, floor 0.1; f32 out tol "
          "1e-4, rel_l2 1e-5, floor 1")
    gemm_tol = {torch.bfloat16: (2e-2, 1e-2, 0.1),
                torch.float32: (1e-4, 1e-5, 1.0)}

    def gemm_case(label, key, got, ref):
        torch.cuda.synchronize()
        if not bool(got.isfinite().all()):
            raise AssertionError(f"{label}: non-finite output")
        errs[key] = max(errs[key], check_rows(label, got, ref,
                                              *gemm_tol[got.dtype]))

    ne, h_moe, f_moe = (MOE_FIELDS[k] for k in (
        "num_experts", "hidden_size", "moe_intermediate_size"))
    moe_products = (("gate_up", h_moe, 2 * f_moe, torch.bfloat16),
                    ("down", f_moe, h_moe, torch.float32))
    for label, cap in (("prefill", MOE_PREFILL_CAP),
                       ("decode", MOE_DECODE_CAP)):
        for nm, k, n, out_dtype in moe_products:
            a, b = randn(ne, cap, k), randn(ne, k, n) * k ** -0.5
            gemm_case(f"grouped_matmul {label} {nm} ({ne}x{cap}x{k})@"
                      f"({ne}x{k}x{n}) out {out_dtype}", "grouped_matmul",
                      grouped_matmul(a, b, out_dtype),
                      grouped_matmul_reference(a, b, torch.float32))
    # The tile promise: the same 16 rows an expert at other places inside
    # buckets of 16, 64 and 256 rows (K8's 64- and 128-row wgmma tiles)
    # give the same bits, and so does a second launch.
    for nm, k, n, out_dtype in moe_products:
        rows, b = randn(ne, MOE_DECODE_CAP, k), randn(ne, k, n) * k ** -0.5
        outs = []
        for cap, at in ((MOE_DECODE_CAP, 0), (64, 40), (MOE_PREFILL_CAP, 100)):
            a = torch.zeros(ne, cap, k, device=dev, dtype=torch.bfloat16)
            a[:, at:at + MOE_DECODE_CAP] = rows
            outs.append(grouped_matmul(a, b, out_dtype)[
                :, at:at + MOE_DECODE_CAP])
        outs.append(grouped_matmul(a, b, out_dtype)[
            :, at:at + MOE_DECODE_CAP])
        torch.cuda.synchronize()
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        print(f"  grouped_matmul {nm} tile promise ({ne}x{{16,64,256}}x{k})@"
              f"({ne}x{k}x{n}) out {out_dtype}: the same rows in buckets of "
              f"16, 64 and 256 and a second launch "
              f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("grouped_matmul: a row's product depends on "
                                 "its bucket or differs between launches")
    a, b = randn(5, 37, 136), randn(5, 136, 200)
    gemm_case("grouped_matmul ragged (5x37x136)@(5x136x200) bf16",
              "grouped_matmul", grouped_matmul(a, b),
              grouped_matmul_reference(a, b, torch.float32))
    a, b = (torch.randn(shape, generator=gen, device=dev)
            for shape in ((3, 70, 100), (3, 100, 77)))
    gemm_case("grouped_matmul f32, k and n off 16-byte rows "
              "(3x70x100)@(3x100x77)", "grouped_matmul",
              grouped_matmul(a, b), grouped_matmul_reference(a, b))
    k6_b = randn(MLP_HIDDEN, 2 * MLP_FFN) * MLP_HIDDEN ** -0.5
    k6_a = {m: randn(m, MLP_HIDDEN) for m in W8A8_ROWS}
    for m, a in k6_a.items():
        ref = matmul_reference(a, k6_b, torch.float32)
        outs = [ag_gemm(a, k6_b, AllGatherGEMMContext("tp", 1, method))
                for method in ("fused", "ll")]
        for method, out in zip(("fused", "ll"), outs):
            gemm_case(f"matmul via ag_gemm(method={method!r}) "
                      f"({m}x{MLP_HIDDEN})@({MLP_HIDDEN}x{2 * MLP_FFN})",
                      "matmul", out, ref)
        if not torch.equal(*outs):
            raise AssertionError("ag_gemm fused and ll differ")
    a, b = (torch.randn(shape, generator=gen, device=dev)
            for shape in ((33, 72), (72, 40)))
    gemm_case("matmul f32 ragged (33x72)@(72x40)", "matmul", matmul(a, b),
              matmul_reference(a, b))
    del a, b, ref, outs

    # K9 on `MoEMLP.quantize_params` output (the expert weights of a random
    # layer of Qwen3-30B-A3B's widths, per expert and output channel), the
    # bucket rows quantized per token, at the w8a8 capacities (32-row
    # alignment): 256 rows (prefill) and 32 (decode).  Bit for bit against
    # the exact plain version, as K7.
    k9_q = MoEMLP.quantize_params({
        "router": None,
        "gate_up": randn(ne, h_moe, 2 * f_moe) * h_moe ** -0.5,
        "down": randn(ne, f_moe, h_moe) * h_moe ** -0.5})
    for cap in (MOE_PREFILL_CAP, MOE_W8A8_DECODE_CAP):
        for nm, k, n, out_dtype in moe_products:
            b_q, sb = k9_q[nm + "_q"], k9_q[nm + "_scale"]
            a_q, sa = quantize_sym(randn(ne, cap, k), 2)
            got = grouped_matmul_w8a8(a_q, b_q, sa, sb, out_dtype=out_dtype)
            want = grouped_matmul_w8a8_reference(a_q, b_q, sa, sb,
                                                 out_dtype=out_dtype)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"  grouped_matmul_w8a8 {nm} ({ne}x{cap}x{k})@({ne}x{k}x"
                  f"{n}) out {out_dtype}: {'bit-identical' if same else 'DIFFER'}"
                  " to the exact plain version")
            if not same:
                raise AssertionError("grouped_matmul_w8a8 differs from its "
                                     "plain version")
    del k9_q, a_q, sa, got, want

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
                "flash_attention_backward": flash_attention_backward,
                "matmul": matmul,
                "grouped_matmul": grouped_matmul,
                "grouped_matmul_w8a8": grouped_matmul_w8a8,
                "ag_gemm": ag_gemm, "gemm_rs": gemm_rs,
                "all_gather": all_gather, "reduce_scatter": reduce_scatter,
                "all_reduce": all_reduce, "common_ops": common_ops,
                "ag_group_gemm": ag_group_gemm,
                "ag_group_gemm_w8a8": ag_group_gemm_w8a8,
                "moe_reduce_rs_fused": moe_reduce_rs_fused,
                "ag_gemm_w8a8": ag_gemm_w8a8,
                "fast_all_to_all": fast_all_to_all,
                "sp_ag_attention_fused": sp_ag_attention_fused,
                "all_gather_torus": all_gather_torus,
                "reduce_scatter_torus": reduce_scatter_torus,
                "ag_gemm_torus": ag_gemm_torus}
    total_launches = dict.fromkeys(KERNELS, 0)

    def counted(fn):
        """Run ``fn`` with every kernel's launch count set to 0 just before
        it, add the counts read just after to the totals of the main
        paths, and return them."""
        for _, wrapper, attr, _ in KERNELS.values():
            setattr(wrappers[wrapper], attr, 0)
        fn()
        got = {nm: getattr(wrappers[wrapper], attr)
               for nm, (_, wrapper, attr, _) in KERNELS.items()}
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

    # -- 6b. ag_gemm path at world 1 ----------------------------------
    # ag_gemm(method="fused" | "ll") at world 1 is K6 (JAX: `matmul`); held
    # row by row against the "xla" method (an f32 library product cast to
    # bf16) on phase 3's operands.
    for m, a in k6_a.items():
        ref = ag_gemm(a, k6_b, AllGatherGEMMContext("tp", 1, "xla"))
        for method in ("fused", "ll"):
            out = []
            launches = counted(lambda: out.append(ag_gemm(
                a, k6_b, AllGatherGEMMContext("tp", 1, method),
                return_gathered=True)))
            print(f"[ag_gemm path] ag_gemm(method={method!r}) at world 1, "
                  f"({m}x{MLP_HIDDEN})@({MLP_HIDDEN}x{2 * MLP_FFN}) bf16: "
                  f"launches {short(launches)}; against method 'xla':")
            gemm_case(f"ag_gemm {method} vs xla, {m} rows", "matmul",
                      out[0][0], ref)
            if launches != expect(matmul=1) or out[0][1] is not a:
                raise AssertionError(f"ag_gemm {method}: launches "
                                     f"{launches}")

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

    fa_rows, fa_flop = {}, {}
    for key, idx in (("K1a", 0), ("K1b", 1), ("K1c", 3)):
        label, q, k, v, causal, off = fa_timed[idx]
        fa_rows[key] = (label,) + attention_times(q, k, v, causal, off, 50)
        fa_flop[key] = 4 * q.shape[0] * q.shape[1] * q.shape[3] * (
            attention_pairs(q.shape[2], k.shape[2], causal, off))
    records.append(("flash_attention",) + fa_rows["K1a"][1:])
    for key, (label, ms, plain, bms, by, lib) in fa_rows.items():
        flop = fa_flop[key]
        print(f"[times] flash_attention {key} ({label}): {ms:.4f} ms, "
              f"{flop / ms / 1e9:.1f} TFLOP/s (bound {bms:.4f} ms by {by}, "
              f"{bms / ms:.1%} of bound), plain {plain:.4f} ms, SDPA "
              f"{lib:.4f} ms; {card}")
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
    # What the chunks past every row's length cost: the same rows and pools
    # through a table of 2,048 pages (a capacity of 32,768 positions), the
    # added entries on the null page, in windows alternating with K3's.
    wide_table = torch.zeros((SLOTS, 16 * MAX_SEQ // PAGE), dtype=torch.int32,
                             device=dev)
    wide_table[:, :MAX_SEQ // PAGE] = k3_table
    wide = {MAX_SEQ: [], 16 * MAX_SEQ: []}
    for cap in (MAX_SEQ, 16 * MAX_SEQ, 16 * MAX_SEQ, MAX_SEQ):
        tbl = k3_table if cap == MAX_SEQ else wide_table
        wide[cap].append(per_layer_ms(lambda k_, v_: flash_decode_paged(
            k3_q, k_, v_, tbl, k3_len), k3_pools, 5))
    print(f"[times] flash_decode_paged (K3) at its main-path state, capacity "
          f"{MAX_SEQ} ({MAX_SEQ // DECODE_CHUNK} chunks a row) against "
          f"{16 * MAX_SEQ} ({16 * MAX_SEQ // DECODE_CHUNK} chunks a row, the "
          f"same lengths) in alternating windows: "
          + "; ".join(f"{cap}: " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                      for cap, ts in wide.items()) + f"; {card}")
    # Host time a call of K3's wrapper (the kernel's scratch and counters
    # included), float against int8 pools in windows of HOST_CALLS calls
    # in the order float, int8, int8, float; the device spins meanwhile.
    host = {"float": [], "int8": []}
    k3_calls = {
        "float": lambda: flash_decode_paged(k3_q, *k3_pools[0], k3_table,
                                            k3_len),
        "int8": lambda: flash_decode_paged(
            k3_q, *k3q_pools[0][:2], k3_table, k3_len,
            k_scale=k3q_pools[0][2], v_scale=k3q_pools[0][3])}
    for label in ("float", "int8", "int8", "float"):
        k3_calls[label]()
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            k3_calls[label]()
        host[label].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    print(f"[times] flash_decode_paged (K3, one launch a call) host time a "
          f"call at its main-path state, windows of {HOST_CALLS} calls: "
          + ", ".join(f"{label} " + " / ".join(f"{us:.2f}" for us in ts)
                      + " us" for label, ts in host.items()) + f"; {card}")
    del k3_pools, wide_table

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

    # K6 at the ag_gemm path's shapes; yardstick torch.matmul (cuBLAS, bf16
    # out, f32 accumulation).  The record is 2048 rows.
    for m, a in k6_a.items():
        kk, n = k6_b.shape
        ms = time_ms(lambda: matmul(a, k6_b), 20)
        plain = time_ms(lambda: matmul_reference(a, k6_b), 3)
        lib = time_ms(lambda: torch.matmul(a, k6_b), 20)
        bms, by = bound(nbytes(a, k6_b) + m * n * 2, 2 * m * n * kk)
        print(f"[times] matmul (K6) ({m}x{kk})@({kk}x{n}) bf16: {ms:.4f} ms "
              f"({2 * m * n * kk / ms / 1e9:.1f} TFLOP/s; bound {bms:.4f} ms "
              f"by {by}, {bms / ms:.1%} of bound), plain (f32) {plain:.4f} "
              f"ms, torch.matmul {lib:.4f} ms; {card}")
        if m == W8A8_ROWS[0]:
            records.append(("matmul", ms, plain, bms, by, lib))
    del k6_a, k6_b

    # Host time a call of K8's wrapper: the wgmma path encodes two tensor
    # maps on the host for every call, the f32 path encodes none; a decode
    # step calls K8 96 times.  The device spins while the host queues the
    # calls, so their time is the host's alone; windows alternate.
    host = {torch.bfloat16: [], torch.float32: []}
    ops = {dt: (torch.randn(8, 16, 256, generator=gen, device=dev).to(dt),
                torch.randn(8, 256, 384, generator=gen, device=dev).to(dt))
           for dt in host}
    for dt in (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16):
        grouped_matmul(*ops[dt])
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            grouped_matmul(*ops[dt])
        host[dt].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    print(f"[times] grouped_matmul (K8) host time a call, windows of "
          f"{HOST_CALLS} calls of (8x16x256)@(8x256x384): bf16 (wgmma tile, "
          f"two tensor maps encoded) "
          + " / ".join(f"{us:.2f}" for us in host[torch.bfloat16])
          + " us, f32 (no tensor map) "
          + " / ".join(f"{us:.2f}" for us in host[torch.float32])
          + f" us; {card}")
    del ops

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
                      lambda: [sched.step() for _ in range(8)], card,
                      steps=8)

    # -- 9. TP path ----------------------------------------------------
    # The serving phases are done: free their caches and schedulers.  The
    # TP path runs on the same weights, resharded; then the training phase
    # moves them.
    del kept, sched, cache, cache_q, c, mdl, model_q, engine_q, engine
    del layers, layers_q, kc, vc, kq, vq, ksq, vsq
    gc.collect()
    torch.cuda.empty_cache()
    tp_path(model, cfg, prompts, tokens, floor, dev, card, counted, expect,
            short, records, errs)

    # -- 10. training path --------------------------------------------
    print(f"[training path] device memory held before training: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (the bf16 "
          f"weights: {n_params * 2 / 2**30:.2f} GiB)")
    train_model_gradients(cfg, dev, card)
    train_steps(model, cfg, prompts, counted, expect, short, dev, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11. MoE path ---------------------------------------------------
    print(f"[moe path] device memory held before the MoE path: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    moe_path(dev, card, counted, expect, short, records, errs)

    # -- 12. MoE TP path ------------------------------------------------
    print(f"[moe tp path] device memory held before the MoE TP path: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    moe_tp_path(dev, card, counted, expect, short, records, errs)

    # -- 13. collective path -------------------------------------------
    print(f"[collective path] device memory held: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    collective_path(dev, card, counted, expect, short, records, errs)

    # -- 14. EP path ----------------------------------------------------
    print(f"[ep path] device memory held: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ep_path(dev, card, counted, expect, short, records, errs)

    # -- 15. SP attention path ------------------------------------------
    print(f"[sp path] device memory held: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    sp_path(dev, card, counted, expect, short, records, errs)

    # -- 16. grid path --------------------------------------------------
    print(f"[grid path] device memory held: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    grid_path(dev, card, counted, expect, short, records, errs)

    kernels = []
    for nm, ms, plain, bms, by, lib, *extra in records:
        lib_name, _, _, repl = KERNELS[nm]
        extra = dict(extra[0]) if extra else {}
        repl = extra.pop("replaces", repl)
        pair = (f" (pair {extra['pair_ms']:.4f} ms; plain and library are "
                "the whole backward)" if "pair_ms" in extra
                else f" ({extra['method']} at {extra['shape']}; ll "
                f"{extra['ll_ms']:.4f} ms; library: {extra['library_note']})"
                if "ll_ms" in extra
                else f" ({extra['method']} at {extra['shape']}; methods "
                f"{extra['method_ms']}; library: {extra['library_note']})"
                if "method_ms" in extra
                else f" ({extra['library_note']}: "
                f"{extra['library_loop_ms']:.4f} ms)"
                if "library_loop_ms" in extra
                else f" ({extra['shape']}; library: {extra['library_note']})"
                if extra else "")
        lib_text = "none" if lib is None else f"{lib:.4f} ms"
        print(f"[times] {nm}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, "
              f"{bms / ms:.1%} of bound){pair}, plain {plain:.4f} ms, "
              f"library {lib_text}; launches on the main paths "
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


def spin_report() -> str | None:
    """The wait a kernel trapped on, if one timed out (the port's
    `_build.spin_report`), else None."""
    try:
        from triton_distributed_tpu_torch.kernels import _build
    except ImportError:
        return None
    return _build.spin_report()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError:
        report = spin_report()
        if report:
            print(f"[error] {report}", file=sys.stderr)
        raise
