#!/usr/bin/env python3
"""The flash backward, K4 (dq) and K5 (dk, dv), of the PyTorch/CUDA port on
one NVIDIA GPU: two source trees compared, or this tree's variants of its
bf16 bodies.

    python3 scripts/torch_flash_bwd_ab.py --ab OTHER_ROOT
    python3 scripts/torch_flash_bwd_ab.py --variants [VARIANT ...]

``--ab`` runs the measurement for OTHER_ROOT (a checkout of another commit,
for example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone.  A run
measures, in bf16 with seeded random inputs and Qwen3-8B's 32/8 heads of
128:
- K4 alone (with its delta), K5 alone, the wrapper's pair and SDPA's
  backward (causal, GQA; dq, dk and dv together; the port never calls it)
  at 4 x 512 causal (the training shape), 1 x 2048 causal (a bucket) and
  the ring-training shard (1 x 2048 queries over 2048 keys at kv_offset
  2048: every key visible, SDPA without a mask), each beside its bound
  (each input read once and each output written once at 3.35 TB/s, or the
  products at 989 TFLOP/s: 3 of the forward's for K4, 4 for K5);
- the training step of `chip_smoke.py`'s training path: Qwen3-8B (36
  layers, seed-0 random bf16 weights), forward and backward of the last
  position's cross-entropy on 4 x 512 tokens, one K1/K4/K5 set a layer:
  device ms over 5 queued steps, and the host clock around a synchronised
  step (median of 5);
- hashes of K4's and K5's outputs and of the forwards K1 (4 x 512) and K20
  (world 4, 1024 tokens a rank), which must keep their bits;
- ptxas's report of the ``flash_attention_bwd`` library: registers and
  spills of each kernel, and its count of C7510 (products serialised for a
  call), C7520 (serialised for a divergent path) and C7519 (a warpgroup
  arrive the compiler injected) lines.

``--variants`` times this tree's K4 and K5 at 4 x 512 and 1 x 2048 by
variant of ``csrc/flash_attention_bwd.cu`` (default: all, in the order
below, then ``base`` again), each held to the plain version on a ragged
case first:
- ``base``: the bodies as they are;
- ``statsearly``: K4 waits for its rows' statistics (the spare warps'
  delta) before its first stage's products, not after;
- ``noover``: K4 waits for a stage's dS K before it issues the next
  stage's S and dP;
- ``stages2`` / ``stages5``: K5 with a ring of 2 or 5 Q / dO stages, not
  4;
- ``k4stages3``: K4 with 3 K / V stages at D = 128, not 2 (the shared
  memory then holds no slack to align the tiles: the body traps if the
  block's dynamic shared memory does not start 1024-byte aligned);
- ``k4late``: K4 gives a stage back only once the next stage's S and dP
  have retired too, not as soon as its own dS K has;
- ``qbuf1``: K4 with one Q / dO buffer and 4 K / V stages (D = 128), not
  2 and 2;
- ``splitdq``: K4 adds dS K as one chain of m64n64k16 a 64-column box of
  K, not one chain of m64nDk16;
- ``dssmem``: K4 stages dS in shared memory and adds dS K with both
  operands from there, not with dS as the register A operand;
- ``pingpong``: the consumer warpgroups take turns issuing their
  products (named barriers 4 and 5);
- cut variants, which give wrong results and are timed only, each without
  one part of the work: ``nodelta`` (K4's spare warps load no dO or out),
  ``nostats`` (K5's stats warp loads no lse or delta), ``noexp`` (no exp2
  in either body), ``k4noss`` / ``k5noss`` (no S and dP products),
  ``k4nors`` / ``k5nors`` (no dS K, or no P^T dO and dS^T Q, products),
  ``k4none`` / ``k5none`` (no products at all), ``dqbq`` (K4's dS K
  reads its B from the Q buffer, not the K stage), ``dqconst`` (its A is
  a constant, so nothing waits for the softmax).
Each variant is built from a copy of the sources in a temporary directory
(one ``nvcc``, seconds); the repository is not touched.

Device ms: CUDA events over back-to-back calls queued behind a device spin,
after warm-up.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPS, SPIN = 20, 100_000_000
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12
#: label -> (batch, Sq, Sk, kv_offset, causal), 32/8 heads of 128.
SHAPES = {"4x512": (4, 512, 512, 0, True),
          "1x2048": (1, 2048, 2048, 0, True),
          "ring shard": (1, 2048, 2048, 2048, True)}

_STATS = ("      // The rows' statistics, once the spare warps have them: after the\n"
          "      // first stage's products, which do not need them.\n"
          "      const Rows rs =\n"
          "          rows_of(sm, cur, stats_phase, w * wg::WG_ROWS + warp * 16 "
          "+ g);\n")
#: ``splitdq``: dS K as D / 64 chains of m64n64k16, one a 64-column box
#: of K (accumulators 32 j .. 32 j + 31 of the m64nD fragment are box j's).
_SPLIT_DQ = r"""#pragma unroll
        for (int j = 0; j < D / 64; ++j)
#pragma unroll
          for (int tt = 0; tt < 4; ++tt)
            fb::mma_rs_m64n64k16(
                *reinterpret_cast<float(*)[32]>(dq + 32 * j), da[tt],
                wg::desc(ks + j * KBOX + tt * 16 * ROW, KBOX, ATOM), 1);
"""
#: ``dssmem``: dS staged as a swizzled 64 x 64 bf16 tile a warpgroup past
#: the K/V ring (row warp 16 + g + 8 h, keys 8 j + 2 tg, + 1 in 16-byte
#: chunk j), then dS K with both operands from shared memory.
_DS_STAGE = r"""        uint8_t* dsw = sm.ring + STAGES * STAGE_BYTES + w * 64 * ROW;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = warp * 16 + g + 8 * h;
            *reinterpret_cast<unsigned*>(dsw + lr * ROW +
                                         ((j ^ lr % 8) << 4) + tg * 4) =
                pack_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1]);
          }
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        fb::named_sync(OUT_BARRIER + w, wg::WG);
"""
_DS_MMA = r"""#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          const uint64_t a_ = wg::desc(dsw + tt * 32, 16, ATOM);
          const uint64_t b_ = wg::desc(ks + tt * 16 * ROW, KBOX, ATOM);
          if constexpr (D == 128)
            wg::mma_m64n128k16<0>(dq, a_, b_, 1);
          else
            wg::mma_m64n64k16(dq, a_, b_, 1);
        }
"""
#: ``pingpong``: warpgroup w issues its products only after the other has
#: issued its last batch (named barriers 4 and 5, FlashAttention-3's
#: ping-pong); warpgroup 0 takes the first turn, and in K5 warpgroup 1
#: takes two idle turns after an item with an odd count of stages.
_TURNS = r"""constexpr int SCHED_BARRIER = 4;
__device__ __forceinline__ void turn_wait(int w) {
  fb::named_sync(SCHED_BARRIER + w, 2 * wg::WG);
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, %1;\\n" ::"r"(SCHED_BARRIER + 1 - w),
               "r"(2 * wg::WG)
               : "memory");
}
"""
_IDLE_TURNS = r"""      if (t.n % 2 == 1 && w == 1) {
        turn_wait(w);
        turn_pass(w);
        turn_wait(w);
        turn_pass(w);
      }
"""
#: variant -> edits of csrc/flash_attention_bwd.cu: (regex, replacement[,
#: matches]), each matching once unless it says how often.
VARIANTS = {
    "base": [],
    "statsearly": [(re.escape(_STATS), ""),
                   (r"(      float dq\[NO\];\n)",
                    _STATS.replace("\\", "\\\\") + r"\1")],
    "noover": [(r"(mma_rs_k64<D>\(dq, da, ks, KBOX\);\n"
                r"        wg::mma_commit\(\);\n)",
                r"\1        wg::mma_wait<0>();\n")],
    "stages2": [(r"static constexpr int STAGES = 4;",
                 "static constexpr int STAGES = 2;")],
    "stages5": [(r"static constexpr int STAGES = 4;",
                 "static constexpr int STAGES = 5;")],
    "splitdq": [(r"        mma_rs_k64<D>\(dq, da, ks, KBOX\);\n",
                 _SPLIT_DQ)],
    "dssmem": [(r"(static constexpr int TILES = QBUFS \* BUF_BYTES \+ "
                r"STAGES \* STAGE_BYTES)",
                r"\1 + 2 * 64 * ROW"),
               (r"        pack_a\(da, dp\);\n(        // dQ \+= dS K)",
                _DS_STAGE + r"\1"),
               (r"        mma_rs_k64<D>\(dq, da, ks, KBOX\);\n", _DS_MMA)],
    "pingpong": [(r"(constexpr int OUT_BARRIER = 2;\n)", r"\1" + _TURNS),
                 (r"(const int g = lane / 4, tg = lane % 4;\n"
                  r"    int s = 0, qb = 0;\n"
                  r"    unsigned phase = 0, q_phase = 0;\n)",
                  r"\1    if (w == 1) turn_pass(0);\n"),
                 (r"(    float sc\[32\] = \{\}, dp\[32\] = \{\};\n)"
                  r"(    for \(int r)",
                  r"\1    if (w == 1) turn_pass(0);\n\2"),
                 (r"\n(\s*)wg::mma_fence\(\);\n",
                  r"\n\1turn_wait(w);\n\1wg::mma_fence();\n", 4),
                 (r"(\n(\s*)wg::mma_commit\(\);[^\n]*\n)(?!\s*if \(kt)",
                  r"\1\2turn_pass(w);\n", 4),
                 (r"(      c \+= t\.n;\n)", _IDLE_TURNS + r"\1")],
    "k4stages3": [(r"static constexpr int STAGES = D == 128 \? 2 : 4;",
                   "static constexpr int STAGES = D == 128 ? 3 : 4;")],
    "k4late": [(r"        wg::mma_wait<1>\(\);\n        wg::fence_acc\(dq\);\n"
                r"        fb::keep\(da\);\n"
                r"        tdt::mbar_arrive\(&sm\.empty\[cur_s\]\);\n"
                r"        wg::mma_wait<0>\(\);\n",
                "        wg::mma_wait<0>();\n        wg::fence_acc(dq);\n"
                "        fb::keep(da);\n"
                "        tdt::mbar_arrive(&sm.empty[cur_s]);\n")],
    "qbuf1": [(r"static constexpr int QBUFS = 2;\n"
               r"  static constexpr int STAGES = D == 128 \? 2 : 4;",
               "static constexpr int QBUFS = 1;\n"
               "  static constexpr int STAGES = 4;")],
    # Cut variants, for timing only: each leaves out one part of the work.
    "nodelta": [(r"a\[u\] = ok \?", "a[u] = false ?"),
                (r"o\[u\] = ok \?", "o[u] = false ?")],
    "nostats": [(r"l = p\.lse\[base \+ row\];\n(\s+if \(l > LSE_DEAD\) \{\n"
                 r"\s+l2 = l \* LOG2E;\n\s+)dl = p\.delta\[base \+ row\];",
                 r"l = 0.f;\n\1dl = 0.f;")],
    "noexp": [(r"exp2f\(fminf\(sc\[4 \* j \+ e\]", "(fminf(sc[4 * j + e]", 2)],
    "k4noss": [(r"mma_ss_kd<D>\(sc, qs, QBOX, k[sn], KBOX\);\n\s*"
                r"mma_ss_kd<D>\(dp, dos, QBOX, k[sn] \+ KV_BYTES, KBOX\);\n",
                "", 2)],
    "k4nors": [(r"mma_rs_k64<D>\(dq, da, ks, KBOX\);\n", ";\n")],
    "k5noss": [(r"mma_ss_kd<D>\(sc, sm\.k, BOX, qs, BOX\);\n\s*"
                r"mma_ss_kd<D>\(dp, sm\.k \+ KV_BYTES, BOX, dos, BOX\);\n",
                "")],
    "k5nors": [(r"mma_rs_k64<D>\(dv, pa, dos, BOX\);\n\s*"
                r"mma_rs_k64<D>\(dk, da, qs, BOX\);\n", "")],
    "dqbq": [(r"mma_rs_k64<D>\(dq, da, ks, KBOX\);\n",
              "mma_rs_k64<D>(dq, da, qs, QBOX);\n")],
    "dqconst": [(r"mma_rs_k64<D>\(dq, da, ks, KBOX\);\n",
                 "mma_rs_k64<D>(dq, dz, ks, KBOX);\n"),
                (r"unsigned da\[4\]\[4\];", "unsigned da[4][4], dz[4][4] = {};")],
    "k5none": [(r"mma_rs_k64<D>\(dv, pa, dos, BOX\);\n\s*"
                r"mma_rs_k64<D>\(dk, da, qs, BOX\);\n", ""),
               (r"mma_ss_kd<D>\(sc, sm\.k, BOX, qs, BOX\);\n\s*"
                r"mma_ss_kd<D>\(dp, sm\.k \+ KV_BYTES, BOX, dos, BOX\);\n",
                "")],
    "k4none": [(r"mma_rs_k64<D>\(dq, da, ks, KBOX\);\n", ";\n"),
               (r"mma_ss_kd<D>\(sc, qs, QBOX, k[sn], KBOX\);\n\s*"
                r"mma_ss_kd<D>\(dp, dos, QBOX, k[sn] \+ KV_BYTES, KBOX\);\n",
                "", 2)],
}
#: The cut variants give wrong results: timed, not checked.
CUT = ("nodelta", "nostats", "noexp", "k4noss", "k4nors", "k5noss", "k5nors",
       "k4none", "k5none", "dqbq", "dqconst")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def digest(t) -> str:
    import torch

    view = t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)
    return hashlib.sha256(view.cpu().numpy().tobytes()).hexdigest()[:16]


class Timer:
    """Device ms of back-to-back calls queued behind a device spin."""

    def __init__(self):
        import torch

        self.torch = torch

    def __call__(self, fn, reps=REPS, warmup=3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps


def pairs(sq: int, sk: int, causal: bool, off: int) -> int:
    """Visible (query row, key) pairs: row i sees keys <= i + off."""
    if not causal:
        return sq * sk
    return sum(max(0, min(sk, i + off + 1)) for i in range(sq))


def bounds(b, h, hkv, sq, sk, d, causal, off) -> tuple[float, float]:
    """K4's and K5's least times in ms (`chip_smoke.py`'s bound)."""
    flops = 2 * b * h * pairs(sq, sk, causal, off) * d
    qb, kb = 2 * b * h * sq * d, 2 * b * hkv * sk * d
    stats = 4 * b * h * sq
    k4 = max((3 * qb + 2 * kb + 2 * stats + qb) / PEAK_BYTES_PER_S,
             3 * flops / PEAK_BF16_FLOPS)
    k5 = max((2 * qb + 2 * kb + 2 * stats + 2 * kb) / PEAK_BYTES_PER_S,
             4 * flops / PEAK_BF16_FLOPS)
    return k4 * 1e3, k5 * 1e3


def inputs(b, sq, sk, off, causal, seed=0):
    import torch

    from triton_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention)

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v, do = (randn(b, 32, sq, 128), randn(b, 8, sk, 128),
                   randn(b, 8, sk, 128), randn(b, 32, sq, 128))
    out, lse = flash_attention(q, k, v, causal=causal, kv_offset=off,
                               return_lse=True)
    return q, k, v, out, lse, do


def times(timer, out: dict, shapes=SHAPES, sdpa=True) -> None:
    """K4, K5, the pair (and SDPA's backward) at each shape."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import flash_attention as fa

    for label, (b, sq, sk, off, causal) in shapes.items():
        q, k, v, o, lse, do = inputs(b, sq, sk, off, causal)
        scale = 128 ** -0.5
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        out[f"{label} K4"] = timer(lambda: fa._launch_bwd(
            "dq", (q, k, v, do, o, lse, None, delta, dq), causal, off,
            scale))
        out[f"{label} K5"] = timer(lambda: fa._launch_bwd(
            "dkv", (q, k, v, do, lse, delta, dk, dv), causal, off, scale))
        out[f"{label} pair"] = timer(lambda: fa.flash_attention_backward(
            q, k, v, o, lse, do, causal=causal, kv_offset=off))
        b4, b5 = bounds(b, 32, 8, sq, sk, 128, causal, off)
        out[f"{label} K4 bound"], out[f"{label} K5 bound"] = b4, b5
        if sdpa:
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            full = off >= sk - 1  # every key visible to every row
            ref = F.scaled_dot_product_attention(
                *leaves, is_causal=causal and not full, enable_gqa=True)
            out[f"{label} SDPA backward"] = timer(lambda: torch.autograd.grad(
                ref, leaves, do, retain_graph=True))
            del ref, leaves
        del q, k, v, o, lse, do, dq, dk, dv


def train_times(timer, out: dict) -> None:
    """Qwen3-8B's forward + backward at 4 x 512 (`chip_smoke.py`'s training
    step, without its SGD update)."""
    import statistics
    import time

    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch import ModelConfig, Qwen3

    cfg = ModelConfig.qwen3_8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Qwen3(cfg).init_params(gen)
    model.requires_grad_(True)
    ids = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                        device="cuda")
    targets = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                            device="cuda")

    def step():
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(ids), targets).backward()

    out["training fwd+bwd device"] = timer(step, reps=5, warmup=2)
    wall = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    out["training fwd+bwd host"] = statistics.median(wall)
    del model
    torch.cuda.empty_cache()


def hashes(out: dict) -> None:
    """K4/K5 outputs at 4 x 512 and the K1 and K20 forwards."""
    import torch

    from triton_distributed_tpu_torch.kernels import flash_attention as fa
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp

    q, k, v, o, lse, do = inputs(4, 512, 512, 0, True, seed=1)
    dlse = torch.randn(lse.shape, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
    for name, t in zip(("dq", "dk", "dv"),
                       fa.flash_attention_backward(q, k, v, o, lse, do,
                                                   dlse)):
        out[f"K4/K5 {name} hash"] = digest(t)
    out["K1 out hash"], out["K1 lse hash"] = digest(o), digest(lse)
    gen = torch.Generator(device="cuda").manual_seed(3)
    w, s = 4, 1024
    qs, ks, vs = (torch.randn((w, 1, n, s, 128), generator=gen,
                              device="cuda", dtype=torch.bfloat16)
                  for n in (32, 8, 8))
    o20, l20 = sp.sp_ag_attention_fused(qs, ks, vs, return_lse=True)
    out["K20 out hash"], out["K20 lse hash"] = digest(o20), digest(l20)


def check() -> None:
    """K4/K5 against the plain version on ragged bf16 cases, D 64 and 128
    (tol 2e-2 row by row, rel_l2 1e-2, floor 0.1, as the `gpu` tests)."""
    import torch

    from triton_distributed_tpu_torch.kernels import flash_attention as fa

    for d, (b, h, hkv, sq, sk, off) in ((128, (1, 8, 2, 255, 255, 0)),
                                        (64, (1, 8, 2, 130, 130, -70)),
                                        (128, (1, 8, 4, 129, 257, 128))):
        gen = torch.Generator(device="cuda").manual_seed(sq + d)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.bfloat16)
                       for shape in ((b, h, sq, d), (b, hkv, sk, d),
                                     (b, hkv, sk, d), (b, h, sq, d)))
        o, lse = fa.flash_attention(q, k, v, kv_offset=off, return_lse=True)
        got = fa.flash_attention_backward(q, k, v, o, lse, do, kv_offset=off)
        ref = fa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            kv_offset=off)
        for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            err = (g_.float() - r_).abs()
            row = r_.pow(2).mean(-1, keepdim=True).sqrt()
            fl = 0.1 * r_.pow(2).mean().sqrt()
            ratio = float((err / (r_.abs() + row + fl).clamp_min(1e-38))
                          .max())
            rel = float(err.norm() / r_.norm())
            if not (ratio <= 2e-2 and rel <= 1e-2):
                raise AssertionError(f"d {d} {name}: ratio {ratio:.3e}, "
                                     f"rel_l2 {rel:.3e}")


def ptxas(path=None) -> dict:
    from triton_distributed_tpu_torch.kernels import _build

    path = path or _build._library_path("flash_attention_bwd")
    if not path.exists():
        return {}
    log = path.with_suffix(".log").read_text()
    return {"c7510": log.count("C7510"), "c7520": log.count("C7520"),
            "c7519": log.count("C7519"),
            "kernels": [list(r) for r in
                        _build.resource_usage("flash_attention_bwd", path)]}


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels import _build

    _build.build(["flash_attention_bwd", "flash_attention",
                  "sp_ag_attention"])
    timer = Timer()
    out = {"root": str(root), "card": card(), "torch": torch.__version__}
    times(timer, out)
    hashes(out)
    train_times(timer, out)
    out["ptxas"] = ptxas()
    return out


def build_variant(name: str):
    """The ``flash_attention_bwd`` library from a copy of this tree's
    sources with variant ``name``'s edits; returns (library path,
    temporary directory)."""
    from triton_distributed_tpu_torch.kernels import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"bwd_{name}_"))
    shutil.copytree(_build.CSRC, tmp / "csrc")
    src = tmp / "csrc" / "flash_attention_bwd.cu"
    text = src.read_text()
    for pattern, new, *times in VARIANTS[name]:
        text, count = re.subn(pattern, new, text)
        if count != (times[0] if times else 1):
            raise RuntimeError(f"variant {name}: {pattern!r} matched {count} "
                               "times")
    src.write_text(text)
    return tmp


def variants(names) -> int:
    import torch

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("torch_flash_bwd_ab: CUDA is not available", file=sys.stderr)
        return 1
    timer, name_of = Timer(), card()
    _build.build(["flash_attention"])
    tmps = {name: build_variant(name) for name in dict.fromkeys(names)}
    try:
        # One nvcc a variant, all started together.
        with ThreadPoolExecutor(len(tmps)) as pool:
            built = {name: pool.submit(
                _build.build, ["flash_attention_bwd"], csrc=tmp / "csrc",
                build_dir=tmp / "build") for name, tmp in tmps.items()}
            paths = {name: f.result()["flash_attention_bwd"]
                     for name, f in built.items()}
        shapes = {k: SHAPES[k] for k in ("4x512", "1x2048")}
        for name in names:
            _build._loaded["flash_attention_bwd"] = _build.load_path(
                paths[name], fa._BWD_SIGNATURES)
            if name not in CUT:
                check()
            res = {"variant": name, "card": name_of,
                   "bits": ("cut: timing only" if name in CUT else
                            "within the plain version's tolerance"),
                   "ptxas": ptxas(paths[name])}
            times(timer, res, shapes, sdpa=False)
            print(json.dumps(res), flush=True)
    finally:
        for tmp in tmps.values():
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", type=Path)
    group.add_argument("--ab", type=Path, metavar="OTHER_ROOT")
    group.add_argument("--variants", nargs="*", choices=list(VARIANTS),
                       metavar="VARIANT")
    args = ap.parse_args()
    if args.variants is not None:
        sys.path.insert(0, str(HERE))
        return variants(args.variants or [*VARIANTS, "base"])
    if args.root is not None:
        import torch

        if not torch.cuda.is_available():
            print("torch_flash_bwd_ab: CUDA is not available",
                  file=sys.stderr)
            return 1
        print(json.dumps(measure(args.root.resolve())), flush=True)
        return 0
    runs = []
    for root in (args.ab.resolve(), HERE, HERE, args.ab.resolve()):
        res = subprocess.run(
            [sys.executable, __file__, "--root", str(root)],
            capture_output=True, text=True, cwd=str(root),
            env={**os.environ, "PYTHONPATH": str(root)})
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            print(f"torch_flash_bwd_ab: the run of {root} failed",
                  file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for name, value in runs[1].items():
        if not isinstance(value, float):
            continue
        other = [r.get(name) for r in (runs[0], runs[3])]
        other = " / ".join("-" if t is None else f"{t:.4f}" for t in other)
        print(f"{name}: other {other}; this tree {value:.4f} / "
              f"{runs[2][name]:.4f}; {runs[0]['card']}")
    for name in runs[1]:
        if name.endswith(" hash"):
            seen = [str(r.get(name)) for r in runs]
            same = len(set(seen[1:3])) == 1 and len(set(seen[::3])) == 1
            print(f"{name}: other {seen[0]} / {seen[3]}, this tree "
                  f"{seen[1]} / {seen[2]}: "
                  + ("the same bits in all four runs" if len(set(seen)) == 1
                     else "each tree repeats its bits" if same
                     else "NOT REPEATED"))
    for tag, r in (("other", runs[0]), ("this tree", runs[1])):
        rep = r["ptxas"]
        print(f"flash_attention_bwd ({tag}): C7510 {rep.get('c7510')}, "
              f"C7520 {rep.get('c7520')}, C7519 {rep.get('c7519')}; "
              + "; ".join(f"{k[0][-40:]} {k[1]} registers, spills "
                          f"{k[2]}/{k[3]} B" for k in rep.get("kernels", [])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
