#!/usr/bin/env python3
"""K14 (`gemm_rs`) of the PyTorch/CUDA port on one NVIDIA GPU: two source
trees compared, or this tree's variants of the kernel.

    python3 scripts/torch_gemm_rs_ab.py --ab OTHER_ROOT
    python3 scripts/torch_gemm_rs_ab.py --variants [VARIANT ...]

``--ab`` runs the measurement for OTHER_ROOT (a checkout of another commit,
for example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone.  A run
measures, bf16, seeded random inputs, the 4 ranks in one launch:
- K14 at Qwen3-8B's world-4 shapes (hidden 4096; the O projection's k =
  1024 and the down projection's 3072 a rank; prefill 2048 rows, decode
  4) and at Qwen3-30B-A3B's decode O projection at world 4 (hidden 2048,
  k = 1024 a rank, 4 rows: the MoE TP path's), ``fused`` and ``ll``,
  beside ``torch.bmm`` + the sum over the ranks (`chip_smoke.py`'s
  library yardstick: the same function without the scatter) and the
  bound;
- the world-4 Qwen3-8B prefill (4 x 512 tokens, 36 layers, random
  weights): device ms (the sum of its kernels' times under
  `torch.profiler`), K14's and K12's shares, host ms;
- K6, K8 and K12, which share the `wgmma` tile with K14, at
  `scripts/torch_flash_ab.py`'s shapes, with a hash of each output (the
  tile must leave their bits alone);
- ptxas's report of K14, K12 and K8's libraries: registers, spills, and
  the lines saying a call serialized the `wgmma`s (C7510).

``--variants`` times this tree's K14 at the five shapes by variant (default:
all, in the order given below, then ``base`` again):
- ``base``: the kernel as it is;
- ``nostore``: the partials are not stored (the signals and the sums
  stay): what sending them costs;
- ``nosum``: the sums do not read the partials: what the sum costs;
- ``tail``: ``ll``'s sum after the consumers' tile loop, in a ``tail``
  hook of the tile, instead of in the last tile's ``store``.
The cut variants give wrong results and are for timing only; the others
are held to the plain version (row by row, bf16 bound).  Each set of
edits is built from a copy of the sources in a temporary directory (one
``nvcc``, seconds); the repository is not touched.

Device ms: CUDA events over back-to-back calls queued behind a device spin,
after warm-up.  ``ms`` rotates over 8 sets of operands (the weights come
from HBM, as in a model's layers); ``warm_ms`` repeats one set, as
`chip_smoke.py` times it (decode O's 32 MB of weights fit the 50 MB L2).
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
WORLD, SETS, REPS, SPIN = 4, 8, 10, 100_000_000
#: label -> (rows M a rank, k a rank, n): Qwen3-8B at world 4, and
#: Qwen3-30B-A3B's decode O projection at world 4 (the MoE TP path's).
SHAPES = {"prefill O": (2048, 1024, 4096), "prefill down": (2048, 3072, 4096),
          "decode O": (4, 1024, 4096), "decode down": (4, 3072, 4096),
          "moe decode O": (4, 1024, 2048)}
LIBS = ("gemm_rs", "ag_gemm", "grouped_matmul")
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12

#: variant -> (text, its replacement[, the source file, by default
#: gemm_rs.cu]) edits.
VARIANTS = {
    "base": [],
    "nostore": [("      if (rows[k] != nullptr && col + 64 * s < N)",
                 "      if (rows[k] == nullptr && col < 0)",
                 "wgmma_epilogue.cuh")],
    "nosum": [("  for (unsigned i = lo + threadIdx.x; i < hi; i += NT) {",
               "  for (unsigned i = hi + threadIdx.x; i < hi; i += NT) {",
               "wgmma_epilogue.cuh")],
    "tail": [("        sched.store(t, w, wg, acc);\n      }\n    }",
              "        sched.store(t, w, wg, acc);\n      }\n"
              "      sched.tail(wg);\n    }", "wgmma_tile.cuh"),
             ("};\n\n// `ll`: the W mc rows",
              "  __device__ __forceinline__ void tail(int) {}\n};\n\n"
              "// `ll`: the W mc rows"),
             ("    if (t + (int)gridDim.x < ntiles) return;\n",
              "  }\n  __device__ __forceinline__ void tail(int) {\n"
              "    const size_t slot = (size_t)p->mc * p->n;\n")],
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """K14's least time at world 4 (`chip_smoke.tp_collective_bound`): the
    A shards, the partials every rank receives, B and the output once each
    at the HBM rate, or the GEMM's operations at the bf16 peak."""
    w, mc = WORLD, m // WORLD
    moved = 2 * (w * m * k + w * (w - 1) * mc * n + w * k * n + w * mc * n)
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * w * m * k * n / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def digest(t) -> str:
    import torch

    return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


class Timer:
    """Device ms of back-to-back calls queued behind a device spin."""

    def __init__(self):
        import torch

        self.torch = torch

    def __call__(self, fn, reps=REPS, warmup=2) -> float:
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


def operand_sets(m: int, k: int, n: int, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn((WORLD, m, k), generator=gen, device="cuda",
                         dtype=torch.bfloat16),
             torch.randn((WORLD, k, n), generator=gen, device="cuda",
                         dtype=torch.bfloat16) * (WORLD * k) ** -0.5)
            for _ in range(SETS)]


def k14_times(timer) -> dict:
    """K14 at the five shapes, both methods, rotating and warm, beside the
    library and the bound."""
    from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
        GEMMReduceScatterContext, gemm_rs)

    out = {}
    for i, (label, (m, k, n)) in enumerate(SHAPES.items()):
        sets = operand_sets(m, k, n, i)
        it = [0]

        def rotate(fn):
            def call():
                a, b = sets[it[0] % SETS]
                it[0] += 1
                return fn(a, b)
            return call

        for method in ("fused", "ll"):
            ctx = GEMMReduceScatterContext("tp", WORLD, method)
            run = rotate(lambda a, b: gemm_rs(a, b, ctx))
            out[f"{label} {method}"] = timer(run, REPS * SETS // 4)
            a, b = sets[0]
            out[f"{label} {method} warm"] = timer(lambda: gemm_rs(a, b, ctx))
        out[f"{label} library"] = timer(rotate(
            lambda a, b: timer.torch.bmm(a, b).view(
                WORLD, WORLD, -1, n).sum(0)), REPS * SETS // 4)
        out[f"{label} bound"] = bound_ms(m, k, n)[0]
        del sets
    return out


def prefill_profile(out: dict) -> None:
    """The world-4 Qwen3-8B prefill, traced once after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triton_distributed_tpu_torch import ModelConfig, Qwen3
    from triton_distributed_tpu_torch.parallel import make_mesh

    cfg = ModelConfig.qwen3_8b()
    model = Qwen3(cfg, mesh=make_mesh(WORLD)).init_params(
        torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (4, 512), device="cuda",
                        generator=gen)
    cache = model.create_cache(4, max_seq=1024)
    with torch.inference_mode():
        model.prefill(ids, cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.prefill(ids, cache)
            end.record()
            torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kern) / 1e3
    k14 = [e for e in kern if "gemm_rs_" in e.key]
    k12 = [e for e in kern if "ag_gemm_" in e.key]
    out["prefill device ms"] = total
    out["prefill K14 ms"] = sum(e.self_device_time_total for e in k14) / 1e3
    out["prefill K14 launches"] = sum(e.count for e in k14)
    out["prefill K12 ms"] = sum(e.self_device_time_total for e in k12) / 1e3
    out["prefill event ms"] = start.elapsed_time(end)
    del model, cache
    torch.cuda.empty_cache()


def neighbours(out: dict, timer) -> None:
    """K6, K8 and K12 at `scripts/torch_flash_ab.py`'s shapes: ms and a
    hash of the output."""
    import torch

    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        AllGatherGEMMContext, ag_gemm)
    from triton_distributed_tpu_torch.kernels.grouped_gemm import (
        grouped_matmul)
    from triton_distributed_tpu_torch.kernels.matmul import matmul

    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    cases = {"K6": (randn(2048, 4096), randn(4096, 24576) * 4096 ** -0.5,
                    matmul),
             "K8 decode gate_up": (randn(128, 16, 2048),
                                   randn(128, 2048, 1536) * 2048 ** -0.5,
                                   grouped_matmul)}
    for name, (m, n, method) in {
            "K12 prefill gate_up fused": (512, 6144, "fused"),
            "K12 decode QKV ll": (1, 1536, "ll")}.items():
        ctx = AllGatherGEMMContext("tp", WORLD, method)
        cases[name] = (randn(WORLD, m, 4096),
                       randn(WORLD, 4096, n) * 4096 ** -0.5,
                       lambda a, b, ctx=ctx: ag_gemm(a, b, ctx))
    for name, (a, b, fn) in cases.items():
        out[name] = timer(lambda: fn(a, b), 20)
        out[f"{name} hash"] = digest(fn(a, b))


def ptxas(lib: str) -> dict:
    from triton_distributed_tpu_torch.kernels import _build

    path = _build._library_path(lib)
    if not path.exists():
        return {}
    log = path.with_suffix(".log").read_text()
    return {"c7510": log.count("C7510"),
            "kernels": [list(r) for r in _build.resource_usage(lib)]}


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels import _build

    _build.build([*LIBS, "flash_attention"])  # one nvcc each, together
    timer = Timer()
    out = {"root": str(root), "card": card(), "torch": torch.__version__}
    out.update(k14_times(timer))
    prefill_profile(out)
    neighbours(out, timer)
    out["ptxas"] = {lib: ptxas(lib) for lib in LIBS}
    return out


def build_variant(name: str):
    """K14's library from a copy of this tree's sources with variant
    ``name``'s edits; returns (library path, temporary directory)."""
    from triton_distributed_tpu_torch.kernels import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"gemm_rs_{name}_"))
    shutil.copytree(_build.CSRC, tmp / "csrc")
    for edit in VARIANTS[name]:
        old, new, src = (*edit, "gemm_rs.cu")[:3]
        text = (tmp / "csrc" / src).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {src}")
        (tmp / "csrc" / src).write_text(text.replace(old, new))
    path = _build.build(["gemm_rs"], csrc=tmp / "csrc",
                        build_dir=tmp / "build")["gemm_rs"]
    return path, tmp


def check(timer) -> float:
    """The worst err / (|ref| + rms of ref's row) of K14 against its plain
    version (f32 from the same inputs), both methods, at the five shapes:
    the variants that are not cut must keep it under 2e-2 (bf16)."""
    from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
        GEMMReduceScatterContext, gemm_rs, gemm_rs_plain)

    worst = 0.0
    for i, (m, k, n) in enumerate(SHAPES.values()):
        a, b = operand_sets(m, k, n, 100 + i)[0]
        ref = gemm_rs_plain(a.float(), b.float())
        row = ref.pow(2).mean(-1, keepdim=True).sqrt()
        for method in ("fused", "ll"):
            got = gemm_rs(a, b, GEMMReduceScatterContext("tp", WORLD, method))
            err = (got.float() - ref).abs() / (ref.abs() + row)
            worst = max(worst, float(err.max()))
    return worst


def sass_usage(path: Path) -> dict:
    """Per `wgmma` kernel of the library at ``path``: the highest register
    its SASS names and its local-memory loads and stores (spills and
    arrays a kernel indexes at run time alike), from ``cuobjdump``."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True).stdout
    out = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        if "wgmma" in name:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
            out[name[name.find("gemm_rs_"):]] = {
                "max_register": max(regs, default=0),
                "local_ops": len(re.findall(r"\b(?:STL|LDL)\b", body))}
    return out


def variants(names) -> int:
    import torch

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as grs

    if not torch.cuda.is_available():
        print("torch_gemm_rs_ab: CUDA is not available", file=sys.stderr)
        return 1
    timer, name_of = Timer(), card()
    built = {}  # variant -> (library, temporary directory)
    try:
        for name in names:
            if name not in built:
                built[name] = build_variant(name)
        for name in names:
            path, _ = built[name]
            _build._loaded["gemm_rs"] = _build.load_path(path,
                                                         grs._SIGNATURES)
            log = path.with_suffix(".log").read_text()
            res = {"variant": name, "card": name_of,
                   "c7510": log.count("C7510"),
                   "spills": [[k[k.find("gemm_rs_"):], st, ld]
                              for k, _, st, ld, _ in
                              _build.resource_usage("gemm_rs", path)
                              if "wgmma" in k],
                   "sass": sass_usage(path),
                   **k14_times(timer)}
            if name not in ("nostore", "nosum"):
                res["worst_err_ratio"] = check(timer)
                if res["worst_err_ratio"] > 2e-2:
                    print(json.dumps(res), flush=True)
                    raise AssertionError(f"variant {name} disagrees with "
                                         "the plain version")
            print(json.dumps(res), flush=True)
    finally:
        for _, tmp in built.values():
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
            print("torch_gemm_rs_ab: CUDA is not available", file=sys.stderr)
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
            print(f"torch_gemm_rs_ab: the run of {root} failed",
                  file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for name, value in runs[1].items():
        if not isinstance(value, (int, float)) or name == "torch":
            continue
        other = [r.get(name) for r in (runs[0], runs[3])]
        other = " / ".join("-" if t is None else f"{t:.4f}" for t in other)
        print(f"{name}: other {other}; this tree {value:.4f} / "
              f"{runs[2][name]:.4f}; {runs[0]['card']}")
    for name in runs[1]:
        if name.endswith(" hash"):
            seen = [str(r.get(name)) for r in runs]
            print(f"{name}: " + ("the same bits in all four runs"
                                 if len(set(seen)) == 1 else
                                 "DIFFERS: " + ", ".join(seen)))
    for lib in LIBS:
        for tag, r in (("other", runs[0]), ("this tree", runs[1])):
            rep = r["ptxas"].get(lib, {})
            print(f"{lib} ({tag}): C7510 lines {rep.get('c7510')}; "
                  + "; ".join(f"{k[0][-48:]} {k[1]} registers, spills "
                              f"{k[2]}/{k[3]} B"
                              for k in rep.get("kernels", [])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
