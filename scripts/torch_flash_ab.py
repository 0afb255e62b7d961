#!/usr/bin/env python3
"""Flash attention (K1), SP attention (K20) and the `wgmma` GEMM kernels
(K6, K8, K12) of the PyTorch/CUDA port, two source trees compared on one
NVIDIA GPU: device ms at `chip_smoke.py`'s shapes, and each library's
ptxas report (registers, spills, lines saying it serialized `wgmma`s).

    python3 scripts/torch_flash_ab.py --ab OTHER_ROOT

runs the measurement for OTHER_ROOT (a checkout of another commit, for
example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone;
``--roots DIR ...`` each tree in turn (give each twice, in mirrored order,
to see the drift); ``--attention`` leaves out K6, K8 and K12.

Cases (bf16, seeded random inputs, Qwen3-8B's 32/8 heads of 128):
- K1a 4 x 512 causal (the Engine prefill), K1b 1 x 2048 causal (a
  bucket), K1c 2 x 8/4 heads, 128 queries over 256 keys at offset 128 (a
  ring step), K1 over 32,768 tokens at world 1;
- K20 at world 4 over 32,768 tokens (8,192 a rank) and, where the tree
  has it, its consumers alone on chunks already in the ring buffers;
- K6 2048 x 4096 @ 4096 x 24576; K8 128 experts of 16 rows, 2048 @ 2048 x
  1536 (decode gate_up); K12 `fused` 4 x 512 x 4096 @ 4096 x 6144 a rank
  (prefill gate_up) and `ll` 4 x 1 x 4096 @ 4096 x 1536 (decode QKV).
Device ms: CUDA events over back-to-back calls queued behind a device
spin, after warm-up.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SPIN = 100_000_000
LIBS = ("flash_attention", "sp_ag_attention", "grouped_matmul", "ag_gemm")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def measure(root: Path, gemms: bool = True) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp
    from triton_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def device_ms(fn, reps, warmup=2):
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

    out = {"root": str(root), "card": card()}
    k1 = {"K1a": ((4, 32, 512), (4, 8, 512), 0, 50),
          "K1b": ((1, 32, 2048), (1, 8, 2048), 0, 50),
          "K1c": ((2, 8, 128), (2, 4, 256), 128, 50),
          "K1 32768": ((1, 32, 32768), (1, 8, 32768), 0, 3)}
    for name, (qs, ks, off, reps) in k1.items():
        q, k, v = randn(*qs, 128), randn(*ks, 128), randn(*ks, 128)
        out[name] = device_ms(lambda: flash_attention(q, k, v,
                                                      kv_offset=off), reps)
        del q, k, v

    w, s_loc = 4, 8192
    q = randn(w, 1, 32, s_loc, 128)
    k, v = randn(w, 1, 8, s_loc, 128), randn(w, 1, 8, s_loc, 128)
    out["K20 world 4"] = device_ms(lambda: sp.sp_ag_attention_fused(q, k, v),
                                   3)
    try:
        out["K20 consumers alone"] = device_ms(lambda: sp._launch(
            q, k, v, [r * s_loc for r in range(w)], [0] * w, 128 ** -0.5,
            sp.cids.SP_AG_FUSED, None, False, 0, ring=False), 3)
    except TypeError:  # a tree whose K20 has no such form
        pass
    del q, k, v

    if gemms:
        gemm_times(out, randn, device_ms)
    out["ptxas"] = {}
    for lib in LIBS:
        path = _build._library_path(lib)
        if path.exists():
            log = path.with_suffix(".log").read_text()
            out["ptxas"][lib] = {
                "c7510": log.count("C7510"),
                "serialized": log.count(
                    "wgmma.mma_async instructions are serialized"),
                "kernels": [list(r) for r in _build.resource_usage(lib)]}
    return out


def gemm_times(out, randn, device_ms) -> None:
    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        AllGatherGEMMContext, ag_gemm)
    from triton_distributed_tpu_torch.kernels.grouped_gemm import (
        grouped_matmul)
    from triton_distributed_tpu_torch.kernels.matmul import matmul

    w = 4
    a, b = randn(2048, 4096), randn(4096, 24576) * 4096 ** -0.5
    out["K6"] = device_ms(lambda: matmul(a, b), 20)
    a, b = randn(128, 16, 2048), randn(128, 2048, 1536) * 2048 ** -0.5
    out["K8 decode gate_up"] = device_ms(lambda: grouped_matmul(a, b), 20)
    for name, (m, n, method) in {
            "K12 prefill gate_up fused": (512, 6144, "fused"),
            "K12 decode QKV ll": (1, 1536, "ll")}.items():
        a, b = randn(w, m, 4096), randn(w, 4096, n) * 4096 ** -0.5
        ctx = AllGatherGEMMContext("tp", w, method)
        out[name] = device_ms(lambda: ag_gemm(a, b, ctx), 20)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", type=Path)
    group.add_argument("--ab", type=Path, metavar="OTHER_ROOT")
    group.add_argument("--roots", type=Path, nargs="+")
    ap.add_argument("--attention", action="store_true")
    args = ap.parse_args()
    if args.root is not None:
        import torch

        if not torch.cuda.is_available():
            print("torch_flash_ab: CUDA is not available", file=sys.stderr)
            return 1
        print(json.dumps(measure(args.root.resolve(), not args.attention)),
              flush=True)
        return 0
    runs = []
    roots = ([r.resolve() for r in args.roots] if args.roots else
             [args.ab.resolve(), HERE, HERE, args.ab.resolve()])
    for root in roots:
        res = subprocess.run(
            [sys.executable, __file__, "--root", str(root)]
            + ["--attention"] * args.attention,
            capture_output=True, text=True, cwd=str(root),
            env={**os.environ, "PYTHONPATH": str(root)})
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            print(f"torch_flash_ab: the run of {root} failed",
                  file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    if args.roots:
        for name in runs[0]:
            if isinstance(runs[0][name], float):
                print(f"{name}: " + "; ".join(
                    f"{Path(r['root']).name} {r.get(name, float('nan')):.4f}"
                    for r in runs)
                    + f" ms; {runs[0]['card']}")
        return 0
    for name, value in runs[1].items():
        if not isinstance(value, float):
            continue
        other = [r.get(name) for r in (runs[0], runs[3])]
        other = " / ".join("-" if t is None else f"{t:.4f}" for t in other)
        print(f"{name}: other {other} ms; this tree {value:.4f} / "
              f"{runs[2][name]:.4f} ms; {runs[0]['card']}")
    for lib in runs[0]["ptxas"]:
        print(f"{lib} C7510 lines: other {runs[0]['ptxas'][lib]['c7510']}, "
              f"this tree {runs[1]['ptxas'][lib]['c7510']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
