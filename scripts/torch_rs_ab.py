#!/usr/bin/env python3
"""K16 (`reduce_scatter`, ``scatter_reduce``) and K21b
(`reduce_scatter_torus`) of the PyTorch/CUDA port on one NVIDIA GPU: two
source trees compared, or this tree's variants of their body.

    python3 scripts/torch_rs_ab.py --ab OTHER_ROOT
    python3 scripts/torch_rs_ab.py --variants [VARIANT ...]

``--ab`` runs the measurement for OTHER_ROOT (a checkout of another commit,
for example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone.  A run
measures, bf16, seeded random inputs, every rank of a call in one launch:
- K16 ``scatter_reduce`` at worlds 4 and 8 and K21b on the (2, 2) and
  (2, 2, 2) grids, on 2048 x 4096 a rank (x (W, 2048, 4096), rank c
  getting rows chunk c of the sum), each beside its bound (each rank's x
  read once, what it must receive and its output written once at 3.35
  TB/s) and the local sum (`x.view(W, W, m, n).sum(0, dtype=f32)`, which
  moves nothing between ranks);
- `all_reduce_torus` (K21b then K21a) on both grids, and `gemm_rs_torus`
  (a K6 product a rank, then K21b) at Qwen3-8B's prefill down projection
  (2048 x 3072 @ 3072 x 4096 a rank) on both grids, beside their bounds;
- what must keep its bits and times: K16 ``ring`` at worlds 4 and 8, K17
  (every method at world 4), K14 ``fused`` at the same prefill down shape
  and K10 (`moe_reduce_rs_fused`) on a random routing at world 4;
- a hash of every output (the same bits in both trees: the function does
  not change), and ptxas's report of the ``reduce_scatter`` library.

``--variants`` times this tree's K16 and K21b at the four shapes by variant
(default: all, in the order below, then ``base`` again):
- ``base``: the body as it is;
- ``threads`` / ``bulk``: the copies as each thread's 16-byte loads and
  stores (`dl::put_nbi`, four loads in flight a thread), or as the
  base's bulk copies through shared memory;
- ``whole``: every block waits for every block of each source, not only
  for the blocks that wrote its own range;
- ``nowait``: the sum does not wait for the copies: what the waits cost;
- ``nocopy``: no copies (the signals and the sums stay): what the copies
  cost;
- ``blocks3`` / ``blocks4``: the body compiled for at least 3 or 4
  resident blocks an SM (`__launch_bounds__`), at the registers' expense.
The cut variants (``nowait``, ``nocopy``) give wrong results and are for
timing only; the others are held bit for bit to the plain versions.  Each
set of edits is built from a copy of the sources in a temporary directory
(one ``nvcc``, seconds); the repository is not touched.

Device ms: CUDA events over back-to-back calls queued behind a device spin,
after warm-up.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROWS, COLS, REPS, SPIN = 2048, 4096, 20, 100_000_000
#: label -> (kind, grid sizes): K16 over a flat world, K21b over a grid.
CASES = {"K16 W=4": ("flat", (4,)), "K16 W=8": ("flat", (8,)),
         "K21b (2, 2)": ("torus", (2, 2)),
         "K21b (2, 2, 2)": ("torus", (2, 2, 2))}
#: Qwen3-8B's prefill down projection a rank: rows M, k, n.
GEMM = (2048, 3072, 4096)
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12

#: variant -> (regex, replacement) edits of csrc/reduce_scatter.cu, each
#: matching once.
VARIANTS = {
    "base": [],
    "threads": [(r"  if \(!vec\) \{\n    for \(int j = 1; j < w; \+\+j\)",
                 "  if (true) {\n    for (int j = 1; j < w; ++j)")],
    "bulk": [],
    "whole": [(r"for \(int i = tid; i < w; i \+= blockDim.x\)\n"
               r"    if \(i != me\)\n"
               r"      dl::signal_wait_until\(p.sig\[me\] \+ "
               r"sum_word\(i, b\),",
               "for (int i = tid; i < w * P; i += blockDim.x)\n"
               "    if (i / P != me)\n"
               "      dl::signal_wait_until(p.sig[me] + sum_word(i / P, "
               "i % P),")],
    "nowait": [(r"    if \(i != me\)\n      dl::signal_wait_until",
                "    if (i != me && w < 0)\n      dl::signal_wait_until")],
    "nocopy": [(r"  scatter<T>\(x, p\.rbuf,",
                "  if (w < 0) scatter<T>(x, p.rbuf,")],
    "blocks3": [(r"__launch_bounds__\(comm::COMM_THREADS(?:, \d)?\)\n"
                 r"    scatter_sum_kernel",
                 "__launch_bounds__(comm::COMM_THREADS, 3)\n"
                 "    scatter_sum_kernel")],
    "blocks4": [(r"__launch_bounds__\(comm::COMM_THREADS(?:, \d)?\)\n"
                 r"    scatter_sum_kernel",
                 "__launch_bounds__(comm::COMM_THREADS, 4)\n"
                 "    scatter_sum_kernel")],
}
CUT = ("nowait", "nocopy")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def rs_bound_ms(world: int, shard_bytes: int) -> float:
    """A reduce-scatter's least time (`chip_smoke.collective_bound`): each
    rank's x read once, the (W - 1) / W of x it must receive and its 1 / W
    of x written once, at the HBM rate."""
    return 2 * world * shard_bytes / PEAK_BYTES_PER_S * 1e3


def ar_bound_ms(world: int, shard_bytes: int) -> float:
    """An all-reduce's least time (`chip_smoke.collective_bound`): each
    rank's x read, the reduce-scatter half's (W - 1) / W x received and W
    copies of the sum written."""
    return (3 * world - 1) * shard_bytes / PEAK_BYTES_PER_S * 1e3


def gemm_rs_bound_ms(world: int) -> float:
    """A GEMM-reduce-scatter's least time (`chip_smoke.tp_collective_bound`
    for K14): the A shards, the partials every rank receives, B and the
    output once each at the HBM rate, or the products at the bf16 peak."""
    m, k, n = GEMM
    mc = m // world
    moved = 2 * (world * m * k + world * (world - 1) * mc * n + world * k * n
                 + world * mc * n)
    return max(moved / PEAK_BYTES_PER_S, 2 * world * m * k * n
               / PEAK_BF16_FLOPS) * 1e3


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


def randn(gen, *shape):
    import torch

    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def call(kind, sizes, method="scatter_reduce"):
    """The reduce-scatter of ``kind`` on ``sizes`` as a function of x."""
    from triton_distributed_tpu_torch.kernels import torus
    from triton_distributed_tpu_torch.kernels.reduce_scatter import (
        ReduceScatterContext, reduce_scatter)

    if kind == "torus":
        ctx = torus.TorusContext(("x", "y", "z")[:len(sizes)], sizes)
        return lambda x: torus.reduce_scatter_torus(x, ctx)
    ctx = ReduceScatterContext("tp", sizes[0], method)
    return lambda x: reduce_scatter(x, ctx)


def rs_times(timer, out: dict) -> None:
    """K16 and K21b at the four shapes, beside the bound and the local sum,
    with a hash of each output."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(19)
    for label, (kind, sizes) in CASES.items():
        w = math.prod(sizes)
        x = randn(gen, w, ROWS, COLS)
        fn = call(kind, sizes)
        out[label] = timer(lambda: fn(x))
        out[f"{label} hash"] = digest(fn(x))
        out[f"{label} bound"] = rs_bound_ms(w, x[0].numel() * 2)
        out[f"{label} local sum"] = timer(lambda: x.view(
            w, w, -1, COLS).sum(0, dtype=torch.float32).to(x.dtype))
        del x


def check(kinds=CASES) -> None:
    """K16 and K21b bit for bit against their plain versions at a shape of
    each case with rows off the pieces (CPU plain versions)."""
    import torch

    from triton_distributed_tpu_torch.kernels import torus
    from triton_distributed_tpu_torch.kernels.reduce_scatter import (
        reduce_scatter_reference)

    gen = torch.Generator(device="cuda").manual_seed(23)
    for label, (kind, sizes) in kinds.items():
        w = math.prod(sizes)
        for rows, cols in ((w * 100, 264), (w * 256, 1024)):
            x = randn(gen, w, rows, cols)
            got = call(kind, sizes)(x).cpu()
            want = (torus.reduce_scatter_torus_plain(x.cpu(), sizes)
                    if kind == "torus" else
                    reduce_scatter_reference(x.cpu(), "scatter_reduce"))
            if not torch.equal(got, want):
                raise AssertionError(f"{label} at {tuple(x.shape)} differs "
                                     "from its plain version")


def callers(timer, out: dict) -> None:
    """`all_reduce_torus` and `gemm_rs_torus` on both grids, with hashes."""
    import torch

    from triton_distributed_tpu_torch.kernels import torus
    from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
        gemm_rs)

    gen = torch.Generator(device="cuda").manual_seed(29)
    m, k, n = GEMM
    for sizes in ((2, 2), (2, 2, 2)):
        w = math.prod(sizes)
        ctx = torus.TorusContext(("x", "y", "z")[:len(sizes)], sizes)
        x = randn(gen, w, ROWS, COLS)
        label = f"all_reduce_torus {sizes}"
        out[label] = timer(lambda: torus.all_reduce_torus(x, ctx))
        out[f"{label} hash"] = digest(torus.all_reduce_torus(x, ctx))
        out[f"{label} bound"] = ar_bound_ms(w, x[0].numel() * 2)
        a, b = randn(gen, w, m, k), randn(gen, w, k, n) * (w * k) ** -0.5
        label = f"gemm_rs_torus {sizes}"
        out[label] = timer(lambda: gemm_rs(a, b, ctx), 10)
        out[f"{label} hash"] = digest(gemm_rs(a, b, ctx))
        out[f"{label} bound"] = gemm_rs_bound_ms(w)
        del x, a, b


def neighbours(timer, out: dict) -> None:
    """K16 ``ring``, K17's methods, K14 ``fused`` and K10: ms and hashes."""
    import torch

    from triton_distributed_tpu_torch.kernels.allreduce import (
        AllReduceContext, all_reduce)
    from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
        GEMMReduceScatterContext, gemm_rs)
    from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
        MoEReduceRSContext, moe_reduce_rs_fused)
    from triton_distributed_tpu_torch.kernels.moe_utils import plan_chunks

    gen = torch.Generator(device="cuda").manual_seed(31)
    for w in (4, 8):
        x = randn(gen, w, ROWS, COLS)
        fn = call("flat", (w,), "ring")
        out[f"K16 ring W={w}"] = timer(lambda: fn(x))
        out[f"K16 ring W={w} hash"] = digest(fn(x))
    x = randn(gen, 4, ROWS, COLS)
    for method in ("one_shot", "two_shot", "ring", "chain"):
        ctx = AllReduceContext("tp", 4, method)
        out[f"K17 {method}"] = timer(lambda: all_reduce(x, ctx))
        out[f"K17 {method} hash"] = digest(all_reduce(x, ctx))
    m, k, n = GEMM
    a, b = randn(gen, 4, m, k), randn(gen, 4, k, n) * (4 * k) ** -0.5
    ctx = GEMMReduceScatterContext("tp", 4, "fused")
    out["K14 fused"] = timer(lambda: gemm_rs(a, b, ctx), 10)
    out["K14 fused hash"] = digest(gemm_rs(a, b, ctx))
    # K10 at world 4: 256 tokens a rank, 32 experts, top 4, capacity 64,
    # k 192 and n 2048 a rank (Qwen3-30B-A3B's down projection widths).
    world, mc, e, topk, cap, kk, nn = 4, 256, 32, 4, 64, 192, 2048
    cpu = torch.Generator().manual_seed(37)
    ids = torch.stack([torch.randperm(e, generator=cpu)[:topk]
                       for _ in range(world * mc)]).to(torch.int32).cuda()
    wts = torch.softmax(torch.randn(world * mc, topk, generator=cpu),
                        -1).cuda()
    plan = plan_chunks(ids, wts, world, e, cap)
    acts = randn(gen, world, world, e, cap, kk)
    weights = randn(gen, world, e, kk, nn) * (world * kk) ** -0.5
    mctx = MoEReduceRSContext("tp", world, e, topk)
    out["K10"] = timer(lambda: moe_reduce_rs_fused(acts, weights, plan,
                                                   mctx), 10)
    out["K10 hash"] = digest(moe_reduce_rs_fused(acts, weights, plan, mctx))


def ptxas(path=None) -> dict:
    from triton_distributed_tpu_torch.kernels import _build

    path = path or _build._library_path("reduce_scatter")
    if not path.exists():
        return {}
    log = path.with_suffix(".log").read_text()
    return {"c7510": log.count("C7510"),
            "kernels": [list(r) for r in
                        _build.resource_usage("reduce_scatter", path)]}


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels import _build

    _build.build(["reduce_scatter", "torus", "all_gather", "all_reduce",
                  "gemm_rs", "grouped_matmul", "moe_reduce_rs"])
    timer = Timer()
    out = {"root": str(root), "card": card(), "torch": torch.__version__}
    rs_times(timer, out)
    callers(timer, out)
    neighbours(timer, out)
    out["ptxas"] = ptxas()
    return out


def build_variant(name: str):
    """The ``reduce_scatter`` library from a copy of this tree's sources
    with variant ``name``'s edits; returns (library path, temporary
    directory)."""
    from triton_distributed_tpu_torch.kernels import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"rs_{name}_"))
    shutil.copytree(_build.CSRC, tmp / "csrc")
    src = tmp / "csrc" / "reduce_scatter.cu"
    text = src.read_text()
    for pattern, new in VARIANTS[name]:
        text, count = re.subn(pattern, lambda _m, new=new: new, text)
        if count != 1:
            raise RuntimeError(f"variant {name}: {pattern!r} matched {count} "
                               "times")
    src.write_text(text)
    path = _build.build(["reduce_scatter"], csrc=tmp / "csrc",
                        build_dir=tmp / "build")["reduce_scatter"]
    return path, tmp


def variants(names) -> int:
    import torch

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs

    if not torch.cuda.is_available():
        print("torch_rs_ab: CUDA is not available", file=sys.stderr)
        return 1
    timer, name_of = Timer(), card()
    built = {}  # variant -> (library, temporary directory)
    try:
        for name in names:
            if name not in built:
                built[name] = build_variant(name)
        for name in names:
            path, _ = built[name]
            _build._loaded["reduce_scatter"] = _build.load_path(
                path, rs._SIGNATURES)
            res = {"variant": name, "card": name_of, "ptxas": ptxas(path)}
            rs_times(timer, res)
            if name not in CUT:
                check()
                res["bits"] = "equal to the plain versions"
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
            print("torch_rs_ab: CUDA is not available", file=sys.stderr)
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
            print(f"torch_rs_ab: the run of {root} failed", file=sys.stderr)
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
    for tag, r in (("other", runs[0]), ("this tree", runs[1])):
        rep = r["ptxas"]
        print(f"reduce_scatter ({tag}): C7510 lines {rep.get('c7510')}; "
              + "; ".join(f"{k[0][-40:]} {k[1]} registers, spills "
                          f"{k[2]}/{k[3]} B" for k in rep.get("kernels", [])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
