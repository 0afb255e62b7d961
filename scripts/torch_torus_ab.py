#!/usr/bin/env python3
"""K21c (`ag_gemm_torus`) of the PyTorch/CUDA port on one NVIDIA GPU: two
source trees compared.

    python3 scripts/torch_torus_ab.py --ab OTHER_ROOT
    python3 scripts/torch_torus_ab.py --root DIR
    python3 scripts/torch_torus_ab.py --variants [VARIANT ...]

``--ab`` runs the measurement for OTHER_ROOT (a checkout of another commit,
for example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone.  A run
measures, bf16, seeded random inputs, every rank in one launch:
- K21c at Qwen3-8B's prefill gate_up a rank (a 512 x 4096, B 4096 x 6144)
  on the (2, 2) and (2, 2, 2) grids, beside K12 ``fused`` at the same
  world, ``torch.matmul`` of the gathered A with the stacked B (the same
  product without the gather) and the bound, with a hash of K21c's output
  and whether it equals K12's bit for bit;
- K6, K8, K12 and K14, which share the `wgmma` tile, at
  `scripts/torch_gemm_rs_ab.py`'s shapes, with a hash of each output (the
  tile must leave their bits alone);
- ptxas's report of the ``torus`` library (registers and spills a kernel,
  the lines saying a call serialized the `wgmma`s, C7510).

``--variants`` times this tree's K21c on both grids by variant (default:
all, in the order below, then ``base`` again), each with its ptxas spills
and its SASS's top register and local-memory loads and stores:
- ``base``: the kernel as it is;
- ``nowait``: the TMA thread does not wait for a piece's arrival (what the
  dependency on the gather costs);
- ``nocopy``: the crews copy only their own piece (the signals and waits
  stay): what the lanes' copies cost.
The cut variants give wrong results and are for timing only; ``base`` is
held to K12 ``fused`` bit for bit.  Each variant is built from a copy of
the sources in a temporary directory (one ``nvcc``, seconds); the
repository is not touched.

Device ms: CUDA events over back-to-back calls queued behind a device spin,
after warm-up.  ``ms`` rotates over 4 sets of operands (the weights come
from HBM, as in a model's layers); ``warm_ms`` repeats one set, as
`chip_smoke.py` times it.  Every line carries the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from torch_gemm_rs_ab import (
    PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, REPS, Timer, card, digest, ptxas)

HERE = Path(__file__).resolve().parent.parent
SETS = 4
GATE_UP = (512, 4096, 6144)
GRIDS = ((2, 2), (2, 2, 2))
LIBS = ("torus", "ag_gemm", "gemm_rs", "grouped_matmul")

#: variant -> (text, its replacement) edits of torus.cu.
VARIANTS = {
    "base": [],
    "nowait": [("    return (need & ~held) != 0;\n", "    return false;\n")],
    "nocopy": [("        comm::crew_copy(out[nbr] + off, cell == me ? x + start "
                ": mine + off,\n                        piece, part, parts, "
                "crew);\n", "")],
}


def bound_ms(world: int, m: int, k: int, n: int) -> tuple[float, str]:
    """K21c's least time (`chip_smoke.tp_collective_bound` of K12): the A
    shards, the rows every rank receives, B and the output once each at
    the HBM rate, or the GEMM's operations at the bf16 peak."""
    moved = 2 * (world * m * k + world * (world - 1) * m * k + world * k * n
                 + world * world * m * n)
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * world * world * m * k * n / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k21c_times(out: dict, timer) -> None:
    """K21c on each grid, rotating and warm, beside K12 fused at the same
    world, the library and the bound; the output's hash."""
    import torch

    from triton_distributed_tpu_torch.kernels import torus
    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        AllGatherGEMMContext, ag_gemm)

    m, k, n = GATE_UP
    for i, sizes in enumerate(GRIDS):
        world = 1
        for s in sizes:
            world *= s
        gen = torch.Generator(device="cuda").manual_seed(i)
        sets = [(torch.randn((world, m, k), generator=gen, device="cuda",
                             dtype=torch.bfloat16),
                 torch.randn((world, k, n), generator=gen, device="cuda",
                             dtype=torch.bfloat16) * k ** -0.5)
                for _ in range(SETS)]
        it = [0]

        def rotate(fn):
            def call():
                a, b = sets[it[0] % SETS]
                it[0] += 1
                return fn(a, b)
            return call

        ctx = torus.TorusContext(("x", "y", "z")[:len(sizes)], sizes)
        k12 = AllGatherGEMMContext("tp", world, "fused")
        label = f"K21c {sizes}"
        wg0 = getattr(torus.ag_gemm_torus, "wgmma_launches", None)
        out[label] = timer(rotate(lambda a, b: torus.ag_gemm_torus(a, b, ctx)),
                           REPS * SETS // 2)
        a, b = sets[0]
        out[f"{label} warm"] = timer(lambda: torus.ag_gemm_torus(a, b, ctx))
        wg1 = getattr(torus.ag_gemm_torus, "wgmma_launches", None)
        out[f"{label} on the wgmma body"] = (None if wg0 is None
                                             else wg1 > wg0)
        out[f"K12 fused world {world}"] = timer(rotate(
            lambda a, b: ag_gemm(a, b, k12)), REPS * SETS // 2)
        out[f"{label} library"] = timer(rotate(
            lambda a, b: torch.matmul(a.reshape(1, -1, k), b)),
            REPS * SETS // 2)
        out[f"{label} bound"] = bound_ms(world, m, k, n)[0]
        got = torus.ag_gemm_torus(a, b, ctx)
        out[f"{label} hash"] = digest(got)
        out[f"{label} equals K12 fused"] = bool(torch.equal(
            got, ag_gemm(a, b, k12)))
        del sets, got
        torch.cuda.empty_cache()


def neighbours(out: dict, timer) -> None:
    """K6, K8, K12 and K14 at `scripts/torch_gemm_rs_ab.py`'s shapes: ms
    and a hash of the output."""
    import torch

    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        AllGatherGEMMContext, ag_gemm)
    from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
        GEMMReduceScatterContext, gemm_rs)
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
        ctx = AllGatherGEMMContext("tp", 4, method)
        cases[name] = (randn(4, m, 4096), randn(4, 4096, n) * 4096 ** -0.5,
                       lambda a, b, ctx=ctx: ag_gemm(a, b, ctx))
    for name, (m, k, method) in {
            "K14 prefill down fused": (2048, 3072, "fused"),
            "K14 decode O ll": (4, 1024, "ll")}.items():
        ctx = GEMMReduceScatterContext("tp", 4, method)
        cases[name] = (randn(4, m, k), randn(4, k, 4096) * (4 * k) ** -0.5,
                       lambda a, b, ctx=ctx: gemm_rs(a, b, ctx))
    for name, (a, b, fn) in cases.items():
        out[name] = timer(lambda: fn(a, b), 20)
        out[f"{name} hash"] = digest(fn(a, b))


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels import _build

    _build.build(list(LIBS))  # one nvcc each, together
    timer = Timer()
    out = {"root": str(root), "card": card(), "torch": torch.__version__}
    k21c_times(out, timer)
    neighbours(out, timer)
    out["ptxas"] = {"torus": ptxas("torus")}
    return out


def build_variant(name: str):
    """The torus library from a copy of this tree's sources with variant
    ``name``'s edits; returns (library path, temporary directory)."""
    from triton_distributed_tpu_torch.kernels import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"torus_{name}_"))
    shutil.copytree(_build.CSRC, tmp / "csrc")
    src = tmp / "csrc" / "torus.cu"
    for old, new in VARIANTS[name]:
        text = src.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in torus.cu")
        src.write_text(text.replace(old, new))
    path = _build.build(["torus"], csrc=tmp / "csrc",
                        build_dir=tmp / "build")["torus"]
    return path, tmp


def sass_usage(path: Path, prefix: str = "torus_") -> dict:
    """Per `wgmma` kernel of the library at ``path``: the highest register
    its SASS names and its local-memory loads and stores, from
    ``cuobjdump``; kernels named from ``prefix`` on."""
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
            out[name[name.find(prefix):][:60]] = {
                "max_register": max(regs, default=0),
                "local_ops": len(re.findall(r"\b(?:STL|LDL)\b", body))}
    return out


def variants(names) -> int:
    import torch

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import torus

    if not torch.cuda.is_available():
        print("torch_torus_ab: CUDA is not available", file=sys.stderr)
        return 1
    timer, name_of = Timer(), card()
    built = {}  # variant -> (library, temporary directory)
    try:
        for name in names:
            if name not in built:
                built[name] = build_variant(name)
        for name in names:
            path, _ = built[name]
            _build._loaded["torus"] = _build.load_path(path,
                                                       torus._SIGNATURES)
            res = {"variant": name, "card": name_of,
                   "c7510": path.with_suffix(".log").read_text().count(
                       "C7510"),
                   "spills": [[k[k.find("torus_"):][:60], st, ld]
                              for k, _, st, ld, _ in
                              _build.resource_usage("torus", path)
                              if "wgmma" in k],
                   "sass": sass_usage(path)}
            k21c_times(res, timer)
            print(json.dumps(res), flush=True)
            if name == "base" and not all(
                    res[f"K21c {s} equals K12 fused"] for s in GRIDS):
                raise AssertionError("base differs from K12 fused")
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
            print("torch_torus_ab: CUDA is not available", file=sys.stderr)
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
            print(f"torch_torus_ab: the run of {root} failed",
                  file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for name, value in runs[1].items():
        if (not isinstance(value, (int, float)) or isinstance(value, bool)
                or name == "torch"):
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
        elif isinstance(runs[1][name], bool) or runs[1][name] is None:
            print(f"{name}: " + ", ".join(str(r.get(name)) for r in runs))
    for tag, r in (("other", runs[0]), ("this tree", runs[1])):
        rep = r["ptxas"].get("torus", {})
        print(f"torus ({tag}): C7510 lines {rep.get('c7510')}; "
              + "; ".join(f"{k[0][-48:]} {k[1]} registers, spills "
                          f"{k[2]}/{k[3]} B" for k in rep.get("kernels", [])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
