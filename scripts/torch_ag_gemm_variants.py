#!/usr/bin/env python3
"""K12 (`ag_gemm`) of the PyTorch/CUDA port by variant, or against another
source tree, on one NVIDIA GPU: device ms at Qwen3-8B's world-4 shapes
(hidden 4096; QKV slice n = 1536, gate_up slice n = 6144; prefill 512 rows
a rank, decode 1) in both methods, bf16, the 4 ranks in one launch.

    python3 scripts/torch_ag_gemm_variants.py [VARIANT ...]
    python3 scripts/torch_ag_gemm_variants.py --ab OTHER_ROOT

Variants (default: base wide nogemm nowait nostore base):
- ``base``: the kernel as it is (decode ``ll``: 64 x 64 tiles, `wgmma`
  m64n64k16 with 12 stages of 16 KB, where `allgather_gemm.ll_tile_n`
  takes them: QKV's 24 column tiles a rank, not 6);
- ``wide``: decode ``ll`` on the 64 x 256 tile always;
- ``nogemm``: the protocol alone: the entry barrier, the copies and
  signals, the producers' arrival waits and the launch, with no TMA load,
  product or store (what K12 costs beside its GEMM);
- ``nowait``: the producers do not wait for the gathered rows (what the
  dependency on the gather costs);
- ``nostore``: ``ll``'s epilogue (the store) is skipped.
The cut variants give wrong results and are for timing only.  Each variant
is built from a copy of the sources in a temporary directory (one ``nvcc``,
seconds); the repository is not touched.  ``--ab`` times OTHER_ROOT (a
checkout of another commit, for example ``git archive`` of the parent
unpacked into a git-ignored directory), this tree, this tree and OTHER_ROOT
again, each in its own process.

Device ms: CUDA events over back-to-back calls queued behind a device spin:
``ms`` rotates over 8 sets of operands (the weights come from HBM, as
in a model's layers), ``warm_ms`` repeats one set, as `chip_smoke.py`
times it (50 MB of QKV weights at world 4 fit the 50 MB L2).  Prints one
JSON line a run (a variant's also counts ptxas's C7510 lines: a function
call in a kernel makes ptxas serialize its `wgmma`s).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
WORLD, HIDDEN, SETS, REPS, SPIN = 4, 4096, 8, 5, 100_000_000
SHAPES = {"prefill QKV": (512, 1536), "prefill gate_up": (512, 6144),
          "decode QKV": (1, 1536), "decode gate_up": (1, 6144)}

_RUN = "    Tile::run(smem, &p.tb, ntiles, sched);\n"
#: variant -> (text, its replacement[, the source file, by default
#: ag_gemm.cu]) edits, and whether the host may take the narrow tile.
EDITS = {
    "base": ([], True),
    "wide": ([], False),
    "nogemm": ([(_RUN,
                 "    if (threadIdx.x >= Tile::NT - wg::WG + 32)\n"
                 "      sched.side(threadIdx.x - (Tile::NT - wg::WG + 32));\n"
                 "    else if (threadIdx.x == Tile::NT - wg::WG)\n"
                 "      for (int t = blockIdx.x; t < ntiles; t += gridDim.x)"
                 "\n        if (sched.pending(t)) sched.ready(t);\n")], True),
    "nowait": ([("      comm::ring_wait_chunk(p->sig, me, c, target, "
                 "tdt::WAIT_AG_GEMM_PUSH);\n", ""),
                ("    comm::ring_wait_chunk(p->sig, me, held, target, "
                 "tdt::WAIT_AG_GEMM_RING);\n", "")], True),
    "nostore": ([("    wg::store_tile(p->out + (size_t)y * M * p->n,",
                  "    if (p->m > 0) return;\n"
                  "    wg::store_tile(p->out + (size_t)y * M * p->n,")],
                True),
}


def build_variant(name: str, root: Path = HERE):
    """Build K12's library from a copy of ``root``'s sources with variant
    ``name``'s edits; returns (library path, temporary directory)."""
    sys.path.insert(0, str(root))
    from triton_distributed_tpu_torch.kernels import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"ag_gemm_{name}_"))
    shutil.copytree(_build.CSRC, tmp / "csrc")
    for edit in EDITS[name][0]:
        old, new, src = (*edit, "ag_gemm.cu")[:3]
        text = (tmp / "csrc" / src).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {src}")
        (tmp / "csrc" / src).write_text(text.replace(old, new))
    path = _build.build(["ag_gemm"], csrc=tmp / "csrc",
                        build_dir=tmp / "build")["ag_gemm"]
    return path, tmp


def use_variant(path: Path, narrow: bool):
    """Route this process's `ag_gemm` calls to the library at ``path``
    (the narrow decode tile only if ``narrow``); returns a function that
    undoes it."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import allgather_gemm as agm

    saved = _build._loaded.get("ag_gemm"), agm.ll_tile_n
    _build._loaded["ag_gemm"] = _build.load_path(path, agm._SIGNATURES)
    if not narrow:
        agm.ll_tile_n = lambda n, blocks: agm.WGMMA_TILE_N

    def undo():
        if saved[0] is None:
            _build._loaded.pop("ag_gemm", None)
        else:
            _build._loaded["ag_gemm"] = saved[0]
        agm.ll_tile_n = saved[1]
    return undo


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def measure(root: Path) -> dict:
    """Device ms of K12 at SHAPES in both methods, with the package of
    ``root`` (already first on sys.path when it is another tree)."""
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels.allgather_gemm import (
        AllGatherGEMMContext, ag_gemm)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def device_ms(fn, sets):
        call = lambda: [fn(*s) for s in sets]  # noqa: E731
        for _ in range(2):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN)
        start.record()
        for _ in range(REPS):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS / len(sets)

    out = {"root": str(root), "card": card()}
    for label, (m, n) in SHAPES.items():
        sets = [(torch.randn(WORLD, m, HIDDEN, generator=gen, device=dev,
                             dtype=torch.bfloat16),
                 torch.randn(WORLD, HIDDEN, n, generator=gen, device=dev,
                             dtype=torch.bfloat16) * HIDDEN ** -0.5)
                for _ in range(SETS)]
        for method in ("fused", "ll"):
            ctx = AllGatherGEMMContext("tp", WORLD, method)
            fn = lambda a, b: ag_gemm(a, b, ctx)  # noqa: E731
            out[f"{label} {method}"] = {
                "ms": device_ms(fn, sets),
                "warm_ms": device_ms(fn, sets[:1] * SETS)}
        del sets
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--ab", type=Path, metavar="OTHER_ROOT")
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_ag_gemm_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    if args.root is not None:
        print(json.dumps(measure(args.root.resolve())), flush=True)
        return 0
    if args.ab is not None:
        for root in (args.ab.resolve(), HERE, HERE, args.ab.resolve()):
            res = subprocess.run(
                [sys.executable, __file__, "--root", str(root)],
                capture_output=True, text=True, cwd=root)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return res.returncode
            print(res.stdout.strip().splitlines()[-1], flush=True)
        return 0
    names = args.variants or ["base", "wide", "nogemm", "nowait", "nostore",
                              "base"]
    built, threads = {}, []
    for name in dict.fromkeys(names):
        th = threading.Thread(target=lambda nm=name: built.__setitem__(
            nm, build_variant(nm)))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    for name in names:
        path = built[name][0]
        undo = use_variant(path, EDITS[name][1])
        res = measure(HERE)
        undo()
        # ptxas's C7510: its `wgmma`s serialized by a function call.
        serialized = path.with_suffix(".log").read_text().count("C7510")
        print(json.dumps({"variant": name, "c7510": serialized, **res}),
              flush=True)
    for _, tmp in built.values():
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
