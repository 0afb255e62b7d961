#!/usr/bin/env python3
"""K18 (`barrier_all_on_axis`, `broadcast`) and K17 ``two_shot``
(`all_reduce`) of the PyTorch/CUDA port on one NVIDIA GPU: two source trees
compared, or this tree's variants of their bodies.

    python3 scripts/torch_collectives_ab.py --ab OTHER_ROOT
    python3 scripts/torch_collectives_ab.py --variants [VARIANT ...]

``--ab`` runs the measurement for OTHER_ROOT (a checkout of another commit,
for example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone.  A run
measures, bf16, seeded random inputs, every rank of a call in one launch:
- the broadcast (root 2), the barrier and ``two_shot`` at W = 4 and 8 on
  2048 x 4096, 64 x 1024 (the smoke's K18 payload on its main path) and 4 x
  4096 a rank (decode's), each beside its bound (each rank's x
  read once, what it must receive and each output written once at 3.35
  TB/s, `chip_smoke.collective_bound`) and its library call
  (``x[root].expand(W, ...).contiguous()``, ``x.clone()``, the f32 sum over
  the ranks cast and expanded to W copies); at the two small payloads also
  the host us a call (the least of five windows of 100 calls enqueued back
  to back, no sync between them);
- what must keep its bits and times: K16 ``scatter_reduce`` and ``ring``
  at W = 4 and 8, K21b on (2, 2) and (2, 2, 2), and K17 ``one_shot``,
  ``chain`` and ``ring`` at W = 4, on 2048 x 4096 a rank;
- a hash of every output (the same bits in both trees: the functions do
  not change), and ptxas's report of the ``common_ops``, ``all_reduce`` and
  ``reduce_scatter`` libraries.

``--variants`` times this tree's K18 and K17 ``two_shot`` at W = 4 and 8 on
the three payloads by variant (default: all, in the order
below, then ``base`` again), each form made as edits of a copy of the
sources:
- ``base``: the bodies as they are;
- ``gather``: the broadcast as a scatter, then an all-gather: block b of
  the root puts its part of chunk c of x into rank c's output, and block b
  of rank c, once its part has landed, forwards it into the W - 1 other
  outputs (every rank's blocks copy; the root reads and sends x once), not
  the root's blocks alone storing each piece into all W outputs;
- ``waitfirst``: the barrier waits for every rank before its copy (the JAX
  kernel's order), not after;
- ``regs``: ``two_shot`` stores each 16-byte unit of its sum from
  registers into all W outputs, not through shared-memory slabs
  bulk-stored while the next slab is summed;
- ``threads``: every copy of the three kernels as each thread's 16-, 4- or
  1-byte loads and stores (`dl::put_nbi`), not bulk copies;
- ``allbulk``: the barrier's copy by bulk copies through 4 x 8 KB of
  shared memory a block, as the broadcast's, not the threads' copies;
- ``stride``: the barrier's threads copy x in a grid-stride loop over the
  rank's blocks (16-byte units 4 KB apart swept by every block together),
  not each block its own contiguous share;
- ``smN``: the barrier at most N blocks an SM, every rank's together, not
  BARRIER_BLOCKS_PER_SM (``sm64``: as many as fit; the default list takes
  ``sm1``, ``sm4`` and ``sm64``); ``capN``: at most N blocks a rank, as
  many an SM as fit (not in the default list);
- ``whole``: every block waits for every block of each source (the
  broadcast's arrival bank and ``two_shot``'s two), not only for the blocks
  that wrote its own range.
Every variant is held bit for bit to the plain versions.  Each set of
edits is built from a copy of the sources in a temporary directory (one
``nvcc`` a library, all started together); the repository is not touched.

Device ms: CUDA events over back-to-back calls queued behind a device spin,
after warm-up.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROWS, COLS, REPS, SPIN = 2048, 4096, 20, 100_000_000
#: Rows x columns a rank: the prefill payload, the main path's K18 payload
#: (`chip_smoke.py` ``ops.broadcast`` and the barrier) and decode's.
PAYLOADS = ((ROWS, COLS), (64, 1024), (4, COLS))
WORLDS = (4, 8)
ROOT = 2
PEAK_BYTES_PER_S = 3.35e12
#: The libraries a variant rebuilds.
LIBS = ("common_ops", "all_reduce")

_PUSH_TO_END = (r"(?s)  // The root's block b: its share of x into every "
                r"rank's out\..*?\n}\n\n// ``moved``")
_GATHER = """  // A scatter, then an all-gather: the root's block b puts its part of
  // chunk c into rank c's out; block b of rank c, once its part has landed,
  // forwards it into the W - 1 other outs.  Scatter words from ARRIVAL_WORD,
  // gather words (c, g) from GATHER on.
  constexpr int GATHER = dl::ARRIVAL_WORD + MAX_BLOCKS;
  auto part = [&](int c) {
    const comm::Range ch = comm::share(p.bytes, 16, c, w);
    const comm::Range r =
        comm::share(ch.hi - ch.lo, 16, blockIdx.x, gridDim.x);
    return comm::Range{ch.lo + r.lo, ch.lo + r.hi};
  };
  if (me == root) {
    const char* x = p.x + blockIdx.y * p.bytes;
    if (!bulk) {
      for (int c = 0; c < w; ++c) {
        const comm::Range r = part(c);
        dl::put_nbi(p.out[c] + r.lo, x + r.lo, r.hi - r.lo, 0, 1);
      }
    } else if (threadIdx.x == 0) {
      auto len = [&](unsigned c) {
        const comm::Range r = part(c);
        return (unsigned)(r.hi - r.lo);
      };
      unsigned most = 0;
      for (int c = 0; c < w; ++c) most = max(most, len(c));
      comm::bulk_runs(s, w, comm::pieces(most), 1, len,
                      [&](unsigned c) { return x + part(c).lo; },
                      [&](unsigned c, int) { return p.out[c] + part(c).lo; });
    }
    dl::fence<dl::Scope::gpu>();
    __syncthreads();
    comm::signal_blocks(w, p.bank,
                        [&](int c) { return p.sig[c] + dl::ARRIVAL_WORD; });
  }
  if (threadIdx.x == 0) {
    dl::signal_wait_until(p.sig[me] + dl::ARRIVAL_WORD + blockIdx.x, target,
                          tdt::WAIT_BROADCAST_ARRIVAL);
    asm volatile("fence.proxy.async.global;\\n" ::: "memory");
  }
  __syncthreads();
  const comm::Range r = part(me);
  comm::copy_fan(s, bulk, p.out[me] + r.lo, r.hi - r.lo, w - 1,
                 [&](int d) { return p.out[(me + 1 + d) % w] + r.lo; });
  dl::fence<dl::Scope::gpu>();
  __syncthreads();
  comm::signal_blocks(w - 1, p.bank, [&](int i) {
    return p.sig[(me + 1 + i) % w] + GATHER + me * MAX_BLOCKS; });
  comm::wait_blocks(w, me, [&](int c) {
    return p.sig[me] + GATHER + c * MAX_BLOCKS; }, target,
    tdt::WAIT_BROADCAST_ARRIVAL);
}

// ``moved``"""
#: The broadcast's words a rank in the ``gather`` variant: a gather bank
#: for each of up to 8 ranks past the arrival bank.
GATHER_WORDS = 2 + 9 * 256
_WAIT_BLOCKS = (r"(?s)  for \(int i = threadIdx\.x; i < n; i \+= blockDim\.x\)\n"
                r"    if \(i != skip\)\n"
                r"      dl::signal_wait_until\(bank\(i\) \+ blockIdx\.x, "
                r"target, what\);")
_WAIT_WHOLE = """  const int P = gridDim.x;
  for (int i = threadIdx.x; i < n * P; i += blockDim.x)
    if (i / P != skip)
      dl::signal_wait_until(bank(i / P) + i % P, target, what);"""

_BARRIER_COPY = (r"  const comm::Range r = comm::share\(p\.bytes, 16, "
                 r"blockIdx\.x, gridDim\.x\);\n"
                 r"  dl::put_nbi\(p\.out\[me\] \+ r\.lo, p\.x \+ "
                 r"blockIdx\.y \* p\.bytes \+ r\.lo,\n"
                 r"              r\.hi - r\.lo, 0, 1\);")
_BARRIER_BULK = """  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ uint64_t bar[comm::STAGE_BUFS];
  comm::Staging s = comm::staging(stage, bar);
  const comm::Range r = comm::share(p.bytes, 16, blockIdx.x, gridDim.x);
  comm::copy_fan(s, p.bulk != 0, p.x + blockIdx.y * p.bytes + r.lo,
                 r.hi - r.lo, 1, [&](int) { return p.out[me] + r.lo; });"""

_BARRIER_STRIDE = """  if (p.bulk) {
    const uint4* s =
        reinterpret_cast<const uint4*>(p.x + blockIdx.y * p.bytes);
    uint4* d = reinterpret_cast<uint4*>(p.out[me]);
    const size_t n = p.bytes / 16, step = (size_t)gridDim.x * blockDim.x;
    size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    for (; i + 3 * step < n; i += 4 * step) {
      const uint4 v0 = __ldcg(s + i), v1 = __ldcg(s + i + step);
      const uint4 v2 = __ldcg(s + i + 2 * step), v3 = __ldcg(s + i + 3 * step);
      d[i] = v0;
      d[i + step] = v1;
      d[i + 2 * step] = v2;
      d[i + 3 * step] = v3;
    }
    for (; i < n; i += step) d[i] = __ldcg(s + i);
  } else {
    const comm::Range r = comm::share(p.bytes, 16, blockIdx.x, gridDim.x);
    dl::put_nbi(p.out[me] + r.lo, p.x + blockIdx.y * p.bytes + r.lo,
                r.hi - r.lo, 0, 1);
  }"""


#: variant -> (file under csrc, regex, replacement) edits, each matching
#: once.
VARIANTS = {
    "base": [],
    "gather": [("common_ops.cu", _PUSH_TO_END, _GATHER),
               ("common_ops.cu",
                r"BROADCAST_WORDS = dl::ARRIVAL_WORD \+ MAX_BLOCKS;",
                "BROADCAST_WORDS = dl::ARRIVAL_WORD + 9 * MAX_BLOCKS;")],
    "waitfirst": [("common_ops.cu",
                   r"  dl::team_arrive\(t, p\.sig\);\n"
                   r"  const comm::Range r = comm::share",
                   "  dl::team_arrive(t, p.sig);\n"
                   "  dl::team_wait(t, p.sig, p.epoch + gridDim.x);\n"
                   "  const comm::Range r = comm::share")],
    "regs": [("scatter_sum.cuh", r"  if \(ALL && p\.vec\) \{",
              "  if (false) {")],
    "allbulk": [("common_ops.cu", _BARRIER_COPY, _BARRIER_BULK),
                ("common_ops.cu",
                 r"launch\(reinterpret_cast<void\*>\(barrier_kernel\), 0,",
                 "launch(reinterpret_cast<void*>(barrier_kernel), "
                 "comm::STAGE_SMEM,")],
    "stride": [("common_ops.cu", _BARRIER_COPY, _BARRIER_STRIDE)],
    "threads": [("common_ops.cu", r"  p\.bulk = align % 16 == 0;",
                 "  p.bulk = 0;"),
                ("scatter_sum.cuh", r"  if \(!vec\) \{\n    for \(int j = 1;",
                 "  if (true) {\n    for (int j = 1;")],
    "whole": [("comm_body.cuh", _WAIT_BLOCKS, _WAIT_WHOLE),
              ("common_ops.cu",
               r"  if \(threadIdx\.x == 0\)\n"
               r"    dl::signal_wait_until\(p\.sig\[me\] \+ dl::ARRIVAL_WORD "
               r"\+ blockIdx\.x, target,",
               "  for (int g = threadIdx.x; g < gridDim.x; g += blockDim.x)\n"
               "    dl::signal_wait_until(p.sig[me] + dl::ARRIVAL_WORD + g, "
               "target,")],
}


def edits(name: str):
    """Variant ``name``'s edits: VARIANTS, or ``smN`` (the barrier at most N
    blocks an SM) and ``capN`` (the barrier at most N blocks a rank, with
    as many an SM as fit)."""
    m = re.fullmatch(r"(sm|cap)(\d+)", name)
    if m is None:
        return VARIANTS[name]
    n = int(m.group(2))
    if m.group(1) == "sm":
        return [("common_ops.cu", r"BARRIER_BLOCKS_PER_SM = \d+;",
                 f"BARRIER_BLOCKS_PER_SM = {n};")]
    return [("common_ops.cu", r"bytes, bytes, 1 << 30,\n(\s*)"
             r"BARRIER_BLOCKS_PER_SM,", f"bytes, bytes, {n},\n\\1 0,")]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound_ms(op: str, world: int, shard_bytes: int) -> float:
    """The least time (`chip_smoke.collective_bound`): broadcast, the
    root's x in and W x out; the barrier, W x in and out; the all-reduce,
    W x in, the reduce-scatter half's (W - 1) / W x a rank received and W
    x out; at the HBM rate."""
    s, w = shard_bytes, world
    moved = {"broadcast": s + w * s, "barrier": 2 * w * s,
             "two_shot": (3 * w - 1) * s}[op]
    return moved / PEAK_BYTES_PER_S * 1e3


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


def host_us(fn, reps=100, windows=5) -> float:
    """Host us a call: the least over ``windows`` windows of ``reps`` calls
    enqueued back to back, the clock read before the sync (the least, since
    the host's other load only adds time)."""
    import torch

    for _ in range(10):
        fn()
    best = math.inf
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / reps * 1e6


def randn(gen, *shape):
    import torch

    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def ops(world):
    """op -> (kernel call, plain version, library call), each of x."""
    import torch

    from triton_distributed_tpu_torch.kernels import allreduce as ar
    from triton_distributed_tpu_torch.kernels import common_ops

    ctx = ar.AllReduceContext("tp", world, "two_shot")
    f32 = torch.float32
    root = ROOT % world
    return {
        "broadcast": (
            lambda x: common_ops.broadcast(x, root, "tp", world),
            lambda x: common_ops.broadcast_reference(x, root),
            lambda x: x[root].expand(world, -1, -1).contiguous()),
        "barrier": (
            lambda x: common_ops.barrier_all_on_axis(x),
            lambda x: x.clone(), lambda x: x.clone()),
        "two_shot": (
            lambda x: ar.all_reduce(x, ctx),
            lambda x: ar.all_reduce_reference(x, "two_shot"),
            lambda x: x.sum(0, dtype=f32).to(x.dtype).expand(
                world, -1, -1).contiguous()),
    }


def redesigned(timer, out: dict, library=True) -> None:
    """K18 and K17 ``two_shot`` at both worlds and payloads: ms, bound,
    library ms, host us at 4 rows, and a hash of each output."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(21)
    for w in WORLDS:
        for rows, cols in PAYLOADS:
            x = randn(gen, w, rows, cols)
            shard = x[0].numel() * 2
            for op, (fn, _, lib) in ops(w).items():
                label = f"{op} W={w} {rows}x{cols}"
                out[label] = timer(lambda: fn(x))
                out[f"{label} hash"] = digest(fn(x))
                out[f"{label} bound"] = bound_ms(op, w, shard)
                if library:
                    out[f"{label} library"] = timer(lambda: lib(x))
                if rows < ROWS:
                    out[f"{label} host us"] = host_us(lambda: fn(x))
            del x


def check() -> None:
    """K18 and K17 ``two_shot`` bit for bit against their plain versions
    at W = 2, 4, 8 on an aligned and a ragged shape, every root."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(23)
    for w in (2, 4, 8):
        for rows, cols in ((w * 64, 1024), (w * 37, 1001)):
            x = randn(gen, w, rows, cols)
            for op, (fn, plain, _) in ops(w).items():
                if not torch.equal(fn(x), plain(x)):
                    raise AssertionError(f"{op} W={w} {tuple(x.shape)} "
                                         "differs from its plain version")
            from triton_distributed_tpu_torch.kernels import common_ops
            for root in range(w):
                got = common_ops.broadcast(x, torch.tensor(root).cuda(), "tp",
                                           w)
                if not torch.equal(got, common_ops.broadcast_reference(
                        x, root)):
                    raise AssertionError(f"broadcast root {root} W={w}")


def neighbours(timer, out: dict) -> None:
    """K16 both methods, K21b, K17's other methods: ms and hashes."""
    import torch

    from triton_distributed_tpu_torch.kernels import torus
    from triton_distributed_tpu_torch.kernels.allreduce import (
        AllReduceContext, all_reduce)
    from triton_distributed_tpu_torch.kernels.reduce_scatter import (
        ReduceScatterContext, reduce_scatter)

    gen = torch.Generator(device="cuda").manual_seed(31)
    for w in WORLDS:
        x = randn(gen, w, ROWS, COLS)
        for method in ("scatter_reduce", "ring"):
            ctx = ReduceScatterContext("tp", w, method)
            out[f"K16 {method} W={w}"] = timer(lambda: reduce_scatter(x, ctx))
            out[f"K16 {method} W={w} hash"] = digest(reduce_scatter(x, ctx))
        del x
    for sizes in ((2, 2), (2, 2, 2)):
        w = math.prod(sizes)
        x = randn(gen, w, ROWS, COLS)
        ctx = torus.TorusContext(("x", "y", "z")[:len(sizes)], sizes)
        out[f"K21b {sizes}"] = timer(lambda: torus.reduce_scatter_torus(
            x, ctx))
        out[f"K21b {sizes} hash"] = digest(torus.reduce_scatter_torus(x, ctx))
        del x
    x = randn(gen, 4, ROWS, COLS)
    for method in ("one_shot", "chain", "ring"):
        ctx = AllReduceContext("tp", 4, method)
        out[f"K17 {method}"] = timer(lambda: all_reduce(x, ctx))
        out[f"K17 {method} hash"] = digest(all_reduce(x, ctx))


def ptxas(paths=None) -> dict:
    from triton_distributed_tpu_torch.kernels import _build

    rep = {}
    for name in ("common_ops", "all_reduce", "reduce_scatter"):
        path = (paths or {}).get(name) or _build._library_path(name)
        if not path.exists():
            continue
        log = path.with_suffix(".log").read_text()
        rep[name] = {"c7510": log.count("C7510"),
                     "kernels": [list(r) for r in
                                 _build.resource_usage(name, path)]}
    return rep


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels import _build

    _build.build(["common_ops", "all_reduce", "reduce_scatter", "torus",
                  "all_gather"])
    timer = Timer()
    out = {"root": str(root), "card": card(), "torch": torch.__version__}
    redesigned(timer, out)
    neighbours(timer, out)
    out["ptxas"] = ptxas()
    return out


def build_variant(name: str):
    """The LIBS libraries from a copy of this tree's sources with variant
    ``name``'s edits; returns ({library: path}, temporary directory)."""
    from triton_distributed_tpu_torch.kernels import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"coll_{name}_"))
    shutil.copytree(_build.CSRC, tmp / "csrc")
    for file, pattern, new in edits(name):
        src = tmp / "csrc" / file
        text, count = re.subn(pattern, lambda m, new=new: new.replace(
            "\\1", m.group(1) if m.groups() else ""), src.read_text())
        if count != 1:
            raise RuntimeError(f"variant {name}: {pattern!r} matched {count} "
                               "times")
        src.write_text(text)
    return _build.build(list(LIBS), csrc=tmp / "csrc",
                        build_dir=tmp / "build"), tmp


def variants(names) -> int:
    import torch

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import allreduce, common_ops

    if not torch.cuda.is_available():
        print("torch_collectives_ab: CUDA is not available", file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.language.core import (
        release_symmetric_buffers)

    timer, name_of = Timer(), card()
    words = common_ops.BROADCAST_WORDS
    sigs = {"common_ops": common_ops._SIGNATURES,
            "all_reduce": allreduce._SIGNATURES}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        built = dict(zip(dict.fromkeys(names), pool.map(
            build_variant, dict.fromkeys(names))))
    try:
        for name in names:
            paths, _ = built[name]
            for lib in LIBS:
                _build._loaded[lib] = _build.load_path(paths[lib], sigs[lib])
            # A variant's words differ from the others': fresh instances.
            release_symmetric_buffers()
            common_ops.BROADCAST_WORDS = (GATHER_WORDS if name == "gather"
                                          else words)
            res = {"variant": name, "card": name_of, "ptxas": ptxas(paths)}
            check()
            res["bits"] = "equal to the plain versions"
            redesigned(timer, res, library=False)
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
    group.add_argument("--variants", nargs="*", metavar="VARIANT")
    args = ap.parse_args()
    for name in args.variants or ():
        if name not in VARIANTS and not re.fullmatch(r"(sm|cap)\d+", name):
            ap.error(f"unknown variant {name!r}: one of {', '.join(VARIANTS)}"
                     ", smN or capN")
    if args.variants is not None:
        sys.path.insert(0, str(HERE))
        return variants(args.variants
                        or [*VARIANTS, "sm1", "sm4", "sm64", "base"])
    if args.root is not None:
        import torch

        if not torch.cuda.is_available():
            print("torch_collectives_ab: CUDA is not available",
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
            print(f"torch_collectives_ab: the run of {root} failed",
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
    for tag, r in (("other", runs[0]), ("this tree", runs[1])):
        for lib, rep in r["ptxas"].items():
            print(f"{lib} ({tag}): C7510 lines {rep['c7510']}; " + "; ".join(
                f"{k[0][-48:]} {k[1]} registers, spills {k[2]}/{k[3]} B"
                for k in rep["kernels"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
