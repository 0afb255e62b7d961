#!/usr/bin/env python3
"""K10 (`moe_reduce_rs_fused`) of the PyTorch/CUDA port on one NVIDIA GPU:
two source trees compared, or this tree's variants of the kernel.

    python3 scripts/torch_moe_reduce_rs_ab.py --ab OTHER_ROOT
    python3 scripts/torch_moe_reduce_rs_ab.py --root DIR
    python3 scripts/torch_moe_reduce_rs_ab.py --variants [VARIANT ...]

``--ab`` runs the measurement for OTHER_ROOT (a checkout of another commit,
for example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone.  A run
builds Qwen3-30B-A3B at world 4 in mode ``fused`` with seeded random bf16
weights (`chip_smoke.py`'s MoE TP model, the 4 ranks in one process on the
one card) and measures:
- its prefill of 4 x 512 tokens under `torch.profiler`: device ms, K10's
  and K11's ms, launches and shares of it; the CUDA event ms around it;
  and the peak memory of the prefill (`torch.cuda.max_memory_allocated`
  after a reset, the model's weights included);
- K10 on layer 0's prefill activations (K11's output of the routing that
  the random weights give, through the gated SiLU) and on a balanced
  routing (every bucket of every chunk half full, random activations),
  beside the library loop (`chip_smoke.py`'s: `torch.matmul` over every
  expert, the dense one-hot combine product, the rank sum) and the bound,
  with a hash of K10's output and its worst row error against the plain
  version; K10's launches of the Hopper body (``wgmma_launches``);
- the hash of K11's output on layer 0's buckets, and K6, K8, K12 and K14,
  which share the `wgmma` tile, at `scripts/torch_torus_ab.py`'s shapes,
  with a hash of each output (the shared headers must leave their bits
  alone);
- ptxas's report of K10's library (registers and spills a kernel, the
  lines saying the `wgmma`s were serialized: C7510 for a call, C7520 for a
  warpgroup arrive in a divergent path) and the local-memory operations of
  its Hopper kernel by `setmaxnreg` region of the SASS.

``--variants`` times this tree's K10 on the two routings by variant
(default: all, in the order below, then ``base`` again), each with its
ptxas report:
- ``base``: the kernel as it is;
- ``nostore``: the epilogue stores no row into the stage: what staging the
  counted rows costs;
- ``nocombine``: the blocks combine nothing (the barrier, signals, wait and
  sum stay): what the combine costs;
- ``pairs4``: the loads of four pairs of a piece go out together, not
  eight;
- ``live``: the consumers do not exit after the sum, so the accumulators
  stay live through the combine (it then has about 70 registers);
- ``first``: ``live`` with four pairs' loads together, the first form of
  the combine.
The cut variants give wrong results and are for timing only; the others
are held to the plain version row by row.  Each variant of the
source is built from a copy in a temporary directory (one ``nvcc``); the
repository is not touched.

Device ms: CUDA events over back-to-back calls queued behind a device spin,
after warm-up (`torch_gemm_rs_ab.Timer`).  Every line carries the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from torch_ag_group_gemm_ab import (
    BATCH, PROMPT, build_model, prefill_profile, spill_sites)
from torch_gemm_rs_ab import (
    PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, Timer, card, digest, ptxas)
from torch_torus_ab import neighbours

HERE = Path(__file__).resolve().parent.parent
REPS = 20
LIBS = ("moe_reduce_rs", "ag_group_gemm", "grouped_matmul", "ag_gemm",
        "gemm_rs", "flash_attention", "flash_decode")

#: variant -> (text, its replacement) edits of moe_reduce_rs.cu.
EXIT = ("      finish();\n      asm volatile(\"exit;\");\n"
        "      __builtin_unreachable();\n", "      finish();\n")
VARIANTS = {
    "base": [],
    "nostore": [("    if (b0 != NO_BOX)\n      store_box(b0,",
                 "    if (b0 == NO_BOX + 1)\n      store_box(b0,"),
                ("    if (b1 != NO_BOX)\n      store_box(b1,",
                 "    if (b1 == NO_BOX + 1)\n      store_box(b1,")],
    "nocombine": [("unsigned q = blockIdx.x * NT + threadIdx.x; q < units;",
                   "unsigned q = units + threadIdx.x; q < units;")],
    "pairs4": [("COMBINE_PAIRS = 8;", "COMBINE_PAIRS = 4;")],
    "live": [EXIT],
    "first": [EXIT, ("COMBINE_PAIRS = 8;", "COMBINE_PAIRS = 4;")],
}
CUT = ("nostore", "nocombine")


def bound_ms(counts, e_occ: int, k: int, n: int, mc: int, pairs: int):
    """K10's least time at world W (`chip_smoke.moe_tp_bound`): every
    rank's occupied rows of every chunk and its occupied experts' weights
    read, the W partials of a chunk put and the output written; or the
    products of the occupied rows and the combine's weighted rows."""
    w = counts.shape[0]
    rows = int(counts.sum())
    moved = 2 * (w * rows * k + w * e_occ * k * n + w * w * mc * n)
    ops = 2 * w * rows * k * n + 2 * w * pairs * n
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def routings(model, ids) -> dict:
    """label -> (act (W, W, E, cap, k), plan, down weights): layer 0's
    prefill activations, and a balanced routing of the same shape (token t
    to experts 8 t .. 8 t + 7: every bucket half full at cap 64); with the
    hash of K11's output on layer 0's buckets."""
    import torch

    from triton_distributed_tpu_torch.kernels import moe_utils
    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        AGGroupGEMMContext, ag_group_gemm)
    from triton_distributed_tpu_torch.layers.tp_mlp import gated_silu

    mlp = model.layers[0].mlp
    grab = []
    hook = mlp.register_forward_pre_hook(
        lambda mod, args: grab.append(args[0].clone()))
    cache = model.create_cache(BATCH, max_seq=2 * PROMPT)
    with torch.inference_mode():
        model.prefill(ids, cache)
        hook.remove()
        buckets, plan = mlp._route_bucket_plan(grab[0], mlp.router)
        w, e, cap, _ = buckets.shape
        inter = ag_group_gemm(buckets, mlp.gate_up,
                              AGGroupGEMMContext("tp", w, e),
                              counts=plan.counts)
        act = gated_silu(inter)
    mc, topk = grab[0].shape[1], mlp.topk
    toks = torch.arange(w * mc, device="cuda")[:, None]
    bal_ids = ((toks * topk + torch.arange(topk, device="cuda")) % e).to(
        torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bal_w = torch.softmax(torch.randn((w * mc, topk), generator=gen,
                                      device="cuda"), -1)
    bal_plan = moe_utils.plan_chunks(bal_ids, bal_w, w, e, cap)
    bal_act = torch.randn(act.shape, generator=gen, device="cuda",
                          dtype=act.dtype)
    return {"layer 0": (act, plan, mlp.down),
            "balanced": (bal_act, bal_plan, mlp.down)}, digest(inter)


def device_split(fn, key: str, reps: int) -> tuple[float, float, float]:
    """``reps`` calls of ``fn`` under `torch.profiler`: the device ms a
    call of the kernels whose name holds ``key``, of all its kernels (the
    wrapper's routing tables too), and the host ms a call to enqueue
    them."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = sum(e.self_device_time_total for e in kern if key in e.key)
    every = sum(e.self_device_time_total for e in kern)
    return mine / 1e3 / reps, every / 1e3 / reps, host


def k10_times(out: dict, cases: dict, timer, check: bool) -> None:
    """K10 on each routing: ms (CUDA events around queued wrapper calls),
    the kernel's own device ms, the call's device ms with the wrapper's
    table ops, the host ms a call, its Hopper-body launches, the library
    loop's ms, the bound, a hash; with ``check``, the worst row error
    against the plain version."""
    import torch

    from triton_distributed_tpu_torch.kernels import moe_utils
    from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
        MoEReduceRSContext, moe_reduce_rs_fused, moe_reduce_rs_fused_plain)

    for label, (act, plan, down) in cases.items():
        w, _, e, cap, k = act.shape
        n = down.shape[-1]
        topk = plan.slot_of_pair.shape[-1]
        mc = plan.slot_of_pair.shape[1]
        ctx = MoEReduceRSContext("tp", w, e, topk)
        wg0 = getattr(moe_reduce_rs_fused, "wgmma_launches", 0)
        out[f"K10 {label}"] = timer(
            lambda: moe_reduce_rs_fused(act, down, plan, ctx), REPS)
        out[f"K10 {label} wgmma launches"] = getattr(
            moe_reduce_rs_fused, "wgmma_launches", 0) - wg0
        (out[f"K10 {label} kernel"], out[f"K10 {label} call device"],
         out[f"K10 {label} host"]) = device_split(
            lambda: moe_reduce_rs_fused(act, down, plan, ctx),
            "moe_reduce_rs", REPS)
        got = moe_reduce_rs_fused(act, down, plan, ctx)
        out[f"K10 {label} hash"] = digest(got)
        cm = moe_utils.dense_combine_mats(plan, cap).to(act.dtype).permute(
            0, 2, 1, 3).reshape(w, -1, e * cap)

        def library_loop():
            dense = torch.matmul(act, down[:, None])
            part = torch.matmul(cm, dense.reshape(w, w, e * cap, n))
            return part.float().sum(0).to(act.dtype)

        out[f"K10 {label} library loop"] = timer(library_loop, 3)
        counts = plan.counts
        e_occ = int((counts.sum(0) > 0).sum())
        pairs = int((plan.slot_of_pair >= 0).sum())
        out[f"K10 {label} bound"] = bound_ms(counts, e_occ, k, n, mc,
                                             pairs)[0]
        out[f"K10 {label} occupied rows"] = int(counts.sum())
        if check:
            rows, pw = moe_utils.combine_pairs(plan, topk)
            ref = moe_reduce_rs_fused_plain(act, down, plan, rows,
                                            pw.to(act.dtype)).float()
            err = (got.float() - ref).abs()
            row = ref.pow(2).mean(-1, keepdim=True).sqrt()
            out[f"K10 {label} worst err ratio"] = float(
                (err / (ref.abs() + row).clamp_min(1e-30)).max())
            del ref, err, row
        del got, cm
        torch.cuda.empty_cache()


def prefill_peak(out: dict, model, ids) -> None:
    """The peak memory of a 4 x 512 prefill at world 4, the weights
    included."""
    import torch

    cache = model.create_cache(BATCH, max_seq=2 * PROMPT)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model.prefill(ids, cache)
        torch.cuda.synchronize()
    out["prefill peak GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["weights GiB"] = sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 2 ** 30
    del cache


def k10_ptxas(path: Path) -> dict:
    """ptxas's report of K10's library at ``path``: registers and spills a
    kernel, its serialization lines, and the Hopper kernel's local-memory
    operations by SASS region."""
    from triton_distributed_tpu_torch.kernels import _build

    log = path.with_suffix(".log").read_text()
    return {"c7510": log.count("C7510"), "c7520": log.count("C7520"),
            "serialized": [line.strip() for line in log.splitlines()
                           if "are serialized" in line],
            "kernels": [[k[k.find("moe_reduce_rs"):][:48], regs, st, ld]
                        for k, regs, st, ld, _ in
                        _build.resource_usage("moe_reduce_rs", path)],
            "local ops by region": spill_sites(path,
                                               "moe_reduce_rs_wgmma")}


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels import _build

    paths = _build.build(list(LIBS))  # one nvcc each, together
    timer = Timer()
    out = {"root": str(root), "card": card(), "torch": torch.__version__}
    model, ids = build_model()
    prefill_profile(out, model, ids)
    out["prefill K10 share"] = out["prefill K10 ms"] / out[
        "prefill device ms"]
    prefill_peak(out, model, ids)
    cases, out["K11 layer 0 hash"] = routings(model, ids)
    del model
    torch.cuda.empty_cache()
    k10_times(out, cases, timer, check=True)
    del cases
    torch.cuda.empty_cache()
    neighbours(out, timer)
    out["ptxas"] = {"moe_reduce_rs": k10_ptxas(paths["moe_reduce_rs"]),
                    "gemm_rs": ptxas("gemm_rs")}
    return out


def build_variant(name: str):
    """K10's library from a copy of this tree's sources with variant
    ``name``'s edits; returns (library path, temporary directory)."""
    from triton_distributed_tpu_torch.kernels import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"moe_reduce_rs_{name}_"))
    shutil.copytree(_build.CSRC, tmp / "csrc")
    src = tmp / "csrc" / "moe_reduce_rs.cu"
    text = src.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    src.write_text(text)
    path = _build.build(["moe_reduce_rs"], csrc=tmp / "csrc",
                        build_dir=tmp / "build")["moe_reduce_rs"]
    return path, tmp


def variants(names) -> int:
    import torch

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import moe_reduce_rs

    if not torch.cuda.is_available():
        print("torch_moe_reduce_rs_ab: CUDA is not available",
              file=sys.stderr)
        return 1
    _build.build(list(LIBS))
    timer, name_of = Timer(), card()
    model, ids = build_model()
    cases, _ = routings(model, ids)
    del model
    torch.cuda.empty_cache()
    built = {}  # variant -> (library, temporary directory)
    try:
        for name in names:
            if name not in built:
                built[name] = build_variant(name)
        for name in names:
            path, _ = built[name]
            _build._loaded["moe_reduce_rs"] = _build.load_path(
                path, moe_reduce_rs._SIGNATURES)
            res = {"variant": name, "card": name_of,
                   "ptxas": k10_ptxas(path)}
            k10_times(res, cases, timer, check=name not in CUT)
            print(json.dumps(res), flush=True)
            bad = [k for k, v in res.items()
                   if k.endswith("worst err ratio") and v > 2e-2]
            if bad:
                raise AssertionError(f"variant {name} disagrees with the "
                                     f"plain version: {bad}")
    finally:
        _build._loaded.pop("moe_reduce_rs", None)
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
            print("torch_moe_reduce_rs_ab: CUDA is not available",
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
            print(f"torch_moe_reduce_rs_ab: the run of {root} failed",
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
    for tag, r in (("other", runs[0]), ("this tree", runs[1])):
        rep = r["ptxas"].get("moe_reduce_rs", {})
        print(f"moe_reduce_rs ({tag}): C7510 {rep.get('c7510')}, C7520 "
              f"{rep.get('c7520')}; "
              + "; ".join(f"{k[0]} {k[1]} registers, spills {k[2]}/{k[3]} B"
                          for k in rep.get("kernels", []))
              + f"; local ops {rep.get('local ops by region')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
