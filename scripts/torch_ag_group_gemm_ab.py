#!/usr/bin/env python3
"""K11 (`ag_group_gemm`) of the PyTorch/CUDA port on one NVIDIA GPU: two
source trees compared, or this tree's variants of the kernel.

    python3 scripts/torch_ag_group_gemm_ab.py --ab OTHER_ROOT
    python3 scripts/torch_ag_group_gemm_ab.py --root DIR
    python3 scripts/torch_ag_group_gemm_ab.py --variants [VARIANT ...]

``--ab`` runs the measurement for OTHER_ROOT (a checkout of another commit,
for example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone.  A run
builds Qwen3-30B-A3B at world 4 in mode ``fused`` with seeded random bf16
weights (`chip_smoke.py`'s MoE TP model, the 4 ranks in one process on the
one card) and measures:
- its prefill of 4 x 512 tokens under `torch.profiler`: device ms (the sum
  of its kernels' times), K11's and K10's ms and launches, and the CUDA
  event ms around it;
- K11 on layer 0's prefill buckets (the routing that the random weights
  give) and on a balanced routing (every bucket of every chunk half full,
  the rows past the counts garbage), beside ``torch.matmul`` of the
  gathered buckets with every rank's weights (`chip_smoke.py`'s library
  yardstick: the same products without the gather or the counts) and the
  bound, with a hash of K11's output, and K8 (`grouped_matmul`, the same
  tile on m64n256k16) on the gathered buckets with each rank's weights,
  four launches: the dense products on one card without the gather;
- K6, K8, K12 and K14, which share the `wgmma` tile, at
  `scripts/torch_torus_ab.py`'s shapes, with a hash of each output (the
  tile must leave their bits alone);
- ptxas's report of K11's library (registers and spills a kernel, the
  lines saying a call serialized the `wgmma`s, C7510).

``--variants`` times this tree's K11 on the two routings by variant
(default: all, in the order below, then ``base`` again), each with its
ptxas spills and its SASS's top register and local-memory operations:
- ``base``: the kernel as it is;
- ``nowait``: the TMA thread does not wait for a chunk's arrival (what the
  dependency on the gather costs);
- ``nocopy``: the crews copy nothing (the signals and waits stay): what
  the ring's copies cost;
- ``whole``: the ring forwards whole chunks (one piece a chunk), so a unit
  waits for the ring's last hop;
- ``nostore``: the epilogue stores nothing: what writing the output costs;
- ``ringonly``: no unit runs, only the crews' ring and zeros: what the
  gather costs alone;
- ``tilestore``: the epilogue stores the fragment's 4-byte pairs
  (`wgmma_tile.cuh` `store_tile`) in place of 16 bytes a lane;
- ``stages3``: three stages of the tile's ring, not four, and the freed
  shared memory to the crew's staging buffers;
- ``pieces2``, ``pieces8``: ring pieces of 2 or 8 experts, not 4;
- ``skipdead``: the consumers skip the products of a unit's dead boxes,
  on a runtime condition (ptxas then serializes the `wgmma`s, C7520).
The cut variants give wrong results and are for timing only; ``base`` and
``whole`` are held to the plain version row by row.  Each variant of the
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

from torch_gemm_rs_ab import (
    PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, Timer, card, digest, ptxas)
from torch_torus_ab import neighbours, sass_usage

HERE = Path(__file__).resolve().parent.parent
WORLD, BATCH, PROMPT, REPS = 4, 4, 512, 20
LIBS = ("ag_group_gemm", "moe_reduce_rs", "grouped_matmul", "ag_gemm",
        "gemm_rs", "flash_attention", "flash_decode")
#: `chip_smoke.py` MOE_FIELDS: Qwen3-30B-A3B.
MOE_FIELDS = dict(
    vocab_size=151936, hidden_size=2048, intermediate_size=6144,
    num_layers=48, num_heads=32, num_kv_heads=4, head_dim=128,
    rms_norm_eps=1e-6, rope_theta=1e6, qk_norm=True,
    tie_word_embeddings=False, max_seq_len=40960, num_experts=128,
    num_experts_per_tok=8, moe_intermediate_size=768)

#: variant -> (text, its replacement[, the source file, by default
#: ag_group_gemm.cu]) edits, and overrides of `allgather_group_gemm`'s
#: constants.
VARIANTS = {
    "base": ([], {}),
    "nowait": ([("    for (unsigned w = m & ~held; w != 0; w &= w - 1)",
                 "    for (unsigned w = 0; w != 0; w &= w - 1)")], {}),
    "nocopy": ([("          if (lead)\n            st.copy(",
                 "          if (false)\n            st.copy(")], {}),
    "whole": ([], {"RING_PIECE_EXPERTS": 1 << 20}),
    "nostore": ([("    if (b0 != NO_BOX)\n", "    if (b0 == NO_BOX + 1)\n"),
                 ("    if (b1 != NO_BOX)\n", "    if (b1 == NO_BOX + 1)\n")],
                {}),
    "ringonly": ([("  UnitTile::run(smem, &p.tb, __ldg(p.ntiles), sched);",
                   "  UnitTile::run(smem, &p.tb, 0, sched);")], {}),
    "tilestore": ([("      store_box(", "      wg::store_tile("),
                   (", w.col,\n", ", w.col, 0,\n")], {}),
    "stages3": ([("using UnitTile = wg::Tile<2, 4, 128, 2>;",
                  "using UnitTile = wg::Tile<2, 3, 128, 2>;")], {}),
    "skipdead": ([(old, new, "wgmma_tile.cuh") for old, new in (
        ("int kk, int accumulate) {", "int kk, int accumulate, int boxes) {"),
        ("      mma_m64n128k16<0>(\n",
         "      if (wg < boxes) mma_m64n128k16<0>(\n"),
        ("      mma_m64n128k16<TN / 2>(\n",
         "      if (C + wg < boxes) mma_m64n128k16<TN / 2>(\n"),
        ("mma_step(acc, st, wg, kk, kt | kk);",
         "mma_step(acc, st, wg, kk, kt | kk, w.boxes);"))], {}),
    "pieces2": ([], {"RING_PIECE_EXPERTS": 2}),
    "pieces8": ([], {"RING_PIECE_EXPERTS": 8}),
}
CUT = ("nowait", "nocopy", "nostore", "ringonly")


def bound_ms(counts, e_occ: int, cap: int, k: int, n: int):
    """K11's least time at world 4 (`chip_smoke.moe_tp_bound`): each rank's
    occupied bucket rows read once and received by the others, the
    occupied experts' weight shards, the dense output written; or the
    products of the occupied rows."""
    w, e = counts.shape
    rows = int(counts.sum())
    moved = 2 * (w * rows * k + w * e_occ * k * n + w * w * e * cap * n)
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * w * rows * k * n / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def build_model():
    import torch

    from triton_distributed_tpu_torch import ModelConfig, Qwen3
    from triton_distributed_tpu_torch.parallel import make_mesh

    cfg = ModelConfig(**MOE_FIELDS)
    model = Qwen3(cfg, "fused", mesh=make_mesh(WORLD)).init_params(
        torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                        generator=gen)
    return model, ids


def routings(model, ids) -> dict:
    """label -> (buckets (W, E, cap, h), counts (W, E), weights): layer 0's
    prefill buckets, and a balanced routing of the same shape."""
    import torch

    mlp = model.layers[0].mlp
    grab = []
    hook = mlp.register_forward_pre_hook(
        lambda mod, args: grab.append(args[0].clone()))
    cache = model.create_cache(BATCH, max_seq=2 * PROMPT)
    with torch.inference_mode():
        model.prefill(ids, cache)
        hook.remove()
        buckets, plan = mlp._route_bucket_plan(grab[0], mlp.router)
    w, e, cap, h = buckets.shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    balanced = torch.randn((w, e, cap, h), generator=gen, device="cuda",
                           dtype=buckets.dtype)
    half = torch.full((w, e), cap // 2, dtype=torch.int32, device="cuda")
    return {"layer 0": (buckets, plan.counts, mlp.gate_up),
            "balanced": (balanced, half, mlp.gate_up)}


def k11_times(out: dict, cases: dict, timer, check: bool) -> None:
    """K11 on each routing: ms, the library's ms, the bound, a hash; with
    ``check``, the worst row error against the plain version."""
    import torch

    from triton_distributed_tpu_torch.kernels import allgather_group_gemm
    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        AGGroupGEMMContext, ag_group_gemm, ag_group_gemm_plain)
    from triton_distributed_tpu_torch.kernels.grouped_gemm import (
        grouped_matmul, row_tile, zero_past_counts)

    # A tree without the Hopper body zeroes by the first body's row tile.
    body = getattr(allgather_group_gemm, "kernel_body", None)

    for label, (buckets, counts, wts) in cases.items():
        w, e, cap, h = buckets.shape
        n = wts.shape[-1]
        ctx = AGGroupGEMMContext("tp", w, e)
        wg0 = getattr(ag_group_gemm, "wgmma_launches", 0)
        out[f"K11 {label}"] = timer(
            lambda: ag_group_gemm(buckets, wts, ctx, counts=counts), REPS)
        out[f"K11 {label} wgmma launches"] = getattr(
            ag_group_gemm, "wgmma_launches", 0) - wg0
        got = ag_group_gemm(buckets, wts, ctx, counts=counts)
        out[f"K11 {label} hash"] = digest(got)
        gathered = buckets.transpose(0, 1).reshape(1, e, w * cap, h)
        out[f"K11 {label} library"] = timer(
            lambda: torch.matmul(gathered, wts), REPS)
        dense = gathered[0]
        out[f"K11 {label} K8 dense"] = timer(
            lambda: [grouped_matmul(dense, wts[r]) for r in range(w)], REPS)
        e_occ = int((counts.sum(0) > 0).sum())
        out[f"K11 {label} bound"] = bound_ms(counts, e_occ, cap, h, n)[0]
        out[f"K11 {label} occupied rows"] = int(counts.sum())
        if check:
            ref = zero_past_counts(
                ag_group_gemm_plain(buckets.float(), wts.float()), counts,
                row_tile(cap, buckets.dtype, body(buckets, wts)) if body
                else row_tile(cap, buckets.dtype))
            err = (got.float() - ref).abs()
            row = ref.pow(2).mean(-1, keepdim=True).sqrt()
            out[f"K11 {label} worst err ratio"] = float(
                (err / (ref.abs() + row).clamp_min(1e-30)).max())
            del ref, err, row
        del got
        torch.cuda.empty_cache()


def prefill_profile(out: dict, model, ids) -> None:
    """The world-4 prefill, traced once after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cache = model.create_cache(BATCH, max_seq=2 * PROMPT)
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
    out["prefill device ms"] = total
    for tag, key in (("K11", "ag_group_gemm_"), ("K10", "moe_reduce_rs")):
        mine = [e for e in kern if key in e.key]
        out[f"prefill {tag} ms"] = sum(
            e.self_device_time_total for e in mine) / 1e3
        out[f"prefill {tag} launches"] = sum(e.count for e in mine)
    out["prefill K11 share"] = out["prefill K11 ms"] / total
    out["prefill event ms"] = start.elapsed_time(end)
    del cache


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels import _build

    _build.build(list(LIBS))  # one nvcc each, together
    timer = Timer()
    out = {"root": str(root), "card": card(), "torch": torch.__version__}
    model, ids = build_model()
    prefill_profile(out, model, ids)
    k11_times(out, routings(model, ids), timer, check=True)
    del model
    torch.cuda.empty_cache()
    neighbours(out, timer)
    out["ptxas"] = {"ag_group_gemm": ptxas("ag_group_gemm")}
    return out


def build_variant(name: str):
    """K11's library from a copy of this tree's sources with variant
    ``name``'s edits; returns (library path, temporary directory)."""
    from triton_distributed_tpu_torch.kernels import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"ag_group_gemm_{name}_"))
    shutil.copytree(_build.CSRC, tmp / "csrc")
    for edit in VARIANTS[name][0]:
        old, new, file = (*edit, "ag_group_gemm.cu")[:3]
        src = tmp / "csrc" / file
        text = src.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {file}")
        src.write_text(text.replace(old, new))
    path = _build.build(["ag_group_gemm"], csrc=tmp / "csrc",
                        build_dir=tmp / "build")["ag_group_gemm"]
    return path, tmp


def spill_sites(path: Path, kernel: str = "ag_group_gemm_wgmma") -> dict:
    """The kernel named with ``kernel`` (K11's Hopper kernel by default) in
    the library at ``path``: its local-memory loads and stores (STL, LDL)
    counted by the `setmaxnreg` that last precedes them in the SASS (the
    producer warpgroup's 40, the consumers' 232, or none: the code before
    either)."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True).stdout
    out = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        if kernel not in body.split("\n", 1)[0]:
            continue
        region = "entry"
        for line in body.splitlines():
            m = re.search(r"SETMAXREG\S*\s+(?:\S+\s*,\s*)*?(0x[0-9a-f]+|\d+)",
                          line)
            if m:
                region = f"after setmaxnreg {int(m.group(1), 0)}"
                out.setdefault("setmaxnreg lines", []).append(
                    line.strip()[-60:])
            elif re.search(r"\b(?:STL|LDL)\b", line):
                out[region] = out.get(region, 0) + 1
    return out


def variants(names) -> int:
    import torch

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import allgather_group_gemm

    if not torch.cuda.is_available():
        print("torch_ag_group_gemm_ab: CUDA is not available",
              file=sys.stderr)
        return 1
    _build.build(list(LIBS))
    timer, name_of = Timer(), card()
    model, ids = build_model()
    cases = routings(model, ids)
    del model
    torch.cuda.empty_cache()
    built = {}  # variant -> (library, temporary directory)
    defaults = {k: getattr(allgather_group_gemm, k)
                for _, over in VARIANTS.values() for k in over}
    try:
        for name in names:
            if name not in built:
                built[name] = build_variant(name)
        for name in names:
            path, _ = built[name]
            _build._loaded["ag_group_gemm"] = _build.load_path(
                path, allgather_group_gemm._SIGNATURES)
            for key, value in {**defaults, **VARIANTS[name][1]}.items():
                setattr(allgather_group_gemm, key, value)
            res = {"variant": name, "card": name_of,
                   "c7510": path.with_suffix(".log").read_text().count(
                       "C7510"),
                   "spills": [[k[k.find("ag_group_gemm_"):][:60], regs, st,
                               ld]
                              for k, regs, st, ld, _ in
                              _build.resource_usage("ag_group_gemm", path)
                              if "wgmma" in k],
                   "serialized": [line.strip() for line in path.with_suffix(
                       ".log").read_text().splitlines()
                       if "are serialized" in line],
                   "sass": sass_usage(path, "ag_group_gemm_"),
                   "local ops by region": spill_sites(path)}
            k11_times(res, cases, timer, check=name not in CUT)
            print(json.dumps(res), flush=True)
            bad = [k for k, v in res.items()
                   if k.endswith("worst err ratio") and v > 2e-2]
            if bad:
                raise AssertionError(f"variant {name} disagrees with the "
                                     f"plain version: {bad}")
    finally:
        for key, value in defaults.items():
            setattr(allgather_group_gemm, key, value)
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
            print("torch_ag_group_gemm_ab: CUDA is not available",
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
            print(f"torch_ag_group_gemm_ab: the run of {root} failed",
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
        rep = r["ptxas"].get("ag_group_gemm", {})
        print(f"ag_group_gemm ({tag}): C7510 lines {rep.get('c7510')}; "
              + "; ".join(f"{k[0][-48:]} {k[1]} registers, spills "
                          f"{k[2]}/{k[3]} B" for k in rep.get("kernels", [])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
