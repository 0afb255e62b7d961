#!/usr/bin/env python3
"""K7 (`matmul_w8a8`) and K11-int8 (`ag_group_gemm_w8a8`) of the PyTorch/CUDA
port on one NVIDIA GPU: two source trees compared, or this tree's variants
of the kernels.

    python3 scripts/torch_w8a8_ab.py --ab OTHER_ROOT
    python3 scripts/torch_w8a8_ab.py --root DIR
    python3 scripts/torch_w8a8_ab.py --variants [VARIANT ...]
    python3 scripts/torch_w8a8_ab.py --plans

``--ab`` runs the measurement for OTHER_ROOT (a checkout of another commit,
for example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone.  A run
measures:
- K7 at its main paths' shapes (`K7_SHAPES`: the W8A8 `TPMLP(4096, 12288)`
  gate_up and down at 2048 and 8 rows, world 4's down a rank), each with
  the kernel's own device ms from `torch.profiler`, the call's ms (CUDA
  events around queued calls), `torch._int_mm` plus the same epilogue (8
  rows padded to 32 beforehand), the bound and a hash of the output; the
  weights as each tree's layers keep them (K-major where the tree has the
  int8 Hopper tile, else (k, n));
- the W8A8 `TPMLP` at world 1 on 2048 and 8 rows (event ms a call);
- Qwen3-30B-A3B at world 4 in mode ``fused`` with seeded random bf16 weights
  (`chip_smoke.py`'s MoE TP model, the 4 ranks in one process on the one
  card; `torch_ag_group_gemm_ab.py`'s), then K11-int8 on layer 0's prefill
  buckets and on a balanced routing (every bucket half full), on layer 0's
  gate_up quantized per expert and column: kernel and call ms, the bound, a
  hash and whether the output equals the plain version bit for bit;
  `MoEMLP(mode="w8a8")` on layer 0's weights and prefill input (device ms a
  call, the kernels' sum under the profiler, and K11-int8's part);
- K6, K8, K12 and K14 (`torch_torus_ab.neighbours`), which share the tile's
  header, with a hash of each output;
- ptxas's report of both libraries (registers and spills a kernel, the
  lines saying the `wgmma`s were serialized: C7510 for a call, C7520 for a
  warpgroup arrive in a divergent path) and the local-memory operations of
  the Hopper kernels by `setmaxnreg` region of the SASS.

``--variants`` times this tree's K7 at its shapes by variant (default: all,
in the order below, then ``base`` again), each with its ptxas report:
- ``base``: the kernel as it is;
- ``wide``: decode batches on a 64 x 256 tile of 5 stages, not 64 x 128 of
  8 (the planner's split unchanged);
- ``frag``: the epilogue stores fragment pairs, not 16-byte row pieces
  through the slabs;
- ``stages3``: three stages of the 128 x 256 tile's ring, not four;
- ``l2none``, ``l2_128``: the tensor maps' L2 promotion none or 128 bytes,
  not 256;
- ``loadonly``: the consumers issue no product (cut: what the loads cost);
- ``nostore``: the epilogue stores nothing (cut: what it costs).
The variants not cut are held to the plain version bit for bit.  Each is
built from a copy of the sources in a temporary directory (one ``nvcc``);
the repository is not touched.

``--plans`` times K7 at its shapes on the tile of its row count at every k
split up to `PLAN_SPLITS` ranges of at least `quantized.MIN_SPLIT_STAGES`
stages (each launched through `quantized._launch`, each held to the plain
version bit for bit), beside the plan `quantized.plan_w8a8` picks.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from torch_ag_group_gemm_ab import build_model, routings, spill_sites
from torch_gemm_rs_ab import PEAK_BYTES_PER_S, Timer, card, digest
from torch_moe_reduce_rs_ab import device_split
from torch_torus_ab import neighbours

HERE = Path(__file__).resolve().parent.parent
REPS = 20
PEAK_INT8_OPS = 1979e12
LIBS = ("matmul_w8a8", "ag_group_gemm", "grouped_matmul", "ag_gemm",
        "gemm_rs", "moe_reduce_rs", "flash_attention", "flash_decode")

#: label -> (m, k, n, out dtype name), as `chip_smoke.py`'s K7_TIMED.
K7_SHAPES = {
    "gate_up 2048": (2048, 4096, 24576, "bfloat16"),
    "down 2048": (2048, 12288, 4096, "float32"),
    "gate_up 8": (8, 4096, 24576, "bfloat16"),
    "down 8": (8, 12288, 4096, "float32"),
    "world-4 down 2048": (2048, 3072, 4096, "float32"),
}

#: variant -> source edits (text, its replacement, and the file when not
#: matmul_w8a8.cu).
L2_PROMOTION = "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"
MMA = "            mma_step(acc, st, wg, kk, kt | kk);"
VARIANTS = {
    "base": [],
    "frag": [("  p.slabs = N % (out_dtype == tdt::DTYPE_BF16 ? 8 : 4) == 0;",
              "  p.slabs = 0;")],
    "wide": [("using Tile64 = wg::Tile<1, 8, 128, 1, Int8Ops>;",
              "using Tile64 = wg::Tile<1, 5, 256, 1, Int8Ops>;")],
    "stages3": [("using Tile128 = wg::Tile<2, 4, 256, 1, Int8Ops>;",
                 "using Tile128 = wg::Tile<2, 3, 256, 1, Int8Ops>;")],
    "l2none": [(L2_PROMOTION, "CU_TENSOR_MAP_L2_PROMOTION_NONE",
                "wgmma_tile.cuh")],
    "l2_128": [(L2_PROMOTION, "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                "wgmma_tile.cuh")],
    "loadonly": [(MMA, MMA.replace("mma_step", "if (kk < 0) mma_step"),
                  "wgmma_tile.cuh")],
    "nostore": [("    if (p->split > 1) {\n      store_partial(",
                 "    if (p->M > 0) return;\n    if (p->split > 1) {\n"
                 "      store_partial(")],
}
CUT = ("loadonly", "nostore")
#: `--plans`: the most k ranges tried.
PLAN_SPLITS = 16


def bound_ms(m: int, k: int, n: int, out_bytes: int) -> tuple[float, str]:
    """K7's least time (`chip_smoke.py`'s): a, b, the scales and the output
    once at the HBM rate, or the products at the int8 peak."""
    t_bytes = (m * k + k * n + 4 * (m + n) + m * n * out_bytes
               ) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k11_bound_ms(counts, e_occ: int, cap: int, k: int, n: int) -> float:
    """K11-int8's least time at world W (`chip_smoke.moe_tp_bound`): the
    occupied int8 bucket rows read once and received by the others, the
    occupied experts' int8 weight shards, the dense bf16 output; or the
    products of the occupied rows at the int8 peak."""
    w, e = counts.shape
    rows = int(counts.sum())
    moved = w * rows * k + w * e_occ * k * n + 2 * w * w * e * cap * n
    return max(moved / PEAK_BYTES_PER_S,
               2 * w * rows * k * n / PEAK_INT8_OPS) * 1e3


def k7_operands(on_tile: bool) -> dict:
    """label -> (a_q, b_q, sa, sb, out dtype), seeded; b_q K-major (the
    transpose of a contiguous (n, k)) for a tree with the int8 tile, else
    (k, n) contiguous, as each tree's layers keep it."""
    import torch

    from triton_distributed_tpu_torch.kernels.quantized import quantize_sym

    gen = torch.Generator(device="cuda").manual_seed(23)
    ops = {}
    for label, (m, k, n, dt) in K7_SHAPES.items():
        b_q, sb = quantize_sym(torch.randn((k, n), generator=gen,
                                           device="cuda") * k ** -0.5, 0)
        if on_tile:
            b_q = b_q.t().contiguous().t()
        a_q, sa = quantize_sym(torch.randn((m, k), generator=gen,
                                           device="cuda"), 1)
        ops[label] = (a_q, b_q, sa, sb, getattr(torch, dt))
    return ops


def k7_times(out: dict, ops: dict, timer) -> None:
    """K7 at each shape: kernel ms (profiler), call ms (events), the
    library's ms, the bound, a hash, whether it equals the plain version,
    and the plan it ran."""
    import torch

    from triton_distributed_tpu_torch.kernels import quantized
    from triton_distributed_tpu_torch.kernels.quantized import (
        matmul_w8a8, matmul_w8a8_reference)

    for label, (a_q, b_q, sa, sb, dt) in ops.items():
        m, k = a_q.shape
        n = b_q.shape[1]

        def k7():
            return matmul_w8a8(a_q, b_q, sa, sb, out_dtype=dt)

        t0 = [getattr(matmul_w8a8, a, 0) for a in ("launches",
                                                    "wgmma_launches",
                                                    "transposes")]
        out[f"K7 {label}"] = device_split(k7, "w8a8", REPS)[0]
        out[f"K7 {label} call"] = timer(k7, REPS)
        got = k7()
        out[f"K7 {label} hash"] = digest(got)
        out[f"K7 {label} exact"] = bool(torch.equal(
            got, matmul_w8a8_reference(a_q, b_q, sa, sb, out_dtype=dt)))
        t1 = [getattr(matmul_w8a8, a, 0) for a in ("launches",
                                                    "wgmma_launches",
                                                    "transposes")]
        out[f"K7 {label} launches/wgmma/transposes"] = [
            b - a for a, b in zip(t0, t1)]
        if hasattr(quantized, "plan_w8a8"):
            p = quantized.plan_w8a8(m, n, k)
            out[f"K7 {label} plan"] = [p.rows, p.tn, p.split]
        mp = max(m, 32)
        a_p = torch.zeros((mp, k), dtype=torch.int8, device="cuda")
        a_p[:m] = a_q
        sa_p = torch.ones(mp, device="cuda")
        sa_p[:m] = sa
        bk = b_q.t().contiguous().t()  # the library on the K-major weights
        out[f"K7 {label} library"] = timer(
            lambda: (torch._int_mm(a_p, bk).float() * sa_p[:, None]
                     * sb[None, :]).to(dt), REPS)
        out[f"K7 {label} bound"] = bound_ms(m, k, n, got.element_size())[0]
        del got


def layer_times(out: dict) -> None:
    """The W8A8 `TPMLP(4096, 12288)` at world 1 on 2048 and 8 rows."""
    import torch

    from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP

    mlp = TPMLP(4096, 12288, mode="w8a8", device="cuda")
    mlp.init_params(torch.Generator(device="cuda").manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(4)
    timer = Timer()
    with torch.inference_mode():
        for m in (2048, 8):
            x = torch.randn((m, 4096), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            out[f"TPMLP w8a8 {m} rows"] = timer(lambda: mlp(x), 10)
            out[f"TPMLP w8a8 {m} rows hash"] = digest(mlp(x))
    del mlp


def k11_int8_times(out: dict, model, ids, timer) -> None:
    """K11-int8 on layer 0's buckets and a balanced routing, on layer 0's
    gate_up quantized per expert and column (K-major on a tree with the
    int8 tile); then `MoEMLP(mode="w8a8")` on layer 0's weights at its
    prefill input."""
    import torch

    from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
        AGGroupGEMMContext, ag_group_gemm_w8a8, ag_group_gemm_w8a8_plain)
    from triton_distributed_tpu_torch.kernels.quantized import quantize_sym
    from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP

    on_tile = hasattr(ag_group_gemm_w8a8, "wgmma_launches")
    cases = routings(model, ids)
    mlp = model.layers[0].mlp
    wq, ws = quantize_sym(mlp.gate_up.float(), 2)
    if on_tile:
        wq = wq.transpose(-1, -2).contiguous().transpose(-1, -2)
    for label, (buckets, counts, _) in cases.items():
        w, e, cap, h = buckets.shape
        n = wq.shape[-1]
        ctx = AGGroupGEMMContext("tp", w, e)

        def k11q():
            return ag_group_gemm_w8a8(buckets, wq, ws, ctx, counts=counts)

        out[f"K11-int8 {label}"] = device_split(k11q, "ag_group_gemm",
                                                REPS)[0]
        out[f"K11-int8 {label} call"] = timer(k11q, REPS)
        got = k11q()
        out[f"K11-int8 {label} hash"] = digest(got)
        bq, sa = quantize_sym(buckets, -1)
        out[f"K11-int8 {label} exact"] = bool(torch.equal(
            got, ag_group_gemm_w8a8_plain(bq, sa, wq, ws, got.dtype,
                                          counts)))
        e_occ = int((counts.sum(0) > 0).sum())
        out[f"K11-int8 {label} bound"] = k11_bound_ms(counts, e_occ, cap, h,
                                                      n)
        del got
        torch.cuda.empty_cache()
    # MoEMLP(w8a8) at world 4 on layer 0's weights and prefill input.
    grab = []
    hook = mlp.register_forward_pre_hook(
        lambda mod, args: grab.append(args[0].clone()))
    cache = model.create_cache(4, max_seq=1024)
    with torch.inference_mode():
        model.prefill(ids, cache)
        hook.remove()
        layer = MoEMLP(mlp.hidden, mlp.ffn, mlp.num_experts, topk=mlp.topk,
                       mode="w8a8", world_size=mlp.world_size,
                       device="cuda").load_jax_params(
                           MoEMLP.quantize_params(mlp.jax_params()))
        x = grab[0]
        dev_ms, every, host = device_split(lambda: layer(x), "ag_group_gemm",
                                           10)
        out["MoEMLP w8a8 layer 0 device"] = every
        out["MoEMLP w8a8 layer 0 K11-int8"] = dev_ms
        out["MoEMLP w8a8 layer 0 host"] = host
        out["MoEMLP w8a8 layer 0 hash"] = digest(layer(x))
    del cache, layer, grab


def lib_ptxas(lib: str, path: Path, kernel: str) -> dict:
    from triton_distributed_tpu_torch.kernels import _build

    log = path.with_suffix(".log").read_text()
    return {"c7510": log.count("C7510"), "c7520": log.count("C7520"),
            "kernels": [[k[:72], regs, st, ld] for k, regs, st, ld, _ in
                        _build.resource_usage(lib, path) if kernel in k],
            "local ops by region": spill_sites(path, kernel)}


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels.quantized import matmul_w8a8

    paths = _build.build(list(LIBS))  # one nvcc each, together
    timer = Timer()
    out = {"root": str(root), "card": card(), "torch": torch.__version__}
    on_tile = hasattr(matmul_w8a8, "wgmma_launches")
    k7_times(out, k7_operands(on_tile), timer)
    layer_times(out)
    torch.cuda.empty_cache()
    neighbours(out, timer)
    model, ids = build_model()
    k11_int8_times(out, model, ids, timer)
    del model
    torch.cuda.empty_cache()
    out["ptxas"] = {
        "matmul_w8a8": lib_ptxas("matmul_w8a8", paths["matmul_w8a8"],
                                 "w8a8"),
        "ag_group_gemm": lib_ptxas("ag_group_gemm", paths["ag_group_gemm"],
                                   "ag_group_gemm_wgmma")}
    return out


def build_variant(name: str):
    """K7's library from a copy of this tree's sources with variant
    ``name``'s edits; returns (library path, temporary directory)."""
    from triton_distributed_tpu_torch.kernels import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"matmul_w8a8_{name}_"))
    shutil.copytree(_build.CSRC, tmp / "csrc")
    for edit in VARIANTS[name]:
        old, new, file = (*edit, "matmul_w8a8.cu")[:3]
        src = tmp / "csrc" / file
        text = src.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {file}")
        src.write_text(text.replace(old, new))
    path = _build.build(["matmul_w8a8"], csrc=tmp / "csrc",
                        build_dir=tmp / "build")["matmul_w8a8"]
    return path, tmp


def variants(names) -> int:
    import torch

    from triton_distributed_tpu_torch.kernels import _build, quantized

    if not torch.cuda.is_available():
        print("torch_w8a8_ab: CUDA is not available", file=sys.stderr)
        return 1
    base = _build.build(["matmul_w8a8"])["matmul_w8a8"]
    timer, name_of = Timer(), card()
    ops = k7_operands(True)
    built = {}  # variant -> (library, temporary directory or None)
    try:
        for name in names:
            if name not in built:
                built[name] = (build_variant(name) if VARIANTS[name]
                               else (base, None))
        for name in names:
            path, _ = built[name]
            _build._loaded["matmul_w8a8"] = _build.load_path(
                path, quantized._SIGNATURES)
            res = {"variant": name, "card": name_of,
                   "ptxas": lib_ptxas("matmul_w8a8", path, "w8a8")}
            k7_times(res, ops, timer)
            print(json.dumps(res), flush=True)
            bad = [k for k, v in res.items()
                   if k.endswith(" exact") and not v and name not in CUT]
            if bad:
                raise AssertionError(f"variant {name} differs from the plain "
                                     f"version: {bad}")
    finally:
        _build._loaded.pop("matmul_w8a8", None)
        for _, tmp in built.values():
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
    return 0


def plans() -> int:
    import torch

    from triton_distributed_tpu_torch.kernels import _build, quantized

    if not torch.cuda.is_available():
        print("torch_w8a8_ab: CUDA is not available", file=sys.stderr)
        return 1
    _build.build(["matmul_w8a8"])
    name_of = card()
    for label, (a_q, b_q, sa, sb, dt) in k7_operands(True).items():
        m, k = a_q.shape
        n = b_q.shape[1]
        stages = -(-k // quantized.K_STAGE)
        chosen = quantized.plan_w8a8(m, n, k)
        want = quantized.matmul_w8a8_reference(a_q, b_q, sa, sb, dt)
        res = {"shape": label, "card": name_of,
               "chosen": [chosen.rows, chosen.tn, chosen.split]}
        for split in range(1, PLAN_SPLITS + 1):
            per = -(-stages // split)
            if (split - 1) * per >= stages or (
                    split > 1 and per < quantized.MIN_SPLIT_STAGES):
                continue
            plan = dataclasses.replace(chosen, split=split, per=per)
            out = torch.empty((m, n), dtype=dt, device="cuda")

            def k7():
                quantized._launch(a_q, b_q.t(), sa, sb, out, plan)

            ms = device_split(k7, "w8a8", REPS)[0]
            k7()
            if not torch.equal(out, want):
                raise AssertionError(f"{label} {plan}: differs")
            res[f"{plan.rows}x{plan.tn} split {split}"] = ms
        print(json.dumps(res), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", type=Path)
    group.add_argument("--ab", type=Path, metavar="OTHER_ROOT")
    group.add_argument("--variants", nargs="*", choices=list(VARIANTS),
                       metavar="VARIANT")
    group.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    if args.plans:
        sys.path.insert(0, str(HERE))
        return plans()
    if args.variants is not None:
        sys.path.insert(0, str(HERE))
        return variants(args.variants or [*VARIANTS, "base"])
    if args.root is not None:
        import torch

        if not torch.cuda.is_available():
            print("torch_w8a8_ab: CUDA is not available", file=sys.stderr)
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
            print(f"torch_w8a8_ab: the run of {root} failed", file=sys.stderr)
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
        if name.endswith(" hash") or name.endswith(" exact"):
            seen = [str(r.get(name)) for r in runs]
            print(f"{name}: " + ("the same in all four runs"
                                 if len(set(seen)) == 1 else
                                 "DIFFERS: " + ", ".join(seen)))
    for tag, r in (("other", runs[0]), ("this tree", runs[1])):
        for lib, rep in r["ptxas"].items():
            print(f"{lib} ({tag}): C7510 {rep.get('c7510')}, C7520 "
                  f"{rep.get('c7520')}; "
                  + "; ".join(f"{k[0]} {k[1]} registers, spills {k[2]}/"
                              f"{k[3]} B" for k in rep.get("kernels", []))
                  + f"; local ops {rep.get('local ops by region')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
