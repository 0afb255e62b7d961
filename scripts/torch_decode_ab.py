#!/usr/bin/env python3
"""Decode kernels of the PyTorch/CUDA port, two source trees compared on
one NVIDIA GPU: device ms and host us a call of K2/K2q (`flash_decode`)
and K3/K3q (`flash_decode_paged`) at `chip_smoke.py`'s decode states.

    python3 scripts/torch_decode_ab.py --ab OTHER_ROOT

runs the measurement for OTHER_ROOT (a checkout of another commit, for
example ``git archive`` of the parent unpacked into a git-ignored
directory), this tree, this tree and OTHER_ROOT again, each in its own
process (the two trees' packages share a name), and prints one JSON line a
run and a summary.  ``--root DIR`` measures the tree at DIR alone.

States (bf16, Qwen3-8B's 32/8 heads of 128, seeded random K/V):
- K2/K2q: 4 rows at 513 positions of a 1024-position dense cache;
- K3/K3q: 8 rows at (1, 15, 16, 17, 513, 1000, 1928, 2048) positions in
  pages of 16 (capacity 2048), each row's pages shuffled over the pool.
Device ms: CUDA events over back-to-back calls queued behind a device
spin, 36 layers' caches in turn (as a decode step reads them, so K/V
come from HBM and not from the 50 MB L2).  Host us: the wrapper's time a
call over windows of 500 calls queued behind a device spin.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
K3_LENS = (1, 15, 16, 17, 513, 1000, 1928, 2048)
LAYERS, HOST_CALLS, SPIN = 36, 500, 100_000_000


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from triton_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode, flash_decode_paged, quantize_kv)
    from triton_distributed_tpu_torch.kernels.quantized import quantize_sym

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def device_ms(fn, layers, reps=5):
        call = lambda: [fn(*t) for t in layers]  # noqa: E731
        for _ in range(2):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps / len(layers)

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        return us

    q2 = randn(4, 32, 128)
    len2 = torch.full((4,), 513, dtype=torch.int32, device=dev)
    dense = [(randn(4, 8, 1024, 128), randn(4, 8, 1024, 128))
             for _ in range(LAYERS)]
    dense_q = [quantize_kv(k, v) for k, v in dense]

    q3 = randn(8, 32, 128)
    len3 = torch.tensor(K3_LENS, dtype=torch.int32, device=dev)
    need = [-(-n // 16) for n in K3_LENS]
    perm = 1 + torch.randperm(sum(need), generator=gen, device=dev)
    table = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n].to(torch.int32)
        at += n
    pages = 1 + sum(need)
    pools = [(randn(pages, 8, 16, 128), randn(pages, 8, 16, 128))
             for _ in range(LAYERS)]
    pools_q = []
    for k, v in pools:
        (kq, ks), (vq, vs) = quantize_sym(k, 3), quantize_sym(v, 3)
        pools_q.append((kq, vq, ks, vs))

    calls = {
        "K2": (lambda k, v: flash_decode(q2, k, v, len2), dense),
        "K2q": (lambda k, v, ks, vs: flash_decode(
            q2, k, v, len2, k_scale=ks, v_scale=vs), dense_q),
        "K3": (lambda k, v: flash_decode_paged(q3, k, v, table, len3),
               pools),
        "K3q": (lambda k, v, ks, vs: flash_decode_paged(
            q3, k, v, table, len3, k_scale=ks, v_scale=vs), pools_q),
    }
    out = {"root": str(root), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    for name, (fn, layers) in calls.items():
        ms = device_ms(fn, layers)
        us = host_us(lambda: fn(*layers[0]))
        out[name] = {"ms": ms, "host_us": us}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", type=Path)
    group.add_argument("--ab", type=Path, metavar="OTHER_ROOT")
    args = ap.parse_args()
    if args.root is not None:
        import torch

        if not torch.cuda.is_available():
            print("torch_decode_ab: CUDA is not available", file=sys.stderr)
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
            print(f"torch_decode_ab: the run of {root} failed",
                  file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for name in ("K2", "K2q", "K3", "K3q"):
        print(f"{name}: other {runs[0][name]['ms']:.4f} / "
              f"{runs[3][name]['ms']:.4f} ms, host "
              f"{runs[0][name]['host_us']:.2f} / "
              f"{runs[3][name]['host_us']:.2f} us; this tree "
              f"{runs[1][name]['ms']:.4f} / {runs[2][name]['ms']:.4f} ms, "
              f"host {runs[1][name]['host_us']:.2f} / "
              f"{runs[2][name]['host_us']:.2f} us; {runs[0]['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
