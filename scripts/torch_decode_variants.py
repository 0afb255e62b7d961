#!/usr/bin/env python3
"""Where the decode kernels' time goes, by ablation: builds variants of
the PyTorch/CUDA port's decode body (`kernels/csrc/decode_body.cuh`) with
one phase cut out, and times K2/K2q/K3/K3q at `chip_smoke.py`'s decode
states (`scripts/torch_decode_ab.py` `measure`) on one NVIDIA GPU.

    python3 scripts/torch_decode_variants.py [VARIANT ...]

Variants (default: all, with ``base`` first and last):
- ``base``: the body as it is;
- ``nocompute``: each block waits for its copies and skips the softmax
  (what the copies, the combines and the fixed costs take);
- ``nocopy``: no bulk copy is issued or waited for; the consumers read
  whatever shared memory holds (what the arithmetic, the combines and the
  fixed costs take);
- ``nocombine``: the last block of a row does not combine its chunks.
The cut variants give wrong results and are for timing only.  Each is
built from a copy of the sources in a temporary directory (one ``nvcc``
a library, seconds); the repository is not touched.  Prints one JSON line
a variant: device ms of each kernel.
"""

from __future__ import annotations

import importlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: variant -> (text in decode_body.cuh, its replacement)
EDITS = {
    "base": [],
    "nocompute": [("    mbar_wait(&bar[s], 0);\n",
                   "    mbar_wait(&bar[s], 0);\n"
                   "    if (scale > -1.f) continue;\n")],
    "nocopy": [("  if (tid < 32 && n > 0) {",
                "  if (tid < 32 && n > 0 && scale < -1.f) {"),
               ("    mbar_wait(&bar[s], 0);\n", "")],
    "nocombine": [("  if (!last) return;\n", "  if (scale > -1.f) return;\n")],
}


def main() -> int:
    names = sys.argv[1:] or ["base", "nocompute", "nocopy", "nocombine",
                             "base"]
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_variants: CUDA is not available",
              file=sys.stderr)
        return 1
    from triton_distributed_tpu_torch.kernels import _build
    from torch_decode_ab import measure

    # `kernels.flash_decode` is also the name of a function the package
    # exports; the wrappers' module is loaded by its full name.
    importlib.import_module("triton_distributed_tpu_torch.kernels."
                            "flash_decode")
    source = (_build.CSRC / "decode_body.cuh").read_text()
    csrc = _build.CSRC
    for name in names:
        text = source
        for old, new in EDITS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in the "
                                   "decode body")
            text = text.replace(old, new)
        tmp = Path(tempfile.mkdtemp(prefix=f"decode_{name}_"))
        shutil.copytree(csrc, tmp / "csrc")
        (tmp / "csrc" / "decode_body.cuh").write_text(text)
        _build.CSRC, _build.BUILD_DIR = tmp / "csrc", tmp / "build"
        _build._loaded.clear()
        res = measure(ROOT)
        print(json.dumps({"variant": name, "card": res["card"],
                          **{k: v["ms"] for k, v in res.items()
                             if k.startswith("K")}}), flush=True)
        shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
