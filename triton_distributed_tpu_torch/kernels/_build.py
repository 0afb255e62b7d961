"""Build the CUDA sources under ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``triton_distributed_tpu_torch/_build/`` (git-ignored).  The file name
carries a hash of the sources and flags, so an edited kernel is rebuilt
and a stale library is never loaded.  A build writes to a temporary name
and renames it into place, so a build that was cut off leaves no partial
library behind.  ptxas's resource report (``-Xptxas -v``: registers,
shared memory and spill bytes of every kernel) is kept beside each library
(`resource_usage`).  There is no fallback: without ``nvcc`` this raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: dtype codes understood by the C entry points (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "triton_distributed_tpu_torch are built from source at first use")


def _library_path(name: str, csrc: Path | None = None,
                  build_dir: Path | None = None) -> Path:
    csrc, build_dir = csrc or CSRC, build_dir or BUILD_DIR
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cuh")) + [csrc / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names, csrc: Path | None = None,
          build_dir: Path | None = None) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> path.
    ``csrc`` and ``build_dir`` (default: the package's) build another copy
    of the sources, such as a measurement's variant of a kernel."""
    csrc, build_dir = csrc or CSRC, build_dir or BUILD_DIR
    paths = {n: _library_path(n, csrc, build_dir) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(prefix=f".{p.name}.", suffix=".tmp",
                                   dir=build_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(csrc / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failures = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            todo[n].with_suffix(".log").write_text(log)
            os.replace(tmp, todo[n])
        else:
            os.unlink(tmp)
            failures.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def resource_usage(name: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes, static
    shared memory bytes) of every kernel of ``csrc/<name>.cu``, from
    ptxas's report of its build (the kernel's mangled name).  Dynamic
    shared memory is set at launch and is not in the report."""
    log = _library_path(name).with_suffix(".log").read_text()
    rows, kernel, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((kernel, int(m.group(1)), *spills,
                         int(smem.group(1)) if smem else 0))
            kernel = None
    return rows


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.  ``signatures``
    maps each C entry point to its argtypes; every entry returns a
    cudaError_t code as int."""
    lib = _loaded.get(name)
    if lib is None:
        lib = load_path(build([name])[name], signatures)
        _loaded[name] = lib
    return lib


def load_path(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load the built library at ``path`` with ``signatures``."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.tdt_error_string.argtypes = [ctypes.c_int]
    lib.tdt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.tdt_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
