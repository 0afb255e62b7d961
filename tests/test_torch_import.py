"""The PyTorch/CUDA port stands alone: it imports with JAX and the JAX
package blocked, none of its modules (nor chip_smoke.py) imports them,
and its entry points refuse to run without CUDA unless asked for the
CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "triton_distributed_tpu_torch"
FORBIDDEN = ("jax", "triton_distributed_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton_distributed_tpu'] = None\n"
        "import triton_distributed_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from triton_distributed_tpu_torch import (
        KVCache, ModelConfig, Qwen3, resolve_device)

    cfg = ModelConfig.tiny(dtype="float32")
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: Qwen3(cfg),
                 lambda: KVCache.create(1, 1, 1, 4, 16, torch.float32)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert Qwen3(cfg, device="cpu").device == torch.device("cpu")


def test_world_size_above_one_raises():
    from triton_distributed_tpu_torch import ModelConfig, Qwen3

    with pytest.raises(NotImplementedError, match="multi-GPU"):
        Qwen3(ModelConfig.tiny(), world_size=2, device="cpu")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
