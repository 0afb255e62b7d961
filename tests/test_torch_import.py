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
    assert int(res.stdout.strip()) >= 37


def test_training_path_runs_without_jax():
    """The training path (the flash backward's plain version and the
    differentiable Qwen3 forward) imports and runs with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton_distributed_tpu'] = None\n"
        "import torch\n"
        "from triton_distributed_tpu_torch import ModelConfig, Qwen3\n"
        "from triton_distributed_tpu_torch.kernels.flash_attention import (\n"
        "    flash_attention_backward, flash_attention_diff)\n"
        "m = Qwen3(ModelConfig.tiny(dtype='float32'), device='cpu')\n"
        "m.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)\n"
        "m(torch.zeros(1, 8, dtype=torch.long)).sum().backward()\n"
        "print(sum(p.grad is not None for p in m.parameters()))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == 2 * 8 + 2


def test_moe_path_runs_without_jax():
    """The MoE path (routing tables, the grouped GEMM's plain version, the
    MoE Qwen3 through `Engine.serve` and the scheduler, `ag_gemm` at world
    1) imports and runs with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton_distributed_tpu'] = None\n"
        "import torch\n"
        "from triton_distributed_tpu_torch import (ContinuousBatchingScheduler,\n"
        "    Engine, ModelConfig, Qwen3, Request, SchedulerConfig)\n"
        "from triton_distributed_tpu_torch.kernels.allgather_gemm import (\n"
        "    AllGatherGEMMContext, ag_gemm)\n"
        "m = Qwen3(ModelConfig.tiny_moe(dtype='float32'), device='cpu')\n"
        "m.init_params(torch.Generator().manual_seed(0))\n"
        "ids = torch.arange(16).reshape(2, 8)\n"
        "a = Engine(m).serve(ids, 3)\n"
        "s = ContinuousBatchingScheduler(m, SchedulerConfig(num_slots=2,\n"
        "    max_seq=32, prefill_buckets=(16, 32), kv_layout='paged'))\n"
        "done = s.run([Request(prompt=list(range(1, 9)), max_new_tokens=3)])\n"
        "x = torch.randn(4, 8)\n"
        "y = ag_gemm(x, torch.randn(8, 5), AllGatherGEMMContext('tp', 1, 'll'))\n"
        "print(tuple(a.shape), len(done[0].generated), tuple(y.shape))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["(2,", "3)", "3", "(4,", "5)"]


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
        KVCache, ModelConfig, PagedKVCache, Qwen3, resolve_device)
    from triton_distributed_tpu_torch.parallel import make_mesh
    from triton_distributed_tpu_torch.serving import ToyModel

    cfg = ModelConfig.tiny(dtype="float32")
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: Qwen3(cfg),
                 lambda: ToyModel(),
                 lambda: KVCache.create(1, 1, 1, 4, 16, torch.float32),
                 lambda: PagedKVCache.create(1, 2, 1, 1, 4, 16, 1),
                 lambda: make_mesh(4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert Qwen3(cfg, device="cpu").device == torch.device("cpu")


def test_tp_path_runs_without_jax():
    """The tensor-parallel path (the mesh, the collective ids, the
    symmetric buffers' module, `ag_gemm` and `gemm_rs` at world 4, a
    world-4 Qwen3 through `Engine.serve`) imports and runs with JAX
    blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton_distributed_tpu'] = None\n"
        "import torch\n"
        "from triton_distributed_tpu_torch import Engine, ModelConfig, Qwen3\n"
        "from triton_distributed_tpu_torch import collective_ids\n"
        "from triton_distributed_tpu_torch.language import core\n"
        "from triton_distributed_tpu_torch.parallel import make_mesh\n"
        "from triton_distributed_tpu_torch.kernels.allgather_gemm import (\n"
        "    AllGatherGEMMContext, ag_gemm)\n"
        "from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter "
        "import (\n"
        "    GEMMReduceScatterContext, gemm_rs)\n"
        "m = Qwen3(ModelConfig.tiny(dtype='float32'),\n"
        "          mesh=make_mesh(4, device='cpu'))\n"
        "m.init_params(torch.Generator().manual_seed(0))\n"
        "a = Engine(m).serve(torch.arange(32).reshape(4, 8), 3)\n"
        "x, w = torch.randn(4, 2, 8), torch.randn(4, 8, 5)\n"
        "y = ag_gemm(x, w, AllGatherGEMMContext('tp', 4, 'fused'))\n"
        "z = gemm_rs(y, torch.randn(4, 5, 6),\n"
        "            GEMMReduceScatterContext('tp', 4, 'll'))\n"
        "print(tuple(a.shape), tuple(y.shape), tuple(z.shape),\n"
        "      collective_ids.TP_ATTN_QKV, core.SIGNAL_WORDS)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["(4,", "3)", "(4,", "8,", "5)", "(4,",
                                  "2,", "6)", "18", "18"]


def test_collective_path_runs_without_jax():
    """The collective library (K15-K18 wrappers and their plain
    versions, `ops`, the SP decode and its layer, the low-latency
    all-gather, `TPMLP(mode="fused_ar")`) imports and runs with JAX
    blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton_distributed_tpu'] = None\n"
        "import torch\n"
        "from triton_distributed_tpu_torch import ops\n"
        "from triton_distributed_tpu_torch.kernels import common_ops\n"
        "from triton_distributed_tpu_torch.kernels.allgather import (\n"
        "    AllGatherContext, all_gather)\n"
        "from triton_distributed_tpu_torch.kernels.allreduce import (\n"
        "    AllReduceContext, all_reduce)\n"
        "from triton_distributed_tpu_torch.kernels.reduce_scatter import (\n"
        "    ReduceScatterContext, reduce_scatter)\n"
        "from triton_distributed_tpu_torch.kernels.low_latency_allgather "
        "import (\n"
        "    create_fast_allgather_context, fast_allgather_packed)\n"
        "from triton_distributed_tpu_torch.layers.sp_flash_decode_layer "
        "import (\n"
        "    SpFlashDecodeAttention)\n"
        "from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP\n"
        "from triton_distributed_tpu_torch.parallel import make_mesh\n"
        "x = torch.randn(4, 8, 16)\n"
        "a = all_gather(x, AllGatherContext('tp', 4, 'ring'))\n"
        "r = reduce_scatter(x, ReduceScatterContext('tp', 4, 'ring'))\n"
        "s = all_reduce(x, AllReduceContext('tp', 4, 'chain'))\n"
        "b = common_ops.broadcast(x, 2, 'tp', 4)\n"
        "o = ops.all_reduce(x, make_mesh(4, device='cpu'))\n"
        "p = fast_allgather_packed([x, x[:, :1]],\n"
        "    create_fast_allgather_context('tp', 4))\n"
        "att = SpFlashDecodeAttention('sp', 4, 8, 2, 64, 16)\n"
        "d = att(torch.randn(2, 8, 64), torch.randn(4, 2, 2, 16, 64),\n"
        "        torch.randn(4, 2, 2, 16, 64), torch.tensor([40, 5]))\n"
        "m = TPMLP(16, 32, mode='fused_ar', world_size=4,\n"
        "          dtype=torch.float32, device='cpu')\n"
        "print(tuple(a.shape), tuple(r.shape), tuple(s.shape),\n"
        "      bool(b[0].equal(x[2])), tuple(o.shape), tuple(p[1].shape),\n"
        "      tuple(d.shape), tuple(m(torch.randn(3, 16)).shape))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [
        "(4,", "32,", "16)", "(4,", "2,", "16)", "(4,", "8,", "16)", "True",
        "(4,", "8,", "16)", "(4,", "4,", "16)", "(4,", "2,", "8,", "64)",
        "(4,", "3,", "16)"]


def test_world_size_above_one_raises():
    """At world > 1 what is still unported raises, naming its kernels:
    training; an MoE model at world 2 builds and runs."""
    from triton_distributed_tpu_torch import Engine, ModelConfig, Qwen3
    from triton_distributed_tpu_torch.parallel import make_mesh

    m = Qwen3(ModelConfig.tiny_moe(dtype="float32"),
              mesh=make_mesh(2, device="cpu")).init_params(
                  torch.Generator().manual_seed(0))
    assert m.layers[0].mlp.gate_up.shape == (2, 4, 128, 128)
    assert Engine(m).serve(torch.arange(32).reshape(2, 16), 2).shape == (2, 2)
    m.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training duals"):
        m(torch.zeros(2, 16, dtype=torch.long))


def test_moe_tp_path_runs_without_jax():
    """The MoE and int8 tensor-parallel path (the packed plan, K11 and its
    int8 form, K10 fused and staged, K13, `MoEMLP` in fused and w8a8 and
    `TPMLP` in w8a8 at world 4, a world-4 MoE Qwen3 through
    `Engine.serve`) imports and runs with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton_distributed_tpu'] = None\n"
        "import torch\n"
        "from triton_distributed_tpu_torch import Engine, ModelConfig, Qwen3\n"
        "from triton_distributed_tpu_torch.kernels import moe_utils\n"
        "from triton_distributed_tpu_torch.kernels.allgather_gemm import (\n"
        "    AllGatherGEMMContext, ag_gemm_w8a8)\n"
        "from triton_distributed_tpu_torch.kernels.allgather_group_gemm "
        "import (\n"
        "    AGGroupGEMMContext, ag_group_gemm, ag_group_gemm_w8a8)\n"
        "from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (\n"
        "    MoEReduceRSContext, moe_reduce_rs, moe_reduce_rs_fused)\n"
        "from triton_distributed_tpu_torch.kernels.quantized import "
        "quantize_sym\n"
        "from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP\n"
        "from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP\n"
        "from triton_distributed_tpu_torch.parallel import make_mesh\n"
        "g = torch.Generator().manual_seed(0)\n"
        "m = Qwen3(ModelConfig.tiny_moe(dtype='float32'), 'fused',\n"
        "          mesh=make_mesh(4, device='cpu')).init_params(g)\n"
        "a = Engine(m).serve(torch.arange(64).reshape(4, 16), 3)\n"
        "ids = torch.randint(0, 4, (64, 2), generator=g)\n"
        "plan = moe_utils.plan_chunks(ids, torch.rand(64, 2), 4, 4, 16)\n"
        "ctx = AGGroupGEMMContext('tp', 4, 4)\n"
        "h = ag_group_gemm(torch.randn(4, 4, 16, 8), torch.randn(4, 4, 8, 6),\n"
        "                  ctx, counts=plan.counts)\n"
        "wq, ws = quantize_sym(torch.randn(4, 4, 8, 6), 2)\n"
        "h8 = ag_group_gemm_w8a8(torch.randn(4, 4, 32, 16),\n"
        "                        quantize_sym(torch.randn(4, 4, 16, 6), 2)[0],\n"
        "                        torch.ones(4, 4, 6), ctx)\n"
        "rs = MoEReduceRSContext('tp', 4, 4, 2)\n"
        "y = moe_reduce_rs_fused(h[..., :3].contiguous(),\n"
        "                        torch.randn(4, 4, 3, 5), plan, rs)\n"
        "z = ag_gemm_w8a8(torch.randn(4, 3, 16), quantize_sym(\n"
        "    torch.randn(4, 16, 5), 1)[0], torch.ones(4, 5),\n"
        "    AllGatherGEMMContext('tp', 4))\n"
        "q = MoEMLP(16, 8, 4, mode='w8a8', world_size=4,\n"
        "           dtype=torch.float32, device='cpu')\n"
        "q.init_params(g)\n"
        "t = TPMLP(16, 8, mode='w8a8', world_size=4, device='cpu')\n"
        "t.init_params(g)\n"
        "print(tuple(a.shape), tuple(h.shape), tuple(h8.shape),\n"
        "      tuple(y.shape), tuple(z.shape),\n"
        "      tuple(q(torch.randn(4, 32, 16)).shape),\n"
        "      tuple(t(torch.randn(4, 2, 16, dtype=torch.bfloat16)).shape))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [
        "(4,", "3)", "(4,", "4,", "4,", "16,", "6)", "(4,", "4,", "4,",
        "32,", "6)", "(4,", "16,", "5)", "(4,", "12,", "5)", "(4,", "32,",
        "16)", "(4,", "2,", "16)"]


def test_ep_sp_path_runs_without_jax():
    """The expert-parallel exchange (K19's wrapper, `ops.all_to_all`,
    `EPAll2AllLayer`) and the SP attention compositions (K20's wrapper,
    the ring, zigzag and gather) import and run with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton_distributed_tpu'] = None\n"
        "import torch\n"
        "from triton_distributed_tpu_torch import ops\n"
        "from triton_distributed_tpu_torch.kernels import sp_ag_attention "
        "as sp\n"
        "from triton_distributed_tpu_torch.layers import EPAll2AllLayer\n"
        "from triton_distributed_tpu_torch.parallel import make_mesh\n"
        "layer = EPAll2AllLayer('ep', 4, 8, 2, 16, 32)\n"
        "x = torch.randn(4, 6, 32)\n"
        "ids = torch.randint(0, 8, (4, 6, 2))\n"
        "w = torch.softmax(torch.randn(4, 6, 2), -1)\n"
        "recv, eid, cnt, plan = layer.dispatch(x, ids)\n"
        "y = layer.combine(recv, cnt, plan, w, ids)\n"
        "ok = torch.allclose(y, x * w.sum(-1, keepdim=True), atol=1e-6)\n"
        "a = ops.all_to_all(recv, cnt, make_mesh(4, 'ep', device='cpu'))\n"
        "q, k = torch.randn(4, 1, 4, 16, 64), torch.randn(4, 1, 2, 16, 64)\n"
        "outs = [f(q, k, k) for f in (sp.sp_ag_attention_fused,\n"
        "        sp.sp_ring_attention, sp.sp_ag_attention_gather)]\n"
        "z = sp.sp_ring_attention_zigzag(q, k, k)\n"
        "same = all(torch.allclose(o, outs[0], atol=1e-5) for o in outs)\n"
        "same = same and z.shape == q.shape\n"
        "print(tuple(recv.shape), tuple(eid.shape), ok, tuple(a[0].shape),\n"
        "      tuple(outs[0].shape), same)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [
        "(4,", "4,", "16,", "32)", "(4,", "4,", "16)", "True", "(4,", "4,",
        "16,", "32)", "(4,", "1,", "4,", "16,", "64)", "True"]


def test_grid_path_runs_without_jax():
    """The process grid (the multi-axis mesh, `kernels/torus.py`'s K21
    wrappers and plain versions, `kernels/hierarchical.py`,
    `fast_allgather_2d`, `ag_gemm` / `gemm_rs` on both contexts,
    `sp_ag_attention_2d`, `HierarchicalEPAll2AllLayer`) imports and runs
    with JAX blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton_distributed_tpu'] = None\n"
        "import torch\n"
        "from triton_distributed_tpu_torch.kernels import hierarchical as h\n"
        "from triton_distributed_tpu_torch.kernels import torus\n"
        "from triton_distributed_tpu_torch.kernels import sp_ag_attention "
        "as sp\n"
        "from triton_distributed_tpu_torch.kernels.allgather_gemm import "
        "ag_gemm\n"
        "from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter "
        "import gemm_rs\n"
        "from triton_distributed_tpu_torch.kernels.low_latency_allgather "
        "import fast_allgather_2d\n"
        "from triton_distributed_tpu_torch.layers import (\n"
        "    HierarchicalEPAll2AllLayer)\n"
        "from triton_distributed_tpu_torch.parallel import (\n"
        "    make_hierarchical_mesh, make_mesh)\n"
        "mesh = make_mesh({'x': 2, 'y': 2, 'z': 2}, device='cpu')\n"
        "t = torus.TorusContext(mesh.axes, mesh.sizes)\n"
        "x = torch.randn(8, 6, 16)\n"
        "a = torus.all_reduce_torus(x, t)\n"
        "g = ag_gemm(x, torch.randn(8, 16, 5), t)\n"
        "r = gemm_rs(torch.randn(8, 16, 4), torch.randn(8, 4, 3), t)\n"
        "c = h.create_hierarchical_context(make_hierarchical_mesh(\n"
        "    2, 2, device='cpu'), 'ici', 'dcn')\n"
        "f = fast_allgather_2d(x[:4], c)\n"
        "q = torch.randn(4, 1, 2, 8, 32)\n"
        "o = sp.sp_ag_attention_2d(q, q, q, c)\n"
        "lay = HierarchicalEPAll2AllLayer('ici', 4, 8, 2, 16, 16, dcn_size=2)\n"
        "d = lay.dispatch(x[:4], torch.randint(0, 8, (4, 6, 2)))\n"
        "print(tuple(a.shape), tuple(g.shape), tuple(r.shape),\n"
        "      tuple(f.shape), tuple(o.shape), tuple(d[0].shape))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [
        "(8,", "6,", "16)", "(8,", "48,", "5)", "(8,", "2,", "3)", "(4,",
        "24,", "16)", "(4,", "1,", "2,", "8,", "32)", "(4,", "4,", "16,",
        "16)"]


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
