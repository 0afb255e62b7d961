"""MLP layer (port of `triton_distributed_tpu/layers/tp_mlp.py` at
``world_size == 1``): up-projection to [gate | up], gated SiLU,
down-projection.  At world 1 the ``xla`` and ``fused`` modes compute the
same plain products (the JAX package's AllGather-GEMM and
GEMM-ReduceScatter reduce to dots there); the ``fused_ar`` and ``w8a8``
modes and multi-GPU tensor parallelism are not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from triton_distributed_tpu_torch.layers.tp_attn import (
    normal_init_, require_single_gpu, weight)

MODES = ("xla", "fused")


def gated_silu(gate_up):
    """SiLU(gate) * up for stacked [gate | up]: (..., 2n) -> (..., n).
    The SiLU runs in f32 and is cast back before the product (as
    `kernels/allgather_group_gemm.py` `gated_silu`)."""
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    return F.silu(gate.float()).to(gate.dtype) * up


class TPMLP(nn.Module):
    """Weights: ``gate_up`` (hidden, 2 ffn) as [gate | up], ``down``
    (ffn, hidden)."""

    def __init__(self, hidden: int, ffn: int, mode: str = "fused",
                 world_size: int = 1, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        require_single_gpu(world_size)
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES} (the others are "
                             "not ported yet)")
        self.hidden = hidden
        self.ffn = ffn
        self.mode = mode
        self.gate_up = weight(hidden, 2 * ffn, dtype=dtype, device=device)
        self.down = weight(ffn, hidden, dtype=dtype, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        std = self.hidden ** -0.5
        normal_init_(self.gate_up, generator, std)
        normal_init_(self.down, generator, std)

    def forward(self, x):
        return torch.matmul(gated_silu(torch.matmul(x, self.gate_up)),
                            self.down)
