"""AllGather-GEMM at world 1 (port of `triton_distributed_tpu/kernels/
allgather_gemm.py` `AllGatherGEMMContext` and `ag_gemm` for
``world_size == 1``).

With one device there is nothing to gather: ``method="fused"`` or
``"ll"`` runs the matmul kernel (`kernels.matmul.matmul`, K6), and
``"xla"`` (what ``"auto"`` picks at world 1) a library product with an f32
result cast back, as the JAX package's ``xla_dot`` does.  The ring and
one-shot kernels, the hierarchical and torus contexts, the fault-injection
fields and the observability event belong to the multi-GPU slice:
``world_size > 1`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from triton_distributed_tpu_torch.kernels.matmul import matmul

METHODS = ("auto", "fused", "ll", "xla")


@dataclasses.dataclass(frozen=True)
class AllGatherGEMMContext:
    """The fields a world-1 caller sets.  ``method``: "auto" | "fused" |
    "ll" | "xla"."""

    axis: str
    world_size: int
    method: str = "auto"

    def resolve_method(self, m: int, dtype, k: Optional[int] = None,
                       n: Optional[int] = None) -> str:
        """Pick xla / ll / fused: a named method as it is; "auto" is
        "xla" at world 1, where there is no communication to overlap."""
        if self.method not in METHODS:
            raise ValueError(f"method {self.method!r} not in {METHODS}")
        if self.method != "auto":
            return self.method
        if self.world_size <= 1:
            return "xla"
        raise _multi_gpu(self.world_size)


def _multi_gpu(world: int) -> NotImplementedError:
    return NotImplementedError(
        f"ag_gemm at world_size={world}: the multi-GPU AllGather-GEMM "
        "kernels are not yet ported (only world_size=1)")


def ag_gemm(a_shard, b, ctx: AllGatherGEMMContext,
            return_gathered: bool = False):
    """out = all_gather(a_shard) @ b, at world 1 a_shard @ b, in a_shard's
    dtype.  With ``return_gathered`` also returns the gathered A (at world
    1, a_shard itself)."""
    if ctx.world_size > 1:
        raise _multi_gpu(ctx.world_size)
    m, k = a_shard.shape
    method = ctx.resolve_method(m, a_shard.dtype, k=k, n=b.shape[1])
    if method in ("fused", "ll"):
        out = matmul(a_shard, b)
    else:
        out = torch.matmul(a_shard.float(), b.float()).to(a_shard.dtype)
    return (out, a_shard) if return_gathered else out
