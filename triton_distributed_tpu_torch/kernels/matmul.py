"""Matmul: C[m, n] = A[m, k] @ B[k, n] with f32 accumulation.

Port of `triton_distributed_tpu/kernels/matmul.py` `matmul` (the Pallas
`_matmul_kernel`): on the card it is the grouped GEMM kernel
(``csrc/grouped_matmul.cu``) with one group, launched by this wrapper and
counted apart from `grouped_matmul`.  The TPU block sizes (`MatmulConfig`,
`matmul_config_space`) and the Mosaic tiling helpers (`pad_lanes`,
`pad_contraction_lanes`) do not carry over (`round_up_rows` has a copy in
`kernels.allgather_gemm`); the in-kernel forms (`emit_matmul`,
`emit_chunked_matmul`) are the tile body ``csrc/gemm_tile.cuh`` that the
collective GEMMs (K12, K14) run.

On a CUDA tensor `matmul` launches the kernel or raises; on a CPU tensor
it computes the plain version, `matmul_reference`.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels.grouped_gemm import launch_grouped


def matmul_reference(a, b, out_dtype=None):
    """The plain version: an f32 product cast to ``out_dtype`` (default
    a's dtype)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def matmul(a, b, out_dtype=None):
    """a (m, k) @ b (k, n) -> (m, n) in ``out_dtype`` (default a's dtype).

    Both bf16 or both f32, contiguous; m, n and k may be ragged.  Anything
    else raises.  Each kernel launch adds one to ``matmul.launches``."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return matmul_reference(a, b, out_dtype)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    out, launched = launch_grouped(a[None], b[None], out_dtype, "matmul")
    if launched:
        matmul.launches += 1
    return out[0]


matmul.launches = 0
