"""Mesh-level op wrappers (port of `triton_distributed_tpu/ops`): the
user-facing API over the one-process mesh's rank-stacked tensors."""

from triton_distributed_tpu_torch.ops.api import (  # noqa: F401
    ag_gemm,
    ag_gemm_diff,
    all_gather,
    all_reduce,
    all_to_all,
    broadcast,
    gemm_rs,
    gemm_rs_diff,
    reduce_scatter,
)
