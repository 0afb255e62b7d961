"""Mesh-level op wrappers (port of `triton_distributed_tpu/ops/api.py`).

The JAX wrappers take global arrays and `shard_map` a kernel over the
mesh.  Here a mesh (`parallel.make_mesh`) is one process holding every
rank, and a sharded global array is its rank-stacked tensor: row r of
the leading dim is what device r holds under the JAX wrapper's
PartitionSpec.  Each docstring names the JAX global array and its layout.
``axis`` defaults to the mesh's own and must be it; the keyword arguments
go to the op's context (``method``, ``collective_id``, ``straggler``,
``for_correctness``).
"""

from __future__ import annotations

from triton_distributed_tpu_torch.kernels import allgather as ag_mod
from triton_distributed_tpu_torch.kernels import allgather_gemm as agg_mod
from triton_distributed_tpu_torch.kernels import allreduce as ar_mod
from triton_distributed_tpu_torch.kernels import common_ops as common_mod
from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as grs_mod
from triton_distributed_tpu_torch.kernels import low_latency_all_to_all as a2a_mod
from triton_distributed_tpu_torch.kernels import reduce_scatter as rs_mod
from triton_distributed_tpu_torch.parallel.mesh import MeshContext


def _world(mesh: MeshContext, axis) -> tuple:
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"axis {axis!r}: the mesh's axis is {mesh.axis!r}")
    return mesh.axis, mesh.world_size


def all_gather(x, mesh: MeshContext, axis=None,
               method=ag_mod.AllGatherMethod.AUTO, **kw):
    """JAX: (M, N) sharded on rows (P(axis, None)) -> replicated (M, N).
    Here x (W, M/W, N), row r rank r's rows -> (W, M, N), row r rank r's
    copy of the replicated array."""
    axis, world = _world(mesh, axis)
    return ag_mod.all_gather(x, ag_mod.create_allgather_context(
        axis, world, method, **kw))


def reduce_scatter(x, mesh: MeshContext, axis=None, **kw):
    """JAX: x (W, M, N) sharded on its leading dim, row r rank r's partial
    of the full (M, N) -> their sum, (M, N) sharded on rows.  Here x (W,
    M, N) -> (W, M/W, N), row r rank r's chunk of the sum."""
    axis, world = _world(mesh, axis)
    return rs_mod.reduce_scatter(x, rs_mod.create_reduce_scatter_context(
        axis, world, **kw))


def all_reduce(x, mesh: MeshContext, axis=None, **kw):
    """JAX: x (W, M, N) sharded on its leading dim, row r rank r's partial
    -> their sum, replicated (M, N).  Here x (W, M, N) -> (W, M, N), row r
    rank r's copy of the sum."""
    axis, world = _world(mesh, axis)
    return ar_mod.all_reduce(x, ar_mod.create_allreduce_context(
        axis, world, **kw))


def all_to_all(send, counts, mesh: MeshContext, axis=None,
               send_scales=None, **kw):
    """JAX: send (W, W, cap, H) global, row r rank r's per-destination
    blocks; counts (W, W, 1); optional send_scales (W, W, cap, ns) -> (recv,
    recv_counts[, recv_scales]) in the same global layout, row r what rank
    r received (block p from rank p).  Here the global arrays are the
    rank-stacked tensors themselves (K19; `kernels.low_latency_all_to_all.
    fast_all_to_all`)."""
    axis, world = _world(mesh, axis)
    ctx = a2a_mod.create_all_to_all_context(
        axis, world, max_tokens_per_rank=send.shape[2], hidden=send.shape[3],
        **kw)
    return a2a_mod.fast_all_to_all(send, counts, ctx, send_scales=send_scales)


def broadcast(x, root, mesh: MeshContext, axis=None, **kw):
    """JAX: x (M, N) sharded on rows -> rank ``root``'s shard on every
    device, in the same sharding.  Here x (W, M/W, N) -> (W, M/W, N), every
    row x[root].  ``root``: an int or a 0-d integer tensor."""
    axis, world = _world(mesh, axis)
    return common_mod.broadcast(x, root, axis, world, **kw)


def ag_gemm(a, b, mesh: MeshContext, axis=None, **kw):
    """JAX: C = A @ B with A (M, K) row-sharded and B (K, N) column-
    sharded -> C (M, N) column-sharded.  Here a (W, M/W, K) and b (W, K,
    N/W) -> (W, M, N/W), row r rank r's columns of C (K12; `kernels.
    allgather_gemm.ag_gemm`)."""
    axis, world = _world(mesh, axis)
    return agg_mod.ag_gemm(a, b, agg_mod.AllGatherGEMMContext(
        axis, world, **kw))


def gemm_rs(a, b, mesh: MeshContext, axis=None, **kw):
    """JAX: C = reduce_scatter(A @ B) with A (M, K) column(K)-sharded and B
    (K, N) row(K)-sharded -> C (M, N) row-sharded.  Here a (W, M, K/W) and
    b (W, K/W, N) -> (W, M/W, N), row r rank r's rows of C (K14;
    `kernels.gemm_reduce_scatter.gemm_rs`)."""
    axis, world = _world(mesh, axis)
    return grs_mod.gemm_rs(a, b, grs_mod.GEMMReduceScatterContext(
        axis, world, **kw))


def ag_gemm_diff(a, b, mesh: MeshContext, axis=None, **kw):
    """The differentiable `ag_gemm` needs the training duals (its backward
    is the fused `gemm_rs`), not ported yet."""
    raise NotImplementedError(
        "ops.ag_gemm_diff needs the training duals (ag_gemm_diff, "
        "gemm_rs_diff), not yet ported")


def gemm_rs_diff(a, b, mesh: MeshContext, axis=None, **kw):
    """The differentiable `gemm_rs` needs the training duals (its backward
    is the fused `ag_gemm`), not ported yet."""
    raise NotImplementedError(
        "ops.gemm_rs_diff needs the training duals (ag_gemm_diff, "
        "gemm_rs_diff), not yet ported")
