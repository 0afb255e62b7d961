"""GEMM-ReduceScatter (port of `triton_distributed_tpu/kernels/
gemm_reduce_scatter.py` `GEMMReduceScatterContext` :50, `gemm_rs` :215
and `gemm_rs_nonoverlap` :353).

The operands are rank-stacked (`parallel.mesh`): ``a`` (W, M, k_loc) holds
every rank's k shard of the activations' M rows, ``b`` (W, k_loc, n) every
rank's rows of the weight; rank c gets row chunk c of ``sum_r a_r @ b_r``,
so the result is (W, M/W, n).  On the card that is one launch of
``csrc/gemm_rs.cu`` (K14) over every rank: ``"fused"`` computes each
destination's chunk into its owner's receive buffer, remote chunks first
(JAX `_gemm_rs_fused_kernel`), ``"ll"`` one GEMM of all chunks, each row
sent to its owner (`_gemm_rs_ll_kernel`).  Both keep the JAX rounding: a
rank's partial of a chunk is rounded to the activations' dtype (the JAX
kernels' staging and receive buffers hold ``a.dtype``), then the partials
are summed in f32 in rank order 0 .. W-1 and cast once, as
`gemm_rs_plain` does.  ``"xla"`` is `gemm_rs_nonoverlap`, which sums the
f32 partials unrounded.  ``"auto"`` takes the JAX shape-only rule: ``"ll"``
while W padded chunks make at most 256 rows, else ``"fused"``.  At world 1
every method is the nonoverlap product.

Which body a launch runs depends on the operands only (`kernel_body`, K12's
rule): bf16 on 16-byte rows (k and n multiples of 8, 16-byte aligned; every
main-path call) the Hopper body, the `wgmma` + TMA tile storing each
partial tile, rounded to bf16, straight into its owner's receive buffer, on
the unpadded chunk rows, then every rank's blocks summing their chunk
(``ll`` at decode on the 64 x 256 tile).  f32, and bf16 off 16-byte rows,
run the first bodies (the `mma.sync` and f32 tiles) on chunk rows padded
to their row tile and sliced back.  On the Hopper body a row's result
depends on its own row only, not on the other rows, the row tile or the
method.

``ctx`` may also be a `kernels.torus.TorusContext` (`gemm_rs_torus`: the
partial products on K6, then K21b over every axis of the grid) or a
`kernels.hierarchical.HierarchicalContext` (`_gemm_rs_2d`: K14 over each
slice at each of dcn steps, dcn * dcn launches, the slices' results summed
in f32 along a DCN ring), as in JAX.

On a CUDA tensor `gemm_rs` launches the kernel or raises; on a CPU tensor
it computes the plain version, `gemm_rs_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    METHODS, kernel_body, round_up_rows)
from triton_distributed_tpu_torch.language.core import symmetric_buffers
from triton_distributed_tpu_torch.parallel.mesh import MAX_WORLD

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"gemm_rs": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, ctypes.c_uint64, _I,
                           ctypes.POINTER(_I), _P]}


@dataclasses.dataclass(frozen=True)
class GEMMReduceScatterContext:
    """``method``: "auto" | "fused" | "ll" | "xla".  ``collective_id``
    keys the instance's symmetric buffers and signals; concurrent
    instances need distinct ids (`collective_ids`)."""

    axis: str
    world_size: int
    method: str = "auto"
    collective_id: int = cids.GEMM_RS
    #: The group of ranks (a slice's index; 0 for a whole mesh).
    group: int = 0

    #: "auto" picks the ll method up to this many (padded) rows.
    LL_MAX_ROWS = 256

    def resolve_method(self, mc: int, dtype, k: Optional[int] = None,
                       n: Optional[int] = None) -> str:
        """Pick xla / ll / fused for chunks of ``mc`` rows: a named method
        as it is; "auto" is "xla" at world 1, else the shape-only rule."""
        if self.method not in METHODS:
            raise ValueError(f"method {self.method!r} not in {METHODS}")
        if self.method != "auto":
            return self.method
        if self.world_size <= 1:
            return "xla"
        rows = self.world_size * round_up_rows(mc, dtype)
        return "ll" if rows <= self.LL_MAX_ROWS else "fused"


def gemm_rs_nonoverlap(a, b):
    """The golden: f32 partials a_r @ b_r, summed over the ranks unrounded,
    row chunk c to rank c, cast to a's dtype.  a (W, M, k), b (W, k, n) ->
    (W, M/W, n)."""
    world, mt, _ = a.shape
    partial = torch.matmul(a.float(), b.float())
    return partial.reshape(world, world, mt // world, -1).sum(0).to(a.dtype)


def gemm_rs_plain(a, b):
    """The plain version of the kernel: each rank's partial rounded to a's
    dtype, then summed in f32 in rank order 0 .. W-1, cast to a's dtype.
    a (W, M, k), b (W, k, n) -> (W, M/W, n)."""
    world, mt, _ = a.shape
    partial = torch.matmul(a.float(), b.float()).to(a.dtype)
    chunks = partial.reshape(world, world, mt // world, -1)
    acc = chunks[0].float()
    for r in range(1, world):
        acc = acc + chunks[r].float()
    return acc.to(a.dtype)


def gemm_rs(a, b, ctx: GEMMReduceScatterContext):
    """reduce_scatter(a @ b) over the ranks' row chunks, in a's dtype.

    a (W, M, k), b (W, k, n), M a multiple of W -> (W, M/W, n).  The kernel
    takes bf16 or f32, both operands alike and contiguous, at most 8 ranks;
    anything else raises.  Each launch of K14 adds one to
    ``gemm_rs.launches`` (an ``ll`` launch also to ``gemm_rs.ll_launches``,
    one of the Hopper body also to ``gemm_rs.wgmma_launches``)."""
    from triton_distributed_tpu_torch.kernels.hierarchical import (
        HierarchicalContext)
    from triton_distributed_tpu_torch.kernels.torus import (
        TorusContext, gemm_rs_torus)
    if isinstance(ctx, HierarchicalContext):
        return _gemm_rs_2d(a, b, ctx)
    if isinstance(ctx, TorusContext):
        return gemm_rs_torus(a, b, ctx)
    world = ctx.world_size
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != world
            or b.shape[0] != world or a.shape[2] != b.shape[1]
            or a.shape[1] % world):
        raise ValueError(f"gemm_rs at world {world}: want a (W, M, k) with "
                         f"W | M and b (W, k, n), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    mc = a.shape[1] // world
    method = ctx.resolve_method(mc, a.dtype, k=a.shape[2], n=b.shape[2])
    if method == "xla" or world <= 1:
        return gemm_rs_nonoverlap(a, b)
    if a.device.type == "cpu":
        return gemm_rs_plain(a, b)
    return _launch(a, b, ctx, method)


gemm_rs.launches = 0
gemm_rs.ll_launches = 0
gemm_rs.wgmma_launches = 0


def _launch(a, b, ctx, method):
    world, mt, k = a.shape
    n = b.shape[2]
    mc = mt // world
    dev = a.device
    _check(a, b, world)
    wgmma = kernel_body(a, b) == "wgmma"
    mcp = mc if wgmma else round_up_rows(mc, a.dtype)
    a_p = a
    if mcp != mc:
        a_p = a.new_zeros((world, world, mcp, k))
        a_p[:, :, :mc] = a.reshape(world, world, mc, k)
    # The two bodies signal different words: an instance each.
    inst = symmetric_buffers("gemm_rs", ctx.collective_id,
                             method + ("/wgmma" if wgmma else ""), a.dtype,
                             world, dev, group=ctx.group)
    rbuf = inst.buffer("rbuf", (world, mcp, n), a.dtype)
    stage = (inst.buffer("stage", (world * mcp, n), a.dtype)
             if method == "ll" and not wgmma else None)
    out = torch.empty((world, mcp, n), dtype=a.dtype, device=dev)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("gemm_rs", _SIGNATURES)
    rc = lib.gemm_rs(
        a_p.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if stage is None else stage.data_ptr(), inst.peers(rbuf),
        inst.signal_peers(), world, 0, world, int(method == "ll"),
        _build.DTYPE_CODES[a.dtype], mcp, n, k, inst.epoch, int(wgmma),
        ctypes.byref(blocks),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, f"gemm_rs ({method}) kernel launch")
    inst.advance(blocks.value)
    gemm_rs.launches += 1
    if method == "ll":
        gemm_rs.ll_launches += 1
    if wgmma:
        gemm_rs.wgmma_launches += 1
    return out[:, :mc] if mcp != mc else out


def _gemm_rs_2d(a, b, hctx):
    """The two-level GEMM-RS (JAX `_gemm_rs_2d` :166): a (W, M, k), b (W,
    k, n) over a (dcn, ici) mesh, W | M -> (W, M/W, n).  At step s = 0 ..
    dcn-1 every slice d runs K14 (``hctx.gemm_method``) over its ICI ranks
    on the rows owned by slice (d + dcn - 1 - s) mod dcn, and adds the
    result in f32 into an accumulator that hops one slice along the DCN
    ring between steps (JAX's ``ppermute``: a roll of the stack along the
    dcn axis); after the last step each slice holds its own rows, cast to
    a's dtype."""
    dcn, ici = hctx.dcn_size, hctx.ici_size
    world = dcn * ici
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != world
            or b.shape[0] != world or a.shape[2] != b.shape[1]
            or a.shape[1] % world):
        raise ValueError(f"gemm_rs at (dcn {dcn}, ici {ici}): want a (W, M, "
                         f"k) with W | M and b (W, k, n), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    mt, k = a.shape[1:]
    mi = mt // dcn
    ar = a.reshape(world, dcn, mi, k)

    def part(s):
        outs = []
        for d in range(dcn):
            rows = hctx.slice_rows(d)
            c = (d + 2 * dcn - 1 - s) % dcn
            outs.append(gemm_rs(ar[rows, c].contiguous(),
                                b[rows].contiguous(), hctx._gemm_rs_ctx(d)))
        return torch.cat(outs).float()

    acc = part(0)
    for s in range(1, dcn):
        acc = torch.roll(acc.reshape(dcn, ici, *acc.shape[1:]), 1,
                         dims=0).reshape(acc.shape)
        acc = acc + part(s)
    return acc.to(a.dtype)


def _check(a, b, world):
    who = "gemm_rs"
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{who}: a on {a.device}, b on {b.device}; want "
                         "one CUDA device")
    if a.dtype not in _build.DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"{who}: a is {a.dtype} and b {b.dtype}; want both "
                         "bfloat16 or both float32")
    if not a.is_contiguous() or not b.is_contiguous():
        raise ValueError(f"{who}: operands must be contiguous")
    if world > MAX_WORLD:
        raise ValueError(f"{who}: world {world} > {MAX_WORLD}")
    if 0 in a.shape or 0 in b.shape:
        raise ValueError(f"{who}: empty operand a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
