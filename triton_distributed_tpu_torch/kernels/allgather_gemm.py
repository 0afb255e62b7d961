"""AllGather-GEMM (port of `triton_distributed_tpu/kernels/allgather_gemm.py`
`AllGatherGEMMContext` and `ag_gemm`).

At world 1 there is nothing to gather: ``method="fused"`` or ``"ll"`` runs
the matmul kernel (`kernels.matmul.matmul`, K6) on ``(m, k) @ (k, n)``, and
``"xla"`` (what ``"auto"`` picks at world 1) a library product with an f32
result cast back, as the JAX package's ``xla_dot`` does.

At world W > 1 the operands are rank-stacked (`parallel.mesh`): the row
shards ``a_shard`` (W, m, k) and the weight column shards ``b`` (W, k,
n_loc); every rank gets ``all_gather(a) @ b_r``, so the result is (W, W*m,
n_loc).  On the card that is one launch of ``csrc/ag_gemm.cu`` (K12) over
every rank: ``"fused"`` the ring that multiplies each chunk as it arrives
(JAX `_ag_gemm_fused_kernel`), ``"ll"`` the one-shot push then one GEMM
(`_ag_gemm_ll_kernel`); ``"xla"`` gathers by reshape and runs a library
product.  Which body a launch runs depends on the operands only
(`kernel_body`): bf16 on 16-byte rows (k and n multiples of 8, 16-byte
aligned; every main-path call) the Hopper body, PR 11's `wgmma` + TMA tile
fed by the ring, on the unpadded rows, and at decode (``ll`` with W*m <= 64
gathered rows) on 64-column tiles where the 256-column ones leave blocks
of a rank idle (`ll_tile_n`); f32, and bf16 off 16-byte rows, the first
bodies (the `mma.sync` and f32 tiles), on rows padded to their row tile
and sliced back, as the JAX wrapper does.  Both kernel methods reduce the
whole of k for every row in one order, so on one body the choice does not
change the result, and on the Hopper body neither do the other rows of
the call (every tile shape and width gives an element the same bits);
the two bodies sum in other orders, so their outputs differ within bf16
rounding.  ``"auto"`` takes the JAX shape-only
rule: ``"ll"`` while the padded gathered rows are at most 256, else
``"fused"``; the model-driven `choose_ll_or_fused` rests on the TPU's ICI
constants and waits for a model of this card's.  The fault-injection
fields and the observability event are not ported.

``ctx`` may also be a `kernels.torus.TorusContext` (`ag_gemm_torus`, K21c:
the gather over every axis of a process grid, each piece multiplied as it
lands) or a `kernels.hierarchical.HierarchicalContext` (`_ag_gemm_2d`: a
DCN ring of slice chunks, K12 over each slice at each of its dcn steps, so
dcn * dcn K12 launches), as in JAX.

`ag_gemm_w8a8` (JAX :390, K13) is the ring on int8 rows: x (W, m, k)
quantized per row on the fly, rows padded to 32 (`round_up_rows` of int8),
the per-row scales gathered outside the kernel (the rank-stacked tensor is
the gathered one, as JAX gathers them in XLA), b_q (W, k, n_loc) int8
with per-column scales (W, n_loc), out (W, W*m, n_loc) in x's dtype: one
cooperative launch of ``csrc/ag_gemm_w8a8.cu`` running the first int8
tile (``csrc/w8a8_body.cuh``, `quantized.emit_matmul_w8a8`) on each chunk as it arrives.  It has only
the ring (JAX asserts ``method in ("auto", "fused")``); at world 1 it is
`matmul_w8a8` (K7) on the quantized rows.

On a CUDA tensor `ag_gemm` and `ag_gemm_w8a8` launch their kernels or
raise; on a CPU tensor they compute the plain versions, `ag_gemm_plain`
and `ag_gemm_w8a8_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.matmul import matmul
from triton_distributed_tpu_torch.kernels.quantized import (
    matmul_w8a8, matmul_w8a8_reference, quantize_sym)
from triton_distributed_tpu_torch.language.core import symmetric_buffers
from triton_distributed_tpu_torch.parallel.mesh import MAX_WORLD

METHODS = ("auto", "fused", "ll", "xla")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"ag_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, ctypes.c_uint64, _I, _I, ctypes.POINTER(_I),
                           _P]}

#: The Hopper body's tile widths (columns), and the most gathered rows of
#: its one-consumer tile, on which ``ll`` may take the narrow width.
WGMMA_TILE_N, WGMMA_NARROW_N, WGMMA_DECODE_ROWS = 256, 64, 64
_W8A8_SIGNATURES = {"ag_gemm_w8a8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, ctypes.c_uint64,
                                     ctypes.POINTER(_I), _P]}


def round_up_rows(m: int, dtype) -> int:
    """Rows padded to the row tile of the dtype: 16 for 2-byte elements
    (the bf16 ``mma`` tile), 8 for 4-byte and 32 for 1-byte (a copy of
    `triton_distributed_tpu/kernels/matmul.py` `round_up_rows` :277, whose
    numbers the ``"auto"`` rule counts in)."""
    rows = {1: 32, 2: 16, 4: 8}[torch.empty((), dtype=dtype).element_size()]
    return (m + rows - 1) // rows * rows


@dataclasses.dataclass(frozen=True)
class AllGatherGEMMContext:
    """``method``: "auto" | "fused" | "ll" | "xla".  ``collective_id``
    keys the instance's symmetric buffers and signals; concurrent
    instances need distinct ids (`collective_ids`)."""

    axis: str
    world_size: int
    method: str = "auto"
    collective_id: int = cids.AG_GEMM
    #: The group of ranks (a slice's index; 0 for a whole mesh).
    group: int = 0

    #: "auto" picks the one-shot ll method up to this many (padded)
    #: gathered rows: the decode regime.
    LL_MAX_GATHERED_ROWS = 256

    def resolve_method(self, m: int, dtype, k: Optional[int] = None,
                       n: Optional[int] = None) -> str:
        """Pick xla / ll / fused: a named method as it is; "auto" is "xla"
        at world 1, where there is no communication to overlap, else the
        shape-only rule (k and n do not enter it)."""
        if self.method not in METHODS:
            raise ValueError(f"method {self.method!r} not in {METHODS}")
        if self.method != "auto":
            return self.method
        if self.world_size <= 1:
            return "xla"
        rows = self.world_size * round_up_rows(m, dtype)
        return "ll" if rows <= self.LL_MAX_GATHERED_ROWS else "fused"


def kernel_body(a_shard, b) -> str:
    """The K12 body a launch on these operands runs: "wgmma" for bf16 on
    16-byte rows (k and n multiples of 8, both operands 16-byte aligned),
    "mma" for other bf16 (the `mma.sync` tile, loads by element), "f32"
    (CUDA cores).  By operand only; nothing falls back on a failure."""
    if a_shard.dtype != torch.bfloat16:
        return "f32"
    k, n = a_shard.shape[-1], b.shape[-1]
    aligned = a_shard.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    return "wgmma" if k % 8 == 0 and n % 8 == 0 and aligned else "mma"


def ll_tile_n(n: int, blocks: int) -> int:
    """The column width of the ``ll`` Hopper body's tile at decode: 64 (the
    narrow m64n64k16 tile) while ceil(n / 64) column tiles fit one wave of
    ``blocks`` blocks a rank, else 256.  (Qwen3-8B at world 4, 33 blocks a
    rank: QKV's 1536 columns take 24 narrow tiles where 6 wide ones would
    leave 27 blocks idle; gate_up's 6144 keep 24 wide tiles.)  The width
    changes no bit of the result, only how many blocks stream b."""
    narrow = -(-n // WGMMA_NARROW_N) <= blocks
    return WGMMA_NARROW_N if narrow else WGMMA_TILE_N


def ag_gemm_plain(a_shard, b):
    """The plain version at world W: gather by reshape, an f32 product
    with every rank's shard of b, cast to a's dtype.  a_shard (W, m, k),
    b (W, k, n) -> (W, W*m, n)."""
    full = a_shard.reshape(-1, a_shard.shape[-1])
    return torch.matmul(full.float(), b.float()).to(a_shard.dtype)


def ag_gemm(a_shard, b, ctx: AllGatherGEMMContext,
            return_gathered: bool = False):
    """out = all_gather(a_shard) @ b in a_shard's dtype (f32 accumulation).

    World 1: a_shard (m, k), b (k, n) -> (m, n); the gathered A is a_shard
    itself.  World W: a_shard (W, m, k), b (W, k, n) -> (W, W*m, n), and
    the gathered A (W, W*m, k) (every rank's copy).  The kernel takes bf16
    or f32, both operands alike and contiguous, at most 8 ranks; anything
    else raises.  Each launch of K12 adds one to ``ag_gemm.launches`` (an
    ``ll`` launch also to ``ag_gemm.ll_launches``, one of the Hopper body
    also to ``ag_gemm.wgmma_launches``)."""
    from triton_distributed_tpu_torch.kernels.hierarchical import (
        HierarchicalContext)
    from triton_distributed_tpu_torch.kernels.torus import (
        TorusContext, ag_gemm_torus)
    if isinstance(ctx, HierarchicalContext):
        return _ag_gemm_2d(a_shard, b, ctx, return_gathered)
    if isinstance(ctx, TorusContext):
        return ag_gemm_torus(a_shard, b, ctx, return_gathered)
    if ctx.world_size <= 1:
        m, k = a_shard.shape
        method = ctx.resolve_method(m, a_shard.dtype, k=k, n=b.shape[1])
        if method in ("fused", "ll"):
            out = matmul(a_shard, b)
        else:
            out = torch.matmul(a_shard.float(), b.float()).to(a_shard.dtype)
        return (out, a_shard) if return_gathered else out
    world = ctx.world_size
    if (a_shard.dim() != 3 or b.dim() != 3 or a_shard.shape[0] != world
            or b.shape[0] != world or a_shard.shape[2] != b.shape[1]):
        raise ValueError(f"ag_gemm at world {world}: want a_shard (W, m, k) "
                         f"and b (W, k, n), got {tuple(a_shard.shape)} and "
                         f"{tuple(b.shape)}")
    _, m, k = a_shard.shape
    method = ctx.resolve_method(m, a_shard.dtype, k=k, n=b.shape[2])
    if method == "xla" or a_shard.device.type == "cpu":
        out = ag_gemm_plain(a_shard, b)
        if not return_gathered:
            return out
        full = a_shard.reshape(1, world * m, k)
        return out, full.expand(world, -1, -1).clone()
    return _launch(a_shard, b, ctx, method, return_gathered)


ag_gemm.launches = 0
ag_gemm.ll_launches = 0
ag_gemm.wgmma_launches = 0


def _launch(a_shard, b, ctx, method, return_gathered):
    world, m, k = a_shard.shape
    n = b.shape[2]
    dev = a_shard.device
    _check(a_shard, b, world)
    wgmma = kernel_body(a_shard, b) == "wgmma"
    mp = m if wgmma else round_up_rows(m, a_shard.dtype)
    a_p = a_shard
    if mp != m:
        a_p = a_shard.new_zeros((world, mp, k))
        a_p[:, :m] = a_shard
    inst = symmetric_buffers("ag_gemm", ctx.collective_id, method,
                             a_shard.dtype, world, dev, group=ctx.group)
    gathered = inst.buffer("gathered", (world, mp, k), a_shard.dtype)
    out = torch.empty((world, world, mp, n), dtype=a_shard.dtype, device=dev)
    narrow = False
    if wgmma and method == "ll" and world * m <= WGMMA_DECODE_ROWS:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        narrow = ll_tile_n(n, sms // world) == WGMMA_NARROW_N
    blocks = ctypes.c_int(0)
    lib = _build.load_library("ag_gemm", _SIGNATURES)
    rc = lib.ag_gemm(
        a_p.data_ptr(), b.data_ptr(), out.data_ptr(), inst.peers(gathered),
        inst.signal_peers(), world, 0, world, int(method == "ll"),
        _build.DTYPE_CODES[a_shard.dtype], mp, n, k, inst.epoch, int(wgmma),
        int(narrow), ctypes.byref(blocks),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, f"ag_gemm ({method}) kernel launch")
    inst.advance(blocks.value)
    ag_gemm.launches += 1
    if method == "ll":
        ag_gemm.ll_launches += 1
    if wgmma:
        ag_gemm.wgmma_launches += 1
    if mp != m:
        out = out[:, :, :m]
    out = out.reshape(world, world * m, n)
    if not return_gathered:
        return out
    # A copy: the instance's buffer is the next call's.
    return out, gathered[:, :, :m].clone().reshape(world, world * m, k)


def _ag_gemm_slice(a, b, ctx, return_gathered):
    """`ag_gemm` over one slice's rank-stacked rows (a slice of one rank
    runs the world-1 product)."""
    if ctx.world_size > 1:
        return ag_gemm(a, b, ctx, return_gathered)
    res = ag_gemm(a[0], b[0], ctx, return_gathered)
    return tuple(t[None] for t in res) if return_gathered else res[None]


def _ag_gemm_2d(a_shard, b, hctx, return_gathered: bool):
    """The two-level AG-GEMM (JAX `_ag_gemm_2d` :191): a (W, m, k), b (W, k,
    n) over a (dcn, ici) mesh -> (W, W*m, n) [, the gathered A].  At step s
    = 0 .. dcn-1 every slice d runs K12 (``hctx.gemm_method``) over its ICI
    ranks on the rows it holds, slice (d - s) mod dcn's, then the rows hop
    one slice along the DCN ring (JAX's ``ppermute``: a roll of the stack
    along the dcn axis).  The step-s products land at that slice's place
    in the global row order."""
    dcn, ici = hctx.dcn_size, hctx.ici_size
    world = dcn * ici
    if (a_shard.dim() != 3 or b.dim() != 3 or a_shard.shape[0] != world
            or b.shape[0] != world or a_shard.shape[2] != b.shape[1]):
        raise ValueError(f"ag_gemm at (dcn {dcn}, ici {ici}): want a_shard "
                         f"(W, m, k) and b (W, k, n), got "
                         f"{tuple(a_shard.shape)} and {tuple(b.shape)}")
    _, m, k = a_shard.shape
    n = b.shape[2]
    out = a_shard.new_empty((dcn, ici, dcn, ici * m, n))
    gathered = (a_shard.new_empty((dcn, ici, dcn, ici * m, k))
                if return_gathered else None)
    cur = a_shard.contiguous()
    for s in range(dcn):
        for d in range(dcn):
            rows = hctx.slice_rows(d)
            res = _ag_gemm_slice(cur[rows], b[rows].contiguous(),
                                 hctx._ag_gemm_ctx(d), return_gathered)
            src = (d - s) % dcn
            if return_gathered:
                out[d, :, src], gathered[d, :, src] = res
            else:
                out[d, :, src] = res
        if s < dcn - 1:
            cur = torch.roll(cur.reshape(dcn, ici, m, k), 1, dims=0).reshape(
                world, m, k)
    out = out.reshape(world, world * m, n)
    if not return_gathered:
        return out
    return out, gathered.reshape(world, world * m, k)


def ag_gemm_w8a8_plain(a_q, b_q, scales, scale_b, out_dtype):
    """The plain version of K13 on quantized rows a_q (W, mp, k) int8 with
    their scales (W, mp): every rank's exact product of the gathered rows
    with its b_q (W, k, n) and scale_b (W, n), then (float(acc) * sa) *
    sb, in ``out_dtype``: (W, W*mp, n)."""
    full_q = a_q.reshape(-1, a_q.shape[-1])
    sa = scales.reshape(-1)
    return torch.stack([matmul_w8a8_reference(full_q, b_q[r], sa, scale_b[r],
                                              out_dtype)
                        for r in range(b_q.shape[0])])


def ag_gemm_w8a8(a_shard, b_q, scale_b, ctx: AllGatherGEMMContext):
    """out ~ all_gather(a) @ (b_q * scale_b) in a_shard's dtype.

    World 1: a_shard (m, k), b_q (k, n) int8, scale_b (n,) -> (m, n).
    World W: a_shard (W, m, k) float, b_q (W, k, n) int8, scale_b (W, n)
    f32 -> (W, W*m, n).  k must be a multiple of 16.  Only the ring:
    ``ctx.method`` "auto" or "fused".  Each launch of K13 adds one to
    ``ag_gemm_w8a8.launches``."""
    if ctx.method not in ("auto", "fused"):
        raise ValueError(f"ag_gemm_w8a8 runs the fused ring only, got "
                         f"method={ctx.method!r}")
    if ctx.world_size <= 1:
        a_q, sa = quantize_sym(a_shard, 1)
        return matmul_w8a8(a_q, b_q, sa, scale_b, out_dtype=a_shard.dtype)
    world = ctx.world_size
    if (a_shard.dim() != 3 or b_q.dim() != 3 or a_shard.shape[0] != world
            or b_q.shape[0] != world or a_shard.shape[2] != b_q.shape[1]
            or tuple(scale_b.shape) != (world, b_q.shape[2])
            or b_q.dtype != torch.int8):
        raise ValueError(f"ag_gemm_w8a8 at world {world}: want a_shard (W, "
                         f"m, k), b_q (W, k, n) int8 and scale_b (W, n), got "
                         f"{tuple(a_shard.shape)}, {tuple(b_q.shape)} "
                         f"{b_q.dtype} and {tuple(scale_b.shape)}")
    _, m, k = a_shard.shape
    n = b_q.shape[2]
    a_q, sa = quantize_sym(a_shard, -1)
    mp = round_up_rows(m, torch.int8)
    if mp != m:
        a_q = torch.cat([a_q, a_q.new_zeros((world, mp - m, k))], dim=1)
        sa = torch.cat([sa, sa.new_zeros((world, mp - m))], dim=1)
    scale_b = scale_b.float().contiguous()
    if a_shard.device.type == "cpu":
        out = ag_gemm_w8a8_plain(a_q, b_q, sa, scale_b, a_shard.dtype)
    else:
        out = _launch_w8a8(a_q, b_q, sa, scale_b, ctx, a_shard.dtype)
    return out.reshape(world, world, mp, n)[:, :, :m].reshape(
        world, world * m, n)


ag_gemm_w8a8.launches = 0


def _launch_w8a8(a_q, b_q, sa, scale_b, ctx, out_dtype):
    world, mp, k = a_q.shape
    n = b_q.shape[2]
    dev = a_q.device
    if world > MAX_WORLD or k % 16 or out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"ag_gemm_w8a8: world {world} (at most "
                         f"{MAX_WORLD}), k={k} (a multiple of 16), out "
                         f"{out_dtype} (bfloat16 or float32)")
    for nm, t in (("b_q", b_q), ("scale_b", scale_b)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"ag_gemm_w8a8: {nm} not contiguous on {dev}")
    inst = symmetric_buffers("ag_gemm_w8a8", ctx.collective_id, "fused",
                             torch.int8, world, dev)
    gathered = inst.buffer("gathered", (world, mp, k), torch.int8)
    out = torch.empty((world, world * mp, n), dtype=out_dtype, device=dev)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("ag_gemm_w8a8", _W8A8_SIGNATURES)
    rc = lib.ag_gemm_w8a8(
        a_q.data_ptr(), b_q.data_ptr(), sa.data_ptr(), scale_b.data_ptr(),
        out.data_ptr(), inst.peers(gathered), inst.signal_peers(), world,
        _build.DTYPE_CODES[out_dtype], mp, n, k, inst.epoch,
        ctypes.byref(blocks), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "ag_gemm_w8a8 kernel launch")
    inst.advance(blocks.value)
    ag_gemm_w8a8.launches += 1
    return out


def _check(a, b, world):
    who = "ag_gemm"
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
