"""Grouped (per-expert) GEMM: (E, m, k) @ (E, k, n) -> (E, m, n).

Port of `triton_distributed_tpu/kernels/grouped_gemm.py` `grouped_matmul`
(the Pallas `_grouped_kernel`, here the hand-written CUDA kernel
``csrc/grouped_matmul.cu``) and `grouped_matmul_w8a8` (`_grouped_w8a8_kernel`,
here ``csrc/grouped_matmul_w8a8.cu``, the body of `matmul_w8a8` with an
expert index).  Experts are capacity-padded buckets, so a grouped GEMM is
a batched product with static shapes.  The TPU block sizes
(`MatmulConfig`, `Int8MatmulConfig`) and `grouped_matmul_tunable` do not
carry over.

The in-kernel forms that the fused MoE kernels call are CUDA device code
here: `emit_grouped_matmul` / `emit_grouped_matmul_w8a8` with ``count_of``
(row tiles past an expert's count compute nothing and write zeros) in
``csrc/ag_group_gemm.cu`` over ``wgmma_tile.cuh`` (bf16 on 16-byte rows),
``gemm_tile.cuh`` or ``w8a8_body.cuh``, and
`emit_packed_matmul` / `emit_packed_combine` /
`emit_packed_combine_matmul` (the packed block schedule, the tile rounded
to the activations' dtype, then the top-k weighted combine) in
``csrc/moe_reduce_rs.cu``.  Their plain versions are here:
`grouped_matmul_counts_reference`, `packed_matmul_reference` and `packed_combine_reference`; `row_tile` says
which rows a count-skipping tile covers.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version (`grouped_matmul_reference`,
`grouped_matmul_w8a8_reference`).  `grouped_matmul_diff` is
`grouped_matmul` under autograd: its backward is two ``torch.bmm``s, as
the JAX package leaves the einsums' transposes to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from triton_distributed_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"grouped_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}
_W8A8_SIGNATURES = {
    "grouped_matmul_w8a8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]}


def grouped_matmul_reference(a, b, out_dtype=None):
    """The plain version: f32 products, cast to ``out_dtype`` (default
    a's dtype)."""
    return torch.bmm(a.float(), b.float()).to(out_dtype or a.dtype)


def launch_grouped(a, b, out_dtype, who: str):
    """Check (E, m, k) and (E, k, n) CUDA operands and run
    ``csrc/grouped_matmul.cu`` on them.  Returns the (E, m, n) output and
    whether a kernel was launched (not for an empty output).  ``who``
    names the caller in errors."""
    _check(a, b, out_dtype, who)
    e, m, k = a.shape
    n = b.shape[2]
    out = torch.empty((e, m, n), dtype=out_dtype, device=a.device)
    if not out.numel():
        return out, False
    lib = _build.load_library("grouped_matmul", _SIGNATURES)
    rc = lib.grouped_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[a.dtype], _build.DTYPE_CODES[out_dtype], e, m, n,
        k, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, rc, f"{who} kernel launch")
    return out, True


def grouped_matmul(a, b, out_dtype=None):
    """out[e] = a[e] @ b[e] with f32 accumulation, in ``out_dtype``
    (default a's dtype; f32 for the MoE down-projection).

    a: (E, m, k), b: (E, k, n), both bf16 or both f32, contiguous; m, n and
    k may be ragged.  Anything else raises.  Each kernel launch adds one to
    ``grouped_matmul.launches``."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return grouped_matmul_reference(a, b, out_dtype)
    out, launched = launch_grouped(a, b, out_dtype, "grouped_matmul")
    if launched:
        grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return grouped_matmul(a, b, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb, None


def grouped_matmul_diff(a, b, out_dtype=None):
    """`grouped_matmul` with a gradient: the forward is the kernel, the
    backward multiplies f32 copies (``torch.bmm``) and casts each gradient
    to its operand's dtype.  Without a gradient to compute it is
    `grouped_matmul` and saves nothing."""
    out_dtype = out_dtype or a.dtype
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _GroupedMatmul.apply(a, b, out_dtype)
    return grouped_matmul(a, b, out_dtype)


def grouped_matmul_w8a8_reference(a_q, b_q, scale_a, scale_b,
                                  out_dtype=torch.bfloat16):
    """The plain version: exact int8 products in float64 (every partial
    sum is an integer below 2**53), then ``acc.float() * sa[:, :, None] *
    sb[:, None, :]`` in that order."""
    acc = torch.bmm(a_q.double(), b_q.double())
    out = (acc.float() * scale_a.float()[:, :, None]
           * scale_b.float()[:, None, :])
    return out.to(out_dtype)


def grouped_matmul_w8a8(a_q, b_q, scale_a, scale_b,
                        out_dtype=torch.bfloat16):
    """Quantized grouped matmul (E, m, k) int8 @ (E, k, n) int8 ->
    (E, m, n) in ``out_dtype`` (bf16 or f32), int32 accumulation.

    scale_a: (E, m) f32 per token; scale_b: (E, n) f32 per expert and
    output channel (`MoEMLP.quantize_params`).  The kernel takes
    contiguous, 16-byte aligned int8 operands with k a positive multiple of
    16 and contiguous f32 scales; anything else raises.  Each kernel launch
    adds one to ``grouped_matmul_w8a8.launches``."""
    if a_q.device.type == "cpu":
        return grouped_matmul_w8a8_reference(a_q, b_q, scale_a, scale_b,
                                             out_dtype)
    _check_w8a8(a_q, b_q, scale_a, scale_b, out_dtype)
    e, m, k = a_q.shape
    n = b_q.shape[2]
    out = torch.empty((e, m, n), dtype=out_dtype, device=a_q.device)
    if out.numel():
        lib = _build.load_library("grouped_matmul_w8a8", _W8A8_SIGNATURES)
        rc = lib.grouped_matmul_w8a8(
            a_q.data_ptr(), b_q.data_ptr(), scale_a.data_ptr(),
            scale_b.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[out_dtype],
            e, m, n, k, torch.cuda.current_stream(a_q.device).cuda_stream)
        _build.check(lib, rc, "grouped_matmul_w8a8 kernel launch")
        grouped_matmul_w8a8.launches += 1
    return out


grouped_matmul_w8a8.launches = 0


#: Rows of an a box of K11's Hopper body (``csrc/ag_group_gemm.cu``), its
#: row tile at every capacity.
WGMMA_BOX_ROWS = 64


def row_tile(rows: int, dtype, body: str = "mma") -> int:
    """Rows of the tile that the count-skipping device forms run on
    buckets of ``rows`` rows of ``dtype``: the bf16 tile that fits them (16,
    64 or 128, `gemm_tile.cuh`), 64 for f32; on K11's Hopper body
    (``body="wgmma"``: bf16 on 16-byte rows, `allgather_group_gemm.
    kernel_body`, and every int8 call) one 64-row box at every capacity
    (16, 64, 96, 128: a 16-row bucket is one box, a 96-row one two).  A tile
    starting at or past an expert's count is skipped; a tile that holds it
    computes in full."""
    if body == "wgmma":
        return WGMMA_BOX_ROWS
    if dtype == torch.float32:
        return 64
    return 16 if rows <= 16 else 64 if rows <= 64 else 128


def zero_past_counts(out, counts, block_m: int):
    """``out`` (..., E, m, n) with the rows of every row tile of
    ``block_m`` rows that starts at or past ``counts`` (..., E) set to
    zero: what the count-skipping forms write there."""
    live = (counts.long() + block_m - 1) // block_m * block_m
    rows = torch.arange(out.shape[-2], device=out.device)
    return torch.where(rows[:, None] < live[..., None, None], out,
                       out.new_zeros(()))


def grouped_matmul_counts_reference(a, b, counts, out_dtype=None):
    """The plain version of `emit_grouped_matmul` with ``count_of``:
    `grouped_matmul_reference`, zero in the row tiles (`row_tile`) past
    ``counts`` (E,)."""
    out = grouped_matmul_reference(a, b, out_dtype)
    return zero_past_counts(out, counts, row_tile(a.shape[1], a.dtype))


def packed_matmul_reference(a, b, block_expert, block_slot, n_blocks,
                            block: int, out_dtype, scale_a=None,
                            scale_b=None):
    """The plain version of `emit_packed_matmul`: the packed stage (T * B,
    n), block t's rows ``a[e_t, s_t B : s_t B + B] @ b[e_t]`` rounded to
    ``out_dtype``, zero past ``n_blocks``.  a (E, cap, k), b (E, k, n),
    float; or int8 with ``scale_a`` (E, cap) and ``scale_b`` (E, n), the
    product exact and dequantized as `grouped_matmul_w8a8_reference`."""
    if scale_a is None:
        dense = grouped_matmul_reference(a, b, out_dtype)
    else:
        dense = grouped_matmul_w8a8_reference(a, b, scale_a, scale_b,
                                              out_dtype)
    t_max = block_expert.shape[0]
    rows = (block_expert.long()[:, None] * a.shape[1]
            + block_slot.long()[:, None] * block
            + torch.arange(block, device=a.device))
    stage = dense.reshape(-1, dense.shape[-1])[rows.reshape(-1)]
    used = torch.arange(t_max, device=a.device).repeat_interleave(block)
    return torch.where((used < n_blocks)[:, None], stage, stage.new_zeros(()))


def packed_combine_reference(stage, rows, weights):
    """The plain version of `emit_packed_combine` (and of
    `emit_packed_combine_matmul` after `emit_packed_matmul`): out[i] =
    sum over k of weights[i, k] * stage[rows[i, k]] (`moe_utils.
    combine_pairs`: ascending stage rows, -1 past a token's kept pairs),
    each product and sum in f32, in that order.  Returns (mc, n) f32."""
    acc = stage.new_zeros((rows.shape[0], stage.shape[1]), dtype=torch.float32)
    for k in range(rows.shape[1]):
        r = rows[:, k]
        term = weights[:, k, None].float() * stage[r.clamp(min=0).long()].float()
        acc = acc + torch.where((r >= 0)[:, None], term, 0.0)
    return acc


def _check(a, b, out_dtype, who):
    if a.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {a.device}")
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[1]):
        raise ValueError(f"{who}: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    if a.dtype not in _build.DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"{who}: a is {a.dtype} and b {b.dtype}; want both "
                         "bfloat16 or both float32")
    if b.device != a.device:
        raise ValueError(f"{who}: b on {b.device}, a on {a.device}")
    if not a.is_contiguous() or not b.is_contiguous():
        raise ValueError(f"{who}: operands must be contiguous")
    if out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{who}: out dtype {out_dtype} not in (bfloat16, "
                         "float32)")
    if a.shape[0] > 65535:
        raise ValueError(f"{who}: {a.shape[0]} groups (at most 65535)")


def _check_w8a8(a_q, b_q, scale_a, scale_b, out_dtype):
    who = "grouped_matmul_w8a8"
    if a_q.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {a_q.device}")
    if (a_q.dim() != 3 or b_q.dim() != 3 or a_q.shape[0] != b_q.shape[0]
            or a_q.shape[2] != b_q.shape[1]):
        raise ValueError(f"{who}: bad shapes a{tuple(a_q.shape)} "
                         f"b{tuple(b_q.shape)}")
    e, m, k = a_q.shape
    n = b_q.shape[2]
    if k < 16 or k % 16:
        raise ValueError(f"{who}: k={k} must be a positive multiple of 16")
    if e > 65535:
        raise ValueError(f"{who}: {e} groups (at most 65535)")
    for nm, t in (("a_q", a_q), ("b_q", b_q)):
        if t.dtype != torch.int8 or t.device != a_q.device:
            raise ValueError(f"{who}: {nm} is {t.dtype} on {t.device}, want "
                             f"int8 on {a_q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{who}: {nm} is not contiguous and 16-byte "
                             "aligned")
    for nm, t, size in (("scale_a", scale_a, m), ("scale_b", scale_b, n)):
        if (t.dtype != torch.float32 or t.shape != (e, size)
                or t.device != a_q.device or not t.is_contiguous()):
            raise ValueError(f"{who}: {nm} must be a contiguous ({e}, "
                             f"{size}) float32 tensor on {a_q.device}")
    if out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{who}: out dtype {out_dtype} not in (bfloat16, "
                         "float32)")
