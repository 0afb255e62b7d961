"""Int8 (W8A8) quantized matmul with symmetric per-channel scales.

Port of `triton_distributed_tpu/kernels/quantized.py`: `quantize_sym`
(plain tensor code, as the JAX package leaves it to XLA), `matmul_w8a8`
(the Pallas `_w8a8_kernel`, here the hand-written CUDA kernel
``csrc/matmul_w8a8.cu``) and `matmul_quantized`.  The TPU block sizes
(`Int8MatmulConfig`) do not carry over: the CUDA kernel has one tile.
That tile is also `emit_matmul_w8a8` (JAX :161), the in-kernel form:
``csrc/w8a8_body.cuh`` ``tdt::w8a8::tile``, a device function that one
block of a cooperative launch calls on any (row, column) tile, and that
K7's and K9's kernels call once a block; the fused int8 collectives (K11's
int8 form, K10 with int8 weights, K13) run it per tile.  Its plain
version is `matmul_w8a8_reference`.

The int32 accumulator is dequantized with one rank-1 scaling, ``acc *
(scale_a ⊗ scale_b)``.  On a CUDA tensor `matmul_w8a8` launches the kernel
or raises; on a CPU tensor it computes the plain version,
`matmul_w8a8_reference`, which accumulates exactly (in float64: every
partial sum is an integer below 2**53) and applies the same epilogue in the
same order, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from triton_distributed_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"matmul_w8a8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}


def quantize_sym(x, axis: int):
    """Symmetric int8 quantization along ``axis``: returns (q int8, scale
    f32) with x ~ q * scale, ``scale`` having ``axis`` reduced away.
    Bit for bit the JAX function run eagerly: amax in f32, ``max(amax,
    1e-30) / 127``, a true division, round half to even, clamp to +-127.
    The divisor is a tensor on x's device: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal instead, which moves the
    scale by an ulp from the CPU's.  (Under ``jax.jit`` XLA makes the same
    rewrite, so a jitted JAX scale can differ from this one by an ulp.)"""
    xf = x.float()
    scale = xf.abs().amax(dim=axis).clamp_min(1e-30) / torch.full(
        (), 127.0, device=xf.device)
    q = torch.round(xf / scale.unsqueeze(axis)).clamp_(-127, 127)
    return q.to(torch.int8), scale


def matmul_w8a8_reference(a_q, b_q, scale_a, scale_b,
                          out_dtype=torch.bfloat16):
    """The plain version: exact int8 products in float64, then
    ``acc.float() * sa[:, None] * sb[None, :]`` in that order."""
    acc = torch.matmul(a_q.double(), b_q.double())
    out = acc.float() * scale_a.float()[:, None] * scale_b.float()[None, :]
    return out.to(out_dtype)


def matmul_w8a8(a_q, b_q, scale_a, scale_b, out_dtype=torch.bfloat16):
    """C[m, n] ~ (a_q * scale_a[:, None]) @ (b_q * scale_b[None, :]).

    a_q: (m, k) int8; b_q: (k, n) int8; scale_a: (m,) f32 per row (per
    token); scale_b: (n,) f32 per column (per output channel).  Returns
    (m, n) in ``out_dtype`` (bf16 or f32).

    The kernel takes contiguous, 16-byte aligned int8 operands with k a
    positive multiple of 16 and contiguous f32 scales; anything else
    raises.  Each kernel launch adds one to ``matmul_w8a8.launches``."""
    if a_q.device.type == "cpu":
        return matmul_w8a8_reference(a_q, b_q, scale_a, scale_b, out_dtype)
    _check(a_q, b_q, scale_a, scale_b, out_dtype)
    m, k = a_q.shape
    n = b_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    if out.numel():
        lib = _build.load_library("matmul_w8a8", _SIGNATURES)
        rc = lib.matmul_w8a8(
            a_q.data_ptr(), b_q.data_ptr(), scale_a.data_ptr(),
            scale_b.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[out_dtype],
            m, n, k, torch.cuda.current_stream(a_q.device).cuda_stream)
        _build.check(lib, rc, "matmul_w8a8 kernel launch")
        matmul_w8a8.launches += 1
    return out


matmul_w8a8.launches = 0


def matmul_quantized(a, b):
    """Quantize float inputs on the fly (per-row activations, per-column
    weights) and run `matmul_w8a8`, out in a's dtype.  For inference,
    quantize the weights once with ``quantize_sym(w, 0)`` and call
    `matmul_w8a8` directly."""
    a_q, sa = quantize_sym(a, 1)
    b_q, sb = quantize_sym(b, 0)
    return matmul_w8a8(a_q, b_q, sa, sb, out_dtype=a.dtype)


def _check(a_q, b_q, scale_a, scale_b, out_dtype):
    if a_q.device.type != "cuda":
        raise ValueError(f"matmul_w8a8: unsupported device {a_q.device}")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"matmul_w8a8: bad shapes a{tuple(a_q.shape)} "
                         f"b{tuple(b_q.shape)}")
    m, k = a_q.shape
    n = b_q.shape[1]
    if k < 16 or k % 16:
        raise ValueError(f"matmul_w8a8: k={k} must be a positive multiple "
                         "of 16")
    for nm, t in (("a_q", a_q), ("b_q", b_q)):
        if t.dtype != torch.int8 or t.device != a_q.device:
            raise ValueError(f"matmul_w8a8: {nm} is {t.dtype} on {t.device}, "
                             f"want int8 on {a_q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"matmul_w8a8: {nm} is not contiguous and "
                             "16-byte aligned")
    for nm, t, size in (("scale_a", scale_a, m), ("scale_b", scale_b, n)):
        if (t.dtype != torch.float32 or t.shape != (size,)
                or t.device != a_q.device or not t.is_contiguous()):
            raise ValueError(f"matmul_w8a8: {nm} must be a contiguous "
                             f"({size},) float32 tensor on {a_q.device}")
    if out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"matmul_w8a8: out dtype {out_dtype} not in "
                         "(bfloat16, float32)")
