"""Int8 (W8A8) quantized matmul with symmetric per-channel scales.

Port of `triton_distributed_tpu/kernels/quantized.py`: `quantize_sym`
(plain tensor code, as the JAX package leaves it to XLA), `matmul_w8a8`
(the Pallas `_w8a8_kernel`, here the hand-written CUDA kernel
``csrc/matmul_w8a8.cu``) and `matmul_quantized`.  The TPU block sizes
(`Int8MatmulConfig`) do not carry over: the CUDA kernel runs the int8 form
of the Hopper tile (``csrc/wgmma_tile.cuh`` `Int8Ops`: TMA and `wgmma`
m64nNk32 on int8, int32 accumulation), with its tile and k split chosen by
`plan_w8a8` from the shape.  `wgmma` takes 8-bit operands K-major only, so
the kernel reads b as (n, k): b_q (k, n) given as the transpose of a
contiguous (n, k) tensor (how `TPMLP` stores its int8 weights, once) is
read in place, any other b_q costs one transposed copy a call, counted in
``matmul_w8a8.transposes``.  `emit_matmul_w8a8` (JAX :161), the in-kernel
form, is still ``csrc/w8a8_body.cuh`` ``tdt::w8a8::tile`` (an `mma.sync`
tile that K9, K10 with int8 weights and K13 run); its plain version is
`matmul_w8a8_reference`.

The int32 accumulator is dequantized with one rank-1 scaling, ``acc *
(scale_a ⊗ scale_b)``.  On a CUDA tensor `matmul_w8a8` launches the kernel
or raises; on a CPU tensor it computes the plain version,
`matmul_w8a8_reference`, which accumulates exactly (in float64: every
partial sum is an integer below 2**53) and applies the same epilogue in the
same order, so kernel and plain version agree bit for bit, whatever the
tile or the k split (int32 sums are exact in any order).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from triton_distributed_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"matmul_w8a8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _P, _P]}

#: SMs of an H100 SXM: the planner's default (the wrapper passes the card's
#: own count).
H100_SMS = 132
#: k of a ring stage of the int8 tile: one 128-byte swizzled row.
K_STAGE = 128
#: The kernel's tiles, (rows, columns): 128 x 256 above 64 rows, 64 x 128
#: for decode batches (``csrc/matmul_w8a8.cu``).
W8A8_TILES = ((128, 256), (64, 128))
#: The fewest ring stages a range of a k split keeps (so that the ring
#: fills).
MIN_SPLIT_STAGES = 4


@dataclasses.dataclass(frozen=True)
class W8A8Plan:
    """K7's launch: tiles of ``rows`` x ``tn``, k in ``split`` ranges of
    ``per`` ring stages of `K_STAGE` (the last range may be shorter)."""

    rows: int
    tn: int
    split: int
    per: int

    def k_ranges(self, k: int) -> list[tuple[int, int]]:
        """The k range [k0, k1) of each split, in order."""
        step = self.per * K_STAGE
        return [(s * step, min(k, (s + 1) * step)) for s in range(self.split)]


@functools.lru_cache(maxsize=256)
def plan_w8a8(m: int, n: int, k: int, sms: int = H100_SMS) -> W8A8Plan:
    """The tile and k split of K7 for an (m, k) @ (k, n) product on ``sms``
    SMs: the 64 x 128 tile up to 64 rows, 128 x 256 above.  When the tiles
    fill less than a wave of SMs, k is split into as many ranges as keep
    the units within one wave, each of at least `MIN_SPLIT_STAGES` stages.
    Int32 sums are exact, so no plan changes a bit of the result."""
    rows, tn = W8A8_TILES[1] if m <= 64 else W8A8_TILES[0]
    stages = -(-k // K_STAGE)
    tiles = -(-m // rows) * -(-n // tn)
    split = max(1, min(sms // tiles, stages // MIN_SPLIT_STAGES))
    per = -(-stages // split)
    return W8A8Plan(rows, tn, -(-stages // per), per)


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

    The kernel takes a contiguous, 16-byte aligned a_q with k a positive
    multiple of 16, contiguous f32 scales, and reads b_q K-major: in place
    when b_q is the transpose of a contiguous (n, k) tensor (``b_q.t()`` is
    contiguous), else through one transposed copy, which adds one to
    ``matmul_w8a8.transposes``; anything else raises.  Each kernel launch
    adds one to ``matmul_w8a8.launches`` and, on the Hopper tile (every
    launch), to ``matmul_w8a8.wgmma_launches``."""
    if a_q.device.type == "cpu":
        return matmul_w8a8_reference(a_q, b_q, scale_a, scale_b, out_dtype)
    _check(a_q, b_q, scale_a, scale_b, out_dtype)
    m, k = a_q.shape
    n = b_q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    if out.numel():
        _launch(a_q, k_major(b_q), scale_a, scale_b, out,
                plan_w8a8(m, n, k, _sms(a_q.device)))
    return out


matmul_w8a8.launches = 0
matmul_w8a8.wgmma_launches = 0
matmul_w8a8.transposes = 0


def k_major(b_q):
    """b_q (k, n)'s K-major form, (n, k) contiguous: ``b_q.t()`` itself
    when b_q is stored so, else one copy (``matmul_w8a8.transposes``)."""
    bt = b_q.t()
    if bt.is_contiguous():
        return bt
    matmul_w8a8.transposes += 1
    return bt.contiguous()


def _launch(a_q, bt, scale_a, scale_b, out, plan: W8A8Plan):
    """One launch of csrc/matmul_w8a8.cu on a_q (m, k) and bt (n, k), both
    contiguous, into ``out`` (m, n) by ``plan``."""
    m, k = a_q.shape
    n = bt.shape[0]
    if bt.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("matmul_w8a8: b and out must be 16-byte aligned")
    # A k split's int32 partial sums, (split, m, n): every element written.
    ws = (torch.empty(plan.split * m * n, dtype=torch.int32,
                      device=a_q.device) if plan.split > 1 else None)
    lib = _build.load_library("matmul_w8a8", _SIGNATURES)
    rc = lib.matmul_w8a8(
        a_q.data_ptr(), bt.data_ptr(), scale_a.data_ptr(), scale_b.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[out.dtype], m, n, k, plan.rows,
        plan.split, plan.per, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(a_q.device).cuda_stream)
    _build.check(lib, rc, "matmul_w8a8 kernel launch")
    matmul_w8a8.launches += 1
    matmul_w8a8.wgmma_launches += 1


@functools.lru_cache(maxsize=16)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if not a_q.is_contiguous() or a_q.data_ptr() % 16:
        raise ValueError("matmul_w8a8: a_q is not contiguous and 16-byte "
                         "aligned")
    for nm, t, size in (("scale_a", scale_a, m), ("scale_b", scale_b, n)):
        if (t.dtype != torch.float32 or t.shape != (size,)
                or t.device != a_q.device or not t.is_contiguous()):
            raise ValueError(f"matmul_w8a8: {nm} must be a contiguous "
                             f"({size},) float32 tensor on {a_q.device}")
    if out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"matmul_w8a8: out dtype {out_dtype} not in "
                         "(bfloat16, float32)")
