"""Flash-decode: one-position GQA attention over a dense KV cache, masked
by each row's filled length.

Port of `triton_distributed_tpu/kernels/flash_decode.py` `flash_decode`
(Pallas `_decode_kernel`, float cache) as the hand-written CUDA kernel
``csrc/flash_decode.cu``.  The int8 cache (``k_scale``/``v_scale``) and
the paged and sequence-parallel forms are not ported yet.

On a CUDA tensor `flash_decode` launches that kernel or raises; on a CPU
tensor it computes the plain version, `flash_decode_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from triton_distributed_tpu_torch.kernels import _build

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _P],
}


def flash_decode_reference(q, k_cache, v_cache, kv_len, *,
                           scale: Optional[float] = None):
    """Dense decode attention in f32.  q: (B, H, D); caches (B, Hkv, S, D);
    kv_len: (B,) int.  Returns out (B, H, D) in q's dtype, lse (B, H) f32."""
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < kv_len.to(q.device)[:, None]          # (B, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    lse = torch.logsumexp(scores, dim=-1)
    return out.reshape(b, h, d).to(q.dtype), lse.reshape(b, h)


def flash_decode(q, k_cache, v_cache, kv_len, *,
                 scale: Optional[float] = None):
    """q: (B, H, D); k_cache, v_cache: (B, Hkv, S, D); kv_len: (B,) int32
    filled lengths (<= S).  Returns (out (B, H, D), lse (B, H) f32).

    The kernel takes contiguous bf16 or f32 tensors with D in {64, 128}
    and H/Hkv in {1, 2, 4, 8}; anything else raises.  Each kernel launch
    adds one to ``flash_decode.launches``."""
    if q.device.type == "cpu":
        return flash_decode_reference(q, k_cache, v_cache, kv_len,
                                      scale=scale)
    b, h, d, hkv, s = _check(q, k_cache, v_cache, kv_len)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    if out.numel():
        lib = _build.load_library("flash_decode", _SIGNATURES)
        rc = lib.flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _build.DTYPE_CODES[q.dtype], b, h, hkv, s, d, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, rc, "flash_decode kernel launch")
        flash_decode.launches += 1
    return out, lse


flash_decode.launches = 0


def _check(q, k_cache, v_cache, kv_len):
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    b, h, d = q.shape
    _, hkv, s, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or h % hkv:
        raise ValueError(f"flash_decode: q{tuple(q.shape)} does not match "
                         f"cache {tuple(k_cache.shape)}")
    if d not in (64, 128) or h // hkv not in (1, 2, 4, 8):
        raise ValueError(f"flash_decode: head_dim {d} / group {h // hkv} "
                         "not supported (64 or 128; 1, 2, 4 or 8)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_decode: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} is not contiguous and "
                             "16-byte aligned")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"flash_decode: dtype {q.dtype} not in "
                         "(bfloat16, float32)")
    if (kv_len.dtype != torch.int32 or kv_len.shape != (b,)
            or kv_len.device != q.device or not kv_len.is_contiguous()):
        raise ValueError("flash_decode: kv_len must be a contiguous (B,) "
                         "int32 tensor on q's device")
    return b, h, d, hkv, s
