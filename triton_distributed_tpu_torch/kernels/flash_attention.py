"""Flash attention forward (prefill): causal GQA attention with an
optional ``kv_offset`` shift of the diagonal and a natural-log lse.

Port of `triton_distributed_tpu/kernels/flash_attention.py`
`flash_attention` (its three Pallas kernels `_flash_kernel_single_diag`,
`_flash_kernel_packed` and `_flash_kernel` are schedules of one function;
one hand-written CUDA kernel, ``csrc/flash_attention.cu``, computes it).

On a CUDA tensor `flash_attention` launches that kernel or raises; on a
CPU tensor it computes the plain version, `flash_attention_reference`.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Optional

import torch

from triton_distributed_tpu_torch.kernels import _build

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, ctypes.c_float, _P],
}


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None,
                              kv_offset: int = 0, return_lse: bool = False):
    """Dense attention in f32 (the JAX package's `attention_reference`,
    plus lse).  q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D).  Returns out
    (B, H, Sq, D) in q's dtype [, lse (B, H, Sq) f32]."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + kv_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, NEG_INF)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                       vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, kv_offset: int = 0,
                    return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) -> out (B, H, Sq, D)
    [, lse (B, H, Sq) f32].

    Query row i attends key columns <= i + kv_offset when causal.  Fully
    masked rows have lse ~ -inf and an unspecified out.  The kernel takes
    contiguous bf16 or f32 tensors with D in {64, 128}; anything else
    raises.  Each kernel launch adds one to ``flash_attention.launches``.
    """
    kv_offset = operator.index(kv_offset)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         kv_offset=kv_offset,
                                         return_lse=return_lse)
    b, h, sq, d = _check(q, k, v)
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel():
        lib = _build.load_library("flash_attention", _SIGNATURES)
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _build.DTYPE_CODES[q.dtype], b, h, hkv, sq, sk,
            d, int(causal), kv_offset, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, rc, "flash_attention kernel launch")
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def _check(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not match "
                         f"k{tuple(k.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash_attention: head_dim {d} not in (64, 128)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not contiguous "
                             "and 16-byte aligned")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         "(bfloat16, float32)")
    return b, h, sq, d
