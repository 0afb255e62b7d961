"""Attention layer (port of `triton_distributed_tpu/layers/tp_attn.py` at
``world_size == 1``).

Fused QKV projection, Qwen3 per-head q/k RMSNorm, RoPE, then the flash
attention kernel for prefill or the flash-decode kernel for decode, then
the output projection.  At world 1 the JAX package's AllGather-GEMM and
GEMM-ReduceScatter reduce to plain products (`allgather_gemm.py:304-315`,
`gemm_reduce_scatter.py:259-260`), which stay `torch.matmul` here.
Tensor parallelism over several GPUs is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from triton_distributed_tpu_torch.kernels.flash_attention import (
    flash_attention)
from triton_distributed_tpu_torch.kernels.flash_decode import flash_decode


def require_single_gpu(world_size: int) -> None:
    if world_size != 1:
        raise NotImplementedError(
            f"world_size={world_size}: multi-GPU tensor parallelism is not "
            "yet ported (only world_size=1)")


def normal_init_(t: torch.Tensor, generator: torch.Generator,
                 std: float) -> None:
    """Fill ``t`` with N(0, std^2) drawn in f32 from ``generator``."""
    t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32,
                        device=t.device).mul_(std))


def weight(*shape, dtype, device) -> nn.Parameter:
    """An uninitialised inference weight (filled by `init_params` or
    `load_jax_params`)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def rope_cos_sin(positions, dim: int, theta: float = 1e6,
                 dtype=torch.float32):
    """RoPE tables: positions (S,) -> cos, sin (S, dim/2)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x, cos, sin):
    """x: (..., S, D), rotate-half convention; the rotation runs in the
    promoted (f32) type and the result is cast back to x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    shape = (1,) * (x.dim() - 2) + tuple(cos.shape)
    c = cos.reshape(shape)
    s = sin.reshape(shape)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


class TPAttention(nn.Module):
    """Weights: ``wqkv`` (hidden, (H + 2 Hkv) D) with columns [q | k | v],
    ``wo`` (H D, hidden), and per-head ``q_norm``/``k_norm`` (D,)."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, rope_theta: float = 1e6,
                 qk_norm: bool = True, world_size: int = 1, *,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        require_single_gpu(world_size)
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads={num_heads} is not a multiple of "
                             f"num_kv_heads={num_kv_heads}")
        self.hidden = hidden
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.qk_norm = qk_norm
        qkv_cols = (num_heads + 2 * num_kv_heads) * head_dim
        self.wqkv = weight(hidden, qkv_cols, dtype=dtype, device=device)
        self.wo = weight(num_heads * head_dim, hidden, dtype=dtype,
                         device=device)
        if qk_norm:
            self.q_norm = weight(head_dim, dtype=dtype, device=device)
            self.k_norm = weight(head_dim, dtype=dtype, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        std = self.hidden ** -0.5
        normal_init_(self.wqkv, generator, std)
        normal_init_(self.wo, generator, std)
        if self.qk_norm:
            self.q_norm.fill_(1)
            self.k_norm.fill_(1)

    def _qkv_heads(self, x, batch: int, seq: int):
        """x (B*S, hidden) -> q (B, H, S, D), k/v (B, Hkv, S, D), normed."""
        d = self.head_dim
        qkv = torch.matmul(x, self.wqkv).view(batch, seq, -1)
        q, k, v = torch.split(
            qkv, [self.num_heads * d, self.num_kv_heads * d,
                  self.num_kv_heads * d], dim=-1)
        q = q.reshape(batch, seq, self.num_heads, d).transpose(1, 2)
        k = k.reshape(batch, seq, self.num_kv_heads, d).transpose(1, 2)
        v = v.reshape(batch, seq, self.num_kv_heads, d).transpose(1, 2)
        if self.qk_norm:
            q = rms_norm(q, self.q_norm)
            k = rms_norm(k, self.k_norm)
        return q, k, v

    def prefill(self, x, batch: int):
        """x: (B*S, hidden).  Returns (out (B*S, hidden), (k, v)) with k/v
        (B, Hkv, S, D) for the cache."""
        m = x.shape[0]
        seq = m // batch
        q, k, v = self._qkv_heads(x, batch, seq)
        cos, sin = rope_cos_sin(torch.arange(seq, device=x.device),
                                self.head_dim, self.rope_theta)
        q = apply_rope(q, cos, sin).contiguous()
        k = apply_rope(k, cos, sin).contiguous()
        v = v.contiguous()
        attn = flash_attention(q, k, v, causal=True)
        attn = attn.transpose(1, 2).reshape(m, -1)
        return torch.matmul(attn, self.wo), (k, v)

    def decode(self, x, kv_cache, offset):
        """One position per row.  x: (B, hidden); kv_cache: (k_cache,
        v_cache), each (B, Hkv, S_max, D), written IN PLACE at each row's
        ``offset`` ((B,) int32) before attention reads ``offset + 1``
        positions.  Returns out (B, hidden)."""
        k_cache, v_cache = kv_cache
        b = k_cache.shape[0]
        q, k, v = self._qkv_heads(x, b, 1)              # (B, *, 1, D)
        cos, sin = rope_cos_sin(offset, self.head_dim, self.rope_theta)
        c = cos[:, None, None, :]                       # (B, 1, 1, D/2)
        s = sin[:, None, None, :]

        def rope_rows(t):
            d2 = t.shape[-1] // 2
            t1, t2 = t[..., :d2], t[..., d2:]
            return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s],
                             dim=-1).to(t.dtype)

        q = rope_rows(q)
        k = rope_rows(k)
        rows = torch.arange(b, device=x.device)
        pos = offset.long()
        k_cache[rows, :, pos] = k[:, :, 0].to(k_cache.dtype)
        v_cache[rows, :, pos] = v[:, :, 0].to(v_cache.dtype)
        out, _ = flash_decode(
            q.reshape(b, self.num_heads, self.head_dim).contiguous(),
            k_cache, v_cache, offset + 1)
        return torch.matmul(out.reshape(b, -1), self.wo)
