"""Attention layer (port of `triton_distributed_tpu/layers/tp_attn.py`).

Fused QKV projection, Qwen3 per-head q/k RMSNorm, RoPE, then the flash
attention kernel for prefill or a flash-decode kernel (dense cache or
paged pool, float or int8) for decode, then the output projection.
Prefill attends over its float K/V and never reads the cache, so an int8
cache changes decode only.

At world 1 the JAX package's AllGather-GEMM and GEMM-ReduceScatter reduce
to plain products (`allgather_gemm.py:304-315`,
`gemm_reduce_scatter.py:259-260`), which stay `torch.matmul` here, and
prefill is differentiable (`flash_attention_diff`: K1 forward, K4/K5
backward) when a gradient is needed; the weights are created frozen, and
training turns them on with ``Module.requires_grad_(True)``.

At world W > 1 (tensor parallelism, heads sharded over the ranks; one
process holds every rank, `parallel.mesh`) the weights are rank-stacked,
``wqkv`` (W, hidden, qkv_loc) with columns [q_r | k_r | v_r] and ``wo``
(W, H_loc D, hidden), and the activations row-sharded (W, M/W, hidden).
Mode ``fused`` projects QKV with `ag_gemm` (K12) and the output with
`gemm_rs` (K14) (JAX `_project_qkv` :133, `_out_proj` :157); mode ``xla``
runs their ``"xla"`` method: the rows gathered by reshape, a library
product, and the f32 partials summed unrounded.
Rank r's heads are the global heads r H_loc .., so the attention kernels
run every rank's heads in one launch at the global head count, the GQA
grouping kept, and the KV cache keeps its global (B, Hkv, S, D) layout.
Decode needs a batch that the ranks split evenly.  What is still unported
at world > 1 raises `NotImplementedError` naming its kernels
(`require_ported`): training.
"""

from __future__ import annotations

import torch
from torch import nn

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    AllGatherGEMMContext, ag_gemm)
from triton_distributed_tpu_torch.kernels.flash_attention import (
    flash_attention_diff)
from triton_distributed_tpu_torch.kernels.flash_decode import (
    flash_decode, flash_decode_paged, write_kv)
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    GEMMReduceScatterContext, gemm_rs)

#: What runs only at world 1 so far, and the kernels it waits for.
UNPORTED_AT_WORLD = {
    "grad": "training needs the training duals (ag_gemm_diff, gemm_rs_diff: "
            "their backwards are the dual fused kernels)",
}


def collective_method(mode: str) -> str:
    """The collective GEMMs' method for a layer mode: ``fused`` lets the
    shape pick the kernel's method, ``xla`` is the gather or f32
    reduce-scatter around a library product."""
    return "auto" if mode == "fused" else "xla"


def require_ported(world_size: int, what: str) -> None:
    """Raise `NotImplementedError` naming the unported kernel when ``what``
    (a key of `UNPORTED_AT_WORLD`) is asked for at world > 1."""
    if world_size > 1:
        raise NotImplementedError(
            f"world_size={world_size}: {UNPORTED_AT_WORLD[what]}, not yet "
            "ported (it runs at world_size=1)")



def normal_init_(t: torch.Tensor, generator: torch.Generator,
                 std: float) -> None:
    """Fill ``t`` with N(0, std^2) drawn in f32 from ``generator``."""
    t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32,
                        device=t.device).mul_(std))


def weight(*shape, dtype, device) -> nn.Parameter:
    """An uninitialised weight (filled by `init_params` or
    `load_jax_params`), frozen until ``requires_grad_(True)``."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def weight_k_major(*shape, dtype, device) -> nn.Parameter:
    """`weight` of ``shape`` (..., k, n) stored K-major: the transposed
    view of a contiguous (..., n, k) tensor, so the JAX layout's shape and
    values with the layout the int8 `wgmma` kernels read in place, and no
    weight held twice."""
    *lead, k, n = shape
    return nn.Parameter(torch.empty((*lead, n, k), dtype=dtype,
                                    device=device).transpose(-1, -2),
                        requires_grad=False)


#: Leaves sharded by columns (their last axis) and by rows (their
#: second-to-last axis) at world W; every other leaf is replicated.
COLUMN_SHARDED = ("wqkv", "gate_up", "gate_up_q", "gate_up_scale")
ROW_SHARDED = ("wo", "down", "down_q")


def stack_columns(w, world: int):
    """The JAX global layout's column shards, (..., W * c) -> (W, ..., c)."""
    return w.reshape(*w.shape[:-1], world, -1).movedim(-2, 0)


def stack_rows(w, world: int):
    """The JAX global layout's row shards, (..., W * r, out) -> (W, ..., r,
    out)."""
    return w.reshape(*w.shape[:-2], world, -1, w.shape[-1]).movedim(-3, 0)


def tp_layout(name: str, leaf, world: int):
    """A JAX world-W weight -> the port's rank-stacked tensor: the
    `COLUMN_SHARDED` leaves split on their last axis (an MoE ``gate_up``
    (E, h, 2F) on its expert columns), the `ROW_SHARDED` ones on their rows
    (an MoE ``down`` (E, F, h) on F); anything else (the router, the MoE
    ``down_scale``) and everything at world 1 as it is."""
    if world == 1:
        return leaf
    if name in COLUMN_SHARDED:
        return stack_columns(leaf, world)
    if name in ROW_SHARDED:
        return stack_rows(leaf, world)
    return leaf


def jax_layout(name: str, t, world: int):
    """The inverse of `tp_layout`: a rank-stacked tensor -> the JAX
    world-W leaf."""
    if world == 1:
        return t
    if name in COLUMN_SHARDED:
        return t.movedim(0, -2).reshape(*t.shape[1:-1], -1)
    if name in ROW_SHARDED:
        return t.movedim(0, -3).reshape(*t.shape[1:-2], -1, t.shape[-1])
    return t


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
    """Weights at world 1: ``wqkv`` (hidden, (H + 2 Hkv) D) with columns
    [q | k | v], ``wo`` (H D, hidden); at world W: ``wqkv`` (W, hidden,
    (H_loc + 2 Hkv_loc) D) with columns [q_r | k_r | v_r], ``wo`` (W, H_loc
    D, hidden); and per-head ``q_norm``/``k_norm`` (D,).  ``mode``: "xla"
    or "fused" (the same products at world 1)."""

    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, rope_theta: float = 1e6,
                 qk_norm: bool = True, world_size: int = 1, *,
                 mode: str = "fused", dtype=torch.bfloat16, device=None):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads={num_heads} is not a multiple of "
                             f"num_kv_heads={num_kv_heads}")
        if num_heads % world_size or num_kv_heads % world_size:
            raise ValueError(f"{num_heads} query and {num_kv_heads} KV heads "
                             f"do not split over world_size={world_size} "
                             "(KV-head replication is unsupported)")
        if mode not in ("xla", "fused"):
            raise ValueError(f"attention mode {mode!r} not in ('xla', "
                             "'fused')")
        self.hidden = hidden
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.qk_norm = qk_norm
        self.world_size = world_size
        self.mode = mode
        self.h_loc = num_heads // world_size
        self.hkv_loc = num_kv_heads // world_size
        qkv_loc = (self.h_loc + 2 * self.hkv_loc) * head_dim
        stack = (world_size,) if world_size > 1 else ()
        self.wqkv = weight(*stack, hidden, qkv_loc, dtype=dtype,
                           device=device)
        self.wo = weight(*stack, self.h_loc * head_dim, hidden, dtype=dtype,
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

    def _project_qkv(self, x):
        """World 1: x (M, hidden) @ wqkv.  World W: x (W, M/W, hidden) ->
        every rank's (W, M, qkv_loc) (JAX `_project_qkv`)."""
        if self.world_size == 1:
            return torch.matmul(x, self.wqkv)
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.wqkv.requires_grad):
            require_ported(self.world_size, "grad")
        return ag_gemm(x, self.wqkv, AllGatherGEMMContext(
            "tp", self.world_size, collective_method(self.mode),
            collective_id=cids.TP_ATTN_QKV))

    def _qkv_heads(self, x, batch: int, seq: int):
        """x (B*S, hidden), or at world W (W, B*S/W, hidden) -> q (B, H, S,
        D), k/v (B, Hkv, S, D) in the global head order, normed."""
        d = self.head_dim
        if self.world_size == 1:
            qkv = self._project_qkv(x).view(batch, seq, -1)
            q, k, v = torch.split(
                qkv, [self.num_heads * d, self.num_kv_heads * d,
                      self.num_kv_heads * d], dim=-1)
            q = q.reshape(batch, seq, self.num_heads, d).transpose(1, 2)
            k = k.reshape(batch, seq, self.num_kv_heads, d).transpose(1, 2)
            v = v.reshape(batch, seq, self.num_kv_heads, d).transpose(1, 2)
        else:
            # (W, B, S, heads_loc, D) per rank -> (B, W * heads_loc, S, D):
            # rank r's heads are the global heads r * heads_loc ..
            w = self.world_size
            qkv = self._project_qkv(x).view(w, batch, seq, -1, d)
            q, k, v = (t.permute(1, 0, 3, 2, 4).reshape(batch, -1, seq, d)
                       for t in torch.split(
                           qkv, [self.h_loc, self.hkv_loc, self.hkv_loc],
                           dim=3))
        if self.qk_norm:
            q = rms_norm(q, self.q_norm)
            k = rms_norm(k, self.k_norm)
        return q, k, v

    def _out_proj(self, attn):
        """attn (M, H D) in the global head order -> (M, hidden); at world
        W -> (W, M/W, hidden), rank r's rows of the sum over the ranks' head
        shards (JAX `_out_proj`)."""
        if self.world_size == 1:
            return torch.matmul(attn, self.wo)
        w, m = self.world_size, attn.shape[0]
        attn = attn.view(m, w, -1).transpose(0, 1).contiguous()
        return gemm_rs(attn, self.wo, GEMMReduceScatterContext(
            "tp", w, collective_method(self.mode),
            collective_id=cids.TP_ATTN_OUT))

    def prefill(self, x, batch: int):
        """x: (B*S, hidden), at world W (W, B*S/W, hidden).  Returns (out
        like x, (k, v)) with k/v (B, Hkv, S, D) for the cache.  At world 1
        differentiable; without a gradient to compute it launches K1 alone
        and saves nothing."""
        m = x.shape[0] if self.world_size == 1 else x.shape[0] * x.shape[1]
        seq = m // batch
        q, k, v = self._qkv_heads(x, batch, seq)
        cos, sin = rope_cos_sin(torch.arange(seq, device=x.device),
                                self.head_dim, self.rope_theta)
        q = apply_rope(q, cos, sin).contiguous()
        k = apply_rope(k, cos, sin).contiguous()
        v = v.contiguous()
        attn = flash_attention_diff(q, k, v, causal=True)
        attn = attn.transpose(1, 2).reshape(m, -1)
        return self._out_proj(attn), (k, v)

    def _decode_qkv(self, x, offset):
        """x: (B, hidden), at world W (W, B/W, hidden), at positions
        ``offset`` ((B,) int32) -> q (B, H, D) contiguous, k/v (B, Hkv, D),
        normed and rotated."""
        b = offset.shape[0]
        q, k, v = self._qkv_heads(x, b, 1)              # (B, *, 1, D)
        cos, sin = rope_cos_sin(offset, self.head_dim, self.rope_theta)
        c = cos[:, None, None, :]                       # (B, 1, 1, D/2)
        s = sin[:, None, None, :]

        def rope_rows(t):
            d2 = t.shape[-1] // 2
            t1, t2 = t[..., :d2], t[..., d2:]
            return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s],
                             dim=-1).to(t.dtype)

        q = rope_rows(q).reshape(b, self.num_heads, self.head_dim)
        return q.contiguous(), rope_rows(k)[:, :, 0], v[:, :, 0]

    def decode(self, x, kv_cache, offset, kv_scales=None):
        """One position per row.  x: (B, hidden), at world W (W, B/W,
        hidden); kv_cache: (k_cache,
        v_cache), each (B, Hkv, S_max, D), written IN PLACE at each row's
        ``offset`` ((B,) int32) before attention reads ``offset + 1``
        positions.  With ``kv_scales`` ((k_scale, v_scale), each
        (B, Hkv, S_max) f32) the cache is int8 and the new token is
        quantized on write.  Returns out like x."""
        b = kv_cache[0].shape[0]
        q, k, v = self._decode_qkv(x, offset)
        idx = (torch.arange(b, device=x.device), slice(None), offset.long())
        write_kv(kv_cache, kv_scales, idx, k, v)
        out, _ = flash_decode(q, *kv_cache, offset + 1,
                              **_scale_kwargs(kv_scales))
        return self._out_proj(out.reshape(b, -1))

    def decode_paged(self, x, kv_pools, page_table, offset, kv_scales=None):
        """`decode` over a page pool (port of `TPAttention.decode_paged`).
        kv_pools: (k_pool, v_pool), each (P, Hkv, page, D); page_table:
        (B, T) int32.  The new K/V goes IN PLACE to row ``offset % page``
        of page ``page_table[b, offset // page]`` (a masked row's
        null-mapped write lands in the trash page 0), then attention reads
        ``offset + 1`` positions through the table.  With ``kv_scales``
        ((P, Hkv, page) f32 scale pools) the pools are int8 and the new
        token's scales go to ``[page, :, offset % page]``.  Returns out
        like x."""
        b = offset.shape[0]
        ps = kv_pools[0].shape[2]
        q, k, v = self._decode_qkv(x, offset)
        pos = offset.long()
        rows = torch.arange(b, device=x.device)
        idx = (page_table[rows, pos // ps].long(), slice(None), pos % ps)
        write_kv(kv_pools, kv_scales, idx, k, v)
        out, _ = flash_decode_paged(q, *kv_pools, page_table, offset + 1,
                                    **_scale_kwargs(kv_scales))
        return self._out_proj(out.reshape(b, -1))


def _scale_kwargs(kv_scales):
    if kv_scales is None:
        return {}
    return {"k_scale": kv_scales[0], "v_scale": kv_scales[1]}
