"""Flash-decode: one-position GQA attention over a dense KV cache or a
paged KV pool, masked by each row's filled length.

Port of `triton_distributed_tpu/kernels/flash_decode.py` `flash_decode`
(Pallas `_decode_kernel`) and `flash_decode_paged` (`_paged_decode_kernel`)
as the hand-written CUDA kernels ``csrc/flash_decode.cu`` and
``csrc/flash_decode_paged.cu``, which share one body
(``csrc/decode_body.cuh``) and so agree bit for bit on the same logical
K/V.  The body splits each row's cache into chunks of `DECODE_CHUNK`
positions, one block each, and combines a row's chunks in order inside the
same launch, so a row's result does not depend on the other rows of the
batch.  Both take a float cache or an int8 one with per-token f32 scales
(``k_scale``/``v_scale``, from `quantize_kv`): the K scale multiplies the
scores, the V scale the softmax weights.

The sequence-parallel forms, `sp_flash_decode` and `sp_flash_decode_paged`
(JAX :416, :440), hold the KV cache split over W ranks along the sequence
(`parallel.mesh`: rank-stacked shards), run the local kernel over every
rank's shard in ONE launch (the ranks as extra batch rows), gather each
rank's packed (out, lse) with one K15 push all-gather, and combine them
with LSE weights in plain torch (`combine_partials`, JAX :352; the JAX
combine is `jnp` code, outside Pallas).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version (`flash_decode_reference`,
`flash_decode_paged_reference`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.allgather import (
    AllGatherContext, AllGatherMethod, all_gather)
from triton_distributed_tpu_torch.kernels.quantized import quantize_sym

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_decode": [_P] * 10 + [_I] * 7 + [_F, _P],
}
_PAGED_SIGNATURES = {
    "flash_decode_paged": [_P] * 11 + [_I] * 9 + [_F, _P],
}

#: Positions per chunk of the decode kernels (``DECODE_CH`` of
#: ``csrc/decode_body.cuh``, which refuses any other value): each (row, KV
#: head) is cut into chunks of this many positions, one block each.
DECODE_CHUNK = 128

#: (device index, stream) -> the kernels' int32 counters, one per (row, KV
#: head), zero between calls (the block that combines a row resets its own).
_COUNTERS: dict = {}


def quantize_kv(k, v):
    """Per-token symmetric int8 quantization of a KV cache (amax over D):
    returns (k_q, v_q int8, k_scale, v_scale f32 (B, Hkv, S))."""
    k_q, ks = quantize_sym(k, 3)
    v_q, vs = quantize_sym(v, 3)
    return k_q, v_q, ks, vs


def write_kv(caches, scales, idx, k, v) -> None:
    """Write new K/V rows, k/v (N, Hkv, D), IN PLACE into ``caches``
    (k_cache, v_cache) at ``idx``, an index over their (row or page,
    head, position) dims.  With ``scales`` (k_scale, v_scale) the caches
    are int8: the rows are quantized per token first (`quantize_kv`) and
    their scales written at the same index."""
    if scales is not None:
        k, v, k_scale, v_scale = quantize_kv(k[:, :, None], v[:, :, None])
        k, v = k[:, :, 0], v[:, :, 0]
        scales[0][idx] = k_scale[:, :, 0]
        scales[1][idx] = v_scale[:, :, 0]
    caches[0][idx] = k.to(caches[0].dtype)
    caches[1][idx] = v.to(caches[1].dtype)


def flash_decode_reference(q, k_cache, v_cache, kv_len, *,
                           k_scale=None, v_scale=None,
                           scale: Optional[float] = None):
    """Dense decode attention in f32.  q: (B, H, D); caches (B, Hkv, S, D),
    float, or int8 with ``k_scale``/``v_scale`` (B, Hkv, S); kv_len: (B,)
    int.  Returns out (B, H, D) in q's dtype, lse (B, H) f32.

    Int8, as the TPU kernel (`_decode_kernel` :76-103): the K scale
    multiplies the scores after ``scale``, the softmax normalises the
    unscaled weights, and the V scale multiplies the weights.  Scales at
    positions >= kv_len may be stale or NaN (a reused slot, the null
    page): those scores are masked before the softmax and those V scales
    zeroed, so they never reach the result."""
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < kv_len.to(q.device)[:, None]          # (B, S)
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, None, :]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        p = p * torch.where(valid[:, None, :], v_scale.float(),
                            0.0)[:, :, None, :]
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    lse = torch.logsumexp(scores, dim=-1)
    return out.reshape(b, h, d).to(q.dtype), lse.reshape(b, h)


def gather_pages(pool, page_table):
    """The logical (B, Hkv, T*page, ...) view of a (P, Hkv, page, ...) pool
    (K/V pages, or their scales without the trailing D) through a (B, T)
    page table (a copy)."""
    b, t = page_table.shape
    _, hkv, ps = pool.shape[:3]
    g = pool[page_table.long()]                   # (B, T, Hkv, page, ...)
    return g.transpose(1, 2).reshape(b, hkv, t * ps, *pool.shape[3:])


def flash_decode_paged_reference(q, k_pool, v_pool, page_table, kv_len, *,
                                 k_scale=None, v_scale=None,
                                 scale: Optional[float] = None):
    """Paged decode attention in f32: gather the pools (and the scale
    pools) into logical order through the table, then
    `flash_decode_reference`."""
    def gathered(x):
        return None if x is None else gather_pages(x, page_table)

    return flash_decode_reference(
        q, gathered(k_pool), gathered(v_pool), kv_len,
        k_scale=gathered(k_scale), v_scale=gathered(v_scale), scale=scale)


def flash_decode(q, k_cache, v_cache, kv_len, *, k_scale=None, v_scale=None,
                 scale: Optional[float] = None):
    """q: (B, H, D); k_cache, v_cache: (B, Hkv, S, D); kv_len: (B,) int32
    filled lengths (<= S).  With ``k_scale``/``v_scale`` ((B, Hkv, S) f32,
    from `quantize_kv`) the caches are int8.  Returns (out (B, H, D), lse
    (B, H) f32).

    The kernel takes contiguous bf16 or f32 q, a cache of q's dtype or
    int8 with both scales, D in {64, 128} and H/Hkv in {1, 2, 4, 8};
    anything else raises.  Each kernel launch adds one to
    ``flash_decode.launches`` (float cache) or
    ``flash_decode.int8_launches`` (int8 cache)."""
    if q.device.type == "cpu":
        return flash_decode_reference(q, k_cache, v_cache, kv_len,
                                      k_scale=k_scale, v_scale=v_scale,
                                      scale=scale)
    _check("flash_decode", q, k_cache, v_cache, kv_len, k_scale, v_scale)
    if k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"flash_decode: cache batch {k_cache.shape[0]} != "
                         f"q batch {q.shape[0]}")
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    if out.numel():
        lib = _build.load_library("flash_decode", _SIGNATURES)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part, cnt = _split_scratch(q, hkv, s, stream)
        rc = lib.flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), kv_len.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _ptr(part), _ptr(cnt),
            _build.DTYPE_CODES[q.dtype], b, h, hkv, s, d, DECODE_CHUNK,
            float(scale), stream)
        _build.check(lib, rc, "flash_decode kernel launch")
        if k_scale is None:
            flash_decode.launches += 1
        else:
            flash_decode.int8_launches += 1
    return out, lse


flash_decode.launches = 0
flash_decode.int8_launches = 0


def flash_decode_paged(q, k_pool, v_pool, page_table, kv_len, *,
                       k_scale=None, v_scale=None,
                       scale: Optional[float] = None):
    """q: (B, H, D); k_pool, v_pool: (P, Hkv, page, D) shared by all rows;
    page_table: (B, T) int32, logical page j of row b in physical page
    ``page_table[b, j]``; kv_len: (B,) int32 filled lengths (<= T*page).
    With ``k_scale``/``v_scale`` ((P, Hkv, page) f32 pools) the pools are
    int8.  Only positions below kv_len are read, so pages at or past it may
    map to the null page.  Returns (out (B, H, D), lse (B, H) f32).

    Same dtypes, D and H/Hkv as `flash_decode`, any page size >= 1;
    anything else raises.  Each kernel launch adds one to
    ``flash_decode_paged.launches`` (float pools) or
    ``flash_decode_paged.int8_launches`` (int8 pools)."""
    if q.device.type == "cpu":
        return flash_decode_paged_reference(
            q, k_pool, v_pool, page_table, kv_len, k_scale=k_scale,
            v_scale=v_scale, scale=scale)
    _check("flash_decode_paged", q, k_pool, v_pool, kv_len, k_scale,
           v_scale)
    b, h, d = q.shape
    p, hkv, ps, _ = k_pool.shape
    if (page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != b or page_table.shape[1] < 1
            or page_table.device != q.device
            or not page_table.is_contiguous()):
        raise ValueError("flash_decode_paged: page_table must be a "
                         "contiguous (B, T) int32 tensor on q's device, "
                         f"got {page_table.dtype} {tuple(page_table.shape)}")
    t = page_table.shape[1]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    if out.numel():
        lib = _build.load_library("flash_decode_paged", _PAGED_SIGNATURES)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part, cnt = _split_scratch(q, hkv, t * ps, stream)
        rc = lib.flash_decode_paged(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(part),
            _ptr(cnt), _build.DTYPE_CODES[q.dtype], b, h, hkv, p, ps, t, d,
            DECODE_CHUNK, float(scale), stream)
        _build.check(lib, rc, "flash_decode_paged kernel launch")
        if k_scale is None:
            flash_decode_paged.launches += 1
        else:
            flash_decode_paged.int8_launches += 1
    return out, lse


flash_decode_paged.launches = 0
flash_decode_paged.int8_launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _split_scratch(q, hkv, capacity, stream):
    """The scratch of a kernel call over ``capacity`` positions a row: f32
    partials, G * (D + 2) a (row, KV head, chunk), and the counters, or
    (None, None) when one chunk holds every row.  The counters are kept per
    device and stream (zeroed once, reset by the kernel), so calls on one
    stream share them in order and two streams never do."""
    chunks = -(-capacity // DECODE_CHUNK)
    if chunks <= 1:
        return None, None
    b, h, d = q.shape
    part = torch.empty(b * h * chunks * (d + 2), dtype=torch.float32,
                       device=q.device)
    key = (q.device.index, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < b * hkv:
        cnt = torch.zeros(max(b * hkv, 1024), dtype=torch.int32,
                          device=q.device)
        _COUNTERS[key] = cnt
    return part, cnt


def _check(name, q, k, v, kv_len, k_scale, v_scale):
    """Checks shared by both kernels: q (B, H, D) against 4-d K/V (dense
    cache or page pool) whose dims 1 and 3 are Hkv and D; K/V of q's dtype,
    or int8 with f32 scales of K/V's first three dims."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, h, d = q.shape
    hkv = k.shape[1]
    if k.shape[3] != d or h % hkv or min(k.shape) < 1:
        raise ValueError(f"{name}: q{tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if d not in (64, 128) or h // hkv not in (1, 2, 4, 8):
        raise ValueError(f"{name}: head_dim {d} / group {h // hkv} "
                         "not supported (64 or 128; 1, 2, 4 or 8)")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    cache_dtype = q.dtype if k_scale is None else torch.int8
    for nm, t in (("k", k), ("v", v)):
        if t.dtype != cache_dtype:
            raise ValueError(f"{name}: {nm} is {t.dtype}; with q {q.dtype} "
                             f"and {'' if k_scale is None else 'k/v scales, '}"
                             f"the cache must be {cache_dtype}")
    for nm, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != k.shape[:3]
                              or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {nm} must be a contiguous float32 "
                             f"tensor of shape {tuple(k.shape[:3])} on "
                             f"q's device")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, q is on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} is not contiguous and 16-byte "
                             "aligned")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not in "
                         "(bfloat16, float32)")
    if (kv_len.dtype != torch.int32 or kv_len.shape != (b,)
            or kv_len.device != q.device or not kv_len.is_contiguous()):
        raise ValueError(f"{name}: kv_len must be a contiguous (B,) int32 "
                         "tensor on q's device")


# ---- sequence-parallel decode --------------------------------------------

def combine_partials(outs, lses):
    """LSE-weighted combine of per-shard decode partials (JAX
    `combine_partials`): outs (R, ..., D), lses (R, ...) -> (..., D).

    An empty shard (lse about -inf) may carry garbage partials, so its out
    is zeroed by its OWN lse: not by the relative weight (when every shard
    is empty each weight is exp(0) = 1 and the garbage would pass) and not
    by finiteness (a live shard's NaN must propagate)."""
    m = lses.max(0, keepdim=True).values
    w = torch.exp(lses - m)
    denom = w.sum(0)
    outs = torch.where((lses > NEG_INF / 2)[..., None], outs,
                       torch.zeros((), dtype=outs.dtype, device=outs.device))
    num = (w[..., None] * outs.float()).sum(0)
    return (num / denom.clamp_min(1e-30)[..., None]).to(outs.dtype)


def _sp_gather_combine(out, lse, kv_len_local, q, axis: str,
                       collective_id: int):
    """The distributed tail of both SP decodes (JAX `_sp_gather_combine`):
    empty shards' lse set to -inf, each rank's (out, lse) packed into one
    f32 row of D + 1 values padded to 16 bytes (the kernel's copy unit; the
    JAX package pads to 128 lanes for Mosaic), one K15 push all-gather, the
    combine.  out (W, B, H, D), lse (W, B, H), kv_len_local (W, B) ->
    (W, B, H, D) in q's dtype, every rank's copy."""
    world, b, h, d = out.shape
    lse = torch.where(kv_len_local[..., None] > 0, lse,
                      torch.full((), NEG_INF, device=lse.device))
    dp = (d + 1 + 3) // 4 * 4
    payload = torch.zeros((world, b * h, dp), dtype=torch.float32,
                          device=out.device)
    payload[..., :d] = out.float().reshape(world, b * h, d)
    payload[..., d] = lse.reshape(world, b * h)
    ctx = AllGatherContext(axis, world, AllGatherMethod.PUSH_ALL,
                           collective_id)
    gathered = all_gather(payload, ctx)          # (W, W * B * H, dp)
    g = gathered.reshape(world, world, b, h, dp).transpose(0, 1)
    return combine_partials(g[..., :d], g[..., d]).to(q.dtype)


def sp_flash_decode(q, k_shard, v_shard, kv_len_local, axis: str = "sp", *,
                    k_scale=None, v_scale=None,
                    scale: Optional[float] = None,
                    collective_id: int = cids.FLASH_DECODE_AG):
    """Sequence-parallel decode over the W ranks of ``axis`` (JAX
    `sp_flash_decode`).  q (B, H, D), replicated; k_shard, v_shard (W, B,
    Hkv, S_loc, D): rank r's shard of every row's cache, float, or int8
    with ``k_scale``/``v_scale`` (W, B, Hkv, S_loc); kv_len_local (W, B)
    int32: the positions of rank r's shard that are filled.  Returns (W, B,
    H, D): every rank's copy of the combined output.

    One launch of the decode kernel (K2, or K2q with an int8 cache) over
    every rank's shard, then one K15 launch: `flash_decode` and
    `all_gather` count them."""
    world, b = k_shard.shape[:2]
    qq = q.unsqueeze(0).expand(world, *q.shape).reshape(world * b,
                                                        *q.shape[1:])

    def rows(t):
        return None if t is None else t.reshape(world * b, *t.shape[2:])

    out, lse = flash_decode(qq.contiguous(), rows(k_shard), rows(v_shard),
                            rows(kv_len_local), k_scale=rows(k_scale),
                            v_scale=rows(v_scale), scale=scale)
    return _sp_gather_combine(out.reshape(world, *q.shape),
                              lse.reshape(world, *q.shape[:2]),
                              kv_len_local, q, axis, collective_id)


def sp_flash_decode_paged(q, k_pool, v_pool, page_table, kv_len_local,
                          axis: str = "sp", *, k_scale=None, v_scale=None,
                          scale: Optional[float] = None,
                          collective_id: int = cids.FLASH_DECODE_AG):
    """Sequence-parallel decode over paged shards (JAX
    `sp_flash_decode_paged`): rank r holds a pool k_pool[r], v_pool[r] (W,
    P, Hkv, page, D) (int8 with ``k_scale``/``v_scale`` (W, P, Hkv, page))
    and a table page_table[r] (W, B, T) int32 of its own pages covering its
    kv_len_local[r] (W, B) positions.  Returns (W, B, H, D) as
    `sp_flash_decode`.

    One launch of the paged kernel (K3, or K3q) over every rank's pool (the
    pools stacked into one, each rank's table offset by its first page),
    then one K15 launch."""
    world, p = k_pool.shape[:2]
    b = page_table.shape[1]
    qq = q.unsqueeze(0).expand(world, *q.shape).reshape(world * b,
                                                        *q.shape[1:])
    first = torch.arange(world, dtype=torch.int32,
                         device=page_table.device) * p
    table = (page_table + first[:, None, None]).reshape(world * b, -1)

    def pool(t):
        return None if t is None else t.reshape(world * p, *t.shape[2:])

    out, lse = flash_decode_paged(
        qq.contiguous(), pool(k_pool), pool(v_pool), table.contiguous(),
        kv_len_local.reshape(world * b), k_scale=pool(k_scale),
        v_scale=pool(v_scale), scale=scale)
    return _sp_gather_combine(out.reshape(world, *q.shape),
                              lse.reshape(world, *q.shape[:2]),
                              kv_len_local, q, axis, collective_id)
