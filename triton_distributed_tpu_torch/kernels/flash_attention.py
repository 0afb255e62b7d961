"""Flash attention for prefill and training: causal GQA attention with an
optional ``kv_offset`` shift of the diagonal and a natural-log lse, and its
backward.

Port of `triton_distributed_tpu/kernels/flash_attention.py`.  The forward
`flash_attention` (its three Pallas kernels `_flash_kernel_single_diag`,
`_flash_kernel_packed` and `_flash_kernel` are schedules of one function)
is one hand-written CUDA kernel, K1 (``csrc/flash_attention.cu``).  The
backward `flash_attention_backward` (`_flash_backward`: `_flash_bwd_dq_kernel`
and `_flash_bwd_dkv_kernel`) is two, K4 (dq) and K5 (dk, dv), in
``csrc/flash_attention_bwd.cu``; `flash_attention_diff` joins them in a
`torch.autograd.Function`.  In bf16 both run warp-specialised `wgmma` + TMA
bodies over persistent blocks that take their items heaviest first
(`bwd_items` writes that order in plain Python); f32 runs the CUDA-core
kernels.

On a CUDA tensor each wrapper launches its kernels or raises; on a CPU
tensor it computes the plain version (`flash_attention_reference`,
`flash_attention_backward_reference`).
"""

from __future__ import annotations

import ctypes
import operator
from typing import Optional

import torch

from triton_distributed_tpu_torch.kernels import _build

NEG_INF = -1e30
LN2 = 0.6931471805599453
#: lse at or below this marks a fully masked row (the JAX kernels' test).
LSE_DEAD = NEG_INF * (LN2 / 2)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _P],
}
_BWD_SIGNATURES = {
    "flash_attention_bwd_dq": [_P] * 9 + [_I] * 9 + [_F, _P],
    "flash_attention_bwd_dkv": [_P] * 8 + [_I] * 9 + [_F, _P],
    "flash_attention_bwd_hopper_launches": [],
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


#: K4's item: (query rows, keys of a K/V stage); K5's: (keys, query rows
#: of a Q/dO stage).  The bf16 bodies' tiles (csrc/flash_attention_bwd.cu
#: `Dq`, `Dkv`).  K4's two consumer warpgroups split an item's rows and
#: share its stages; K5's share its keys and take its stages in turn.
BWD_DQ_TILE = (128, 64)
BWD_DKV_TILE = (64, 64)


def bwd_items(which: str, b: int, h: int, hkv: int, sq: int, sk: int,
              causal: bool = True, kv_offset: int = 0) -> list[tuple]:
    """The items of K4 (``which="dq"``) or K5 (``"dkv"``) in the order the
    bf16 bodies number them, which persistent blocks take in a snake
    (`snake`), heaviest first.  Each is (batch, head, first row, stages):
    - dq: (b, query head, first query row of 128, the K/V stages of 64 keys
      up to the causal limit of the tile's last row); item it is query tile
      nqt - 1 - it // (B H) of (batch, head) it % (B H);
    - dkv: (b, KV head, first key of 64, the Q/dO stages: each query head
      of the group times the visible query tiles of 64 rows); item it is
      key tile it // (B Hkv) of (batch, KV head) it % (B Hkv).
    The kernels compute the same counts (`Dq::item`, `Dkv::item`)."""
    if which == "dq":
        rows, keys = BWD_DQ_TILE
        nqt = -(-sq // rows)
        out = []
        for it in range(nqt * b * h):
            bh, qt = it % (b * h), nqt - 1 - it // (b * h)
            q0 = qt * rows
            last = min(q0 + rows, sq) - 1
            if not causal:
                n = -(-sk // keys)
            else:
                last_k = min(last + kv_offset, sk - 1)
                n = 0 if last_k < 0 else last_k // keys + 1
            out.append((bh // h, bh % h, q0, n))
        return out
    if which != "dkv":
        raise ValueError(f"bwd_items: which {which!r} not in ('dq', 'dkv')")
    keys, rows = BWD_DKV_TILE
    group, nkt, nq = h // hkv, -(-sk // keys), -(-sq // rows)
    out = []
    for it in range(nkt * b * hkv):
        bhk, k0 = it % (b * hkv), it // (b * hkv) * keys
        qt0, n_q = 0, nq
        if causal:
            first = k0 - kv_offset  # the first query row that sees k0
            qt0 = max(first, 0) // rows
            n_q = 0 if first > sq - 1 else nq - qt0
        out.append((bhk // hkv, bhk % hkv, k0, group * n_q))
    return out


def snake(n_items: int, blocks: int) -> list[list[int]]:
    """The items each of ``blocks`` persistent blocks takes, in order: in
    round r block j takes item r * P + j, or r * P + P - 1 - j in odd
    rounds (csrc `item_of`), so with the items heaviest first every
    block's sum of work is about even."""
    taken = [[] for _ in range(blocks)]
    for r in range(-(-n_items // blocks)):
        for j in range(blocks):
            it = r * blocks + (blocks - 1 - j if r % 2 else j)
            if it < n_items:
                taken[j].append(it)
    return taken


def bwd_balance(which: str, b: int, h: int, hkv: int, sq: int, sk: int,
                causal: bool = True, kv_offset: int = 0,
                sms: int = 132) -> tuple[int, float]:
    """(the stage times of the busiest block, the mean over the blocks) for
    one launch of K4 or K5 on ``sms`` SMs (one block each at most): the
    critical path of the schedule against its mean.  A K4 stage keeps both
    consumer warpgroups busy; K5's warpgroups take an item's stages in
    turn, so an item of n stages takes ceil(n / 2) stage times."""
    items = bwd_items(which, b, h, hkv, sq, sk, causal, kv_offset)
    blocks = min(len(items), sms)
    cost = ((lambda n: n) if which == "dq" else (lambda n: -(-n // 2)))
    per = [sum(cost(items[it][3]) for it in taken)
           for taken in snake(len(items), blocks)]
    return max(per), sum(per) / blocks


def flash_attention_backward_reference(q, k, v, out, lse, do, dlse=None, *,
                                       causal: bool = True,
                                       scale: Optional[float] = None,
                                       kv_offset: int = 0):
    """The plain version of the backward, in f32, with the JAX package's
    contract (`_flash_backward`): delta = rowsum(do * out) - dlse,
    p = exp(s - lse) (0 on the rows whose lse is at the fully masked
    sentinel, and on masked columns), ds = p * (do v^T - delta),
    dq = scale ds k, dk = scale ds^T q, dv = p^T do, dk/dv summed over each
    GQA group.  Returns (dq, dk, dv) in q's, k's and v's dtypes.

    Not autograd through `flash_attention_reference`: that gives a fully
    masked row a uniform softmax, whose gradient would leak."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    live = (lse > LSE_DEAD)[..., None]                      # (b, h, sq, 1)
    delta = (dof * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    keep = live
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + kv_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        keep = keep & (kpos <= qpos)
    p = torch.where(keep, torch.exp(torch.clamp(s - lse[..., None], max=0.0)),
                    0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    # A select, not a product: delta is NaN on a dead row whose out is.
    ds = torch.where(live, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, hkv, group, sk, d).sum(2)
    dv = dv.reshape(b, hkv, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(q, k, v, out, lse, do, dlse=None, *,
                             causal: bool = True,
                             scale: Optional[float] = None,
                             kv_offset: int = 0):
    """Gradients (dq, dk, dv) of `flash_attention`'s (out, lse) for the
    cotangents ``do`` (like out) and ``dlse`` (like lse, or None).  ``out``
    and ``lse`` are the forward's.  K4 forms delta = rowsum(do * out) -
    dlse (XLA code in the JAX package) in its prologue and computes dq; K5
    reads that delta and computes dk, dv.  K4 adds one to
    ``flash_attention_backward.dq_launches``, K5 one to ``.dkv_launches``,
    and the pair one to ``.launches``; a pair whose kernels both reported
    their bf16 bodies (the Hopper ``wgmma`` + TMA ones, which bf16 inputs
    take; f32 takes the CUDA-core kernels, and nothing falls back) one to
    ``.wgmma_launches``.  The kernels take what K1 takes (contiguous bf16
    or f32, D in {64, 128}; lse, dlse f32); anything else raises."""
    kv_offset = operator.index(kv_offset)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, lse, do, dlse, causal=causal, scale=scale,
            kv_offset=kv_offset)
    b, h, sq, d = _check(q, k, v)
    for name, t in (("out", out), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention_backward: {name} must be a "
                             f"contiguous {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}")
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and (t.shape != (b, h, sq)
                              or t.dtype != torch.float32
                              or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"flash_attention_backward: {name} must be a "
                             f"contiguous f32 {(b, h, sq)} on {q.device}")
    scale = scale if scale is not None else d ** -0.5
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    hopper = _launch_bwd("dq", (q, k, v, do, out, lse, dlse, delta, dq),
                         causal, kv_offset, scale)
    flash_attention_backward.dq_launches += 1
    hopper &= _launch_bwd("dkv", (q, k, v, do, lse, delta, dk, dv), causal,
                          kv_offset, scale)
    flash_attention_backward.dkv_launches += 1
    flash_attention_backward.launches += 1
    if hopper:
        flash_attention_backward.wgmma_launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.dq_launches = 0
flash_attention_backward.dkv_launches = 0
flash_attention_backward.wgmma_launches = 0


def _launch_bwd(which, tensors, causal, kv_offset, scale):
    """Launch K4 (``which="dq"``; tensors q, k, v, do, out, lse, dlse or
    None, delta (written), dq) or K5 (``"dkv"``; q, k, v, do, lse, delta,
    dk, dv) on checked CUDA tensors; counts nothing.  Returns whether the
    C entry launched its bf16 (Hopper) body."""
    q, k = tensors[:2]
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    lib = _build.load_library("flash_attention_bwd", _BWD_SIGNATURES)
    before = lib.flash_attention_bwd_hopper_launches()
    rc = getattr(lib, f"flash_attention_bwd_{which}")(
        *(None if t is None else t.data_ptr() for t in tensors),
        _build.DTYPE_CODES[q.dtype], b, h, hkv, sq, sk, d, int(causal),
        kv_offset, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, f"flash_attention_bwd_{which} kernel launch")
    return lib.flash_attention_bwd_hopper_launches() > before


class _FlashAttentionFn(torch.autograd.Function):
    """K1 forward (out, lse); K4/K5 backward, the lse cotangent folded into
    delta.  ``kv_offset``, ``causal`` and ``scale`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_offset, causal, scale):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_offset=kv_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, scale=scale, kv_offset=kv_offset)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        # The cotangent of out arrives through a transpose and reshape: make
        # it contiguous for the kernels.
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        if dlse is not None:
            dlse = dlse.contiguous()
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, dlse,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_diff(q, k, v, kv_offset: int = 0, *, causal: bool = True,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Differentiable `flash_attention` (the training path; JAX
    `flash_attention_diff`): the same forward, K1, with K4/K5 as its
    backward.  With ``return_lse`` the lse is differentiable too (its
    cotangent folds into delta).  When no gradient is needed (grad mode
    off, or no input requires one) this is `flash_attention` itself and
    saves nothing.  JAX's ``block_q``/``block_k`` are TPU tiling knobs and
    have no counterpart here.  Returns (B, H, Sq, D) [, lse (B, H, Sq)]."""
    kv_offset = operator.index(kv_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttentionFn.apply(q, k, v, kv_offset, causal, scale)
    else:
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_offset=kv_offset, return_lse=True)
    return (out, lse) if return_lse else out
