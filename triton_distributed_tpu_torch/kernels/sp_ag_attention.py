"""Sequence-parallel causal attention for long-context prefill and ring
training (port of `triton_distributed_tpu/kernels/sp_ag_attention.py`).

Every function takes the rank-stacked shards of one sequence
(`parallel.mesh`): q (W, B, H, S_loc, D) and k, v (W, B, Hkv, S_loc, D),
rank r's rows at global rows [r * S_loc, (r + 1) * S_loc) (the JAX
functions' per-device q and k/v shards under `shard_map`), and returns the
rank-stacked (W, B, H, S_loc, D).

- `sp_ag_attention_fused` (JAX :466) is one launch of
  ``csrc/sp_ag_attention.cu`` (K20) over every rank: the KV chunks go round
  a +1 ring inside the kernel (every block's spare warps forward its
  share) while persistent consumers fold each chunk that has arrived into
  their online-softmax state on K1's tile body; chunks in the causal
  future are skipped.  At world 1 it is one K1 (`flash_attention`) with
  ``kv_offset``, as in JAX.  Its plain version,
  `sp_ag_attention_fused_reference`, is the TPU kernel's schedule in f32:
  per rank, chunk by chunk in ring order, a dense attention merged into the
  running (out, lse) by `_merge`, future chunks carried.
- `sp_ring_attention` (:126) and `sp_ring_attention_diff` (:146) run the
  ring schedule of `_ring_attend` (:90) with K1 per step; `_diff` uses
  `flash_attention_diff` (K1 forward, K4/K5 backward) and autograd through
  `_merge`, the lse cotangent included.
- `sp_ring_attention_zigzag` (:662) runs it on the balanced zigzag layout
  (`zigzag_shard` / `zigzag_unshard`, :638 / :653).
- `sp_ag_attention_gather` (:721) gathers the packed K|V with K15's ring
  (`all_gather`), then runs one rectangular K1 a rank.

JAX's `ppermute` between ring steps (XLA's collective, not a Pallas
kernel) is here a rank-axis `torch.roll` of the stacked K and V: a copy,
after which rank r holds rank r - 1's chunk.  The compositions batch the
ranks that share a causal offset into one K1 launch and skip the (rank,
chunk) pairs in the causal future, whose JAX partials are fully masked
(lse ~ -inf) and merge out exactly; so the ring runs W K1 launches (one a
step), the zigzag 3 W and the gather W.  JAX's ``block_q``/``block_k`` are
TPU tiling knobs with no counterpart here.
- `sp_ag_attention_2d` (:568) is the two-level form over a (dcn, ici) mesh
  (`kernels.hierarchical.HierarchicalContext`): dcn steps, each one K20
  launch a slice over the KV chunks the slice holds (slice (d - s) mod dcn
  at step s, placed by ``kv_base``), the steps' partials merged by lse
  with `_merge`, the KV shards hopping one slice along the DCN ring (JAX's
  ``ppermute``, a roll of the stack along the dcn axis) between steps:
  dcn * dcn K20 launches.

On a CUDA tensor K20's wrapper launches the kernel or raises; on a CPU
tensor every kernel underneath runs its plain version.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.allgather import (
    AllGatherContext, AllGatherMethod, all_gather)
from triton_distributed_tpu_torch.kernels.flash_attention import (
    NEG_INF, _check, flash_attention, flash_attention_diff,
    flash_attention_reference)
from triton_distributed_tpu_torch.language.core import (
    fault_args, symmetric_buffers)
from triton_distributed_tpu_torch.parallel.mesh import MAX_WORLD

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"sp_ag_attention_fused": (
    [_P] * 8 + [_I] * 7 + [ctypes.POINTER(_I)] * 2
    + [ctypes.c_float, ctypes.c_uint64, _I, ctypes.c_longlong, _I, _I,
       ctypes.POINTER(_I), _P])}

#: The plain version scores at most this many (query, key) pairs of f32 at
#: a time (heads are taken in groups), so a 32,768-token sequence fits.
_REFERENCE_PAIRS = 1 << 28


def _merge(out_a, lse_a, out_b, lse_b):
    """Combine two online-softmax partials (f32), as JAX's `_merge`: out
    (..., S, D), lse (..., S).  Fully masked rows on both sides (lse ~
    -inf) stay finite."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.clamp_min(m, NEG_INF / 2)
    wa = torch.exp(lse_a - m_safe)
    wb = torch.exp(lse_b - m_safe)
    denom = torch.clamp_min(wa + wb, 1e-30)
    out = (out_a.float() * wa[..., None]
           + out_b.float() * wb[..., None]) / denom[..., None]
    return out, m_safe + torch.log(denom)


def _flat(t):
    """(W, B, ...) -> (W*B, ...): the ranks batched as one kernel batch."""
    return t.reshape(-1, *t.shape[2:])


def _ring_attend(q, k, v, attend_chunk):
    """The causal ring schedule shared by `sp_ring_attention` and its
    differentiable form: every rank attends its own chunk, then for W - 1
    steps the K/V shards move one rank to the right and every rank folds
    the chunk it holds into its running (out, lse) with `_merge`.
    ``attend_chunk(q, k, v, off) -> (out, lse)`` attends rank-batched rows
    (n*B, H, S_loc, D) with the causal shift ``off``; after step s + 1
    ranks r >= s + 1 hold chunk r - s - 1 at shift (s + 1) * S_loc, and
    the others a chunk of their causal future, which they skip."""
    world, b, h, s_loc, d = q.shape
    out, lse = attend_chunk(_flat(q), _flat(k), _flat(v), 0)
    out = out.float().reshape(q.shape)
    lse = lse.reshape(q.shape[:-1])
    kv = (k, v)
    for lo in range(1, world):
        kv = tuple(torch.roll(t, 1, dims=0) for t in kv)
        o_s, l_s = attend_chunk(_flat(q[lo:]), _flat(kv[0][lo:]),
                                _flat(kv[1][lo:]), lo * s_loc)
        o_m, l_m = _merge(out[lo:], lse[lo:], o_s.reshape(q[lo:].shape),
                          l_s.reshape(q[lo:].shape[:-1]))
        out = torch.cat([out[:lo], o_m])
        lse = torch.cat([lse[:lo], l_m])
    return out.to(q.dtype)


def sp_ring_attention(q, k_shard, v_shard, axis: str = "sp", *,
                      scale: Optional[float] = None):
    """Causal ring attention (JAX `sp_ring_attention`): q (W, B, H, S_loc,
    D), k_shard/v_shard (W, B, Hkv, S_loc, D) -> (W, B, H, S_loc, D), one
    K1 launch (`flash_attention` with ``kv_offset``) a ring step."""
    def attend_chunk(q, k_c, v_c, off):
        return flash_attention(q, k_c, v_c, causal=True, scale=scale,
                               kv_offset=off, return_lse=True)

    return _ring_attend(q, k_shard, v_shard, attend_chunk)


def sp_ring_attention_diff(q, k_shard, v_shard, axis: str = "sp", *,
                           scale: Optional[float] = None):
    """Differentiable causal ring attention, the long-context training path
    (JAX `sp_ring_attention_diff`): the ring of `sp_ring_attention` with
    `flash_attention_diff` a step (K1 forward, K4/K5 backward; out and lse
    both differentiable) and the merge in plain tensor code, so autograd
    differentiates the whole ring; the roll's gradient runs the ring
    backwards."""
    def attend_chunk(q, k_c, v_c, off):
        return flash_attention_diff(q, k_c, v_c, off, causal=True,
                                    scale=scale, return_lse=True)

    return _ring_attend(q, k_shard, v_shard, attend_chunk)


def _offsets(value, default, world: int, name: str):
    """Per-rank ints from None (``default``, a list), an int (every rank)
    or W values."""
    if value is None:
        return list(default)
    if isinstance(value, torch.Tensor):
        value = value.tolist()
    if isinstance(value, (list, tuple)):
        if len(value) != world:
            raise ValueError(f"{name}: {len(value)} values for world {world}")
        return [operator.index(x) for x in value]
    return [operator.index(value)] * world


def sp_ag_attention_fused_reference(q, k, v, q_offset=None, kv_base=0,
                                    scale: Optional[float] = None):
    """The plain version of `sp_ag_attention_fused`, the TPU kernel's
    schedule in f32: for each rank r, chunk c = (r - s) mod W for s = 0 ..
    W-1 at causal shift off = q_off[r] - (kv_base[r] + c * S_loc); a chunk
    with off <= -S_loc (its first key after the rank's last query) is
    skipped (its state carried, or zeros and lse -inf first); the others'
    dense attention (`flash_attention_reference` in f32, heads taken in
    groups to bound the scores' memory) merged into the running (out, lse)
    with `_merge`.  Returns (out in q's dtype, lse f32), rank-stacked."""
    world, b, h, s_loc, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    q_off = _offsets(q_offset, [r * s_loc for r in range(world)], world,
                     "q_offset")
    base = _offsets(kv_base, [0] * world, world, "kv_base")
    step = max(group, _REFERENCE_PAIRS // max(b * s_loc * s_loc, 1)
               // group * group)

    def attend(r, c, off):
        outs, lses = [], []
        for h0 in range(0, h, step):
            h1 = min(h, h0 + step)
            o, l = flash_attention_reference(
                q[r, :, h0:h1].float(), k[c, :, h0 // group:h1 // group]
                .float(), v[c, :, h0 // group:h1 // group].float(),
                causal=True, scale=scale, kv_offset=off, return_lse=True)
            outs.append(o)
            lses.append(l)
        return torch.cat(outs, dim=1), torch.cat(lses, dim=1)

    outs, lses = [], []
    for r in range(world):
        out = lse = None
        for s in range(world):
            c = (r - s) % world
            off = q_off[r] - (base[r] + c * s_loc)
            if off <= -s_loc:
                if out is None:
                    out = q.new_zeros((b, h, s_loc, d), dtype=torch.float32)
                    lse = q.new_full((b, h, s_loc), NEG_INF,
                                     dtype=torch.float32)
                continue
            o_c, l_c = attend(r, c, off)
            out, lse = ((o_c, l_c) if out is None
                        else _merge(out, lse, o_c, l_c))
        outs.append(out.to(q.dtype))
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def sp_ag_attention_fused(q, k_shard, v_shard, axis: str = "sp", *,
                          scale: Optional[float] = None, q_offset=None,
                          kv_base=0, return_lse: bool = False,
                          collective_id: int = cids.SP_AG_FUSED,
                          straggler=None, for_correctness: bool = False,
                          group: int = 0):
    """Fused SP all-gather attention, causal prefill (JAX
    `sp_ag_attention_fused`): q (W, B, H, S_loc, D), k_shard/v_shard (W, B,
    Hkv, S_loc, D) -> out (W, B, H, S_loc, D) [, lse (W, B, H, S_loc) f32,
    natural log].  ``q_offset`` / ``kv_base`` (None, an int for every rank,
    or W ints) place each rank's queries and the KV chunks in the global
    sequence: chunk c starts at kv_base[r] + c * S_loc, rank r's queries at
    q_offset[r] (default r * S_loc, and 0).  ``straggler`` (None or (rank,
    cycles)) and ``for_correctness`` are the collectives' fault injection;
    ``group`` (a slice's index) keys the instance of one group of ranks.

    The kernel takes contiguous bf16 or f32 CUDA tensors with D in {64,
    128} and at most 8 ranks; anything else raises.  Each launch of K20
    adds one to ``sp_ag_attention_fused.launches``; at world 1 it is K1,
    counted by `flash_attention`."""
    world, b, h, s_loc, d = q.shape
    if k_shard.dim() != 5 or k_shard.shape[0] != world or \
            k_shard.shape != v_shard.shape or k_shard.shape[3] != s_loc \
            or k_shard.shape[1] != b or k_shard.shape[4] != d or \
            h % k_shard.shape[2]:
        raise ValueError(f"sp_ag_attention_fused: q {tuple(q.shape)} does "
                         f"not match k {tuple(k_shard.shape)}, v "
                         f"{tuple(v_shard.shape)}")
    scale = scale if scale is not None else d ** -0.5
    q_off = _offsets(q_offset, [r * s_loc for r in range(world)], world,
                     "q_offset")
    base = _offsets(kv_base, [0] * world, world, "kv_base")
    if world == 1:
        out, lse = flash_attention(q[0], k_shard[0], v_shard[0], causal=True,
                                   scale=scale, kv_offset=q_off[0] - base[0],
                                   return_lse=True)
        out, lse = out[None], lse[None]
    elif q.device.type == "cpu":
        out, lse = sp_ag_attention_fused_reference(q, k_shard, v_shard, q_off,
                                                   base, scale)
    else:
        out, lse = _launch(q, k_shard, v_shard, q_off, base, scale,
                           collective_id, straggler, for_correctness, group)
    return (out, lse) if return_lse else out


sp_ag_attention_fused.launches = 0


#: TMA coordinates are signed 32-bit: a map's planes must stay below this.
_TMA_PLANES = 1 << 31


def ring_maps(world: int, b: int, h: int, hkv: int, s_loc: int, d: int):
    """The 3-D tensor maps K20's bf16 kernel reads through, each (d, rows,
    planes), innermost first: ``q`` over every rank's queries (plane r B H
    + b H + h), ``kv`` over every rank's k and v inputs and ``ring`` over a
    rank's kbuf and vbuf (chunk c of (b, hk) at `ring_plane`)."""
    return {"q": (d, s_loc, world * b * h), "kv": (d, s_loc, world * b * hkv),
            "ring": (d, s_loc, world * b * hkv)}


def ring_plane(c: int, bi: int, hk: int, b: int, hkv: int) -> int:
    """The plane of chunk ``c``'s rows of (batch ``bi``, KV head ``hk``) in
    a rank's ring buffer (W, B, Hkv, S_loc, D) seen as (W B Hkv, S_loc, D):
    the index K20 gives its TMA loads (and, with the rank for ``c``, of a
    rank's own chunk in the stacked inputs)."""
    return (c * b + bi) * hkv + hk


def _launch(q, k, v, q_off, base, scale, collective_id, straggler,
            for_correctness, group, ring: bool = True):
    """One K20 launch.  ``ring=False`` (bf16; for timing the consumers
    alone): no ring and no arrival wait, the chunks read from the ring
    buffers as the last call left them; the epoch does not move."""
    world, b, h, s_loc, d = q.shape
    hkv = k.shape[2]
    if world > MAX_WORLD:
        raise ValueError(f"sp_ag_attention_fused: world {world} > "
                         f"{MAX_WORLD}")
    _check(_flat(q), _flat(k), _flat(v))
    if any(dims[2] >= _TMA_PLANES for dims in
           ring_maps(world, b, h, hkv, s_loc, d).values()):
        raise ValueError(f"sp_ag_attention_fused: {world * b * h} query "
                         "planes exceed a tensor map's coordinates")
    inst = symmetric_buffers("sp_ag_attention", collective_id, "fused",
                             q.dtype, world, q.device, group=group)
    kbuf = inst.buffer("k", (world, b, hkv, s_loc, d), q.dtype)
    vbuf = inst.buffer("v", (world, b, hkv, s_loc, d), q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((world, b, h, s_loc), dtype=torch.float32,
                      device=q.device)
    ints = ctypes.c_int * world
    blocks = ctypes.c_int(0)
    lib = _build.load_library("sp_ag_attention", _SIGNATURES)
    rc = lib.sp_ag_attention_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), inst.peers(kbuf), inst.peers(vbuf),
        inst.signal_peers(), world, _build.DTYPE_CODES[q.dtype], b, h, hkv,
        s_loc, d, ints(*q_off), ints(*base), float(scale), inst.epoch,
        *fault_args(straggler, for_correctness), int(ring),
        ctypes.byref(blocks), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "sp_ag_attention_fused kernel launch")
    inst.advance(blocks.value)
    sp_ag_attention_fused.launches += 1
    return out, lse


def sp_ag_attention_2d(q, k_shard, v_shard, hctx, *,
                       scale: Optional[float] = None):
    """Two-level causal SP attention (JAX `sp_ag_attention_2d`): q (W, B,
    H, S_loc, D), k_shard/v_shard (W, B, Hkv, S_loc, D) over the (dcn, ici)
    mesh of ``hctx``, global rank g = dcn_index * ici + ici_index owning
    rows [g * S_loc, (g + 1) * S_loc) -> (W, B, H, S_loc, D).  See the
    module docstring for the schedule."""
    dcn, ici = hctx.dcn_size, hctx.ici_size
    world, s_loc = q.shape[0], q.shape[3]
    if world != dcn * ici or k_shard.shape[0] != world:
        raise ValueError(f"sp_ag_attention_2d at (dcn {dcn}, ici {ici}): q "
                         f"{tuple(q.shape)}, k {tuple(k_shard.shape)}")
    kv = (k_shard, v_shard)
    out = lse = None
    for s in range(dcn):
        parts = []
        for d in range(dcn):
            rows = hctx.slice_rows(d)
            parts.append(sp_ag_attention_fused(
                q[rows], kv[0][rows], kv[1][rows], hctx.ici_axis, scale=scale,
                q_offset=[g * s_loc for g in range(world)[rows]],
                kv_base=(d - s) % dcn * ici * s_loc, return_lse=True,
                collective_id=hctx.collective_id, group=d))
        o_s = torch.cat([p[0] for p in parts])
        l_s = torch.cat([p[1] for p in parts])
        if out is None:
            out, lse = o_s.float(), l_s
        else:
            out, lse = _merge(out, lse, o_s, l_s)
        if s < dcn - 1:
            kv = tuple(torch.roll(t.reshape(dcn, ici, *t.shape[1:]), 1,
                                  dims=0).reshape(t.shape) for t in kv)
    return out.to(q.dtype)


def _zigzag_order(world: int):
    """Chunk order of the zigzag layout: rank r owns (r, 2w-1-r)."""
    order = []
    for r in range(world):
        order += [r, 2 * world - 1 - r]
    return order


def _permute_chunks(x, perm, axis_dim: int):
    """Permute 2*world equal chunks of x along ``axis_dim`` by ``perm``."""
    s = x.shape[axis_dim]
    n = len(perm)
    if s % n:
        raise ValueError(f"length {s} does not split into {n} chunks")
    chunks = torch.split(x, s // n, dim=axis_dim)
    return torch.cat([chunks[i] for i in perm], dim=axis_dim)


def zigzag_shard(x, world: int, axis_dim: int = 2):
    """Re-order a global sequence (along ``axis_dim``) for balanced causal
    ring attention: 2*world chunks, rank r's pair (r, 2*world-1-r) placed
    r-th, so that a plain row split hands rank r its zigzag pair."""
    return _permute_chunks(x, _zigzag_order(world), axis_dim)


def zigzag_unshard(x, world: int, axis_dim: int = 2):
    """Inverse of `zigzag_shard` (restore natural order)."""
    order = _zigzag_order(world)
    inv = [0] * len(order)
    for pos, chunk in enumerate(order):
        inv[chunk] = pos
    return _permute_chunks(x, inv, axis_dim)


def sp_ring_attention_zigzag(q, k_shard, v_shard, axis: str = "sp", *,
                             scale: Optional[float] = None):
    """Load-balanced causal ring attention over zigzag-sharded inputs (JAX
    `sp_ring_attention_zigzag`): rank r holds global chunks (r, 2W-1-r) of
    c = S_loc / 2 rows, its low and high half.  Each ring step attends the
    (q half x kv half) pairs at their global offsets; q_lo never sees a kv
    high half.  Every pair that is not in the causal future is either the
    diagonal of the own chunks or fully visible, so the ranks of a step
    share one K1 launch a pair kind (a fully visible pair is computed at
    the shift c, which gives the same result as any larger one).  Returns
    the zigzag layout (W, B, H, S_loc, D); `zigzag_unshard` of the rows
    restores natural order."""
    world, b, h, s2, d = q.shape
    if s2 % 2:
        raise ValueError(f"zigzag shards need an even S_loc, got {s2}")
    c = s2 // 2

    def halves(t):
        return t[..., :c, :].contiguous(), t[..., c:, :].contiguous()

    def attend(qq, kk, vv, off):
        o, l = flash_attention(_flat(qq), _flat(kk), _flat(vv), causal=True,
                               scale=scale, kv_offset=off, return_lse=True)
        return o.float().reshape(qq.shape), l.reshape(qq.shape[:-1])

    q_lo, q_hi = halves(q)
    k_lo, k_hi = halves(k_shard)
    v_lo, v_hi = halves(v_shard)
    out_lo, lse_lo = attend(q_lo, k_lo, v_lo, 0)
    out_hi, lse_hi = _merge(*attend(q_hi, k_lo, v_lo, c),
                            *attend(q_hi, k_hi, v_hi, 0))
    for lo in range(1, world):
        k_lo, k_hi, v_lo, v_hi = (torch.roll(t, 1, dims=0)
                                  for t in (k_lo, k_hi, v_lo, v_hi))
        # Ranks >= lo hold an earlier rank's chunks: q_lo sees its low half
        # in full, q_hi its low half; the high half is in their future.
        # Ranks < lo hold a later rank's chunks: q_lo sees nothing, q_hi
        # both halves in full.
        o_m, l_m = _merge(out_lo[lo:], lse_lo[lo:],
                          *attend(q_lo[lo:], k_lo[lo:], v_lo[lo:], c))
        out_lo, lse_lo = torch.cat([out_lo[:lo], o_m]), torch.cat(
            [lse_lo[:lo], l_m])
        o_a, l_a = attend(q_hi, k_lo, v_lo, c)
        o_b, l_b = _merge(o_a[:lo], l_a[:lo],
                          *attend(q_hi[:lo], k_hi[:lo], v_hi[:lo], c))
        out_hi, lse_hi = _merge(out_hi, lse_hi, torch.cat([o_b, o_a[lo:]]),
                                torch.cat([l_b, l_a[lo:]]))
    return torch.cat([out_lo, out_hi], dim=3).to(q.dtype)


def sp_ag_attention_gather(q, k_shard, v_shard, axis: str = "sp", *,
                           scale: Optional[float] = None,
                           collective_id: int = cids.SP_AG_GATHER):
    """All-gather the KV, then attend (JAX `sp_ag_attention_gather`): each
    rank's K and V packed into one payload (2*B*Hkv*S_loc, D), gathered by
    K15's ring (one launch), unpacked into the whole (B, Hkv, W*S_loc, D),
    then one rectangular K1 a rank at shift r * S_loc (W launches)."""
    world, b, hkv, s_loc, d = k_shard.shape
    ctx = AllGatherContext(axis=axis, world_size=world,
                           method=AllGatherMethod.RING,
                           collective_id=collective_id)
    payload = torch.cat([k_shard.reshape(world, -1, d),
                         v_shard.reshape(world, -1, d)], dim=1)
    gathered = all_gather(payload.contiguous(), ctx).reshape(
        world, world, 2, b, hkv, s_loc, d)

    def full(i):
        return gathered[:, :, i].permute(0, 2, 3, 1, 4, 5).reshape(
            world, b, hkv, world * s_loc, d)

    k_full, v_full = full(0), full(1)
    return torch.stack([
        flash_attention(q[r], k_full[r], v_full[r], causal=True, scale=scale,
                        kv_offset=r * s_loc) for r in range(world)])

