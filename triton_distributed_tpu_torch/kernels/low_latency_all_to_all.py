"""Low-latency AllToAll for expert-parallel MoE dispatch and combine (port
of `triton_distributed_tpu/kernels/low_latency_all_to_all.py`
`AllToAllContext` :45, `create_all_to_all_context` :67, `fast_all_to_all`
:127 and `all_to_all_post_process` :229).

The operands are rank-stacked (`parallel.mesh`): ``send_tokens`` (W, W,
cap, hidden) holds in row r rank r's per-destination blocks (block p the
tokens rank r routes to rank p, capacity-padded), ``send_counts`` (W, W, 1)
their true counts, and the optional ``send_scales`` (W, W, cap, ns) a
second payload of per-row values.  The result has the same layout: block
[r, p] is what rank p sent to rank r, so it is the transpose of the two
rank axes, byte for byte.  On the card that is one launch of
``csrc/all_to_all.cu`` (K19) over every rank: each rank puts every block
(the whole capacity block, as the TPU kernel does), its count and its
scale rows into the destination's receive slot and signals it; ``method
"xla"`` (JAX `jax.lax.all_to_all`) is the plain version,
`fast_all_to_all_reference`.  The JAX wrapper pads the counts to 128 lanes
and the scales to a multiple of 128 for Mosaic; the kernel copies every
payload at its own width and needs no padding.  The observability event is
not ported.

On a CUDA tensor `fast_all_to_all` launches the kernel or raises; on a CPU
tensor it computes the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.language.core import (
    fault_args, symmetric_buffers)
from triton_distributed_tpu_torch.parallel.mesh import MAX_WORLD

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_SIGNATURES = {"all_to_all": [_P] * 7 + [_I, _I, _I] + [_U64] * 4
               + [_I, ctypes.c_longlong, _I, ctypes.POINTER(_I), _P]}

METHODS = ("auto", "xla")


@dataclasses.dataclass
class AllToAllContext:
    """``world_size`` ranks along ``axis``; ``max_tokens_per_rank`` rows a
    (source, destination) block of ``hidden`` columns.  ``method``:
    ``"auto"`` (K19) or ``"xla"`` (the plain version).  ``collective_id``
    keys the instance's signal words (`collective_ids`); ``straggler``
    (None or (rank, cycles)) and ``for_correctness`` are the JAX fault
    injection (`dl.maybe_straggle`, `dl.correctness_delay`)."""

    axis: str
    world_size: int
    max_tokens_per_rank: int
    hidden: int
    collective_id: int = cids.ALL_TO_ALL
    method: str = "auto"
    straggler: Optional[tuple] = None
    for_correctness: bool = False
    #: The group of ranks (a slice's index; 0 for a whole mesh).
    group: int = 0


def create_all_to_all_context(axis: str, world_size: int,
                              max_tokens_per_rank: int, hidden: int,
                              **kw) -> AllToAllContext:
    return AllToAllContext(axis=axis, world_size=world_size,
                           max_tokens_per_rank=max_tokens_per_rank,
                           hidden=hidden, **kw)


def fast_all_to_all_reference(send_tokens, send_counts, send_scales=None):
    """The plain version: block [r, p] of the result is block [p, r] of the
    input (the two rank axes swapped), for every payload."""
    out = [t.transpose(0, 1).contiguous() for t in (send_tokens, send_counts)]
    if send_scales is not None:
        out.append(send_scales.transpose(0, 1).contiguous())
    return tuple(out)


def fast_all_to_all(send_tokens, send_counts, ctx: AllToAllContext,
                    send_scales=None):
    """Exchange capacity-padded blocks between all ranks.  send_tokens (W,
    W, cap, hidden) any dtype, send_counts (W, W, 1) int32, send_scales
    None or (W, W, cap, ns) any dtype -> (recv_tokens, recv_counts[,
    recv_scales]) of the same shapes, block [r, p] what rank p sent to rank
    r.  The kernel takes contiguous CUDA tensors of at most 8 ranks;
    anything else raises.  Each launch of K19 adds one to
    ``fast_all_to_all.launches``."""
    world = ctx.world_size
    if ctx.method not in METHODS:
        raise ValueError(f"fast_all_to_all: method {ctx.method!r} not in "
                         f"{METHODS}")
    if (send_tokens.dim() != 4 or send_tokens.shape[:2] != (world, world)
            or send_counts.shape != (world, world, 1)):
        raise ValueError(f"fast_all_to_all at world {world}: want send "
                         f"(W, W, cap, hidden) and counts (W, W, 1), got "
                         f"{tuple(send_tokens.shape)} and "
                         f"{tuple(send_counts.shape)}")
    if send_counts.dtype != torch.int32:
        raise ValueError(f"fast_all_to_all: counts are {send_counts.dtype}; "
                         "want int32")
    if send_scales is not None and (
            send_scales.dim() != 4
            or send_scales.shape[:3] != send_tokens.shape[:3]):
        raise ValueError(f"fast_all_to_all: scales {tuple(send_scales.shape)}"
                         f" do not match send {tuple(send_tokens.shape)}")
    if ctx.method == "xla" or send_tokens.device.type == "cpu":
        return fast_all_to_all_reference(send_tokens, send_counts,
                                         send_scales)
    return _launch(send_tokens, send_counts, send_scales, ctx)


fast_all_to_all.launches = 0


def _launch(send, counts, scales, ctx):
    world = ctx.world_size
    payloads = [("send", send), ("counts", counts)]
    if scales is not None:
        payloads.append(("scales", scales))
    for name, t in payloads:
        if t.device != send.device or t.device.type != "cuda":
            raise ValueError(f"fast_all_to_all: {name} on {t.device}; want "
                             f"{send.device}, a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"fast_all_to_all: {name} must be contiguous")
    if world > MAX_WORLD:
        raise ValueError(f"fast_all_to_all: world {world} > {MAX_WORLD}")
    if send.numel() == 0:
        raise ValueError(f"fast_all_to_all: empty send {tuple(send.shape)}")
    inst = symmetric_buffers("all_to_all", ctx.collective_id, "push", None,
                             world, send.device, group=ctx.group)
    # In the one-process emulation the outputs are every rank's receive
    # buffers: rank r's row is where the peers put into.
    recv = torch.empty_like(send)
    rcounts = torch.empty_like(counts)
    rscales = None if scales is None else torch.empty_like(scales)

    def block_bytes(t):
        return t[0, 0].numel() * t.element_size()

    blocks = ctypes.c_int(0)
    lib = _build.load_library("all_to_all", _SIGNATURES)
    rc = lib.all_to_all(
        send.data_ptr(), counts.data_ptr(),
        None if scales is None else scales.data_ptr(),
        inst.peers(recv), inst.peers(rcounts),
        None if scales is None else inst.peers(rscales),
        inst.signal_peers(), world, 0, world, block_bytes(send),
        block_bytes(counts), 0 if scales is None else block_bytes(scales),
        inst.epoch, *fault_args(ctx.straggler, ctx.for_correctness),
        ctypes.byref(blocks), torch.cuda.current_stream(send.device).cuda_stream)
    _build.check(lib, rc, "fast_all_to_all kernel launch")
    inst.advance(blocks.value)
    fast_all_to_all.launches += 1
    return (recv, rcounts) if scales is None else (recv, rcounts, rscales)


def all_to_all_post_process(recv_tokens, recv_counts, cap: int):
    """Compact one rank's received blocks into a dense prefix (JAX
    `all_to_all_post_process`): recv_tokens (W, cap, hidden), recv_counts
    (W, 1) -> (tokens (W*cap, hidden), total): block p's first count_p
    rows at offset sum(count_<p), zeros past the total (a 0-d int32
    tensor).  A row whose place falls past W*cap is dropped, as by the JAX
    scatter's ``mode="drop"``."""
    world, _, hidden = recv_tokens.shape
    counts = recv_counts.reshape(world).to(torch.int32)
    flat = recv_tokens.reshape(world * cap, hidden)
    within = torch.arange(cap, device=flat.device)[None, :]
    valid = (within < counts[:, None].long()).reshape(-1)
    offsets = torch.cumsum(counts.long(), 0) - counts.long()
    dest = (offsets[:, None] + within).reshape(-1)
    # Invalid rows and rows past the end land in a spare row that is cut
    # off (no boolean-mask indexing: it would wait for the device).
    dest = torch.where(valid & (dest < world * cap), dest, world * cap)
    out = flat.new_zeros((world * cap + 1, hidden))
    out[dest] = flat
    return out[:world * cap], counts.sum(dtype=torch.int32)
