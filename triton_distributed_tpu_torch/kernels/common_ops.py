"""Barrier and broadcast (port of `triton_distributed_tpu/kernels/
common_ops.py` `barrier_all_on_axis` :38 and `broadcast` :71).

The operands are rank-stacked (`parallel.mesh`), x (W, ...).  On the card
each is one launch of ``csrc/common_ops.cu`` (K18) over every rank:
`barrier_all_on_axis` returns each rank's x copied once every rank has
arrived (JAX `_barrier_kernel`: the copy is the data dependency that
orders what follows; the kernel copies while the ranks arrive); `broadcast`
gives every rank the x of rank ``root`` (`_broadcast_kernel` over
`dl.emit_broadcast`), each of the root's blocks reading its share of x
once and storing it into every rank's output (`broadcast_plan` is the
plan).  The root may be a Python int or a 0-d integer tensor: on the card
it is read from device memory in every call, so a root that changes from
call to call changes no kernel.  Both copy bytes: every dtype is exact.

The keyword arguments ``straggler`` and ``for_correctness`` are the other
collectives' fault injection, which the JAX wrappers of these two do not
take.  Each launch of K18 adds one to ``common_ops.launches`` (both
kernels: K18's count) and to ``common_ops.method_launches[name]``.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version, `barrier_reference` or
`broadcast_reference`.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.allgather import _check
from triton_distributed_tpu_torch.language.core import (
    MAX_BLOCKS, fault_args, owned_words, share, symmetric_buffers)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_TAIL = [_U64, _U64, _I, ctypes.c_longlong, _I, ctypes.POINTER(_I), _P]
_SIGNATURES = {"barrier_all_on_axis": [_P, _P, _P, _I, _I, _I] + _TAIL,
               "broadcast": [_P, _P, _P, _P, _I, _I, _I, _I] + _TAIL}

#: The broadcast's signal words a rank (``csrc/common_ops.cu``
#: BROADCAST_WORDS): the barrier word, the local word, then an arrival bank
#: of MAX_BLOCKS words (one a block of the root).
ARRIVAL_WORD = 2
BROADCAST_WORDS = ARRIVAL_WORD + MAX_BLOCKS

#: K18's launches, both kernels, and by kernel.
launches = 0
method_launches = collections.Counter()


def barrier_reference(x):
    """The plain version of the barrier: a copy of x."""
    return x.clone()


def broadcast_reference(x, root):
    """The plain version of the broadcast: x (W, ...) -> every rank's copy
    of x[root]."""
    src = x[int(root)]
    return src.expand(x.shape[0], *src.shape).clone()


def barrier_plan(nbytes: int, world: int, blocks: int):
    """The plan of one barrier call on every rank's ``nbytes``, ``blocks``
    (P) blocks a rank, as ``csrc/common_ops.cu`` `barrier_kernel` runs it, in
    the events of `allreduce.two_shot_plan` ("x" and "out" buffers): block 0
    adds P to each peer's word 0 (`dl::team_arrive`), every block copies its
    share of x (16-byte units, `comm::share`) into its rank's out, then
    waits for (W - 1) P on word 0 (`dl::team_wait`).

    It mirrors `barrier_kernel`'s body (common_ops.cu :87-91) and
    ``csrc/dl.cuh`` `team_arrive` / `team_wait` (:288-301): an edit there
    needs the same edit here."""
    plan = {}
    for r in range(world):
        for b in range(blocks):
            lo, hi = share(nbytes, 16, b, blocks)
            plan[(r, b)] = [
                ("add", [(q, 0, blocks) for q in range(world)
                         if q != r and b == 0]),
                ("copy", ("x", r, lo), [("out", r, lo)], hi - lo),
                ("wait", [(0, (world - 1) * blocks)])]
    return plan


def broadcast_plan(nbytes: int, world: int, root: int, blocks: int,
                   bank: int = MAX_BLOCKS):
    """The plan of one broadcast call from rank ``root`` on every rank's
    ``nbytes``, ``blocks`` (P) blocks a rank of at most ``bank`` (the most a
    launch of the kernel can have), as ``csrc/common_ops.cu``
    `broadcast_kernel` runs it, in the events of `allreduce.two_shot_plan`:
    the team barrier on word 0; block b of the root copies its share of x
    (16-byte units) into every rank's out and adds P to its words of the
    arrival bank at every rank, its own too; block b of every rank waits for
    word b of that bank.

    It mirrors `broadcast_kernel`'s body (common_ops.cu :107-123, the root's
    words from ``comm_body.cuh`` `signal_blocks`, :342) and the arrival bank
    of BROADCAST_WORDS: an edit there needs the same edit here."""
    plan = {}
    for r in range(world):
        for b in range(blocks):
            ev = [("add", [(q, 0, blocks) for q in range(world)
                           if q != r and b == 0]),
                  ("wait", [(0, (world - 1) * blocks)])]
            if r == root:
                lo, hi = share(nbytes, 16, b, blocks)
                ev.append(("copy", ("x", r, lo),
                           [("out", q, lo) for q in range(world)], hi - lo))
                ev.append(("add", [(q, ARRIVAL_WORD + g, blocks)
                                   for q in range(world)
                                   for g in owned_words(b, blocks, bank)]))
            ev.append(("wait", [(ARRIVAL_WORD + b, blocks)]))
            plan[(r, b)] = ev
    return plan


def barrier_all_on_axis(x, axis: str = "tp", *,
                        collective_id: int = cids.BARRIER,
                        straggler: Optional[tuple] = None,
                        for_correctness: bool = False):
    """Block every rank of ``axis`` until all have arrived; returns x (W,
    ...) copied, each rank's own (any dtype)."""
    if x.dim() < 1:
        raise ValueError("barrier_all_on_axis: want x (W, ...)")
    if x.device.type == "cpu":
        return barrier_reference(x)
    world = x.shape[0]
    _check("barrier_all_on_axis", x, world)
    out = torch.empty_like(x)
    _launch("barrier_all_on_axis", x, out, None, collective_id, straggler,
            for_correctness)
    return out


def broadcast(x, root, axis: str, world_size: int, *,
              collective_id: int = cids.BROADCAST,
              straggler: Optional[tuple] = None,
              for_correctness: bool = False):
    """Every rank gets rank ``root``'s shard: x (W, ...) -> (W, ...), each
    row x[root] (any dtype).  ``root``: an int or a 0-d integer tensor.
    At world 1 it returns x."""
    if x.dim() < 1 or x.shape[0] != world_size:
        raise ValueError(f"broadcast at world {world_size}: want x (W, ...),"
                         f" got {tuple(x.shape)}")
    if world_size <= 1:
        return x
    if x.device.type == "cpu":
        return broadcast_reference(x, root)
    _check("broadcast", x, world_size)
    if isinstance(root, torch.Tensor):
        if root.numel() != 1 or root.is_floating_point():
            raise ValueError("broadcast: root must be an int or a 0-d "
                             "integer tensor")
        root_t = root.to(device=x.device, dtype=torch.int32).reshape(())
    else:
        if not 0 <= int(root) < world_size:
            raise ValueError(f"broadcast: root {root} outside the "
                             f"{world_size} ranks")
        root_t = torch.full((), int(root), dtype=torch.int32,
                            device=x.device)
    out = torch.empty_like(x)
    _launch("broadcast", x, out, root_t, collective_id, straggler,
            for_correctness)
    return out


def _launch(fn, x, out, root, collective_id, straggler, for_correctness):
    global launches
    world = x.shape[0]
    bcast = root is not None
    inst = symmetric_buffers(fn, collective_id, "", x.dtype, world,
                             x.device,
                             **({"words": BROADCAST_WORDS} if bcast else {}))
    blocks = ctypes.c_int(0)
    lib = _build.load_library("common_ops", _SIGNATURES)
    head = [x.data_ptr(), inst.peers(out)]
    if bcast:
        head += [root.data_ptr(), inst.signal_peers(), inst.words]
    else:
        head.append(inst.signal_peers())
    rc = getattr(lib, fn)(
        *head, world, 0, world,
        x[0].numel() * x.element_size(), inst.epoch,
        *fault_args(straggler, for_correctness), ctypes.byref(blocks),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"{fn} kernel launch")
    inst.advance(blocks.value)
    launches += 1
    method_launches[fn] += 1
