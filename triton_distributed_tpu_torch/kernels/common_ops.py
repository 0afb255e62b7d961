"""Barrier and broadcast (port of `triton_distributed_tpu/kernels/
common_ops.py` `barrier_all_on_axis` :38 and `broadcast` :71).

The operands are rank-stacked (`parallel.mesh`), x (W, ...).  On the card
each is one launch of ``csrc/common_ops.cu`` (K18) over every rank:
`barrier_all_on_axis` waits until every rank has arrived, then copies each
rank's x to its output (JAX `_barrier_kernel`: the copy is the data
dependency that orders what follows); `broadcast` gives every rank the x
of rank ``root`` (`_broadcast_kernel` over `dl.emit_broadcast`).  The root
may be a Python int or a 0-d integer tensor: on the card it is read from
device memory in every call, so a root that changes from call to call
changes no kernel.  Both copy bytes: every dtype is exact.

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
    fault_args, symmetric_buffers)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_TAIL = [_U64, _U64, _I, ctypes.c_longlong, _I, ctypes.POINTER(_I), _P]
_SIGNATURES = {"barrier_all_on_axis": [_P, _P, _P, _I, _I, _I] + _TAIL,
               "broadcast": [_P, _P, _P, _P, _I, _I, _I] + _TAIL}

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
    inst = symmetric_buffers(fn, collective_id, "", x.dtype, world,
                             x.device)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("common_ops", _SIGNATURES)
    head = [x.data_ptr(), inst.peers(out)]
    if root is not None:
        head.append(root.data_ptr())
    rc = getattr(lib, fn)(
        *head, inst.signal_peers(), world, 0, world,
        x[0].numel() * x.element_size(), inst.epoch,
        *fault_args(straggler, for_correctness), ctypes.byref(blocks),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"{fn} kernel launch")
    inst.advance(blocks.value)
    launches += 1
    method_launches[fn] += 1
