"""AllReduce (port of `triton_distributed_tpu/kernels/allreduce.py`
`AllReduceMethod`, `get_auto_allreduce_method` :60, `AllReduceContext` :101,
`_chain_chunks` :244 and `all_reduce` :253).

The operand is rank-stacked (`parallel.mesh`): ``x`` (W, m, n) holds every
rank's partial, and every rank gets their sum, so the result is (W, m, n),
row r being rank r's copy.  On the card the methods are:

- ``"one_shot"``: one launch of ``csrc/all_reduce.cu`` (K17): every rank
  pushes its x to every rank, which sums them (`_one_shot_kernel`);
- ``"two_shot"``: one K17 launch: partial chunks scattered to their owners,
  summed, and the sums broadcast (`_two_shot_kernel`), on the
  scatter-then-sum body that K16 ``scatter_reduce`` runs, with every block
  waiting only for the blocks that wrote its range (`two_shot_plan` is the
  plan); one-shot when the rows do not split over the ranks (allreduce.py
  :350-372);
- ``"chain"``: one K17 launch: running sums down the line to rank 0, the
  result back up, pipelined over `_chain_chunks` chunks; x itself at
  world 1, where there is nothing to reduce;
- ``"ring"``: K16's ring (`reduce_scatter`), then K15's ring (`all_gather`)
  under ``collective_ids.ALLREDUCE_RING_AG`` (allreduce.py :282-310): two
  launches, none of K17; one-shot when the rows do not split over the
  ranks;
- ``"xla"`` (JAX ``psum``): the plain f32 sum in rank order.

Numerics, in the kernels and their plain versions alike: one-shot,
two-shot and xla sum in f32 in rank order 0 .. W-1 and round once; the ring
rounds to x's dtype at every hop of its reduce-scatter (`reduce_scatter`);
the chain adds from rank W-1 down to rank 0, one rounded f32 add a hop.
In bf16 the methods differ by design; in f32 they agree to the order of
the sums.

``"auto"`` (`get_auto_allreduce_method`) is a byte rule, not the JAX
package's TPU ICI model: ``"one_shot"`` up to `ONE_SHOT_MAX_BYTES` of x a
rank, else ``"two_shot"``: the crossover of ``chip_smoke.py``'s sweep at
world 4 on an H100 80GB HBM3 at 700 W (PERF.md), one-shot leading up to
128 KiB, the two even at 256 KiB (0.0120 ms each) and two-shot leading
from 512 KiB (0.0119 against 0.0162).  The chain, which the JAX rule takes
only on open topologies (NVLink and one card are closed), stays an
explicit method, and so does the ring: the sweep never found either
fastest.

On a CUDA tensor `all_reduce` launches the kernels or raises; on a CPU
tensor it computes the plain version, `all_reduce_reference`.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import enum
from typing import Optional

import torch

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.allgather import (
    AllGatherContext, AllGatherMethod, _check, all_gather,
    all_gather_reference)
from triton_distributed_tpu_torch.kernels.reduce_scatter import (
    SUM_WORDS, ReduceScatterContext, ReduceScatterMethod, reduce_scatter,
    reduce_scatter_reference, sum_in_rank_order)
from triton_distributed_tpu_torch.language.core import (
    MAX_BLOCKS, fault_args, owned_words, share, symmetric_buffers)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_FAULTS = [_I, ctypes.c_longlong, _I, ctypes.POINTER(_I), _P]
_SIGNATURES = {
    "all_reduce": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U64, _I, _U64]
    + _FAULTS,
    "all_reduce_two_shot": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U64, _U64]
    + _FAULTS,
}

#: Signal words a rank of ``"two_shot"`` (``csrc/scatter_sum.cuh``
#: TWO_SHOT_WORDS): the scatter-then-sum body's SUM_WORDS (the barrier and
#: local words, then a bank of MAX_BLOCKS words for each of up to 8 source
#: ranks), then a second such bank from OUT_WORD on, for the sums' arrival.
OUT_WORD = SUM_WORDS
TWO_SHOT_WORDS = OUT_WORD + 8 * MAX_BLOCKS


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"
    RING = "ring"
    CHAIN = "chain"
    XLA = "xla"


#: The kernel's method codes (csrc/all_reduce.cu `all_reduce`; two-shot
#: has its own entry).
_CODES = {AllReduceMethod.ONE_SHOT: 0, AllReduceMethod.CHAIN: 2}

#: "auto" takes one-shot up to this many bytes of x a rank, else two-shot
#: (the crossover of chip_smoke.py's sweep on an H100, PERF.md).
ONE_SHOT_MAX_BYTES = 256 << 10


def get_auto_allreduce_method(nbytes: int, world_size: int
                              ) -> AllReduceMethod:
    """The byte rule of ``"auto"`` for ``nbytes`` of x a rank (see the
    module docstring); one-shot at world 1, where it is one copy."""
    if world_size <= 1 or nbytes <= ONE_SHOT_MAX_BYTES:
        return AllReduceMethod.ONE_SHOT
    return AllReduceMethod.TWO_SHOT


@dataclasses.dataclass
class AllReduceContext:
    """As `AllGatherContext`: the axis and its size, the method, the
    collective id keying the instance, and the fault injection: JAX's
    ``straggler``, and ``for_correctness`` as the other collectives'
    contexts have it."""

    axis: str
    world_size: int
    method: AllReduceMethod = AllReduceMethod.AUTO
    collective_id: int = cids.ALLREDUCE
    straggler: Optional[tuple] = None
    for_correctness: bool = False


def create_allreduce_context(axis: str, world_size: int, **kw):
    if "method" in kw:
        kw["method"] = AllReduceMethod(kw["method"])
    return AllReduceContext(axis=axis, world_size=world_size, **kw)


def _chain_chunks(m: int) -> int:
    """Pipeline depth of the chain: 8, 4 or 2 chunks of rows when they
    divide ``m``, else 1 (JAX `_chain_chunks`)."""
    for p in (8, 4, 2):
        if m % p == 0:
            return p
    return 1


def resolve(x, ctx: AllReduceContext) -> AllReduceMethod:
    """The method ``all_reduce`` runs for x (W, m, ...): ``auto`` resolved,
    the ring's and two-shot's fallback to one-shot taken."""
    world, m = x.shape[0], x.shape[1]
    method = AllReduceMethod(ctx.method)
    if method == AllReduceMethod.AUTO:
        method = get_auto_allreduce_method(x[0].numel() * x.element_size(),
                                           world)
    if method in (AllReduceMethod.RING, AllReduceMethod.TWO_SHOT) and (
            m % world):
        method = AllReduceMethod.ONE_SHOT
    return method


def all_reduce_reference(x, method="one_shot"):
    """The plain version of ``method`` (a resolved one): x (W, m, ...) ->
    (W, m, ...), every rank's copy of the sum in the method's order and
    rounding."""
    method = AllReduceMethod(method)
    world = x.shape[0]
    if method == AllReduceMethod.RING:
        return all_gather_reference(reduce_scatter_reference(x, "ring"))
    if method == AllReduceMethod.CHAIN:
        if world <= 1:
            return x
        total = x[world - 1]
        for r in range(world - 2, -1, -1):
            total = (total.float() + x[r].float()).to(x.dtype)
    else:
        total = sum_in_rank_order(x)
    return total.expand(world, *total.shape).clone()


def two_shot_plan(elems: int, world: int, blocks: int,
                  bank: int = MAX_BLOCKS):
    """The plan of one ``"two_shot"`` call on every rank's x of ``elems``
    elements (W chunks of ``elems // world``), ``blocks`` (P) blocks a rank
    of at most ``bank`` (the most a launch of the kernel can have), as
    ``csrc/scatter_sum.cuh`` `scatter_sum_kernel<T, false, 1, true>` runs
    it: {(rank, block): [event, ..]} in program order, each event

    - ``("add", [(rank, word, amount), ..])``: adds to signal words;
    - ``("wait", [(word, target), ..])``: until each of the rank's words
      holds its target (this call's, from an instance at epoch 0);
    - ``("copy", src, [dst, ..], n)``: ``n`` elements from ``src`` to every
      ``dst``, each ``(buffer, rank, offset)`` of "x", "rbuf" or "out";
    - ``("sum", [src, ..], [dst, ..], n)``: the sources summed in their
      order into every destination.

    The entry barrier is every block's add to each peer's word 0; block b
    of rank r copies its `block_range` (16-byte units: 8 elements) of each
    foreign chunk c into slot r of rank c's rbuf, adds P to its words of the
    first bank at each of those ranks, waits for word (s, b) from each
    other source, sums its range in rank order (its own partial from x) into
    chunk r of every rank's out, then does the same with the second bank.
    The plan is the same whether the copies are bulk or the threads' and
    the sums go through slabs or registers.

    It mirrors `scatter_sum_kernel`'s body (``csrc/scatter_sum.cuh``
    :354-400 with ALL: `scatter`, the first bank `sum_word`, the sum, the
    second bank `out_word`), its entry barrier (``dl.cuh`` `barrier_all`,
    :274) and ``comm_body.cuh`` `signal_blocks` / `wait_blocks` (:342-363):
    an edit there needs the same edit here."""
    chunk = elems // world
    plan = {}
    for r in range(world):
        for b in range(blocks):
            lo, hi = share(chunk, 8, b, blocks)
            n = hi - lo
            ev = [("add", [(q, 0, 1) for q in range(world) if q != r]),
                  ("wait", [(0, (world - 1) * blocks)])]
            for j in range(1, world):
                c = (r + j) % world
                ev.append(("copy", ("x", r, c * chunk + lo),
                           [("rbuf", c, r * chunk + lo)], n))
            banks = [(r + 1 + i) % world for i in range(world - 1)]
            ev.append(("add", [(q, 2 + r * MAX_BLOCKS + g, blocks)
                               for q in banks
                               for g in owned_words(b, blocks, bank)]))
            ev.append(("wait", [(2 + s * MAX_BLOCKS + b, blocks)
                                for s in range(world) if s != r]))
            srcs = [("x", r, r * chunk + lo) if s == r
                    else ("rbuf", r, s * chunk + lo) for s in range(world)]
            ev.append(("sum", srcs, [("out", q, r * chunk + lo)
                                     for q in range(world)], n))
            ev.append(("add", [(q, OUT_WORD + r * MAX_BLOCKS + g, blocks)
                               for q in banks
                               for g in owned_words(b, blocks, bank)]))
            ev.append(("wait", [(OUT_WORD + s * MAX_BLOCKS + b, blocks)
                                for s in range(world) if s != r]))
            plan[(r, b)] = ev
    return plan


def all_reduce(x, ctx: AllReduceContext):
    """Sum the rank-stacked partials x (W, m, n) on every rank -> (W, m, n).
    The kernels take contiguous bf16 or f32 on a CUDA device, at most 8
    ranks; anything else raises.  Each launch of K17 adds one to
    ``all_reduce.launches`` and to ``all_reduce.method_launches[method]``;
    the ring counts its two launches in ``reduce_scatter.launches`` and
    ``all_gather.launches``."""
    world = ctx.world_size
    if x.dim() < 2 or x.shape[0] != world:
        raise ValueError(f"all_reduce at world {world}: want x (W, m, ...), "
                         f"got {tuple(x.shape)}")
    method = resolve(x, ctx)
    if method == AllReduceMethod.CHAIN and world <= 1:
        return x
    if method == AllReduceMethod.XLA or x.device.type == "cpu":
        return all_reduce_reference(x, method)
    if method == AllReduceMethod.RING:
        faults = dict(straggler=ctx.straggler,
                      for_correctness=ctx.for_correctness)
        chunk = reduce_scatter(x, ReduceScatterContext(
            ctx.axis, world, ReduceScatterMethod.RING, ctx.collective_id,
            **faults))
        return all_gather(chunk, AllGatherContext(
            ctx.axis, world, AllGatherMethod.RING,
            cids.ALLREDUCE_RING_AG if ctx.collective_id == cids.ALLREDUCE
            else ctx.collective_id, **faults))
    return _launch(x, ctx, method)


all_reduce.launches = 0
all_reduce.method_launches = collections.Counter()


def _launch(x, ctx, method):
    world, m = x.shape[0], x.shape[1]
    _check("all_reduce", x, world, _build.DTYPE_CODES)
    elems = x[0].numel()
    chunks = _chain_chunks(m) if method == AllReduceMethod.CHAIN else 1
    two_shot = method == AllReduceMethod.TWO_SHOT
    # The chain's reduce and broadcast words depend on its chunk count:
    # one instance a count keeps every word's adds the same in every call.
    key = method.value + (f"/{chunks}" if chunks > 1 else "")
    inst = symmetric_buffers(
        "all_reduce", ctx.collective_id, key, x.dtype, world, x.device,
        **({"words": TWO_SHOT_WORDS} if two_shot else {}))
    if method == AllReduceMethod.ONE_SHOT:
        buf = inst.buffer("rbuf", (world, elems), x.dtype)
    elif two_shot:
        buf = inst.buffer("rbuf", (world, elems // world), x.dtype)
    else:
        buf = inst.buffer("staging", (elems,), x.dtype)
    # In the one-process emulation the output is every rank's receive
    # buffer (two-shot's broadcast and the chain put into it).
    out = torch.empty_like(x)
    blocks = ctypes.c_int(0)
    lib = _build.load_library("all_reduce", _SIGNATURES)
    tail = (inst.epoch, *fault_args(ctx.straggler, ctx.for_correctness),
            ctypes.byref(blocks),
            torch.cuda.current_stream(x.device).cuda_stream)
    if two_shot:
        rc = lib.all_reduce_two_shot(
            x.data_ptr(), inst.peers(out), inst.peers(buf),
            inst.signal_peers(), inst.words, world, 0, world,
            _build.DTYPE_CODES[x.dtype], elems // world, *tail)
    else:
        rc = lib.all_reduce(
            x.data_ptr(), inst.peers(out), inst.peers(buf),
            inst.signal_peers(), world, 0, world, _CODES[method],
            _build.DTYPE_CODES[x.dtype], elems, chunks, *tail)
    _build.check(lib, rc, f"all_reduce ({method.value}) kernel launch")
    inst.advance(blocks.value)
    all_reduce.launches += 1
    all_reduce.method_launches[method.value] += 1
    return out
