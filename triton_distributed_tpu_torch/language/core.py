"""The host half of the device-side communication primitives (port of
`triton_distributed_tpu/language/core.py`).

The primitives themselves are device functions in ``kernels/csrc/dl.cuh``:
``rank``, ``num_ranks`` and ``peer_id`` (JAX :35-52), ``put`` / ``put_nbi``
(:70-92), ``notify`` (:129), ``signal_wait_until`` / ``wait`` (:153-165),
``barrier_all`` (:193), ``entry_barrier`` (:223), ``maybe_straggle`` (:304),
``correctness_delay`` (:331) and ``barrier_neighbors`` (:364), over a
table of peer pointers, with the memory scope a template parameter (JAX's
``emit_broadcast`` (:247) is K18's own kernel).  What the host keeps for
them lives here: each collective instance's symmetric buffers and signal
words, and its epoch.

Signal words are monotonic counters that no call resets.  In every call of
an instance each of its signal words receives adds summing to the same
multiple of P, P being the blocks a rank of that launch (one add from each
block of its signallers, or one add of P from one block of each
signaller: ``dl.cuh`` `team_arrive`, and the words paired by range of the
scatter-then-sum body of K16 ``scatter_reduce``, K17 ``two_shot`` and K21b
and of K18's broadcast, each owned by one block, `owned_words`); the
instance's ``epoch`` is the sum of P over its calls so
far.  A kernel is handed the epoch before its
call, adds its own P and waits for that multiple of the sum, so a signal of
a later call cannot satisfy a wait early and no stale signal of an earlier
call is left to clear.  With one process per GPU the same holds: each
process makes the same calls with the same P, and the kernels' entry
barrier keeps a rank from writing into a peer that has not yet entered the
call, i.e. is still reading its buffers in the last one.  A method's
barrier adds differ from another method's, so each (collective id, method)
pair keys its own instance.

An instance has `SIGNAL_WORDS` words a rank unless its kernels need more:
the torus kernels (``csrc/torus.cu``) give every (phase, lane, ring
position) its own word, so no wait can be met by another lane's adds, and
size their instances by their grid; the scatter-then-sum body and K18's
broadcast give every (source rank, block) its own word
(`reduce_scatter.SUM_WORDS`, `allreduce.TWO_SHOT_WORDS`,
`common_ops.BROADCAST_WORDS`; `owned_words`), so a block waits only for the
blocks that wrote its range.  A kernel
that runs once per group of ranks (the hierarchical collectives launch the
intra-slice kernel once a slice) keys one instance a group.
"""

from __future__ import annotations

import ctypes
import math

import torch

#: Counters a rank holds (``dl.cuh`` SIGNAL_WORDS): the entry barrier, the
#: rank-local barrier, then two banks of 8 arrival counters (a source rank,
#: a chunk or a ring step each; the second bank for a second phase,
#: direction or the acks).
SIGNAL_WORDS = 18


#: Blocks a rank at most of a body with an arrival word a block, and the
#: words a source rank owns in one bank at each destination (``comm_body.cuh``
#: MAX_BLOCKS).
MAX_BLOCKS = 256


def share(n: int, unit: int, part: int, parts: int) -> tuple[int, int]:
    """The part [lo, hi) of ``n`` that ``part`` of ``parts`` owns
    (``comm_body.cuh`` `share`): whole ``unit``s, the share rounded up (the
    last parts may be empty), the last part also the tail."""
    units = n // unit
    each = -(-units // parts)
    lo, hi = min(part * each, units) * unit, min((part + 1) * each, units) * unit
    return lo, n if part == parts - 1 else hi


def owned_words(block: int, blocks: int, words: int = MAX_BLOCKS) -> range:
    """The words of a bank to which block ``block`` of ``blocks`` adds
    ``blocks`` in every call (``comm_body.cuh`` `signal_blocks`): b, b + P,
    .. < ``words``, the most blocks a rank any launch of the kernel can
    have (at most MAX_BLOCKS), so every word of the bank that a block may
    wait on receives adds summing to P whatever P is."""
    return range(block, words, blocks)


def fault_args(straggler, for_correctness: bool):
    """The kernels' fault-injection arguments (``dl.cuh``
    `maybe_straggle`, `correctness_delay`): (straggler rank or -1, its
    cycles, 0 or 1) from a context's ``straggler`` (None or (rank,
    cycles)) and ``for_correctness``."""
    rank, cycles = straggler if straggler is not None else (-1, 0)
    return int(rank), int(cycles), int(bool(for_correctness))


class SymmetricBuffers:
    """Every rank's buffers and signal words of one collective instance,
    on one device: rank r's copy of a buffer is row r of a rank-stacked
    tensor, reached by the kernels through a table of per-rank pointers."""

    def __init__(self, world: int, device, words: int = SIGNAL_WORDS):
        self.world = world
        self.device = torch.device(device)
        self.words = words
        self.signals = torch.zeros((world, words), dtype=torch.int64,
                                   device=self.device)
        #: The sum, over this instance's calls so far, of the blocks a rank.
        self.epoch = 0
        self._buffers: dict[str, torch.Tensor] = {}

    def buffer(self, name: str, shape, dtype) -> torch.Tensor:
        """The rank-stacked buffer ``name`` as (world, *shape), kept across
        calls (its contents are the last call's) and grown when a call
        needs more."""
        numel = math.prod(shape)
        buf = self._buffers.get(name)
        if buf is None or buf.dtype != dtype or buf.shape[1] < numel:
            buf = torch.empty((self.world, numel), dtype=dtype,
                              device=self.device)
            self._buffers[name] = buf
        return buf[:, :numel].view(self.world, *shape)

    @staticmethod
    def peers(t: torch.Tensor):
        """The ctypes table of rank r's pointer ``t[r]`` for every rank."""
        return (ctypes.c_void_p * t.shape[0])(
            *(t[r].data_ptr() for r in range(t.shape[0])))

    def signal_peers(self):
        return self.peers(self.signals)

    def advance(self, blocks: int) -> None:
        """Count a launched call of ``blocks`` blocks a rank."""
        self.epoch += blocks


_instances: dict[tuple, SymmetricBuffers] = {}


def symmetric_buffers(op: str, collective_id: int, method: str, dtype,
                      world: int, device, *, group: int = 0,
                      words: int = SIGNAL_WORDS) -> SymmetricBuffers:
    """The instance of collective ``collective_id`` running ``op``'s
    ``method`` at ``world`` on ``device`` in ``dtype`` for the group of
    ranks ``group`` (a slice's index, 0 for a whole mesh), with ``words``
    signal words a rank, made at first use.  Sequential calls share an
    instance; concurrent ones need distinct ids (`collective_ids`) or
    groups."""
    key = (op, collective_id, method, dtype, world, torch.device(device),
           group, words)
    inst = _instances.get(key)
    if inst is None:
        inst = _instances[key] = SymmetricBuffers(world, device, words)
    return inst


def release_symmetric_buffers() -> None:
    """Drop every instance and its device memory (the next call of a
    collective starts a fresh instance at epoch 0)."""
    _instances.clear()
