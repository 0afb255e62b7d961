"""Slot-batched decode: the step functions behind both the
continuous-batching scheduler and `models.engine.Engine` (port of
`triton_distributed_tpu/serving/engine_batched.py`).

- the **masked decode step**: one step over all slots, whatever mix of
  requests occupies them.  Free/finished slots are masked: they emit
  ``pad_id`` (never a sample of stale logits), their cache offsets do
  not advance, and their sampling keys do not advance, so a request's
  token stream is a function of its own (prompt, seed) and not of whoever
  shares the batch;
- the **bucketed prefill**: prompts are right-padded to a small fixed
  set of lengths (`pick_bucket`, `pad_prompt`) and prefilled at batch 1;
- the **slot insert**: a freshly prefilled single-row cache is copied
  into a free slot of the decode cache (or scattered into pages of the
  paged pool), with the slot's offset set to ``prompt_len - 1``.

The insert sets offset to ``prompt_len - 1`` (not ``prompt_len``) and
the scheduler seeds the slot's input token with the last prompt token:
the next masked step recomputes position ``s-1``'s KV (same token, same
rope position) and emits the request's first generated token.  This is
what makes right-padded bucket prefill exact: the padded tail's logits
and KV are never consumed (causal attention keeps positions ``< s``
untouched by the pad, offsets mask the tail).

The JAX versions are jitted with donated caches, the block and the
rollout are `lax.scan`s.  Here every function runs eagerly, loops in
Python, and updates the cache (and the slots' keys) IN PLACE.

Sampling keys.  JAX splits a per-slot threefry key once per emitted
token; torch has no split.  A slot's key here is the int64 pair (seed,
tokens emitted), kept on the host: each active row samples from a
generator seeded from its pair, then the count advances by one.  A
stream therefore depends only on (prompt, seed) and resumes exactly
from a snapshot of the pair.  Only greedy streams match the JAX
package's tokens.  `make_spec_verify_fn` waits for the speculative
decoding slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from triton_distributed_tpu_torch.models.kv_cache import (
    NULL_PAGE, layer_tensors)
from triton_distributed_tpu_torch.models.utils import sample_token

#: Default prefill length buckets.  Powers of two keep padding waste
#: below 2x.
DEFAULT_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


# ---------------------------------------------------------------------------
# Shared step composition (Engine's static-batch path uses these too)
# ---------------------------------------------------------------------------


def make_step_fn(decode_fn, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0):
    """Decode + sample: ``step(tokens, cache, generator) -> next (B,)``.
    ``decode_fn(tokens, cache)`` returns logits and advances the cache."""

    def step(tokens, cache, generator):
        logits = decode_fn(tokens, cache)
        return sample_token(logits, generator, temperature, top_k=top_k,
                            top_p=top_p)

    return step


def make_rollout_fn(step_fn):
    """``rollout(first_tokens, cache, generator, steps) -> (B, steps)``:
    ``steps`` calls of ``step_fn``, each fed the previous token."""

    def rollout(first_tokens, cache, generator, steps: int):
        cur = first_tokens
        toks = []
        for _ in range(steps):
            cur = step_fn(cur, cache, generator)
            toks.append(cur)
        if not toks:
            return first_tokens.new_empty((first_tokens.shape[0], 0))
        return torch.stack(toks, dim=1)

    return rollout


# ---------------------------------------------------------------------------
# Masked (slot-batched) step
# ---------------------------------------------------------------------------


def request_key(seed: int) -> np.ndarray:
    """The slot key a request starts from: (seed, 0 tokens emitted)."""
    return np.array([seed, 0], np.int64)


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def key_generator(key, device) -> torch.Generator:
    """The generator a row samples its next token from, seeded from its
    (seed, tokens emitted) pair.  The pair is hashed (splitmix64) because
    the CPU generator keeps only the seed's low 32 bits."""
    seed, n = (int(x) for x in key)
    return torch.Generator(device=device).manual_seed(
        _splitmix64(_splitmix64(seed & _MASK64) ^ n))


def masked_sample(logits, keys, active, pad_id: int,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Per-slot sampling under an activity mask.

    logits: (B, V); keys: (B, 2) int64 host array of (seed, emitted);
    active: (B,) bool host array.  Active rows sample with their OWN key
    (`sample_token` on one row, so temperature/top-k/top-p semantics
    match the single-request engine); masked rows return ``pad_id`` and
    stale logits of a free slot never reach the sampler.  Returns (B,)
    int32 on the logits' device.  Does not advance the keys."""
    if temperature <= 0.0:
        sampled = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        sampled = torch.full((logits.shape[0],), pad_id, dtype=torch.int32,
                             device=logits.device)
        for b in np.flatnonzero(active):
            sampled[b] = sample_token(
                logits[b:b + 1], key_generator(keys[b], logits.device),
                temperature, top_k=top_k, top_p=top_p)[0]
    act = torch.from_numpy(np.asarray(active, bool)).to(logits.device)
    return torch.where(act, sampled, torch.full_like(sampled, pad_id))


def make_masked_step_fn(decode_fn, temperature: float = 0.0,
                        top_k: int = 0, top_p: float = 1.0,
                        pad_id: int = 0):
    """One decode step over all B slots:
    ``step(tokens (B,), cache, keys (B, 2), active (B,) bool) -> next
    tokens (B,)``.

    Masked rows emit ``pad_id``, keep their cache offset (the model's
    decode advances every row; the step restores the masked rows') and
    keep their key, so a slot's stream depends only on its own request.
    The cache and the host ``keys`` array are updated in place."""

    def step(tokens, cache, keys, active):
        prev_offset = cache.offset.clone()
        logits = decode_fn(tokens, cache)       # advances every offset
        nxt = masked_sample(logits, keys, active, pad_id, temperature,
                            top_k=top_k, top_p=top_p)
        act = torch.from_numpy(np.asarray(active, bool)).to(
            cache.offset.device)
        cache.offset.copy_(torch.where(act, cache.offset, prev_offset))
        keys[active, 1] += 1
        return nxt

    return step


def make_masked_block_fn(decode_fn, temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 1.0,
                         pad_id: int = 0, block: int = 8):
    """``block`` masked steps per call, one host sync for all of them:
    ``(tokens, cache, keys, active) -> tokens (B, block)``.

    The activity mask is FIXED for the block: rows that hit EOS mid-block
    keep decoding and the scheduler discards their post-EOS tokens
    (bounded over-generation, <= block-1 steps).  The caller must leave
    every active row ``block`` KV positions of headroom.  A row's pre-EOS
    tokens and key chain are those of the single-step path."""
    step = make_masked_step_fn(decode_fn, temperature, top_k, top_p, pad_id)

    def blockstep(tokens, cache, keys, active):
        toks = []
        for _ in range(block):
            tokens = step(tokens, cache, keys, active)
            toks.append(tokens)
        return torch.stack(toks, dim=1)

    return blockstep


# ---------------------------------------------------------------------------
# Slot insert
# ---------------------------------------------------------------------------


def make_insert_fn():
    """``insert(big_cache, keys, row_cache, key, slot, offset)``: copy a
    freshly prefilled single-row cache (batch 1, max_seq = its length
    bucket; int8 codes and scales when the caches are int8) into row
    ``slot`` of the decode cache, set that slot's offset and its key.  In
    place."""

    def insert(big, keys, row, key, slot: int, offset: int):
        bucket = row.ks[0].shape[2]
        for b, r in zip(layer_tensors(big), layer_tensors(row),
                        strict=True):
            b[slot, :, :bucket].copy_(r[0])
        big.offset[slot] = offset
        keys[slot] = key

    return insert


def make_paged_insert_fn():
    """``insert(pool_cache, keys, row_cache, key, slot, page_ids,
    offset)``: scatter a freshly prefilled single-row dense cache (batch
    1, max_seq = its length bucket) into physical pages of the paged
    pool, set the slot's offset and key.  In place.

    ``page_ids`` (host int array of ``ceil(bucket / page_size)``) names
    the physical destination of each LOCAL page of the row cache; entries
    equal to `NULL_PAGE` are skipped: shared prefix pages (owned by the
    radix cache, possibly mapped by other slots) and pad-tail pages past
    the prompt.  An int8 row's scales go to the same pages of the scale
    pools, with the same skips.  The row may cover a page-aligned SUFFIX
    of the prompt (the prefix-aware prefill); the caller encodes that in
    ``page_ids``.
    The page TABLE is not touched: `serving.pages.PagedKV` owns it."""

    def insert(pool, keys, row, key, slot: int, page_ids, offset: int):
        ps = pool.page_size
        bucket = row.ks[0].shape[2]
        page_ids = np.asarray(page_ids)
        keep = np.flatnonzero(page_ids != NULL_PAGE)
        full = keep[keep < bucket // ps]          # whole local pages
        ragged = keep[keep >= bucket // ps]       # the last, partial page
        dev = pool.offset.device
        src = torch.from_numpy(full.astype(np.int64)).to(dev)
        dst = torch.from_numpy(page_ids[full].astype(np.int64)).to(dev)
        for p, r in zip(layer_tensors(pool), layer_tensors(row),
                        strict=True):
            r = r[0]                        # (Hkv, bucket[, D])
            hkv, tail = r.shape[0], r.shape[2:]
            blocks = r[:, :bucket // ps * ps].reshape(hkv, -1, ps, *tail)
            p[dst] = blocks[:, src].transpose(0, 1).to(p.dtype)
            for j in ragged:
                lo = int(j) * ps
                p[int(page_ids[j]), :, :bucket - lo] = r[:, lo:].to(p.dtype)
        pool.offset[slot] = offset
        keys[slot] = key

    return insert


# ---------------------------------------------------------------------------
# Prefill bucketing
# ---------------------------------------------------------------------------


def pick_bucket(length: int,
                buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= length, or None when the prompt exceeds all
    buckets (reject upstream)."""
    for b in sorted(buckets):
        if length <= b:
            return int(b)
    return None


def pad_prompt(prompt: Sequence[int], bucket: int, pad_id: int = 0,
               device=None) -> Tuple[torch.Tensor, int]:
    """Right-pad to the bucket length.  Returns ((1, bucket) int32 ids on
    ``device``, true length).  Right padding is exact here: see the
    module docstring."""
    s = len(prompt)
    if not 0 < s <= bucket:
        raise ValueError(f"prompt of {s} tokens does not fit bucket "
                         f"{bucket}")
    ids = list(prompt) + [pad_id] * (bucket - s)
    return torch.tensor([ids], dtype=torch.int32, device=device), s
