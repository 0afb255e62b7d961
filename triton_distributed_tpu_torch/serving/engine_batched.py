"""Decode step composition shared by `models.engine.Engine` and, in a
later slice, the continuous-batching scheduler (port of
`triton_distributed_tpu/serving/engine_batched.py` `make_step_fn` and
`make_rollout_fn`).

The JAX versions are jitted and the rollout is a `lax.scan`; here the
step runs eagerly, the rollout is a Python loop, and the KV cache is
updated in place, so neither returns it.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.models.utils import sample_token


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
