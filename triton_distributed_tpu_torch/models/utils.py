"""Sampling (port of `triton_distributed_tpu/models/utils.py`
`sample_token`)."""

from __future__ import annotations

from typing import Optional

import torch


def sample_token(logits, generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0):
    """logits: (B, V) -> (B,) int32.  Temperature 0 (or no generator) is
    greedy.  Otherwise: temperature scaling, then top-k truncation, then
    nucleus (top-p) truncation, keeping the smallest prefix of the sorted
    distribution whose mass reaches ``top_p`` (the first token always
    stays), then one categorical draw from ``generator``.  The draws are
    not JAX's: only greedy streams match the JAX package."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    if 0.0 < top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        # Exclusive prefix mass: a sorted position is kept while the mass
        # before it is < top_p (so the head token always stays).
        excl = torch.cumsum(probs, dim=-1) - probs
        thresh = torch.where(excl < top_p, desc, torch.inf).min(
            dim=-1, keepdim=True).values
        logits = torch.where(logits < thresh, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
