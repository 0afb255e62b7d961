"""Serving engine: prefill, first sample, then the decode loop (port of
`triton_distributed_tpu/models/engine.py` `Engine.serve`).

Decode runs eagerly, one step per Python iteration; capturing it in a
CUDA graph (the reference's `_init_cuda_graph`) is later work, as are
the serve spans and metrics.
"""

from __future__ import annotations

from typing import Optional

import torch

from triton_distributed_tpu_torch.models.qwen import Qwen3
from triton_distributed_tpu_torch.models.utils import sample_token
from triton_distributed_tpu_torch.serving.engine_batched import (
    make_rollout_fn, make_step_fn)


class Engine:
    def __init__(self, model: Qwen3, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0):
        self.model = model
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        step = make_step_fn(model.decode, temperature, top_k=top_k,
                            top_p=top_p)
        self._rollout = make_rollout_fn(step)

    @torch.inference_mode()
    def serve(self, input_ids, gen_len: int,
              generator: Optional[torch.Generator] = None,
              cache=None):
        """input_ids: (B, S) on the model's device.  Returns generated
        tokens (B, gen_len) int32: the first from the prefill logits, then
        ``gen_len - 1`` decode steps.

        ``generator``: the sampling generator (default: seeded 0 on the
        model's device); unused when greedy.  ``cache``: a caller's KV
        cache to reuse instead of allocating a zeroed one; its offset is
        reset to 0 and it is updated in place."""
        if gen_len < 1:
            raise ValueError(f"gen_len={gen_len} must be >= 1")
        b, s = input_ids.shape
        if generator is None:
            generator = torch.Generator(
                device=self.model.device).manual_seed(0)
        if cache is None:
            cache = self.model.create_cache(b)
        else:
            if cache.offset.shape[0] != b:
                raise ValueError(f"cache batch {cache.offset.shape[0]} != "
                                 f"input batch {b}")
            cache.set_offset(0)
        # The last token's K/V is never written: s + gen_len - 1 positions.
        if s + gen_len > cache.max_seq + 1:
            raise ValueError(f"cache max_seq={cache.max_seq} cannot hold "
                             f"prompt {s} + gen_len {gen_len}")
        logits = self.model.prefill(input_ids, cache)
        first = sample_token(logits, generator, self.temperature,
                             top_k=self.top_k, top_p=self.top_p)
        rest = self._rollout(first, cache, generator, gen_len - 1)
        return torch.cat([first[:, None], rest], dim=1)
