"""Qwen3 dense model on one GPU (port of
`triton_distributed_tpu/models/qwen.py` `Qwen3` at ``world == 1``).

The JAX model is a parameter pytree plus pure per-device functions; here
the parameters live in the module.  Layouts are the JAX package's, so its
parameters carry over as they are (`load_jax_params`): matrices are
(in, out), ``wqkv`` columns are [q | k | v], ``gate_up`` columns are
[gate | up], and a tied LM head is ``embed.T``.  MoE layers,
multi-GPU tensor parallelism and loading HF checkpoints are not ported
yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from triton_distributed_tpu_torch.layers.tp_attn import (
    TPAttention, normal_init_, require_single_gpu, rms_norm, weight)
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.kv_cache import KVCache
from triton_distributed_tpu_torch.utils.platform import resolve_device


def dot_f32(a, b):
    """a @ b with an f32 result (the JAX package's
    ``preferred_element_type=jnp.float32``) without widening ``b``."""
    if a.dtype != torch.float32 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class Qwen3Layer(nn.Module):
    def __init__(self, config: ModelConfig, mode: str, dtype, device):
        super().__init__()
        h = config.hidden_size
        self.eps = config.rms_norm_eps
        self.ln1 = weight(h, dtype=dtype, device=device)
        self.ln2 = weight(h, dtype=dtype, device=device)
        self.attn = TPAttention(
            h, config.num_heads, config.num_kv_heads, config.head_dim,
            rope_theta=config.rope_theta, qk_norm=config.qk_norm,
            dtype=dtype, device=device)
        self.mlp = TPMLP(h, config.intermediate_size, mode=mode,
                         dtype=dtype, device=device)

    def prefill(self, x, batch: int):
        h, kv = self.attn.prefill(rms_norm(x, self.ln1, self.eps), batch)
        x = x + h
        return x + self.mlp(rms_norm(x, self.ln2, self.eps)), kv

    def decode(self, x, kv_cache, offset):
        x = x + self.attn.decode(rms_norm(x, self.ln1, self.eps), kv_cache,
                                 offset)
        return x + self.mlp(rms_norm(x, self.ln2, self.eps))


class Qwen3(nn.Module):
    """Weights are allocated uninitialised on ``device`` (default CUDA);
    fill them with `init_params` or `load_jax_params`."""

    def __init__(self, config: ModelConfig, mode: str = "fused",
                 world_size: int = 1, device=None):
        super().__init__()
        require_single_gpu(world_size)
        if config.is_moe:
            raise NotImplementedError("MoE layers are not yet ported")
        if config.quantize_kv_cache:
            raise NotImplementedError("the int8 KV cache is not yet ported")
        self.config = config
        self.device = resolve_device(device)
        self.dtype = getattr(torch, config.dtype)
        dev, dt = self.device, self.dtype
        h, vocab = config.hidden_size, config.vocab_size
        self.embed = weight(vocab, h, dtype=dt, device=dev)
        self.layers = nn.ModuleList(
            Qwen3Layer(config, mode, dt, dev)
            for _ in range(config.num_layers))
        self.ln_f = weight(h, dtype=dt, device=dev)
        if not config.tie_word_embeddings:
            self.lm_head_w = weight(h, vocab, dtype=dt, device=dev)

    @property
    def lm_head(self):
        """(hidden, vocab); ``embed.T`` when the embeddings are tied."""
        if self.config.tie_word_embeddings:
            return self.embed.t()
        return self.lm_head_w

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Qwen3":
        """Random weights with the JAX package's distributions: N(0, 1/h)
        matrices and embeddings, unit norms.  Returns self."""
        std = self.config.hidden_size ** -0.5
        for layer in self.layers:
            layer.ln1.fill_(1)
            layer.ln2.fill_(1)
            layer.attn.init_params(generator)
            layer.mlp.init_params(generator)
        normal_init_(self.embed, generator, std)
        self.ln_f.fill_(1)
        if not self.config.tie_word_embeddings:
            normal_init_(self.lm_head_w, generator, std)
        return self

    @torch.no_grad()
    def load_jax_params(self, tree) -> "Qwen3":
        """Copy the JAX package's parameter pytree (`Qwen3.init_params`
        layout, leaves as numpy arrays) into this module.  Returns self."""
        def put(dst, src):
            src = torch.from_numpy(np.array(src, dtype=np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

        for layer, lp in zip(self.layers, tree["layers"], strict=True):
            put(layer.ln1, lp["ln1"])
            put(layer.ln2, lp["ln2"])
            put(layer.attn.wqkv, lp["attn"]["wqkv"])
            put(layer.attn.wo, lp["attn"]["wo"])
            if self.config.qk_norm:
                put(layer.attn.q_norm, lp["attn"]["q_norm"])
                put(layer.attn.k_norm, lp["attn"]["k_norm"])
            put(layer.mlp.gate_up, lp["mlp"]["gate_up"])
            put(layer.mlp.down, lp["mlp"]["down"])
        put(self.embed, tree["embed"])
        put(self.ln_f, tree["ln_f"])
        if not self.config.tie_word_embeddings:
            put(self.lm_head_w, tree["lm_head"])
        return self

    def create_cache(self, batch: int, max_seq: Optional[int] = None):
        cfg = self.config
        return KVCache.create(cfg.num_layers, batch, cfg.num_kv_heads,
                              max_seq or cfg.max_seq_len, cfg.head_dim,
                              self.dtype, device=self.device)

    @torch.inference_mode()
    def prefill(self, input_ids, cache: Optional[KVCache]):
        """input_ids: (B, S).  Writes positions [0, S) of ``cache`` in
        place and sets its offset to S.  Returns f32 logits (B, V) of the
        last position."""
        b, s = input_ids.shape
        x = self.embed[input_ids.long()].reshape(b * s, -1)
        for li, layer in enumerate(self.layers):
            x, (k, v) = layer.prefill(x, b)
            if cache is not None:
                cache.write_prefill(li, k, v)
        x = rms_norm(x, self.ln_f, self.config.rms_norm_eps)
        last = x.reshape(b, s, -1)[:, -1]
        if cache is not None:
            cache.set_offset(s)
        return dot_f32(last, self.lm_head)

    @torch.inference_mode()
    def decode(self, tokens, cache: KVCache):
        """tokens: (B,).  Writes each row's position ``cache.offset`` in
        place and advances the offset by one.  Returns f32 logits (B, V)."""
        x = self.embed[tokens.long()]
        for li, layer in enumerate(self.layers):
            x = layer.decode(x, (cache.ks[li], cache.vs[li]), cache.offset)
        x = rms_norm(x, self.ln_f, self.config.rms_norm_eps)
        cache.inc_offset(1)
        return dot_f32(x, self.lm_head)
