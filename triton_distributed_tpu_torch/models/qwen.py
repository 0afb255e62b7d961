"""Qwen3 model (port of `triton_distributed_tpu/models/qwen.py` `Qwen3`).

The JAX model is a parameter pytree plus pure per-device functions; here
the parameters live in the module.  Layouts are the JAX package's, so its
parameters carry over as they are (`load_jax_params`): matrices are
(in, out), ``wqkv`` columns are [q | k | v], ``gate_up`` columns are
[gate | up], and a tied LM head is ``embed.T``.  With
``ModelConfig.quantize_kv_cache`` the caches are int8 with per-token
scales (decode quantizes its new token on write; prefill logits do not
read the cache).  The MLP runs in the ``xla`` or ``fused`` mode, as the
JAX model's `set_mode` allows (``w8a8`` is a layer mode of `TPMLP`, not a
model mode there either).  With ``config.num_experts > 0`` every MLP is a
`MoEMLP` (Qwen3-MoE), whose two expert products run on the grouped GEMM
kernel; its router is f32 whatever the model's dtype.  Loading HF
checkpoints is not ported yet.

Tensor parallelism: ``Qwen3(config, mode, mesh=make_mesh(W))`` runs the
JAX model's per-device bodies for a world of W (`prefill_shard` :242,
`decode_shard` :302, `decode_paged_shard` :266) with every rank in this
process (`parallel.mesh`): the embedding rows are sliced per rank into the
rank-stacked (W, M/W, hidden) activations, every projection of the dense
layers goes through AllGather-GEMM or GEMM-ReduceScatter (K12 and K14 in
mode ``fused``), the final all-gather of rows is a reshape, and the
vocab-sharded head (JAX ``P(None, tp)``: rank r's columns r V/W ..)
concatenates to the one (hidden, V) product, kept whole here.  An MoE
model's layers run `MoEMLP` at world W (mode ``fused``: K11 then K10 in
prefill; decode's few rows a rank take its ``xla`` path, as JAX's do).
Decode needs a batch that W divides.  `reshard` moves a dense world-1
model's weights into the world-W layout, so the same weights run at both
(an MoE model is built at world W instead).  Training and the scheduler
at world > 1 are refused.

The engine contract the serving stack drives: `create_cache`,
`create_paged_cache`, `prefill(ids, cache)`, `decode(tokens, cache)` and
`decode_paged(tokens, cache)`; each updates its cache in place.

Training: ``model(ids)`` (`forward`) is the differentiable prefill without
a cache (JAX: ``prefill_shard(params, ids, None)``), returning the f32
last-position logits; ``model.requires_grad_(True)`` turns on the
gradients of the (frozen by default) weights, and `to_jax_params` turns
the parameters or their gradients back into the JAX pytree layout.  The
package has no optimizer: a caller takes its own steps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from triton_distributed_tpu_torch.layers.tp_attn import (
    TPAttention, jax_layout, normal_init_, rms_norm, stack_columns,
    stack_rows, tp_layout, weight)
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.kv_cache import (
    KVCache, PagedKVCache)
from triton_distributed_tpu_torch.parallel.mesh import MeshContext
from triton_distributed_tpu_torch.utils.platform import resolve_device


def dot_f32(a, b):
    """a @ b with an f32 result (the JAX package's
    ``preferred_element_type=jnp.float32``).  Without a gradient to compute
    it does not widen ``b``; with one it multiplies f32 copies (the
    products of bf16 values are exact in f32, so only the order of the sums
    differs), whose backward is plain autograd."""
    needs_grad = torch.is_grad_enabled() and (a.requires_grad
                                              or b.requires_grad)
    if a.dtype != torch.float32 and a.is_cuda and not needs_grad:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _mlp_names(config: ModelConfig):
    """The MLP's leaves in the JAX parameter tree."""
    if config.is_moe:
        return ("router", "gate_up", "down")
    return ("gate_up", "down")


def _interleave(parts, world: int):
    """World-1 column blocks (e.g. [q | k | v]) -> each rank's columns of
    every block side by side, rank-stacked: (W, in, sum of c_i / W).  As
    the JAX `load_hf_weights` interleaves wqkv and `_interleave_gate_up`
    gate_up."""
    return torch.cat([stack_columns(p, world) for p in parts], dim=2)


class Qwen3Layer(nn.Module):
    def __init__(self, config: ModelConfig, mode: str, dtype, device,
                 world_size: int = 1):
        super().__init__()
        h = config.hidden_size
        self.eps = config.rms_norm_eps
        self.ln1 = weight(h, dtype=dtype, device=device)
        self.ln2 = weight(h, dtype=dtype, device=device)
        self.attn = TPAttention(
            h, config.num_heads, config.num_kv_heads, config.head_dim,
            rope_theta=config.rope_theta, qk_norm=config.qk_norm,
            world_size=world_size, mode=mode, dtype=dtype, device=device)
        if config.is_moe:
            self.mlp = MoEMLP(
                h, config.moe_intermediate_size or config.intermediate_size,
                config.num_experts, topk=config.num_experts_per_tok,
                capacity_factor=config.moe_capacity_factor, mode=mode,
                world_size=world_size, dtype=dtype, device=device)
        else:
            self.mlp = TPMLP(h, config.intermediate_size, mode=mode,
                             world_size=world_size, dtype=dtype,
                             device=device)

    def prefill(self, x, batch: int):
        h, kv = self.attn.prefill(rms_norm(x, self.ln1, self.eps), batch)
        x = x + h
        return x + self.mlp(rms_norm(x, self.ln2, self.eps)), kv

    def decode(self, x, kv_cache, offset, kv_scales=None):
        x = x + self.attn.decode(rms_norm(x, self.ln1, self.eps), kv_cache,
                                 offset, kv_scales)
        return x + self.mlp(rms_norm(x, self.ln2, self.eps))

    def decode_paged(self, x, kv_pools, page_table, offset, kv_scales=None):
        x = x + self.attn.decode_paged(rms_norm(x, self.ln1, self.eps),
                                       kv_pools, page_table, offset,
                                       kv_scales)
        return x + self.mlp(rms_norm(x, self.ln2, self.eps))


class Qwen3(nn.Module):
    """Weights are allocated uninitialised on ``device`` (default CUDA), or
    on ``mesh``'s device for a world of ``mesh.world_size`` ranks; fill them
    with `init_params` or `load_jax_params`."""

    def __init__(self, config: ModelConfig, mode: str = "fused",
                 device=None, mesh: Optional[MeshContext] = None):
        super().__init__()
        if mode not in ("xla", "fused"):
            raise ValueError(f"mode {mode!r}: a Qwen3 runs 'xla' or 'fused' "
                             "(w8a8 is a TPMLP layer mode)")
        world = 1 if mesh is None else mesh.world_size
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.config = config
        self.mode = mode
        self.mesh = mesh
        self.world_size = world
        self.device = resolve_device(device)
        self.dtype = getattr(torch, config.dtype)
        dev, dt = self.device, self.dtype
        h, vocab = config.hidden_size, config.vocab_size
        self.embed = weight(vocab, h, dtype=dt, device=dev)
        self.layers = nn.ModuleList(
            Qwen3Layer(config, mode, dt, dev, world)
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
        matrices (the MoE router and experts too) and embeddings, unit
        norms.  Returns self."""
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
        layout, leaves as numpy arrays) into this module.  At world W the
        tree is the JAX world-W model's: ``wqkv`` and ``gate_up`` put each
        rank's columns together ([q_r | k_r | v_r], [gate_r | up_r]), and
        ``wo``/``down`` are row-sharded.  Returns self."""
        w = self.world_size

        def put(dst, src, name=""):
            src = torch.from_numpy(np.array(src, dtype=np.float32))
            src = tp_layout(name, src, w)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

        for layer, lp in zip(self.layers, tree["layers"], strict=True):
            put(layer.ln1, lp["ln1"])
            put(layer.ln2, lp["ln2"])
            put(layer.attn.wqkv, lp["attn"]["wqkv"], "wqkv")
            put(layer.attn.wo, lp["attn"]["wo"], "wo")
            if self.config.qk_norm:
                put(layer.attn.q_norm, lp["attn"]["q_norm"])
                put(layer.attn.k_norm, lp["attn"]["k_norm"])
            for name in _mlp_names(self.config):
                put(getattr(layer.mlp, name), lp["mlp"][name], name)
        put(self.embed, tree["embed"])
        put(self.ln_f, tree["ln_f"])
        if not self.config.tie_word_embeddings:
            put(self.lm_head_w, tree["lm_head"])
        return self

    def to_jax_params(self, grad: bool = False):
        """The inverse of `load_jax_params`: this module's parameters (or,
        with ``grad``, their ``.grad``s, zeros where there is none) as the
        JAX package's pytree of f32 numpy arrays.  With tied embeddings the
        parameter tree's ``lm_head`` is ``embed.T``; the gradient tree has
        no ``lm_head``, because the one tensor's gradient (the gather's and
        the head's together) is under ``embed``."""
        def get(t, name=""):
            if grad:
                t = t.grad if t.grad is not None else torch.zeros_like(t)
            return jax_layout(name, t.detach(),
                               self.world_size).float().cpu().numpy()

        layers = []
        for layer in self.layers:
            attn = {"wqkv": get(layer.attn.wqkv, "wqkv"),
                    "wo": get(layer.attn.wo, "wo")}
            if self.config.qk_norm:
                attn["q_norm"] = get(layer.attn.q_norm)
                attn["k_norm"] = get(layer.attn.k_norm)
            mlp = {name: get(getattr(layer.mlp, name), name)
                   for name in _mlp_names(self.config)}
            layers.append({"ln1": get(layer.ln1), "ln2": get(layer.ln2),
                           "attn": attn, "mlp": mlp})
        tree = {"embed": get(self.embed), "layers": layers,
                "ln_f": get(self.ln_f)}
        if not self.config.tie_word_embeddings:
            tree["lm_head"] = get(self.lm_head_w)
        elif not grad:
            tree["lm_head"] = tree["embed"].T
        return tree

    @torch.no_grad()
    def reshard(self, world: int) -> "Qwen3":
        """A world-``world`` model (``mesh=make_mesh(world)`` on this
        model's device) holding this world-1 model's weights: rank r gets
        the query heads r H/W .., their KV heads, the ffn columns r F/W ..
        of gate and of up, and the matching rows of ``wo`` and ``down`` (as
        the JAX `load_hf_weights` interleaves them, `_interleave_gate_up`).
        The norms, the embedding and the head are shared, not copied."""
        from triton_distributed_tpu_torch.parallel.mesh import make_mesh
        if self.world_size != 1:
            raise ValueError(f"reshard: the model is at world "
                             f"{self.world_size}, not 1")
        cfg = self.config
        if cfg.is_moe:
            raise NotImplementedError(
                "reshard: an MoE model is not resharded (the copy would hold "
                "its experts twice on one device); build the MoE model at "
                "world W with mesh=make_mesh(W) and load its weights there")
        out = Qwen3(cfg, self.mode, mesh=make_mesh(world, device=self.device))
        d = cfg.head_dim
        split = [cfg.num_heads * d, cfg.num_kv_heads * d,
                 cfg.num_kv_heads * d]
        for src, dst in zip(self.layers, out.layers, strict=True):
            dst.ln1, dst.ln2 = src.ln1, src.ln2
            dst.attn.wqkv.copy_(_interleave(
                torch.split(src.attn.wqkv, split, dim=1), world))
            dst.attn.wo.copy_(stack_rows(src.attn.wo, world))
            if cfg.qk_norm:
                dst.attn.q_norm = src.attn.q_norm
                dst.attn.k_norm = src.attn.k_norm
            dst.mlp.gate_up.copy_(_interleave(
                torch.chunk(src.mlp.gate_up, 2, dim=1), world))
            dst.mlp.down.copy_(stack_rows(src.mlp.down, world))
        out.embed, out.ln_f = self.embed, self.ln_f
        if not cfg.tie_word_embeddings:
            out.lm_head_w = self.lm_head_w
        return out

    def _shard(self, x):
        """Global rows (M, hidden) -> the ranks' (W, M/W, hidden) (the
        JAX bodies' per-rank ``dynamic_slice`` of the embedded rows); at
        world 1, x itself."""
        return x if self.world_size == 1 else self.mesh.shard_rows(x)

    def _gather(self, x):
        """The ranks' rows -> the global (M, hidden) (JAX ``all_gather``,
        ``tiled=True``); at world 1, x itself."""
        return x if self.world_size == 1 else self.mesh.gather_rows(x)

    def create_cache(self, batch: int, max_seq: Optional[int] = None):
        cfg = self.config
        return KVCache.create(cfg.num_layers, batch, cfg.num_kv_heads,
                              max_seq or cfg.max_seq_len, cfg.head_dim,
                              self.dtype, device=self.device,
                              quantized=cfg.quantize_kv_cache)

    def create_paged_cache(self, batch: int, num_pages: int,
                           page_size: int, max_pages_per_seq: int):
        """Zeroed page pools; ``num_pages`` includes the null page."""
        cfg = self.config
        return PagedKVCache.create(
            cfg.num_layers, num_pages, batch, cfg.num_kv_heads, page_size,
            cfg.head_dim, max_pages_per_seq, self.dtype, device=self.device,
            quantized=cfg.quantize_kv_cache)

    def forward(self, input_ids):
        """The differentiable prefill: input_ids (B, S) -> f32 logits
        (B, V) of the last position, with no cache.  (JAX:
        `Qwen3.prefill_shard(params, ids, None)`.)"""
        return self._prefill(input_ids, None)

    @torch.inference_mode()
    def prefill(self, input_ids, cache: Optional[KVCache]):
        """input_ids: (B, S).  Writes positions [0, S) of ``cache`` in
        place and sets its offset to S.  Returns f32 logits (B, V) of the
        last position.  (JAX: `Qwen3.make_prefill_fn`.)"""
        return self._prefill(input_ids, cache)

    def _prefill(self, input_ids, cache: Optional[KVCache]):
        b, s = input_ids.shape
        x = self._shard(self.embed[input_ids.long()].reshape(b * s, -1))
        for li, layer in enumerate(self.layers):
            x, (k, v) = layer.prefill(x, b)
            if cache is not None:
                cache.write_prefill(li, k, v)
        x = self._gather(rms_norm(x, self.ln_f, self.config.rms_norm_eps))
        last = x.reshape(b, s, -1)[:, -1]
        if cache is not None:
            cache.set_offset(s)
        return dot_f32(last, self.lm_head)

    @torch.inference_mode()
    def decode(self, tokens, cache: KVCache):
        """tokens: (B,).  Writes each row's position ``cache.offset`` in
        place and advances the offset by one.  Returns f32 logits (B, V).
        (JAX: `Qwen3.make_decode_fn`.)"""
        x = self._decode_rows(tokens)
        for li, layer in enumerate(self.layers):
            k, v, ks, vs = cache.layer(li)
            x = layer.decode(x, (k, v), cache.offset,
                             None if ks is None else (ks, vs))
        x = self._gather(rms_norm(x, self.ln_f, self.config.rms_norm_eps))
        cache.inc_offset(1)
        return dot_f32(x, self.lm_head)

    @torch.inference_mode()
    def decode_paged(self, tokens, cache: PagedKVCache):
        """`decode` over a `PagedKVCache`: each row's new K/V goes in place
        to its page for position ``cache.offset``, attention reads through
        ``cache.page_table``, and every offset advances by one.  Returns
        f32 logits (B, V).  (JAX: `Qwen3.make_paged_decode_fn`.)"""
        x = self._decode_rows(tokens)
        for li, layer in enumerate(self.layers):
            k, v, ks, vs = cache.layer(li)
            x = layer.decode_paged(x, (k, v), cache.page_table, cache.offset,
                                   None if ks is None else (ks, vs))
        x = self._gather(rms_norm(x, self.ln_f, self.config.rms_norm_eps))
        cache.inc_offset(1)
        return dot_f32(x, self.lm_head)

    def _decode_rows(self, tokens):
        """The decode step's embedded rows, sharded over the ranks: at
        world W the batch must split evenly (JAX `decode_shard` slices
        B / W rows a rank)."""
        if tokens.shape[0] % self.world_size:
            raise ValueError(f"decode batch {tokens.shape[0]} does not split "
                             f"over world_size={self.world_size}: a rank "
                             "takes B / W rows")
        return self._shard(self.embed[tokens.long()])
