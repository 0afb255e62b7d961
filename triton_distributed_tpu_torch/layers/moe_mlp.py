"""Tensor-parallel MoE MLP, the fused AG-MoE-RS module (port of
`triton_distributed_tpu/layers/moe_mlp.py` `MoEMLP`).

Router (an f32 product, softmax, top-k renormalized), capacity-padded
buckets per expert (`kernels.moe_utils`), the gate/up grouped GEMM out in
the activations' dtype, gated SiLU, the down grouped GEMM, and the
weighted combine back to token order.

World 1: every mode runs the golden ``xla`` path, as the JAX layer's
`__call__` sends it there (``w8a8`` after dequantizing its int8 weights):
the two expert products on `grouped_matmul` (K8), the down product out in
f32.  They differentiate through `grouped_matmul_diff` (backward:
``torch.bmm``, as the JAX package leaves the einsums' transposes to XLA).

World W (one process holding every rank, `parallel.mesh`): x is
row-sharded (W, mc, hidden); ``gate_up`` (W, E, hidden, 2 ffn_loc) holds
rank r's columns [gate_r | up_r] of every expert, ``down`` (W, E,
ffn_loc, hidden) its rows; the router (hidden, E) is replicated.  Each
chunk of mc tokens is routed with its own capacity (`moe_utils.
plan_chunks`).
- ``xla`` (JAX `_fwd_xla`): the rows gathered by reshape, routed, the
  expert products of every rank on K8, the combine, and the sum over the
  ranks of the partials rounded to x's dtype, in f32.
- ``fused`` (JAX `_fwd_fused`): each rank routes its own rows and buckets
  them, the routing ids and weights are gathered (`_route_bucket_plan`);
  `ag_group_gemm` (K11) gathers the buckets and runs gate/up on the row
  tiles that hold tokens; gated SiLU; `moe_reduce_rs_fused` (K10) runs
  down on the packed blocks, combines and reduce-scatters.
- ``w8a8`` (JAX `_fwd_w8a8`): the same on the int8 forms, K11-int8 and K10
  with int8 weights (`quantize_params` of the global weights: per expert
  and output channel, ``down_scale`` (E, hidden) over the whole ffn, so
  replicated).
Below 16 rows a rank (8 in f32) ``fused`` and ``w8a8`` take the ``xla``
path, as the JAX layer does (decode).  Training at world > 1 raises.

Weights, in the JAX package's global layout at `load_jax_params`:
``router`` (hidden, E) f32 whatever the model's dtype, ``gate_up`` (E,
hidden, 2 ffn) as each rank's [gate_r | up_r] in rank order, ``down`` (E,
ffn, hidden); in ``w8a8`` mode ``gate_up_q``, ``gate_up_scale`` (E, 2 ffn),
``down_q``, ``down_scale`` (E, hidden).  At world W the int8 ``gate_up_q``
(W, E, hidden, 2 ffn_loc) is stored K-major once, as the transposed view of
a contiguous (W, E, 2 ffn_loc, hidden) tensor (`tp_attn.weight_k_major`),
which K11-int8's `wgmma` reads in place; ``down_q`` feeds K10 with int8
weights and stays (k, n).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels import moe_utils
from triton_distributed_tpu_torch.kernels.allgather_group_gemm import (
    AGGroupGEMMContext, ag_group_gemm, ag_group_gemm_w8a8)
from triton_distributed_tpu_torch.kernels.grouped_gemm import (
    grouped_matmul_diff)
from triton_distributed_tpu_torch.kernels.moe_reduce_rs import (
    MoEReduceRSContext, moe_reduce_rs_fused)
from triton_distributed_tpu_torch.kernels.quantized import quantize_sym
from triton_distributed_tpu_torch.kernels.reduce_scatter import (
    sum_in_rank_order)
from triton_distributed_tpu_torch.layers.tp_attn import (
    jax_layout, normal_init_, require_ported, tp_layout, weight,
    weight_k_major)
from triton_distributed_tpu_torch.layers.tp_mlp import gated_silu

MODES = ("xla", "fused", "w8a8")
FLOAT_PARAMS = ("router", "gate_up", "down")
W8A8_PARAMS = ("router", "gate_up_q", "gate_up_scale", "down_q",
               "down_scale")


def _round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


def route(x, router, topk: int):
    """Top-``topk`` expert ids (n, topk) int32 and renormalized f32
    weights of tokens x (n, hidden) under ``router`` (hidden, E) f32.

    The router product runs in full f32: a TF32 rounding moves choices
    near ties, so a CUDA product refuses to run under TF32.  Ties go to
    the lower expert index, as ``lax.top_k`` orders them (a stable
    descending sort; ``torch.topk`` promises no order)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("MoE router: torch.backends.cuda.matmul."
                           "allow_tf32 is on; routing needs full f32 "
                           "products")
    logits = torch.matmul(x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    ids = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :topk]
    w = probs.gather(-1, ids)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return ids.to(torch.int32), w


def gather_chunks(x, dispatch_index):
    """Every chunk's buckets: x (W, mc, h), dispatch_index (W, E, cap)
    chunk-local (sentinel mc: a zero row) -> (W, E, cap, h)."""
    padded = torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)
    chunk = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return padded[chunk, dispatch_index.long()]


class MoEMLP(nn.Module):
    """One MoE MLP of ``num_experts`` experts of width ``ffn``, ``topk``
    experts a token, ``capacity_factor`` times the even share of slots an
    expert, over ``world_size`` ranks.  Modes as the JAX layer's: ``xla``,
    ``fused`` and ``w8a8`` (int8 weights `quantize_params` makes)."""

    def __init__(self, hidden: int, ffn: int, num_experts: int,
                 topk: int = 2, capacity_factor: float = 2.0,
                 mode: str = "fused", world_size: int = 1, *,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if ffn % world_size:
            raise ValueError(f"ffn={ffn} does not split over "
                             f"world_size={world_size}")
        self.hidden = hidden
        self.ffn = ffn
        self.num_experts = num_experts
        self.topk = topk
        self.capacity_factor = capacity_factor
        self.mode = mode
        self.world_size = world_size
        self.dtype = dtype
        e, f = num_experts, ffn // world_size
        ranks = (world_size,) if world_size > 1 else ()
        self.router = weight(hidden, e, dtype=torch.float32, device=device)
        if mode == "w8a8":
            # At world W K11-int8 reads gate_up_q K-major: stored so once.
            self.gate_up_q = (weight_k_major if world_size > 1 else weight)(
                *ranks, e, hidden, 2 * f, dtype=torch.int8, device=device)
            self.gate_up_scale = weight(*ranks, e, 2 * f,
                                        dtype=torch.float32, device=device)
            self.down_q = weight(*ranks, e, f, hidden, dtype=torch.int8,
                                 device=device)
            self.down_scale = weight(e, hidden, dtype=torch.float32,
                                     device=device)
        else:
            self.gate_up = weight(*ranks, e, hidden, 2 * f, dtype=dtype,
                                  device=device)
            self.down = weight(*ranks, e, f, hidden, dtype=dtype,
                               device=device)

    def capacity(self, tokens: int) -> int:
        """Expert capacity for ``tokens`` routed tokens (a chunk's): the
        even share times the capacity factor, at least and a multiple of
        16 (32 for w8a8, int8's tiling on the TPU; kept so routing is the
        JAX package's, and the int8 packed blocks 32-row aligned)."""
        align = 32 if self.mode == "w8a8" else 16
        even = tokens * self.topk / self.num_experts
        return _round_up(max(int(even * self.capacity_factor), align), align)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """N(0, 1/hidden) router (f32), gate_up and down, as the JAX
        layer's distributions; in w8a8 mode the global float draws,
        quantized."""
        std = self.hidden ** -0.5
        normal_init_(self.router, generator, std)
        if self.mode != "w8a8":
            normal_init_(self.gate_up, generator, std)
            normal_init_(self.down, generator, std)
            return
        e, dev = self.num_experts, self.router.device
        floats = {"router": self.router}
        for name, shape in (("gate_up", (e, self.hidden, 2 * self.ffn)),
                            ("down", (e, self.ffn, self.hidden))):
            floats[name] = torch.empty(shape, dtype=self.dtype, device=dev)
            normal_init_(floats[name], generator, std)
        self.load_jax_params(self.quantize_params(floats))

    @staticmethod
    def quantize_params(params):
        """One-time per-expert, per-output-channel symmetric int8 weight
        quantization (over the contraction axis 1) of the global weights
        for mode ``w8a8``: ``{"router", "gate_up", "down"}`` -> ``{"router",
        "gate_up_q", "gate_up_scale", "down_q", "down_scale"}``; the router
        stays f32."""
        gq, gs = quantize_sym(params["gate_up"], 1)
        dq, ds = quantize_sym(params["down"], 1)
        return {"router": params["router"], "gate_up_q": gq,
                "gate_up_scale": gs, "down_q": dq, "down_scale": ds}

    @staticmethod
    def dequantize_params(params, dtype=torch.bfloat16):
        """The float view of w8a8 parameters (either layout): q * scale in
        f32, cast to ``dtype``, contiguous (the int8 weights may be stored
        K-major)."""
        return {
            "router": params["router"],
            "gate_up": (params["gate_up_q"].float()
                        * params["gate_up_scale"].unsqueeze(-2)).to(
                            dtype, memory_format=torch.contiguous_format),
            "down": (params["down_q"].float()
                     * params["down_scale"].unsqueeze(-2)).to(
                         dtype, memory_format=torch.contiguous_format),
        }

    def params(self):
        """This layer's weights as a dict, by the JAX names."""
        names = W8A8_PARAMS if self.mode == "w8a8" else FLOAT_PARAMS
        return {n: getattr(self, n) for n in names}

    @torch.no_grad()
    def load_jax_params(self, params) -> "MoEMLP":
        """Copy the JAX layer's global weights (tensors or numpy arrays;
        float or, in ``w8a8`` mode, `quantize_params` output) into this
        layer's (rank-stacked) ones.  Returns self."""
        for name, dst in self.params().items():
            src = params[name]
            if not isinstance(src, torch.Tensor):
                src = np.array(src)
                src = torch.from_numpy(src if src.dtype == np.int8
                                       else src.astype(np.float32))
            src = tp_layout(name, src, self.world_size)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        return self

    def jax_params(self):
        """The inverse of `load_jax_params`: this layer's weights in the JAX
        global layout (tensors, not copies where the layout is the
        same)."""
        return {n: jax_layout(n, t.detach(), self.world_size)
                for n, t in self.params().items()}

    def forward(self, x):
        """x: (n, hidden) at world 1, (W, mc, hidden) at world W -> the
        same shape in x's dtype."""
        params = self.params()
        mode = self.mode
        min_rows = 16 if x.element_size() < 4 else 8
        if mode != "xla" and (self.world_size == 1
                              or x.shape[-2] % min_rows):
            # Decode-shaped or one rank: the xla path (JAX `__call__`).
            if mode == "w8a8":
                params = self.dequantize_params(params, x.dtype)
            mode = "xla"
        if self.world_size > 1 and torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, *params.values())):
            require_ported(self.world_size, "grad")
        if mode == "xla":
            return self.forward_xla(x, params)
        buckets, plan = self._route_bucket_plan(x, params["router"])
        w = self.world_size
        ag_ctx = AGGroupGEMMContext("tp", w, self.num_experts,
                                    collective_id=cids.MOE_MLP_AG)
        rs_ctx = MoEReduceRSContext("tp", w, self.num_experts, self.topk,
                                    collective_id=cids.MOE_MLP_RS)
        if mode == "fused":
            act = gated_silu(ag_group_gemm(buckets, params["gate_up"], ag_ctx,
                                           counts=plan.counts))
            return moe_reduce_rs_fused(act, params["down"], plan, rs_ctx)
        act = gated_silu(ag_group_gemm_w8a8(
            buckets, params["gate_up_q"], params["gate_up_scale"], ag_ctx,
            counts=plan.counts))
        return moe_reduce_rs_fused(act, params["down_q"], plan, rs_ctx,
                                   weight_scales=params["down_scale"])

    def _route_bucket_plan(self, x, router):
        """Each rank routes and buckets its own rows (the router product
        over its mc rows); the ids and weights are gathered (a reshape)
        into the replicated per-chunk plan, whose chunk c is rank c's own
        routing.  Returns the buckets (W, E, cap, hidden) and the plan."""
        w, mc, _ = x.shape
        routed = [route(x[r], router, self.topk) for r in range(w)]
        plan = moe_utils.plan_chunks(
            torch.cat([i for i, _ in routed]), torch.cat([p for _, p in routed]),
            w, self.num_experts, self.capacity(mc))
        return gather_chunks(x, plan.dispatch_index), plan

    def forward_xla(self, x, params):
        """The golden path (JAX `MoEMLP._fwd_xla`): route, bucket per
        chunk, the two grouped GEMMs on K8, combine; at world W the rows
        gathered first and the ranks' partials (rounded to x's dtype)
        summed in f32 last."""
        if self.world_size == 1:
            cap = self.capacity(x.shape[0])
            ids, w = route(x, params["router"], self.topk)
            routing = moe_utils.route_capacity(ids, self.num_experts, cap)
            buckets = moe_utils.gather_tokens(x, routing.dispatch_index)
            inter = grouped_matmul_diff(buckets, params["gate_up"])
            act = gated_silu(inter)                        # (E, cap, ffn)
            partial = grouped_matmul_diff(act, params["down"],
                                          out_dtype=torch.float32)
            return moe_utils.combine_tokens(
                partial, ids, routing.slot_of_pair, w).to(x.dtype)
        world, mc, h = x.shape
        e, topk = self.num_experts, self.topk
        cap = self.capacity(mc)
        ids, w = route(x.reshape(world * mc, h), params["router"], topk)
        plan = moe_utils.plan_chunks(ids, w, world, e, cap)
        # (W chunk, E, cap, h) -> (E, W cap, h): one K8 launch a rank and
        # product over every chunk's buckets.
        buckets = gather_chunks(x, plan.dispatch_index).transpose(
            0, 1).reshape(e, world * cap, h)
        ids_c = ids.reshape(world, mc, topk).long()
        kept = plan.slot_of_pair >= 0
        slot = torch.where(kept, plan.slot_of_pair, 0).long()
        wk = torch.where(kept, w.reshape(world, mc, topk), 0.0)
        chunk = torch.arange(world, device=x.device)[:, None, None]
        parts = []
        for r in range(world):
            act = gated_silu(grouped_matmul_diff(buckets,
                                                 params["gate_up"][r]))
            partial = grouped_matmul_diff(act, params["down"][r],
                                          out_dtype=torch.float32)
            partial = partial.reshape(e, world, cap, h).transpose(0, 1)
            vals = partial[chunk, ids_c, slot]          # (W, mc, topk, h)
            parts.append((vals * wk[..., None]).sum(dim=2).to(x.dtype))
        return sum_in_rank_order(torch.stack(parts).float()).to(x.dtype)
