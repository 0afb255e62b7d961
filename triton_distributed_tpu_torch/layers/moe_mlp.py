"""MoE MLP at ``world_size == 1`` (port of `triton_distributed_tpu/layers/
moe_mlp.py` `MoEMLP`).

Router (an f32 product, softmax, top-k renormalized), capacity-padded
buckets per expert (`kernels.moe_utils`), the gate/up grouped GEMM
(`grouped_matmul`, K8) out in the activations' dtype, gated SiLU, the down
grouped GEMM out in f32, and the weighted combine back to token order.  At
world 1 the JAX layer sends every mode to this golden ``xla`` path
(`MoEMLP.__call__`), ``w8a8`` after dequantizing its int8 weights; so does
this one.  The grouped GEMMs differentiate through `grouped_matmul_diff`
(backward: ``torch.bmm``, as the JAX package leaves the einsums'
transposes to XLA).  The fused ring pipeline (`ag_group_gemm`,
`moe_reduce_rs_fused`) and expert parallelism over several GPUs are not
ported yet.

Weights, in the JAX package's layout: ``router`` (hidden, E) f32 whatever
the model's dtype, ``gate_up`` (E, hidden, 2 ffn) as [gate | up] per
expert, ``down`` (E, ffn, hidden).
"""

from __future__ import annotations

import torch
from torch import nn

from triton_distributed_tpu_torch.kernels import moe_utils
from triton_distributed_tpu_torch.kernels.grouped_gemm import (
    grouped_matmul_diff)
from triton_distributed_tpu_torch.kernels.quantized import quantize_sym
from triton_distributed_tpu_torch.layers.tp_attn import (
    normal_init_, require_ported, weight)
from triton_distributed_tpu_torch.layers.tp_mlp import gated_silu

MODES = ("xla", "fused", "w8a8")


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


class MoEMLP(nn.Module):
    """One MoE MLP of ``num_experts`` experts of width ``ffn``, ``topk``
    experts a token, ``capacity_factor`` times the even share of slots an
    expert.  Modes as the JAX layer's: ``xla``, ``fused`` (at world 1 the
    same path) and ``w8a8`` (int8 weights `quantize_params` makes,
    dequantized for the float path at world 1)."""

    def __init__(self, hidden: int, ffn: int, num_experts: int,
                 topk: int = 2, capacity_factor: float = 2.0,
                 mode: str = "fused", world_size: int = 1, *,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        require_ported(world_size, "moe")
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.hidden = hidden
        self.ffn = ffn
        self.num_experts = num_experts
        self.topk = topk
        self.capacity_factor = capacity_factor
        self.mode = mode
        self.dtype = dtype
        e = num_experts
        self.router = weight(hidden, e, dtype=torch.float32, device=device)
        if mode == "w8a8":
            self.gate_up_q = weight(e, hidden, 2 * ffn, dtype=torch.int8,
                                    device=device)
            self.gate_up_scale = weight(e, 2 * ffn, dtype=torch.float32,
                                        device=device)
            self.down_q = weight(e, ffn, hidden, dtype=torch.int8,
                                 device=device)
            self.down_scale = weight(e, hidden, dtype=torch.float32,
                                     device=device)
        else:
            self.gate_up = weight(e, hidden, 2 * ffn, dtype=dtype,
                                  device=device)
            self.down = weight(e, ffn, hidden, dtype=dtype, device=device)

    def capacity(self, tokens: int) -> int:
        """Expert capacity for ``tokens`` routed tokens: the even share
        times the capacity factor, at least and a multiple of 16 (32 for
        w8a8, int8's tiling on the TPU; kept so routing is the JAX
        package's)."""
        align = 32 if self.mode == "w8a8" else 16
        even = tokens * self.topk / self.num_experts
        return _round_up(max(int(even * self.capacity_factor), align), align)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """N(0, 1/hidden) router (f32), gate_up and down, as the JAX
        layer's distributions; in w8a8 mode the float draws quantized."""
        std = self.hidden ** -0.5
        normal_init_(self.router, generator, std)
        if self.mode != "w8a8":
            normal_init_(self.gate_up, generator, std)
            normal_init_(self.down, generator, std)
            return
        floats = {}
        for name, shape in (("gate_up", self.gate_up_q.shape),
                            ("down", self.down_q.shape)):
            floats[name] = torch.empty(shape, dtype=self.dtype,
                                       device=self.router.device)
            normal_init_(floats[name], generator, std)
        q = self.quantize_params({"router": self.router, **floats})
        for name in ("gate_up_q", "gate_up_scale", "down_q", "down_scale"):
            getattr(self, name).copy_(q[name])

    @staticmethod
    def quantize_params(params):
        """One-time per-expert, per-output-channel symmetric int8 weight
        quantization (over the contraction axis 1) for mode ``w8a8``:
        ``{"router", "gate_up", "down"}`` -> ``{"router", "gate_up_q",
        "gate_up_scale", "down_q", "down_scale"}``; the router stays f32."""
        gq, gs = quantize_sym(params["gate_up"], 1)
        dq, ds = quantize_sym(params["down"], 1)
        return {"router": params["router"], "gate_up_q": gq,
                "gate_up_scale": gs, "down_q": dq, "down_scale": ds}

    @staticmethod
    def dequantize_params(params, dtype=torch.bfloat16):
        """The float view of w8a8 parameters: q * scale in f32, cast to
        ``dtype``."""
        return {
            "router": params["router"],
            "gate_up": (params["gate_up_q"].float()
                        * params["gate_up_scale"][:, None, :]).to(dtype),
            "down": (params["down_q"].float()
                     * params["down_scale"][:, None, :]).to(dtype),
        }

    def params(self):
        """This layer's weights as a dict, by the JAX names."""
        names = (("router", "gate_up_q", "gate_up_scale", "down_q",
                  "down_scale") if self.mode == "w8a8"
                 else ("router", "gate_up", "down"))
        return {n: getattr(self, n) for n in names}

    def forward(self, x):
        """x: (n, hidden) -> (n, hidden) in x's dtype."""
        params = self.params()
        if self.mode == "w8a8":
            params = self.dequantize_params(params, x.dtype)
        return self.forward_xla(x, params)

    def forward_xla(self, x, params):
        """The golden path at world 1 (JAX `MoEMLP._fwd_xla`): route,
        bucket, the two grouped GEMMs on K8, combine."""
        cap = self.capacity(x.shape[0])
        ids, w = route(x, params["router"], self.topk)
        routing = moe_utils.route_capacity(ids, self.num_experts, cap)
        buckets = moe_utils.gather_tokens(x, routing.dispatch_index)
        inter = grouped_matmul_diff(buckets, params["gate_up"])
        act = gated_silu(inter)                        # (E, cap, ffn)
        partial = grouped_matmul_diff(act, params["down"],
                                      out_dtype=torch.float32)
        return moe_utils.combine_tokens(partial, ids, routing.slot_of_pair,
                                        w).to(x.dtype)
