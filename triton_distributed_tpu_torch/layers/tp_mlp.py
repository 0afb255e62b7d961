"""MLP layer (port of `triton_distributed_tpu/layers/tp_mlp.py`):
up-projection to [gate | up], gated SiLU, down-projection.

At world 1 the ``xla`` and ``fused`` modes compute the same plain products
(the JAX package's AllGather-GEMM and GEMM-ReduceScatter reduce to dots
there) and differentiate through ``torch.matmul`` (at world 1 the JAX
package's `ag_gemm_diff`/`gemm_rs_diff` are dots).  The ``w8a8`` mode holds
int8 weights with per-output-channel scales (`TPMLP.quantize_params`) and
runs both projections on the int8 GEMM kernel
(`kernels.quantized.matmul_w8a8`), with the activations quantized per row
on the fly; it has no backward and refuses a gradient, as the JAX layer's
``training`` assert does.

At world W > 1 (gate/up column-parallel, down row-parallel, one process
holding every rank: `parallel.mesh`) the weights are rank-stacked,
``gate_up`` (W, hidden, 2 ffn_loc) with columns [gate_r | up_r] and
``down`` (W, ffn_loc, hidden), and x is row-sharded (W, M/W, hidden).
``fused`` (JAX `_fwd_fused` :111) is `ag_gemm` (K12), gated SiLU, then
`gemm_rs` (K14), whose partials are rounded to x's dtype before their sum;
``xla`` (JAX `_fwd_xla` :102) runs their ``"xla"`` method: gather by
reshape, a library product, and the f32 partials summed unrounded
(`gemm_rs_nonoverlap`, as JAX `_psum_scatter_rows` :93).  ``w8a8`` (JAX
`_fwd_w8a8` :145) holds each rank's weights quantized per rank
(`quantize_params` of the rank-stacked weights, as the JAX layer
quantizes its shards): `ag_gemm_w8a8` (K13), gated SiLU, the rows
quantized per row, `matmul_w8a8` (K7) a rank out in f32, then the f32 sum
over the ranks, cast to x's dtype.  Training at world > 1 raises
`NotImplementedError` naming its kernels.

The int8 weights that K7 reads (``gate_up_q`` and ``down_q`` at world 1,
``down_q`` at world W) are stored K-major once, as the transposed views of
contiguous (..., n, k) tensors (`tp_attn.weight_k_major`): K7's `wgmma`
takes 8-bit operands K-major only, and reads them in place, with no copy
a call.  Their names, shapes and values are the JAX layout's, so
`quantize_params`, `load_quantized` and ``state_dict`` carry the JAX
package's arrays unchanged.  ``gate_up_q`` at world W feeds K13, which
reads (k, n), and stays so.

``fused_ar`` (JAX `_fwd_fused_ar` :167) takes x replicated, (M, hidden) at
every world: each rank's gate_up and down products are library products
(JAX computes them with ``jnp.dot``, outside Pallas), the partial rounded
to x's dtype, then `kernels.allreduce.all_reduce` (K17) sums the partials,
at world 1 too, as JAX does.  At world W it returns every rank's copy,
(W, M, hidden).  It has no backward."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from triton_distributed_tpu_torch import collective_ids as cids
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    AllGatherGEMMContext, ag_gemm, ag_gemm_w8a8)
from triton_distributed_tpu_torch.kernels.allreduce import (
    AllReduceContext, all_reduce)
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    GEMMReduceScatterContext, gemm_rs)
from triton_distributed_tpu_torch.kernels.quantized import (
    matmul_w8a8, quantize_sym)
from triton_distributed_tpu_torch.kernels.reduce_scatter import (
    sum_in_rank_order)
from triton_distributed_tpu_torch.layers.tp_attn import (
    collective_method, normal_init_, require_ported, tp_layout, weight,
    weight_k_major)

MODES = ("xla", "fused", "fused_ar", "w8a8")

#: The w8a8 mode's parameters, as `TPMLP.quantize_params` names them.
QUANTIZED = ("gate_up_q", "gate_up_scale", "down_q", "down_scale")


def gated_silu(gate_up):
    """SiLU(gate) * up for stacked [gate | up]: (..., 2n) -> (..., n).
    The SiLU runs in f32 and is cast back before the product (as
    `kernels/allgather_group_gemm.py` `gated_silu`)."""
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    return F.silu(gate.float()).to(gate.dtype) * up


def mlp_w8a8(x, gate_up_q, gate_up_scale, down_q, down_scale,
             matmul=matmul_w8a8):
    """The w8a8 forward at world 1 (JAX `TPMLP._fwd_w8a8`, whose
    `ag_gemm_w8a8` is ``quantize_sym`` + `matmul_w8a8` at world 1): x
    quantized per row, int8 up-projection out in x's dtype, gated SiLU, h
    quantized per row, int8 down-projection out in f32, cast to x's dtype.
    ``matmul``: the int8 GEMM (its plain version for a reference run)."""
    x_q, sx = quantize_sym(x, 1)
    h = gated_silu(matmul(x_q, gate_up_q, sx, gate_up_scale,
                          out_dtype=x.dtype))
    h_q, sh = quantize_sym(h, 1)
    return matmul(h_q, down_q, sh, down_scale,
                  out_dtype=torch.float32).to(x.dtype)


class TPMLP(nn.Module):
    """Weights at world 1: ``gate_up`` (hidden, 2 ffn) as [gate | up],
    ``down`` (ffn, hidden); in ``w8a8`` mode their int8 forms
    ``gate_up_q``, ``down_q`` with f32 per-output-channel scales
    ``gate_up_scale`` (2 ffn,), ``down_scale`` (hidden,) instead.  At world
    W: ``gate_up`` (W, hidden, 2 ffn_loc) as [gate_r | up_r] and ``down``
    (W, ffn_loc, hidden)."""

    def __init__(self, hidden: int, ffn: int, mode: str = "fused",
                 world_size: int = 1, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES} (the others are "
                             "not ported yet)")
        if ffn % world_size:
            raise ValueError(f"ffn={ffn} does not split over "
                             f"world_size={world_size}")
        self.hidden = hidden
        self.ffn = ffn
        self.mode = mode
        self.world_size = world_size
        f = ffn // world_size
        ranks = (world_size,) if world_size > 1 else ()
        if mode == "w8a8":
            self.gate_up_q = (weight_k_major if world_size == 1 else weight)(
                *ranks, hidden, 2 * f, dtype=torch.int8, device=device)
            self.gate_up_scale = weight(*ranks, 2 * f, dtype=torch.float32,
                                        device=device)
            self.down_q = weight_k_major(*ranks, f, hidden, dtype=torch.int8,
                                         device=device)
            self.down_scale = weight(*ranks, hidden, dtype=torch.float32,
                                     device=device)
        else:
            self.gate_up = weight(*ranks, hidden, 2 * f, dtype=dtype,
                                  device=device)
            self.down = weight(*ranks, f, hidden, dtype=dtype, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """N(0, 1/hidden) weights; in w8a8 mode the same draws, quantized
        (what `quantize_params` makes of a float layer's weights)."""
        std = self.hidden ** -0.5
        if self.mode != "w8a8":
            normal_init_(self.gate_up, generator, std)
            normal_init_(self.down, generator, std)
            return
        dev = self.gate_up_q.device
        floats = {}
        for name, shape in (("gate_up", self.gate_up_q.shape),
                            ("down", self.down_q.shape)):
            floats[name] = torch.empty(shape, device=dev)
            normal_init_(floats[name], generator, std)
        self.load_quantized(self.quantize_params(floats))

    @staticmethod
    def quantize_params(params):
        """One-time symmetric int8 weight quantization per output channel
        (over the rows, axis -2) for the ``w8a8`` mode: ``{"gate_up",
        "down"}`` float tensors -> ``{"gate_up_q", "gate_up_scale",
        "down_q", "down_scale"}``, as the JAX `TPMLP.quantize_params`; at
        world W each rank's shard of the rank-stacked weights apart, as
        the JAX layer quantizes its shards."""
        gq, gs = quantize_sym(params["gate_up"], -2)
        dq, ds = quantize_sym(params["down"], -2)
        return {"gate_up_q": gq, "gate_up_scale": gs,
                "down_q": dq, "down_scale": ds}

    @torch.no_grad()
    def load_quantized(self, qparams) -> "TPMLP":
        """Copy quantized parameters (`quantize_params` output, tensors or
        numpy arrays such as the JAX package's) into a ``w8a8`` layer.
        Returns self."""
        if self.mode != "w8a8":
            raise ValueError(f"load_quantized: mode is {self.mode!r}, "
                             "not 'w8a8'")
        for name in QUANTIZED:
            dst = getattr(self, name)
            src = qparams[name]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src))
            if src.dtype != dst.dtype or tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: {src.dtype} {tuple(src.shape)} != "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
        return self

    @torch.no_grad()
    def load_jax_params(self, params) -> "TPMLP":
        """Copy the JAX layer's global weights (tensors or numpy arrays)
        into a float layer: ``gate_up`` (hidden, 2 ffn) whose columns are
        each rank's [gate_r | up_r] in rank order, and ``down`` (ffn,
        hidden) row-sharded, as the JAX layer is called on them under
        ``shard_map`` (P(None, axis), P(axis, None)).  Returns self."""
        if self.mode == "w8a8":
            raise ValueError("load_jax_params: a w8a8 layer takes "
                             "load_quantized")
        for name in ("gate_up", "down"):
            dst = getattr(self, name)
            src = params[name]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src, dtype=np.float32))
            src = tp_layout(name, src, self.world_size)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        return self

    def forward(self, x):
        """x (M, hidden) -> (M, hidden); at world W x (W, M/W, hidden) ->
        the same rows (W, M/W, hidden), and in ``fused_ar`` mode x (M,
        hidden) replicated -> (W, M, hidden), every rank's copy."""
        if self.mode == "fused_ar":
            return self._forward_fused_ar(x)
        if self.mode == "w8a8":
            if torch.is_grad_enabled() and x.requires_grad:
                raise NotImplementedError(
                    "TPMLP(mode='w8a8') has no backward: training runs the "
                    "'xla' or 'fused' mode")
            if self.world_size > 1:
                return self._forward_w8a8_tp(x)
            return mlp_w8a8(x, *(getattr(self, n) for n in QUANTIZED))
        if self.world_size > 1:
            return self._forward_tp(x)
        return torch.matmul(gated_silu(torch.matmul(x, self.gate_up)),
                            self.down)

    def _forward_fused_ar(self, x):
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.gate_up.requires_grad):
            raise NotImplementedError(
                "TPMLP(mode='fused_ar') has no backward: training runs the "
                "'xla' or 'fused' mode")
        w = self.world_size
        partial = torch.matmul(gated_silu(torch.matmul(x, self.gate_up)),
                               self.down)
        out = all_reduce(partial.reshape(w, *x.shape), AllReduceContext(
            "tp", w, collective_id=cids.TP_MLP_AR))
        return out if w > 1 else out[0]

    def _forward_tp(self, x):
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.gate_up.requires_grad):
            require_ported(self.world_size, "grad")
        w, method = self.world_size, collective_method(self.mode)
        h = ag_gemm(x, self.gate_up, AllGatherGEMMContext(
            "tp", w, method, collective_id=cids.TP_MLP_AG))
        return gemm_rs(gated_silu(h), self.down, GEMMReduceScatterContext(
            "tp", w, method, collective_id=cids.TP_MLP_RS))

    def _forward_w8a8_tp(self, x):
        w = self.world_size
        h = gated_silu(ag_gemm_w8a8(x, self.gate_up_q, self.gate_up_scale,
                                    AllGatherGEMMContext(
                                        "tp", w, collective_id=cids.TP_MLP_AG)))
        h_q, sh = quantize_sym(h, -1)
        partial = torch.stack([matmul_w8a8(h_q[r], self.down_q[r], sh[r],
                                           self.down_scale[r],
                                           out_dtype=torch.float32)
                               for r in range(w)])      # (W, W m, hidden)
        # JAX `_psum_scatter_rows`: rank c's rows of the f32 sum.
        return sum_in_rank_order(partial.reshape(
            w, w, -1, partial.shape[-1])).to(x.dtype)
