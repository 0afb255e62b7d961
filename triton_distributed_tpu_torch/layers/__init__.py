"""Attention, MLP and MoE layers, at world 1 and (dense layers) at
world W, and the expert-parallel AllToAll layer."""

from triton_distributed_tpu_torch.layers.ep_a2a_layer import (  # noqa: F401
    EPAll2AllLayer, HierarchicalEPAll2AllLayer)
