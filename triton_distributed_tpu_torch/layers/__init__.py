"""Attention, MLP and MoE layers, at world 1 and (dense layers) at
world W."""
