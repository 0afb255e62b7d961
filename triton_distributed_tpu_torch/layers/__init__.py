"""Attention and MLP layers at world_size 1."""
