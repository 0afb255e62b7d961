"""Model configuration: a copy of `triton_distributed_tpu/models/config.py`
`ModelConfig` with its fields and presets (``from_hf`` is not ported
yet)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    architecture: str = "qwen3"
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    qk_norm: bool = True
    tie_word_embeddings: bool = True
    max_seq_len: int = 4096
    dtype: str = "bfloat16"
    # MoE (Qwen3-MoE style: every MLP is an expert layer when
    # num_experts > 0)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None   # per-expert ffn
    moe_capacity_factor: float = 2.0
    #: Int8-quantize the KV cache (per-token scales).
    quantize_kv_cache: bool = False

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @classmethod
    def qwen3_0_6b(cls):
        return cls(hidden_size=1024, intermediate_size=3072,
                   num_layers=28, num_heads=16, num_kv_heads=8,
                   head_dim=128)

    @classmethod
    def qwen3_8b(cls):
        return cls(hidden_size=4096, intermediate_size=12288,
                   num_layers=36, num_heads=32, num_kv_heads=8,
                   head_dim=128, tie_word_embeddings=False)

    @classmethod
    def qwen3_32b(cls):
        return cls(hidden_size=5120, intermediate_size=25600,
                   num_layers=64, num_heads=64, num_kv_heads=8,
                   head_dim=128, tie_word_embeddings=False)

    @classmethod
    def draft_of(cls, target: "ModelConfig", **kw):
        """A cheap draft model beside ``target`` for speculative decoding:
        the same vocabulary, sequence capacity and dtype, a fraction of
        the depth and width.  Override any field via ``kw``."""
        d = dict(architecture=target.architecture,
                 vocab_size=target.vocab_size,
                 hidden_size=512, intermediate_size=1536,
                 num_layers=4, num_heads=8, num_kv_heads=4,
                 head_dim=64, rms_norm_eps=target.rms_norm_eps,
                 rope_theta=target.rope_theta,
                 tie_word_embeddings=True,
                 max_seq_len=target.max_seq_len,
                 dtype=target.dtype,
                 quantize_kv_cache=target.quantize_kv_cache)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, **kw):
        """Test-size config."""
        d = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                 num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
                 max_seq_len=128)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny_moe(cls, **kw):
        """Test-size MoE config."""
        d = dict(num_experts=4, num_experts_per_tok=2,
                 moe_intermediate_size=128)
        d.update(kw)
        return cls.tiny(**d)
