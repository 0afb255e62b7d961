"""Qwen3 model, KV cache and serving engine."""

from triton_distributed_tpu_torch.models.config import ModelConfig  # noqa: F401
from triton_distributed_tpu_torch.models.kv_cache import (  # noqa: F401
    KVCache, PagedKVCache)
from triton_distributed_tpu_torch.models.qwen import Qwen3  # noqa: F401
from triton_distributed_tpu_torch.models.engine import Engine  # noqa: F401
