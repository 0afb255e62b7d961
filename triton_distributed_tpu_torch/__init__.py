"""PyTorch/CUDA port of `triton_distributed_tpu` for NVIDIA Hopper.

Imports torch only.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``, where every kernel's plain PyTorch
version runs instead.
"""

from triton_distributed_tpu_torch.models import (  # noqa: F401
    Engine, KVCache, ModelConfig, Qwen3)
from triton_distributed_tpu_torch.utils.platform import (  # noqa: F401
    is_hopper, resolve_device)
