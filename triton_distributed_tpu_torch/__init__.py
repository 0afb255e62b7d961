"""PyTorch/CUDA port of `triton_distributed_tpu` for NVIDIA Hopper.

Imports torch only.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"`` (or a mesh made with it, `make_mesh`), where
every kernel's plain PyTorch version runs instead.
"""

from triton_distributed_tpu_torch.models import (  # noqa: F401
    Engine, KVCache, ModelConfig, PagedKVCache, Qwen3)
from triton_distributed_tpu_torch.parallel import make_mesh  # noqa: F401
from triton_distributed_tpu_torch.serving import (  # noqa: F401
    ContinuousBatchingScheduler, Request, SchedulerConfig)
from triton_distributed_tpu_torch.utils.platform import (  # noqa: F401
    is_hopper, resolve_device)
