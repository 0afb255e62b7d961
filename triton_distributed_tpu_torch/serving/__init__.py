"""Continuous-batching serving runtime (port of
`triton_distributed_tpu/serving/`, one engine on one GPU).

Iteration-level scheduling over a slot-partitioned KV cache
(``kv_layout="slots"``) or a paged, page-table-indexed KV pool with radix
prefix reuse (``kv_layout="paged"``): new requests join the running
decode batch through bucketed prefill and a slot/page insert instead of
waiting for the batch to drain.
"""

from triton_distributed_tpu_torch.serving.engine_batched import (  # noqa: F401
    DEFAULT_PREFILL_BUCKETS,
    make_insert_fn,
    make_masked_block_fn,
    make_masked_step_fn,
    make_paged_insert_fn,
    make_rollout_fn,
    make_step_fn,
    masked_sample,
    pad_prompt,
    pick_bucket,
    request_key,
)
from triton_distributed_tpu_torch.serving.pages import (  # noqa: F401
    PagedKV,
    PagePool,
    RadixCache,
    SpillPool,
)
from triton_distributed_tpu_torch.serving.request import (  # noqa: F401
    FinishReason,
    RejectReason,
    Request,
    RequestState,
)
from triton_distributed_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    SchedulerConfig,
)
from triton_distributed_tpu_torch.serving.slots import SlotKV  # noqa: F401
from triton_distributed_tpu_torch.serving.toy import (  # noqa: F401
    ToyConfig,
    ToyModel,
)
