"""Data parallelism on ``torch.distributed`` (counterpart of
``d3feat_tpu.parallel``): one process per device, each on its own pair."""

from d3feat_tpu_torch.parallel.data_parallel import (  # noqa: F401
    make_dp_eval_step,
    make_dp_extract_step,
    make_dp_train_step,
)
from d3feat_tpu_torch.parallel.mesh import (  # noqa: F401
    init_group,
    rank_device,
    shard_batch,
    stack_batches,
)
