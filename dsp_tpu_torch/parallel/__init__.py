"""Parallelism layer: the ('data', 'bank') mesh on ``torch.distributed``
and the sharded classify, spotting, level building and EM (port of
``dsp_tpu/parallel``; one process a GPU, NCCL on the card, gloo on the CPU).
"""

from dsp_tpu_torch.parallel.mesh import (
    BANK_AXIS,
    DATA_AXIS,
    make_mesh,
    pad_axis_to_multiple,
    replicate,
    shard_bank,
    shard_queries,
)
from dsp_tpu_torch.parallel.sharding import (classify_sharded, recognize_sharded,
                                             spot_sharded)

__all__ = [
    "DATA_AXIS", "BANK_AXIS", "make_mesh", "shard_queries", "shard_bank",
    "replicate", "pad_axis_to_multiple", "classify_sharded", "recognize_sharded",
    "spot_sharded",
]

from dsp_tpu_torch.parallel.em import em_step_sharded  # noqa: E402

__all__.append("em_step_sharded")

from dsp_tpu_torch.parallel import multihost  # noqa: E402

__all__.append("multihost")
