"""Utilities of the port: device timing on the card (``timing``), logging,
one-time warnings and run metrics (``logging``), profiler traces, named
stages and stage timing (``profiling``)."""

from dsp_tpu_torch.utils.logging import RunMetrics, get_logger
from dsp_tpu_torch.utils.profiling import StageTimer, stage, trace
from dsp_tpu_torch.utils.timing import chained_timeit

__all__ = ["get_logger", "RunMetrics", "trace", "stage", "StageTimer",
           "chained_timeit"]
