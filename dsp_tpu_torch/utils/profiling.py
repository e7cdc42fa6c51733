"""Profiling helpers: device traces, named stages, stage timing.

The port of ``dsp_tpu/utils/profiling.py``:

* ``trace(logdir)`` runs ``torch.profiler.profile`` with the CPU and, where
  this torch build has it, the CUDA activity, and writes a Chrome trace
  (``trace_<pid>_<ns>.json``) into ``logdir`` at the end; open it in
  Perfetto or ``chrome://tracing`` to see each kernel on the device's
  timeline.  The context yields the profiler, so a caller can also read
  its ``key_averages()``;
* ``stage(name)`` is ``torch.profiler.record_function``: the pipeline's
  stages (vad, mfcc, dtw, argmin) get their own ranges in those traces;
* ``StageTimer`` sums host wall-clock seconds a named stage.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the block into ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def stage(name: str):
    """Named range for profile attribution: ``with stage('dtw'): ...``."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulates host wall-clock seconds per named stage.

    A stage's time is that of finished work: where CUDA is initialized in
    this process, the end of each stage synchronizes the current card
    (``torch.cuda.synchronize``) before the clock is read, so kernels a
    stage launched count in it, not in the next stage that waits for them.
    """

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> dict[str, float]:
        return {k: round(v, 4) for k, v in sorted(self.totals.items())}
