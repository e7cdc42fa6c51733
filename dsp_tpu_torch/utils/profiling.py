"""Profiling helpers: device traces, named stages, counters, stage timing.

The port of ``dsp_tpu/utils/profiling.py``:

* ``trace(logdir)`` runs ``torch.profiler.profile`` with the CPU and, where
  this torch build has it, the CUDA activity, and writes a Chrome trace
  (``trace_<pid>_<ns>.json``) into ``logdir`` at the end; open it in
  Perfetto or ``chrome://tracing`` to see each kernel on the device's
  timeline.  The context yields the profiler, so a caller can also read
  its ``key_averages()``;
* ``stage(name)`` is a ``torch.profiler.record_function`` range while a
  profiler records, so the pipeline's stages (``dsp.pad``, ``dsp.h2d``,
  ``dsp.frontend``, ``dsp.dtw``, ...) lie in those traces on the device
  events' clock; with no profiler recording it is one shared no-op
  context.  Each range that closes while a profiler records is also kept
  in :data:`SPAN_LOG` as ``(name, start s, end s)`` on the host's
  ``time.perf_counter`` clock, read inside the range (the profiler's own
  cost of opening and closing it left out), the newest last;
* ``count(name, n)`` adds to the process-wide counter :data:`COUNTS`
  (always on, one dict update); ``counts()`` is a snapshot.  While a
  profiler records, each call is also kept in :data:`COUNT_LOG` as
  ``(name, time s, n)``.  The recognizer's path counts ``h2d_bytes``
  (bytes ``pipeline.pad_signals`` copies to another device) and
  ``host_syncs`` (each point where the host waits on the card: the two
  copies of ``pad_signals``, the readbacks of ``classify_batch``);
* ``StageTimer`` sums host wall-clock seconds a named stage.

The two logs let code in the traced process (a benchmark's readers) take
the spans and counts of a traced window without parsing the trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity

COUNTS: dict[str, int] = {}
LOG_LEN = 1 << 16          # entries each log keeps; the oldest go first
SPAN_LOG: collections.deque = collections.deque(maxlen=LOG_LEN)
COUNT_LOG: collections.deque = collections.deque(maxlen=LOG_LEN)

_NO_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` / ``torch.autograd.profiler`` session
    is recording in this process (a Python flag: ~0.05 us to read)."""
    return _autograd_profiler._is_profiler_enabled


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


class _Span:
    """A ``record_function`` range that logs its host interval on exit."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = _autograd_profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        SPAN_LOG.append((self.name, self.t0, t1))


def stage(name: str):
    """Named range for profile attribution: ``with stage('dsp.dtw'): ...``;
    a shared no-op unless a profiler is recording."""
    return _Span(name) if recording() else _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    COUNTS[name] = COUNTS.get(name, 0) + n
    if recording():
        COUNT_LOG.append((name, time.perf_counter(), n))


def counts() -> dict[str, int]:
    """A snapshot of every counter."""
    return dict(COUNTS)


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
