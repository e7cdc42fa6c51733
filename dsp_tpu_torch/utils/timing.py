"""Device timing on the card: CUDA events on the current stream.

The counterpart of ``dsp_tpu/utils/timing.py``.  The JAX package threads a
token from each iteration's output into the next input because its relay's
completion barrier can return early; here the stream itself orders the
launches and an event recorded after the last one completes only when they
have, so no token is needed and ``step_fn`` takes its arguments as they
are.  Every function raises without a card.
"""

from __future__ import annotations

import statistics

import torch


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _pass_seconds(step_fn, example_args, n_iters: int) -> float:
    start, end = _events()
    start.record()
    for _ in range(n_iters):
        step_fn(*example_args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n_iters


def chained_timeit(step_fn, example_args, n_iters: int = 8,
                   warmup: int = 1) -> float:
    """Seconds per iteration of ``step_fn(*example_args)`` over ``n_iters``
    back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        step_fn(*example_args)
    return _pass_seconds(step_fn, example_args, n_iters)


def chained_timeit_spread(step_fn, example_args, n_iters: int = 8,
                          warmup: int = 1, passes: int = 3):
    """:func:`chained_timeit` repeated ``passes`` times after one warm-up:
    ``(median, lo, hi)`` seconds per iteration."""
    for _ in range(warmup):
        step_fn(*example_args)
    dts = sorted(_pass_seconds(step_fn, example_args, n_iters)
                 for _ in range(max(1, passes)))
    return statistics.median(dts), dts[0], dts[-1]


def time_ms(fn, reps: int = 5, warmup: bool = True) -> float:
    """Median CUDA-event ms of ``fn()`` over ``reps`` runs, each timed
    alone, after a warm-up (``warmup=False`` when the caller has just run
    ``fn``)."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        start, end = _events()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
