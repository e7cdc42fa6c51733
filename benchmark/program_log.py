"""The program's own record of the traced window, for the readers of
``program_span`` and ``program_counter`` metrics.

While a profiler records, ``dsp_tpu_torch.utils.profiling`` keeps each
span it closes (``SPAN_LOG``: name, start s, end s) and each count
(``COUNT_LOG``: name, time s, n) on the host's ``time.perf_counter``
clock.  The harness's traced window is the only recording in a run, but
a window whose trace lost device events is traced again, so the logs
may hold two windows.  The last one is what ends at the log's newest
entry and lasts the window's ``window_s``: the program's spans all lie
inside the harness's ``window`` span, and a window that is traced again
starts only after the first one's trace was written out.  A program
without the logs gives nothing, and so does a window with no span.
"""

from __future__ import annotations


def window(rec):
    """(spans, counts) of the traced window ``rec``, or None."""
    try:
        from dsp_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = list(getattr(profiling, "SPAN_LOG", ()))
    counted = list(getattr(profiling, "COUNT_LOG", ()))
    if not spans or rec.get("window_s", 0) <= 0 or rec.get("requests", 0) <= 0:
        return None
    lo = max(max(s[2] for s in spans), max((c[1] for c in counted), default=0.0)) \
        - rec["window_s"]
    return [s for s in spans if s[1] >= lo], [c for c in counted if c[1] >= lo]


def span_ms_per_req(rec, name: str):
    """Summed host ms of the window's spans ``name`` over its requests."""
    got = window(rec)
    if got is None:
        return None
    ds = [t1 - t0 for n, t0, t1 in got[0] if n == name]
    if not ds:
        return None
    return 1e3 * sum(ds) / rec["requests"]


def counted(rec, name: str):
    """Counter ``name`` summed over the window (None where it never
    counted there)."""
    got = window(rec)
    if got is None:
        return None
    ns = [n for c, _, n in got[1] if c == name]
    return sum(ns) if ns else None
