"""The readers of the program's own spans and counters
(``program_log.py``) on synthetic logs: the last traced window is read,
nothing is read where the program keeps no log, and every reader, old
and new, reads the record the harness builds."""

import collections
import copy

import pytest
import torch

from benchmark import harness, tracing
from dsp_tpu_torch.utils import profiling

NEW = ("pad_host_ms_per_req", "h2d_host_ms_per_req", "h2d_gb_per_s",
       "frontend_host_ms_per_req", "host_syncs_per_req")
BYTES = 16_385_024          # a host256 request: 256 x 16,000 x 4 + 256 x 4


def _window(t, requests=2):
    """One traced window from ``t`` s: each request 10 s long, with pad
    4 ms, h2d 2 ms, front end 3 ms, and its bytes and four waits."""
    spans, counts = [], []
    for r in range(requests):
        a = t + 10.0 * r
        spans += [("dsp.pad", a, a + 0.004), ("dsp.h2d", a + 0.004, a + 0.006),
                  ("dsp.mfcc", a + 0.006, a + 0.008), ("dsp.frontend", a + 0.006, a + 0.009),
                  ("dsp.classify_chunk", a, a + 0.02)]
        counts += [("h2d_bytes", a + 0.005, BYTES), ("host_syncs", a + 0.005, 2),
                   ("host_syncs", a + 0.019, 1), ("host_syncs", a + 0.0195, 1)]
    return spans, counts


@pytest.fixture
def logs(monkeypatch):
    """An earlier window of 3 requests (traced once more), then the last
    one of 2, in the program's logs."""
    first, last = _window(100.0, 3), _window(200.0, 2)
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque(first[0] + last[0]))
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque(first[1] + last[1]))


def _rec(copy_us=1440.0 * 2):
    copies = [tracing.Event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0.0, copy_us / 2),
              tracing.Event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 10.0, copy_us / 2),
              tracing.Event("dtw_banded_kernel", "kernel", 20.0, 5.0)]
    return {"events": copies, "requests": 2, "window_s": 10.0 + 0.021, "busy_s": 0.0}


def _read(name, rec):
    return harness.load_metric(harness.ROOT, name).read(rec)


def test_readers_read_the_last_window(logs):
    rec = _rec()
    got = {m: _read(m, rec) for m in NEW}
    assert got["pad_host_ms_per_req"] == pytest.approx(4.0)
    assert got["h2d_host_ms_per_req"] == pytest.approx(2.0)
    assert got["frontend_host_ms_per_req"] == pytest.approx(3.0)
    assert got["host_syncs_per_req"] == 4.0
    # 2 requests' bytes over 2 x 1,440 us of copies: 11.378 GB/s
    assert got["h2d_gb_per_s"] == pytest.approx(2 * BYTES / 2880.0 / 1e3)


def test_readers_read_nothing_where_the_program_logs_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque())
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque())
    assert all(_read(m, _rec()) is None for m in NEW)
    monkeypatch.delattr(profiling, "SPAN_LOG")      # a program without the logs
    monkeypatch.delattr(profiling, "COUNT_LOG")
    assert all(_read(m, _rec()) is None for m in NEW)


def test_readers_read_nothing_where_their_span_or_counter_is_absent(logs, monkeypatch):
    spans = [s for s in profiling.SPAN_LOG if s[0] != "dsp.pad"]
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque(spans))
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque())
    rec = _rec()
    assert _read("pad_host_ms_per_req", rec) is None
    assert _read("h2d_host_ms_per_req", rec) == pytest.approx(2.0)
    assert _read("host_syncs_per_req", rec) is None
    assert _read("h2d_gb_per_s", rec) is None


def test_bandwidth_needs_the_copies_in_the_trace(logs):
    rec = dict(_rec(), events=[e for e in _rec()["events"] if e.cat == "kernel"])
    assert _read("h2d_gb_per_s", rec) is None


def test_every_reader_reads_the_record_the_harness_builds(monkeypatch):
    """The harness's traced record of a CPU cell at a tiny cut (its own
    keys and the entry's), with the program's logs of one window: each
    reader of the cell returns a number or None, and the new readers
    theirs."""
    cell = harness.resolve("sc2-35w.host256")
    cell = dict(cell, config=copy.deepcopy(cell["config"]), mix=copy.deepcopy(cell["mix"]))
    cell["config"].update(words=["yes", "no", "up"], templates_per_word=2)
    cell["mix"].update(request=4, pool=8, warmup_requests=1, check_requests=2)
    entry = cell["entry"].set_up(cell["config"], cell["mix"], 2**31 + 3, torch.device("cpu"))
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque())
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for r in range(2):
            entry.call(entry.request(r)[1])
    rec = {**_rec(), "window_s": max(s[2] for s in profiling.SPAN_LOG)
           - min(s[1] for s in profiling.SPAN_LOG), "device": torch.device("cpu"),
           **entry.record(2)}
    got = {m["name"]: m["reader"].read(rec) for m in cell["per_layer"]}
    assert set(NEW) <= set(got)
    assert all(v is None or isinstance(v, float) for v in got.values()), got
    assert got["pad_host_ms_per_req"] > 0 and got["frontend_host_ms_per_req"] > 0
    assert got["host_syncs_per_req"] is None       # on the CPU nothing waits on a card
