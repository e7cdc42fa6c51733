"""The trace readers and the per-layer metrics on a small synthetic
Chrome trace."""

import json

import numpy as np
import pytest

from benchmark import harness, tracing

# window 0-100 us; two requests; device busy 10-30 (kernels overlapping),
# 40-45 (a copy) and 60-90 (the DTW kernel)
TRACE = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "request", "ts": 0, "dur": 50},
    {"ph": "X", "cat": "user_annotation", "name": "request", "ts": 50, "dur": 50},
    {"ph": "X", "cat": "user_annotation", "name": "pad_signals", "ts": 0, "dur": 9},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 30, "dur": 15},
    {"ph": "X", "cat": "kernel", "name": "void mel_kernel()", "ts": 10, "dur": 15},
    {"ph": "X", "cat": "kernel", "name": "void log_kernel()", "ts": 20, "dur": 10},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 40, "dur": 5},
    {"ph": "X", "cat": "kernel", "name": "dtw_banded_kernel(float const*)", "ts": 60, "dur": 30},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 92, "dur": 2},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    {"ph": "X", "cat": "python_function", "name": "ignored", "ts": 0, "dur": 100},
]}


@pytest.fixture
def events(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    return tracing.load(str(path))


def test_parse_keeps_device_and_host_complete_events(events):
    assert len(events) == 10
    assert len(tracing.device(events)) == 5 and sum(e.cat in tracing.HOST_CATS for e in events) == 5


def test_union_gaps_and_busy(events):
    dev = tracing.device(events)
    assert tracing.union(dev) == [(10, 30), (40, 45), (60, 90), (92, 94)]
    assert tracing.busy_us(dev) == 57
    assert tracing.gaps(tracing.union(dev), 0, 100) == [(0, 10), (30, 40), (45, 60), (90, 92),
                                                        (94, 100)]
    assert tracing.busy_us(tracing.clip(dev, 0, 50)) == 25


def test_breakdown(events):
    top = tracing.top_device_ops(events)
    assert top[0] == ["dtw_banded_kernel(float const*)", 30e-6] and len(top) == 5
    idle = dict(tracing.idle_by_host(events, 0, 100))
    # 0-10: pad_signals span (mid 5); 30-40 (mid 35): request span beats the op;
    # 45-60, 90-92, 94-100: request spans
    assert idle == pytest.approx({"request": 33e-6, "pad_signals": 10e-6})


def _record(events):
    dev = tracing.device(events)
    return {"events": dev, "requests": 2, "window_s": 100e-6,
            "busy_s": tracing.busy_us(dev) / 1e6, "batch": 2,
            "n_samples": 16000, "t_max": 98, "n_feats": 39, "band_frac": 0.17,
            "frame_len": 400, "hop": 160, "n_fft": 512, "n_mels": 26, "n_mfcc": 13,
            "lifter": 22, "device": "cpu",
            "max_warp_scale": 2.0, "bank_lens": np.array([50, 60, 98]),
            "request_lens": [np.array([40, 98]), np.array([70, 20])]}


def test_metric_readers(events):
    rec = _record(events)
    got = {m: harness.load_metric(harness.ROOT, m).read(rec) for m in (
        "h2d_ms_per_req", "frontend_device_ms_per_req", "device_ops_per_req",
        "dtw_device_ms_per_req", "device_idle_pct", "dtw_roofline", "request_mfu")}
    assert got["h2d_ms_per_req"] == pytest.approx(0.0025)
    assert got["frontend_device_ms_per_req"] == pytest.approx(0.0125)
    assert got["device_ops_per_req"] == 1.5
    assert got["dtw_device_ms_per_req"] == pytest.approx(0.015)
    assert got["device_idle_pct"] == pytest.approx(43.0)
    from benchmark import roofline
    table = roofline.cell_table(98, 98, 0.17, 2.0)
    cells = sum(roofline.dtw_cells(q, rec["bank_lens"], table) for q in rec["request_lens"])
    least = sum(roofline.least_seconds(
        roofline.dtw_flops(roofline.dtw_cells(q, rec["bank_lens"], table), 39),
        roofline.dtw_bytes(2, 98, 3, 98, 39)) for q in rec["request_lens"])
    assert got["dtw_roofline"] == pytest.approx(100 * least / 30e-6)
    flops = cells * 81 + 2 * roofline.frontend_flops(2, 16000, 98)
    assert got["request_mfu"] == pytest.approx(100 * flops / 100e-6 / 67e12)


def test_readers_return_nothing_where_there_is_nothing_to_read(events):
    rec = _record([e for e in events if e.cat != "gpu_memcpy" and "dtw" not in e.name])
    assert harness.load_metric(harness.ROOT, "h2d_ms_per_req").read(rec) is None
    assert harness.load_metric(harness.ROOT, "dtw_roofline").read(rec) is None
    assert harness.load_metric(harness.ROOT, "dtw_device_ms_per_req").read(rec) is None


def test_trace_problem_finds_lost_events(events):
    span = next(e for e in events if e.name == "window")
    def problem(evts, n, launches, ms):
        return harness.trace_problem(evts, span, n, launches, ms, "dtw_banded")

    assert problem(events, 2, {"dtw_banded": 1}, 0.1) is None
    assert "lost" in problem(events, 2, {"dtw_banded": 2}, 0.1)
    assert "lost" in problem(events, 3, {"dtw_banded": 1}, 0.1)
    assert "CUDA events" in problem(events, 2, {"dtw_banded": 1}, 0.001)
    host_only = [e for e in events if e.cat not in tracing.DEVICE_CATS]
    assert "no device event" in problem(host_only, 2, {}, 0.1)
