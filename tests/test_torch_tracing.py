"""Spans and counters of the recognizer's path (``utils/profiling.py``),
on the CPU.

Under ``torch.profiler`` ``classify_batch`` emits one span tree a chunk:
``dsp.classify_chunk`` around ``dsp.pad``, ``dsp.h2d``, ``dsp.frontend``
(around ``dsp.mfcc``, ``dsp.vad``, ``dsp.deltas``), ``dsp.dtw``,
``dsp.argmin`` and ``dsp.readback``; with no profiler ``stage`` touches
nothing of ``record_function``.  ``h2d_bytes`` and ``host_syncs`` count
what crosses to another device and nothing on an all-CPU run.
"""

import json

import numpy as np
import pytest
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import PipelineConfig
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
from dsp_tpu_torch.utils import profiling

CHILDREN = {"dsp.classify_chunk": ["dsp.pad", "dsp.h2d", "dsp.frontend", "dsp.dtw",
                                   "dsp.argmin", "dsp.readback"],
            "dsp.frontend": ["dsp.mfcc", "dsp.vad", "dsp.deltas"]}
MAX_SAMPLES = 8000


@pytest.fixture(scope="module")
def rec():
    rng = np.random.default_rng(0)
    r = KnnDtwRecognizer(PipelineConfig(max_samples=MAX_SAMPLES), device="cpu")
    for w in ("a", "b"):
        r.enroll(w, [0.3 * rng.standard_normal(6000).astype(np.float32) for _ in range(2)])
    return r


def _signals(n):
    rng = np.random.default_rng(1)
    return [0.3 * rng.standard_normal(4000 + 500 * i).astype(np.float32) for i in range(n)]


def _spans(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                   for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("dsp.")), key=lambda s: (s[0], -s[1]))


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_classify_batch_emits_one_span_tree_a_chunk(rec, tmp_path):
    sigs = _signals(5)
    want = rec.classify_batch(sigs, chunk=2)
    n_log = len(profiling.SPAN_LOG)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = rec.classify_batch(sigs, chunk=2)
    assert got == want
    spans = _spans(prof, tmp_path)
    roots = [s for s in spans if s[2] == "dsp.classify_chunk"]
    assert len(roots) == 3                      # 5 clips in chunks of 2
    for s in spans:                             # every span inside exactly one tree
        assert sum(_inside(s, r) for r in roots) == 1, s
    for root in roots:
        tree = [s for s in spans if _inside(s, root) and s is not root]
        assert [s[2] for s in tree if sum(_inside(s, t) for t in tree) == 1] \
            == CHILDREN["dsp.classify_chunk"]   # direct children, in order
        (fe,) = [s for s in tree if s[2] == "dsp.frontend"]
        assert [s[2] for s in tree if _inside(s, fe) and s is not fe] \
            == CHILDREN["dsp.frontend"]
    # the same spans in the program's own log, each with its host interval
    logged = list(profiling.SPAN_LOG)[n_log:]
    assert sorted(n for n, _, _ in logged) == sorted(s[2] for s in spans)
    assert all(t0 <= t1 for _, t0, t1 in logged)


def test_stage_touches_no_record_function_without_a_profiler(rec, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.recording()
    assert profiling.stage("dsp.a") is profiling.stage("dsp.b")
    n_log, n_count = len(profiling.SPAN_LOG), len(profiling.COUNT_LOG)
    with profiling.stage("dsp.a"):
        pass
    pl.pad_signals(_signals(2), MAX_SAMPLES, "meta")
    assert rec.classify_batch(_signals(3)) == rec.classify_batch(_signals(3), chunk=2)
    assert (len(profiling.SPAN_LOG), len(profiling.COUNT_LOG)) == (n_log, n_count)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_pad_signals_counts_what_crosses_a_device(device):
    before = profiling.counts()
    x, n = pl.pad_signals(_signals(3), MAX_SAMPLES, device)
    got = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    assert x.device.type == n.device.type == device
    crossed = device != "cpu"
    assert got.get("h2d_bytes", 0) == crossed * (3 * MAX_SAMPLES * 4 + 3 * 4)
    assert got.get("host_syncs", 0) == crossed * 2


def test_an_all_cpu_classify_counts_nothing(rec):
    before = profiling.counts()
    rec.classify_batch(_signals(5), chunk=2, return_distances=True)
    assert profiling.counts() == before


def test_counts_are_logged_only_while_a_profiler_records():
    n_log = len(profiling.COUNT_LOG)
    profiling.count("test_counter", 3)
    assert len(profiling.COUNT_LOG) == n_log
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("test_counter", 2)
    assert [(c, n) for c, _, n in list(profiling.COUNT_LOG)[n_log:]] == [("test_counter", 2)]
    assert profiling.counts()["test_counter"] >= 5
