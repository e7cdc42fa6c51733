"""The GMM-HMM cell (``aurora2-hmm.dev1024``): its files found by name, its
comparison on a run at a tiny cut on the CPU (sound, and with the timed
path broken underneath), the control failing it, and the new per-layer
metrics on hand-built records.  The card's tests are marked ``cuda``."""

import collections
import contextlib
import copy
import json

import numpy as np
import pytest
import torch

from benchmark import check, harness, hmm, hmm_roofline, knn, roofline
from dsp_tpu_torch.utils import profiling

CELL = "aurora2-hmm.dev1024"
NEW = ("viterbi_host_ms_per_req", "emission_host_ms_per_req", "viterbi_steps_per_req",
       "hmm_request_mfu")
SEED = 2**31 + 77


def _cell(words=3, per_word=4, request=4):
    cell = harness.resolve(CELL)
    cell = dict(cell, config=copy.deepcopy(cell["config"]), mix=copy.deepcopy(cell["mix"]))
    cell["config"].update(words=cell["config"]["words"][:words], train_per_word=per_word)
    cell["mix"].update(request=request, pool=2 * request, warmup_requests=1, check_requests=2)
    return cell


def _run(cell, seconds=0.3):
    return harness.run(cell, SEED, seconds, False, torch.device("cpu"), 0.0)


@pytest.fixture(scope="module")
def cut():
    """The tiny cut's cell and its entry, set up once on the CPU."""
    cell = _cell()
    return cell, cell["entry"].set_up(cell["config"], cell["mix"], SEED, torch.device("cpu"))


def test_cell_resolves_with_its_files():
    cell = harness.resolve(CELL)
    conf, mix = cell["config"], cell["mix"]
    assert cell["cell"]["chips"] == 1 and len(cell["cell"]["why"]) <= 200
    assert mix["name"] == cell["cell"]["traffic"] == "hmm-dev1024"
    assert (mix["entry"], mix["request"], mix["pool"], mix["warmup_requests"],
            mix["check_requests"], mix["trace_requests"]) == (
        "hmm_recognize_batch", 1024, 2048, 3, 1, 25)
    assert {m["name"] for m in cell["end_to_end"]} == {
        "utterances_per_s", "request_p95_ms", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {
        "device_ops_per_req", "device_idle_pct", *NEW}
    assert set(conf["limits"]) == {"score_gap", "label_errors"}
    assert conf["limits"]["label_errors"] == 0
    assert (conf["sample_rate"], conf["max_samples"], conf["frame_len"], conf["hop"],
            conf["n_fft"], conf["n_mels"], conf["n_mfcc"], conf["n_feats"], conf["lifter"],
            conf["n_states"], conf["n_mix"], len(conf["words"])) == (
        8000, 16000, 200, 80, 256, 23, 13, 39, 22, 16, 3, 11)
    assert knn.t_max(conf) == 198
    assert set(conf["reduced"]) == {"train_per_word"}
    assert {"clips", "front_end", "silence", "final_state", "training"} <= set(conf["assumed"])
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in spec["configs"] if c["name"] == "aurora2-hmm"]
    assert entry["source"] == conf["source"] and len(entry["source"]) <= 200


def test_sound_run_is_correct(capsys):
    out = _run(_cell())
    assert out["correct"] and out["attempted"] > 0
    assert out["compared"]["score_gap"]["value"] < 1e-5
    assert out["compared"]["label_errors"]["value"] == 0
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2].startswith("score_gap ") and err[-1].startswith("label_errors ")


def _alter_a_score(ids, scores):
    scores = scores.clone()
    scores[0, 1] *= 1.001
    return ids, scores


def _alter_a_label(ids, scores):
    ids = ids.clone()
    ids[0] = (ids[0] + 1) % scores.shape[1]
    return ids, scores


def _swap_two_rows(ids, scores):
    return ids[[1, 0, *range(2, len(ids))]], scores[[1, 0, *range(2, len(ids))]]


@pytest.mark.parametrize("fault", [_alter_a_score, _alter_a_label, _swap_two_rows],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from dsp_tpu_torch.models import gmm_hmm

    real = gmm_hmm.recognize_batch

    def broken(*a, **k):
        return fault(*real(*a, **k))
    monkeypatch.setattr(gmm_hmm, "recognize_batch", broken)
    assert _run(_cell())["correct"] is False


def test_compare_reads_a_planted_score_error_and_a_planted_label(cut):
    """``hmm.compare`` itself: the reference's own answers read 0 and 0,
    a score off by 1e-3 reads its gap, a label off the reference's near
    words reads 1, and a label within the limit of the best reads 0."""
    from benchmark.reference import gmm_hmm as ref

    cell, entry = cut
    fe = knn.frontend(cell["config"], "cpu")
    q = check.side(fe, entry.pool[:4], knn.t_max(cell["config"]))
    r = ref.word_scores(q.feats, q.lens, entry.params).numpy()
    ids = r.argmax(-1)
    assert hmm.compare(ids, r, q, entry.params, 1e-4) == {
        "score_gap": 0.0, "label_errors": 0, "marginal_clips": 0}
    off = r.copy()
    off[2, 0] *= 1.001
    assert hmm.compare(ids, off, q, entry.params, 1e-4)["score_gap"] == pytest.approx(1e-3)
    wrong = ids.copy()
    wrong[1] = np.argsort(r[1])[0]
    assert hmm.compare(wrong, r, q, entry.params, 1e-4)["label_errors"] == 1
    gap = (r[1].max() - r[1][wrong[1]]) / abs(r[1].max())
    assert hmm.compare(wrong, r, q, entry.params, 2 * gap)["label_errors"] == 0
    assert hmm.compare(np.full(4, 7), r, q, entry.params, 1e-4)["label_errors"] == 4


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _tf32_on_the_cpu():
    """The CPU's float32 products with TF32's rounded inputs, in place of
    ``check.tf32`` (which sets the card's flags only)."""
    real = torch.Tensor.__matmul__

    def matmul(a, b):
        if a.dtype == torch.float32:
            return real(_round_tf32(a), _round_tf32(b))
        return real(a, b)
    torch.Tensor.__matmul__ = matmul
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = real


def test_control_fails_on_a_small_case(cut, monkeypatch):
    cell, entry = cut
    config = cell["config"]
    t_max = knn.t_max(config)
    limit = config["limits"]["score_gap"]
    idx, x = entry.request(0)
    q = check.side(knn.frontend(config, "cpu"), entry.pool[idx], t_max)
    ids, scores = entry.call(x)
    assert hmm.compare(ids, scores, q, entry.params, limit)["score_gap"] <= limit
    monkeypatch.setattr(check, "tf32", _tf32_on_the_cpu)
    fe32 = knn.frontend(config, "cpu", torch.float32)
    c_ids, c_s = hmm.control(fe32, entry.pool[idx], entry.params, t_max)
    assert c_s.dtype == np.float32 and c_s.shape == scores.shape
    assert hmm.compare(c_ids, c_s, q, entry.params, limit)["score_gap"] > limit


def _window(t, requests=2):
    """One traced window of ``requests`` requests 10 s apart: emissions 3
    ms, Viterbi 8 ms and 197 steps each."""
    spans, counts = [], []
    for r in range(requests):
        a = t + 10.0 * r
        spans += [("dsp.frontend", a, a + 0.004), ("dsp.emissions", a + 0.004, a + 0.007),
                  ("dsp.viterbi", a + 0.007, a + 0.015), ("dsp.argmax", a + 0.015, a + 0.016)]
        counts += [("viterbi_steps", a + 0.007, 197)]
    return spans, counts


def _rec(lens):
    conf = harness.resolve(CELL)["config"]
    return {"events": [], "requests": 2, "window_s": 10.016, "busy_s": 1.0, "batch": 4,
            "n_samples": 16000, "t_max": 198, "n_feats": 39, **knn.widths(conf),
            "n_words": 11, "n_states": 16, "n_mix": 3, "request_lens": lens}


def _read(name, rec):
    return harness.load_metric(harness.ROOT, name).read(rec)


def test_new_metrics_read_a_hand_built_record(monkeypatch):
    first, last = _window(100.0, 3), _window(200.0, 2)
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque(first[0] + last[0]))
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque(first[1] + last[1]))
    lens = [np.array([10, 20, 30, 40]), np.array([198, 1, 50, 60])]
    rec = _rec(lens)
    assert _read("viterbi_host_ms_per_req", rec) == pytest.approx(8.0)
    assert _read("emission_host_ms_per_req", rec) == pytest.approx(3.0)
    assert _read("viterbi_steps_per_req", rec) == pytest.approx(197.0)
    fe = roofline.frontend_flops(4, 16000, 198, 200, 80, 256, 23, 13)
    emis = 4 * 198 * 11 * 16 * 3 * (3 * 39 + 3)
    decode = 3 * 11 * 16 * (100 + 309)
    want = 100.0 * (2 * (fe + emis) + decode) / 10.016 / roofline.PEAK_FP32_FLOPS
    assert _read("hmm_request_mfu", rec) == pytest.approx(want, rel=1e-12)
    assert hmm_roofline.emission_flops(4, 198, 11, 16, 3, 39) == emis


def test_new_metrics_read_nothing_where_the_program_logged_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque())
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque())
    rec = _rec([np.array([10])])
    for name in NEW[:3]:
        assert _read(name, rec) is None
    assert _read("hmm_request_mfu", {k: v for k, v in rec.items() if k != "n_states"}) is None


def test_every_reader_reads_the_record_the_cell_builds(cut, monkeypatch):
    cell, entry = cut
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque())
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for r in range(2):
            entry.call(entry.request(r)[1])
    rec = {"events": [], "requests": 2, "busy_s": 0.0, "device": torch.device("cpu"),
           "window_s": max(s[2] for s in profiling.SPAN_LOG)
           - min(s[1] for s in profiling.SPAN_LOG), **entry.record(2)}
    got = {m["name"]: m["reader"].read(rec) for m in cell["per_layer"]}
    assert got["viterbi_steps_per_req"] == 197.0
    assert got["viterbi_host_ms_per_req"] > 0 and got["emission_host_ms_per_req"] > 0
    assert 0 < got["hmm_request_mfu"]
    assert got["device_ops_per_req"] is None and got["device_idle_pct"] is None


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card(dev):
    from benchmark import hmm_control

    cell = _cell(words=11, per_word=8, request=64)
    limit = cell["config"]["limits"]["score_gap"]
    for seed in (2**31 + 1, 2**31 + 2):
        got = hmm_control.readings(cell, seed, 0.5, dev)
        assert got["program"]["score_gap"] <= limit and got["program"]["label_errors"] == 0
        assert got["control"]["score_gap"] > limit, got


@pytest.mark.cuda
def test_traced_run_reads_every_per_layer_metric_on_the_card(dev):
    cell = _cell(words=11, per_word=8, request=64)
    cell["mix"]["trace_requests"] = 10
    out = harness.run(cell, 2**31 + 11, 5.0, True, dev, 0.0)
    assert out["correct"]
    assert set(out["metrics"]) == {m["name"] for m in cell["per_layer"]}
    assert 0 < out["metrics"]["hmm_request_mfu"]["value"] < 100
    assert out["metrics"]["viterbi_steps_per_req"]["value"] == 197.0
