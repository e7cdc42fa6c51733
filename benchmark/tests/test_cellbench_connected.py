"""The connected-digit cell (``aurora2-connected.strings1001``): its files
found by name, the strings' generator, its comparison on a run at a tiny
cut on the CPU (sound, and with the timed path broken underneath), the
control failing it, and the new per-layer metrics on hand-built records.
The card's tests are marked ``cuda``."""

import collections
import copy
import json

import numpy as np
import pytest
import torch

from benchmark import connected, connected_roofline, harness, knn, roofline
from benchmark.data import strings
from benchmark.reference import connected as ref
from dsp_tpu_torch.utils import profiling

CELL = "aurora2-connected.strings1001"
NEW = ("connected_steps_per_req", "connected_host_ms_per_req", "connected_request_mfu")
SEED = 2**31 + 91


def _cell(words=3, per_word=4, request=4, max_samples=24000, levels=9):
    cell = harness.resolve(CELL)
    cell = dict(cell, config=copy.deepcopy(cell["config"]), mix=copy.deepcopy(cell["mix"]))
    cell["config"].update(words=cell["config"]["words"][:words], train_per_word=per_word,
                          sil_train=4, max_samples=max_samples, max_levels=levels)
    cell["mix"].update(request=request, pool=2 * request, warmup_requests=1, check_requests=2)
    return cell


def _run(cell, seconds=0.3):
    return harness.run(cell, SEED, seconds, False, torch.device("cpu"), 0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the DPs are thousands of small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cut():
    """The tiny cut's cell and its entry, set up once on the CPU."""
    cell = _cell()
    return cell, cell["entry"].set_up(cell["config"], cell["mix"], SEED, torch.device("cpu"))


def test_cell_resolves_with_its_files():
    cell = harness.resolve(CELL)
    conf, mix = cell["config"], cell["mix"]
    assert cell["cell"]["chips"] == 1 and len(cell["cell"]["why"]) <= 200
    assert mix["name"] == cell["cell"]["traffic"] == "strings1001"
    assert (mix["entry"], mix["request"], mix["pool"], mix["warmup_requests"],
            mix["check_requests"], mix["trace_requests"]) == (
        "hmm_connected_batch", 1001, 2002, 3, 1, 3)
    assert {m["name"] for m in cell["end_to_end"]} == {
        "utterances_per_s", "request_p95_ms", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {
        "device_ops_per_req", "device_idle_pct", "frontend_host_ms_per_req",
        "emission_host_ms_per_req", *NEW}
    assert set(conf["limits"]) == {"score_gap", "label_errors"}
    assert conf["limits"]["label_errors"] == 0
    assert (conf["sample_rate"], conf["max_samples"], conf["frame_len"], conf["hop"],
            conf["n_fft"], conf["n_mels"], conf["n_mfcc"], conf["n_feats"], conf["lifter"],
            conf["n_states"], conf["n_mix"], len(conf["words"]), conf["sil_states"],
            conf["sil_mix"], conf["max_levels"], conf["use_vad"]) == (
        8000, 48000, 200, 80, 256, 23, 13, 39, 22, 16, 3, 11, 3, 6, 9, False)
    assert knn.t_max(conf) == 598
    assert set(conf["reduced"]) == {"train_per_word", "sil_train"}
    assert {"strings", "front_end", "training", "sil_skips", "no_sp", "max_digits",
            "word_penalty"} <= set(conf["assumed"])
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in spec["configs"] if c["name"] == "aurora2-connected"]
    assert entry["source"] == conf["source"] and len(entry["source"]) <= 200
    assert sorted(entry["reduced"]) == sorted(conf["reduced"])


def test_strings_follow_the_tidigits_mix_and_are_seeded():
    words = harness.resolve(CELL)["config"]["words"]
    clips, lens, labels, redrawn = strings.pool(words, 140, SEED, 8000, 48000)
    again = strings.pool(words, 140, SEED, 8000, 48000)
    assert np.array_equal(clips, again[0]) and labels == again[2]
    assert redrawn == again[3] >= 0 and clips.shape == (140, 48000)
    counts = collections.Counter(len(s) for s in labels)
    assert set(counts) <= set(strings.LENGTHS) and counts[1] > counts[7] > 0
    assert all((clips[i, lens[i]:] == 0).all() for i in range(140))
    assert all(lens >= 0.2 * 8000) and all(lens <= 48000)
    quiet = strings.silence(3, SEED, 8000, 0.5)
    assert quiet.shape == (3, 4000) and abs(float(quiet.std()) - strings.NOISE) < 1e-3


def test_sound_run_is_correct(capsys):
    out = _run(_cell())
    assert out["correct"] and out["attempted"] > 0
    assert out["compared"]["score_gap"]["value"] < 2e-5
    assert out["compared"]["label_errors"]["value"] == 0
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2].startswith("score_gap ") and err[-1].startswith("label_errors ")


def _alter_a_score(ids, counts, final):
    final = final.clone()
    final[0, counts[0] - 1] *= 1.001
    return ids, counts, final


def _drop_a_unit(ids, counts, final):
    ids, counts = ids.clone(), counts.clone()
    ids[0, counts[0] - 2] = ids[0, counts[0] - 1]
    ids[0, counts[0] - 1] = -1
    counts[0] -= 1
    return ids, counts, final


def _swap_two_rows(ids, counts, final):
    order = [1, 0, *range(2, len(counts))]
    return ids[order], counts[order], final[order]


@pytest.mark.parametrize("fault", [_alter_a_score, _drop_a_unit, _swap_two_rows],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from dsp_tpu_torch.models import gmm_hmm

    real = gmm_hmm.recognize_level_batch

    def broken(*a, **k):
        return fault(*real(*a, **k))
    monkeypatch.setattr(gmm_hmm, "recognize_level_batch", broken)
    assert _run(_cell())["correct"] is False


def _no_skips(groups):
    sil = dict(groups[1], log_a=groups[1]["log_a"].copy())
    sil["log_a"][:, [0, 2], [2, 0]] = -1e30
    return [groups[0], sil]


def _a_digit_skips(groups):
    digits = dict(groups[0], log_a=groups[0]["log_a"].copy())
    digits["log_a"][1, 3, 5] = -1.0
    return [digits, groups[1]]


def _skips_of_another_mass(groups):
    sil = dict(groups[1], log_a=groups[1]["log_a"].copy())
    sil["log_a"][:, 0, 2] = np.log(0.2)
    return [groups[0], sil]


def _sil_of_four_gaussians(groups):
    sil = {k: (v[:, :, :4] if k in ("means", "log_var", "log_mix") else v)
           for k, v in groups[1].items()}
    return [groups[0], sil]


@pytest.mark.parametrize("fault", [None, _no_skips, _a_digit_skips, _skips_of_another_mass,
                                   _sil_of_four_gaussians],
                         ids=lambda f: f.__name__ if f else "as_fitted")
def test_set_up_holds_the_fitted_models_to_the_configuration(cut, fault):
    cell, entry = cut
    groups = fault(entry.groups) if fault else entry.groups
    faults = connected.topology_faults(groups, cell["config"])
    assert (len(faults) == 1) if fault else faults == [], faults


def test_models_other_than_the_configuration_are_not_correct(monkeypatch):
    from dsp_tpu_torch.models import gmm_hmm

    monkeypatch.setattr(gmm_hmm, "add_skips", lambda params, prob=0.1: params)
    assert _run(_cell())["correct"] is False


def test_compare_reads_planted_errors(cut):
    """``connected.compare`` itself: the reference's own decode reads 0
    and 0; a final score off by 1e-3 reads its gap; a sequence the grammar
    refuses, a sequence of a lower score and a lost decode read one error
    each."""
    cell, entry = cut
    conf = cell["config"]
    idx = np.arange(4)
    fe = knn.frontend(conf, "cpu")
    feats, lens = ref.features(fe, entry.pool[idx], entry.pool_lens[idx], knn.t_max(conf))
    args = (feats, lens, entry.groups, entry.masks, entry.max_levels, entry.word_penalty)
    final, seqs = ref.level_decode(feats, lens, entry.groups, *entry.masks, entry.max_levels)
    ids = np.full((4, entry.max_levels), -1)
    for b, s in enumerate(seqs):
        ids[b, :len(s)] = s
    counts = np.asarray([len(s) for s in seqs])
    assert connected.compare(ids, counts, final.numpy(), *args, 1e-6) == {
        "score_gap": 0.0, "label_errors": 0}
    off = final.numpy().copy()
    off[1, counts[1] - 1] *= 1.001
    assert connected.compare(ids, counts, off, *args, 1e-6)["score_gap"] == pytest.approx(1e-3)
    bad = ids.copy()
    bad[0, 0] = 0                                  # a digit first: the grammar wants sil
    worse = ids.copy()
    worse[2, 1] = (worse[2, 1] + 1) % 3            # another digit in place of the first
    lost = counts.copy()
    lost[3] = 0
    got = connected.compare(bad, counts, final.numpy(), *args, 1e-6)
    assert got["label_errors"] == 1
    assert connected.compare(worse, counts, final.numpy(), *args, 1e-6)["label_errors"] == 1
    assert connected.compare(ids, lost, final.numpy(), *args, 1e-6)["label_errors"] == 1


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_control_fails_on_a_small_case(cut, monkeypatch):
    from benchmark import check

    cell, entry = cut
    conf = cell["config"]
    t_max = knn.t_max(conf)
    limit = conf["limits"]["score_gap"]
    idx, req = entry.request(0)
    answer = entry.call(req)
    fe = knn.frontend(conf, "cpu")
    feats, lens = ref.features(fe, entry.pool[idx], entry.pool_lens[idx], t_max)
    args = (feats, lens, entry.groups, entry.masks, entry.max_levels, entry.word_penalty, limit)
    sound = connected.compare(*answer, *args)
    assert sound["score_gap"] <= limit and sound["label_errors"] == 0
    real = torch.Tensor.__matmul__

    def matmul(a, b):      # the CPU's float32 products with TF32's rounded inputs
        if a.dtype == torch.float32:
            return real(_round_tf32(a), _round_tf32(b))
        return real(a, b)
    monkeypatch.setattr(torch.Tensor, "__matmul__", matmul)
    monkeypatch.setattr(check, "tf32", lambda: __import__("contextlib").nullcontext())
    fe32 = knn.frontend(conf, "cpu", torch.float32)
    c = connected.control(fe32, entry.pool[idx], entry.pool_lens[idx], t_max, entry.groups,
                          entry.masks, entry.max_levels, entry.word_penalty)
    assert c[2].dtype == np.float32 and c[0].shape == answer[0].shape
    monkeypatch.setattr(torch.Tensor, "__matmul__", real)
    assert connected.compare(*c, *args)["score_gap"] > limit


def _window(t, requests=2):
    """One traced window of ``requests`` requests 10 s apart: the DP 90 ms
    and 5,382 steps each."""
    spans, counts = [], []
    for r in range(requests):
        a = t + 10.0 * r
        spans += [("dsp.frontend", a, a + 0.004), ("dsp.emissions", a + 0.004, a + 0.007),
                  ("dsp.connected", a + 0.007, a + 0.097), ("dsp.backtrace", a + 0.097, a + 0.1)]
        counts += [("connected_steps", a + 0.007, 5382)]
    return spans, counts


def _rec(lens):
    conf = harness.resolve(CELL)["config"]
    return {"events": [], "requests": 2, "window_s": 10.1, "busy_s": 1.0, "batch": 4,
            "n_samples": 48000, "t_max": 598, "n_feats": 39, **knn.widths(conf),
            "groups": [(11, 16, 3), (1, 3, 6)], "transitions": 11 * 31 + 7, "max_levels": 9,
            "request_lens": lens}


def _read(name, rec):
    return harness.load_metric(harness.ROOT, name).read(rec)


def test_new_metrics_read_a_hand_built_record(monkeypatch):
    first, last = _window(100.0, 3), _window(200.0, 2)
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque(first[0] + last[0]))
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque(first[1] + last[1]))
    lens = [np.array([100, 200, 300, 400]), np.array([598, 1, 50, 60])]
    rec = _rec(lens)
    assert _read("connected_host_ms_per_req", rec) == pytest.approx(90.0)
    assert _read("connected_steps_per_req", rec) == pytest.approx(5382.0)
    fe = roofline.frontend_flops(4, 48000, 598, 200, 80, 256, 23, 13)
    emis = 4 * 598 * (11 * 16 * 3 + 1 * 3 * 6) * (3 * 39 + 3)
    dp = 9 * (1000 + 709) * (2 * (11 * 31 + 7) + 3 * (11 * 16 + 3))
    want = 100.0 * (2 * (fe + emis) + dp) / 10.1 / roofline.PEAK_FP32_FLOPS
    assert _read("connected_request_mfu", rec) == pytest.approx(want, rel=1e-12)
    assert connected_roofline.emission_flops(4, 598, [(11, 16, 3), (1, 3, 6)], 39) == emis


def test_new_metrics_read_nothing_where_the_program_logged_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque())
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque())
    rec = _rec([np.array([10])])
    for name in NEW[:2]:
        assert _read(name, rec) is None
    assert _read("connected_request_mfu",
                 {k: v for k, v in rec.items() if k != "transitions"}) is None


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
    assert got["connected_steps_per_req"] == 9 * 298
    assert got["connected_host_ms_per_req"] > 0 and 0 < got["connected_request_mfu"]
    assert got["frontend_host_ms_per_req"] > 0 and got["emission_host_ms_per_req"] > 0
    assert rec["transitions"] == 3 * 31 + 7
    assert got["device_ops_per_req"] is None and got["device_idle_pct"] is None


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card(dev):
    from benchmark import connected_control

    cell = _cell(words=11, per_word=8, request=64, max_samples=48000)
    limit = cell["config"]["limits"]["score_gap"]
    for seed in (2**31 + 1, 2**31 + 2):
        got = connected_control.readings(cell, seed, 0.5, dev)
        assert got["program"]["score_gap"] <= limit and got["program"]["label_errors"] == 0
        assert got["control"]["score_gap"] > limit, got


@pytest.mark.cuda
def test_traced_run_reads_every_per_layer_metric_on_the_card(dev):
    cell = _cell(words=11, per_word=8, request=64, max_samples=48000)
    cell["mix"]["trace_requests"] = 3
    out = harness.run(cell, 2**31 + 11, 5.0, True, dev, 0.0)
    assert out["correct"]
    assert set(out["metrics"]) == {m["name"] for m in cell["per_layer"]}
    assert 0 < out["metrics"]["connected_request_mfu"]["value"] < 100
    assert out["metrics"]["connected_steps_per_req"]["value"] == 9 * 598
