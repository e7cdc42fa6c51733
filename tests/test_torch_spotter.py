"""Offline keyword spotting parity: the port's whole-recording features and
``KeywordSpotter`` against the JAX package.

Both packages get the same bank: the JAX recognizer enrolls it and the
port loads its arrays through ``KnnDtwRecognizer.from_arrays``.  Features
allclose at 5e-3 (tests/test_e2e.py:34, as tests/test_torch_pipeline.py),
lengths equal; spotting norms allclose at rtol 1e-3 (they sum hundreds of
local costs of features that agree to ~1e-4), witnesses and events equal,
the calibrated threshold at rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import KnnDtwRecognizer as JaxRecognizer
from dsp_tpu import pipeline as jpl
from dsp_tpu.config import FrontendConfig as JFrontendConfig
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.models.spotter import KeywordSpotter as JaxSpotter
from dsp_tpu.ops import frontend as jfe

from dsp_tpu_torch import KeywordSpotter, KnnDtwRecognizer, PipelineConfig
from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import FrontendConfig
from dsp_tpu_torch.io import synth_connected, synth_spotting_stream, synth_word
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import spot_fused as ksp
from dsp_tpu_torch.models import spotter as tspotter

KEYWORDS = ["zero", "one"]
VOCAB = ["zero", "one", "three", "four", "five"]
STREAMS = [synth_spotting_stream(KEYWORDS, VOCAB, seed=s, n_words=5)
           for s in (2, 7, 13)]
SIGNALS = [sig for sig, _ in STREAMS]


@pytest.fixture(scope="module")
def jax_rec():
    rec = JaxRecognizer(JPipelineConfig())
    for lab in KEYWORDS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    return rec


def _port_rec(jax_rec, **kw):
    return KnnDtwRecognizer.from_arrays(
        np.stack(jax_rec._bank_feats), jax_rec._bank_lens,
        jax_rec._bank_label_ids, jax_rec.labels, PipelineConfig(),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def port_rec(jax_rec):
    return _port_rec(jax_rec)


@pytest.mark.parametrize("use_vad,kw", [(False, {}), (True, {}),
                                        (True, {"cmn": True}),
                                        (False, {"cmn": True, "cmn_mode": "causal"})])
def test_extract_recording_features_matches_jax(use_vad, kw):
    sigs = [synth_connected(["one", "two", "three"], 300), SIGNALS[0]]
    pad_len = 3 * 32000
    x, n = tpl.pad_signals(sigs, pad_len, device="cpu")
    t_max = 1 + (pad_len - 400) // 160
    jcfg = JPipelineConfig(use_vad=use_vad, frontend=JFrontendConfig(**kw))
    want = jpl.extract_recording_features(
        jnp.asarray(x.numpy()), jnp.asarray(n.numpy()),
        jfe.make_matrices(jcfg.frontend), jcfg, t_max)
    got = tpl.extract_recording_features(
        x, n, PipelineConfig(use_vad=use_vad, frontend=FrontendConfig(**kw)),
        t_max)
    assert got.feats.shape == (2, t_max, 39)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=5e-3, atol=5e-3)


def test_extract_recording_features_lpcc_raises():
    x, n = tpl.pad_signals(SIGNALS[:1], 64000, device="cpu")
    cfg = PipelineConfig(frontend=FrontendConfig(feature_type="lpcc"))
    with pytest.raises(NotImplementedError, match="item 14"):
        tpl.extract_recording_features(x, n, cfg, 398)


@pytest.mark.parametrize("quantum", [32000, 16000, 7])
def test_group_by_padded_len_matches_jax(quantum):
    sigs = SIGNALS + [synth_word("one", 3), np.zeros(0, np.float32),
                      SIGNALS[1][:40000]]
    got = tpl.group_by_padded_len(sigs, quantum)
    want = jpl.group_by_padded_len(sigs, quantum)
    assert list(got) == list(want)
    assert all(got[key] == [int(i) for i in want[key]] for key in want)


def test_scores_match_jax(jax_rec, port_rec):
    want = JaxSpotter(jax_rec).scores(SIGNALS)
    got = KeywordSpotter(port_rec).scores(SIGNALS)
    assert len(got) == len(want) == len(SIGNALS)
    for (gn, gs_), (wn, ws) in zip(got, want):
        assert gn.shape == np.asarray(wn).shape
        np.testing.assert_allclose(gn, np.asarray(wn), rtol=1e-3, atol=1e-5)
        np.testing.assert_array_equal(gs_, np.asarray(ws))


def test_spot_events_match_jax(jax_rec, port_rec):
    thr = JaxSpotter(jax_rec).calibrate_threshold()
    want = JaxSpotter(jax_rec).spot(SIGNALS, threshold=thr)
    got = KeywordSpotter(port_rec).spot(SIGNALS, threshold=thr)
    assert [[ev[:3] for ev in evs] for evs in got] == \
        [[ev[:3] for ev in evs] for evs in want]
    for evs_g, evs_w in zip(got, want):
        for g, w in zip(evs_g, evs_w):
            assert g[3] == pytest.approx(w[3], rel=1e-3)


def test_spotter_finds_the_planted_keywords(port_rec):
    spotter = KeywordSpotter(port_rec)
    thr = spotter.calibrate_threshold()
    hits = n_truth = 0
    for evs, (_, truth) in zip(spotter.spot(SIGNALS, threshold=thr), STREAMS):
        for lab, s, e in truth:
            n_truth += 1
            hits += any(ev[0] == lab and s // 160 <= (ev[1] + ev[2]) / 2 <= e // 160
                        for ev in evs)
    assert n_truth > 0 and hits == n_truth


def test_calibrate_threshold_matches_jax(jax_rec, port_rec):
    want = JaxSpotter(jax_rec).calibrate_threshold()
    got = KeywordSpotter(port_rec).calibrate_threshold()
    assert got == pytest.approx(want, rel=1e-4)


def test_calibrate_threshold_requires_pairs(jax_rec):
    ids = np.asarray(jax_rec._bank_label_ids)
    first = [int(np.flatnonzero(ids == v)[0]) for v in (0, 1)]
    one_each = KnnDtwRecognizer.from_arrays(
        np.stack(jax_rec._bank_feats)[first], np.asarray(jax_rec._bank_lens)[first],
        ids[first], jax_rec.labels, PipelineConfig(), device="cpu")
    with pytest.raises(ValueError, match="genuine"):
        KeywordSpotter(one_each).calibrate_threshold()
    zeros = np.flatnonzero(ids == 0)
    one_label = KnnDtwRecognizer.from_arrays(
        np.stack(jax_rec._bank_feats)[zeros], np.asarray(jax_rec._bank_lens)[zeros],
        ids[zeros], jax_rec.labels[:1], PipelineConfig(), device="cpu")
    with pytest.raises(ValueError, match="labels"):
        KeywordSpotter(one_label).calibrate_threshold()


def test_threshold_resolution_order(jax_rec, tmp_path):
    rec = _port_rec(jax_rec)
    sp0 = KeywordSpotter(rec)
    assert (sp0.threshold, sp0.threshold_source) == (
        tspotter.DEFAULT_SPOT_THRESHOLD, "default")
    assert tspotter.DEFAULT_SPOT_THRESHOLD == 40.0
    rec.spot_threshold = 33.5
    sp1 = KeywordSpotter(rec)
    assert (sp1.threshold, sp1.threshold_source) == (33.5, "bank-calibrated")
    sp2 = KeywordSpotter(rec, threshold=41.0)
    assert (sp2.threshold, sp2.threshold_source) == (41.0, "explicit")
    # a threshold calibrated by the JAX package travels with its bank
    jrec = JaxRecognizer(JPipelineConfig())
    jrec.labels, jrec._bank_feats = jax_rec.labels, jax_rec._bank_feats
    jrec._bank_lens, jrec._bank_label_ids = jax_rec._bank_lens, jax_rec._bank_label_ids
    jrec.spot_threshold = 31.25
    path = str(tmp_path / "bank.npz")
    jrec.save(path)
    loaded = KnnDtwRecognizer.load(path, PipelineConfig(), device="cpu")
    assert KeywordSpotter(loaded).threshold == pytest.approx(31.25)
    assert KeywordSpotter(loaded).threshold_source == "bank-calibrated"


def test_mesh_raises(jax_rec):
    with pytest.raises(NotImplementedError, match="item 15"):
        KnnDtwRecognizer(PipelineConfig(), device="cpu", mesh=object())
    meshed = _port_rec(jax_rec)
    meshed.mesh = object()
    with pytest.raises(NotImplementedError, match="item 15"):
        KeywordSpotter(meshed)


@pytest.mark.parametrize("impl", ["auto", "scan", "fused"])
def test_routes_agree_on_cpu_and_launch_nothing(port_rec, impl):
    before = _build.LAUNCHES["spot_subseq"]
    got = KeywordSpotter(port_rec, impl=impl).scores(SIGNALS[:2])
    want = KeywordSpotter(port_rec, impl="scan").scores(SIGNALS[:2])
    assert _build.LAUNCHES["spot_subseq"] == before
    for (gn, gs_), (wn, ws) in zip(got, want):
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(gs_, ws)


def test_sub_batching_changes_no_score(port_rec, monkeypatch):
    want = KeywordSpotter(port_rec).scores(SIGNALS)
    monkeypatch.setattr(tspotter, "_COST_BUDGET_ELEMS", 1)   # one stream a call
    got = KeywordSpotter(port_rec).scores(SIGNALS)
    for (gn, gs_), (wn, ws) in zip(got, want):
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(gs_, ws)


def test_empty_input_and_frame_to_seconds(port_rec):
    spotter = KeywordSpotter(port_rec)
    assert spotter.scores([]) == [] and spotter.spot([]) == []
    assert spotter.frame_to_seconds(100) == pytest.approx(1.0)
    assert spotter.cfg.use_vad is False and port_rec.cfg.use_vad is True


def test_spotter_default_device_is_the_card(jax_rec):
    rec = KnnDtwRecognizer.from_arrays(
        np.stack(jax_rec._bank_feats), jax_rec._bank_lens,
        jax_rec._bank_label_ids, jax_rec.labels)
    assert rec.device.type == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises((AssertionError, RuntimeError)):
        KeywordSpotter(rec).spot(SIGNALS[:1])
