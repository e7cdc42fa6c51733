"""Out-of-vocabulary rejection parity: the port's recognizer against the
JAX package on the same bank (the fixture of tests/test_reject.py:28-34,
enrolled by the JAX package and handed to the port as arrays).

Thresholds at rtol 1e-5 (the same bank and the same scan, summed in
another order); REJECT/accept decisions, labels and evaluate's results
exactly (each package extracts the queries' features itself, and the
in-vocabulary and OOV best distances sit far from the threshold).
"""

import numpy as np
import pytest

from dsp_tpu import KnnDtwRecognizer as JaxRecognizer
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.models.knn_dtw import REJECT as JREJECT

from dsp_tpu_torch import KnnDtwRecognizer, PipelineConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.models.knn_dtw import REJECT

IN_VOCAB = ["zero", "one", "two", "three", "four"]
OOV = ["papa", "quebec", "victor"]
SIGS = ([synth_word(lab, 50 + i) for i, lab in enumerate(IN_VOCAB)]
        + [synth_word(w, 7) for w in OOV])


@pytest.fixture(scope="module")
def jax_recs():
    """JAX recognizers over one enrolled bank, calibrated per matcher."""
    recs = {}
    for matcher in ("dtw", "ltw", "cascade"):
        r = JaxRecognizer(JPipelineConfig(), matcher=matcher)
        if not recs:
            for lab in IN_VOCAB:
                r.enroll(lab, [synth_word(lab, i) for i in range(3)])
        else:
            base = recs["dtw"]
            r.labels, r._bank_feats = list(base.labels), list(base._bank_feats)
            r._bank_lens = list(base._bank_lens)
            r._bank_label_ids = list(base._bank_label_ids)
        r.calibrate_rejection()
        recs[matcher] = r
    return recs


def _port(jrec, **kw):
    return KnnDtwRecognizer.from_arrays(
        np.stack(jrec._bank_feats), jrec._bank_lens, jrec._bank_label_ids,
        jrec.labels, PipelineConfig(), device="cpu", matcher=jrec.matcher, **kw)


@pytest.fixture(scope="module")
def port_recs(jax_recs):
    recs = {}
    for matcher, jrec in jax_recs.items():
        r = _port(jrec)
        r.calibrate_rejection()
        recs[matcher] = r
    return recs


@pytest.mark.parametrize("matcher", ["dtw", "ltw", "cascade"])
def test_thresholds_and_decisions_match_jax(jax_recs, port_recs, matcher):
    jrec, prec = jax_recs[matcher], port_recs[matcher]
    assert prec.reject_threshold == pytest.approx(jrec.reject_threshold, rel=1e-5)
    assert prec.reject_scale == jrec.reject_scale == ("ltw" if matcher == "ltw" else "dtw")
    want = jrec.classify_batch(SIGS, reject=True)
    got = prec.classify_batch(SIGS, reject=True)
    assert got == [REJECT if w == JREJECT else w for w in want]
    assert got == IN_VOCAB + [REJECT] * len(OOV)
    assert prec.recognize(SIGS[1], reject=True) == "one"
    assert prec.recognize(SIGS[-1], reject=True) == REJECT


def test_explicit_thresholds_and_reject_off(port_recs):
    rec = port_recs["dtw"]
    assert REJECT not in rec.classify_batch(SIGS)
    assert REJECT not in rec.classify_batch(SIGS, reject=1e9)
    assert rec.classify_batch(SIGS, reject=1e-6) == [REJECT] * len(SIGS)


def test_evaluate_with_oov_matches_jax(jax_recs, port_recs):
    corpus = {lab: [synth_word(lab, 60)] for lab in IN_VOCAB}
    corpus["papa"] = [synth_word("papa", 7)]
    corpus["quebec"] = [synth_word("quebec", 7)]
    for matcher in ("dtw", "cascade"):
        want = jax_recs[matcher].evaluate(corpus, reject=True)
        got = port_recs[matcher].evaluate(corpus, reject=True)
        assert got["accuracy"] == want["accuracy"] == 1.0
        assert got["n"] == want["n"] == len(IN_VOCAB) + 2
        assert got["confusion"][REJECT] == {REJECT: 2}
        assert port_recs[matcher].evaluate(corpus) == jax_recs[matcher].evaluate(corpus)


def test_classify_nbest_matches_jax(jax_recs, port_recs):
    want = jax_recs["dtw"].classify_nbest(SIGS[:5], n=3)
    got = port_recs["dtw"].classify_nbest(SIGS[:5], n=3)
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for row_g, row_w in zip(got, want):
        np.testing.assert_allclose([h[1] for h in row_g], [h[1] for h in row_w], rtol=1e-3)
    assert [row[0][0] for row in got] == port_recs["dtw"].classify_batch(SIGS[:5])
    assert port_recs["dtw"].classify_nbest([]) == []


def test_classify_nbest_under_the_cascade(jax_recs, port_recs):
    # the JAX package broadcasts the [K] template labels against the
    # cascade's [B, M] shortlist distances and raises; the port scores each
    # label by its shortlisted templates
    with pytest.raises(ValueError, match="broadcast"):
        jax_recs["cascade"].classify_nbest(SIGS[:2])
    rec = port_recs["cascade"]
    rows = rec.classify_nbest(SIGS[:5], n=2)
    assert [row[0][0] for row in rows] == rec.classify_batch(SIGS[:5]) == IN_VOCAB
    assert all(1 <= len(row) <= 2 for row in rows)


def test_matcher_scale_guard(port_recs):
    rec = _port(port_recs["dtw"])
    rec.reject_threshold, rec.reject_scale = 45.0, "dtw"
    rec.matcher = "ltw"
    with pytest.raises(ValueError, match="score units"):
        rec.classify_batch(SIGS[:2], reject=True)
    assert rec.classify_batch(SIGS[:2], reject=1e9)     # explicit: no guard
    fresh = _port(port_recs["dtw"])
    with pytest.raises(ValueError, match="no rejection threshold"):
        fresh.classify_batch(SIGS[:1], reject=True)


def test_calibration_needs_pairs():
    r = KnnDtwRecognizer(PipelineConfig(), device="cpu")
    r.enroll("zero", [synth_word("zero", 0)])
    r.enroll("one", [synth_word("one", 0)])
    with pytest.raises(ValueError, match="genuine"):
        r.calibrate_rejection()
    r2 = KnnDtwRecognizer(PipelineConfig(), device="cpu")
    r2.enroll("zero", [synth_word("zero", i) for i in range(2)])
    with pytest.raises(ValueError, match="labels"):
        r2.calibrate_rejection()


@pytest.mark.parametrize("matcher", ["ltw", "cascade"])
def test_checkpoints_with_matcher_and_threshold_load_across(jax_recs, port_recs,
                                                            matcher, tmp_path):
    jrec, prec = jax_recs[matcher], port_recs[matcher]
    jrec.shortlist = prec.shortlist = 5
    try:
        prec.save(str(tmp_path / "port.npz"))
        back = JaxRecognizer.load(str(tmp_path / "port.npz"), JPipelineConfig())
        assert (back.matcher, back.ltw_len, back.shortlist, back.bucketed) == (
            matcher, 64, 5, False)
        assert back.reject_threshold == prec.reject_threshold
        assert back.classify_batch(SIGS, reject=True) == jrec.classify_batch(
            SIGS, reject=True)
        jrec.save(str(tmp_path / "jax.npz"))
        mine = KnnDtwRecognizer.load(str(tmp_path / "jax.npz"), PipelineConfig(),
                                     device="cpu")
        assert (mine.matcher, mine.shortlist, mine.reject_scale) == (
            matcher, 5, jrec.reject_scale)
        assert mine.reject_threshold == jrec.reject_threshold
        assert mine.classify_batch(SIGS, reject=True) == prec.classify_batch(
            SIGS, reject=True)
    finally:
        jrec.shortlist = prec.shortlist = 8


def test_bucketed_flag_round_trips_and_matches(port_recs, tmp_path):
    rec = _port(port_recs["dtw"], bucketed=True)
    rec.save(str(tmp_path / "b.npz"))
    back = KnnDtwRecognizer.load(str(tmp_path / "b.npz"), PipelineConfig(), device="cpu")
    assert back.bucketed and back.matcher == "dtw"
    rng = np.random.default_rng(0)
    sigs = [s[: int(len(s) * rng.uniform(0.3, 1.0))] for s in SIGS * 5]   # > 32
    labels, d = back.classify_batch(sigs, return_distances=True)
    want, want_d = port_recs["dtw"].classify_batch(sigs, return_distances=True)
    assert labels == want
    np.testing.assert_array_equal(d, want_d)
