"""Cascade keyword spotting parity: the port's ``CascadeSpotter`` and
``StreamingCascadeSpotter`` against the JAX package.

Stage 1 runs on the JAX recognizer's own parameters and UBM (2 words,
S = 4, M = 2, tests/test_cascade_spot.py's fixture), carried across as
numpy; each package enrolls its bank from the same ``synth_word`` signals.
Tolerances: rescored and spotted events with equal labels and spans, and
scores at rtol 1e-4 (span-normalised DTW distances of features that agree
to ~1e-4; 1.0e-6 relative measured).  Streaming against offline by JAX's
rule (tests/test_cascade_spot.py): labels in order, spans within 3 frames.

The JAX streaming cascade checks a candidate's readiness on its window's
end clamped to the frames received (``dsp_tpu/models/spotter.py:812-814``),
so at ``add_deltas=False`` it reranks windows cut short and parts from its
offline cascade; the port's checks the unclamped end while the stream runs
(``test_streaming_cascade_reranks_no_truncated_window``).  Every port
object lives on the CPU.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_spotter import _build_stream  # noqa: E402

from dsp_tpu.config import HmmConfig as JHmmConfig  # noqa: E402
from dsp_tpu.config import PipelineConfig as JPipelineConfig  # noqa: E402
from dsp_tpu.io.dataset import make_corpus, synth_word  # noqa: E402
from dsp_tpu.models import spotter as jspotter  # noqa: E402
from dsp_tpu.models.gmm_hmm import GmmHmmRecognizer as JaxHmm  # noqa: E402
from dsp_tpu.models.knn_dtw import KnnDtwRecognizer as JaxBank  # noqa: E402

from dsp_tpu_torch import GmmHmmRecognizer, HmmConfig, KnnDtwRecognizer  # noqa: E402
from dsp_tpu_torch import PipelineConfig  # noqa: E402
from dsp_tpu_torch.config import FrontendConfig  # noqa: E402
from dsp_tpu_torch.models import CascadeSpotter, StreamingCascadeSpotter  # noqa: E402
from dsp_tpu_torch.models import gmm_hmm as pg  # noqa: E402

KEYWORDS = ["zero", "one"]
HCFG = dict(n_states=4, n_mix=2, n_iter=4)
CHUNK = 1600
# (words, seed) of tests/test_cascade_spot.py's streams
STREAMS = {seed: _build_stream(words, seed=seed)
           for words, seed in ((["three", "zero", "four", "one", "five"], 2),
                               (["zero", "six", "zero"], 5), (["seven", "one", "eight"], 6),
                               (["one", "nine", "zero", "two"], 7),
                               (["zero", "six", "one"], 8), (["one", "six"], 9))}


@pytest.fixture(scope="module")
def hmm_pair():
    jrec = JaxHmm(JPipelineConfig(), JHmmConfig(**HCFG))
    jrec.fit(make_corpus(KEYWORDS, n_per_word=5, seed=0))
    rec = GmmHmmRecognizer(PipelineConfig(), HmmConfig(**HCFG), device="cpu")
    rec.labels = list(jrec.labels)
    rec.params = pg.params_from_numpy(tuple(np.array(a) for a in jrec.params), "cpu")
    rec.ubm = pg.ubm_from_numpy([np.array(a) for a in jrec.ubm], "cpu")
    return jrec, rec


def _banks(add_deltas: bool = True):
    """(JAX bank, port bank) enrolled from the same signals."""
    jcfg = JPipelineConfig()
    jcfg = dataclasses.replace(jcfg, frontend=dataclasses.replace(jcfg.frontend,
                                                                  add_deltas=add_deltas))
    jbank = JaxBank(jcfg)
    bank = KnnDtwRecognizer(PipelineConfig(frontend=FrontendConfig(add_deltas=add_deltas)),
                            device="cpu")
    for lab in KEYWORDS:
        sigs = [synth_word(lab, i) for i in range(3)]
        jbank.enroll(lab, sigs)
        bank.enroll(lab, sigs)
    return jbank, bank


@pytest.fixture(scope="module")
def bank_pair():
    return _banks()


@pytest.fixture(scope="module")
def cascades(hmm_pair, bank_pair):
    return (jspotter.CascadeSpotter(hmm_pair[0], bank_pair[0]),
            CascadeSpotter(hmm_pair[1], bank_pair[1]))


def _assert_same_events(got, want):
    assert [ev[:3] for ev in got] == [ev[:3] for ev in want], (got, want)
    np.testing.assert_allclose([ev[3] for ev in got], [ev[3] for ev in want], rtol=1e-4)


def _near(got, want, frames: int = 3) -> bool:
    """JAX's streaming-against-offline rule: labels in order, spans within
    ``frames``."""
    return [ev[0] for ev in got] == [ev[0] for ev in want] and all(
        abs(g[1] - w[1]) <= frames and abs(g[2] - w[2]) <= frames for g, w in zip(got, want))


def _run_stream(sc, sig):
    events = []
    n_full = len(sig) // CHUNK
    for c in range(n_full):
        events += sc.feed(sig[c * CHUNK:(c + 1) * CHUNK])
    return events + sc.flush(sig[n_full * CHUNK:])


@pytest.mark.parametrize("seeds", [(2,), (5, 6), (7, 8, 9)])
def test_rescored_and_spot_match_jax(cascades, seeds):
    jcas, cas = cascades
    sigs = [STREAMS[s][0] for s in seeds]
    want, got = jcas.rescored(sigs), cas.rescored(sigs)
    assert all(got)
    for g, w in zip(got, want):
        _assert_same_events(g, w)
    for thr in (None, 15.0):
        for g, w in zip(cas.spot(sigs, threshold=thr), jcas.spot(sigs, threshold=thr)):
            _assert_same_events(g, w)


def test_cascade_finds_keywords_with_full_spans(cascades):
    """Every planted keyword with its label and a >= 50 %-overlap whole-word
    span at the defaults (tests/test_cascade_spot.py's check)."""
    cas = cascades[1]
    for seed in (2, 5, 6):
        sig, spans = STREAMS[seed]
        truth = [sp for sp in spans if sp[0] in KEYWORDS]
        events, = cas.spot([sig])
        assert [ev[0] for ev in events] == [sp[0] for sp in truth], events
        for (lab, s, e, sc), (_, ts, te) in zip(events, truth):
            assert min(e, te) - max(s, ts) + 1 >= 0.5 * (te - ts), (lab, (s, e), (ts, te))
            assert sc < cas.threshold


def test_rescored_events_contain_a_landmark_midpoint(cascades):
    cas = cascades[1]
    sig = STREAMS[7][0]
    cands, = cas.stage1.spot([sig], threshold=cas.hmm_threshold)
    mids = [(s + e) / 2.0 for _, s, e, _ in cands]
    resc, = cas.rescored([sig])
    assert resc
    for lab, s, e, _ in resc:
        assert any(s <= m <= e for m in mids), ((lab, s, e), mids)


def test_spot_is_filtered_suppressed_rescored(cascades):
    cas = cascades[1]
    sig = STREAMS[8][0]
    resc, = cas.rescored([sig])
    for thr in (0.0, 20.0, cas.threshold, 1e9):
        got, = cas.spot([sig], threshold=thr)
        assert got == cas.suppress([ev for ev in resc if ev[3] < thr]), thr
    assert cas.spot([sig], threshold=0.0) == [[]]


def test_suppress_keeps_best_of_overlapping():
    evs = [("a", 10, 30, 5.0), ("b", 25, 40, 3.0), ("c", 50, 60, 9.0), ("d", 55, 58, 9.5)]
    assert CascadeSpotter.suppress(evs) == [("b", 25, 40, 3.0), ("c", 50, 60, 9.0)]
    assert CascadeSpotter.suppress([]) == []
    assert CascadeSpotter.suppress(evs) == jspotter.CascadeSpotter.suppress(evs)


def test_silence_and_empty_inputs(cascades):
    cas = cascades[1]
    assert cas.spot([np.zeros(cas.cfg.frontend.sample_rate, np.float32)]) == [[]]
    assert cas.spot([]) == [] and cas.rescored([]) == []


def test_stage_mismatch_raises(hmm_pair):
    other = PipelineConfig(frontend=FrontendConfig(hop_len=200))
    for cls in (CascadeSpotter, StreamingCascadeSpotter):
        with pytest.raises(ValueError, match="frame grid"):
            cls(hmm_pair[1], KnnDtwRecognizer(other, device="cpu"))
        with pytest.raises(ValueError, match="share a device"):
            cls(hmm_pair[1], KnnDtwRecognizer(device="cuda"))


def test_streaming_cascade_matches_offline_and_jax(hmm_pair, bank_pair, cascades):
    jcas, cas = cascades
    for seed in (2, 7):
        sig = STREAMS[seed][0]
        got = _run_stream(StreamingCascadeSpotter(hmm_pair[1], bank_pair[1]), sig)
        offline, = cas.spot([sig])
        assert got and _near(got, offline), (got, offline)
        assert all(ev[3] < cas.threshold for ev in got)
        _assert_same_events(
            got, _run_stream(jspotter.StreamingCascadeSpotter(hmm_pair[0], bank_pair[0]), sig))


def test_streaming_cascade_reranks_no_truncated_window(hmm_pair):
    """At ``add_deltas=False`` on stream 7: JAX's streaming cascade reranks
    the first keyword's window cut at the frames received and reports
    ('one', 31, 87) where its offline cascade reports ('one', 31, 110); the
    port's streaming cascade equals its offline cascade and JAX's."""
    jbank, bank = _banks(add_deltas=False)
    sig = STREAMS[7][0]
    j_off, = jspotter.CascadeSpotter(hmm_pair[0], jbank).spot([sig])
    j_str = _run_stream(jspotter.StreamingCascadeSpotter(hmm_pair[0], jbank), sig)
    assert not _near(j_str, j_off), (j_str, j_off)       # the fault, in the reference
    off, = CascadeSpotter(hmm_pair[1], bank).spot([sig])
    got = _run_stream(StreamingCascadeSpotter(hmm_pair[1], bank), sig)
    assert [ev[0] for ev in got] == ["one", "zero"]
    assert _near(got, off) and _near(got, j_off), (got, off, j_off)
    _assert_same_events(off, j_off)


def test_streaming_cascade_bounded_lag(hmm_pair, bank_pair):
    """An early keyword's event emits well before the stream ends."""
    sig, _ = _build_stream(["zero", "six", "seven", "eight", "nine", "three", "four"],
                           seed=4, gap_s=0.4)
    sc = StreamingCascadeSpotter(hmm_pair[1], bank_pair[1])
    n_full = len(sig) // CHUNK
    first_at = next((c for c in range(n_full)
                     if sc.feed(sig[c * CHUNK:(c + 1) * CHUNK])), None)
    assert first_at is not None and first_at < n_full - 2, first_at


def test_streaming_cascade_reset_reuses(hmm_pair, bank_pair):
    sig = STREAMS[9][0]
    sc = StreamingCascadeSpotter(hmm_pair[1], bank_pair[1])
    first = _run_stream(sc, sig)
    sc.reset()
    assert _run_stream(sc, sig) == first
    assert [ev[0] for ev in first] == ["one"]


def test_streaming_cascade_rejects_what_it_cannot_take(hmm_pair):
    cmn = KnnDtwRecognizer(PipelineConfig(frontend=FrontendConfig(cmn=True)), device="cpu")
    cmn.enroll("zero", [synth_word("zero", 0)])
    with pytest.raises(NotImplementedError, match="cmn"):
        StreamingCascadeSpotter(hmm_pair[1], cmn)
    _, bank = _banks()
    sc = StreamingCascadeSpotter(hmm_pair[1], bank)
    with pytest.raises(ValueError, match="chunk of"):
        sc.feed(np.zeros(CHUNK - 1, np.float32))
    with pytest.raises(ValueError, match="tail of"):
        sc.flush(np.zeros(CHUNK, np.float32))
