"""The port's GMM-HMM against the plain reference (``benchmark/reference/
gmm_hmm.py``, float64, no program import), on the CPU, at the Aurora 2
topology (16 left-to-right states, 3 Gaussians a state, 39 features)
and the 8 kHz front end.

Tolerances: the port expands the Gaussian exponent into float32 matrix
products whose terms cancel (``models/gmm_hmm.py``), and sums a score
over up to 198 frames in float32; against the float64 direct form both
part by a few 1e-7 relative here (3.0e-7 emissions, 5.9e-7 scores), so
each is held at rtol 1e-5, well below what reduced precision gives
(TF32 products part by 1e-3 and more).  Features at 8 kHz part by
float32 rounding of the front end's products (rtol/atol 1e-4, as in
``benchmark/tests/test_cellbench_reference.py``).  ``recognize_batch``
and ``classify_batch`` run the same operations on the same shapes, so
they agree bit for bit.
"""

import collections

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.data import synth
from benchmark.reference import gmm_hmm as ref
from benchmark.reference import plain
from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import FrontendConfig, HmmConfig, PipelineConfig
from dsp_tpu_torch.models import gmm_hmm as gh
from dsp_tpu_torch.utils import profiling

W, S, M, F = 3, 16, 3, 39
WORDS = ["zero", "oh", "one"]
CFG = PipelineConfig(frontend=FrontendConfig(sample_rate=8000, frame_len=200, hop_len=80,
                                             n_fft=256, n_mels=23, n_mfcc=13, lifter=22),
                     max_samples=16000)


def _random_params(seed):
    g = torch.Generator().manual_seed(seed)
    log_pi, _ = gh._lr_start((W,), S, "cpu")
    return gh.HmmParams(log_pi, gh._lr_log_a(0.3 + 0.6 * torch.rand(W, S, generator=g), S),
                        2.0 * torch.randn(W, S, M, F, generator=g),
                        2.0 * torch.rand(W, S, M, F, generator=g) - 1.0,
                        torch.log_softmax(torch.randn(W, S, M, generator=g), -1))


@pytest.fixture(scope="module")
def rec():
    """Three words fitted at 16 states x 3 Gaussians on 8 kHz clips."""
    train, ids, _, _ = synth.cell_inputs(WORDS, 4, 3, 2**31 + 5, 8000, CFG.max_samples)
    r = gh.GmmHmmRecognizer(CFG, HmmConfig(n_states=S, n_mix=M, seed=3), device="cpu")
    r.fit({w: list(train[ids == i]) for i, w in enumerate(WORDS)})
    return r


@pytest.fixture(scope="module")
def queries():
    return synth.cell_inputs(WORDS, 1, 6, 2**31 + 6, 8000, CFG.max_samples)[2]


@pytest.mark.parametrize("seed", [0, 1])
def test_emissions_and_scores_match_the_plain_reference(seed):
    """Seeded random models, B = 4 utterances of T = 40 frames, lengths
    past, under and far under the 16 states."""
    p = _random_params(seed)
    lens = torch.tensor([40, 23, 12, 1], dtype=torch.int32)
    g = torch.Generator().manual_seed(100 + seed)
    feats = 2.0 * torch.randn(4, 40, F, generator=g)
    feats = feats * (torch.arange(40)[None, :, None] < lens[:, None, None])
    models = tuple(a.numpy() for a in p)
    want_b = ref.log_emissions(feats.double(), ref.as_tensors(models, "cpu"))
    torch.testing.assert_close(gh.emission_logb(feats, p).double(), want_b, rtol=1e-5, atol=0)
    got = gh.score_words(feats, lens, p).double()
    want = ref.word_scores(feats, lens, models)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_fitted_models_on_8khz_clips_match_the_plain_reference(rec, queries):
    """The port's 8 kHz front end and decode against the reference's front
    end and scores, under the models the port fitted."""
    n = torch.full((len(queries),), CFG.max_samples, dtype=torch.int32)
    ids, scores = gh.recognize_batch(torch.from_numpy(queries), n, rec.device_params(), CFG)
    fe = plain.Frontend(8000, "cpu", frame_len=200, hop=80, n_fft=256, n_mels=23, n_mfcc=13,
                        lifter=22)
    q = check.side(fe, queries, CFG.max_frames)
    feats = pl.extract_features(torch.from_numpy(queries), n, CFG)
    assert not q.alts
    assert torch.equal(feats.length.to(torch.int64), q.lens)
    assert torch.allclose(feats.feats.double(), q.feats, rtol=1e-4, atol=1e-4)
    want = ref.word_scores(q.feats, q.lens, gh.params_to_numpy(rec.params)._asdict())
    torch.testing.assert_close(scores.double(), want, rtol=1e-5, atol=0)
    assert torch.equal(ids, want.argmax(-1))


def test_recognize_batch_and_classify_batch_agree_bit_for_bit(rec, queries):
    labels, scores = rec.classify_batch(list(queries), return_scores=True)
    x, n = pl.pad_signals(list(queries), CFG.max_samples, "cpu")
    ids, got = gh.recognize_batch(x, n, rec.device_params(), CFG)
    assert np.array_equal(scores, got.numpy()) and scores.dtype == np.float32
    assert labels == [rec.labels[i] for i in ids.tolist()]
    # the decode as classify_batch ran it before the batch path
    feats = rec.extract(list(queries))
    before = gh.score_words(feats.feats, feats.length, rec.params).numpy()
    assert np.array_equal(scores, before)
    assert labels == [rec.labels[i] for i in before.argmax(-1)]
    assert rec.classify_batch(list(queries), reject=-1e9) == labels
    with pytest.raises(ValueError):
        gh.GmmHmmRecognizer(CFG, device="cpu").device_params()


def test_spans_and_counters_of_the_decode(rec, queries, monkeypatch):
    """Under a profiler the decode's spans nest in the batch path's order
    and ``viterbi_steps`` counts T - 1 a decode; with none, nothing is
    logged and the counter still counts.  On the CPU nothing waits on a
    card, so ``host_syncs`` stays."""
    monkeypatch.setattr(profiling, "SPAN_LOG", collections.deque())
    monkeypatch.setattr(profiling, "COUNT_LOG", collections.deque())
    before = profiling.counts()
    rec.classify_batch(list(queries))
    assert not profiling.SPAN_LOG and not profiling.COUNT_LOG
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        rec.classify_batch(list(queries))
    counted = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    assert counted["viterbi_steps"] == 2 * (CFG.max_frames - 1)
    assert counted.get("host_syncs", 0) == 0
    spans = {name: (t0, t1) for name, t0, t1 in profiling.SPAN_LOG}
    order = ["dsp.frontend", "dsp.emissions", "dsp.viterbi", "dsp.argmax", "dsp.readback"]
    assert set(order) <= set(spans)
    assert all(spans[a][1] <= spans[b][0] for a, b in zip(order, order[1:]))
    assert [c[0] for c in profiling.COUNT_LOG] == ["viterbi_steps"]


def test_short_utterances_take_one_state_a_frame():
    """Under 16 states an utterance of 10 frames walks states 0..9, one a
    frame, from its uniform segmentation through EM; 16 frames and more
    keep floor(t S / length)."""
    lens = torch.tensor([10, 16, 40])
    got = gh._uniform_alignment(40, lens, S)
    assert got[0, :10].tolist() == list(range(10))
    for i in (1, 2):
        t = torch.arange(40)
        assert torch.equal(got[i], torch.clamp(t * S // lens[i], max=S - 1))
    g = torch.Generator().manual_seed(0)
    base = 3.0 * torch.randn(10, F, generator=g)
    feats = torch.zeros(1, 12, 40, F)
    feats[0, :, :10] = base + 0.3 * torch.randn(12, 10, F, generator=g)
    lengths = torch.full((1, 12), 10, dtype=torch.int32)
    cfg = HmmConfig(n_states=S, n_mix=M)
    p = gh.fit_words_batched(feats, lengths, gh.word_jitter(cfg, 1, F, "cpu"), cfg)
    logb = torch.logsumexp(gh._mixture_loglik(feats, p), -1)
    _, paths = gh.viterbi_decode(p.log_pi[:, None], p.log_a[:, None], logb, lengths)
    assert (paths[0, :, :10] == torch.arange(10)).all()
