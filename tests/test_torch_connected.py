"""Connected-word decoding in the port against the JAX package, on the CPU:
``pipeline.extract_segments_features``, ``recognize_connected_batch``,
``decode_connected`` (its power-of-two trailing bucket),
``decode_connected_level``, both recognizers' ``classify_connected``
(``method="vad"``, ``"level"``, ``grammar=``) and ``resolve_grammar``, and
``StreamingConnectedRecognizer``.

The template bank is enrolled by the JAX package and loaded through its
``.npz``; the GMM-HMM is fitted by the JAX package and its parameters
carried across (``GmmHmmRecognizer.load``).  Labels, segment starts, ends
and counts, streaming events and hypotheses are held equal; segment
features at rtol/atol 2e-4 and DP costs at rtol 1e-5 (the two packages'
float32 front-ends and cost GEMMs sum in other orders)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import pipeline as jpl
from dsp_tpu.config import HmmConfig as JHmmConfig
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.io.dataset import make_corpus
from dsp_tpu.models.gmm_hmm import GmmHmmRecognizer as JGmmHmmRecognizer
from dsp_tpu.models.knn_dtw import KnnDtwRecognizer as JKnnDtwRecognizer
from dsp_tpu.models.streaming import \
    StreamingConnectedRecognizer as JStreamingConnectedRecognizer
from dsp_tpu.ops import frontend as jfe

from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import HmmConfig, PipelineConfig
from dsp_tpu_torch.io import synth_connected, synth_word
from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
from dsp_tpu_torch.models.streaming import StreamingConnectedRecognizer
from dsp_tpu_torch.ops.grammar import Grammar

import torch_mesh_rank as mesh_rank

LABELS = ["zero", "one", "two"]
GAPLESS = dict(gap_ms=(0.0, 1.0), lead_ms=(50.0, 60.0))
# gapped recordings of 1-4 words; five of them take decode_connected's
# trailing power-of-two bucket (8 recordings at max_segments=4)
GAPPED = [synth_connected(w, s) for w, s in (
    (["two", "zero", "one"], 5), (["one"], 6), (["zero", "two"], 7),
    (["one", "one", "zero", "two"], 8), (["two"], 9))]
GAPLESS_CLIPS = [synth_connected(["two", "zero", "one"], 5, **GAPLESS),
                 synth_connected(["one", "two"], 8, **GAPLESS)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the DP loops are thousands of small ops, which
    crawl when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    """(JAX recognizer, port recognizer) over one bank: 2 templates a
    label, enrolled in JAX, loaded by the port from the .npz."""
    jrec = JKnnDtwRecognizer(JPipelineConfig())
    for lab in LABELS:
        jrec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    path = str(tmp_path_factory.mktemp("bank") / "bank.npz")
    jrec.save(path)
    return jrec, KnnDtwRecognizer.load(path, PipelineConfig(), device="cpu")


@pytest.fixture(scope="module")
def hmms(tmp_path_factory):
    """(JAX GMM-HMM, port GMM-HMM) on JAX's fitted parameters
    (tests/test_connected_viterbi.py:115's model)."""
    jrec = JGmmHmmRecognizer(JPipelineConfig(),
                             JHmmConfig(n_states=4, n_mix=2, n_iter=5))
    jrec.fit(make_corpus(LABELS, n_per_word=3, seed=0))
    path = str(tmp_path_factory.mktemp("hmm") / "hmm.npz")
    jrec.save(path)
    return jrec, GmmHmmRecognizer.load(
        path, PipelineConfig(), HmmConfig(n_states=4, n_mix=2, n_iter=5),
        device="cpu")


def _padded(signals, n):
    x, lens = np.zeros((len(signals), n), np.float32), []
    for i, s in enumerate(signals):
        x[i, :len(s)] = s
        lens.append(len(s))
    return x, np.asarray(lens, np.int32)


def test_segment_features_match_jax_and_the_isolated_window():
    x, n = _padded(GAPPED, 96000)
    segs, starts, ends, n_segs = tpl.extract_segments_features(
        torch.from_numpy(x), torch.from_numpy(n), PipelineConfig(), 4)
    jcfg = JPipelineConfig()
    want = jpl.extract_segments_features(
        jnp.asarray(x), jnp.asarray(n), jfe.make_matrices(jcfg.frontend),
        jcfg, 4)
    for g, w in zip((starts, ends, n_segs), want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    np.testing.assert_array_equal(segs.length.numpy(), np.asarray(want[0].length))
    np.testing.assert_allclose(segs.feats.numpy(), np.asarray(want[0].feats),
                               rtol=2e-4, atol=2e-4)
    # a segment's features are the isolated path's for the same window
    c = tpl._plain_cepstra(torch.from_numpy(x), PipelineConfig())
    for b, s in ((0, 2), (3, 3), (1, 0)):
        one = tpl._finalize_window(c[b:b + 1], starts[b, s:s + 1], ends[b, s:s + 1],
                                   PipelineConfig())
        assert torch.equal(one.feats[0], segs.feats[b, s])


def test_recognize_connected_batch_matches_jax(recs):
    jrec, rec = recs
    x, n = _padded(GAPPED, 96000)
    bank, ids = rec.device_bank()
    got = tpl.recognize_connected_batch(torch.from_numpy(x), torch.from_numpy(n),
                                        bank, ids, cfg=PipelineConfig(),
                                        max_segments=4)
    jbank, jids = jrec.device_bank()
    want = jpl.recognize_connected_batch(jnp.asarray(x), jnp.asarray(n), jrec.mats,
                                         jbank, jids, cfg=JPipelineConfig(),
                                         max_segments=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_decode_connected_buckets_and_matches_jax(recs):
    jrec, rec = recs
    rows = []
    bank, ids = rec.device_bank()

    def score(flat):
        rows.append(flat.length.shape[0])
        return tpl.classify_features(flat, bank, ids, cfg=rec.cfg)[0]

    got = tpl.decode_connected(GAPPED, rec.cfg, 4, score, rec._ids_to_labels, "cpu")
    assert rows == [8 * 4]          # 5 recordings pad to the next power of two
    want = jrec.classify_connected(GAPPED, max_segments=4, return_segments=True)
    assert got[0] == want[0] == [["two", "zero", "one"], ["one"], ["zero", "two"],
                                 ["one", "one", "zero", "two"], ["two"]]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, np.asarray(w).astype(np.int64))
    assert rec.classify_connected(GAPPED, max_segments=4) == want[0]
    # chunked recordings (8 a chunk at max_segments=32) decode the same
    assert ([o[:1] for o in rec.classify_connected(GAPPED, max_segments=32)]
            == [o[:1] for o in want[0]])


@pytest.mark.parametrize("matcher", ["dtw", "ltw", "cascade"])
def test_knn_vad_method_routes_each_matcher_as_jax(recs, matcher):
    jrec, rec = recs
    rec.matcher = jrec.matcher = matcher
    try:
        assert (rec.classify_connected(GAPPED[:3], max_segments=4)
                == jrec.classify_connected(GAPPED[:3], max_segments=4))
    finally:
        rec.matcher = jrec.matcher = "dtw"


def test_knn_level_and_grammar_match_jax(recs, tmp_path):
    jrec, rec = recs
    got, costs = rec.classify_connected(GAPLESS_CLIPS, max_segments=4,
                                        method="level", return_segments=True)
    want, want_costs = jrec.classify_connected(GAPLESS_CLIPS, max_segments=4,
                                               method="level", return_segments=True)
    assert got == want == [["two", "zero", "one"], ["one", "two"]]
    np.testing.assert_allclose(costs, want_costs, rtol=1e-5)
    # the splitter under-counts the gapless words; level building does not
    assert len(rec.classify_connected(GAPLESS_CLIPS[:1], max_segments=4)[0]) < 3
    path = tmp_path / "grammar.json"
    path.write_text('{"start": ["zero", "one"]}')
    for grammar in ({"no_repeat": True}, {"start": ["zero", "one"]}, str(path),
                    Grammar.no_repeat(("two", "one", "zero"))):
        assert (rec.classify_connected(GAPLESS_CLIPS, max_segments=4,
                                       method="level", grammar=grammar)
                == jrec.classify_connected(GAPLESS_CLIPS, max_segments=4,
                                           method="level", grammar=grammar))
    masks = rec.resolve_grammar({"pairs": [["one", "two"]], "end": ["two"]})
    for g, w in zip(masks, jrec.resolve_grammar({"pairs": [["one", "two"]],
                                                 "end": ["two"]})):
        np.testing.assert_array_equal(g, w)
    # a grammar no recording fits decodes to nothing
    assert rec.classify_connected(GAPLESS_CLIPS[:1], method="level",
                                  grammar={"start": [], "end": []}) == [[]]


def test_decode_connected_level_matches_jax(recs):
    jrec, rec = recs
    bank, ids = rec.device_bank()
    sigs = GAPLESS_CLIPS + [GAPPED[1], np.zeros(40000, np.float32)]
    got = tpl.decode_connected_level(sigs, rec.cfg, bank, ids, 3, 1.5,
                                     device="cpu")
    jbank, jids = jrec.device_bank()
    want = jpl.decode_connected_level(sigs, jrec.mats, jrec.cfg, jbank, jids, 3, 1.5)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def test_hmm_connected_matches_jax(hmms):
    jrec, rec = hmms
    for method in ("vad", "level"):
        got = rec.classify_connected(GAPPED[:3] + GAPLESS_CLIPS, max_segments=4,
                                     method=method)
        assert got == jrec.classify_connected(GAPPED[:3] + GAPLESS_CLIPS,
                                              max_segments=4, method=method)
    assert got[3] == ["two", "zero", "one"]
    for grammar in ({"no_repeat": True}, {"start": ["zero", "one"]}):
        assert (rec.classify_connected(GAPLESS_CLIPS, max_segments=4,
                                       method="level", grammar=grammar)
                == jrec.classify_connected(GAPLESS_CLIPS, max_segments=4,
                                           method="level", grammar=grammar))
    for g, w in zip(rec.resolve_grammar({"no_repeat": True}),
                    jrec.resolve_grammar({"no_repeat": True})):
        np.testing.assert_array_equal(g, w)


def test_hmm_connected_with_noise_adapt_matches_jax(hmms):
    jrec, rec = hmms
    rng = np.random.default_rng(3)
    noisy = [(s + 0.05 * rng.standard_normal(len(s))).astype(np.float32)
             for s in GAPPED[:2]]
    jrec.noise_adapt = rec.noise_adapt = True
    try:
        for method in ("vad", "level"):
            assert (rec.classify_connected(noisy, max_segments=4, method=method)
                    == jrec.classify_connected(noisy, max_segments=4, method=method))
    finally:
        jrec.noise_adapt = rec.noise_adapt = False


def test_connected_errors_and_empty_input(recs, hmms):
    _, rec = recs
    _, hmm = hmms
    for r in (rec, hmm):
        assert r.classify_connected([]) == []
        assert r.classify_connected([], method="level") == []
        with pytest.raises(ValueError, match="require method='level'"):
            r.classify_connected(GAPPED[:1], grammar={"no_repeat": True})
        with pytest.raises(ValueError, match="unknown connected method"):
            r.classify_connected(GAPPED[:1], method="nope")
        with pytest.raises(ValueError, match="does not cover"):
            r.classify_connected(GAPPED[:1], method="level",
                                 grammar=Grammar.loop(("zero", "one")))
    out, starts, ends, n_segs = rec.classify_connected([], max_segments=4,
                                                       return_segments=True)
    assert out == [] and starts.shape == (0, 4) and n_segs.shape == (0,)
    with pytest.raises(ValueError, match="not fitted"):
        GmmHmmRecognizer(device="cpu").classify_connected(GAPPED[:1])
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpl.decode_connected_level(GAPPED[:1], rec.cfg, *rec.device_bank(),
                                   mesh=object(), device="cpu")
    # a one-rank mesh runs the bank-sharded DP with the unsharded result
    # (tests/test_torch_mesh_models.py holds the multi-rank meshes)
    want = tpl.decode_connected_level(GAPPED[:1], rec.cfg, *rec.device_bank(),
                                      max_levels=3, device="cpu")
    with mesh_rank.one_rank_mesh() as mesh:
        got = tpl.decode_connected_level(GAPPED[:1], rec.cfg, *rec.device_bank(),
                                         max_levels=3, mesh=mesh, device="cpu")
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def _stream(sc, sig):
    sig = np.concatenate([sig, np.zeros((-len(sig)) % 1600, np.float32)])
    events, hyps = [], []
    for lo in range(0, len(sig), 1600):
        events += sc.feed(sig[lo:lo + 1600])
        hyps.append(sc.hypothesis())
    return events + sc.flush(), hyps


STREAMS = {   # tests/test_streaming_connected.py:46-96
    "gapless3": synth_connected(["two", "zero", "one"], seed=5, gap_ms=(0.0, 1.0),
                                lead_ms=(120.0, 130.0)),
    "gapless2": synth_connected(["one", "two"], seed=11, gap_ms=(0.0, 1.0),
                                lead_ms=(120.0, 130.0)),
    "gapped": np.concatenate([
        synth_connected(["zero"], seed=21, lead_ms=(150.0, 160.0)),
        np.zeros(8000, np.float32),
        synth_connected(["two", "one"], seed=22, gap_ms=(0.0, 1.0),
                        lead_ms=(150.0, 160.0)),
        np.zeros(4000, np.float32)]),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_streaming_connected_matches_jax(recs, name):
    jrec, rec = recs
    got = _stream(StreamingConnectedRecognizer(rec, 1600, max_levels=4), STREAMS[name])
    want = _stream(JStreamingConnectedRecognizer(jrec, 1600, max_levels=4),
                   STREAMS[name])
    assert got == want
    events, hyps = got
    assert [w for ev in events for w in ev[0]] == {
        "gapless3": ["two", "zero", "one"], "gapless2": ["one", "two"],
        "gapped": ["zero", "two", "one"]}[name]
    assert any(h for h in hyps)                 # mid-utterance hypotheses
    if name == "gapless2":      # the offline level decode of the same words
        assert rec.classify_connected([STREAMS[name]], max_segments=4,
                                      method="level")[0] == events[0][0]


def test_streaming_connected_reset_chunk_and_cmn(recs):
    _, rec = recs
    sc = StreamingConnectedRecognizer(rec, 1600, max_levels=3)
    sig = synth_connected(["one"], seed=31, lead_ms=(150.0, 160.0))
    first = _stream(sc, sig)
    sc.reset()
    assert _stream(sc, sig) == first and [e[0] for e in first[0]] == [["one"]]
    with pytest.raises(ValueError, match="1600"):
        sc.feed(np.zeros(1599, np.float32))
    cfg = PipelineConfig()
    cmn = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, cmn=True))
    r = KnnDtwRecognizer(cmn, device="cpu")
    r.enroll("zero", [synth_word("zero", 0)])
    with pytest.raises(NotImplementedError, match="cmn"):
        StreamingConnectedRecognizer(r)


def test_streaming_connected_causal_cmn_matches_jax(recs, tmp_path):
    """cmn_mode="causal" streams: the port's host running mean equals the
    JAX package's golden one, and the events equal JAX's."""
    from dsp_tpu.golden.frontend import causal_cmn
    from dsp_tpu_torch.models.streaming import _np_causal_cmn

    c = np.random.default_rng(2).standard_normal((40, 13)).astype(np.float32)
    np.testing.assert_array_equal(_np_causal_cmn(c, 0.995), causal_cmn(c, 0.995))
    jcfg = JPipelineConfig()
    jcfg = dataclasses.replace(jcfg, frontend=dataclasses.replace(
        jcfg.frontend, cmn=True, cmn_mode="causal"))
    jrec = JKnnDtwRecognizer(jcfg)
    for lab in LABELS:
        jrec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    jrec.save(str(tmp_path / "causal.npz"))
    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, cmn=True, cmn_mode="causal"))
    rec = KnnDtwRecognizer.load(str(tmp_path / "causal.npz"), cfg, device="cpu")
    sig = STREAMS["gapless2"]
    assert (_stream(StreamingConnectedRecognizer(rec, 1600, max_levels=4), sig)
            == _stream(JStreamingConnectedRecognizer(jrec, 1600, max_levels=4), sig))


def test_hmm_level_inserts_words_as_jax_at_the_default_config(tmp_path):
    """At the default HmmConfig (10 digits x 10) and word_penalty=0 the
    connected Viterbi explains some inter-word silences as an extra short
    word on chip_smoke.py's connected recordings; the JAX package decodes
    the same word lists, insertions included."""
    from dsp_tpu_torch.io import DIGITS

    jrec = JGmmHmmRecognizer(JPipelineConfig(), JHmmConfig())
    jrec.fit({lab: [synth_word(lab, i) for i in range(10)] for lab in DIGITS})
    jrec.save(str(tmp_path / "hmm.npz"))
    rec = GmmHmmRecognizer.load(str(tmp_path / "hmm.npz"), PipelineConfig(),
                                HmmConfig(), device="cpu")
    truth = [[DIGITS[(i + j) % 10] for j in range(3)] for i in range(4)]
    clips = [synth_connected(w, 300 + i)[:96_000] for i, w in enumerate(truth)]
    got = rec.classify_connected(clips, 4, method="level")
    assert got == jrec.classify_connected(clips, 4, method="level")
    assert any(len(g) > len(w) for g, w in zip(got, truth))
    assert rec.classify_connected(clips, 4) == truth        # the VAD split
