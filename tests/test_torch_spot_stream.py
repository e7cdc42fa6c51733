"""Streaming keyword spotting parity: the port's SPRING update
(``ops/spot.py:spot_chunk``) and ``StreamingSpotter`` against the JAX
package.

``spot_chunk``: norms at rtol 2e-5 and start witnesses equal to JAX's on the
same inputs (tests/test_spot.py's rule: the two scans sum in other tree
orders); the port's own outputs bit-exact under any chunking, and their
concatenation equal to the offline plain route at the same rule.
``StreamingSpotter``: events (label, start, end) equal to JAX's and scores
at rtol 1e-3 (the features agree to ~1e-4 and a score sums ~200 local
costs, tests/test_torch_spotter.py's rule), on a bank the JAX package
enrolls and the port loads through ``from_arrays``.  Every port object
lives on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.models.knn_dtw import KnnDtwRecognizer as JaxRecognizer
from dsp_tpu.models.spotter import StreamingSpotter as JaxStreamingSpotter
from dsp_tpu.ops import spot as jsp

from dsp_tpu_torch import KeywordSpotter, KnnDtwRecognizer, PipelineConfig
from dsp_tpu_torch.config import FrontendConfig
from dsp_tpu_torch.io import synth_spotting_stream, synth_word
from dsp_tpu_torch.models import StreamingSpotter
from dsp_tpu_torch.models import spotter as tspotter
from dsp_tpu_torch.ops import spot as tsp

KEYWORDS = ["zero", "one"]
VOCAB = ["zero", "one", "three", "four", "five"]
STREAMS = [synth_spotting_stream(KEYWORDS, VOCAB, seed=s, n_words=5)[0]
           for s in (4, 7)]


def _spring_inputs(seed, u=24, f=3, k=2, t=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((u, f)).astype(np.float32),
            rng.standard_normal((k, t, f)).astype(np.float32),
            np.asarray([t, 3], np.int32)[:k])


def _run_spring(mod, stream, bank, lens, chunks, squared=False):
    """Feed ``stream`` in ``chunks`` through one buffer width; the per-chunk
    (norm, start) columns of the valid frames and the final state."""
    to = torch.from_numpy if mod is tsp else jnp.asarray
    k, t, f = bank.shape
    state = tsp.spot_init(k, t, "cpu") if mod is tsp else jsp.spot_init(k, t)
    width = max(chunks)
    outs, off = [], 0
    for c in chunks:
        buf = np.zeros((width, f), np.float32)
        buf[:c] = stream[off:off + c]
        n = c if mod is tsp else jnp.asarray(c, jnp.int32)
        state, norm, start = mod.spot_chunk(state, to(buf), n, to(bank), to(lens),
                                            squared=squared)
        outs.append((np.asarray(norm), np.asarray(start)))
        off += c
    return outs, state


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("chunks", [[24], [8, 8, 8], [5, 7, 12], [1] * 24])
def test_spot_chunk_matches_jax(chunks, squared):
    stream, bank, lens = _spring_inputs(9)
    got, state = _run_spring(tsp, stream, bank, lens, chunks, squared)
    want, jstate = _run_spring(jsp, stream, bank, lens, chunks, squared)
    for (gn, gs), (wn, ws) in zip(got, want):
        assert gn.shape == wn.shape and gs.dtype == ws.dtype == np.int32
        np.testing.assert_allclose(gn, wn, rtol=2e-5, atol=1e-6)
        np.testing.assert_array_equal(gs, ws)
    for g, w in zip(state, jstate):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5)
    assert int(state.n_fed) == 24


def test_spot_chunk_invalid_frames_score_big_and_keep_the_state():
    stream, bank, lens = _spring_inputs(3)
    state = tsp.spot_init(2, 5, "cpu")
    buf = torch.from_numpy(stream[:8])
    after, norm, _ = tsp.spot_chunk(state, buf, 3, torch.from_numpy(bank),
                                    torch.from_numpy(lens))
    assert (norm[:, 3:] == tsp.BIG).all() and (norm[:, :3] < tsp.BIG).all()
    assert int(after.n_fed) == 3
    ref, _, _ = tsp.spot_chunk(state, buf[:3], 3, torch.from_numpy(bank),
                               torch.from_numpy(lens))
    for a, b in zip(after, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,f", [(9, 3), (4, 39)])
def test_spring_bit_exact_across_chunkings_and_equal_to_offline(seed, f):
    stream, bank, lens = _spring_inputs(seed, u=24, f=f, k=2, t=5)
    runs = []
    for chunks in ([24], [8, 8, 8], [1] * 24):
        outs, _ = _run_spring(tsp, stream, bank, lens, chunks)
        runs.append((np.concatenate([n[:, :c] for (n, _), c in zip(outs, chunks)], 1),
                     np.concatenate([s[:, :c] for (_, s), c in zip(outs, chunks)], 1)))
    for norm, start in runs[1:]:
        np.testing.assert_array_equal(norm, runs[0][0])
        np.testing.assert_array_equal(start, runs[0][1])
    off_n, off_s = tsp.subseq_dtw_batch_plain(
        torch.from_numpy(stream[None]), torch.tensor([24]), torch.from_numpy(bank),
        torch.from_numpy(lens))
    np.testing.assert_allclose(runs[0][0], off_n[0].numpy(), rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(runs[0][1], off_s[0].numpy())


# ---------------------------------------------------------------- the spotter


@pytest.fixture(scope="module")
def jax_rec():
    rec = JaxRecognizer(JPipelineConfig())
    for lab in KEYWORDS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    return rec


def _port_rec(jax_rec):
    return KnnDtwRecognizer.from_arrays(
        np.stack(jax_rec._bank_feats), jax_rec._bank_lens,
        jax_rec._bank_label_ids, jax_rec.labels, PipelineConfig(), device="cpu")


def _spot_stream(spotter, sig, chunk):
    n_full = len(sig) // chunk * chunk
    events = []
    for lo in range(0, n_full, chunk):
        events += spotter.feed(sig[lo:lo + chunk])
    return events + spotter.flush(sig[n_full:])


THRESHOLD = 30.0


@pytest.mark.parametrize("stream", [0, 1])
def test_streaming_spotter_events_match_jax(jax_rec, stream):
    sig = STREAMS[stream]
    want = _spot_stream(JaxStreamingSpotter(jax_rec, 1600, threshold=THRESHOLD), sig, 1600)
    got = _spot_stream(StreamingSpotter(_port_rec(jax_rec), 1600, threshold=THRESHOLD),
                       sig, 1600)
    assert want and [ev[:3] for ev in got] == [ev[:3] for ev in want]
    for g, w in zip(got, want):
        assert g[3] == pytest.approx(w[3], rel=1e-3)


def test_streaming_spotter_matches_the_offline_spotter(jax_rec):
    rec = _port_rec(jax_rec)
    sig = STREAMS[0]
    offline, = KeywordSpotter(rec).spot([sig], threshold=THRESHOLD)
    got = _spot_stream(StreamingSpotter(rec, 1600, threshold=THRESHOLD), sig, 1600)
    assert [ev[0] for ev in got] == [ev[0] for ev in offline] and got
    for (l1, s1, e1, c1), (l2, s2, e2, c2) in zip(got, offline):
        assert abs(s1 - s2) <= 2 and abs(e1 - e2) <= 2
        np.testing.assert_allclose(c1, c2, rtol=1e-3, atol=1e-5)


def test_streaming_spotter_chunk_size_invariance(jax_rec):
    rec = _port_rec(jax_rec)
    sig = STREAMS[1]
    # flush(tail) drops the pad frames, so the streams are sample-identical
    outs = [_spot_stream(StreamingSpotter(rec, cl, threshold=THRESHOLD), sig, cl)
            for cl in (800, 1600)]
    assert outs[0] == outs[1] and outs[0]


def test_streaming_spotter_no_duplicate_emission(jax_rec):
    # one keyword, then distractors: the trailing sub-threshold columns of
    # the same occurrence must not re-open a match after its emission
    sig, truth = synth_spotting_stream(["zero"], ["zero", "three", "four", "five"],
                                       seed=4, n_words=5)
    assert [lab for lab, _, _ in truth] == ["zero"]
    kw = dict(threshold=THRESHOLD, hangover=10)
    want = _spot_stream(JaxStreamingSpotter(jax_rec, 1600, **kw), sig, 1600)
    got = _spot_stream(StreamingSpotter(_port_rec(jax_rec), 1600, **kw), sig, 1600)
    assert [ev[0] for ev in got] == ["zero"]
    assert [ev[:3] for ev in got] == [ev[:3] for ev in want]


def test_streaming_spotter_threshold_source(jax_rec):
    rec = _port_rec(jax_rec)
    for stored, explicit, want in ((None, None, (tspotter.DEFAULT_SPOT_THRESHOLD, "default")),
                                   (33.5, None, (33.5, "bank-calibrated")),
                                   (33.5, 41.0, (41.0, "explicit"))):
        rec.spot_threshold = jax_rec.spot_threshold = stored
        got = StreamingSpotter(rec, threshold=explicit)
        ref = JaxStreamingSpotter(jax_rec, threshold=explicit)
        assert (got.threshold, got.threshold_source) == want
        assert (ref.threshold, ref.threshold_source) == want
    jax_rec.spot_threshold = None


def test_streaming_spotter_refuses_cmn_and_bad_chunks(jax_rec):
    rec = _port_rec(jax_rec)
    with pytest.raises(ValueError, match="1600"):
        StreamingSpotter(rec).feed(np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="fewer"):
        StreamingSpotter(rec).flush(np.zeros(1600, np.float32))
    rec.cfg = PipelineConfig(frontend=FrontendConfig(cmn=True))
    with pytest.raises(NotImplementedError, match="cmn"):
        StreamingSpotter(rec)
