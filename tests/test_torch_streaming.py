"""Streaming front-end and online recognizer parity: the port's
``ops/streaming.py`` and ``models/streaming.py`` against the JAX package.

Inputs are seeded numpy; every port object lives on the CPU.  Chunk by
chunk: MFCC rtol/atol 2e-4 (measured: the two chains differ by up to 1.5x
of 1e-4 on these streams, from GEMM summation order; JAX's own
streaming-vs-offline bound is 1e-3), energy rtol 1e-4, ZCR, validity, VAD
flags and utterance indices equal; the final state's integer leaves equal
and its float leaves at rtol 1e-5 (the noise PSD sums are MFCC-chain
GEMMs: rtol 2e-4).  Recognizer events (label, start, end) equal, on a bank
the JAX package enrolls and the port loads through ``from_arrays``.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import FrontendConfig as JFrontendConfig
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.config import VadConfig as JVadConfig
from dsp_tpu.models.knn_dtw import KnnDtwRecognizer as JaxRecognizer
from dsp_tpu.models.streaming import StreamingRecognizer as JaxStreaming
from dsp_tpu.ops import frontend as jfe
from dsp_tpu.ops import streaming as jst

from dsp_tpu_torch import KnnDtwRecognizer, PipelineConfig, StreamingRecognizer
from dsp_tpu_torch.config import FrontendConfig, VadConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.models import streaming as tms
from dsp_tpu_torch.ops import frontend as tfe
from dsp_tpu_torch.ops import streaming as tst
from dsp_tpu_torch.utils import logging as tlog

CHUNK = 1600
LABELS = ["zero", "one", "two"]


def _stream(words, seconds, seed, noise=0.002):
    """Seeded noise with synth words at (label, seed, start sample)."""
    rng = np.random.default_rng(seed)
    sig = noise * rng.standard_normal(16000 * seconds)
    for lab, s, at in words:
        w = synth_word(lab, s, max_samples=24000)[: len(sig) - at]
        sig[at:at + len(w)] += w
    return sig.astype(np.float32)


TWO_WORDS = _stream([("zero", 50, 8000), ("two", 60, 48000)], 5, 3)


def _chunks(x, chunk):
    return [x[c * chunk:(c + 1) * chunk] for c in range(len(x) // chunk)]


def _assert_outputs_equal(got, want, what=""):
    for name, g, w in zip(tst.ChunkOutput._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name, g.dtype, w.dtype)
        if name == "mfcc":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=what + name)
        elif name == "energy":
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=what + name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what + name)


def _assert_states_equal(got, want):
    for name, g, w in zip(tst.StreamState._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype)
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4 if name == "noise_psd" else 1e-5,
                                       err_msg=name)


def _jax_state_to_port(state):
    return tst.StreamState(*(torch.as_tensor(np.array(a)) for a in state))


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("kw,chunk", [({}, 1600), ({}, 800), ({}, 480),
                                      ({"frame_len": 160, "hop_len": 160}, 1600),
                                      ({"frame_len": 512, "hop_len": 128}, 1280)])
def test_residual_len_matches_jax(kw, chunk):
    assert tst.residual_len(FrontendConfig(**kw), chunk) == \
        jst.residual_len(JFrontendConfig(**kw), chunk)


def test_residual_len_raises():
    for mod, cfg in ((tst, FrontendConfig()), (jst, JFrontendConfig())):
        with pytest.raises(ValueError, match="multiple of hop_len"):
            mod.residual_len(cfg, 1601)
        with pytest.raises(ValueError, match=">= frame_len"):
            mod.residual_len(cfg, 320)


@pytest.mark.parametrize("denoise", [None, "spectral_subtraction"])
@pytest.mark.parametrize("kw,chunk", [({}, 1600), ({}, 800),
                                      ({"frame_len": 160, "hop_len": 160}, 1600)],
                         ids=["chunk1600", "chunk800", "zero_residual"])
def test_process_chunk_matches_jax(kw, chunk, denoise):
    fcfg, jfcfg = FrontendConfig(denoise=denoise, **kw), JFrontendConfig(denoise=denoise, **kw)
    mats, jmats = tfe.make_matrices(fcfg, "cpu"), jfe.make_matrices(jfcfg)
    state, jstate = tst.init_state(fcfg, chunk, "cpu"), jst.init_state(jfcfg, chunk)
    _assert_states_equal(state, jstate)
    n_ends = 0
    for c, x in enumerate(_chunks(TWO_WORDS, chunk)):
        state, out = tst.process_chunk(state, torch.from_numpy(x), mats, fcfg,
                                       VadConfig(), chunk)
        jstate, jout = jst.process_chunk(jstate, jnp.asarray(x), jmats, jfcfg,
                                         JVadConfig(), chunk)
        _assert_outputs_equal(out, jout, f"chunk {c}: ")
        n_ends += int(out.utt_end.sum())
    _assert_states_equal(state, jstate)
    assert n_ends == 2
    if not kw:
        assert state.residual.shape == (tst.residual_len(fcfg, chunk),)
    else:
        assert state.residual.shape == (0,)


def test_jax_midstream_state_continues_in_the_port():
    fcfg, jfcfg = FrontendConfig(), JFrontendConfig()
    mats, jmats = tfe.make_matrices(fcfg, "cpu"), jfe.make_matrices(jfcfg)
    chunks = _chunks(TWO_WORDS, CHUNK)
    jstate = jst.init_state(jfcfg, CHUNK)
    c = 0
    while int(jstate.vad_state) != jst.SPEECH:
        jstate, _ = jst.process_chunk(jstate, jnp.asarray(chunks[c]), jmats,
                                      jfcfg, JVadConfig(), CHUNK)
        c += 1
    state = _jax_state_to_port(jstate)
    assert int(state.vad_state) == tst.SPEECH
    for x in chunks[c:c + 20]:
        state, out = tst.process_chunk(state, torch.from_numpy(x), mats, fcfg,
                                       VadConfig(), CHUNK)
        jstate, jout = jst.process_chunk(jstate, jnp.asarray(x), jmats, jfcfg,
                                         JVadConfig(), CHUNK)
        _assert_outputs_equal(out, jout)
    _assert_states_equal(state, jstate)


@pytest.mark.parametrize("chunk", [1600, 3200])
def test_streaming_mfcc_equals_the_ports_offline_mfcc(chunk):
    x = np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    fcfg = FrontendConfig()
    mats = tfe.make_matrices(fcfg, "cpu")
    want = tfe.mfcc(torch.from_numpy(x), fcfg, mats).numpy()
    state = tst.init_state(fcfg, chunk, "cpu")
    got = []
    for xc in _chunks(x, chunk):
        state, out = tst.process_chunk(state, torch.from_numpy(xc), mats, fcfg,
                                       VadConfig(), chunk)
        got.append(out.mfcc.numpy()[out.frame_valid.numpy()])
    got = np.concatenate(got)
    # only frames whole inside the consumed chunks are emitted
    assert 0 <= want.shape[0] - got.shape[0] <= 2
    np.testing.assert_allclose(got, want[: got.shape[0]], rtol=1e-3, atol=1e-3)


def test_batched_streams_match_single_streams():
    s_streams, n_chunks = 3, 8
    sigs = np.stack([_stream([(lab, 10 + s, 2000)], 1, 9 + s)[: CHUNK * n_chunks]
                     for s, lab in enumerate(["zero", "one", "three"])])
    fcfg = FrontendConfig()
    mats = tfe.make_matrices(fcfg, "cpu")
    singles = []
    for s in range(s_streams):
        state = tst.init_state(fcfg, CHUNK, "cpu")
        outs = []
        for x in _chunks(sigs[s], CHUNK):
            state, out = tst.process_chunk(state, torch.from_numpy(x), mats, fcfg,
                                           VadConfig(), CHUNK)
            outs.append(out)
        singles.append((state, outs))
    bstate = tst.init_state_batch(s_streams, fcfg, CHUNK, "cpu")
    in_speech = torch.zeros(s_streams, dtype=torch.bool)
    for c in range(n_chunks):
        bstate, bout = tst.process_chunk_batch(
            bstate, torch.from_numpy(sigs[:, c * CHUNK:(c + 1) * CHUNK]), mats,
            fcfg, VadConfig(), CHUNK)
        in_speech |= bout.in_speech.any(dim=1)
        for s in range(s_streams):
            for name, b, o in zip(tst.ChunkOutput._fields, bout, singles[s][1][c]):
                torch.testing.assert_close(b[s], o, rtol=1e-4, atol=1e-4,
                                           msg=f"{name} s={s} c={c}")
    for s in range(s_streams):
        for b, o in zip(bstate, singles[s][0]):
            torch.testing.assert_close(b[s], o, rtol=1e-4, atol=1e-4)
    assert in_speech.all()


def test_two_pass_thresholds_warn_once():
    seen = []

    class Catch(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    logger = tlog.get_logger()
    handler = Catch()
    logger.addHandler(handler)
    tlog._WARNED.discard("stream-two-pass")
    try:
        fcfg, vcfg = FrontendConfig(), VadConfig(threshold_mode="two_pass")
        mats = tfe.make_matrices(fcfg, "cpu")
        state = tst.init_state(fcfg, CHUNK, "cpu")
        for x in _chunks(TWO_WORDS, CHUNK)[:3]:
            state, out = tst.process_chunk(state, torch.from_numpy(x), mats, fcfg,
                                           vcfg, CHUNK)
    finally:
        logger.removeHandler(handler)
    assert len(seen) == 1 and "two_pass" in seen[0]
    assert not tlog.warn_once("stream-two-pass", "again")
    # the causal rule runs whatever the mode says
    ref = tst.init_state(fcfg, CHUNK, "cpu")
    for x in _chunks(TWO_WORDS, CHUNK)[:3]:
        ref, ref_out = tst.process_chunk(ref, torch.from_numpy(x), mats, fcfg,
                                         VadConfig(), CHUNK)
    for a, b in zip(out, ref_out):
        assert torch.equal(a, b)


def test_run_metrics_dump(tmp_path):
    m = tlog.RunMetrics("stream")
    m.record(cfg=FrontendConfig(), frames=np.arange(3), rate=1.5)
    path = tmp_path / "m.json"
    text = m.dump(str(path))
    assert path.read_text().strip() == text
    assert '"run": "stream"' in text and '"frames": [0, 1, 2]' in text
    assert '"hop_len": 160' in text and "elapsed_s" in text


def test_shard_streams_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 15"):
        tst.shard_streams(None, None, None)


# --------------------------------------------------------------- recognizer


def _jax_rec(cfg, n=2):
    rec = JaxRecognizer(cfg)
    for lab in LABELS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(n)])
    return rec


@pytest.fixture(scope="module")
def jax_rec():
    return _jax_rec(JPipelineConfig())


def _port_rec(jrec, cfg, **kw):
    return KnnDtwRecognizer.from_arrays(
        np.stack(jrec._bank_feats), jrec._bank_lens, jrec._bank_label_ids,
        jrec.labels, cfg, device="cpu", **kw)


def _run(stream, sig, flush=True):
    events = []
    for x in _chunks(sig, CHUNK):
        events += stream.feed(x)
    return events + (stream.flush() if flush else [])


ONE_WORD = _stream([("one", 70, 8000)], 3, 5)
CASES = {
    # name: (port kwargs, stream, history_frames)
    "two_words": ({}, TWO_WORDS, None),
    "ltw": ({"matcher": "ltw"}, ONE_WORD, None),
    "cascade": ({"matcher": "cascade"}, ONE_WORD, None),
    "k3": ({"k": 3}, ONE_WORD, None),
    "tiny_history": ({}, _stream([("zero", 80, 8000)], 4, 6), 5),
    # the stream ends inside the word: flush closes it
    "flush": ({}, _stream([("two", 88, 32000)], 3, 7), None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_recognizer_events_match_jax(jax_rec, name):
    kw, sig, history = CASES[name]
    jrec = jax_rec
    jrec.k = kw.get("k", 1)
    jrec.matcher = kw.get("matcher", "dtw")
    try:
        want = _run(JaxStreaming(jrec, CHUNK, history_frames=history), sig)
    finally:
        jrec.k, jrec.matcher = 1, "dtw"
    stream = StreamingRecognizer(_port_rec(jrec, PipelineConfig(), **kw), CHUNK,
                                 history_frames=history)
    got = _run(stream, sig, flush=False)
    tail = stream.flush()
    assert got + tail == want
    if name == "flush":
        assert len(tail) == 1 and tail[0][0] == "two"
    elif name == "tiny_history":
        assert stream.history_frames == 5 and len(stream._frames) <= 5
    else:
        assert [ev[0] for ev in want] == (["zero", "two"] if name == "two_words" else ["one"])


@pytest.mark.parametrize("mode", ["utterance", "causal"])
def test_recognizer_events_match_jax_with_cmn(mode):
    kw = {"cmn": True, "cmn_mode": mode}
    jrec = _jax_rec(JPipelineConfig(frontend=JFrontendConfig(**kw)))
    sig = _stream([("one", 77, 8000)], 3, 5)
    want = _run(JaxStreaming(jrec, CHUNK), sig)
    got = _run(StreamingRecognizer(
        _port_rec(jrec, PipelineConfig(frontend=FrontendConfig(**kw))), CHUNK), sig)
    assert got == want and [ev[0] for ev in got] == ["one"]


def test_recognizer_reset_and_chunk_length(jax_rec):
    stream = StreamingRecognizer(_port_rec(jax_rec, PipelineConfig()), CHUNK)
    first = _run(stream, TWO_WORDS)
    stream.reset()
    assert int(stream.state.n_samples) == 0 and stream._frames == []
    assert _run(stream, TWO_WORDS) == first
    with pytest.raises(ValueError, match="1600"):
        stream.feed(np.zeros(CHUNK - 1, np.float32))


def test_recognizer_rejects_lpcc(jax_rec):
    cfg = PipelineConfig(frontend=FrontendConfig(feature_type="lpcc"))
    rec = KnnDtwRecognizer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="mfcc"):
        StreamingRecognizer(rec, CHUNK)


def test_np_deltas_matches_the_ports_deltas():
    c = np.random.default_rng(4).standard_normal((37, 13)).astype(np.float32)
    want = tfe.deltas(torch.from_numpy(c), 2).numpy()
    np.testing.assert_allclose(tms._np_deltas(c, 2), want, rtol=1e-6, atol=1e-6)


def test_streaming_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tst.init_state(FrontendConfig(), CHUNK).n_samples.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        tst.init_state(FrontendConfig(), CHUNK)
