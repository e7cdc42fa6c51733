"""LPC / LPCC in the port against the JAX package, on the CPU, with
``dsp_tpu/golden/lpc.py`` (float64 loops) as the second check.

Tolerances: Levinson-Durbin against JAX's on the same float32 lags at
rtol 5e-3 / atol 1e-4, JAX's own rule against the golden oracle
(measured 3.6e-5 absolute on smooth AR frames, whose order-12 systems
are near-singular: the masked sums round in another order and the
recursion amplifies it); the cepstral recursion at rtol 1e-4 / atol
1e-5; LPCC and LPCC features against JAX's at rtol/atol 1e-3, the MFCC
rule (measured ~1.3e-4 absolute, for the same reason); against the
golden float64 oracle at rtol/atol 2e-2, JAX's own rule
(tests/test_lpc.py).
VAD endpoints and labels are held equal.  The recognizers' banks and
models are made by the JAX package and loaded through their ``.npz``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import pipeline as jpl
from dsp_tpu.config import FrontendConfig as JFrontendConfig
from dsp_tpu.config import HmmConfig as JHmmConfig
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.golden import lpc as glpc
from dsp_tpu.io.dataset import make_corpus
from dsp_tpu.models.gmm_hmm import GmmHmmRecognizer as JGmmHmmRecognizer
from dsp_tpu.models.knn_dtw import KnnDtwRecognizer as JKnnDtwRecognizer
from dsp_tpu.ops import frontend as jfe
from dsp_tpu.ops import lpc as jlpc

from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import FrontendConfig, HmmConfig, PipelineConfig
from dsp_tpu_torch.io import synth_connected, synth_word
from dsp_tpu_torch.kernels import mfcc_fused as kmf
from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
from dsp_tpu_torch.ops import lpc as tlpc

TOL = dict(rtol=1e-3, atol=1e-3)
GOLDEN_TOL = dict(rtol=2e-2, atol=2e-2)
LABELS = ["zero", "one", "two"]
LPCC = FrontendConfig(feature_type="lpcc")
JLPCC = JFrontendConfig(feature_type="lpcc")
SIGS = [synth_word(lab, s) for lab, s in (("one", 1), ("six", 2), ("nine", 3))]
QUERIES = [synth_word(lab, 20 + i) for i, lab in enumerate(LABELS * 3)]
CONNECTED = [synth_connected(w, s) for w, s in (
    (["two", "zero", "one"], 5), (["one"], 6), (["zero", "two"], 7))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the level-building and HMM loops are
    thousands of small ops, which crawl when parallel test workers
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ar_frames(seed=1, t=7, length=400):
    """Smooth (AR-like) frames, as tests/test_lpc.py makes them."""
    rng = np.random.default_rng(seed)
    frames = np.cumsum(rng.standard_normal((t, length)), axis=1)
    return (frames - frames.mean(axis=1, keepdims=True)).astype(np.float32)


def _padded(signals, n):
    x = np.zeros((len(signals), n), np.float32)
    for i, s in enumerate(signals):
        x[i, :len(s)] = s[:n]
    return x, np.asarray([min(len(s), n) for s in signals], np.int32)


def test_autocorrelation_and_levinson_match_jax_and_golden():
    frames = _ar_frames()
    r = tlpc.autocorrelation(torch.from_numpy(frames), 12)
    np.testing.assert_allclose(r.numpy(), np.asarray(jlpc.autocorrelation(
        jnp.asarray(frames), 12)), rtol=1e-5)
    r_np = r.numpy()
    a, e = tlpc.levinson_durbin(torch.from_numpy(r_np), 12)
    ja, je = jlpc.levinson_durbin(jnp.asarray(r_np), 12)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=5e-3)
    ga, ge = glpc.levinson_durbin(r_np.astype(np.float64), 12)
    np.testing.assert_allclose(a.numpy(), ga, rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(e.numpy(), ge, rtol=5e-3)


def test_levinson_floors_silent_frames():
    # an all-zero frame: e0 floored at 1e-10, every coefficient 0
    r = torch.zeros((2, 13))
    r[1] = torch.from_numpy(tlpc.autocorrelation(torch.from_numpy(_ar_frames(t=1)),
                                                 12).numpy()[0])
    a, e = tlpc.levinson_durbin(r, 12)
    ja, je = jlpc.levinson_durbin(jnp.asarray(r.numpy()), 12)
    assert float(e[0]) == pytest.approx(1e-10) and not a[0].any()
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=5e-3)


@pytest.mark.parametrize("n_ceps", [13, 8])
def test_lpcc_from_lpc_matches_jax_and_golden(n_ceps):
    rng = np.random.default_rng(2)
    a = (0.3 * rng.standard_normal((6, 12))).astype(np.float32)
    gain = np.abs(rng.standard_normal(6)).astype(np.float32)
    gain[0] = 0.0                                    # the ln floor
    got = tlpc.lpcc_from_lpc(torch.from_numpy(a), torch.from_numpy(gain), n_ceps).numpy()
    want = np.asarray(jlpc.lpcc_from_lpc(jnp.asarray(a), jnp.asarray(gain), n_ceps))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, glpc.lpcc_from_lpc(a.astype(np.float64), gain,
                                                       n_ceps), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lpc_order", [12, 16])
def test_lpcc_matches_jax_and_golden(lpc_order):
    cfg = dataclasses.replace(LPCC, lpc_order=lpc_order)
    jcfg = dataclasses.replace(JLPCC, lpc_order=lpc_order)
    x = np.stack([s[:8000] for s in SIGS])
    got = tlpc.lpcc(torch.from_numpy(x), cfg).numpy()
    assert got.shape == (3, 48, 13)
    np.testing.assert_allclose(got, np.asarray(jlpc.lpcc(jnp.asarray(x), jcfg)), **TOL)
    for i in range(3):
        np.testing.assert_allclose(got[i], glpc.lpcc(x[i], jcfg), **GOLDEN_TOL)


def test_lpcc_refuses_denoise():
    cfg = dataclasses.replace(LPCC, denoise="spectral_subtraction")
    with pytest.raises(ValueError, match="denoise"):
        tlpc.lpcc(torch.zeros((1, 800)), cfg)


@pytest.mark.parametrize("use_vad", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_extract_features_lpcc_matches_jax(impl, use_vad, monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("LPCC must not reach the fused MFCC kernel")

    # feature_type is read before impl: impl="pallas" computes plain LPCC
    monkeypatch.setattr(kmf, "mfcc_fused", no_kernel)
    kw = dict(feature_type="lpcc", impl=impl)
    x, n = _padded(SIGS, 32000)
    got = tpl.extract_features(torch.from_numpy(x), torch.from_numpy(n),
                               PipelineConfig(use_vad=use_vad,
                                              frontend=FrontendConfig(**kw)))
    jcfg = JPipelineConfig(use_vad=use_vad, frontend=JFrontendConfig(**kw))
    want = jpl.extract_features(jnp.asarray(x), jnp.asarray(n),
                                jfe.make_matrices(jcfg.frontend), jcfg)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats), **TOL)


@pytest.mark.parametrize("use_vad", [True, False])
def test_extract_recording_features_lpcc_matches_jax(use_vad):
    x, n = _padded(CONNECTED, 96000)
    got = tpl.extract_recording_features(
        torch.from_numpy(x), torch.from_numpy(n),
        PipelineConfig(use_vad=use_vad, frontend=LPCC), 598)
    jcfg = JPipelineConfig(use_vad=use_vad, frontend=JLPCC)
    want = jpl.extract_recording_features(jnp.asarray(x), jnp.asarray(n),
                                          jfe.make_matrices(JLPCC), jcfg, 598)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats), **TOL)


def test_extract_segments_features_lpcc_matches_jax():
    x, n = _padded(CONNECTED, 96000)
    segs, starts, ends, n_segs = tpl.extract_segments_features(
        torch.from_numpy(x), torch.from_numpy(n), PipelineConfig(frontend=LPCC), 4)
    jcfg = JPipelineConfig(frontend=JLPCC)
    want = jpl.extract_segments_features(jnp.asarray(x), jnp.asarray(n),
                                         jfe.make_matrices(JLPCC), jcfg, 4)
    for g, w in zip((starts, ends, n_segs), want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    np.testing.assert_array_equal(segs.length.numpy(), np.asarray(want[0].length))
    np.testing.assert_allclose(segs.feats.numpy(), np.asarray(want[0].feats), **TOL)


@pytest.fixture(scope="module")
def lpcc_recs(tmp_path_factory):
    """(JAX, port) LPCC kNN recognizers over one bank enrolled by JAX."""
    jcfg = JPipelineConfig(frontend=JLPCC)
    jrec = JKnnDtwRecognizer(jcfg)
    for lab in LABELS:
        jrec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    path = str(tmp_path_factory.mktemp("bank") / "bank.npz")
    jrec.save(path)
    return jrec, KnnDtwRecognizer.load(path, PipelineConfig(frontend=LPCC), device="cpu")


def test_knn_lpcc_labels_match_jax(lpcc_recs):
    jrec, rec = lpcc_recs
    labels, d = rec.classify_batch(QUERIES, return_distances=True)
    jlabels, jd = jrec.classify_batch(QUERIES, return_distances=True)
    assert labels == jlabels
    np.testing.assert_allclose(d, jd, rtol=2e-3)
    # a port-enrolled LPCC bank holds the same templates
    own = KnnDtwRecognizer(PipelineConfig(frontend=LPCC), device="cpu")
    for lab in LABELS:
        own.enroll(lab, [synth_word(lab, i) for i in range(2)])
    assert own.classify_batch(QUERIES) == jlabels


@pytest.mark.parametrize("method", ["vad", "level"])
def test_knn_lpcc_classify_connected_matches_jax(lpcc_recs, method):
    jrec, rec = lpcc_recs
    assert (rec.classify_connected(CONNECTED, 4, method=method)
            == jrec.classify_connected(CONNECTED, 4, method=method))


@pytest.fixture(scope="module")
def lpcc_hmms(tmp_path_factory):
    """(JAX, port) LPCC GMM-HMMs on the JAX package's fitted parameters."""
    hcfg = dict(n_states=4, n_mix=2, n_iter=3)
    jrec = JGmmHmmRecognizer(JPipelineConfig(frontend=JLPCC), JHmmConfig(**hcfg))
    jrec.fit(make_corpus(LABELS, n_per_word=3, seed=0))
    path = str(tmp_path_factory.mktemp("hmm") / "hmm.npz")
    jrec.save(path)
    return jrec, GmmHmmRecognizer.load(path, PipelineConfig(frontend=LPCC),
                                       HmmConfig(**hcfg), device="cpu")


def test_gmm_hmm_lpcc_labels_match_jax(lpcc_hmms):
    jrec, rec = lpcc_hmms
    assert rec.classify_batch(QUERIES) == jrec.classify_batch(QUERIES)
    assert (rec.classify_connected(CONNECTED, 4)
            == jrec.classify_connected(CONNECTED, 4))
