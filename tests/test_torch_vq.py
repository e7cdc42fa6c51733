"""The VQ-codebook recognizer in the port against the JAX package, on the
CPU.

k-means on the same frames: codebooks at atol 1e-5 (measured 0: the same
strided init, first-of-ties argmin and fp32 centroid sums).  Recognizers
fitted by each package on their own features: codebooks at atol 1e-3
(measured ~2e-5; the features differ by ~1e-4), distortions at rtol 1e-4
and labels equal.  Checkpoints cross-load in both directions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.config import VqConfig as JVqConfig
from dsp_tpu.models import vq as jvq

from dsp_tpu_torch import VqRecognizer as TopLevelVq
from dsp_tpu_torch.config import FrontendConfig, PipelineConfig, VqConfig
from dsp_tpu_torch.io import synth_connected, synth_word
from dsp_tpu_torch.models import VqRecognizer as ModelsVq
from dsp_tpu_torch.models import vq as tvq

LABELS = ["zero", "one", "two"]
CORPUS = {lab: [synth_word(lab, i) for i in range(3)] for lab in LABELS}
TEST = {lab: [synth_word(lab, 30 + i) for i in range(2)] for lab in LABELS}
QUERIES = [x for xs in TEST.values() for x in xs]
VQ = dict(n_codes=8, n_iter=4)


def _frames(seed=0, w=3, n=50, f=6):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((w, n, f)).astype(np.float32)
    mask = np.ones((w, n), np.float32)
    mask[1, 30:] = 0.0
    mask[2, 10:] = 0.0
    return frames, mask


@pytest.mark.parametrize("n_iter", [0, 1, 6])
def test_kmeans_fit_matches_jax(n_iter):
    frames, mask = _frames()
    got = tvq.kmeans_fit(torch.from_numpy(frames), torch.from_numpy(mask), 8, n_iter)
    want = jvq.kmeans_fit(jnp.asarray(frames), jnp.asarray(mask), 8, n_iter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_lloyd_step_assignments_and_empty_clusters():
    frames, mask = _frames(seed=1)
    f, m = torch.from_numpy(frames), torch.from_numpy(mask)
    # word 2 has 10 valid frames for 16 codes: the strided init repeats
    # frames, ties go to the first code, and the empty codes keep theirs
    init = tvq.kmeans_init(f, m, 16)
    step = tvq.lloyd_step(f, m, init)
    assign = torch.argmin(tvq._sq_dists(f, init), dim=-1)[2, :10]
    empty = torch.ones(16, dtype=torch.bool)
    empty[assign] = False
    assert empty.any()
    assert torch.equal(step[2, empty], init[2, empty])
    np.testing.assert_allclose(step.numpy(), np.asarray(jvq.kmeans_fit(
        jnp.asarray(frames), jnp.asarray(mask), 16, 1)), rtol=0, atol=1e-5)


def test_vq_distortion_matches_jax_and_masks_padding():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 30, 6)).astype(np.float32)
    cb = rng.standard_normal((4, 8, 6)).astype(np.float32)
    lens = np.asarray([30, 12], np.int32)
    for squared in (True, False):
        got = tvq.vq_distortion(torch.from_numpy(feats), torch.from_numpy(lens),
                                torch.from_numpy(cb), squared).numpy()
        want = np.asarray(jvq.vq_distortion(jnp.asarray(feats), jnp.asarray(lens),
                                            jnp.asarray(cb), squared))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        feats2 = feats.copy()
        feats2[1, 12:] = 1e3
        np.testing.assert_array_equal(tvq.vq_distortion(
            torch.from_numpy(feats2), torch.from_numpy(lens), torch.from_numpy(cb),
            squared).numpy(), got)


@pytest.fixture(scope="module")
def fitted():
    """(JAX, port) VQ recognizers, each fitted on its own features."""
    jrec = jvq.VqRecognizer(JPipelineConfig(), JVqConfig(**VQ))
    jrec.fit(CORPUS)
    rec = tvq.VqRecognizer(PipelineConfig(), VqConfig(**VQ), device="cpu")
    rec.fit(CORPUS)
    return jrec, rec


def test_vq_recognizer_matches_jax(fitted):
    jrec, rec = fitted
    assert rec.labels == jrec.labels
    np.testing.assert_allclose(rec.codebooks, jrec.codebooks, rtol=0, atol=1e-3)
    labels, d = rec.classify_batch(QUERIES, return_distances=True)
    jlabels, jd = jrec.classify_batch(QUERIES, return_distances=True)
    assert labels == jlabels
    np.testing.assert_allclose(d, jd, rtol=1e-4)
    assert rec.recognize(QUERIES[0]) == jlabels[0]
    assert rec.evaluate(TEST) == jrec.evaluate(TEST)
    got, want = rec.classify_nbest(QUERIES, n=2), jrec.classify_nbest(QUERIES, n=2)
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    np.testing.assert_allclose([[h[1:] for h in row] for row in got],
                               [[h[1:] for h in row] for row in want], rtol=1e-3)
    assert rec.classify_nbest([]) == []


def test_classify_batch_chunks_like_one_batch(fitted):
    _, rec = fitted
    labels, d = rec.classify_batch(QUERIES, return_distances=True)
    got, gd = rec.classify_batch(QUERIES, return_distances=True, chunk=4)
    assert got == labels
    np.testing.assert_allclose(gd, d, rtol=1e-6)


def test_classify_connected_matches_jax(fitted):
    jrec, rec = fitted
    clips = [synth_connected(w, s) for w, s in (
        (["two", "zero", "one"], 5), (["one"], 6), (["zero", "two"], 7))]
    assert rec.classify_connected(clips, 4) == jrec.classify_connected(clips, 4)


def test_checkpoints_cross_load(fitted, tmp_path):
    jrec, rec = fitted
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jrec.save(jpath)
    rec.save(tpath)
    from_jax = tvq.VqRecognizer.load(jpath, PipelineConfig(), device="cpu")
    assert from_jax.vq == VqConfig(**VQ)
    np.testing.assert_array_equal(from_jax.codebooks, jrec.codebooks)
    assert from_jax.classify_batch(QUERIES) == jrec.classify_batch(QUERIES)
    from_port = jvq.VqRecognizer.load(tpath, JPipelineConfig())
    np.testing.assert_array_equal(from_port.codebooks, rec.codebooks)
    assert from_port.classify_batch(QUERIES) == rec.classify_batch(QUERIES)
    other = dataclasses.replace(PipelineConfig(), frontend=FrontendConfig(n_mfcc=20))
    with pytest.raises(ValueError, match="front-end"):
        tvq.VqRecognizer.load(jpath, other, device="cpu")


def test_recognizer_surface():
    assert TopLevelVq is ModelsVq is tvq.VqRecognizer
    assert tvq.VqRecognizer().device.type == "cuda"
    with pytest.raises(TypeError, match="DeviceMesh"):
        tvq.VqRecognizer(mesh=object())
    with pytest.raises(ValueError, match="no enrollment data"):
        tvq.VqRecognizer(device="cpu").fit()
