"""The port's PMC noise adaptation (``dsp_tpu_torch/ops/noise_adapt.py``)
against the JAX package's (``dsp_tpu/ops/noise_adapt.py``), on the CPU,
mirroring ``tests/test_noise_adapt.py:26-91``.

Tolerances, measured here: the pseudo-inverse of the float32 DCT matrix
differs by at most 3.3e-7 between ``torch.linalg.pinv`` and
``jnp.linalg.pinv`` (held at atol 1e-6); PMC-adapted means by 2.1e-6
(held at rtol/atol 1e-4); the noise estimate by 3.8e-6 (held at
rtol/atol 1e-4), with the rejected-frame count equal; noise-adapted
recognizer scores at rtol 1e-4 (the two packages' features differ by up
to 2.1e-4, tests/test_torch_gmm_hmm.py), labels and decisions equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import (FrontendConfig as JFrontendConfig,
                            HmmConfig as JHmmConfig,
                            PipelineConfig as JPipelineConfig,
                            VadConfig as JVadConfig)
from dsp_tpu.models import gmm_hmm as jg
from dsp_tpu.ops import frontend as jfe
from dsp_tpu.ops import noise_adapt as jna
from dsp_tpu_torch import GmmHmmRecognizer
from dsp_tpu_torch.config import FrontendConfig, HmmConfig, PipelineConfig, VadConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops.noise_adapt import (estimate_noise_cepstrum,
                                           pmc_adapt_means, pmc_supported)

CFG = FrontendConfig()
MATS = fe.make_matrices(CFG, "cpu")
JMATS = jfe.make_matrices(JFrontendConfig())


def _noise_ceps(logmel_value):
    """The static cepstrum of a flat log-mel at ``logmel_value``."""
    d = MATS.dct_t.T.numpy()
    return ((np.full(CFG.n_mels, logmel_value) @ d.T)
            * MATS.lifter.numpy()).astype(np.float32)


def test_pinv_matches_jax():
    got = torch.linalg.pinv(MATS.dct_t.T).numpy()
    want = np.asarray(jnp.linalg.pinv(JMATS.dct_t.T))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pmc_silence_noise_is_identity():
    """Noise at the log floor adds nothing: D @ pinv(D) = I on the 13 kept
    coefficients, and exp/log cancel, so means pass through."""
    rng = np.random.default_rng(0)
    means = (0.5 * rng.standard_normal((2, 3, 4, 39))).astype(np.float32)
    noise_c = _noise_ceps(np.log(CFG.log_floor))
    got = pmc_adapt_means(torch.from_numpy(means), torch.from_numpy(noise_c), MATS, CFG)
    np.testing.assert_allclose(got.numpy(), means, atol=1e-4)
    want = jna.pmc_adapt_means(jnp.asarray(means), jnp.asarray(noise_c), JMATS,
                               JFrontendConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gain", [1.0, 0.5])
def test_pmc_deltas_untouched_and_statics_move(gain):
    rng = np.random.default_rng(1)
    means = rng.standard_normal((5, 39)).astype(np.float32)
    noise_c = _noise_ceps(0.0)                      # loud: flat log-mel at 0
    got = pmc_adapt_means(torch.from_numpy(means), torch.from_numpy(noise_c), MATS,
                          CFG, gain=gain).numpy()
    np.testing.assert_array_equal(got[:, 13:], means[:, 13:])
    assert np.max(np.abs(got[:, :13] - means[:, :13])) > 0.1
    want = jna.pmc_adapt_means(jnp.asarray(means), jnp.asarray(noise_c), JMATS,
                               JFrontendConfig(), gain=gain)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_noise_estimate_matches_jax_and_true_noise():
    """Rejected-frame estimate against JAX's on the same noisy words, and
    against the cepstra of noise alone at the same sigma
    (tests/test_noise_adapt.py:55's atol 2: two noise realisations)."""
    rng = np.random.default_rng(2)
    sigma = 0.05
    x = np.stack([synth_word("zero", 0), synth_word("one", 1)])
    x = (x + sigma * rng.standard_normal(x.shape)).astype(np.float32)
    n = np.full(2, x.shape[1], np.int32)
    est, n_rej = estimate_noise_cepstrum(torch.from_numpy(x), torch.from_numpy(n),
                                         MATS, CFG, VadConfig())
    j_est, j_rej = jna.estimate_noise_cepstrum(jnp.asarray(x), jnp.asarray(n), JMATS,
                                               JFrontendConfig(), JVadConfig())
    assert int(n_rej) == int(j_rej) > 50
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), rtol=1e-4, atol=1e-4)
    noise_only = (sigma * rng.standard_normal((2, x.shape[1]))).astype(np.float32)
    true_c = fe.mfcc(torch.from_numpy(noise_only), CFG, MATS).numpy().mean(axis=(0, 1))
    np.testing.assert_allclose(est.numpy(), true_c, atol=2.0)


def test_noise_estimate_fallback_without_rejected_frames():
    """Speech wall to wall: no VAD-rejected frame, so the lowest-energy
    frames are pooled; ragged lengths mask the padded tail."""
    t = np.arange(16000) / 16000.0
    x = np.stack([np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)),
                  np.sin(2 * np.pi * 300 * t)]).astype(np.float32)
    n = np.asarray([16000, 12000], np.int32)
    x[1, 12000:] = 0.0
    est, n_rej = estimate_noise_cepstrum(torch.from_numpy(x), torch.from_numpy(n),
                                         MATS, CFG, VadConfig())
    j_est, j_rej = jna.estimate_noise_cepstrum(jnp.asarray(x), jnp.asarray(n), JMATS,
                                               JFrontendConfig(), JVadConfig())
    assert int(n_rej) == int(j_rej) == 0
    assert np.isfinite(est.numpy()).all()
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), rtol=1e-4, atol=1e-4)


def test_pmc_supported_gates():
    assert pmc_supported(FrontendConfig()) is None
    assert "cmn" in pmc_supported(FrontendConfig(cmn=True))
    assert "energy" in pmc_supported(FrontendConfig(use_energy=True))
    assert "mfcc" in pmc_supported(FrontendConfig(feature_type="lpcc"))


def test_recognizer_rejects_unsupported_frontend():
    rec = GmmHmmRecognizer(PipelineConfig(frontend=FrontendConfig(cmn=True)),
                           device="cpu", noise_adapt=True)
    rec.labels = ["zero"]
    rec.params = object()   # anything non-None
    with pytest.raises(ValueError, match="noise_adapt unavailable"):
        rec.classify_batch([synth_word("zero", 0)])


def test_noise_adapted_recognizer_matches_jax():
    """The port's fit, handed to the JAX recognizer as arrays: with
    noise_adapt on, both adapt the word models and the UBM to the noisy
    batch and agree on scores, labels and rejection decisions."""
    labels = ["zero", "one", "two"]
    hmm = dict(n_states=4, n_mix=2, n_iter=5)
    port = GmmHmmRecognizer(PipelineConfig(), HmmConfig(**hmm), device="cpu")
    port.fit({lab: [synth_word(lab, i) for i in range(3)] for lab in labels})
    jrec = jg.GmmHmmRecognizer(JPipelineConfig(), JHmmConfig(**hmm), noise_adapt=True)
    jrec.labels = list(port.labels)
    jrec.params = jg.HmmParams(*(jnp.asarray(a.numpy()) for a in port.params))
    jrec.ubm = tuple(jnp.asarray(a.numpy()) for a in port.ubm)
    port.noise_adapt = True
    rng = np.random.default_rng(3)
    noisy = [(synth_word(lab, 60 + i) + 0.05 * rng.standard_normal(32000)).astype(np.float32)
             for lab in labels for i in range(2)]
    got, got_s = port.classify_batch(noisy, return_scores=True)
    want, want_s = jrec.classify_batch(noisy, return_scores=True)
    assert got == want
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=1e-4)
    port.noise_adapt = False
    _, plain_s = port.classify_batch(noisy, return_scores=True)
    assert np.abs(plain_s - got_s).max() > 1.0          # adaptation moved the scores
    port.noise_adapt = True
    thr = float(np.median(port._utterance_llr(port.extract(noisy), got_s,
                                              port._scoring_models(noisy)[1])))
    assert (port.classify_batch(noisy, reject=thr)
            == [w if w in labels else "<reject>" for w in jrec.classify_batch(noisy, reject=thr)])
