"""Front-end parity: dsp_tpu_torch.ops.frontend against the JAX ops.

Inputs are made once with numpy and fed to both packages.  Tolerance
rtol/atol 1e-3, the repo's front-end tolerance (tests/test_pallas_mfcc.py):
float32 GEMMs in another summation order, amplified by the log.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import FrontendConfig as JFrontendConfig
from dsp_tpu.kernels.mfcc_pallas import mfcc_frames_pallas
from dsp_tpu.ops import frontend as jfe

from dsp_tpu_torch.config import FrontendConfig, PipelineConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import mfcc_fused as kmf
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch import pipeline as tpl

TOL = dict(rtol=1e-3, atol=1e-3)
SIGS = np.stack([synth_word(lab, s, max_samples=8000)
                 for lab, s in (("one", 1), ("six", 2), ("nine", 3))])


def _both(**kw):
    return FrontendConfig(**kw), JFrontendConfig(**kw)


@pytest.mark.parametrize("kw", [{}, {"use_energy": True},
                                {"denoise": "spectral_subtraction"}])
def test_mfcc_matches_jax(kw):
    tc, jc = _both(**kw)
    got = fe.mfcc(torch.from_numpy(SIGS), tc).numpy()
    want = np.asarray(jfe.mfcc(jnp.asarray(SIGS), jc))
    assert got.shape == want.shape == (3, 1 + (8000 - 400) // 160, 13)
    np.testing.assert_allclose(got, want, **TOL)


def test_preemphasis_and_frame_match_jax():
    x = torch.from_numpy(SIGS)
    y = fe.preemphasis(x, 0.97)
    np.testing.assert_allclose(y.numpy(), np.asarray(jfe.preemphasis(jnp.asarray(SIGS))),
                               rtol=1e-6, atol=1e-7)
    fr = fe.frame(y, 400, 160)
    np.testing.assert_array_equal(fr.numpy(), np.asarray(jfe.frame(jnp.asarray(y.numpy()),
                                                                  400, 160)))
    with pytest.raises(ValueError):
        fe.frame(x[:, :100], 400, 160)


def test_spectral_subtract_matches_jax():
    rng = np.random.default_rng(4)
    p = rng.gamma(2.0, size=(2, 40, 257)).astype(np.float32)
    p[0, :5] = 0.0                      # digital-zero frames are excluded
    p[1, 10:13] = p[1, 20]              # ties keep the stable order
    tc, jc = _both(denoise="spectral_subtraction")
    got = fe.spectral_subtract(torch.from_numpy(p), tc).numpy()
    want = np.asarray(jfe.spectral_subtract(jnp.asarray(p), jc))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_deltas_and_masked_deltas_match_jax():
    rng = np.random.default_rng(5)
    c = rng.standard_normal((3, 30, 13)).astype(np.float32)
    lens = np.array([30, 12, 1], np.int32)
    np.testing.assert_allclose(fe.deltas(torch.from_numpy(c)).numpy(),
                               np.asarray(jfe.deltas(jnp.asarray(c))), **TOL)
    got = fe.masked_deltas(torch.from_numpy(c), torch.from_numpy(lens)).numpy()
    for b in range(3):
        want = np.asarray(jfe.masked_deltas(jnp.asarray(c[b]), jnp.asarray(lens[b])))
        np.testing.assert_allclose(got[b], want, **TOL)
    tc, jc = _both()
    got = fe.add_deltas(torch.from_numpy(c), tc, torch.from_numpy(lens)).numpy()
    assert got.shape == (3, 30, 39)
    for b in range(3):
        want = np.asarray(jfe.add_deltas(jnp.asarray(c[b]), jc, jnp.asarray(lens[b])))
        np.testing.assert_allclose(got[b], want, **TOL)


def test_causal_cmn_matches_jax():
    rng = np.random.default_rng(6)
    c = (rng.standard_normal((2, 50, 13)) + 3.0).astype(np.float32)
    got = fe.causal_cmn(torch.from_numpy(c), 0.995).numpy()
    want = np.asarray(jfe.causal_cmn(jnp.asarray(c), 0.995))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_energy", [False, True])
def test_kernel_plain_version_matches_pallas_interpret(use_energy):
    """The plain version of the fused MFCC kernel against the TPU kernel
    run in interpret mode, on random frames and on real speech frames."""
    tc, jc = _both(use_energy=use_energy)
    rng = np.random.default_rng(7)
    y = fe.preemphasis(torch.from_numpy(SIGS[:1]), tc.preemphasis)
    speech = fe.frame(y, 400, 160).reshape(-1, 400).numpy()
    frames = np.concatenate([rng.standard_normal((40, 400)).astype(np.float32),
                             speech]).astype(np.float32)
    got = kmf.mfcc_frames_plain(torch.from_numpy(frames), tc).numpy()
    want = np.asarray(mfcc_frames_pallas(jnp.asarray(frames), jc, interpret=True))
    assert got.shape == want.shape == (frames.shape[0], 13)
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_takes_cpu_tensors_to_plain_version():
    cfg = FrontendConfig()
    frames = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (17, 400)).astype(np.float32))
    before = _build.LAUNCHES["mfcc_fused"]
    got = kmf.mfcc_frames_fused(frames, cfg)
    assert _build.LAUNCHES["mfcc_fused"] == before   # no kernel on the CPU
    torch.testing.assert_close(got, kmf.mfcc_frames_plain(frames, cfg),
                               rtol=0, atol=0)
    sig = torch.from_numpy(SIGS)
    np.testing.assert_array_equal(kmf.mfcc_fused(sig, cfg).numpy(),
                                  fe.mfcc(sig, cfg).numpy())


def test_wrapper_guards():
    frames = torch.zeros((4, 400))
    with pytest.raises(ValueError, match="denoise"):
        kmf.mfcc_frames_fused(frames, FrontendConfig(denoise="spectral_subtraction"))
    with pytest.raises(ValueError, match="frame_len"):
        kmf.mfcc_frames_fused(torch.zeros((4, 256)), FrontendConfig())
    with pytest.raises(ValueError):
        kmf.mfcc_frames_fused(torch.zeros((2, 4, 400)), FrontendConfig())


@pytest.mark.parametrize("kw", [{}, {"use_energy": True}, {"n_fft": 256},
                                {"denoise": "spectral_subtraction"}])
def test_mfcc_use_fft_matches_jax(kw):
    """The exact-rFFT parity path against JAX's and against the DFT-GEMM
    chain, at the front-end tolerance (n_fft 256 < 400: both FFTs cut the
    frame to n_fft)."""
    tc, jc = _both(**kw)
    got = fe.mfcc(torch.from_numpy(SIGS), tc, use_fft=True).numpy()
    want = np.asarray(jfe.mfcc(jnp.asarray(SIGS), jc, use_fft=True))
    np.testing.assert_allclose(got, want, **TOL)
    if tc.n_fft >= tc.frame_len:
        np.testing.assert_allclose(got, fe.mfcc(torch.from_numpy(SIGS), tc).numpy(),
                                   **TOL)
    wframes = fe.frame(torch.from_numpy(SIGS), 400, 160) * fe.make_matrices(tc, "cpu").window
    np.testing.assert_allclose(
        fe.power_spectrum_fft(wframes, tc.n_fft).numpy(),
        np.asarray(jfe.power_spectrum_fft(jnp.asarray(wframes.numpy()), tc.n_fft)),
        rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("feature_type", ["mfcc", "lpcc"])
def test_extract_mfcc_matches_jax(feature_type):
    import dsp_tpu
    import dsp_tpu_torch
    from dsp_tpu.config import PipelineConfig as JPipelineConfig

    x = synth_word("four", 3)
    got = dsp_tpu_torch.extract_mfcc(
        x, PipelineConfig(frontend=FrontendConfig(feature_type=feature_type)),
        device="cpu")
    want = dsp_tpu.extract_mfcc(
        x, JPipelineConfig(frontend=JFrontendConfig(feature_type=feature_type)))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_exports_cover_the_jax_package():
    import dsp_tpu
    import dsp_tpu.ops
    import dsp_tpu_torch
    import dsp_tpu_torch.ops

    assert set(dsp_tpu_torch.ops.__all__) == set(dsp_tpu.ops.__all__)
    assert set(dsp_tpu.__all__) - {"__version__"} <= set(dsp_tpu_torch.__all__)
    for mod in (dsp_tpu_torch, dsp_tpu_torch.ops):
        assert all(hasattr(mod, name) for name in mod.__all__)


def test_pipeline_pallas_impl_on_cpu_equals_xla():
    cfg = PipelineConfig()
    cfg_p = dataclasses.replace(cfg, frontend=FrontendConfig(impl="pallas"))
    x = torch.from_numpy(np.stack([synth_word("one", 1), synth_word("two", 2)]))
    n = torch.full((2,), 32000, dtype=torch.int32)
    a = tpl.extract_features(x, n, cfg)
    b = tpl.extract_features(x, n, cfg_p)
    torch.testing.assert_close(a.feats, b.feats, rtol=0, atol=0)
    torch.testing.assert_close(a.length, b.length)
