"""VAD parity: dsp_tpu_torch.ops.vad endpoints are integer-equal to the
JAX package's ``detect_endpoints`` in both threshold modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import FrontendConfig as JFrontendConfig
from dsp_tpu.config import VadConfig as JVadConfig
from dsp_tpu.ops import vad as jvad

from dsp_tpu_torch.config import FrontendConfig, VadConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.ops import vad as tvad

N = 16000


def _inputs():
    rng = np.random.default_rng(11)
    sigs = [synth_word(lab, s, max_samples=N)
            for lab, s in (("one", 0), ("four", 1), ("eight", 2), ("two", 3))]
    sigs.append((0.01 * rng.standard_normal(N)).astype(np.float32))   # pure noise
    sigs.append(synth_word("three", 4, max_samples=N, noise=0.0))     # digital zero lead
    sigs.append(synth_word("five", 5, max_samples=N))                 # short, see lens
    sigs.append(synth_word("six", 6, max_samples=N))
    sigs.append(synth_word("seven", 7, max_samples=N))
    x = np.stack(sigs).astype(np.float32)
    lens = np.full(len(sigs), N, np.int32)
    lens[-3:] = (3000, 450, 0)      # short utterance, one frame, empty
    return x, lens


X, LENS = _inputs()


@pytest.mark.parametrize("mode", ["noise_mult", "two_pass"])
def test_endpoints_integer_equal(mode):
    vc, jvc = VadConfig(threshold_mode=mode), JVadConfig(threshold_mode=mode)
    got = tvad.detect_endpoints(torch.from_numpy(X), FrontendConfig(), vc,
                                torch.from_numpy(LENS))
    want = jax.vmap(lambda x, n: jvad.detect_endpoints(
        x, JFrontendConfig(), jvc, n))(jnp.asarray(X), jnp.asarray(LENS))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    assert bool(got[2][0]) and not bool(got[2][4])   # speech found, noise not


def test_endpoints_without_lengths_equal():
    got = tvad.detect_endpoints(torch.from_numpy(X[:4]))
    want = jax.vmap(lambda x: jvad.detect_endpoints(x))(jnp.asarray(X[:4]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


def test_run_lengths_and_features_match_jax():
    rng = np.random.default_rng(12)
    flags = rng.random((3, 40)) < 0.6
    got_end = tvad._run_ending_at(torch.from_numpy(flags)).numpy()
    got_start = tvad._run_starting_at(torch.from_numpy(flags)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got_end[b], np.asarray(jvad._run_ending_at(
            jnp.asarray(flags[b]))))
        np.testing.assert_array_equal(got_start[b], np.asarray(jvad._run_starting_at(
            jnp.asarray(flags[b]))))
    frames = rng.standard_normal((2, 5, 400)).astype(np.float32)
    np.testing.assert_array_equal(
        tvad.zero_crossing_rate(torch.from_numpy(frames)).numpy(),
        np.asarray(jvad.zero_crossing_rate(jnp.asarray(frames))))
    np.testing.assert_allclose(
        tvad.short_time_energy(torch.from_numpy(frames)).numpy(),
        np.asarray(jvad.short_time_energy(jnp.asarray(frames))), rtol=1e-6)


def test_unknown_threshold_mode_raises():
    with pytest.raises(ValueError, match="threshold_mode"):
        tvad.detect_endpoints(torch.from_numpy(X[:1]),
                              vcfg=VadConfig(threshold_mode="bogus"))
