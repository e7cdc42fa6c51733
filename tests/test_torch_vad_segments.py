"""The port's multi-segment VAD (``dsp_tpu_torch/ops/vad.py:detect_segments``,
``detect_segments_frames``) against the JAX package's and the golden loop
spec (``dsp_tpu/golden/vad.py``): starts, ends and segment counts
integer-equal, batched over recordings, in both threshold modes, with
more utterances than ``max_segments``, padded tails and length 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import FrontendConfig as JFrontendConfig
from dsp_tpu.config import VadConfig as JVadConfig
from dsp_tpu.golden import vad as gvad
from dsp_tpu.ops import vad as jvad

from dsp_tpu_torch.config import FrontendConfig, VadConfig
from dsp_tpu_torch.io import DIGITS, synth_connected
from dsp_tpu_torch.ops import vad as tvad

MODES = ["noise_mult", "two_pass"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the DP loops are thousands of small ops, which
    crawl when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recordings():
    """Connected-digit recordings of 1-7 words (7 > the default
    max_segments of the tests below) zero-padded into one batch, with
    true lengths; the last one cut to nothing."""
    rng = np.random.default_rng(5)
    sigs = [synth_connected([DIGITS[int(rng.integers(10))]
                             for _ in range(n)], 40 + i)
            for i, n in enumerate([1, 3, 7, 2, 5, 4])]
    x = np.zeros((len(sigs), max(len(s) for s in sigs)), np.float32)
    for i, s in enumerate(sigs):
        x[i, :len(s)] = s
    lens = np.asarray([len(s) for s in sigs], np.int32)
    lens[-1] = 0
    return sigs, x, lens


SIGS, X, LENS = _recordings()


def _ints(t):
    return np.asarray(t).astype(np.int64)


def _rows(starts, ends, n_segs, b):
    return [(int(starts[b, j]), int(ends[b, j])) for j in range(int(n_segs[b]))]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("max_segments", [3, 8])
def test_segments_integer_equal_jax(mode, max_segments):
    vc, jvc = VadConfig(threshold_mode=mode), JVadConfig(threshold_mode=mode)
    got = tvad.detect_segments(torch.from_numpy(X), FrontendConfig(), vc,
                               torch.from_numpy(LENS), max_segments)
    want = jax.vmap(lambda x, n: jvad.detect_segments(
        x, JFrontendConfig(), jvc, n, max_segments))(jnp.asarray(X),
                                                      jnp.asarray(LENS))
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_array_equal(g.numpy(), _ints(w))
    assert int(got[2][2]) == min(7, max_segments)    # the 7-word recording
    assert int(got[2][-1]) == 0                      # length 0: no segment


@pytest.mark.parametrize("mode", MODES)
def test_segments_equal_the_golden_spec(mode):
    vc, jvc = VadConfig(threshold_mode=mode), JVadConfig(threshold_mode=mode)
    starts, ends, n_segs = tvad.detect_segments(
        torch.from_numpy(X), FrontendConfig(), vc, torch.from_numpy(LENS), 8)
    for b, sig in enumerate(SIGS[:-1]):
        want = gvad.detect_segments(sig, JFrontendConfig(), jvc)
        assert _rows(starts, ends, n_segs, b) == want[:8], b


@pytest.mark.parametrize("mode", MODES)
def test_random_energy_vectors_equal_jax(mode):
    """Seeded random e / z [B, T]: a quiet head, then bursts of 2-15 loud
    frames between gaps of 4-40, ZCR spikes; random valid lengths (0 and
    T among them); a small max_segments."""
    rng = np.random.default_rng(17)
    b, t = 24, 240
    e = rng.exponential(1.0, (b, t))
    z = rng.uniform(0.0, 10.0, (b, t))
    for row in range(b):
        at = 10
        while at < t:
            at += int(rng.integers(4, 41))
            n = int(rng.integers(2, 16))
            e[row, at:at + n] *= rng.uniform(3.0, 40.0)
        spikes = rng.random(t) < 0.05
        z[row, spikes] += 40.0
    lens = rng.integers(0, t + 1, b)
    lens[:2] = (0, t)
    vc, jvc = VadConfig(threshold_mode=mode), JVadConfig(threshold_mode=mode)
    got = tvad.detect_segments_frames(torch.from_numpy(e), torch.from_numpy(z),
                                      torch.from_numpy(lens), vc, 3)
    want = jax.vmap(lambda ee, zz, n: jvad.detect_segments_frames(
        ee, zz, n, jvc, 3))(jnp.asarray(e), jnp.asarray(z), jnp.asarray(lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _ints(w))
    assert int(got[2].max()) == 3 and int(got[2][0]) == 0   # some truncated


def test_every_small_frame_pattern_equals_the_golden_spec():
    """Every silent / audible-only / high pattern over 8 frames (3^8),
    with tight thresholds so core runs, audible extension, gap merging,
    hangover and the short-segment drop all trigger
    (tests/test_vad_segments.py:TestExhaustive), in one batch."""
    kw = dict(n_init=2, min_speech_frames=2, max_silence_frames=3,
              hangover_frames=1, min_utterance_frames=2)
    vc, jvc = VadConfig(**kw), JVadConfig(**kw)
    t = 8
    levels = np.array([0.5, 2.0, 8.0])          # vs th=4.0, tl=1.5 (noise=1)
    pats = np.stack(np.meshgrid(*([np.arange(3)] * t), indexing="ij"),
                    -1).reshape(-1, t)
    e = np.concatenate([np.full((len(pats), kw["n_init"]), 1.0), levels[pats]],
                       axis=1)
    z = np.zeros_like(e)
    starts, ends, n_segs = tvad.detect_segments_frames(
        torch.from_numpy(e), torch.from_numpy(z), None, vc, 4)
    for i in range(len(pats)):
        want = gvad.detect_segments_frames(e[i], z[i], jvc)
        assert _rows(starts, ends, n_segs, i) == want[:4], pats[i].tolist()


def test_padding_and_truncation():
    sig = synth_connected(["two", "eight"], 3)
    padded = np.concatenate([sig, np.zeros(24000, np.float32)])
    x = torch.from_numpy(np.stack([padded, padded]))
    n = torch.tensor([len(sig), len(padded)])
    starts, ends, n_segs = tvad.detect_segments(x, length_samples=n)
    plain = tvad.detect_segments(torch.from_numpy(sig)[None])
    assert _rows(starts, ends, n_segs, 0) == _rows(*plain, 0)
    assert _rows(starts, ends, n_segs, 1) == _rows(*plain, 0)
    five = torch.from_numpy(synth_connected(
        ["one", "two", "three", "four", "five"], 9))[None]
    full = _rows(*tvad.detect_segments(five, max_segments=8), 0)
    assert len(full) == 5
    assert _rows(*tvad.detect_segments(five, max_segments=3), 0) == full[:3]
