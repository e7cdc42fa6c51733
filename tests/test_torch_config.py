"""The port's copies stay equal to the JAX package's originals.

``dsp_tpu_torch`` copies the config dataclasses, the window plan, the
front-end constant formulas and the synthetic-word generator rather than
importing them, because importing anything under ``dsp_tpu`` loads jax
(``dsp_tpu/__init__.py``).  These tests hold the copies equal.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dsp_tpu.config as jcfg
from dsp_tpu.io import dataset as jax_dataset
from dsp_tpu.io.dataset import synth_word as jax_synth_word
from dsp_tpu.ops.frontend import _matrices_np
from dsp_tpu.window_plan import plan_window as jax_plan_window

import dsp_tpu_torch.config as tcfg
from dsp_tpu_torch.io import synth_connected, synth_spotting_stream, synth_word
from dsp_tpu_torch.ops.frontend import make_matrices, matrices_np
from dsp_tpu_torch.window_plan import plan_window

CLASSES = ["FrontendConfig", "VadConfig", "DtwConfig", "VqConfig",
           "HmmConfig", "PipelineConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_equal(name):
    ours, theirs = getattr(tcfg, name), getattr(jcfg, name)
    fo = [(f.name, f.type) for f in dataclasses.fields(ours)]
    ft = [(f.name, f.type) for f in dataclasses.fields(theirs)]
    assert fo == ft
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    assert ours.__dataclass_params__.frozen and theirs.__dataclass_params__.frozen


def test_derived_properties_equal():
    for kw in ({}, {"add_deltas": False}, {"n_fft": 256, "fmax": 6000.0}):
        ours, theirs = tcfg.FrontendConfig(**kw), jcfg.FrontendConfig(**kw)
        assert (ours.n_feats, ours.n_bins, ours.fmax_hz) == \
            (theirs.n_feats, theirs.n_bins, theirs.fmax_hz)
    # PipelineConfig re-derives max_frames from max_samples
    assert (tcfg.PipelineConfig(max_samples=16000).max_frames
            == jcfg.PipelineConfig(max_samples=16000).max_frames)


def test_plan_window_equal_over_grid():
    shapes = [1, 7, 33, 64, 120, 198, 256, 300, 512, 1000]
    bands = [None, 0.05, 0.1, 0.17, 0.2, 0.5, 0.9]
    for t in shapes:
        for u in shapes:
            for band in bands:
                for scale in (None, 1.5, 2.0, 3.0):
                    assert plan_window(band, t, u, scale) == \
                        jax_plan_window(band, t, u, scale), (band, t, u, scale)


@pytest.mark.parametrize("kw", [{}, {"n_fft": 256, "lifter": 0},
                                {"n_mels": 40, "n_mfcc": 20, "fmin": 100.0}])
def test_frontend_matrices_equal(kw):
    ours = matrices_np(tcfg.FrontendConfig(**kw))
    theirs = _matrices_np(jcfg.FrontendConfig(**kw))
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    mats = make_matrices(tcfg.FrontendConfig(**kw), "cpu")
    for t, b in zip(mats, theirs):
        np.testing.assert_array_equal(t.numpy(), b.astype(np.float32))


def test_synth_word_byte_equal():
    for label in ("zero", "seven", "yes"):
        for seed in (0, 3, 1001):
            a = synth_word(label, seed)
            b = jax_synth_word(label, seed)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    a = synth_word("two", 5, max_samples=12000, noise=0.01)
    assert a.tobytes() == jax_synth_word("two", 5, max_samples=12000,
                                         noise=0.01).tobytes()


@pytest.mark.parametrize("labels,seed", [(["one", "two", "three"], 300),
                                         (["zero"], 7), (["nine", "yes"], 0)])
def test_synth_connected_byte_equal(labels, seed):
    a = synth_connected(labels, seed)
    b = jax_dataset.synth_connected(labels, seed)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,n_words", [(0, 8), (11, 6), (5000, 3)])
def test_synth_spotting_stream_byte_equal(seed, n_words):
    keywords = ["zero", "one", "two", "three", "four"]
    vocab = keywords + ["five", "six", "seven", "eight", "nine"]
    a, ev_a = synth_spotting_stream(keywords, vocab, seed, n_words=n_words)
    b, ev_b = jax_dataset.synth_spotting_stream(keywords, vocab, seed,
                                                n_words=n_words)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ev_a == ev_b


def test_port_imports_neither_jax_nor_dsp_tpu():
    root = Path(__file__).resolve().parent.parent
    code = ("import sys, dsp_tpu_torch, dsp_tpu_torch.kernels.dtw_fused_banded, "
            "dsp_tpu_torch.kernels.mfcc_fused, dsp_tpu_torch.kernels.spot_fused, "
            "dsp_tpu_torch.ops.spot, dsp_tpu_torch.models.spotter, dsp_tpu_torch.io; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'jax', 'dsp_tpu'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
