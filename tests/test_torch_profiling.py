"""The port's profiling helpers, pipeline picture and package exports.

``utils.profiling`` (trace, stage, StageTimer), ``viz.plot_pipeline``
against the JAX package's golden VAD, and the ``__all__`` of each package
pair, which must differ only by the names the JAX package keeps to the
TPU.
"""

import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.golden import vad as gvad
from dsp_tpu.io.dataset import synth_connected, synth_word
from dsp_tpu_torch.utils import profiling


def _trace_events(logdir):
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(logdir, files[0])) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_with_nested_stages(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with profiling.trace(logdir) as prof:
        with profiling.stage("outer"):
            with profiling.stage("inner"):
                y = x @ x
            y = y + 1.0
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "inner", "aten::mm"} <= names
    spans = {e["name"]: e for e in _trace_events(logdir) if e.get("ph") == "X"}
    outer, inner = spans["outer"], spans["inner"]
    # the inner range lies inside the outer one on the host's timeline
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_stage_timer_sums_each_stage():
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer.time("a"):
            time.sleep(0.02)
    with timer.time("b"):
        time.sleep(0.01)
    with pytest.raises(ValueError):
        with timer.time("b"):
            raise ValueError("a failing stage still counts")
    rep = timer.report()
    assert list(rep) == ["a", "b"]
    assert 0.04 <= timer.totals["a"] < 0.5 and 0.01 <= timer.totals["b"] < 0.5
    assert rep["a"] == round(timer.totals["a"], 4)


@pytest.fixture(scope="module")
def small_bank():
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    rec = KnnDtwRecognizer(device="cpu")
    for lab in ("one", "two", "three"):
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    return rec


@pytest.mark.parametrize("case", ["word", "connected", "silence"])
def test_plot_pipeline_writes_png_with_golden_endpoints(tmp_path, small_bank, case):
    from dsp_tpu_torch.viz import plot_pipeline

    x = {"word": synth_word("three", 11),
         "connected": synth_connected(["one", "two"], 5)[:32000],
         "silence": 0.001 * np.random.default_rng(0).standard_normal(16000)
         .astype(np.float32)}[case]
    out = str(tmp_path / "p.png")
    got = plot_pipeline(x, out, recognizer=small_bank if case == "word" else None,
                        title=case)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(out) > 10000
    cfg = JPipelineConfig()
    start, end, found = gvad.detect_endpoints(x, cfg.frontend, cfg.vad)
    assert (got["start"], got["end"], got["found"]) == (int(start), int(end), bool(found))
    assert got["energy"].shape == got["zcr"].shape
    assert got["features"].shape[1] == 39


JAX_ONLY = {
    "io": set(),
    "utils": {"token_mix"},          # the relay's token trick (TPU-only)
    "models": set(),
    "": set(),
}


@pytest.mark.parametrize("pkg", sorted(JAX_ONLY))
def test_exports_cover_the_jax_package(pkg):
    jax_mod = importlib.import_module("dsp_tpu" + (f".{pkg}" if pkg else ""))
    port_mod = importlib.import_module("dsp_tpu_torch" + (f".{pkg}" if pkg else ""))
    assert set(jax_mod.__all__) - set(port_mod.__all__) == JAX_ONLY[pkg]
    for name in port_mod.__all__:
        assert getattr(port_mod, name) is not None
    if not pkg:
        assert port_mod.__version__ == jax_mod.__version__


def test_kernel_exports_build_nothing():
    import dsp_tpu_torch.kernels as k
    from dsp_tpu_torch.kernels import _build
    assert len(k.__all__) == len(set(k.__all__)) == 8
    assert all(callable(getattr(k, name)) for name in k.__all__)
    # no export shadows a wrapper module of the package
    for mod in ("dtw_fused", "dtw_fused_banded", "dtw_pallas", "mfcc_fused", "spot_fused",
                "mb_wavefront"):
        module = importlib.import_module(f"dsp_tpu_torch.kernels.{mod}")
        assert getattr(k, mod) is module
    assert _build._lib is None
