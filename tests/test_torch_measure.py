"""The port's measurement scripts (``dsp_tpu_torch/scripts/``: cascade_timing,
serve_latency, fe_profile, mb_long_t, mb_fused_banded, mb_spot_fused,
roofline) against the JAX package's (``scripts/``), on the CPU.

The wall-clock scripts run through both ``main``s at a tiny cut
(``run_both`` of ``tests/test_torch_scripts.py``; the port's GMM-HMM fits
start from JAX's draws): the printed lines equal but the device and the
times; the calibrated threshold within ``THR_TOL["knn"]``; the cascade's
F1 and candidate count equal, or the count one apart (the float32 fits
part, ``ROADMAP.md`` queue 3).  ``serve_latency.build`` gives the labels
and request outputs of JAX's recognizer on the same signals.

The CUDA-event scripts refuse the CPU, so their parts are held one by one:
the inputs byte-equal to what the JAX scripts draw (taken from the JAX
``main`` with its timer replaced by a stand-in that keeps the arguments),
the pair counts and window plans equal, and what each row times, run on
CPU tensors (the kernels' plain versions), equal to JAX's ``dtw_batch`` /
``subseq_dtw_batch_impl`` at a small shape: distances at rtol 1e-4, norms
at 2e-4 with the starts equal; ``fe_profile``'s stages to JAX's stage
programs at the front end's tolerance.  ``roofline``'s cell count is the
port's masked cost's, and its JSON keys are JAX's.
"""

import contextlib
import importlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_tpu.ops.dtw as jdtw
import dsp_tpu.utils.cache as jcache
import dsp_tpu.utils.timing as jtiming
from dsp_tpu.config import DtwConfig as JDtwConfig
from dsp_tpu.ops.spot import subseq_dtw_batch_impl
from dsp_tpu_torch.models import gmm_hmm as pg
from dsp_tpu_torch.scripts import (cascade_timing, dtw_inputs, fe_profile, mb_fused_banded,
                                   mb_long_t, mb_spot_fused, roofline, serve_latency)
from test_torch_scripts import THR_TOL, _jax_draw, _jax_script, _one_thread, run_both  # noqa: F401

CARD_SCRIPTS = ["fe_profile", "mb_long_t", "mb_fused_banded", "mb_spot_fused"]


@pytest.fixture
def no_cache(monkeypatch):
    """The JAX scripts' persistent compile cache off (it writes a directory)."""
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)


def _jax_main(monkeypatch, name, argv, **patch):
    """stdout of the JAX script's ``main()`` with ``sys.argv`` patched and
    the module attributes in ``patch`` replaced."""
    mod = _jax_script(name)
    for attr, value in patch.items():
        monkeypatch.setattr(mod, attr, value)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue().splitlines()


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# ------------------------------------------------------------ wall clock
def test_cascade_timing_equals_jax(monkeypatch):
    monkeypatch.setattr(pg, "normal_draw", _jax_draw)
    j, t = run_both(monkeypatch, "cascade_timing", [
        "--keywords", "3", "--templates", "2", "--streams", "2", "--words-per-stream", "3",
        "--passes", "1"])
    assert len(j) == len(t) == 5
    thr = [float(ln.split(":")[1].split("(")[0]) for ln in (j[0], t[0])]
    np.testing.assert_allclose(thr[1], thr[0], **THR_TOL["knn"])
    assert t[0].split("(")[1] == j[0].split("(")[1]
    assert j[1] == t[1] + ", backend cpu"
    f1 = [[ln.rsplit("F1 ", 1)[1] for ln in side[2:4]] for side in (j, t)]
    cand = [int(side[4].split("candidates: ")[1].split()[0]) for side in (j, t)]
    assert [ln.split(":")[0] for ln in t[2:4]] == ["     dtw", " cascade"]
    assert f1[1][0] == f1[0][0]                       # DTW spotting: no fit in it
    gap = abs(cand[1] - cand[0])                      # the cascade: equal, or one
    assert (gap == 0 and f1[1][1] == f1[0][1]) or gap == 1   # candidate apart
    assert cand[1] > 0 and float(f1[1][0]) > 0


def test_f1_of_is_the_jax_scripts_rule():
    rng = np.random.default_rng(5)
    labs = ["w00", "w01", "w02"]
    truths = [[(labs[rng.integers(3)], int(s), int(s) + int(rng.integers(2000, 9000)))
               for s in rng.integers(0, 80000, size=4)] for _ in range(4)]
    events = [[(labs[rng.integers(3)], int(s), int(s) + int(rng.integers(5, 60)), 0.0)
               for s in rng.integers(0, 500, size=6)] for _ in range(4)]
    for evs, tr in zip(events, truths):     # an event that surely covers a plant
        evs.append((tr[0][0], tr[0][1] // 160, tr[0][2] // 160, 0.0))
    got = cascade_timing.f1_of(events, truths, 160)
    # the JAX script's nested rule, restated: greedy first same-label plant
    # overlapped by half its length
    tp = fa = n = 0
    for evs, tr in zip(events, truths):
        left = [(lab, s // 160, e // 160) for lab, s, e in tr]
        n += len(left)
        for lab, s, e, _ in evs:
            k = next((i for i, (tl, ts, te) in enumerate(left)
                      if tl == lab and min(e, te) - max(s, ts) + 1 >= 0.5 * (te - ts + 1)), None)
            if k is None:
                fa += 1
            else:
                tp += 1
                left.pop(k)
    p, r = tp / max(tp + fa, 1), tp / max(n, 1)
    assert got == 2 * p * r / max(p + r, 1e-9) and 0 < got < 1


def _same_nbest(got, want):
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    np.testing.assert_allclose([[h[1] for h in row] for row in got],
                               [[h[1] for h in row] for row in want], rtol=1e-4)


def test_serve_latency_equals_jax(monkeypatch, no_cache):
    from dsp_tpu.models import knn_dtw as jknn

    made = []
    init = jknn.KnnDtwRecognizer.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(jknn.KnnDtwRecognizer, "__init__", keep)
    j, t = run_both(monkeypatch, "serve_latency", ["--bank-size", "10", "--batches", "1,2",
                                                   "--calls", "1"])
    assert len(j) == len(t) == 13
    assert j[0] == t[0] + ", backend=cpu"
    for a, b in zip(j[1:], t[1:]):
        if a.startswith("| ") and not a.startswith(("| batch", "| request")):
            a, b = a.split("|")[1], b.split("|")[1]
        assert a == b

    # the recognizer and request modes of build() against JAX's recognizer
    jrec, = made
    rec, modes = serve_latency.build(10, "cpu")
    assert rec.n_templates == jrec.n_templates == 10 and rec.labels == jrec.labels
    sigs = serve_latency.batch_signals(2, rec.cfg.max_samples)
    assert rec.classify_batch(sigs) == list(jrec.classify_batch(sigs))
    from dsp_tpu.io.dataset import synth_connected
    conn = synth_connected(["zero", "one", "two"], seed=77)
    gapless = synth_connected(["zero", "one", "two"], seed=78, gap_ms=(0.0, 1.0))
    want = [jrec.classify_connected([conn], max_segments=4),
            jrec.classify_connected([gapless], max_segments=4, method="level"),
            jrec.classify_connected([gapless], max_segments=4, method="level",
                                    grammar={"no_repeat": True}),
            jrec.classify_nbest([conn[:rec.cfg.max_samples]], n=3)]
    got = [call() for _, call in modes]
    assert [name for name, _ in modes] == ["connected (vad split)", "level (gapless DP)",
                                           "level + grammar", "nbest (n=3)"]
    assert got[:3] == want[:3] and got[0] == [["zero", "one", "two"]]
    _same_nbest(got[3], want[3])


# ----------------------------------------------------------- fe_profile
def test_fe_profile_stages_equal_jax(monkeypatch, no_cache):
    chunk, n_templates = 4, 10
    kept = []

    def stand_in(step, args, n_iters=8, warmup=1, passes=3):
        kept.append((args, step(*args, token=jnp.asarray(0.0, jnp.float32))))
        return 2e-3, 1e-3, 3e-3

    monkeypatch.setattr(jtiming, "chained_timeit_spread", stand_in)
    lines = [json.loads(ln) for ln in _jax_main(
        monkeypatch, "fe_profile", ["--in-process", "--chunk", str(chunk), "--templates",
                                    str(n_templates), "--iters", "1", "--passes", "1"])]
    got = fe_profile.stages(chunk, n_templates, "cpu")
    assert [n for n, _, _ in got] == [ln["stage"] for ln in lines[:-1]]
    for (name, _, _), ln in zip(got, lines[:-1]):
        assert fe_profile.stage_line(name, 2e-3, 1e-3, 3e-3, chunk, n_templates) == ln
    assert fe_profile.attribution(dict.fromkeys((n for n, _, _ in got), 2e-3)) == \
        lines[-1]["attribution"]

    for (name, fn, args), (jargs, jout) in zip(got, kept):
        assert len(args) == len(jargs)
        for a, b in zip(args, jargs):     # the signals, lengths and features
            if name == "dtw":
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-3, atol=1e-3)
            else:
                assert _np(a).tobytes() == _np(b).tobytes()
        out = fn(*args)
        if name == "noop":
            assert _np(out)[0] == _np(jout[0])
        elif name == "mfcc":
            np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-3, atol=1e-3)
        elif name == "vad":
            for a, b in zip(out, jout):
                assert _np(a).tolist() == _np(b).tolist()
        elif name == "fe":
            np.testing.assert_allclose(_np(out.feats), _np(jout.feats), rtol=1e-3, atol=1e-3)
            assert _np(out.length).tolist() == _np(jout.length).tolist()
        else:                             # dtw, full: (labels, distances)
            assert _np(out[0]).tolist() == _np(jout[0]).tolist()
            np.testing.assert_allclose(_np(out[1]), _np(jout[1]), rtol=1e-4)


# ------------------------------------------------------------ mb scripts
def _kept_timer(kept, result):
    def stand_in(step, args, n_iters=8, warmup=1, **_):
        kept.append(args)
        return result
    return stand_in


def test_mb_long_t_inputs_and_plans_equal_jax(monkeypatch, no_cache):
    kept = []
    monkeypatch.setattr(jtiming, "chained_timeit", _kept_timer(kept, 1e-3))
    lines = _jax_main(monkeypatch, "mb_long_t", ["--impls", "scan"])
    rows = [ln for ln in lines if ln.startswith("| ") and ln[2].isdigit()]
    assert len(rows) == len(kept) == 3
    for t, row, jargs in zip(mb_long_t.shapes(), rows, kept):
        cells = [c.strip() for c in row.strip("|").split("|")]
        b, pairs = mb_long_t.pair_count(t)
        assert [int(cells[0]), int(cells[1])] == [t, pairs]
        assert mb_long_t.plan_text(b, t, 39, 0.17).split(" (")[0] == cells[2]
        for a, ja in zip(dtw_inputs(b, mb_long_t.K, t, 39, "cpu"), jargs):
            assert a.numpy().tobytes() == np.asarray(ja).tobytes()
    assert [mb_long_t.pair_count(t)[1] for t in mb_long_t.shapes()] == [256, 64, 64]
    assert mb_long_t.plan_text(16, 198, 39, 0.17).endswith("(staged x14)")
    assert mb_long_t.plan_text(4, 1024, 39, 0.17).endswith("(staged x4)")


@pytest.mark.parametrize("name", ["scan", "kernel", "unbanded"])
def test_mb_long_t_rows_equal_jax_dtw(name):
    b, t, f = 2, 24, 39
    args = dtw_inputs(b, mb_long_t.K, t, f, "cpu")
    fn, plain, cfg, _, _ = mb_long_t.timed_functions(0.17)[name]
    jcfg = JDtwConfig(band_frac=cfg.band_frac, squared=False)
    want = np.asarray(jdtw.dtw_batch(*(jnp.asarray(a.numpy()) for a in args), jcfg,
                                     jax.lax.Precision.HIGHEST))
    got = fn(*args, cfg)
    assert got.shape == (b, mb_long_t.K) and (want < 1e20).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    if plain is not None:
        np.testing.assert_allclose(plain(*args, cfg).numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("where", ["timing", "check"])
def test_mb_long_t_out_of_memory_row_is_nan(monkeypatch, where):
    """A row that runs out of memory, in its timing or in its check against
    plain, keeps no time; the other rows run and are checked."""
    import dsp_tpu_torch.scripts as tscripts
    import dsp_tpu_torch.utils.timing as ttiming

    def oom(*_a, **_k):
        raise torch.cuda.OutOfMemoryError("planted")

    fns = mb_long_t.timed_functions(0.17)
    fn, plain, cfg, rtol, atol = fns["kernel"]
    fns["kernel"] = (fn, oom, cfg, rtol, atol) if where == "check" else (oom, plain, cfg,
                                                                         rtol, atol)
    monkeypatch.setattr(tscripts, "require_card", lambda device, what: torch.device("cpu"))
    monkeypatch.setattr(ttiming, "chained_timeit",
                        lambda step, args, n_iters=8: (step(*args), 1e-3)[1])
    monkeypatch.setattr(mb_long_t, "timed_functions", lambda band: fns)
    with contextlib.redirect_stdout(io.StringIO()):
        (row,) = mb_long_t.main(["--t", "24", "--pairs", "32", "--impls", "kernel,unbanded"])
    assert row["kernel"] != row["kernel"] and "kernel_max_rel_err" not in row
    assert row["kernel_error"].startswith("out of memory: planted")
    assert row["unbanded"] == 1.0 and row["unbanded_max_rel_err"] <= 1e-4


def test_mb_fused_banded_inputs_equal_jax(monkeypatch):
    import dsp_tpu.kernels.dtw_fused_banded as jfb

    kept = []
    mod = _jax_script("mb_fused_banded")
    monkeypatch.setattr(mod, "chained_timeit", _kept_timer(kept, 1e-3))
    for knob in ("QUERY_TILE", "_ABLATE", "_STAGED_EXTRACT"):    # main sets them
        monkeypatch.setattr(jfb, knob, getattr(jfb, knob))
    monkeypatch.setattr(sys, "argv", ["mb_fused_banded.py", "--qt", "128", "--variant",
                                      "unbanded"])
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main()
    jargs, = kept
    for a, ja in zip(dtw_inputs(128, 100, 198, 39, "cpu"), jargs):
        assert a.numpy().tobytes() == np.asarray(ja).tobytes()


@pytest.mark.parametrize("variant,over", mb_fused_banded.VARIANTS)
def test_mb_fused_banded_rows_equal_jax_dtw(variant, over):
    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels.dtw_fused_banded import config_plan, dtw_batch_fused_banded

    q, ql, bank, bl = dtw_inputs(3, 4, 24, 39, "cpu")
    cfg = DtwConfig(**over)
    assert mb_fused_banded.batch_sweep(128, 198, 39, cfg) == [1, 2, 4, 8, 128]
    assert mb_fused_banded.batch_sweep(16, 198, 39, cfg) == [1, 2, 4, 8, 16]
    assert [config_plan(b, 198, 198, 39, cfg)[1] for b in (1, 2, 4, 128)] == [1, 2, 3, 14]
    want = np.asarray(jdtw.dtw_batch(*(jnp.asarray(a.numpy()) for a in (q, ql, bank, bl)),
                                     JDtwConfig(**over), jax.lax.Precision.HIGHEST))
    for b in (1, 3):       # a row times the first b queries
        got = dtw_batch_fused_banded(q[:b], ql[:b], bank, bl, cfg)
        np.testing.assert_allclose(got.numpy(), want[:b], rtol=1e-4)


def test_mb_spot_fused_inputs_and_rows_equal_jax(monkeypatch):
    kept = []

    def stand_in(x, sl, bank, tl, stream_tile=8, interpret=False):
        kept.append((x, sl, bank, tl))
        return jnp.zeros((x.shape[0], bank.shape[0], x.shape[1])), None

    with jax.disable_jit():
        lines = _jax_main(monkeypatch, "mb_spot_fused", ["--tiles", "8"],
                          subseq_dtw_fused=stand_in,
                          chained_timeit_spread=lambda *a, **k: (1e-3, 1e-3, 1e-3))
    jargs, = kept
    got = mb_spot_fused.inputs(64, 100, 595, 198, 39, "cpu")
    for a, ja in zip((got[0], got[1], got[2], got[3]), jargs):
        assert a.numpy().tobytes() == np.asarray(ja).tobytes()
    assert f"audio={mb_spot_fused.audio_seconds(got[1]):.1f}s/iter" in lines[0]

    # what the rows time, on CPU tensors (the plain version), against JAX's scan
    streams, sl, bank, tl = mb_spot_fused.inputs(3, 4, 32, 12, 39, "cpu")
    from dsp_tpu_torch.kernels.spot_fused import subseq_dtw_fused
    norm, start = subseq_dtw_fused(streams, sl, bank, tl)
    jn, js = subseq_dtw_batch_impl(*(jnp.asarray(a.numpy()) for a in (streams, sl, bank, tl)))
    valid = np.arange(32)[None, None, :] < sl.numpy()[:, None, None]
    np.testing.assert_allclose(norm.numpy()[np.broadcast_to(valid, norm.shape)],
                               np.asarray(jn)[np.broadcast_to(valid, norm.shape)], rtol=2e-4)
    assert (start.numpy()[np.broadcast_to(valid, norm.shape)]
            == np.asarray(js)[np.broadcast_to(valid, norm.shape)]).all()


@pytest.mark.parametrize("name", CARD_SCRIPTS)
def test_card_scripts_refuse_the_cpu(name):
    mod = importlib.import_module(f"dsp_tpu_torch.scripts.{name}")
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.main(["--device", "cpu"])


# ------------------------------------------------------------- roofline
def test_roofline_cells_are_the_masked_costs():
    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.ops.dtw import masked_cost

    x = torch.zeros((1, 198, 1))
    n = torch.tensor([198], dtype=torch.int32)
    cells = int((masked_cost(x, n, x, n, DtwConfig(band_frac=0.17, max_warp_scale=2.0))
                 < 1e20).sum())
    assert roofline.classify_cells(198, 198) == cells == 12144
    assert roofline.classify_model()["fp32"] == cells * (2 * 39 + 3)
    assert roofline.spot_model(t=198, u=595)["fp32"] == 198 * 595 * (2 * 39 + 3)
    assert roofline.bound(67e12 * 1e-3, 0.0) == (1.0, "operations")
    assert roofline.bound(0.0, 3.35e12 * 2e-3) == (2.0, "bytes")


@pytest.mark.parametrize("config,flag", [("classify", "--pairs-per-s"),
                                         ("spot", "--pairs-per-s"),
                                         ("viterbi", "--frames-per-s")])
def test_roofline_lines_have_the_jax_keys(monkeypatch, config, flag):
    argv = ["--config", config, flag, "1e6"]
    jlines = [json.loads(ln) for ln in _jax_main(monkeypatch, "roofline", argv)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = roofline.main(argv)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert lines == rows and len(lines) == 3
    assert {tuple(ln) for ln in lines[:-1]} <= {tuple(ln) for ln in jlines[:-1]}
    assert list(lines[-1]) == list(jlines[-1]) and lines[-1]["config"] == config
    bind = max(lines[:-1], key=lambda r: r["utilization"])
    assert lines[-1]["binding_unit"] == bind["unit"] == "fp32"
    with pytest.raises(SystemExit):
        roofline.main(["--config", config])
