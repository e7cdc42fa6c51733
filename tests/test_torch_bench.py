"""The port's benchmark entry points (``dsp_tpu_torch/bench.py``,
``dsp_tpu_torch/bench_all.py`` and the CLI's ``bench``) against the JAX
package's ``bench.py`` and ``bench_all.py``, on the CPU.

* Inputs: what ``bench.inputs`` and ``bench_all.inputs`` draw is
  byte-equal to the arrays the JAX scripts build (taken from the JAX
  bodies with their pipeline calls and timer replaced by stand-ins that
  keep their arguments, and from their steps' closures), but config 3's
  ``log_a``: the port's ``_lr_log_a`` takes torch's ``log1p(-0.6)``, one
  unit in the last place from XLA's, so it is held within 1 ulp.  The
  port's lines at a stand-in time equal JAX's (keys, order, names, rates).
* ``bench_body``'s labels on its last chunk equal JAX's
  ``pipeline.recognize_batch`` on the same signals, with and without
  ``BENCH_SLOPE=itakura``, under both ``BENCH_DISPATCH`` modes (on the CPU
  ``single`` runs the chunked chain as its one call); distances at rtol
  1e-3 (the tolerance of ``tests/test_torch_pipeline.py``).
* ``bench_all``'s rows at a small size, each run once on CPU tensors:
  configs 0, 1 and 4 give JAX's ``recognize_batch`` labels; config 3 JAX's
  ``score_words`` at rtol 1e-5 on the same features and parameters
  (``tests/test_torch_gmm_hmm.py``); ``spot`` JAX's
  ``subseq_dtw_batch_impl`` with norms at rtol 2e-4 / atol 1e-5 and the
  start witnesses equal on every valid column (``tests/test_torch_spot.py``).
  The other rows run once: shapes, finite values, and ``spot`` equal to
  ``spot-scan`` (both the plain route on the CPU).
* ``bench.main`` prints one JSON line with JAX's keys, also under
  ``BENCH_DISPATCH=single`` (with a stderr line that the CPU has no CUDA
  graphs); the refusals: the default device with no card, ``bench_all``
  anywhere but on a card; the CLI's ``bench`` subcommand, and its help
  listing the JAX CLI's seventeen subcommands.
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_tpu.utils.cache as jcache
import dsp_tpu.utils.timing as jtiming
from dsp_tpu import pipeline as jpl
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.models import gmm_hmm as jgh
from dsp_tpu.ops import frontend as jfe
from dsp_tpu.ops.spot import subseq_dtw_batch_impl
from dsp_tpu_torch import bench, bench_all, cli
from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import PipelineConfig

KNOBS = ("BENCH_UTTS", "BENCH_TEMPLATES", "BENCH_CHUNK", "BENCH_PASSES", "BENCH_SLOPE",
         "BENCH_PRECISION", "BENCH_PLATFORM", "BENCH_DISPATCH", "BENCH_ALL_PASSES",
         "DSP_TPU_PLATFORM", "SC2_ROOT")
TINY = dict(BENCH_UTTS=4, BENCH_CHUNK=4, BENCH_TEMPLATES=10)
SMALL = dict(batch=4, templates_per_word=1, clips=2, sc2_words=10, sc2_per_word=1)
JAX_KEYS = ["metric", "value", "unit", "vs_baseline", "passes", "min", "max"]


@pytest.fixture
def env(monkeypatch):
    """Clears every knob; returns a setter."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)

    def set_env(**kv):
        for k, v in kv.items():
            monkeypatch.setenv(k, str(v))
    return set_env


@pytest.fixture
def no_cache(monkeypatch):
    """The JAX scripts' persistent compile cache off (it writes a directory)."""
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _same_bytes(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _features_stand_in(kept):
    """A JAX feature extractor that keeps its arguments and computes nothing."""
    def stand_in(signals, n_samples, mats, cfg, *a, **k):
        kept.append((np.asarray(signals), np.asarray(n_samples)))
        b = signals.shape[0]
        return jpl.Features(jnp.zeros((b, 1, 1)), jnp.zeros((b,), jnp.int32))
    return stand_in


# ---------------------------------------------------------------- bench
def test_bench_inputs_equal_jax(monkeypatch, env, no_cache, capsys):
    import bench as jbench

    env(BENCH_PLATFORM="cpu", BENCH_UTTS=9, BENCH_CHUNK=4, BENCH_TEMPLATES=20,
        BENCH_PASSES=1)
    banks, chunks = [], []

    def recognize(signals, n_samples, mats, bank, ids, cfg, precision=None):
        chunks.append((np.asarray(signals), np.asarray(n_samples), np.asarray(ids)))
        return jnp.zeros(signals.shape[0], jnp.int32), None

    monkeypatch.setattr(jpl, "extract_features", _features_stand_in(banks))
    monkeypatch.setattr(jpl, "recognize_batch", recognize)
    with jax.disable_jit():                # the chunks reach the stand-in as arrays
        jbench._bench_body()
    jax_note = capsys.readouterr().err.strip()

    bank_sigs, bank_ns, ids, got_chunks, qn = bench.inputs(9, 20, 4, bench.config(), "cpu")
    assert capsys.readouterr().err.strip() == jax_note == \
        "# note: BENCH_UTTS 9 rounded to 8 (whole chunks of 4)"
    (want_sigs, want_ns), = banks
    _same_bytes(bank_sigs, want_sigs)
    _same_bytes(bank_ns, want_ns)
    assert len(got_chunks) == 2 and len(chunks) == 2 * 2    # warm-up and one pass
    for got, (sigs, n, want_ids) in zip(got_chunks, chunks[:2]):
        _same_bytes(got, sigs)             # the step adds a zero token: no -0.0 here
        _same_bytes(qn, n)
        _same_bytes(ids, want_ids)


@pytest.mark.parametrize("dispatch", ["chunked", "single"])
@pytest.mark.parametrize("slope", ["", "itakura"])
def test_bench_labels_equal_jax(env, slope, dispatch):
    env(BENCH_PLATFORM="cpu", BENCH_PASSES=1, BENCH_SLOPE=slope, BENCH_DISPATCH=dispatch,
        **TINY)
    keep = {}
    res = bench.bench_body("cpu", keep)
    cfg = keep["cfg"]
    assert cfg.dtw.slope == (slope or PipelineConfig().dtw.slope)
    assert res["passes"] == 1 and keep["labels"].shape == (4,)

    jcfg = JPipelineConfig()
    if slope:
        import dataclasses
        jcfg = dataclasses.replace(jcfg, dtw=dataclasses.replace(jcfg.dtw, slope=slope))
    mats = jfe.make_matrices(jcfg.frontend)
    bank_sigs, bank_ns, ids, _, _ = bench.inputs(4, 10, 4, cfg, "cpu")
    jbank = jpl.extract_features(jnp.asarray(bank_sigs.numpy()), jnp.asarray(bank_ns.numpy()),
                                 mats, jcfg)
    want, want_d = jpl.recognize_batch(jnp.asarray(keep["chunk"].numpy()),
                                       jnp.asarray(keep["n_samples"].numpy()), mats, jbank,
                                       jnp.asarray(ids.numpy()), jcfg)
    assert keep["labels"].tolist() == np.asarray(want).tolist()
    _, got_d = tpl.recognize_batch(keep["chunk"], keep["n_samples"], keep["bank"],
                                   keep["ids"], cfg)
    assert torch.equal(keep["dists"], got_d)
    want_d = np.asarray(want_d)
    assert ((got_d.numpy() >= 1e20) == (want_d >= 1e20)).all()
    fin = want_d < 1e20
    np.testing.assert_allclose(got_d.numpy()[fin], want_d[fin], rtol=1e-3)


@pytest.mark.parametrize("entry", ["module", "cli", "single"])
def test_bench_main_prints_one_jax_line(env, capsys, entry):
    if entry in ("module", "single"):
        env(BENCH_PLATFORM="cpu", BENCH_PASSES=3, **TINY)
        if entry == "single":
            env(BENCH_DISPATCH="single")
        bench.main()
    else:                                  # --device cpu stands for BENCH_PLATFORM=cpu
        env(BENCH_PASSES=3, **TINY)
        cli.main(["--device", "cpu", "bench"])
    out = capsys.readouterr()
    lines = [ln for ln in out.out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == JAX_KEYS
    assert rec["metric"] == "mfcc_dtw_alignments_per_sec_per_chip"
    assert rec["unit"] == "alignments/s/chip" and rec["passes"] == 3
    assert rec["vs_baseline"] == round(rec["value"] / 1e4, 3)
    assert 0 < rec["min"] <= rec["value"] <= rec["max"]
    assert out.err.splitlines()[0] == "# bench: device cpu"
    assert ("no CUDA graphs" in out.err) == (entry == "single")


def _refuse_no_card(run):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises((AssertionError, RuntimeError)):
        run()


@pytest.mark.parametrize("case", ["bench_no_card", "cli_no_card", "bench_all_cpu",
                                  "bench_all_no_card"])
def test_entry_points_refuse(env, capsys, case):
    if case == "bench_no_card":
        env(**TINY)
        _refuse_no_card(bench.main)
    elif case == "cli_no_card":
        env(**TINY)
        _refuse_no_card(lambda: cli.main(["bench"]))
    else:
        if case == "bench_all_cpu":
            env(DSP_TPU_PLATFORM="cpu")
        with pytest.raises(RuntimeError, match="CUDA card"):
            bench_all.main()
    assert "{" not in capsys.readouterr().out


def test_cli_bench_reaches_bench_main_and_help_lists_sixteen(monkeypatch, capsys):
    import dsp_tpu.cli as jcli

    devices = []
    monkeypatch.setattr(bench, "main", lambda device=None: devices.append(device))
    cli.main(["--device", "cpu", "bench"])
    cli.main(["bench"])
    assert devices == ["cpu", "cuda"]

    def choices(main):
        with pytest.raises(SystemExit):
            main(["--help"])
        text = capsys.readouterr().out
        return next(ln.strip() for ln in text.splitlines()
                    if ln.strip().startswith("{")).strip("{}").split(",")

    # sixteen before the port's ``warm``, which makes the JAX CLI's seventeen
    port, jax_cli = choices(cli.main), choices(jcli.main)
    assert len(port) == 17 and "bench" in port and "warm" in port
    assert port == jax_cli


# ------------------------------------------------------------ bench_all
def test_bench_all_inputs_and_lines_equal_jax(monkeypatch, env, no_cache, capsys):
    import bench_all as jbench_all

    import dsp_tpu_torch.scripts as tscripts
    import dsp_tpu_torch.utils.timing as ttiming

    env(SC2_ROOT="speech_commands_v2")
    banks, recordings, jsteps, psteps = [], [], [], []

    def timer(kept):
        def stand_in(step, args, n_iters=8, warmup=1, passes=3):
            kept.append((step, args))
            return 2e-3, 1e-3, 3e-3
        return stand_in

    def recording_features(signals, n_samples, mats, cfg, t_max, *a, **k):
        recordings.append((np.asarray(signals), np.asarray(n_samples), t_max))
        b = signals.shape[0]
        return jpl.Features(jnp.zeros((b, t_max, 39)), jnp.zeros((b,), jnp.int32))

    monkeypatch.setattr(jpl, "extract_features", _features_stand_in(banks))
    monkeypatch.setattr(jpl, "extract_recording_features", recording_features)
    monkeypatch.setattr(jtiming, "chained_timeit_spread", timer(jsteps))
    jbench_all.main()
    jlines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]

    monkeypatch.setattr(tscripts, "require_card", lambda device, what: torch.device("cpu"))
    monkeypatch.setattr(ttiming, "chained_timeit_spread", timer(psteps))
    returned = bench_all.main()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert returned == [ln for ln in lines if ln["config"] != "4-note"]

    # the lines: JAX's keys in JAX's order, names and rates; the note points
    # at the port's CLI, and the plain scan's unit does not name XLA
    assert len(lines) == len(jlines) == 12
    for got, want in zip(lines, jlines):
        assert list(got) == list(want)
        if want["config"] == "4-note":
            assert got["note"] == want["note"].replace("dsp_tpu ", "dsp_tpu_torch ")
        elif want["config"] == "spot-scan":
            assert got == dict(want, unit=want["unit"].replace("XLA", "plain"))
        else:
            assert got == want

    # the inputs, byte for byte
    inp = bench_all.inputs(PipelineConfig())
    assert [len(x) for x in (banks, recordings, jsteps, psteps)] == [4, 1, 11, 11]
    for (sigs, ns), name in zip(banks, ("bank10", "bank100", None, "bank35")):
        if name is None:                   # config 3's features come from the queries
            _same_bytes(inp["xb"], sigs)
            continue
        _same_bytes(inp[name][0], sigs)
        _same_bytes(inp[name][1], ns)
    (conn, clens, _), = recordings
    _same_bytes(inp["conn"], conn)
    _same_bytes(inp["clens"], clens)
    closure = [inspect.getclosurevars(step.__wrapped__).nonlocals for step, _ in jsteps]
    _same_bytes(inp["bank10"][2], closure[0]["ids10"])
    _same_bytes(inp["bank100"][2], closure[1]["ids100"])
    _same_bytes(inp["bank35"][2], closure[4]["ids35"])
    for name, got, want in zip(inp["params"]._fields, inp["params"], closure[3]["params"]):
        if name == "log_a":                # torch's log1p(-0.6) is 1 ulp from XLA's
            np.testing.assert_array_max_ulp(_np(got), _np(want), maxulp=1)
        else:
            _same_bytes(got, want)
    for got, want in zip(inp["ubm"], closure[9]["ubm"]):
        _same_bytes(got, want)
    # each row's first argument where it is a raw input (the rest are features)
    for i, name in ((0, "x1"), (1, "xb"), (2, "chunk"), (4, "xb"), (5, "conn"), (10, "xb")):
        _same_bytes(inp[name], jsteps[i][1][0])
        _same_bytes(psteps[i][1][0], jsteps[i][1][0])


@pytest.fixture(scope="module")
def small():
    """The rows at a small size on CPU tensors, and their host inputs."""
    return ({r.meta["config"]: r for r in bench_all.rows("cpu", **SMALL)},
            bench_all.inputs(PipelineConfig(), **SMALL))


@pytest.mark.parametrize("config", [0, 1, 3, 4, "spot"])
def test_bench_all_rows_equal_jax(small, config):
    rows, inp = small
    row = rows[config]
    got = row.step(*row.args)
    jcfg = JPipelineConfig()
    if config in (0, 1, 4):
        mats = jfe.make_matrices(jcfg.frontend)
        sigs, ns, ids = inp[{0: "bank10", 1: "bank100", 4: "bank35"}[config]]
        jbank = jpl.extract_features(jnp.asarray(sigs), jnp.asarray(ns), mats, jcfg)
        x = inp["x1" if config == 0 else "xb"]
        n = jnp.full(x.shape[0], jcfg.max_samples, dtype=jnp.int32)
        want, _ = jpl.recognize_batch(jnp.asarray(x), n, mats, jbank, jnp.asarray(ids), jcfg)
        assert got.tolist() == np.asarray(want).tolist()
        assert row.scale is None if config == 0 else row.scale == x.shape[0] * len(ids)
    elif config == 3:
        feats, lengths, params = row.args
        want = jgh.score_words(jnp.asarray(feats.numpy()), jnp.asarray(lengths.numpy()),
                               jgh.HmmParams(*(jnp.asarray(p.numpy()) for p in params)))
        assert got.shape == (SMALL["batch"], bench_all.W)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    else:
        norm, start = got
        streams, lens, bank_feats, bank_lens, impl = row.args
        assert impl == "auto"
        jn, js = subseq_dtw_batch_impl(*(jnp.asarray(a.numpy()) for a in row.args[:4]))
        valid = np.broadcast_to(np.arange(norm.shape[2])[None, None, :]
                                < lens.numpy()[:, None, None], norm.shape)
        np.testing.assert_allclose(norm.numpy()[valid], np.asarray(jn)[valid],
                                   rtol=2e-4, atol=1e-5)
        assert (start.numpy()[valid] == np.asarray(js)[valid]).all()
        assert (norm.numpy()[~valid] >= 1e20).all()


@pytest.mark.parametrize("config", [2, "connected", "connected-level", "spot-scan",
                                    "spot-hmm", "ltw"])
def test_bench_all_rows_run(small, config):
    rows, inp = small
    row = rows[config]
    got = row.step(*row.args)
    b, clips, k = SMALL["batch"], SMALL["clips"], len(inp["bank100"][2])
    frames = rows["spot"].args[0].shape[1]
    shape = {2: (10, 13), "connected": (clips, bench_all.MAX_SEGMENTS),
             "connected-level": (clips, bench_all.MAX_LEVELS, frames),
             "spot-scan": (clips, k, frames), "spot-hmm": (clips, bench_all.W, frames),
             "ltw": (b,)}[config]
    first = got[0] if isinstance(got, tuple) else got
    assert tuple(first.shape) == shape and torch.isfinite(first.float()).all()
    if config == "spot-scan":
        want = rows["spot"].step(*rows["spot"].args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    elif config in ("connected", "ltw"):
        assert ((first >= -1) & (first < 10)).all()
    assert row.meta["metric"] and row.n_iters > 0 and row.scale > 0
