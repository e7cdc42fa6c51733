"""The port's evaluation scripts (``dsp_tpu_torch/scripts/``) against the
JAX package's (``scripts/``), on the CPU.

Each script runs through the port's ``main([..., "--device", "cpu"])`` and
the JAX script's ``main()`` (loaded from ``scripts/`` with ``importlib``,
``sys.argv`` patched) on the same tiny inputs: both packages' ``io``
modules get a 3-word ``DIGITS`` and ``hostile_vocab`` where the script
allows it, and ``make_corpus`` / ``make_hostile_corpus`` capped at
``N_PER`` utterances a word, and the scripts' own flags
cut the rest (``--quick``, ``--conditions``, ``--configs``,
``--enrolled``, ``--oov``, ``--clips``, ``--streams``).  The port's GMM-HMM
fits start from JAX's ``jax.random`` draws, as in
``tests/test_torch_gmm_hmm.py``.  The printed tables must be equal with
the device lines and the utterances/s column left out: kNN and VQ
accuracies, spotting cells and WERs exactly; GMM-HMM accuracies within one
utterance, since the packages' float32 fits part (``ROADMAP.md`` queue 3);
printed thresholds within ``THR_TOL``.  The copied helpers
(``add_noise_snr``, ``score``) are byte-equal on seeded inputs, and a
clean subprocess imports every script without ``jax`` or ``dsp_tpu``.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import dsp_tpu.io.dataset as jds
import dsp_tpu.io.hostile as jhost
import dsp_tpu.kernels.dtw_fused as jfused
import dsp_tpu.ops.dtw as jdtw
import dsp_tpu_torch.io.dataset as tds
import dsp_tpu_torch.io.hostile as thost
from dsp_tpu_torch.models import gmm_hmm as pg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ["results_matrix", "robustness", "hostile_vad", "hostile_matrix", "oov_eval",
           "spot_eval", "connected_eval", "grammar_eval"]
# tests/test_torch_measure.py; roofline needs no device
MEASURE_SCRIPTS = ["cascade_timing", "serve_latency", "fe_profile", "mb_long_t",
                   "mb_fused_banded", "mb_spot_fused", "roofline"]
WORDS = ["zero", "one", "two"]
N_PER = 2
# printed thresholds: the kNN's from each package's own distances, the
# HMM's LLR from fits that part by up to ~1e-2 (tests/test_torch_gmm_hmm.py)
THR_TOL = dict(knn=dict(rtol=1e-3, atol=1e-2), gmm=dict(rtol=0, atol=0.1))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the DP loops are thousands of small ops, which
    crawl when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draw(shape, seed, device="cpu"):
    """The port's normal_draw with JAX's bits (the JAX fit's keys)."""
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(int(seed)),
                                                       tuple(shape)))).to(device)


def _capped(make, key):
    def wrapped(*args, **kw):
        kw[key] = min(kw.get(key, N_PER), N_PER)
        return make(*args, **kw)
    return wrapped


@pytest.fixture
def tiny(monkeypatch):
    """Small corpora in both packages; ``tiny(words=False)`` keeps the
    10-digit vocabulary (the connected scripts index it by 0-9)."""
    def setup(words=True):
        for ds, host in ((jds, jhost), (tds, thost)):
            if words:
                monkeypatch.setattr(ds, "DIGITS", list(WORDS))
                monkeypatch.setattr(host, "hostile_vocab",
                                    lambda vocab=host.hostile_vocab(): vocab[:len(WORDS)])
            monkeypatch.setattr(ds, "make_corpus", _capped(ds.make_corpus, "n_per_word"))
            monkeypatch.setattr(host, "make_hostile_corpus",
                                _capped(host.make_hostile_corpus, "n_per"))
        monkeypatch.setattr(pg, "normal_draw", _jax_draw)
        # the JAX package runs its unbanded fused kernel on a TPU only: its
        # scan computes the same distances on the CPU
        monkeypatch.setattr(jfused, "dtw_batch_fused",
                            lambda q, ql, b, bl, cfg, interpret=False: jdtw.dtw_batch(
                                q, ql, b, bl, cfg, jax.lax.Precision.HIGHEST))
    return setup


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_scripts_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_both(monkeypatch, name, argv):
    """stdout of the JAX script and of the port's (``--device cpu``) on the
    same arguments, without the lines that name the device."""
    outs = []
    for side in ("jax", "port"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if side == "jax":
                monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
                _jax_script(name).main()
            else:
                mod = importlib.import_module(f"dsp_tpu_torch.scripts.{name}")
                mod.main([*argv, "--device", "cpu"])
        outs.append([ln for ln in buf.getvalue().splitlines()
                     if not ln.startswith(("device:", "# device:"))])
    assert outs[1], "the port printed nothing"
    return outs


def _cells(line):
    return [c.strip() for c in line.strip().strip("|").split("|")]


def _hmm_close(a: str, b: str, n: int):
    """Two printed rates of n utterances within one utterance."""
    assert abs(float(a.strip("*")) - float(b.strip("*"))) <= 1.0 / n + 1e-9, (a, b)


def _same_table(j, t, hmm_rows=(), n=1, skip_cols=()):
    """Markdown tables equal cell by cell; rows whose first cell is in
    ``hmm_rows`` within one of ``n`` utterances; columns ``skip_cols``
    (rates) not compared."""
    assert len(j) == len(t), (j, t)
    for a, b in zip(j, t):
        if not a.startswith("|"):
            assert a == b
            continue
        ca, cb = _cells(a), _cells(b)
        assert len(ca) == len(cb), (a, b)
        for i, (x, y) in enumerate(zip(ca, cb)):
            if i in skip_cols:
                continue
            if ca[0] in hmm_rows and i > 0 and x != y:
                _hmm_close(x, y, n)
            else:
                assert x == y, (a, b)


def test_results_matrix(tiny, monkeypatch):
    tiny()
    j, t = run_both(monkeypatch, "results_matrix", [])
    _same_table(j, t, hmm_rows=("GMM-HMM (viterbi)", "GMM-HMM (baum_welch)"),
                n=len(WORDS) * N_PER, skip_cols=(2,))
    rows = [ln for ln in t if ln.startswith("| ") and not ln.startswith("| recognizer")]
    assert len(rows) == 13 and rows[0].startswith("| kNN-DTW (default")


def test_robustness(tiny, monkeypatch):
    tiny()
    j, t = run_both(monkeypatch, "robustness", [])
    _same_table(j, t)
    assert len(t) == 2 + 5 + 4


def test_hostile_vad(tiny, monkeypatch):
    tiny()
    j, t = run_both(monkeypatch, "hostile_vad", [])
    _same_table(j, t)
    assert len(t) == 2 + 4 and "**" in "".join(t)


def test_hostile_matrix(tiny, monkeypatch):
    tiny()
    configs = ["default", "denoise", "itakura", "k=3", "2pass", "causal-cmn"]
    j, t = run_both(monkeypatch, "hostile_matrix", [
        "--quick", "--conditions", "snr0,tilt+snr10", "--configs", ",".join(configs)])
    assert json.loads(t[-1]) == json.loads(j[-1])
    _same_table(j[:-1], t[:-1])
    got = json.loads(t[-1])
    assert list(got["results"]) == ["snr0", "tilt+snr10"]
    assert list(got["results"]["snr0"]) == configs and got["n_queries"] == len(WORDS) * 2


def _same_oov(j, t, n_in):
    """oov_eval's blocks: headers equal; each row's threshold within
    THR_TOL, kNN rates equal, GMM-HMM rates within one utterance."""
    assert len(j) == len(t)
    family = None
    for a, b in zip(j, t):
        if a.startswith(("knn-dtw", "gmm-hmm")):
            family = a.split("-")[0]
        if not a.startswith("  "):
            assert a == b
            continue
        ca, cb = a.split(), b.split()
        assert ca[0] == cb[0] and ca[5:] == cb[5:], (a, b)
        np.testing.assert_allclose(float(ca[1]), float(cb[1]), **THR_TOL[family])
        for x, y in zip(ca[2:5], cb[2:5]):
            if family == "knn":
                assert x == y, (a, b)
            else:
                _hmm_close(x, y, n_in)


def test_oov_eval(tiny, monkeypatch):
    tiny()
    j, t = run_both(monkeypatch, "oov_eval", ["--quick", "--enrolled", "2", "--oov", "1"])
    _same_oov(j, t, n_in=2 * N_PER)
    assert sum(ln.startswith("  ") for ln in t) == 10


@pytest.mark.parametrize("family,flags", [
    ("dtw", ["--thresholds", "30,50"]),
    ("hmm", ["--thresholds=-45,-15"]),
    ("cascade", ["--thresholds", "30,60"]),
])
def test_spot_eval(tiny, monkeypatch, family, flags):
    tiny(words=False)
    j, t = run_both(monkeypatch, "spot_eval", ["--family", family, "--streams", "2",
                                               "--words-per-stream", "3", "--noises",
                                               "0.003,0.05", *flags])
    _same_table(j, t)
    assert len(t) == 2 + 2 + 2


def test_connected_eval(tiny, monkeypatch):
    tiny(words=False)
    j, t = run_both(monkeypatch, "connected_eval", ["--clips", "3"])
    _same_table(j, t)
    assert len(t) == 3 + 6


def test_grammar_eval(tiny, monkeypatch):
    tiny(words=False)
    j, t = run_both(monkeypatch, "grammar_eval", ["--clips", "2", "--noise", "0.02"])
    _same_table(j, t)
    assert len(t) == 3 + 3


def test_copied_helpers_are_byte_equal():
    from dsp_tpu_torch.scripts import robustness, spot_eval
    jrob, jspot = _jax_script("robustness"), _jax_script("spot_eval")
    x = np.random.default_rng(3).standard_normal(4000).astype(np.float32)
    for snr in (30, 5, 0, -5):
        a = robustness.add_noise_snr(x, snr, np.random.default_rng(snr + 10))
        b = jrob.add_noise_snr(x, snr, np.random.default_rng(snr + 10))
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    rng = np.random.default_rng(4)
    labs = ["one", "two", "three"]
    truths = [[(labs[rng.integers(3)], int(s), int(s) + int(rng.integers(2000, 9000)))
               for s in rng.integers(0, 80000, size=4)] for _ in range(5)]
    events = [[(labs[rng.integers(3)], int(s), int(s) + int(rng.integers(5, 60)),
                float(rng.random())) for s in rng.integers(0, 500, size=5)]
              for _ in range(5)]
    for midpoint in (False, True):
        got = spot_eval.score(events, truths, 160, midpoint=midpoint)
        want = jspot.score(events, truths, 160, midpoint=midpoint)
        assert got == want and 0 < got[2] < 1


def test_scripts_import_no_jax_and_default_to_the_card():
    code = (
        "import importlib, sys\n"
        "import dsp_tpu_torch.io.dataset as ds, dsp_tpu_torch.io.hostile as host\n"
        "mc, mh = ds.make_corpus, host.make_hostile_corpus\n"
        "ds.make_corpus = lambda labels=None, **k: mc((labels or ds.DIGITS)[:2], 1, k['seed'] "
        "if 'seed' in k else 0)\n"
        "host.make_hostile_corpus = lambda labels=None, **k: mh((labels or ['a'])[:2], (0,), 1)\n"
        f"names = {SCRIPTS + MEASURE_SCRIPTS!r}\n"
        "mods = [importlib.import_module('dsp_tpu_torch.scripts.' + n) for n in names]\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'dsp_tpu'}))\n"
        "import torch\n"
        "for n, m in zip(names, mods):\n"
        "    if n == 'roofline':\n"
        "        continue\n"
        "    try:\n"
        "        m.main([])\n"
        "    except (AssertionError, RuntimeError) as e:\n"
        "        assert torch.cuda.is_available() or 'CUDA' in str(e), (n, e)\n"
        "    else:\n"
        "        assert torch.cuda.is_available(), n\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["[]", "ok"]
