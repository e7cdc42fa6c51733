"""The port's command line (``python -m dsp_tpu_torch``) against the JAX
package's (``dsp_tpu.cli``), on the CPU.

Every subcommand of the port runs with ``--device cpu`` on one corpus that
``make-corpus --n 2 --words 3`` writes once for the module (with its
connected and spotting splits, a gapless connected split, and a tiny
Speech Commands layout).  The same arguments go through ``dsp_tpu.cli.main``
on the same files and models: stdout lines and ``--metrics-out`` JSON must
be equal, timings excluded (labels, accuracy, confusion, WER, precision,
recall and F1 exactly; printed scores and distances, which the two
packages' float32 arithmetic rounds apart, within 2e-3 of the printed
digits).  Banks are enrolled by each CLI and read by the other; the
GMM-HMM and VQ models the cases read are trained by the port's
``train-hmm`` / ``train-vq`` and loaded by the JAX CLI, and one model of
each family trained by the JAX CLI is loaded by the port's.  ``train-hmm``
starts the port's fit from JAX's own ``jax.random`` draws to hold it to
the JAX CLI's model (parameters within 1e-2, as
``tests/test_torch_gmm_hmm.py`` holds the recognizer's fit).  Then the
semantics that ``tests/test_cli.py`` holds for these subcommands
(rejection, connected and level decoding, grammars, the flag sentinels,
the serve loop, ``--mesh`` in one process, ``evaluate-sc2``'s bank sharded
over a gloo world of two processes) on the port, the device default, and a
clean subprocess that imports no jax.  ``warm`` runs on the CPU and prints
the JAX CLI's line formats; its batch step returns what the JAX CLI's
``_warm_batch`` returns, called in this process, with ``classify_batch``'s
labels equal.
"""

import argparse
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dsp_tpu import cli as jcli
from dsp_tpu.io.dataset import synth_connected, synth_word
from dsp_tpu.io.wav import write_wav
from dsp_tpu.models.knn_dtw import KnnDtwRecognizer as JKnnDtwRecognizer
from dsp_tpu_torch import cli as tcli
from dsp_tpu_torch.models import gmm_hmm as pg
from dsp_tpu_torch.models.knn_dtw import REJECT, KnnDtwRecognizer

import torch_mesh_rank as mesh_rank
from test_torch_io import sc2_root  # noqa: F401  (the tiny Speech Commands layout)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ["make-corpus", "enroll", "recognize", "evaluate", "evaluate-connected",
               "spot", "evaluate-spot", "serve", "train-hmm", "evaluate-hmm", "train-vq",
               "evaluate-vq", "bench", "warm", "evaluate-sc2", "plot", "demo"]
HMM_ARGS = ["--states", "3", "--mix", "2", "--iters", "3"]
CORPUS_ARGS = ["--n", "2", "--words", "3", "--connected", "3", "--spotting", "2"]
# printed scores and distances: the packages' float32 sums round apart
NUM_TOL = dict(rtol=1e-4, atol=2e-3)


def port(*args):
    return tcli.main(["--device", "cpu", *args])


def _jax_draw(shape, seed, device="cpu"):
    """The port's normal_draw with JAX's bits (the JAX fit's keys)."""
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(int(seed)),
                                                       tuple(shape)))).to(device)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the DP loops are thousands of small ops, which
    crawl when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def c(tmp_path_factory, sc2_root):  # noqa: F811
    """The corpus, written by both CLIs, and the models every case reads."""
    root = tmp_path_factory.mktemp("cli")
    p = lambda *parts: str(root.joinpath(*parts))  # noqa: E731
    port("make-corpus", "--out", p("corpus"), *CORPUS_ARGS)
    jcli.main(["make-corpus", "--out", p("jax_corpus"), *CORPUS_ARGS])
    port("make-corpus", "--out", p("gapless"), "--n", "1", "--words", "3",
         "--connected", "3", "--gapless")
    train, test = p("corpus", "train"), p("corpus", "test")
    labels = sorted(os.listdir(train))
    # the test split with an out-of-vocabulary word beside it
    oov_dir = root / "test_oov" / "papa"
    os.makedirs(oov_dir)
    write_wav(str(oov_dir / "w.wav"), 16000, synth_word("papa", 7))
    for lab in labels:
        os.symlink(os.path.join(test, lab), root / "test_oov" / lab)
    write_wav(p("oov.wav"), 16000, synth_word("papa", 7))
    write_wav(p("conn.wav"), 16000, synth_connected(labels[:2], 3))
    write_wav(p("gapless.wav"), 16000, synth_connected(labels[:2], 4, gap_ms=(0.0, 1.0)))
    with open(p("grammar_all.json"), "w") as f:
        json.dump({"start": "*", "end": "*"}, f)      # allows every sequence
    with open(p("grammar_start.json"), "w") as f:
        json.dump({"start": [labels[1]]}, f)          # the truth starts labels[0]
    jcli.main(["enroll", "--corpus", train, "--bank", p("bank_jax.npz")])
    port("enroll", "--corpus", train, "--bank", p("bank_port.npz"))
    jcli.main(["enroll", "--corpus", train, "--bank", p("bank_k3.npz"), "--k", "3",
               "--matcher", "cascade"])
    port("train-hmm", "--corpus", train, "--model", p("hmm.npz"), *HMM_ARGS)
    port("train-vq", "--corpus", train, "--model", p("vq.npz"))
    jcli.main(["train-hmm", "--corpus", train, "--model", p("hmm_jax.npz"), *HMM_ARGS])
    jcli.main(["train-vq", "--corpus", train, "--model", p("vq_jax.npz")])

    def wavs(*parts):
        d = p(*parts)
        return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".wav")]

    return argparse.Namespace(
        root=root, p=p, train=train, test=test, labels=labels,
        test_wavs=[w for lab in labels for w in wavs("corpus", "test", lab)],
        conn=p("corpus", "connected"), conn_wavs=wavs("corpus", "connected"),
        gapless=p("gapless", "connected"), gapless_wavs=wavs("gapless", "connected"),
        spotting=p("corpus", "spotting"), spot_wavs=wavs("corpus", "spotting"),
        bank=p("bank_jax.npz"), bank_port=p("bank_port.npz"), bank_k3=p("bank_k3.npz"),
        hmm=p("hmm.npz"), vq=p("vq.npz"), hmm_jax=p("hmm_jax.npz"), vq_jax=p("vq_jax.npz"),
        sc2=sc2_root, test_oov=p("test_oov"), oov=p("oov.wav"),
        conn_wav=p("conn.wav"), gapless_wav=p("gapless.wav"),
        grammar_all=p("grammar_all.json"), grammar_start=p("grammar_start.json"))


def run_both(capsys, monkeypatch, args, stdin=None, jax_impl=None):
    """stdout and metrics JSON of the JAX CLI and the port's (``--device
    cpu``) on the same arguments; ``{M}`` stands for a metrics path.
    ``jax_impl`` replaces the value of ``--dtw-impl`` on the JAX side."""
    outs = []
    for name, main in (("jax", jcli.main), ("port", port)):
        where = next((args[args.index(f) + 1] for f in ("--corpus", "--root") if f in args),
                     None)
        metrics = os.path.join(os.path.dirname(where) if where else ".", f"m_{name}.json")
        argv = [metrics if a == "{M}" else a for a in args]
        if name == "jax" and jax_impl is not None:
            argv[argv.index("--dtw-impl") + 1] = jax_impl
        if stdin is not None:
            monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        capsys.readouterr()
        if name == "jax":
            main(argv)
        else:
            main(*argv)
        out = capsys.readouterr().out
        got = None
        if "{M}" in args:
            with open(metrics) as f:
                got = json.load(f)
            os.unlink(metrics)
            for k in ("elapsed_s", "started_unix"):      # timings
                got.pop(k)
            # evaluate-sc2: a rate, and the JAX package's count of its XLA
            # devices (8 virtual ones here) against the port's ranks
            for k in ("alignments_per_sec", "devices"):
                got.pop(k, None)
        outs.append((out, got))
    return outs


def _same_cells(a, b, numeric_from: int):
    """Tab-separated lines equal, cells from ``numeric_from`` on (each a
    number or a space-joined list of ``label:number:...`` items) within
    NUM_TOL, labels exactly."""
    la, lb = a.strip().splitlines(), b.strip().splitlines()
    assert len(la) == len(lb), (a, b)
    for x, y in zip(la, lb):
        cx, cy = x.split("\t"), y.split("\t")
        assert len(cx) == len(cy) and cx[:numeric_from] == cy[:numeric_from], (x, y)
        for u, v in zip(cx[numeric_from:], cy[numeric_from:]):
            iu, iv = u.split(" "), v.split(" ")
            assert len(iu) == len(iv), (x, y)
            for s, t in zip(iu, iv):
                ps, pt = s.split(":"), t.split(":")
                assert len(ps) == len(pt), (x, y)
                for q, r in zip(ps, pt):
                    try:
                        np.testing.assert_allclose(float(q), float(r), **NUM_TOL)
                    except ValueError:
                        assert q == r, (x, y)


def _same_spot_lines(a, b):
    """spot's lines: path, label, start s, end s equal; score within NUM_TOL."""
    _same_cells(a, b, numeric_from=4)


def _same_evaluate_spot(a, b):
    """precision, recall, F1 and counts equal; the threshold (recalibrated
    by each package) within 1e-4 relative."""
    (ha, ta), (hb, tb) = (s.strip().rsplit("threshold: ", 1) for s in (a, b))
    assert ha == hb
    np.testing.assert_allclose(float(ta), float(tb), rtol=1e-4)


def _same_sc2(a, b):
    """evaluate-sc2's lines equal but the throughput."""
    cut = [[ln for ln in t.strip().splitlines() if not ln.startswith("throughput: ")]
           for t in (a, b)]
    assert cut[0] == cut[1] and len(cut[0]) == len(a.strip().splitlines()) - 1, (a, b)


CASES = {
    # name: (the arguments, the comparison of stdout (None: equal), and the
    # value of --dtw-impl on the JAX side where it differs)
    "evaluate": (lambda c: ["evaluate", "--corpus", c.test, "--bank", c.bank,
                            "--metrics-out", "{M}"], None),
    "evaluate-reject": (lambda c: ["evaluate", "--corpus", c.test_oov, "--bank", c.bank,
                                   "--reject"], None),
    "evaluate-reject-threshold": (lambda c: ["evaluate", "--corpus", c.test_oov, "--bank",
                                             c.bank, "--reject-threshold", "25"], None),
    "evaluate-enrolled-cascade": (lambda c: ["evaluate", "--corpus", c.test, "--bank",
                                             c.bank_k3], None),
    "evaluate-k-past-bank": (lambda c: ["evaluate", "--corpus", c.test, "--bank", c.bank_k3,
                                        "--k", "50", "--matcher", "dtw"], None),
    "evaluate-ltw": (lambda c: ["evaluate", "--corpus", c.test, "--bank", c.bank,
                                "--matcher", "ltw"], None),
    # the JAX package runs its fused and pallas kernels on a TPU only: its
    # scan computes the same distances on the CPU
    "evaluate-fused": (lambda c: ["evaluate", "--corpus", c.test, "--bank", c.bank,
                                  "--dtw-impl", "fused", "--band", "0",
                                  "--metrics-out", "{M}"], None, "scan"),
    "evaluate-pallas": (lambda c: ["evaluate", "--corpus", c.test, "--bank", c.bank,
                                   "--dtw-impl", "pallas", "--metrics-out", "{M}"],
                        None, "scan"),
    "evaluate-mesh": (lambda c: ["evaluate", "--corpus", c.test, "--bank", c.bank,
                                 "--mesh"], None),
    "recognize": (lambda c: ["recognize", "--bank", c.bank, *c.test_wavs], None),
    "recognize-reject": (lambda c: ["recognize", "--bank", c.bank, "--reject", c.oov,
                                    *c.test_wavs[:2]], None),
    "recognize-nbest": (lambda c: ["recognize", "--bank", c.bank, "--nbest", "3",
                                   *c.test_wavs], lambda a, b: _same_cells(a, b, 1)),
    "recognize-connected": (lambda c: ["recognize", "--bank", c.bank, "--connected",
                                       c.conn_wav, *c.conn_wavs], None),
    "recognize-level": (lambda c: ["recognize", "--bank", c.bank, "--connected",
                                   "--connected-method", "level", c.gapless_wav,
                                   *c.gapless_wavs], None),
    "recognize-level-grammar": (lambda c: ["recognize", "--bank", c.bank, "--connected",
                                           "--connected-method", "level", "--grammar",
                                           c.grammar_start, c.gapless_wav], None),
    "evaluate-connected": (lambda c: ["evaluate-connected", "--corpus", c.conn, "--bank",
                                      c.bank, "--metrics-out", "{M}"], None),
    "evaluate-connected-level": (lambda c: ["evaluate-connected", "--corpus", c.gapless,
                                            "--bank", c.bank, "--connected-method",
                                            "level", "--metrics-out", "{M}"], None),
    "evaluate-connected-grammar": (lambda c: ["evaluate-connected", "--corpus", c.gapless,
                                              "--bank", c.bank, "--connected-method",
                                              "level", "--grammar", c.grammar_all], None),
    "evaluate-connected-vq": (lambda c: ["evaluate-connected", "--corpus", c.conn, "--vq",
                                         c.vq], None),
    "evaluate-connected-hmm": (lambda c: ["evaluate-connected", "--corpus", c.conn, "--hmm",
                                          c.hmm, "--metrics-out", "{M}"], None),
    "evaluate-connected-hmm-level": (lambda c: ["evaluate-connected", "--corpus", c.gapless,
                                                "--hmm", c.hmm, "--connected-method",
                                                "level"], None),
    "spot": (lambda c: ["spot", "--bank", c.bank, "--threshold", "30", *c.spot_wavs],
             _same_spot_lines),
    "spot-stored-threshold": (lambda c: ["spot", "--bank", c.bank, c.spot_wavs[0]],
                              _same_spot_lines),
    "spot-mesh": (lambda c: ["spot", "--bank", c.bank, "--mesh", c.spot_wavs[0]],
                  _same_spot_lines),
    "spot-stream": (lambda c: ["spot", "--bank", c.bank, "--stream", c.spot_wavs[0]],
                    _same_spot_lines),
    "spot-hmm": (lambda c: ["spot", "--hmm", c.hmm, "--threshold", "-60", *c.spot_wavs],
                 _same_spot_lines),
    "spot-hmm-stream": (lambda c: ["spot", "--hmm", c.hmm, "--threshold", "-60",
                                   "--stream", c.spot_wavs[0]], _same_spot_lines),
    "spot-cascade": (lambda c: ["spot", "--bank", c.bank, "--hmm", c.hmm, *c.spot_wavs],
                     _same_spot_lines),
    "spot-cascade-stream": (lambda c: ["spot", "--bank", c.bank, "--hmm", c.hmm, "--stream",
                                       c.spot_wavs[0]], _same_spot_lines),
    "evaluate-spot": (lambda c: ["evaluate-spot", "--corpus", c.spotting, "--bank", c.bank,
                                 "--threshold", "30", "--metrics-out", "{M}"], None),
    "evaluate-spot-stored": (lambda c: ["evaluate-spot", "--corpus", c.spotting, "--bank",
                                        c.bank], None),
    "evaluate-spot-calibrate": (lambda c: ["evaluate-spot", "--corpus", c.spotting,
                                           "--bank", c.bank, "--calibrate-threshold"],
                                _same_evaluate_spot),
    "evaluate-spot-hmm": (lambda c: ["evaluate-spot", "--corpus", c.spotting, "--hmm",
                                     c.hmm, "--threshold", "-60", "--metrics-out", "{M}"],
                          None),
    "evaluate-spot-cascade": (lambda c: ["evaluate-spot", "--corpus", c.spotting, "--bank",
                                         c.bank, "--hmm", c.hmm], None),
    # the GMM-HMM and VQ families: models the port trained, and the JAX CLI's
    "evaluate-hmm": (lambda c: ["evaluate-hmm", "--corpus", c.test, "--model", c.hmm,
                                "--metrics-out", "{M}"], None),
    "evaluate-hmm-jax-model": (lambda c: ["evaluate-hmm", "--corpus", c.test_oov, "--model",
                                          c.hmm_jax, "--reject-threshold", "0",
                                          "--metrics-out", "{M}"], None),
    "evaluate-hmm-noise-adapt": (lambda c: ["evaluate-hmm", "--corpus", c.test, "--model",
                                            c.hmm, "--noise-adapt", "--metrics-out", "{M}"],
                                 None),
    "evaluate-hmm-reject": (lambda c: ["evaluate-hmm", "--corpus", c.test_oov, "--model",
                                       c.hmm, "--reject", "--metrics-out", "{M}"], None),
    "evaluate-vq": (lambda c: ["evaluate-vq", "--corpus", c.test, "--model", c.vq,
                               "--metrics-out", "{M}"], None),
    "evaluate-vq-jax-model": (lambda c: ["evaluate-vq", "--corpus", c.test_oov, "--model",
                                         c.vq_jax, "--metrics-out", "{M}"], None),
    # Speech Commands: the JAX CLI shards the bank over its 8 virtual
    # devices where the port (one process) takes the single-device path
    "evaluate-sc2": (lambda c: ["evaluate-sc2", "--root", c.sc2, "--metrics-out", "{M}"],
                     _same_sc2),
    "evaluate-sc2-k3-validation": (lambda c: ["evaluate-sc2", "--root", c.sc2, "--split",
                                              "validation", "--templates", "1", "--batch",
                                              "2", "--k", "3", "--no-mesh",
                                              "--metrics-out", "{M}"], _same_sc2),
    "demo": (lambda c: ["demo", "--bank", c.bank], None),
    "demo-wav": (lambda c: ["demo", "--bank", c.bank, "--wav", c.conn_wav, "--chunk", "800"],
                 None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_subcommand_matches_the_jax_cli(c, capsys, monkeypatch, case):
    build, same, *jax_impl = CASES[case]
    (j_out, j_metrics), (t_out, t_metrics) = run_both(capsys, monkeypatch, build(c),
                                                      jax_impl=(jax_impl or [None])[0])
    assert t_out.strip(), "the port printed nothing"
    if same is None:
        assert t_out == j_out
    else:
        same(t_out, j_out)
    if j_metrics is not None:
        if jax_impl:
            assert j_metrics["config"]["dtw"].pop("impl") == jax_impl[0]
            assert t_metrics["config"]["dtw"].pop("impl") != jax_impl[0]
        assert t_metrics == j_metrics


def _serve_lines(c):
    return (f"{c.test_wavs[0]}\nconnected {c.conn_wav}\nlevel {c.gapless_wav}\n"
            f"nbest {c.test_wavs[1]}\nspot {c.conn_wav}\n{c.root}/missing.wav\n")


@pytest.mark.parametrize("grammar", [False, True])
def test_serve_matches_the_jax_cli(c, capsys, monkeypatch, grammar):
    args = ["serve", "--bank", c.bank] + (["--grammar", c.grammar_start] if grammar else [])
    lines = _serve_lines(c) if not grammar else f"level {c.gapless_wav}\n"
    (j_out, _), (t_out, _) = run_both(capsys, monkeypatch, args, stdin=lines)
    # drop each answer's milliseconds; the missing file's error text is
    # each package's own
    cut = [[ln.split("\t")[:2] for ln in out.strip().splitlines()] for out in (t_out, j_out)]
    assert cut[0][0] == cut[1][0] == ["ready"]
    assert len(cut[0]) == len(cut[1]) == len(lines.strip().splitlines()) + 1
    for t, j in zip(cut[0][1:], cut[1][1:]):
        if t[1].startswith("ERROR"):
            assert j[1].startswith("ERROR") and t[0] == j[0]
        else:
            _same_cells("\t".join(t), "\t".join(j), numeric_from=1)


def test_make_corpus_files_equal_the_jax_cli(c):
    mine, theirs = c.p("corpus"), c.p("jax_corpus")
    files = sorted(os.path.relpath(os.path.join(d, f), mine)
                   for d, _, fs in os.walk(mine) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    assert len(files) == 3 * 2 * 2 + 3 + 1 + 2 + 1
    for rel in files:
        with open(os.path.join(mine, rel), "rb") as f, \
                open(os.path.join(theirs, rel), "rb") as g:
            assert f.read() == g.read(), rel


def test_make_corpus_hostile(tmp_path):
    port("make-corpus", "--out", str(tmp_path / "t"), "--n", "1", "--hostile",
         "--words", "4", "--condition", "tilt+snr10")
    jcli.main(["make-corpus", "--out", str(tmp_path / "j"), "--n", "1", "--hostile",
               "--words", "4", "--condition", "tilt+snr10"])
    for split, n in (("train", 3), ("test", 2)):
        labs = sorted(os.listdir(tmp_path / "t" / split))
        assert labs == sorted(os.listdir(tmp_path / "j" / split)) and len(labs) == 4
        for lab in labs:
            names = sorted(os.listdir(tmp_path / "t" / split / lab))
            assert len(names) == n
            for name in names:
                assert (tmp_path / "t" / split / lab / name).read_bytes() == \
                    (tmp_path / "j" / split / lab / name).read_bytes()
    with pytest.raises(SystemExit, match="does not combine"):
        port("make-corpus", "--out", str(tmp_path / "x"), "--hostile", "--connected", "2")
    # unset --words on --hostile is the full 35-class vocabulary
    port("make-corpus", "--out", str(tmp_path / "full"), "--n", "1", "--hostile")
    assert len(os.listdir(tmp_path / "full" / "train")) == 35


def test_banks_cross_between_the_clis(c, capsys):
    """A bank enrolled by the JAX CLI is recognized by the port's, and the
    other way round, with equal labels; the two banks hold the same
    templates and calibrations."""
    capsys.readouterr()
    port("recognize", "--bank", c.bank, *c.test_wavs)
    t_on_j = capsys.readouterr().out
    jcli.main(["recognize", "--bank", c.bank_port, *c.test_wavs])
    j_on_t = capsys.readouterr().out
    jcli.main(["recognize", "--bank", c.bank, *c.test_wavs])
    j_on_j = capsys.readouterr().out
    assert t_on_j == j_on_t == j_on_j
    assert [ln.split("\t")[1] for ln in t_on_j.splitlines()] == \
        [os.path.basename(os.path.dirname(w)) for w in c.test_wavs]
    a, b = np.load(c.bank_port), np.load(c.bank)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            assert np.array_equal(a[k], b[k]), k


def test_make_corpus_enroll_evaluate_end_to_end(c, capsys):
    """Each CLI's own chain, make-corpus -> enroll -> evaluate, prints the
    same accuracy JSON and metrics on its own corpus and bank."""
    outs = []
    for corpus, bank, main in ((c.p("corpus"), c.bank_port, port),
                               (c.p("jax_corpus"), c.bank, lambda *a: jcli.main(list(a)))):
        metrics = c.p(f"e2e_{len(outs)}.json")
        capsys.readouterr()
        main("evaluate", "--corpus", os.path.join(corpus, "test"), "--bank", bank,
             "--metrics-out", metrics)
        with open(metrics) as f:
            got = json.load(f)
        outs.append((capsys.readouterr().out, {k: v for k, v in got.items()
                                                if k not in ("elapsed_s", "started_unix")}))
    assert outs[0] == outs[1]
    assert "accuracy: 1.0000 (6 utterances)" in outs[0][0]


@pytest.mark.parametrize("flags", [[], ["--train-mode", "baum_welch", "--map-tau", "5",
                                         "--no-reject-calibration"]],
                         ids=["viterbi", "baum-welch-map"])
def test_train_hmm_matches_the_jax_cli(c, tmp_path, capsys, flags):
    """train-hmm from JAX's draws: the same checkpoint keys, labels and
    reject calibration, parameters within 1e-2; each CLI's evaluate-hmm on
    its own model prints the same confusion and accuracy."""
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "normal_draw", _jax_draw)
        port("train-hmm", "--corpus", c.train, "--model", mine, *HMM_ARGS, *flags)
    jcli.main(["train-hmm", "--corpus", c.train, "--model", theirs, *HMM_ARGS, *flags])
    a, b = np.load(mine), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if a[k].dtype.kind == "f" and a[k].ndim:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-2, atol=1e-2, err_msg=k)
        elif k == "reject_threshold":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-2, atol=1e-2)
            assert np.isfinite(a[k]) != ("--no-reject-calibration" in flags)
        else:
            assert np.array_equal(a[k], b[k]), k
    outs = []
    for main, model in ((port, mine), (lambda *x: jcli.main(list(x)), theirs)):
        capsys.readouterr()
        main("evaluate-hmm", "--corpus", c.test_oov, "--model", model, *HMM_ARGS,
             *([] if flags else ["--reject"]))
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "accuracy: " in outs[0]


def test_train_vq_matches_the_jax_cli(c, tmp_path, capsys):
    """train-vq: the same checkpoint keys and labels, codebooks within 1e-3
    (tests/test_torch_vq.py's tolerance for fits on each package's own
    features), the same evaluate-vq output."""
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port("train-vq", "--corpus", c.train, "--model", mine, "--codes", "16", "--iters", "4")
    jcli.main(["train-vq", "--corpus", c.train, "--model", theirs, "--codes", "16",
               "--iters", "4"])
    a, b = np.load(mine), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-3, err_msg=k)
        else:
            assert np.array_equal(a[k], b[k]), k
    assert int(a["n_codes"]) == 16 and int(a["n_iter"]) == 4
    outs = []
    for main, model in ((port, mine), (lambda *x: jcli.main(list(x)), theirs)):
        capsys.readouterr()
        main("evaluate-vq", "--corpus", c.test, "--model", model)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "accuracy: " in outs[0]


def test_plot_writes_png_and_the_jax_distances(c, tmp_path):
    """plot of a synthetic word with --bank and of a WAV writes a PNG; the
    distances row is the JAX recognizer's within NUM_TOL."""
    from dsp_tpu.config import PipelineConfig as JPipelineConfig
    from dsp_tpu_torch.viz import pipeline_view, plot_pipeline

    for name, extra in (("bank", ["--bank", c.bank]), ("wav", ["--wav", c.test_wavs[0]])):
        out = str(tmp_path / f"{name}.png")
        port("plot", "--word", "two", *extra, "--out", out)
        with open(out, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    rec = KnnDtwRecognizer.load(c.bank, device="cpu")
    x = synth_word("two", 77)        # not a template: seed 0 is one, at distance ~0
    got = plot_pipeline(x, str(tmp_path / "direct.png"), recognizer=rec)
    jlabels, want = JKnnDtwRecognizer.load(c.bank, JPipelineConfig()).classify_batch(
        [x], return_distances=True)
    assert got["label"] == jlabels[0] == "two"
    assert got["distances"].shape == (rec.n_templates,)
    np.testing.assert_allclose(got["distances"], np.asarray(want)[0], **NUM_TOL)
    # where matplotlib is missing (the card's host) plot refuses before any
    # work, and pipeline_view still gives the panels' data
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(SystemExit, match="plot needs matplotlib"):
            port("plot", "--word", "two", "--bank", c.bank, "--out", str(tmp_path / "x.png"))
        view = pipeline_view(x, recognizer=rec)
    assert not os.path.exists(tmp_path / "x.png")
    for k, v in got.items():
        np.testing.assert_array_equal(view[k], v, err_msg=k)


def test_demo_mic_without_pyaudio_exits_as_the_jax_cli(c):
    with pytest.raises(SystemExit) as mine:
        port("demo", "--bank", c.bank, "--mic")
    with pytest.raises(SystemExit) as theirs:
        jcli.main(["demo", "--bank", c.bank, "--mic"])
    assert str(mine.value) == str(theirs.value) and "PyAudio" in str(mine.value)


def test_evaluate_sc2_shards_the_bank_over_a_gloo_world(c, tmp_path, capsys):
    """evaluate-sc2 in a gloo world of two processes takes the sharded
    branch (a (1, 2) mesh) and gives the labels and accuracy of one process."""
    spied = []

    def spy(*args, **kw):
        got, d = real(*args, **kw)
        spied.append(got.numpy().copy())
        return got, d

    from dsp_tpu_torch import pipeline as tpl
    real = tpl.recognize_batch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpl, "recognize_batch", spy)
        capsys.readouterr()
        port("evaluate-sc2", "--root", c.sc2, "--batch", "2")
    single = capsys.readouterr().out
    outs = mesh_rank.run_world(tmp_path, 2, "sc2", {
        "root": np.asarray(c.sc2), "argv": np.asarray(["--batch", "2"])})
    want = np.concatenate(spied)
    for r in outs:
        assert int(r["mesh_ranks"]) == 2
        np.testing.assert_array_equal(r["labels"], want)
        assert str(r["stdout"]).splitlines()[0] == single.splitlines()[0]
        assert str(r["stdout"]).splitlines()[0].startswith("accuracy: ")


def test_enroll_flags_and_sentinels(c, tmp_path, capsys):
    """--no-*-calibration leave the thresholds unset; --k/--matcher are
    stored; the None sentinels keep a bank's enrolled values unless a flag
    is passed (tests/test_cli.py:test_flag_sentinels_preserve_enrolled_config)."""
    bank = str(tmp_path / "b.npz")
    port("enroll", "--corpus", c.train, "--bank", bank, "--k", "3", "--matcher", "cascade",
         "--no-spot-calibration", "--no-reject-calibration")
    rec = KnnDtwRecognizer.load(bank, device="cpu")
    assert rec.k == 3 and rec.matcher == "cascade"
    assert rec.spot_threshold is None and rec.reject_threshold is None
    full = KnnDtwRecognizer.load(c.bank_port, device="cpu")
    assert full.spot_threshold is not None and full.reject_threshold is not None
    tcli._apply_matcher_flags(rec, argparse.Namespace(k=None, matcher=None, shortlist=None))
    assert (rec.k, rec.matcher, rec.shortlist) == (3, "cascade", 8)
    tcli._apply_matcher_flags(rec, argparse.Namespace(k=1, matcher="dtw", shortlist=4))
    assert (rec.k, rec.matcher, rec.shortlist) == (1, "dtw", 4)
    capsys.readouterr()
    port("evaluate", "--corpus", c.test, "--bank", bank, "--k", "50")
    assert "accuracy: 1.0000" in capsys.readouterr().out


def test_reject_connected_and_level_semantics(c, capsys):
    """tests/test_cli.py's rejection and connected cases on the port."""
    capsys.readouterr()
    port("recognize", "--bank", c.bank, "--reject", c.oov, c.test_wavs[0])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split("\t")[1] == REJECT
    assert out[1].split("\t")[1] == c.labels[0]
    port("evaluate", "--corpus", c.test_oov, "--bank", c.bank, "--reject")
    out = capsys.readouterr().out
    assert "<reject>" in out and float(out.rsplit("accuracy:", 1)[1].split("(")[0]) >= 0.8
    port("recognize", "--bank", c.bank, "--connected", c.conn_wav)
    assert capsys.readouterr().out.strip().split("\t")[1].split(" ") == c.labels[:2]
    port("recognize", "--bank", c.bank, "--connected", "--connected-method", "level",
         c.gapless_wav)
    assert capsys.readouterr().out.strip().split("\t")[1].split(" ") == c.labels[:2]
    port("evaluate-connected", "--corpus", c.conn, "--bank", c.bank)
    assert float(capsys.readouterr().out.rsplit("wer:", 1)[1].split("(")[0]) <= 0.25
    port("evaluate-connected", "--corpus", c.conn, "--vq", c.vq)
    assert float(capsys.readouterr().out.rsplit("wer:", 1)[1].split("(")[0]) <= 0.25


def test_grammar_flag_constrains_level_decode(c, capsys):
    """tests/test_cli.py's grammar case on the port: an all-allowed spec is
    a no-op; a start-restricted one reroutes serve's level decode."""
    capsys.readouterr()
    port("evaluate-connected", "--corpus", c.gapless, "--bank", c.bank,
         "--connected-method", "level")
    wer_plain = float(capsys.readouterr().out.rsplit("wer:", 1)[1].split("(")[0])
    port("evaluate-connected", "--corpus", c.gapless, "--bank", c.bank,
         "--connected-method", "level", "--grammar", c.grammar_all)
    assert float(capsys.readouterr().out.rsplit("wer:", 1)[1].split("(")[0]) == wer_plain
    wav = c.gapless_wavs[0]
    with open(os.path.join(c.gapless, "labels.tsv")) as f:
        truth = f.readline().rstrip("\n").split("\t")[1]
    port("recognize", "--bank", c.bank, "--connected", "--connected-method", "level",
         "--grammar", c.grammar_all, wav)
    assert capsys.readouterr().out.strip().split("\t")[1] == truth
    port("recognize", "--bank", c.bank, "--connected", "--connected-method", "level",
         "--grammar", c.grammar_start, c.gapless_wav)
    got = capsys.readouterr().out.strip().split("\t")[1].split(" ")
    assert got != c.labels[:2] and got[0] == c.labels[1]


def test_serve_loop(c, capsys, monkeypatch):
    """tests/test_cli.py:test_serve_loop on the port."""
    monkeypatch.setattr("sys.stdin", io.StringIO(_serve_lines(c)))
    capsys.readouterr()
    port("serve", "--bank", c.bank)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "ready"
    assert lines[1].split("\t")[1] == c.labels[0]
    assert lines[2].split("\t")[1] == " ".join(c.labels[:2])
    assert lines[3].split("\t")[1] == " ".join(c.labels[:2])      # gapless
    nbest = lines[4].split("\t")[1].split(" ")
    assert len(nbest) == 3 and nbest[0].split(":")[0] == c.labels[0]
    spotted = [cell.split(":")[0] for cell in lines[5].split("\t")[1].split(" ")]
    assert spotted == c.labels[:2]
    assert "ERROR" in lines[6]
    assert all(float(ln.split("\t")[2]) > 0 for ln in lines[1:6])


def test_mesh_flag_in_one_process_runs_unsharded(c, capsys):
    args = argparse.Namespace(mesh=True, device="cpu")
    assert tcli._maybe_mesh(args) is None
    assert not torch.distributed.is_initialized()
    assert tcli._maybe_mesh(argparse.Namespace(mesh=False, device="cpu")) is None
    capsys.readouterr()
    port("spot", "--bank", c.bank, c.spot_wavs[0])
    single = capsys.readouterr().out
    port("spot", "--bank", c.bank, "--mesh", c.spot_wavs[0])
    assert capsys.readouterr().out == single and c.spot_wavs[0] in single


ERRORS = {
    "reject-with-connected": (lambda c: ["recognize", "--bank", c.bank, "--reject",
                                         "--connected", c.conn_wav], "plain classification"),
    "two-models": (lambda c: ["evaluate-connected", "--corpus", c.conn, "--bank", c.bank,
                              "--vq", c.vq], "exactly one"),
    "grammar-without-level": (lambda c: ["evaluate-connected", "--corpus", c.conn, "--bank",
                                         c.bank, "--grammar", c.grammar_all],
                              "grammar requires"),
    "vq-level": (lambda c: ["evaluate-connected", "--corpus", c.conn, "--vq", c.vq,
                            "--connected-method", "level"], "VQ family"),
    "spot-no-model": (lambda c: ["spot", c.spot_wavs[0]], "give --bank, --hmm"),
    "threshold-and-calibrate": (lambda c: ["evaluate-spot", "--corpus", c.spotting, "--bank",
                                           c.bank, "--threshold", "30",
                                           "--calibrate-threshold"], "not both"),
    "calibrate-hmm": (lambda c: ["spot", "--hmm", c.hmm, "--calibrate-threshold",
                                 c.spot_wavs[0]], "DTW spotter only"),
    "calibrate-stream": (lambda c: ["spot", "--bank", c.bank, "--stream",
                                    "--calibrate-threshold", c.spot_wavs[0]],
                         "not wired into"),
    "empty-corpus": (lambda c: ["evaluate", "--corpus", str(c.root / "test_oov" / "papa"),
                                "--bank", c.bank], "no <label>/"),
    "sc2-matcher": (lambda c: ["evaluate-sc2", "--root", c.sc2, "--matcher", "ltw"],
                    "full banded DTW only"),
    "train-hmm-empty-corpus": (lambda c: ["train-hmm", "--corpus",
                                          str(c.root / "test_oov" / "papa"), "--model",
                                          str(c.root / "x.npz")], "no <label>/"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_flag_errors_match_the_jax_cli(c, case):
    build, match = ERRORS[case]
    with pytest.raises(SystemExit, match=match):
        port(*build(c))
    with pytest.raises(SystemExit, match=match):
        jcli.main(build(c))


def test_default_device_is_the_card(c, capsys):
    """Without --device every command runs on the card: a CPU-only torch
    raises torch's CUDA error, and nothing falls back to the CPU."""
    assert tcli.build_parser().parse_args(["evaluate", "--corpus", "x", "--bank", "y"]) \
        .device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tcli.main(["recognize", "--bank", c.bank, c.test_wavs[0]])
    assert capsys.readouterr().out == ""
    r = subprocess.run([sys.executable, "-m", "dsp_tpu_torch", "evaluate", "--corpus", c.test,
                        "--bank", c.bank], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "CUDA" in r.stderr and "accuracy" not in r.stdout


def test_help_lists_the_ported_subcommands_and_imports_no_jax():
    code = (
        "import subprocess, sys\n"
        "r = subprocess.run([sys.executable, '-m', 'dsp_tpu_torch', '--help'],\n"
        "                   capture_output=True, text=True)\n"
        "assert r.returncode == 0, r.stderr\n"
        "line = next(ln for ln in r.stdout.splitlines() if ln.strip().startswith('{'))\n"
        "print(line.strip())\n"
        "import dsp_tpu_torch.cli, dsp_tpu_torch.io.native, dsp_tpu_torch.utils.profiling\n"
        "import dsp_tpu_torch.viz, dsp_tpu_torch.bench, dsp_tpu_torch.bench_all\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'dsp_tpu'}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stderr
    choices, leaked = r.stdout.strip().splitlines()
    assert choices == "{" + ",".join(SUBCOMMANDS) + "}"
    assert leaked == "[]"


WARM_LINES = [r"warm: batch=1 bank=10 matcher=dtw k=1 \(\d+\.\ds\)",
              r"warm: batch=2 bank=10 matcher=dtw k=1 \(\d+\.\ds\)",
              r"warm: connected\+spot len=1x max_samples \(\d+\.\ds\)",
              r"warm: fe-profile stages chunk=4 templates=10 \(\d+\.\ds\)",
              r"warm: done in \d+\.\ds — no kernel library is built for cpu"]


def test_warm_prints_the_jax_lines_and_its_batch_step_returns_jax(capsys, monkeypatch):
    """``warm`` on the CPU: the JAX CLI's line formats (``dsp_tpu/cli.py``
    ``cmd_warm``), no library built, the relay flags accepted and not
    read; ``_warm_batch`` returns what the JAX CLI's returns on the same
    signals, with ``classify_batch``'s labels equal."""
    import re

    from dsp_tpu.config import PipelineConfig as JPipelineConfig
    from dsp_tpu.io.dataset import DIGITS
    from dsp_tpu_torch.config import PipelineConfig

    port("warm", "--bank-size", "10", "--batches", "1,2", "--connected", "1",
         "--stages", "4x10", "--timeout", "5", "--retries", "2")
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == len(WARM_LINES)
    assert all(re.fullmatch(p, ln) for p, ln in zip(WARM_LINES, lines)), lines
    assert "does not read them" in out.err

    labels = {}
    for name, cls in (("jax", JKnnDtwRecognizer), ("port", KnnDtwRecognizer)):
        def kept(self, *a, _orig=cls.classify_batch, _name=name, **k):
            labels[_name] = _orig(self, *a, **k)
            return labels[_name]
        monkeypatch.setattr(cls, "classify_batch", kept)
    sigs = [synth_word(DIGITS[i % len(DIGITS)], 7000 + i, max_samples=32000)
            for i in range(2)]
    want = jcli._warm_batch(None, JPipelineConfig(), 10, None, None, None, sigs)
    got = tcli._warm_batch(None, PipelineConfig(), 10, None, None, None, sigs, "cpu")
    assert got == want == (10, "dtw", 1)
    assert list(labels["port"]) == list(labels["jax"]) and len(labels["jax"]) == 2


def test_warm_drives_a_loaded_bank_and_the_grammar(c, capsys, monkeypatch):
    """``warm --bank`` drives that bank (its size, matcher and k in the
    batch line) and ``--grammar`` adds the constrained level decode to the
    VAD split and the plain level decode."""
    import re

    grammars = []
    orig = KnnDtwRecognizer.classify_connected

    def kept(self, *a, **k):
        grammars.append((k.get("method", "vad"), k.get("grammar")))
        return orig(self, *a, **k)

    monkeypatch.setattr(KnnDtwRecognizer, "classify_connected", kept)
    capsys.readouterr()
    port("warm", "--bank", c.bank_k3, "--batches", "1", "--connected", "1",
         "--grammar", c.grammar_all)
    lines = capsys.readouterr().out.strip().splitlines()
    rec = KnnDtwRecognizer.load(c.bank_k3, device="cpu")
    assert rec.k == 3
    assert re.fullmatch(rf"warm: batch=1 bank={rec.n_templates} matcher={rec.matcher} "
                        rf"k=3 \(\d+\.\ds\)", lines[0]), lines
    assert re.fullmatch(WARM_LINES[2], lines[1]) and re.fullmatch(WARM_LINES[4], lines[2])
    assert grammars == [("vad", None), ("level", None), ("level", c.grammar_all)]


@pytest.mark.parametrize("sub", ["recognize", "evaluate"])
def test_trace_flag_writes_the_spans_and_the_counts(c, tmp_path, capsys, sub):
    """``recognize`` / ``evaluate --trace DIR``: stdout as without the
    flag, a Chrome trace in DIR holding the front end's and the matcher's
    spans, and the run's counter changes on stderr and, for ``evaluate``,
    under ``counts`` in ``--metrics-out`` (none on the CPU: nothing
    crosses to another device)."""
    metrics = str(tmp_path / "m.json")
    args = {"recognize": ["--bank", c.bank, *c.test_wavs],
            "evaluate": ["--corpus", c.test, "--bank", c.bank, "--metrics-out", metrics]}[sub]
    capsys.readouterr()
    port(sub, *args)
    plain = capsys.readouterr().out
    port(sub, "--trace", str(tmp_path / "trace"), *args)
    out, err = capsys.readouterr()
    assert out == plain
    (path,) = (tmp_path / "trace").glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"dsp.frontend", "dsp.dtw"} <= names
    assert "counts: {}" in err.splitlines()
    if sub == "evaluate":
        with open(metrics) as f:
            assert json.load(f)["counts"] == {}
