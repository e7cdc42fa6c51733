"""The port's command line (``python -m dsp_tpu_torch``) against the JAX
package's (``dsp_tpu.cli``), on the CPU.

Every subcommand of the port runs with ``--device cpu`` on one corpus that
``make-corpus --n 2 --words 3`` writes once for the module (with its
connected and spotting splits, and a gapless connected split).  The same
arguments go through ``dsp_tpu.cli.main`` on the same files and models:
stdout lines and ``--metrics-out`` JSON must be equal, timings excluded
(labels, accuracy, WER, precision, recall and F1 exactly; printed scores
and distances, which the two packages' float32 arithmetic rounds apart,
within 2e-3 of the printed digits).  Banks are enrolled by each CLI and
read by the other; the GMM-HMM and VQ models are trained by the JAX CLI
(``train-hmm``, ``train-vq`` are not ported yet) and loaded by the port's
own ``load``.  Then the semantics that ``tests/test_cli.py`` holds for
these subcommands (rejection, connected and level decoding, grammars, the
flag sentinels, the serve loop, ``--mesh`` in one process) on the port,
the device default, and a clean subprocess that imports no jax.
"""

import argparse
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dsp_tpu import cli as jcli
from dsp_tpu.io.dataset import synth_connected, synth_word
from dsp_tpu.io.wav import write_wav
from dsp_tpu_torch import cli as tcli
from dsp_tpu_torch.models.knn_dtw import REJECT, KnnDtwRecognizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ["make-corpus", "enroll", "recognize", "evaluate", "evaluate-connected",
               "spot", "evaluate-spot", "serve"]
CORPUS_ARGS = ["--n", "2", "--words", "3", "--connected", "3", "--spotting", "2"]
# printed scores and distances: the packages' float32 sums round apart
NUM_TOL = dict(rtol=1e-4, atol=2e-3)


def port(*args):
    return tcli.main(["--device", "cpu", *args])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the DP loops are thousands of small ops, which
    crawl when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def c(tmp_path_factory):
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
    jcli.main(["train-hmm", "--corpus", train, "--model", p("hmm.npz"), "--states", "3",
               "--mix", "2", "--iters", "3"])
    jcli.main(["train-vq", "--corpus", train, "--model", p("vq.npz")])

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
        hmm=p("hmm.npz"), vq=p("vq.npz"), test_oov=p("test_oov"), oov=p("oov.wav"),
        conn_wav=p("conn.wav"), gapless_wav=p("gapless.wav"),
        grammar_all=p("grammar_all.json"), grammar_start=p("grammar_start.json"))


def run_both(capsys, monkeypatch, args, stdin=None, jax_impl=None):
    """stdout and metrics JSON of the JAX CLI and the port's (``--device
    cpu``) on the same arguments; ``{M}`` stands for a metrics path.
    ``jax_impl`` replaces the value of ``--dtw-impl`` on the JAX side."""
    outs = []
    for name, main in (("jax", jcli.main), ("port", port)):
        metrics = os.path.join(os.path.dirname(args[args.index("--corpus") + 1])
                               if "--corpus" in args else ".", f"m_{name}.json")
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
        "import dsp_tpu_torch.viz\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'dsp_tpu'}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stderr
    choices, leaked = r.stdout.strip().splitlines()
    assert choices == "{" + ",".join(SUBCOMMANDS) + "}"
    assert leaked == "[]"
