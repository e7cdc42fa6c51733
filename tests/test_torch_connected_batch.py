"""The GMM-HMM's connected decode on its device batch path
(``models/gmm_hmm.py:recognize_level_batch``: the network of two
topologies, the level DP ``ops/connected_viterbi.level_dp`` and the
batched backtrace ``backtrace_batch``) on the CPU: against the plain
float64 reference (``benchmark/reference/connected.py``), against the
host backtrace ``level_building.backtrack_grammar`` bit for bit, and
``classify_connected(method="level")`` against the planes read back and
traced on the host, as that method did before the batch path.

Tolerance: final scores at rtol 2e-5 against the reference.  The program
takes its features from a float32 front end and sums the expanded
Gaussian exponent in float32 (``gmm_hmm.gmm_loglik_flat``) over a
40-frame path; against the reference's float64 direct form they part by
~1e-6 relative here, while one TF32 product in the front end alone parts
them by ~1e-3."""

import numpy as np
import pytest
import torch

from benchmark.reference import connected as cref
from benchmark.reference import plain
from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import FrontendConfig, HmmConfig, PipelineConfig
from dsp_tpu_torch.models import gmm_hmm as gh
from dsp_tpu_torch.ops import connected_viterbi as cv
from dsp_tpu_torch.ops import level_building as lb
from dsp_tpu_torch.utils import profiling

NEG_INF = gh.NEG_INF
T, B, L = 40, 4, 5
N = 200 + (T - 1) * 80          # samples of T frames at 8 kHz
FE = FrontendConfig(sample_rate=8000, frame_len=200, hop_len=80, n_fft=256, n_mels=23,
                    n_mfcc=2, lifter=22)        # 6 features
CFG = PipelineConfig(frontend=FE, max_samples=N, use_vad=False)
WORDS = ["one", "three", "two"]
SIL_LAST = (np.array([0, 0, 0, 1], bool), np.array([[1, 1, 1, 1]] * 3 + [[1, 1, 1, 0]], bool),
            np.array([0, 0, 0, 1], bool))   # start sil, end sil, no sil -> sil


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the DP loops are thousands of small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signals(seed, b=B):
    """Recordings of tones and noise, of several lengths (zero-padded)."""
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal((b, N))
    t = np.arange(N) / 8000.0
    for i in range(b):
        for lo in range(0, N, 800):
            k = min(600, N - lo)
            x[i, lo:lo + k] += 0.5 * np.sin(2 * np.pi * rng.uniform(300, 3000) * t[:k])
    n = np.array([N, N - 700, 2300, 1200, 900, N][:b], np.int32)
    for i in range(b):
        x[i, n[i]:] = 0.0
    return x.astype(np.float32), n


def _models(seed, feats, w, s, m, sil=False):
    """Random models whose means are frames of ``feats`` (so every unit
    scores close to the others), log-variances around the frames'."""
    g = torch.Generator().manual_seed(seed)
    f = feats.reshape(-1, feats.shape[-1])
    f = f[f.abs().sum(-1) > 0]
    means = f[torch.randint(0, f.shape[0], (w * s * m,), generator=g)].reshape(w, s, m, -1)
    log_var = torch.log(f.var(0)) + 0.3 * torch.randn(w, s, m, f.shape[1], generator=g)
    log_pi, _ = gh._lr_start((w,), s, "cpu")
    p = gh.HmmParams(log_pi, gh._lr_log_a(0.3 + 0.6 * torch.rand(w, s, generator=g), s),
                     means.contiguous(), log_var.contiguous(),
                     torch.log_softmax(torch.randn(w, s, m, generator=g), -1))
    return gh.add_skips(p) if sil else p


@pytest.fixture(scope="module")
def case():
    x, n = _signals(1)
    feats = pl.extract_recording_features(torch.from_numpy(x), torch.from_numpy(n), CFG, T)
    digits = _models(2, feats.feats, 3, 4, 2)
    sil = _models(3, feats.feats, 1, 3, 2, sil=True)
    return x, n, digits, sil


def _masks(m):
    return tuple(torch.as_tensor(a) for a in m)


def test_recognize_level_batch_matches_the_reference(case):
    x, n, digits, sil = case
    net = gh.network(digits, sil)
    ids, counts, final = gh.recognize_level_batch(torch.from_numpy(x), torch.from_numpy(n),
                                                  net, CFG, _masks(SIL_LAST), L)
    assert ids.dtype == counts.dtype == torch.int32 and final.shape == (B, L)
    fe = plain.Frontend(8000, "cpu", frame_len=200, hop=80, n_fft=256, n_mels=23, n_mfcc=2,
                        lifter=22)
    feats, lens = cref.features(fe, x, n, T)
    groups = [gh.params_to_numpy(g)._asdict() for g in (digits, sil)]
    want, seqs = cref.level_decode(feats, lens, groups, *SIL_LAST, L)
    live = final.double() > -1e29
    assert torch.equal(live, torch.isfinite(want)) and (~live).any()
    np.testing.assert_allclose(final.double()[live], want[live], rtol=2e-5)
    got = [ids[b, :counts[b]].tolist() for b in range(B)]
    assert got == seqs and len({tuple(s) for s in seqs}) > 1
    assert all(s[0] == s[-1] == 3 for s in seqs)
    assert (ids[torch.arange(L)[None, :] >= counts[:, None]] == -1).all()
    forced = cref.forced_score(feats, lens, groups, got)
    np.testing.assert_allclose(forced.numpy(), want.amax(-1).numpy(), rtol=1e-12)


def _tied_planes(seed, b=6, levels=4, t=12, u=5):
    """The level DP's planes on integer emissions and transitions, so
    that scores tie often, under a random grammar."""
    rng = np.random.default_rng(seed)
    logb = torch.from_numpy(rng.integers(-3, 0, (t, b, u, 3)).astype(np.float32))
    log_pi = torch.tensor([[0.0, NEG_INF, NEG_INF]] * u)
    log_a = torch.from_numpy(np.where(rng.random((u, 3, 3)) < 0.6,
                                      -rng.integers(0, 2, (u, 3, 3)), NEG_INF).astype(np.float32))
    start, pairs, end = rng.random(u) < 0.6, rng.random((u, u)) < 0.5, rng.random(u) < 0.5
    start[0] = end[1] = True
    scores, starts = cv.level_dp(logb, log_pi, log_a, torch.from_numpy(start),
                                 torch.from_numpy(pairs), levels)
    return scores, starts, pairs, end


@pytest.mark.parametrize("seed", range(4))
def test_backtrace_batch_equals_the_host_backtrace(seed):
    """Every row of ``backtrace_batch`` against ``backtrack_grammar`` on the
    same planes negated: the same units and costs, including the ties the
    integer scores plant and the rows nothing decodes (no frame, or too
    few for the grammar)."""
    scores, starts, pairs, end = _tied_planes(seed)
    t_valid = torch.tensor([12, 9, 5, 1, 0, 3], dtype=torch.int32)
    ids, counts, final = cv.backtrace_batch(scores, starts, t_valid, torch.from_numpy(pairs),
                                            torch.from_numpy(end))
    undecoded = 0
    for b in range(scores.shape[0]):
        seq, cost = lb.backtrack_grammar(-scores[b].numpy(), starts[b].numpy(), pairs, end,
                                         int(t_valid[b]))
        assert ids[b, :counts[b]].tolist() == seq
        assert (ids[b, counts[b]:] == -1).all()
        if seq:
            assert cost == -final[b, counts[b] - 1].item()
        else:
            undecoded += 1
            assert counts[b] == 0
    assert undecoded >= 1
    assert (final[4] == NEG_INF).all()


def _rec(digits, sil):
    rec = gh.GmmHmmRecognizer(CFG, HmmConfig(n_states=4, n_mix=2), device="cpu")
    rec.labels, rec.params, rec.sil = list(WORDS), digits, sil
    return rec


def _host_route(rec, sigs, grammar):
    """The level route as it was before the batch path: the planes read
    back and traced one recording at a time on the host."""
    if grammar is None and rec.sil is None:
        def dp_fn(feats):
            s, w, st = cv.connected_viterbi(feats.feats, feats.length, rec.params, L)
            return -s, w, st
        backtrack = None
    else:
        units = rec.unit_labels()
        masks = (rec.resolve_grammar(grammar) if grammar is not None else
                 (np.ones(len(units), bool), np.ones((len(units),) * 2, bool),
                  np.ones(len(units), bool)))
        net = rec.network()

        def dp_fn(feats):
            s, st = cv.level_dp(gh.network_logb(feats.feats, net), net.log_pi, net.log_a,
                                torch.as_tensor(masks[0]), torch.as_tensor(masks[1]), L)
            return -s, st

        def backtrack(costs, starts, t_valid):
            return lb.backtrack_grammar(costs, starts, masks[1], masks[2], t_valid)
    ids, _ = pl.decode_level_generic(sigs, rec.cfg, dp_fn,
                                     torch.arange(len(rec.unit_labels())), backtrack, "cpu")
    units = rec.unit_labels()
    return [[units[i] for i in seq if units[i] != gh.SIL] for seq in ids]


@pytest.mark.parametrize("with_sil", [False, True], ids=["words", "words+sil"])
@pytest.mark.parametrize("grammar", [None, {"no_repeat": True}], ids=["loop", "no_repeat"])
def test_classify_connected_labels_equal_the_host_route(case, with_sil, grammar):
    """``classify_connected(method="level")`` (grouping, one padded batch a
    group, ``recognize_level_batch``, one readback) against the planes
    read back and traced on the host, on recordings of two padded
    lengths; ``sil`` never among the labels."""
    x, n, digits, sil = case
    rec = _rec(digits, sil if with_sil else None)
    sigs = [x[i, :n[i]] for i in range(B)] + [np.concatenate([x[0], x[1, :500]])]
    got = rec.classify_connected(sigs, max_segments=L, method="level", grammar=grammar)
    assert got == _host_route(rec, sigs, grammar)
    assert all(w in WORDS for labels in got for w in labels)
    assert len({tuple(g) for g in got}) > 1


def test_network_emissions_equal_each_model_scored_alone(case):
    """``network_logb``: each topology's ``emission_logb`` (no Gaussian
    padded) in its units' last slots, NEG_INF in the rest; the network's
    ``log_pi`` / ``log_a`` place each model the same way."""
    x, n, digits, sil = case
    feats = pl.extract_recording_features(torch.from_numpy(x), torch.from_numpy(n), CFG, T)
    net = gh.network(digits, sil)
    logb = gh.network_logb(feats.feats, net)
    assert logb.shape == (T, B, 4, 4)
    assert torch.equal(logb[:, :, :3], gh.emission_logb(feats.feats, digits).movedim(1, 0))
    assert torch.equal(logb[:, :, 3, 1:], gh.emission_logb(feats.feats, sil)[:, :, 0].movedim(1, 0))
    assert (logb[:, :, 3, 0] == NEG_INF).all()
    assert torch.equal(net.log_pi[:3], digits.log_pi) and torch.equal(net.log_pi[3, 1:], sil.log_pi[0])
    assert torch.equal(net.log_a[3, 1:, 1:], sil.log_a[0]) and (net.log_a[3, 0] == NEG_INF).all()
    assert (net.log_a[3, :, 0] == NEG_INF).all()


def test_fit_silence_adds_the_skips_and_survives_a_checkpoint(case, tmp_path):
    """``fit_silence``: a 3-state, 6-Gaussian model fitted on noise clips,
    with HTK's 2 -> 4 and 4 -> 2 skips at 0.1 before renormalising; the
    isolated paths never see it, and it is saved and loaded."""
    x, n, digits, _ = case
    rec = _rec(digits, None)
    rng = np.random.default_rng(5)
    rec.fit_silence([0.005 * rng.standard_normal(1600).astype(np.float32) for _ in range(6)],
                    HmmConfig(n_states=3, n_mix=6, n_iter=2, seed=9))
    assert rec.sil.means.shape == (1, 3, 6, 6) and rec.unit_labels() == WORDS + ["sil"]
    a = torch.exp(rec.sil.log_a[0]).double()
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert a[0, 2] == pytest.approx(0.1 / 1.1, rel=1e-6) and a[2, 0] == pytest.approx(0.1 / 1.1)
    assert a[1, 0] == 0 and a[2, 2] == pytest.approx(1.0 / 1.1)
    sigs = [x[i, :n[i]] for i in range(B)]
    before = rec.classify_batch(sigs, return_scores=True)[1]
    assert before.shape == (B, 3)
    path = str(tmp_path / "m.npz")
    rec.save(path)
    back = gh.GmmHmmRecognizer.load(path, CFG, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.sil, rec.sil))
    assert back.classify_connected(sigs, max_segments=L, method="level") == \
        rec.classify_connected(sigs, max_segments=L, method="level")


def test_connected_path_opens_its_spans_and_counts_its_steps(case, monkeypatch):
    x, n, digits, sil = case
    monkeypatch.setattr(profiling, "SPAN_LOG", type(profiling.SPAN_LOG)())
    before = profiling.counts().get("connected_steps", 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _rec(digits, sil).classify_connected([x[0, :n[0]]], max_segments=L, method="level",
                                             grammar={"start": "sil", "end": "sil"})
    names = {s[0] for s in profiling.SPAN_LOG}
    assert {"dsp.frontend", "dsp.emissions", "dsp.connected", "dsp.backtrace",
            "dsp.readback"} <= names
    assert profiling.counts()["connected_steps"] - before == L * T
