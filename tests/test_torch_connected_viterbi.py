"""The port's connected Viterbi (``dsp_tpu_torch/ops/connected_viterbi.py``)
against the JAX package's ``dsp_tpu/ops/connected_viterbi.py`` on the same
parameters (JAX's arrays carried across through ``params_from_numpy``) and
seeded features, on the CPU.

Tolerances: scores at rtol 1e-5 (the emissions are the same float32
expansion summed by another GEMM; measured ~1e-7 relative), the NEG_INF
pattern, words and starts equal; the backtrace through the MIN bridge
gives JAX's sequences."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.models import gmm_hmm as jg
from dsp_tpu.ops import connected_viterbi as jcv
from dsp_tpu.ops import level_building as jlb

from dsp_tpu_torch.models.gmm_hmm import params_from_numpy
from dsp_tpu_torch.ops import connected_viterbi as tcv
from dsp_tpu_torch.ops import level_building as tlb

NEG_INF = tcv.NEG_INF
B, T, F, W, S, M, L = 3, 50, 5, 4, 3, 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the DP loops are thousands of small ops, which
    crawl when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed, w=W, dup=False):
    rng = np.random.default_rng(seed)
    log_pi = np.full((w, S), NEG_INF, np.float32)
    log_pi[:, 0] = 0.0
    log_a = np.stack([np.asarray(jg._lr_log_a(jnp.full((S,), p), S))
                      for p in rng.uniform(0.3, 0.8, w)])
    p = jg.HmmParams(log_pi, log_a,
                     rng.standard_normal((w, S, M, F)).astype(np.float32),
                     (0.3 * rng.standard_normal((w, S, M, F))).astype(np.float32),
                     np.log(rng.dirichlet(np.ones(M), size=(w, S))).astype(np.float32))
    if dup:     # word w-1 a copy of word 0: their exits tie
        p = jg.HmmParams(*(np.concatenate([a[:-1], a[:1]]) for a in p))
    return p, jg.HmmParams(*map(jnp.asarray, p)), params_from_numpy(tuple(p), "cpu")


def _feats(seed):
    return np.random.default_rng(seed).standard_normal((B, T, F)).astype(np.float32)


def _assert_scores(got, want):
    live = want > NEG_INF / 2
    np.testing.assert_array_equal(got > NEG_INF / 2, live)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5)
    return live


@pytest.mark.parametrize("penalty", [0.0, 0.5])
def test_connected_viterbi_matches_jax(penalty):
    _, jp, tp = _params(1)
    q = _feats(1)
    got = [g.numpy() for g in tcv.connected_viterbi(torch.from_numpy(q), None, tp,
                                                    L, penalty)]
    want = [np.asarray(w) for w in jcv.connected_viterbi(
        jnp.asarray(q), jnp.full((B,), T), jp, max_levels=L, word_penalty=penalty)]
    assert got[1].dtype == got[2].dtype == np.int32 and got[0].shape == (B, L, T)
    live = _assert_scores(got[0], want[0])
    np.testing.assert_array_equal(got[1][live], want[1][live])
    np.testing.assert_array_equal(got[2][live], want[2][live])
    for b in range(B):
        for tv in (T, 17, 1):
            seq, cost = tlb.backtrack(-got[0][b], got[1][b], got[2][b], tv)
            want_seq, want_cost = jlb.backtrack(-want[0][b], want[1][b],
                                                want[2][b], tv)
            assert seq == want_seq and cost == pytest.approx(want_cost, rel=1e-5)


@pytest.mark.parametrize("penalty", [0.0, 0.5])
def test_connected_viterbi_grammar_matches_jax(penalty):
    _, jp, tp = _params(2)
    q = _feats(2)
    rng = np.random.default_rng(2)
    start, pairs, end = rng.random(W) < 0.7, rng.random((W, W)) < 0.6, rng.random(W) < 0.7
    start[0] = end[1] = True
    got = [g.numpy() for g in tcv.connected_viterbi_grammar(
        torch.from_numpy(q), None, tp, torch.from_numpy(start),
        torch.from_numpy(pairs), L, penalty)]
    want = [np.asarray(w) for w in jcv.connected_viterbi_grammar(
        jnp.asarray(q), jnp.full((B,), T), jp, jnp.asarray(start),
        jnp.asarray(pairs), max_levels=L, word_penalty=penalty)]
    assert got[0].shape == (B, L, T, W) and got[1].dtype == np.int32
    live = _assert_scores(got[0], want[0])
    np.testing.assert_array_equal(got[1][live], want[1][live])
    for b in range(B):
        got_seq = tlb.backtrack_grammar(-got[0][b], got[1][b], pairs, end, T)
        want_seq = jlb.backtrack_grammar(-want[0][b], want[1][b], pairs, end, T)
        assert got_seq[0] == want_seq[0]
        assert got_seq[1] == pytest.approx(want_seq[1], rel=1e-5)


def test_duplicated_word_ties_pick_the_first_word():
    """Word W-1 copies word 0, so their exit scores tie wherever either
    leads: both DPs report word 0 (the first maximum), never W-1."""
    _, jp, tp = _params(3, dup=True)
    q = _feats(3)
    got = [g.numpy() for g in tcv.connected_viterbi(torch.from_numpy(q), None, tp, L)]
    want = [np.asarray(w) for w in jcv.connected_viterbi(
        jnp.asarray(q), jnp.full((B,), T), jp, max_levels=L)]
    live = _assert_scores(got[0], want[0])
    np.testing.assert_array_equal(got[1][live], want[1][live])
    np.testing.assert_array_equal(got[2][live], want[2][live])
    assert (got[1][live] == 0).any() and not (got[1][live] == W - 1).any()


def test_loop_grammar_equals_the_unconstrained_dp():
    _, _, tp = _params(4)
    q = torch.from_numpy(_feats(4))
    ones, loop = torch.ones(W, dtype=torch.bool), torch.ones((W, W), dtype=torch.bool)
    sc_g, st_g = (g.numpy() for g in tcv.connected_viterbi_grammar(q, None, tp, ones,
                                                                    loop, L))
    sc, wd, st = (g.numpy() for g in tcv.connected_viterbi(q, None, tp, L))
    np.testing.assert_array_equal(sc_g.max(-1), sc)
    for b in range(B):
        assert tlb.backtrack_grammar(-sc_g[b], st_g[b], loop.numpy(), ones.numpy(),
                                     T) == tlb.backtrack(-sc[b], wd[b], st[b], T)
