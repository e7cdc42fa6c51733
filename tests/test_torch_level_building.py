"""The port's level building (``dsp_tpu_torch/ops/level_building.py``)
against the JAX package's ``dsp_tpu/ops/level_building.py`` on the same
seeded inputs, on the CPU.

Tolerances: local costs and DP costs at rtol 1e-5 (the cross term is
summed by another GEMM; measured ~1e-7 relative), the BIG pattern, words
and starts equal.  With small-integer features and squared costs every
value is exact, so the planted-tie case holds costs, words and starts
equal bit for bit: both DPs resolve ties by the same first-index rule.
Streaming (``level_build_chunk``) is held to the batch DP bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.ops import level_building as jlb

from dsp_tpu_torch.ops import level_building as tlb

BIG = tlb.BIG
B, T, F, K, U, L = 2, 40, 6, 5, 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the DP loops are thousands of small ops, which
    crawl when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b=B, t=T, f=F, k=K, u=U):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    lens = rng.integers(3, u + 1, size=k).astype(np.int32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    for v, n in enumerate(lens):
        bank[v, n:] = 0.0
    return q, bank, lens


def _port(q, bank, lens):
    return torch.from_numpy(q), torch.from_numpy(bank), torch.from_numpy(lens)


def _jax(q, bank, lens):
    return jnp.asarray(q), jnp.asarray(bank), jnp.asarray(lens)


def _masks(seed, k=K):
    rng = np.random.default_rng(seed)
    start, pairs, end = rng.random(k) < 0.6, rng.random((k, k)) < 0.6, rng.random(k) < 0.6
    start[0] = end[1] = True
    return start, pairs, end


def _assert_costs(got, want, rtol=1e-5):
    live = want < BIG / 2
    np.testing.assert_array_equal(got < BIG / 2, live)
    np.testing.assert_allclose(got[live], want[live], rtol=rtol, atol=rtol)
    return live


@pytest.mark.parametrize("squared", [False, True])
def test_local_costs_match_jax(squared):
    q, bank, lens = _inputs(1)
    got = tlb.local_costs(*_port(q, bank, lens), squared).numpy()    # [T, B, K, U]
    assert got.shape == (T, B, K, U)
    for b in range(B):
        want = np.asarray(jlb.local_costs(jnp.asarray(q[b]), jnp.asarray(bank),
                                          jnp.asarray(lens), squared))
        _assert_costs(got[:, b], want)


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("penalty", [0.0, 0.7])
def test_level_build_matches_jax(squared, penalty):
    q, bank, lens = _inputs(2)
    qt, bt, lt = _port(q, bank, lens)
    got = tlb.level_build(qt, torch.full((B,), T), bt, lt, L, penalty, squared)
    qj, bj, lj = _jax(q, bank, lens)
    want = jlb.level_build(qj, jnp.full((B,), T), bj, lj, max_levels=L,
                           word_penalty=penalty, squared=squared)
    gc, gw, gs = (g.numpy() for g in got)
    wc, ww, ws = (np.asarray(w) for w in want)
    assert gw.dtype == gs.dtype == np.int32 and gc.shape == (B, L, T)
    live = _assert_costs(gc, wc)
    np.testing.assert_array_equal(gw[live], ww[live])
    np.testing.assert_array_equal(gs[live], ws[live])
    assert live.any() and not live.all()


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("penalty", [0.0, 0.7])
def test_level_build_grammar_matches_jax(squared, penalty):
    q, bank, lens = _inputs(3)
    start, pairs, _ = _masks(3)
    qt, bt, lt = _port(q, bank, lens)
    got = tlb.level_build_grammar(qt, torch.full((B,), T), bt, lt,
                                  torch.from_numpy(start), torch.from_numpy(pairs),
                                  L, penalty, squared)
    qj, bj, lj = _jax(q, bank, lens)
    want = jlb.level_build_grammar(qj, jnp.full((B,), T), bj, lj,
                                   jnp.asarray(start), jnp.asarray(pairs),
                                   max_levels=L, word_penalty=penalty,
                                   squared=squared)
    gc, gs = (g.numpy() for g in got)
    wc, ws = (np.asarray(w) for w in want)
    assert gc.shape == (B, L, T, K) and gs.dtype == np.int32
    live = _assert_costs(gc, wc)
    np.testing.assert_array_equal(gs[live], ws[live])


def test_planted_ties_resolve_as_jax():
    """Small-integer features, squared costs and duplicated templates:
    every cost is an exact integer, so equal candidates tie in the step's
    four-way choice, among the templates ending at a frame and in the
    grammar's entry minimum.  Costs, words and starts equal JAX's bit for
    bit, and the ties really occur."""
    rng = np.random.default_rng(8)
    b, t, f, k, u = 2, 30, 3, 6, 5
    q = rng.integers(0, 2, (b, t, f)).astype(np.float32)
    bank = rng.integers(0, 2, (k, u, f)).astype(np.float32)
    bank[3], bank[4] = bank[0], bank[1]                   # duplicated templates
    lens = np.asarray([3, 4, 5, 3, 4, 2], np.int32)
    for v, n in enumerate(lens):
        bank[v, n:] = 0.0
    qt, bt, lt = _port(q, bank, lens)
    qj, bj, lj = _jax(q, bank, lens)
    got = [g.numpy() for g in tlb.level_build(qt, None, bt, lt, 4, 1.0, True)]
    want = [np.asarray(w) for w in jlb.level_build(
        qj, jnp.full((b,), t), bj, lj, max_levels=4, word_penalty=1.0, squared=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    c = tlb.local_costs(qt, bt, lt, True).numpy()
    ends = c[:, :, np.arange(k), lens - 1]
    assert (ends[..., 0] == ends[..., 3]).any()            # tied word ends
    start, pairs, _ = _masks(9, k)
    got = [g.numpy() for g in tlb.level_build_grammar(
        qt, None, bt, lt, torch.from_numpy(start), torch.from_numpy(pairs), 4, 1.0, True)]
    want = [np.asarray(w) for w in jlb.level_build_grammar(
        qj, jnp.full((b,), t), bj, lj, jnp.asarray(start), jnp.asarray(pairs),
        max_levels=4, word_penalty=1.0, squared=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("chunk", [1, 7, T])
@pytest.mark.parametrize("squared", [False, True])
def test_chunked_stream_equals_batch_bit_for_bit(chunk, squared):
    q, bank, lens = _inputs(4, b=1)
    qt, bt, lt = _port(q, bank, lens)
    want = [p[0].numpy() for p in tlb.level_build(qt, None, bt, lt, L, 0.7, squared)]
    state = tlb.level_stream_init(L, K, U, "cpu")
    parts = []
    for lo in range(0, T, chunk):
        state, planes = tlb.level_build_chunk(state, qt[0, lo:lo + chunk], bt, lt,
                                              0.7, squared)
        parts.append([p.numpy() for p in planes])
    assert state.offset == T
    for i, w in enumerate(want):
        got = np.concatenate([p[i] for p in parts], axis=1)
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)


def test_stream_state_resume_is_pure():
    q, bank, lens = _inputs(5, b=1)
    _, bt, lt = _port(q, bank, lens)
    rows = torch.from_numpy(q[0])
    st1, _ = tlb.level_build_chunk(tlb.level_stream_init(2, K, U, "cpu"),
                                   rows[:4], bt, lt)
    _, (a, _, _) = tlb.level_build_chunk(st1, rows[4:], bt, lt)
    _, (b, _, _) = tlb.level_build_chunk(st1, rows[4:], bt, lt)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_backtrack_matches_jax_on_the_same_planes():
    q, bank, lens = _inputs(6, b=3)
    qt, bt, lt = _port(q, bank, lens)
    planes = [p.numpy() for p in tlb.level_build(qt, None, bt, lt, L, 0.3)]
    cases = [(b, tv) for b in range(3) for tv in (T, T // 2, 5, 1, 0)]
    for b, tv in cases:
        row = [p[b] for p in planes]
        assert tlb.backtrack(*row, tv) == jlb.backtrack(*row, tv)
        assert tlb.backtrack(*row, tv, max_levels=2) == \
            jlb.backtrack(*row, tv, max_levels=2)
    infeasible = (np.full((2, 4), BIG), np.zeros((2, 4), np.int32),
                  np.zeros((2, 4), np.int32))
    assert tlb.backtrack(*infeasible, 4) == jlb.backtrack(*infeasible, 4) == ([], BIG)
    assert tlb.backtrack(*(p[0] for p in planes), 0)[0] == []


def test_backtrack_grammar_matches_jax_on_the_same_planes():
    q, bank, lens = _inputs(7, b=3)
    start, pairs, end = _masks(7)
    qt, bt, lt = _port(q, bank, lens)
    costs, starts = (p.numpy() for p in tlb.level_build_grammar(
        qt, None, bt, lt, torch.from_numpy(start), torch.from_numpy(pairs), L, 0.3))
    decoded = 0
    for b in range(3):
        for tv in (T, T // 2, 5, 1, 0):
            got = tlb.backtrack_grammar(costs[b], starts[b], pairs, end, tv)
            assert got == jlb.backtrack_grammar(costs[b], starts[b], pairs, end, tv)
            decoded += bool(got[0])
    assert decoded
    no_end = np.zeros(K, bool)                 # the grammar admits nothing
    assert tlb.backtrack_grammar(costs[0], starts[0], pairs, no_end, T) == ([], BIG)
