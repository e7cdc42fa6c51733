"""Spotting ops parity: ``dsp_tpu_torch/ops/spot.py`` against the JAX package.

The port's plain subsequence DTW is held to the JAX scan
(``dsp_tpu.ops.spot.subseq_dtw_batch(impl="scan")``), to the TPU kernel in
interpret mode (``dsp_tpu.kernels.spot_fused``) and to the numpy oracle
(``dsp_tpu.golden.spot``).  Norms allclose at rtol 2e-4, atol 1e-5 (float32
sums in another order; tests/test_spot_fused.py uses the same), witnesses
``array_equal`` on every valid column (continuous random features have no
near-ties at these sizes), norm >= 1e20 at every column past a stream's
length.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.golden import spot as gs
from dsp_tpu.kernels.spot_fused import subseq_dtw_fused as jax_fused
from dsp_tpu.ops import spot as jsp

from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import spot_fused as ksp
from dsp_tpu_torch.ops import dtw as tdtw
from dsp_tpu_torch.ops import spot as tsp

SHAPES = [(3, 4, 57, 23, 5), (5, 7, 130, 40, 13)]    # (b, k, u, t, f)


def _inputs(shape, seed):
    b, k, u, t, f = shape
    rng = np.random.default_rng(seed)
    streams = rng.normal(size=(b, u, f)).astype(np.float32)
    bank = rng.normal(size=(k, t, f)).astype(np.float32)
    s_lens = rng.integers(max(1, u // 3), u + 1, size=b).astype(np.int32)
    b_lens = rng.integers(3, t + 1, size=k).astype(np.int32)
    s_lens[0], b_lens[0] = u, t
    return streams, s_lens, bank, b_lens


def _port(streams, s_lens, bank, b_lens, squared=False, impl="auto"):
    norm, start = tsp.subseq_dtw_batch(
        torch.from_numpy(streams), torch.from_numpy(s_lens),
        torch.from_numpy(bank), torch.from_numpy(b_lens), squared=squared,
        impl=impl)
    return norm.numpy(), start.numpy()


def _assert_fields_equal(got, want, s_lens):
    (gn, gs_), (wn, ws) = got, want
    assert gn.shape == wn.shape and gs_.shape == ws.shape
    assert gn.dtype == np.float32 and gs_.dtype == np.int32
    for bi, sl in enumerate(s_lens):
        np.testing.assert_allclose(gn[bi, :, :sl], wn[bi, :, :sl],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_array_equal(gs_[bi, :, :sl], ws[bi, :, :sl])
        assert (gn[bi, :, sl:] >= 1e20).all()


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_scan(shape, squared):
    streams, s_lens, bank, b_lens = _inputs(shape, 11)
    want = jsp.subseq_dtw_batch(jnp.asarray(streams), jnp.asarray(s_lens),
                                jnp.asarray(bank), jnp.asarray(b_lens),
                                squared=squared, impl="scan")
    _assert_fields_equal(_port(streams, s_lens, bank, b_lens, squared),
                         [np.asarray(w) for w in want], s_lens)


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_tpu_kernel_interpret(shape, squared):
    streams, s_lens, bank, b_lens = _inputs(shape, 12)
    want = jax_fused(jnp.asarray(streams), jnp.asarray(s_lens),
                     jnp.asarray(bank), jnp.asarray(b_lens), squared=squared,
                     interpret=True)
    _assert_fields_equal(_port(streams, s_lens, bank, b_lens, squared),
                         [np.asarray(w) for w in want], s_lens)


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_golden(shape, squared):
    streams, s_lens, bank, b_lens = _inputs(shape, 13)
    norm, start = _port(streams, s_lens, bank, b_lens, squared)
    for bi in range(len(s_lens)):
        for v in range(len(b_lens)):
            g_norm, g_start = gs.subseq_dtw(bank[v, :b_lens[v]],
                                            streams[bi, :s_lens[bi]],
                                            squared=squared)
            np.testing.assert_allclose(norm[bi, v, :s_lens[bi]], g_norm,
                                       rtol=2e-4, atol=1e-5)
            np.testing.assert_array_equal(start[bi, v, :s_lens[bi]], g_start)


@pytest.mark.parametrize("squared", [False, True])
def test_subseq_cost_matches_jax(squared):
    streams, s_lens, bank, _ = _inputs((2, 1, 30, 12, 6), 14)
    want = jsp.subseq_cost(jnp.asarray(bank[0]), jnp.asarray(streams[1]),
                           jnp.asarray(s_lens[1]), squared)
    got = tsp.subseq_cost(torch.from_numpy(bank[0]), torch.from_numpy(streams[1]),
                          torch.tensor(int(s_lens[1])), squared)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_subseq_dtw_from_cost_matches_jax():
    rng = np.random.default_rng(15)
    cost = rng.uniform(0.0, 3.0, size=(9, 25)).astype(np.float32)
    cost[:, 20:] = 1e30
    want = jsp.subseq_dtw_from_cost(jnp.asarray(cost), jnp.asarray(7),
                                    jnp.asarray(20))
    got = tsp.subseq_dtw_from_cost(torch.from_numpy(cost), torch.tensor(7),
                                   torch.tensor(20))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-4)
    np.testing.assert_array_equal(got[1].numpy()[:20], np.asarray(want[1])[:20])


def test_minplus_scan_payload_follows_the_winner():
    # D_j = min(A_j, D_{j-1} + c_j); the payload follows the winning term and
    # a tie keeps the later (fresher) one
    a = torch.tensor([[1.0, 5.0, 1.5, 0.2]])
    c = torch.tensor([[1.0, 1.0, 0.5, 3.0]])
    s = torch.tensor([[10, 11, 12, 13]], dtype=torch.int32)
    d, w = tdtw._minplus_scan(a, c, s)
    np.testing.assert_allclose(d.numpy(), [[1.0, 2.0, 1.5, 0.2]])
    np.testing.assert_array_equal(w.numpy(), [[10, 10, 12, 13]])
    np.testing.assert_array_equal(tdtw._minplus_scan(a, c).numpy(), d.numpy())


def test_big_tail_past_the_stream_length():
    streams, s_lens, bank, b_lens = _inputs((3, 2, 40, 9, 4), 16)
    s_lens[:] = [40, 17, 1]
    norm, start = _port(streams, s_lens, bank, b_lens)
    for bi, sl in enumerate(s_lens):
        assert (norm[bi, :, sl:] == 1e30).all()
        assert np.isfinite(norm[bi, :, :sl]).all() and (norm[bi, :, :sl] < 1e20).all()
        assert (start[bi, :, :sl] <= np.arange(sl)).all()


def test_zero_cost_tie_keeps_the_fresh_start():
    stream = np.ones((1, 12, 3), np.float32)
    tmpl = np.ones((1, 4, 3), np.float32)
    norm, start = _port(stream, np.array([12], np.int32), tmpl,
                        np.array([4], np.int32))
    g_norm, g_start = gs.subseq_dtw(tmpl[0], stream[0])
    np.testing.assert_array_equal(start[0, 0], g_start)
    np.testing.assert_allclose(norm[0, 0], g_norm, rtol=1e-6)


def test_planted_keyword_is_found():
    rng = np.random.default_rng(17)
    kw = rng.normal(size=(8, 6)).astype(np.float32) * 3.0
    stream = rng.normal(size=(30, 6)).astype(np.float32) * 0.05
    stream[12:20] = kw
    norm, start = _port(stream[None], np.array([30], np.int32), kw[None],
                        np.array([8], np.int32))
    j = int(np.argmin(norm[0, 0]))
    assert (int(start[0, 0, j]), j) == (12, 19)


def test_auto_on_cpu_is_the_scan_and_launches_nothing():
    streams, s_lens, bank, b_lens = _inputs((2, 3, 25, 7, 4), 18)
    before = _build.LAUNCHES["spot_subseq"]
    auto = _port(streams, s_lens, bank, b_lens, impl="auto")
    fused = _port(streams, s_lens, bank, b_lens, impl="fused")
    scan = _port(streams, s_lens, bank, b_lens, impl="scan")
    assert _build.LAUNCHES["spot_subseq"] == before
    for got in (auto, fused):
        np.testing.assert_array_equal(got[0], scan[0])
        np.testing.assert_array_equal(got[1], scan[1])
    assert tsp.production_impl("cpu") == "scan"
    assert tsp.production_impl("cuda") == "fused"
    assert tsp.production_impl(torch.device("cuda", 0)) == "fused"
    with pytest.raises(ValueError, match="impl"):
        _port(streams, s_lens, bank, b_lens, impl="bogus")


def test_chunked_plain_equals_one_chunk(monkeypatch):
    streams, s_lens, bank, b_lens = _inputs((5, 3, 30, 8, 4), 19)
    whole = _port(streams, s_lens, bank, b_lens)
    monkeypatch.setattr(tsp, "_MAX_COST_CELLS", 3 * 8 * 30 * 2)  # 2 streams a chunk
    chunked = _port(streams, s_lens, bank, b_lens)
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(chunked[1], whole[1])


def test_empty_batch():
    norm, start = tsp.subseq_dtw_batch(torch.zeros((0, 10, 3)),
                                       torch.zeros((0,), dtype=torch.int32),
                                       torch.ones((2, 4, 3)),
                                       torch.full((2,), 4, dtype=torch.int32))
    assert norm.shape == start.shape == (0, 2, 10)


@pytest.mark.parametrize("squared", [False, True])
def test_rerank_windows_matches_jax(squared):
    rng = np.random.default_rng(20)
    n, w, k, t, f = 6, 40, 5, 12, 5
    wins = rng.normal(size=(n, w, f)).astype(np.float32)
    bank = rng.normal(size=(k, t, f)).astype(np.float32)
    win_lens = rng.integers(15, w + 1, size=n).astype(np.int32)
    b_lens = rng.integers(4, t + 1, size=k).astype(np.int32)
    mids = rng.integers(5, 15, size=n).astype(np.int32)
    want = jsp.rerank_windows(jnp.asarray(wins), jnp.asarray(win_lens),
                              jnp.asarray(mids), jnp.asarray(bank),
                              jnp.asarray(b_lens), squared=squared)
    got = tsp.rerank_windows(torch.from_numpy(wins), torch.from_numpy(win_lens),
                             torch.from_numpy(mids), torch.from_numpy(bank),
                             torch.from_numpy(b_lens), squared=squared)
    for g, wv in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=2e-4)


@pytest.mark.parametrize("threshold,min_gap", [(0.1, 0), (1.0, 0), (1.0, 3),
                                               (2.5, 1)])
def test_extract_events_matches_jax(threshold, min_gap):
    rng = np.random.default_rng(21)
    f = 3
    kws = [rng.standard_normal((6, f)), rng.standard_normal((5, f))]
    stream = rng.standard_normal((60, f)) * 4.0
    stream[10:16] = kws[0]
    stream[40:45] = kws[1]
    fields = [gs.subseq_dtw(kw, stream) for kw in kws]
    norm = np.stack([fl[0] for fl in fields])
    start = np.stack([fl[1] for fl in fields])
    labels = np.array([3, 1])
    want = jsp.extract_events(norm, start, threshold, labels=labels,
                              min_gap=min_gap)
    got = tsp.extract_events(norm, start, threshold, labels=labels,
                             min_gap=min_gap)
    assert got == want
    if threshold == 0.1:
        assert [ev[:3] for ev in got] == [(3, 10, 15), (1, 40, 44)]


def test_fused_wrapper_takes_plain_on_cpu():
    streams, s_lens, bank, b_lens = _inputs((2, 2, 20, 6, 3), 22)
    args = [torch.from_numpy(a) for a in (streams, s_lens, bank, b_lens)]
    before = _build.LAUNCHES["spot_subseq"]
    got = ksp.subseq_dtw_fused(*args)
    want = ksp.subseq_dtw_batch_plain(*args)
    assert _build.LAUNCHES["spot_subseq"] == before
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
