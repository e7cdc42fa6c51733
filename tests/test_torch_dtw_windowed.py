"""The windowed banded DTW (``ops/dtw_banded.py``) and the bidirectional
half-depth scan (``ops/dtw.py:dtw_batch_bidi``) in the port, against the
JAX package and against the port's full-width scan ``dtw_batch``, on the
CPU.

Tolerance rtol 1e-5 (measured ~4e-7: the min-plus scans sum in other tree
orders; the bidirectional merge adds F + B - cost), with the BIG/finite
pattern identical.  The bidirectional cases at T, U >= 200 run with the
window schedule active (W = 128 lanes < U), where the backward half must
take the full problem's schedule reflected, not its own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import DtwConfig as JDtwConfig
from dsp_tpu.ops import dtw as jdtw
from dsp_tpu.ops import dtw_banded as jbanded

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.ops import dtw as tdtw
from dsp_tpu_torch.ops import dtw_banded as tbanded

RTOL = 1e-5
# name: (config, (B, T), (K, U), window)
WINDOWED = {
    "band_0.1": ({"band_frac": 0.1}, (2, 60), (3, 50), 128),
    "tight_window": ({"band_frac": 0.1}, (2, 60), (3, 50), 16),
    "band_0.2_squared": ({"band_frac": 0.2, "squared": True}, (2, 48), (3, 56), 32),
    "pure_band": ({"band_frac": 0.1, "max_warp_scale": None}, (2, 60), (2, 60), 16),
    "sliding": ({"band_frac": 0.05}, (2, 200), (2, 220), 32),
}
BIDI = {
    "default": ({}, (3, 40), (4, 36)),
    "unbanded": ({"band_frac": None}, (3, 41), (4, 37)),
    "squared": ({"band_frac": 0.3, "squared": True}, (3, 40), (4, 36)),
    "pure_band": ({"band_frac": 0.05, "max_warp_scale": None}, (2, 300), (3, 280)),
    "window_schedule": ({"band_frac": 0.05}, (2, 300), (3, 280)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the row loops are hundreds of small ops, which
    crawl when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, t, k, u, f=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bk = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = rng.integers(max(2, t // 2), t + 1, size=b).astype(np.int32)
    bl = rng.integers(max(2, u // 2), u + 1, size=k).astype(np.int32)
    ql[0], bl[0] = t, u
    return q, ql, bk, bl


def _close(got, want):
    assert ((got >= 1e20) == (want >= 1e20)).all(), "BIG/finite mismatch"
    fin = want < 1e20
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", list(WINDOWED))
def test_windowed_matches_jax_and_the_scan(case):
    kw, (b, t), (k, u), window = WINDOWED[case]
    q, ql, bk, bl = _inputs(b, t, k, u)
    got = tbanded.dtw_batch_windowed(*_torch(q, ql, bk, bl), window,
                                     DtwConfig(**kw)).numpy()
    want = np.asarray(jbanded.dtw_batch_windowed(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bk), jnp.asarray(bl), window,
        JDtwConfig(**kw)))
    _close(got, want)
    # a window holding the whole band gives the full-width scan's distances
    if window >= 2 * max(1.0, kw["band_frac"] * max(t, u)) + 4:
        _close(got, tdtw.dtw_batch(*_torch(q, ql, bk, bl), DtwConfig(**kw)).numpy())
    one = tbanded.dtw_distance_windowed(torch.from_numpy(q[1]), torch.from_numpy(bk[-1]),
                                        int(ql[1]), int(bl[-1]), window, DtwConfig(**kw))
    assert torch.equal(one, torch.from_numpy(got)[1, -1])


@pytest.mark.parametrize("band_frac", [0.05, 0.1, 0.3, 1.0])
@pytest.mark.parametrize("tu", [(60, 50), (300, 1000)])
def test_window_for_band_matches_jax(band_frac, tu):
    assert (tbanded.window_for_band(band_frac, *tu)
            == jbanded.window_for_band(band_frac, *tu))


def test_windowed_refuses_what_it_does_not_compute():
    q = torch.zeros((1, 8, 3))
    lens = torch.full((1,), 8)
    with pytest.raises(ValueError, match="band_frac"):
        tbanded.dtw_batch_windowed(q, lens, q, lens, 16, DtwConfig(band_frac=None))
    with pytest.raises(ValueError, match="slope"):
        tbanded.dtw_batch_windowed(q, lens, q, lens, 16,
                                   DtwConfig(band_frac=0.1, slope="itakura"))
    with pytest.raises(ValueError, match="slope"):
        tdtw.dtw_batch_bidi(q, lens, q, lens, DtwConfig(slope="itakura"))


@pytest.mark.parametrize("case", list(BIDI))
def test_bidi_matches_jax_and_the_scan(case):
    kw, (b, t), (k, u) = BIDI[case]
    q, ql, bk, bl = _inputs(b, t, k, u, seed=1)
    got = tdtw.dtw_batch_bidi(*_torch(q, ql, bk, bl), DtwConfig(**kw)).numpy()
    want = np.asarray(jdtw.dtw_batch_bidi(jnp.asarray(q), jnp.asarray(ql),
                                          jnp.asarray(bk), jnp.asarray(bl),
                                          JDtwConfig(**kw)))
    _close(got, want)
    _close(got, tdtw.dtw_batch(*_torch(q, ql, bk, bl), DtwConfig(**kw)).numpy())
    one = tdtw.dtw_distance_bidi(torch.from_numpy(q[1]), torch.from_numpy(bk[2]),
                                 int(ql[1]), int(bl[2]), DtwConfig(**kw))
    assert torch.equal(one, torch.from_numpy(got)[1, 2])


def test_bidi_chunks_like_one_batch(monkeypatch):
    q, ql, bk, bl = _inputs(5, 40, 3, 36, seed=2)
    whole = tdtw.dtw_batch_bidi(*_torch(q, ql, bk, bl))
    monkeypatch.setattr(tdtw, "_MAX_COST_CELLS", 2 * 3 * 21 * 36 * 2)
    assert torch.equal(tdtw.dtw_batch_bidi(*_torch(q, ql, bk, bl)), whole)
