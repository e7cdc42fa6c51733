"""Wavefront DTW parity: the port's plain version of the wavefront kernel
(and the paired masked cost it reads) against the JAX kernel in interpret
mode, the numpy oracle and the JAX scan.

Tolerances: the skew layout exactly; rtol 1e-6 against the oracle on
integer features (exact costs); rtol 1e-5 against the JAX kernel and scan
on the same masked costs (each DP cell is one exact min and one add, so
only the cost GEMMs round differently).  The BIG/finite pattern must be
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import golden
from dsp_tpu.config import DtwConfig as JDtwConfig
from dsp_tpu.kernels import dtw_pallas as jkp
from dsp_tpu.ops import dtw as jdtw

from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_pallas as kwf
from dsp_tpu_torch.ops import dtw as tdtw

T = torch.from_numpy


def _assert_close(got, want, rtol):
    assert ((got >= 1e20) == (want >= 1e20)).all(), "BIG/finite mismatch"
    fin = want < 1e20
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def _pairs(p, t, u, f, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((p, t, f)).astype(np.float32)
    b = rng.standard_normal((p, u, f)).astype(np.float32)
    la = rng.integers(max(2, t // 4), t + 1, size=p).astype(np.int32)
    lb = rng.integers(max(2, u // 4), u + 1, size=p).astype(np.int32)
    la[0], lb[0] = t, u
    return a, b, la, lb


@pytest.mark.parametrize("shape", [(3, 4), (5, 2), (1, 1)])
def test_skew_cost_layout_matches_jax(shape):
    cost = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = kwf.skew_cost(T(cost)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jkp.skew_cost(jnp.asarray(cost))))
    t, u = shape
    for k in range(t + u - 1):
        for i in range(t):
            want = cost[i, k - i] if 0 <= k - i < u else kwf.BIG
            assert got[k, i] == np.float32(want)


@pytest.mark.parametrize("kw", [{}, {"band_frac": 0.25}, {"band_frac": None},
                                {"max_warp_scale": None}])
def test_paired_masked_cost_matches_jax_vmapped(kw):
    a, b, la, lb = _pairs(4, 30, 37, 6, seed=1)
    got = tdtw.masked_cost_pairs(T(a), T(la), T(b), T(lb), DtwConfig(**kw)).numpy()
    jcfg = JDtwConfig(**kw)
    want = np.asarray(jax.vmap(lambda x, y, p, q: jdtw.masked_cost(x, y, p, q, jcfg))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb)))
    np.testing.assert_array_equal(got >= 1e30, want >= 1e30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dtw_from_cost_matches_jax_interpret():
    a, b, la, lb = _pairs(5, 21, 26, 5, seed=2)
    cfg = JDtwConfig(band_frac=0.3)
    cost = np.array(jax.vmap(lambda x, y, p, q: jdtw.masked_cost(x, y, p, q, cfg))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb)))
    got = kwf.dtw_from_cost_pallas(T(cost), T(la), T(lb)).numpy()
    want = np.asarray(jkp.dtw_from_cost_pallas(jnp.asarray(cost), jnp.asarray(la),
                                               jnp.asarray(lb), interpret=True))
    # the same costs and the same exact min/add per cell: the same bits
    np.testing.assert_array_equal(got, want)


def test_dtw_pairs_matches_golden_on_integers():
    # tests/test_pallas_dtw.py:25: integer features, squared cost
    rng = np.random.default_rng(0)
    cfg = DtwConfig(squared=True)
    a = rng.integers(-3, 4, size=(5, 6, 2)).astype(np.float32)
    b = rng.integers(-3, 4, size=(5, 7, 2)).astype(np.float32)
    la = np.array([6, 3, 1, 6, 4], dtype=np.int32)
    lb = np.array([7, 7, 1, 2, 5], dtype=np.int32)
    got = kwf.dtw_pairs_pallas(T(a), T(b), T(la), T(lb), cfg).numpy()
    for p in range(5):
        want = golden.dtw_distance(a[p, :la[p]], b[p, :lb[p]], JDtwConfig(squared=True))
        np.testing.assert_allclose(got[p], want, rtol=1e-6, err_msg=str(p))


BATCH_CONFIGS = {"default": {}, "band_0.25": {"band_frac": 0.25},
                 "pure_band": {"max_warp_scale": None}, "unbanded": {"band_frac": None}}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 25, 7)).astype(np.float32)
    bank = rng.standard_normal((4, 31, 7)).astype(np.float32)
    ql = rng.integers(5, 26, size=3).astype(np.int32)
    bl = rng.integers(5, 32, size=4).astype(np.int32)
    return q, ql, bank, bl


@pytest.mark.parametrize("name", list(BATCH_CONFIGS))
def test_dtw_batch_matches_jax_interpret(batch, name):
    q, ql, bank, bl = batch
    kw = BATCH_CONFIGS[name]
    got = kwf.dtw_batch_pallas(T(q), T(ql), T(bank), T(bl), DtwConfig(**kw)).numpy()
    want = np.asarray(jkp.dtw_batch_pallas(jnp.asarray(q), jnp.asarray(ql),
                                           jnp.asarray(bank), jnp.asarray(bl),
                                           JDtwConfig(**kw), interpret=True))
    _assert_close(got, want, 1e-5)
    scan = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank),
                                     jnp.asarray(bl), JDtwConfig(**kw)))
    _assert_close(got, scan, 1e-5)


def test_chunked_batch_and_pairs_equal_one_chunk(batch, monkeypatch):
    q, ql, bank, bl = (T(v) for v in batch)
    cfg = DtwConfig()
    whole = kwf.dtw_batch_pallas(q, ql, bank, bl, cfg)
    pairs = kwf.dtw_pairs_pallas(q.repeat_interleave(4, 0), bank.repeat(3, 1, 1),
                                 ql.repeat_interleave(4), bl.repeat(3), cfg)
    monkeypatch.setattr(tdtw, "_MAX_COST_CELLS", 4 * 25 * 31)
    np.testing.assert_array_equal(kwf.dtw_batch_pallas(q, ql, bank, bl, cfg), whole)
    np.testing.assert_array_equal(
        kwf.dtw_pairs_pallas(q.repeat_interleave(4, 0), bank.repeat(3, 1, 1),
                             ql.repeat_interleave(4), bl.repeat(3), cfg), pairs)
    np.testing.assert_array_equal(pairs.reshape(3, 4), whole)


def test_paired_scan_matches_jax_dtw_distance():
    a, b, la, lb = _pairs(4, 20, 24, 5, seed=4)
    for kw in ({}, {"slope": "itakura"}, {"band_frac": None}):
        got = tdtw.dtw_pairs_scan(T(a), T(la), T(b), T(lb), DtwConfig(**kw)).numpy()
        jcfg = JDtwConfig(**kw)
        want = np.asarray(jax.vmap(
            lambda x, y, p, q: jdtw.dtw_distance(x, y, p, q, jcfg))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb)))
        _assert_close(got, want, 1e-5)


def test_slope_rejected_with_the_jax_message():
    args = [torch.zeros((2, 8, 3)), torch.full((2,), 8, dtype=torch.int32),
            torch.zeros((2, 8, 3)), torch.full((2,), 8, dtype=torch.int32)]
    with pytest.raises(ValueError) as want:
        jkp.dtw_batch_pallas(*(jnp.asarray(x.numpy()) for x in args),
                             JDtwConfig(slope="itakura"), interpret=True)
    for call in (lambda cfg: kwf.dtw_batch_pallas(*args, cfg),
                 lambda cfg: tpl.dtw_pairs(*args, DtwConfig(impl="pallas",
                                                            slope="itakura")),
                 lambda cfg: kwf.dtw_pairs_pallas(args[0], args[2], args[1],
                                                  args[3], cfg)):
        with pytest.raises(ValueError) as got:
            call(DtwConfig(slope="itakura"))
        assert str(got.value) == str(want.value)


def test_cpu_tensors_take_the_plain_version():
    q, bank, ql, bl = _pairs(3, 12, 14, 4, seed=5)
    before = _build.LAUNCHES["dtw_wavefront"]
    got = tpl.dtw_pairs(T(q), T(ql), T(bank), T(bl), DtwConfig(impl="pallas"))
    assert _build.LAUNCHES["dtw_wavefront"] == before
    np.testing.assert_array_equal(
        got.numpy(), kwf.dtw_batch_pallas(T(q), T(ql), T(bank), T(bl)).numpy())
    # impl="auto" on CPU tensors is the scan, whatever the band
    auto = tpl.dtw_pairs(T(q), T(ql), T(bank), T(bl), DtwConfig(max_warp_scale=None))
    np.testing.assert_array_equal(auto.numpy(), tdtw.dtw_batch(
        T(q), T(ql), T(bank), T(bl), DtwConfig(max_warp_scale=None)).numpy())
