"""Unbanded closed-form DTW parity: the port's plain version of the fused
DTW kernel against the JAX kernel in interpret mode and the JAX scan.

Tolerance rtol 1e-4 / atol 1e-5, the tolerance of
tests/test_pallas_dtw.py:103: the closed form's prefix sums cancel about
1e-4 in absolute terms on raw row sums, and the scan sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import DtwConfig as JDtwConfig
from dsp_tpu.kernels.dtw_fused import dtw_batch_fused as jax_fused
from dsp_tpu.ops import dtw as jdtw

from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_fused as kfu

# the three shapes of tests/test_pallas_dtw.py:90, (B, K, T, U, F)
SHAPES = [(5, 3, 25, 31, 13), (3, 2, 40, 40, 8), (2, 4, 9, 126, 5)]


def _inputs(shape, seed):
    b, k, t, u, f = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = rng.integers(1, t + 1, size=b).astype(np.int32)
    bl = rng.integers(1, u + 1, size=k).astype(np.int32)
    return q, ql, bank, bl


def _port(q, ql, bank, bl, cfg):
    return kfu.dtw_batch_fused(*(torch.from_numpy(v) for v in (q, ql, bank, bl)),
                               cfg).numpy()


@pytest.fixture(scope="module", params=range(len(SHAPES)))
def case(request):
    return _inputs(SHAPES[request.param], 11 + request.param)


@pytest.mark.parametrize("squared", [False, True])
def test_plain_fused_matches_jax_interpret(case, squared):
    q, ql, bank, bl = case
    got = _port(q, ql, bank, bl, DtwConfig(band_frac=None, squared=squared))
    want = np.asarray(jax_fused(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank),
                                jnp.asarray(bl),
                                JDtwConfig(band_frac=None, squared=squared),
                                interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("squared", [False, True])
def test_plain_fused_matches_jax_scan(case, squared):
    q, ql, bank, bl = case
    got = _port(q, ql, bank, bl, DtwConfig(band_frac=None, squared=squared))
    want = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank),
                                     jnp.asarray(bl),
                                     JDtwConfig(band_frac=None, squared=squared)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_chunked_plain_equals_one_chunk(monkeypatch):
    q, ql, bank, bl = _inputs((5, 3, 20, 22, 6), 3)
    cfg = DtwConfig(band_frac=None)
    whole = _port(q, ql, bank, bl, cfg)
    monkeypatch.setattr(kfu.tdtw, "_MAX_COST_CELLS", 2 * 3 * 20 * 22)
    np.testing.assert_array_equal(_port(q, ql, bank, bl, cfg), whole)


@pytest.mark.parametrize("kw,match", [({"band_frac": 0.2}, "unbanded"),
                                      ({}, "unbanded"),
                                      ({"band_frac": None, "slope": "itakura"}, "slope")])
def test_band_and_slope_rejected_with_the_jax_messages(kw, match):
    args = [torch.zeros((2, 8, 3)), torch.full((2,), 8, dtype=torch.int32),
            torch.zeros((2, 8, 3)), torch.full((2,), 8, dtype=torch.int32)]
    with pytest.raises(ValueError, match=match) as got:
        kfu.dtw_batch_fused(*args, DtwConfig(**kw))
    with pytest.raises(ValueError) as want:
        jax_fused(*(jnp.asarray(a.numpy()) for a in args), JDtwConfig(**kw),
                  interpret=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=match):
        tpl.dtw_pairs(*args, DtwConfig(impl="fused", **kw))


def test_cpu_tensors_take_the_plain_version():
    q, ql, bank, bl = _inputs((3, 2, 15, 17, 4), 5)
    before = _build.LAUNCHES["dtw_fused"]
    got = tpl.dtw_pairs(*(torch.from_numpy(v) for v in (q, ql, bank, bl)),
                        DtwConfig(band_frac=None, impl="fused"))
    assert _build.LAUNCHES["dtw_fused"] == before
    np.testing.assert_array_equal(got.numpy(),
                                  _port(q, ql, bank, bl, DtwConfig(band_frac=None)))
