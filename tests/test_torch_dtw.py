"""DTW parity: the port's plain DTW (the plain version of the banded DTW
kernel) against the JAX scan and the JAX fused banded kernel.

Tolerances: rtol 1e-5 against the scan (same cost expansion, the row scan
sums in another tree order); rtol 2e-5 against the Pallas kernel in
interpret mode, the tolerance of tests/test_fused_banded.py (its GEMM and
prefix sums round differently).  The BIG/finite pattern must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import DtwConfig as JDtwConfig
from dsp_tpu.kernels.dtw_fused_banded import dtw_batch_fused_banded as jax_fused_banded
from dsp_tpu.ops import dtw as jdtw

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
from dsp_tpu_torch.ops import dtw as tdtw

CASES = {
    "sqrt": ({"band_frac": 0.2}, (3, 37), (4, 41)),
    "squared": ({"band_frac": 0.2, "squared": True}, (3, 37), (4, 41)),
    "itakura": ({"band_frac": 0.2, "slope": "itakura"}, (3, 37), (4, 41)),
    "unbanded": ({"band_frac": None}, (2, 50), (3, 60)),
    "default_band": ({}, (3, 45), (3, 45)),
    "sliding": ({"band_frac": 0.1}, (2, 120), (3, 300)),
    "sliding_itakura": ({"band_frac": 0.1, "slope": "itakura"}, (2, 120), (3, 300)),
}
# Interpret mode unrolls the Pallas kernel's rows: the sliding cases run it
# at a smaller shape whose window still slides (W=128 < U_pad=256).
INTERPRET_SHAPES = {"sliding": ((2, 64), (3, 200)),
                    "sliding_itakura": ((2, 64), (3, 200))}


def _inputs(b, t, k, u, f=5, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bk = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = rng.integers(max(2, t // 5), t + 1, size=b).astype(np.int32)
    bl = rng.integers(max(2, u // 5), u + 1, size=k).astype(np.int32)
    ql[0], bl[0] = t, u
    return q, ql, bk, bl


def _port(q, ql, bk, bl, cfg):
    return tdtw.dtw_batch(torch.from_numpy(q), torch.from_numpy(ql),
                          torch.from_numpy(bk), torch.from_numpy(bl), cfg).numpy()


def _assert_close(d, ref, rtol):
    assert ((ref >= 1e20) == (d >= 1e20)).all(), "BIG/finite mismatch"
    fin = ref < 1e20
    if fin.any():
        np.testing.assert_allclose(d[fin], ref[fin], rtol=rtol)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_dtw_matches_jax_scan(case):
    kw, (b, t), (k, u) = CASES[case]
    q, ql, bk, bl = _inputs(b, t, k, u)
    got = _port(q, ql, bk, bl, DtwConfig(**kw))
    want = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bk),
                                     jnp.asarray(bl), JDtwConfig(**kw)))
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_dtw_matches_fused_banded_interpret(case):
    kw, (b, t), (k, u) = CASES[case]
    (b, t), (k, u) = INTERPRET_SHAPES.get(case, ((b, t), (k, u)))
    q, ql, bk, bl = _inputs(b, t, k, u, seed=1)
    got = _port(q, ql, bk, bl, DtwConfig(**kw))
    want = np.asarray(jax_fused_banded(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bk),
                                       jnp.asarray(bl), JDtwConfig(**kw),
                                       interpret=True))
    _assert_close(got, want, 2e-5)


@pytest.mark.parametrize("case", ["sqrt", "itakura", "unbanded", "default_band",
                                  "sliding", "sliding_itakura"])
def test_dtw_distance_matches_jax_and_dtw_batch(case):
    """The single-pair dtw_distance: JAX's at rtol 1e-5, and bit-equal to
    the port's dtw_batch entry (the same masked cost and row DP)."""
    kw, (b, t), (k, u) = CASES[case]
    q, ql, bk, bl = _inputs(b, t, k, u, seed=5)
    batch = _port(q, ql, bk, bl, DtwConfig(**kw))
    for i, j in ((0, 0), (b - 1, k - 1)):
        got = tdtw.dtw_distance(torch.from_numpy(q[i]), torch.from_numpy(bk[j]),
                                int(ql[i]), int(bl[j]), DtwConfig(**kw))
        assert got.item() == batch[i, j]
        want = float(jdtw.dtw_distance(jnp.asarray(q[i]), jnp.asarray(bk[j]),
                                       jnp.asarray(ql[i]), jnp.asarray(bl[j]),
                                       JDtwConfig(**kw)))
        _assert_close(np.float32([got.item()]), np.float32([want]), 1e-5)
    # default lengths: the whole sequences
    whole = tdtw.dtw_distance(torch.from_numpy(q[0]), torch.from_numpy(bk[0]),
                              cfg=DtwConfig(**kw))
    assert whole.item() == batch[0, 0]


def test_sliding_cases_really_slide():
    from dsp_tpu_torch.window_plan import LANE, plan_window, round_up
    for t, u in ((120, 300), (64, 200)):
        assert plan_window(0.1, t, u, 2.0)[0] < round_up(u, LANE)


def test_band_r2_and_window_offsets_match_jax():
    lens_a = np.array([1, 2, 9, 37, 120, 198], np.int32)
    lens_b = np.array([1, 5, 41, 198, 300, 33], np.int32)
    cfg, jcfg = DtwConfig(band_frac=0.1), JDtwConfig(band_frac=0.1)
    for bf in (0.1, 0.17, 0.5):
        got = tdtw.band_r2(torch.from_numpy(lens_a), torch.from_numpy(lens_b), bf)
        want = jdtw.band_r2(jnp.asarray(lens_a), jnp.asarray(lens_b), bf)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    r2 = tdtw.band_r2(torch.from_numpy(lens_a), torch.from_numpy(lens_b), 0.1)
    offs, w, rb = tdtw.window_offsets(120, 300, torch.from_numpy(lens_a),
                                      torch.from_numpy(lens_b), r2, cfg)
    for i in range(len(lens_a)):
        j_offs, jw, jrb = jdtw.window_offsets(
            120, 300, jnp.asarray(lens_a[i]), jnp.asarray(lens_b[i]),
            jnp.asarray(r2[i].item()), jcfg)
        assert (w, rb) == (jw, jrb)
        np.testing.assert_array_equal(offs[i].numpy(), np.asarray(j_offs))


def test_masked_cost_matches_jax():
    q, ql, bk, bl = _inputs(2, 40, 3, 40, seed=2)
    cfg, jcfg = DtwConfig(band_frac=0.15), JDtwConfig(band_frac=0.15)
    got = tdtw.masked_cost(torch.from_numpy(q), torch.from_numpy(ql),
                           torch.from_numpy(bk), torch.from_numpy(bl), cfg).numpy()
    for a in range(2):
        for b in range(3):
            want = np.asarray(jdtw.masked_cost(jnp.asarray(q[a]), jnp.asarray(bk[b]),
                                               jnp.asarray(ql[a]), jnp.asarray(bl[b]),
                                               jcfg))
            np.testing.assert_array_equal(got[a, b] >= 1e30, want >= 1e30)
            np.testing.assert_allclose(got[a, b], want, rtol=1e-5, atol=1e-5)


def test_chunked_batch_equals_single_chunk(monkeypatch):
    q, ql, bk, bl = _inputs(5, 30, 4, 30, seed=3)
    cfg = DtwConfig()
    whole = _port(q, ql, bk, bl, cfg)
    monkeypatch.setattr(tdtw, "_MAX_COST_CELLS", 2 * 4 * 30 * 30)
    np.testing.assert_array_equal(_port(q, ql, bk, bl, cfg), whole)


def test_wrapper_cpu_routes_to_plain_and_rejects_bad_configs():
    q, ql, bk, bl = _inputs(2, 30, 3, 30, seed=4)
    args = [torch.from_numpy(v) for v in (q, ql, bk, bl)]
    before = _build.LAUNCHES["dtw_banded"]
    got = kdtw.dtw_batch_fused_banded(*args, DtwConfig())
    assert _build.LAUNCHES["dtw_banded"] == before
    np.testing.assert_array_equal(got.numpy(), _port(q, ql, bk, bl, DtwConfig()))
    with pytest.raises(ValueError, match="max_warp_scale"):
        kdtw.dtw_batch_fused_banded(*args, DtwConfig(max_warp_scale=None))
    with pytest.raises(ValueError, match="slope"):
        kdtw.dtw_batch_fused_banded(*args, DtwConfig(slope="bogus"))
