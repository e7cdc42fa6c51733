"""The DP cell counts (the reference's mask summed) against a
brute-force loop and the port's own count."""

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.reference import plain


def _brute(la, lb, t, u, band, scale):
    """Cell by cell, the band and window rule written out with loops."""
    w, s_max, rb = plain.plan_window(band, t, u, scale)
    windowed = band is not None and scale is not None and w < plain.round_up(u, plain.LANE)
    lam1, lbm1 = max(la - 1, 1), lb - 1
    r2 = 0
    if band is not None:
        radius = max(np.float32(1.0), np.float32(band) * np.float32(max(la, lb)))
        r2 = int(np.floor(np.float32(radius) * np.float32(lam1)))
    offs, prev = [], 0
    for blk in range(-(-t // rb)):
        jlo = -(-max(blk * rb * lbm1 - r2, 0) // lam1)
        prev = min(max(jlo // 8 * 8 - 8, 0), (max(lb - w, 0) + 7) // 8 * 8, prev + s_max)
        offs.append(prev)
    n = 0
    for i in range(la):
        for j in range(lb):
            ok = band is None or abs(j * lam1 - i * lbm1) <= r2
            if windowed:
                ok = ok and offs[i // rb] <= j < offs[i // rb] + w
            n += ok
    return n


def _pairs(t):
    rng = np.random.default_rng(t)
    return [(1, 1), (t, t), (1, t), (t, 1)] + [tuple(int(v) for v in rng.integers(1, t + 1, 2))
                                               for _ in range(12)]


@pytest.mark.parametrize("t,band,scale", [(40, 0.17, 2.0), (198, 0.17, 2.0), (98, 0.17, 2.0),
                                          (30, None, None), (150, 0.1, 2.0)])
def test_pair_cells_against_brute_force(t, band, scale):
    pairs = _pairs(t)
    got = roofline.pair_cells([a for a, _ in pairs], [b for _, b in pairs], t, t, band, scale)
    assert got.tolist() == [_brute(a, b, t, t, band, scale) for a, b in pairs]


@pytest.mark.parametrize("t,band,scale", [(40, 0.17, 2.0), (30, None, None)])
def test_cell_table_holds_every_pair(t, band, scale):
    table = roofline.cell_table(t, t, band, scale)
    assert table.shape == (t + 1, t + 1) and not table[0].any() and not table[:, 0].any()
    for la, lb in _pairs(t):
        assert table[la, lb] == _brute(la, lb, t, t, band, scale), (la, lb)


def test_pair_cells_against_the_port():
    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels.dtw_fused_banded import valid_cells

    t = 198
    cfg = DtwConfig(band_frac=0.17, max_warp_scale=2.0)
    pairs = [(198, 198), (40, 90), (90, 40), (120, 60), (1, 198), (98, 98), (13, 30)]
    got = roofline.pair_cells([a for a, _ in pairs], [b for _, b in pairs], t, t, 0.17, 2.0)
    assert got.tolist() == [valid_cells(a, b, cfg, t, t) for a, b in pairs]


def test_dtw_cells_sums_the_pairs():
    table = roofline.cell_table(20, 20, 0.17, 2.0)
    q, b = np.array([5, 20, 20]), np.array([7, 11])
    assert roofline.dtw_cells(q, b, table) == sum(table[x, y] for x in q for y in b)


def test_least_time_takes_the_binding_bound():
    assert roofline.least_seconds(67e12, 0.0) == 1.0
    assert roofline.least_seconds(0.0, 6.7e12) == 2.0
