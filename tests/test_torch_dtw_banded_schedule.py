"""The banded DTW kernel's walk (kernel 1) and the launch helper, on the CPU.

``kernels/dtw_fused_banded.py:strip_columns`` is the column range that
``csrc/dtw_banded.cu`` walks, strip by strip, written once in Python.  It
must hold every valid cell of the reference's windowed band
(``dsp_tpu/golden/dtw.py:windowed_band_mask``) and no row outside the
query's length, and with ``band_frac=None`` it must walk whole rows.
``cost_tiles`` is the kernel's rule for the 4 x 4 tiles whose costs it
computes: every valid cell in exactly one tile, no tile without a valid
cell, and few cells more than the valid ones.

Off the card no wrapper may reach ``_build``: with its library and launch
helper made to raise, CPU tensors still take each kernel's plain version.
"""

import numpy as np
import pytest
import torch

from dsp_tpu.golden.dtw import windowed_band_mask
from dsp_tpu.window_plan import plan_window
from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_fused as kfu
from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
from dsp_tpu_torch.kernels import dtw_pallas as kwf
from dsp_tpu_torch.kernels import mb_wavefront as kmb
from dsp_tpu_torch.kernels import mfcc_fused as kmf
from dsp_tpu_torch.kernels import spot_fused as ksp

# (T, U): the main path's shape, chip_smoke.py's sliding case and the
# benchmark's Speech Commands clips
MAIN, SLIDING, SC2 = (198, 198), (120, 300), (98, 98)
EDGE_LENGTHS = (1, 2, 31, 32, 33, 63, 64, 65)


def _pairs(t_pad: int, u_pad: int, seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    pairs = [(int(a), int(b)) for a, b in zip(rng.integers(1, t_pad + 1, n),
                                              rng.integers(1, u_pad + 1, n))]
    pairs += [(a, b) for a in EDGE_LENGTHS + (t_pad,) for b in (1, 33, u_pad)
              if a <= t_pad]
    return pairs


def _walked(strips, la: int, lb: int) -> np.ndarray:
    """[la, lb] bool: the cells the kernel visits; rows must tile [0, la)."""
    seen = np.zeros((la, lb), dtype=bool)
    next_row = 0
    for r0, r1, jlo, jhi in strips:
        assert r0 == next_row and r0 % kdtw.STRIP == 0
        assert r0 <= r1 < min(r0 + kdtw.STRIP, la)
        assert 0 <= jlo <= jhi < lb
        seen[r0:r1 + 1, jlo:jhi + 1] = True
        next_row = r1 + 1
    return seen


@pytest.mark.parametrize("shape", [MAIN, SLIDING], ids=["main", "sliding"])
@pytest.mark.parametrize("band_frac", [0.1, 0.17, 0.2])
def test_strip_columns_hold_every_valid_cell(shape, band_frac):
    t_pad, u_pad = shape
    cfg = DtwConfig(band_frac=band_frac, max_warp_scale=2.0)
    w, s_max, _, rb, _ = plan_window(band_frac, t_pad, u_pad, 2.0)
    for la, lb in _pairs(t_pad, u_pad, seed=int(band_frac * 100) + t_pad):
        strips = kdtw.strip_columns(la, lb, cfg, t_pad, u_pad)
        seen = _walked(strips, la, lb)
        valid = windowed_band_mask(la, lb, band_frac, window=w, row_block=rb,
                                   s_max=s_max)
        assert not (valid & ~seen).any(), (la, lb)
        # the band is walked, not the row: a strip starts at its first row's
        # first valid cell and ends at its last row's last one
        for r0, r1, jlo, jhi in strips:
            if valid[r0].any():
                assert jlo == np.flatnonzero(valid[r0])[0], (la, lb, r0)
            if valid[r1].any():
                assert jhi == np.flatnonzero(valid[r1])[-1], (la, lb, r1)


@pytest.mark.parametrize("shape", [MAIN, SLIDING], ids=["main", "sliding"])
def test_strip_columns_unbanded_walk_whole_rows(shape):
    t_pad, u_pad = shape
    cfg = DtwConfig(band_frac=None)
    for la, lb in _pairs(t_pad, u_pad, seed=7):
        strips = kdtw.strip_columns(la, lb, cfg, t_pad, u_pad)
        assert [(r0, r1) for r0, r1, _, _ in strips] == [
            (r0, min(r0 + kdtw.STRIP, la) - 1) for r0 in range(0, la, kdtw.STRIP)]
        assert all((jlo, jhi) == (0, lb - 1) for _, _, jlo, jhi in strips)
        assert _walked(strips, la, lb).all()


def test_strip_columns_walk_the_band_not_the_row():
    """At the main shape a strip walks ~2 * 0.17 * 198 + 31 columns, far
    fewer than U + 31."""
    cfg = DtwConfig()
    strips = kdtw.strip_columns(198, 198, cfg, *MAIN)
    widths = [jhi - jlo + 1 + (r1 - r0) for r0, r1, jlo, jhi in strips]
    assert len(strips) == 7 and max(widths) < 198 // 2 + 31


def _valid(la: int, lb: int, band_frac, t_pad: int, u_pad: int) -> np.ndarray:
    if band_frac is None:
        return np.ones((la, lb), dtype=bool)
    w, s_max, _, rb, _ = plan_window(band_frac, t_pad, u_pad, 2.0)
    return windowed_band_mask(la, lb, band_frac, window=w, row_block=rb, s_max=s_max)


@pytest.mark.parametrize("shape", [MAIN, SLIDING, SC2], ids=["main", "sliding", "sc2"])
@pytest.mark.parametrize("band_frac", [0.1, 0.17, 0.2, None])
def test_cost_tiles_hold_every_valid_cell_once(shape, band_frac):
    t_pad, u_pad = shape
    cfg = DtwConfig(band_frac=band_frac, max_warp_scale=2.0)
    side = kdtw.TILE_SIDE
    for la, lb in _pairs(t_pad, u_pad, seed=int((band_frac or 0) * 100) + t_pad + 1):
        tiles = kdtw.cost_tiles(la, lb, cfg, t_pad, u_pad)
        valid = _valid(la, lb, band_frac, t_pad, u_pad)
        held = np.zeros((la + side, lb + side), dtype=int)
        for i0, j0 in tiles:
            assert i0 % side == 0 and 0 <= i0 < la and 0 <= j0 < lb, (la, lb, i0, j0)
            held[i0:i0 + side, j0:j0 + side] += 1
            # no tile wholly outside the band
            assert valid[i0:i0 + side, j0:j0 + side].any(), (la, lb, i0, j0)
        assert (held[:la, :lb][valid] == 1).all(), (la, lb)


@pytest.mark.parametrize("n", [40, 70, 98])
def test_cost_tiles_compute_near_the_valid_cells(n):
    """At T = 98 the tiles hold at most 1.5x the valid cells, under half
    the walked parallelogram's (3-6x them)."""
    cfg = DtwConfig()
    side = kdtw.TILE_SIDE
    computed = side * side * len(kdtw.cost_tiles(n, n, cfg, *SC2))
    walked = sum(kdtw.STRIP * ((jhi - jlo + 1) + (r1 - r0))
                 for r0, r1, jlo, jhi in kdtw.strip_columns(n, n, cfg, *SC2))
    valid = kdtw.valid_cells(n, n, cfg, *SC2)
    assert computed <= 1.5 * valid and 2 * computed < walked


def _rng_tensor(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _lens(n, hi, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(1, hi + 1, n)
                            .astype(np.int32))


def _dtw_args():
    return (_rng_tensor((3, 20, 5)), _lens(3, 20), _rng_tensor((2, 24, 5), 2),
            _lens(2, 24, 3))


def _cost_args():
    cost = torch.abs(_rng_tensor((4, 9, 11)))
    return cost, _lens(4, 9), _lens(4, 11, 4)


def _dp_args():
    rng = np.random.default_rng(5)
    kt = torch.from_numpy(rng.integers(-1, 9, (3, 1)).astype(np.int32))
    la = torch.from_numpy(rng.integers(0, 34, (3, 1)).astype(np.int32))
    return _rng_tensor((3, 8, 32)), kt, la


# (wrapper on CPU tensors, its plain version), one per kernel
CASES = {
    "dtw_banded": (lambda: kdtw.dtw_batch_fused_banded(*_dtw_args(), DtwConfig()),
                   lambda: kdtw.dtw_batch_plain(*_dtw_args(), DtwConfig())),
    "mfcc_fused": (lambda: kmf.mfcc_frames_fused(_rng_tensor((6, 400))),
                   lambda: kmf.mfcc_frames_plain(_rng_tensor((6, 400)))),
    "spot_subseq": (lambda: ksp.subseq_dtw_fused(*_dtw_args())[0],
                    lambda: ksp.subseq_dtw_batch_plain(*_dtw_args())[0]),
    "dtw_fused": (lambda: kfu.dtw_batch_fused(*_dtw_args()),
                  lambda: kfu.dtw_batch_fused_plain(*_dtw_args())),
    "dtw_wavefront": (lambda: kwf.dtw_from_cost_pallas(*_cost_args()),
                      lambda: kwf.dtw_from_cost_plain(*_cost_args())),
    "mb_dp_diet": (lambda: kmb.dp_diet(*_dp_args()),
                   lambda: kmb.dp_diet_plain(*_dp_args())),
    "mb_dma_fetch": (lambda: kmb.dma_fetch(*_dp_args()[:2]),
                     lambda: kmb.dma_fetch_plain(*_dp_args()[:2])),
    "mb_trivial": (lambda: kmb.trivial(_rng_tensor((3, 5))),
                   lambda: kmb.trivial_plain(_rng_tensor((3, 5)))),
    "mb_transpose": (lambda: kmb.transpose(_rng_tensor((2, 3, 5))),
                     lambda: kmb.transpose_plain(_rng_tensor((2, 3, 5)))),
    "mb_skew": (lambda: kmb.skew(_rng_tensor((2, 4, 5)), 9),
                lambda: kmb.skew_plain(_rng_tensor((2, 4, 5)), 9)),
    "mb_anatomy": (lambda: kmb.anatomy(_rng_tensor((2, 32)), 2, 5),
                   lambda: kmb.anatomy_plain(_rng_tensor((2, 32)), 2, 5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_tensors_never_reach_the_launch_helper(monkeypatch, name):
    def refuse(*args, **kwargs):
        raise AssertionError("the launch path was reached off the card")

    monkeypatch.setattr(_build, "lib", refuse)
    monkeypatch.setattr(_build, "launch", refuse)
    before = dict(_build.LAUNCHES)
    fn, plain = CASES[name]
    got, want = fn(), plain()
    assert torch.equal(got, want)
    assert _build.LAUNCHES == before


def test_launch_counts_every_entry_point_and_resets():
    assert set(_build.LAUNCHES) == set(_build._SIGNATURES)
    saved = dict(_build.LAUNCHES)
    try:
        _build.LAUNCHES["dtw_banded"] += 3
        _build.reset_launches()
        assert not any(_build.LAUNCHES.values())
    finally:
        _build.LAUNCHES.update(saved)
