"""Shape limits of the port's DTW kernels, on the CPU.

- The launch slices (``_build.row_slices``) that let kernels 1, 3 and 4
  take any batch: every row once, in order, at most 65,535 rows a launch.
- Kernel 1's launch plan (``dtw_fused_banded.launch_plan`` and
  ``queries_a_block``, the host's rule for ``csrc/dtw_banded.cu``): the
  staged and window modes' limits the wrapper's docstring states, and how
  a launch's queries spread over its blocks.
- The plain version the card holds kernel 1 to, against the JAX scan
  (``dsp_tpu/ops/dtw.py``) at a template longer than the staged mode's
  limit: rtol 1e-5 (the same cost GEMMs, rounded in another order), the
  BIG/finite pattern identical.
- Kernel 5's plain version against the TPU kernel in interpret mode at the
  lengths on the CUDA kernel's strip and chunk edges: equal bits (one
  exact min and one add a cell).
- Kernels 4 and 3's walks (``dtw_fused.strips``, ``spot_fused.strips``):
  every cell inside the lengths exactly once, plus the stated ramp; their
  launch plans (no length bounded by shared memory: window mode keeps the
  edge rows or columns in device memory).
- The plain versions the card holds kernels 4 and 3 to, against the JAX
  unbanded scan and the JAX spotting scan at a template of 1,100 frames,
  past the first kernels' 1,024-frame limit: kernel 4 at rtol 1e-4 /
  atol 1e-5 (tests/test_pallas_dtw.py:103), kernel 3 at rtol 2e-4 /
  atol 1e-5 with equal witnesses (tests/test_torch_spot.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import DtwConfig as JDtwConfig
from dsp_tpu.kernels import dtw_pallas as jkp
from dsp_tpu.ops import dtw as jdtw
from dsp_tpu.ops import spot as jsp

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
from dsp_tpu_torch.kernels import dtw_fused as kfu
from dsp_tpu_torch.kernels import dtw_pallas as kwf
from dsp_tpu_torch.kernels import spot_fused as ksp

T = torch.from_numpy


@pytest.mark.parametrize("n", [0, 1, 65_535, 65_536, 200_001])
def test_row_slices_cover_every_row_once_in_order(n):
    slices = _build.row_slices(n)
    rows = [r for lo, hi in slices for r in range(lo, hi)]
    assert rows == list(range(n))
    assert all(0 < hi - lo <= _build.MAX_GRID_ROWS for lo, hi in slices)
    assert len(slices) == -(-n // 65_535)


@pytest.mark.parametrize("kw,staged,longest", [
    ({}, 1369, 54_770),
    ({"slope": "itakura"}, 1335, 27_372),
    ({"band_frac": None}, 1369, 54_776),
    ({"band_frac": None, "slope": "itakura"}, 1335, 27_372),
])
def test_kernel1_launch_plan_limits(kw, staged, longest):
    """At F = 39 and T = 198: the longest template staged whole in a
    one-warp block, and the longest the window mode takes."""
    cfg = DtwConfig(**kw)
    itakura = cfg.slope == "itakura"

    def plan(b, u):
        return kdtw.launch_plan(b, 198, u, 39, kdtw._window(cfg, 198, u)[2], itakura)

    assert plan(1, staged)[0] is False and plan(1, staged + 1)[0] is True
    assert kdtw.max_template_frames(198, 39, cfg) == longest
    assert plan(1, longest)[2] <= kdtw.SMEM_OPTIN < plan(1, longest + 1)[2]
    # the main path keeps its staged launch, at the block size that keeps
    # most warps on an SM: one block of 14 (13 with Itakura)
    window, warps, smem = plan(256, 198)
    assert (window, warps) == (False, 14 if not itakura else 13)
    rb = kdtw._window(cfg, 198, 198)[2]
    assert smem <= kdtw.SMEM_OPTIN < kdtw.smem_bytes(warps + 1, 198, 198, 39, rb, itakura, False)
    assert kdtw.resident_warps(warps, smem) == warps
    # a long template in window mode: as many warps as fit one block
    assert plan(16, 3000)[:2] == (True, 9 if not itakura else 6)


@pytest.mark.parametrize("b,k,t,u", [(256, 2240, 98, 98), (1024, 100, 198, 198),
                                     (256, 100, 198, 198), (64, 32, 120, 300),
                                     (16, 8, 198, 1369), (1, 100, 198, 198), (9, 5, 98, 98),
                                     (65_535, 2, 8, 8)])
def test_kernel1_queries_a_block(b, k, t, u):
    """A launch's queries fill its blocks evenly, at most 8 a warp: 8 where
    the pairs keep every warp the card holds on 4 or more, one a warp where
    they cannot fill it."""
    window, warps, smem = kdtw.launch_plan(b, t, u, 39, kdtw._window(DtwConfig(), t, u)[2],
                                           False)
    per = kdtw.queries_a_block(b, k, warps, smem)
    blocks = -(-b // per)
    assert 1 <= per <= warps * kdtw.PAIRS_A_WARP
    assert per * blocks - b < blocks     # no block takes two fewer than another
    held = kdtw.SM_COUNT * kdtw.resident_warps(warps, smem)
    if b * k >= 4 * held * kdtw.PAIRS_A_WARP:
        assert blocks == -(-b // (warps * kdtw.PAIRS_A_WARP))
    if b * k < 8 * held:
        assert per <= warps


def test_kernel1_queries_a_block_past_the_shared_memory():
    """One frame past the longest template: no SM holds the block, and the
    queries still land in blocks (the launch then fails at the entry)."""
    cfg = DtwConfig()
    u = kdtw.max_template_frames(20, 39, cfg) + 1
    window, warps, smem = kdtw.launch_plan(1, 20, u, 39, kdtw._window(cfg, 20, u)[2], False)
    assert smem > kdtw.SMEM_OPTIN and kdtw.resident_warps(warps, smem) == 0
    assert kdtw.queries_a_block(1, 1, warps, smem) == 1


@pytest.mark.parametrize("kw", [{}, {"band_frac": None}, {"squared": True},
                                {"slope": "itakura"}])
def test_plain_matches_jax_scan_past_the_staged_limit(kw):
    b, k, t, u, f = 2, 2, 40, 1600, 39
    rng = np.random.default_rng(17)
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    # (40, 1600) lies outside the band, window and slope; (35, 70) and
    # (40, 70) inside them
    ql = np.array([t, 35], np.int32)
    bl = np.array([u, 70], np.int32)
    cfg = DtwConfig(**kw)
    # the staged mode would not hold this template: the window mode runs it
    assert kdtw.launch_plan(b, t, u, f, kdtw._window(cfg, t, u)[2],
                            cfg.slope == "itakura")[0]
    got = kdtw.dtw_batch_plain(T(q), T(ql), T(bank), T(bl), cfg).numpy()
    want = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank),
                                     jnp.asarray(bl), JDtwConfig(**kw)))
    assert ((got >= 1e20) == (want >= 1e20)).all()
    fin = want < 1e20
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


# lengths at the CUDA kernel's strip (32 rows) and chunk (32 steps) edges
EDGE_LENGTHS = [1, 31, 32, 33, 63, 64, 65]


@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_wavefront_plain_matches_jax_interpret_at_strip_edges(length):
    t, u = 65, 70
    rng = np.random.default_rng(length)
    cost = (rng.standard_normal((4, t, u)) ** 2).astype(np.float32)
    cost[rng.random(cost.shape) < 0.05] = kwf.BIG
    # the edge length as la, then as lb, each against a full and a short side
    la = np.array([length, length, t, 40], np.int32)
    lb = np.array([u, 47, length, length], np.int32)
    got = kwf.dtw_from_cost_pallas(T(cost), T(la), T(lb)).numpy()
    want = np.asarray(jkp.dtw_from_cost_pallas(jnp.asarray(cost), jnp.asarray(la),
                                               jnp.asarray(lb), interpret=True))
    np.testing.assert_array_equal(got, want)


WALK_LENGTHS = [(1, 1), (1, 40), (31, 1), (32, 32), (33, 31), (64, 65), (65, 64),
                (70, 198)]


def _walk_cells(walk):
    """(cells a lane-step computes, lane-steps) of a walk given as
    (start, n_lanes, n_steps) strips: lane l at step s of a strip is at
    (start + l, s - l) if that lies inside the other length."""
    cells, lane_steps = [], 0
    for start, n_lanes, n_steps, other in walk:
        lane_steps += kfu.STRIP * n_steps
        for lane in range(n_lanes):
            cells += [(start + lane, s - lane) for s in range(n_steps)
                      if 0 <= s - lane < other]
    return cells, lane_steps


@pytest.mark.parametrize("la,lb", WALK_LENGTHS)
def test_kernel4_walk_visits_each_cell_once_plus_the_ramp(la, lb):
    strips = kfu.strips(la, lb, 80, 200)
    cells, lane_steps = _walk_cells([(r0, n, steps, lb) for r0, n, steps in strips])
    assert sorted(cells) == [(i, j) for i in range(la) for j in range(lb)]
    # each strip of n rows walks lb + n - 1 steps: the ramp is 32 x that
    # less the strip's n x lb cells
    assert [r0 for r0, _, _ in strips] == list(range(0, la, 32))
    assert lane_steps == sum(32 * (lb + n - 1) for _, n, _ in strips)
    assert kfu.cost_cells(la, lb, 80, 200) == len(strips) * 32 * -(-lb // 8) * 8


@pytest.mark.parametrize("sl,tl", WALK_LENGTHS)
def test_kernel3_walk_visits_each_cell_once_plus_the_ramp(sl, tl):
    strips = ksp.strips(sl, tl, 200, 200)
    cells, lane_steps = _walk_cells([(c0, n, steps, tl) for c0, n, steps in strips])
    # (stream column, template row), every one once
    assert sorted(cells) == [(j, i) for j in range(sl) for i in range(tl)]
    assert lane_steps == sum(32 * (tl + n - 1) for _, n, _ in strips)
    assert ksp.cost_cells(sl, tl, 200, 200) == len(strips) * 32 * -(-tl // 8) * 8


def test_kernel_walks_clamp_lengths_as_the_kernels_do():
    assert kfu.strips(0, 500, 40, 50) == [(0, 1, 50)]
    assert ksp.strips(0, 500, 40, 50) == [(0, 1, 50)]


def test_kernel4_launch_plan_limits():
    """At F = 39: the main path keeps 8 warps a block in staged mode; the
    longest template staged whole, then window mode, whose edge rows live
    in device memory, so no length is bounded by shared memory; the query
    length is no argument of the plan (a strip stages 32 rows)."""
    window, warps, smem = kfu.launch_plan(256, 198, 39)
    assert (window, warps) == (False, 8)
    assert kfu.resident_warps(warps, smem) == kfu.SM_WARPS     # two blocks an SM
    assert kfu.launch_plan(3, 198, 39)[:2] == (False, 3)       # no idle warp
    assert kfu.launch_plan(1, 1312, 39)[0] is False
    assert kfu.launch_plan(1, 1313, 39)[0] is True
    for u in (1313, 54_429, 10**6):
        for f in (39, 128, 300):
            window, warps, smem = kfu.launch_plan(2, u, f)
            assert window and warps in (1, 2) and smem <= kfu.SMEM_OPTIN
    # window mode's query slices keep the edge rows within the scratch budget
    assert kfu.window_rows(8, 4000) == kfu.WINDOW_SCRATCH_FLOATS // (8 * 4000)
    assert kfu.window_rows(1, 10**9) == 1
    assert kfu.window_rows(1, 2) == _build.MAX_GRID_ROWS


def test_kernel3_launch_plan_limits():
    """Kernel 3 stages the template whole where it fits one warp's block and
    otherwise runs in window mode with its edge columns in device memory:
    1,100 frames at F = 39 staged, 600 at F = 128 in window mode, and any
    length beyond.  Warps a stream: one where the pairs fill the card (the
    spotting bench's 64 x 100), more where they are few (4 x 100 pairs of
    60 s streams), never more than the strips, and never more warps in
    all than the card holds of the chosen block."""
    # 7 warps a block: two blocks an SM, where 8 would leave one
    assert ksp.launch_plan(64, 100, 598, 198, 39) == (False, 7, 1, ksp.smem_bytes(7, 198, 39, False))
    assert ksp.launch_plan(4, 100, 5998, 198, 39)[:3] == (False, 6, 2)
    assert ksp.launch_plan(1, 100, 5998, 198, 39)[2] == 8
    assert ksp.launch_plan(4, 100, 40, 198, 39)[2] == 1       # one strip
    for b, k, u, t in ((4, 100, 5998, 198), (2, 100, 5998, 198), (2, 100, 300, 1100),
                       (3, 2, 300, 198), (2, 100, 300, 600)):
        _, warps, w_pair, smem = ksp.launch_plan(b, k, u, t, 39)
        assert w_pair == 1 or b * k * w_pair <= ksp.SM_COUNT * kfu.resident_warps(warps, smem)
    assert ksp.launch_plan(1, 1, 100, 1280, 39)[0] is False
    assert ksp.launch_plan(1, 1, 100, 1281, 39)[0] is True
    assert ksp.launch_plan(1, 1, 100, 320, 128)[0] is False
    assert ksp.launch_plan(1, 1, 100, 321, 128)[0] is True
    assert ksp.launch_plan(2, 2, 300, 1100, 39)[0] is False
    assert ksp.launch_plan(2, 2, 300, 600, 128)[0] is True
    for t in (1281, 8000, 10**6):
        for f in (39, 128):
            window, warps, w_pair, smem = ksp.launch_plan(2, 2, 300, t, f)
            assert window and smem <= ksp.SMEM_OPTIN and warps % w_pair == 0
    assert ksp.window_rows(4, 1100) == ksp.WINDOW_SCRATCH_WORDS // (4 * 8 * 2 * 1100)


@pytest.mark.parametrize("squared", [False, True])
def test_fused_plain_matches_jax_scan_at_a_long_template(squared):
    b, k, t, u, f = 2, 2, 30, 1100, 13
    rng = np.random.default_rng(23)
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = np.array([t, 17], np.int32)
    bl = np.array([u, 1040], np.int32)
    cfg = DtwConfig(band_frac=None, squared=squared)
    got = kfu.dtw_batch_fused_plain(T(q), T(ql), T(bank), T(bl), cfg).numpy()
    want = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank),
                                     jnp.asarray(bl), JDtwConfig(band_frac=None,
                                                                 squared=squared)))
    assert (want < 1e20).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("squared", [False, True])
def test_spot_plain_matches_jax_scan_at_a_long_template(squared):
    b, k, u, t, f = 2, 2, 1300, 1100, 13
    rng = np.random.default_rng(29)
    streams = rng.standard_normal((b, u, f)).astype(np.float32)
    bank = rng.standard_normal((k, t, f)).astype(np.float32)
    s_lens = np.array([u, 1150], np.int32)
    b_lens = np.array([t, 1030], np.int32)
    got = [x.numpy() for x in ksp.subseq_dtw_batch_plain(T(streams), T(s_lens), T(bank),
                                                         T(b_lens), squared)]
    want = [np.asarray(x) for x in jsp.subseq_dtw_batch(
        jnp.asarray(streams), jnp.asarray(s_lens), jnp.asarray(bank), jnp.asarray(b_lens),
        squared=squared, impl="scan")]
    for bi, sl in enumerate(s_lens):
        np.testing.assert_allclose(got[0][bi, :, :sl], want[0][bi, :, :sl],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_array_equal(got[1][bi, :, :sl], want[1][bi, :, :sl])
        assert (got[0][bi, :, sl:] >= 1e20).all()

