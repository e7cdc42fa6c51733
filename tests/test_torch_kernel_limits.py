"""Shape limits of the port's DTW kernels, on the CPU.

- The launch slices (``_build.row_slices``) that let kernels 1, 3 and 4
  take any batch: every row once, in order, at most 65,535 rows a launch.
- Kernel 1's launch plan (``dtw_fused_banded.launch_plan``, the host rule
  of ``csrc/dtw_banded.cu``): the staged and window modes' limits the
  wrapper's docstring states.
- The plain version the card holds kernel 1 to, against the JAX scan
  (``dsp_tpu/ops/dtw.py``) at a template longer than the staged mode's
  limit: rtol 1e-5 (the same cost GEMMs, rounded in another order), the
  BIG/finite pattern identical.
- Kernel 5's plain version against the TPU kernel in interpret mode at the
  lengths on the CUDA kernel's strip and chunk edges: equal bits (one
  exact min and one add a cell).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import DtwConfig as JDtwConfig
from dsp_tpu.kernels import dtw_pallas as jkp
from dsp_tpu.ops import dtw as jdtw

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
from dsp_tpu_torch.kernels import dtw_pallas as kwf

T = torch.from_numpy


@pytest.mark.parametrize("n", [0, 1, 65_535, 65_536, 200_001])
def test_row_slices_cover_every_row_once_in_order(n):
    slices = _build.row_slices(n)
    rows = [r for lo, hi in slices for r in range(lo, hi)]
    assert rows == list(range(n))
    assert all(0 < hi - lo <= _build.MAX_GRID_ROWS for lo, hi in slices)
    assert len(slices) == -(-n // 65_535)


@pytest.mark.parametrize("kw,staged,longest", [
    ({}, 1357, 54_428),
    ({"slope": "itakura"}, 1325, 27_201),
    ({"band_frac": None}, 1357, 54_434),
    ({"band_frac": None, "slope": "itakura"}, 1325, 27_201),
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
    # the main path keeps its staged launch at 8 warps a block
    window, warps, smem = plan(256, 198)
    assert (window, warps) == (False, 8) and smem <= kdtw.SMEM_OPTIN
    # a long template in window mode keeps 8 warps a block while they fit
    assert plan(16, 3000)[:2] == (True, 8 if not itakura else 4)


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
