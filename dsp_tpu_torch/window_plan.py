"""Static plan of the banded window schedule (pure Python, no deps).

A copy of ``dsp_tpu/window_plan.py``, held equal by
``tests/test_torch_config.py``.  The window it returns is part of the
banded-DTW semantics: the LANE=128 quantisation decides which cells are
valid, so the port's plain DTW (ops/dtw.py) and its CUDA kernel
(csrc/dtw_banded.cu) restrict the Sakoe-Chiba band to the *same*
sliding window as the JAX package.  The plan depends only on the padded
problem shape and the config, never on data.
"""

from __future__ import annotations

import math

LANE = 128


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_window(band_frac, t: int, u: int, max_scale: float | None = 2.0):
    """(W, S_MAX, span, row_block, covered) for problem shape [t, u].

    W        — window lanes (multiple of LANE, <= u padded to LANE)
    S_MAX    — max window advance per row_block rows (multiple of 8)
    span     — power of two >= the longest in-window horizontal run
    row_block— rows sharing one window offset (16 or 32)
    covered  — True if W provably contains the whole band for any
               lengths <= (t, u) with warp scale <= max_scale, i.e. the
               window adds no constraint beyond the band itself.
    """
    u_pad = round_up(u, LANE)
    if band_frac is None or max_scale is None:
        return u_pad, 0, u_pad, 32, True
    radius = max(1.0, band_frac * max(t, u))
    width = int(2 * radius) + 1
    w = covered = row_block = None
    for rb in (32, 16):
        drift = int(math.ceil(rb * max_scale))
        # +8 window-start slack keeps lane 0 out-of-band whenever off>0
        need = width + drift + 8 + 8 + 2
        w_rb = min(u_pad, round_up(need, LANE))
        if w is None or w_rb < w:
            w, row_block, covered = w_rb, rb, need <= w_rb or w_rb == u_pad
    s_max = 0 if w == u_pad else round_up(int(row_block * max_scale) + 8, 8)
    span = 1 << max(1, math.ceil(math.log2(min(width + 1, w))))
    return w, s_max, min(span, w), row_block, covered
