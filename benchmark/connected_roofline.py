"""Operations of a connected-digit request, from shapes and lengths: the
arithmetic of ``connected_request_mfu``.

* the front end's, from shapes (``roofline.frontend_flops``);
* the emissions of every topology at every padded frame: B T W S M (3F +
  3) a topology (each Gaussian a difference, a square and a scaling a
  feature, and its constant, the mixture weight and the log-sum-exp's
  share);
* the level DP at the valid frames: each level, 2 operations (an add and
  a max) for each allowed transition of every unit and 3 (the entry's
  add, its max and the emission's add) for each state.

Every count is the same whatever kernels compute it.
"""

from __future__ import annotations

import numpy as np

from benchmark import roofline


def emission_flops(n_utts: int, t_max: int, groups, n_feats: int) -> float:
    """``groups``: (units, states, mixtures) of each topology."""
    return float(n_utts) * t_max * sum(w * s * m for w, s, m in groups) * (3.0 * n_feats + 3.0)


def dp_flops(lens, groups, transitions: int, max_levels: int) -> float:
    states = sum(w * s for w, s, _ in groups)
    frames = float(np.sum(np.asarray(lens, dtype=np.int64)))
    return max_levels * frames * (2.0 * transitions + 3.0 * states)


def request_flops(rec: dict, lens) -> float:
    """One request of ``rec["batch"]`` strings whose feature lengths are ``lens``."""
    return (roofline.frontend_flops(rec["batch"], rec["n_samples"], rec["t_max"],
                                    rec["frame_len"], rec["hop"], rec["n_fft"], rec["n_mels"],
                                    rec["n_mfcc"])
            + emission_flops(rec["batch"], rec["t_max"], rec["groups"], rec["n_feats"])
            + dp_flops(lens, rec["groups"], rec["transitions"], rec["max_levels"]))
