"""Operations of a GMM-HMM request, from shapes and lengths: the
arithmetic of ``hmm_request_mfu``.

* the front end's, from shapes (``roofline.frontend_flops``);
* the emissions at every padded frame: B T W S M (3F + 3) (each Gaussian
  a difference, a square and a scaling a feature, and its constant, the
  mixture weight and the log-sum-exp's share);
* the decode at 3 operations (two adds and a max over the two
  predecessors of a left-to-right topology) for each of the W S states
  of every valid frame, at the lengths the endpoint detector gives.

Every count is the same whatever kernels compute it.
"""

from __future__ import annotations

import numpy as np

from benchmark import roofline


def emission_flops(n_utts: int, t_max: int, n_words: int, n_states: int, n_mix: int,
                   n_feats: int) -> float:
    return float(n_utts) * t_max * n_words * n_states * n_mix * (3.0 * n_feats + 3.0)


def decode_flops(lens, n_words: int, n_states: int) -> float:
    return 3.0 * n_words * n_states * float(np.sum(np.asarray(lens, dtype=np.int64)))


def request_flops(rec: dict, lens) -> float:
    """One request of ``rec["batch"]`` clips whose feature lengths are ``lens``."""
    return (roofline.frontend_flops(rec["batch"], rec["n_samples"], rec["t_max"],
                                    rec["frame_len"], rec["hop"], rec["n_fft"], rec["n_mels"],
                                    rec["n_mfcc"])
            + emission_flops(rec["batch"], rec["t_max"], rec["n_words"], rec["n_states"],
                             rec["n_mix"], rec["n_feats"])
            + decode_flops(lens, rec["n_words"], rec["n_states"]))
