"""Data-parallel GMM-HMM training (port of ``dsp_tpu/parallel/em.py``).

Each 'data' shard Viterbi-aligns its slice of the utterances and computes
additive sufficient statistics (``SuffStats``); one ``all_reduce`` (SUM)
over the 'data' axis adds them across the mesh, and the closed-form
M-step then gives the same new parameters on every rank: the
reduce-gradients / apply-update shape of data-parallel training, with
sufficient statistics in place of gradients.

:func:`fit_words_sharded` is the batched fit of every word model under a
mesh: words split over 'bank', utterances over 'data' (the layout the
JAX package gives ``fit_words_batched`` by placing its inputs on the mesh).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from dsp_tpu_torch.config import HmmConfig
from dsp_tpu_torch.models.gmm_hmm import (HmmParams, SuffStats, _params_from_stats,
                                          _suff_stats, em_suff_stats, init_params)
from dsp_tpu_torch.parallel.mesh import (BANK_AXIS, DATA_AXIS, as_mesh, coordinate,
                                         gather, mesh_shape, psum, replicate,
                                         shard_queries)


def _psum_stats(stats: SuffStats, mesh: DeviceMesh) -> SuffStats:
    return SuffStats(*(psum(s, mesh, DATA_AXIS) for s in stats))


def em_step_sharded(mesh: DeviceMesh, feats, lengths, params: HmmParams,
                    cfg: HmmConfig):
    """One distributed segmental-EM step.

    Args:
      feats:   [N, T, F], N divisible by the 'data' size (global, the same
               on every rank).
      lengths: [N].
      params:  HmmParams of ONE word model.

    Returns (new HmmParams, total loglik scalar), the same on every rank.
    """
    mesh = as_mesh(mesh)
    fl, ll = shard_queries(mesh, feats, lengths)
    prm = HmmParams(*replicate(mesh, *params))
    stats = _psum_stats(em_suff_stats(fl, ll, prm, cfg), mesh)
    return _params_from_stats(stats, prm, cfg), stats.loglik


def fit_words_sharded(mesh: DeviceMesh, feats_w: torch.Tensor,
                      lengths_w: torch.Tensor, jitter_w: torch.Tensor | None,
                      cfg: HmmConfig, prior: HmmParams | None = None) -> HmmParams:
    """``models/gmm_hmm.py:fit_words_batched`` over a mesh: word w's EM
    runs on the bank shard that holds w, its utterances split over 'data'
    with the statistics summed every iteration; the fitted words are
    gathered over 'bank' at the end.  Needs W divisible by 'bank' and N by
    'data'.  The initial parameters are computed from the whole batch on
    every rank, so each rank starts from the same draw."""
    mesh = as_mesh(mesh)
    nd, nb = mesh_shape(mesh)
    w, n = lengths_w.shape
    if w % nb or n % nd:
        raise ValueError(f"{w} words x {n} utterances do not split over a "
                         f"{nd}x{nb} mesh")
    d, b = coordinate(mesh)
    words = slice(b * (w // nb), (b + 1) * (w // nb))
    utts = slice(d * (n // nd), (d + 1) * (n // nd))
    if prior is not None and cfg.map_tau > 0:
        params = HmmParams(*(a.expand(w, *a.shape).contiguous() for a in prior))
    else:
        params = init_params(feats_w, lengths_w, cfg, jitter_w)
    params = HmmParams(*replicate(mesh, *(a[words] for a in params)))
    fl, ll = replicate(mesh, feats_w[words, utts], lengths_w[words, utts])
    if prior is not None:
        prior = HmmParams(*replicate(mesh, *prior))
    for _ in range(cfg.n_iter):
        stats = _psum_stats(_suff_stats(fl, ll, params, cfg), mesh)
        params = _params_from_stats(stats, params, cfg, prior)
    return HmmParams(*(gather(a, mesh, BANK_AXIS) for a in params))
