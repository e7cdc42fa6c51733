"""GMM-HMM isolated-word recognizer (port of ``dsp_tpu/models/gmm_hmm.py``).

BASELINE config 3: one left-to-right HMM a word (start in state 0,
transitions stay or advance) with diagonal-Gaussian mixture emissions.

* **Emission scoring is a matrix product.**  The Gaussian log-likelihood
  expands as ``-0.5 (x^2 . v^-1 - 2 x . (mu v^-1) + c + F log 2 pi)``, so
  scoring a feature batch against every (word, state, mixture) at once is
  one ``[B*T, F] @ [F, W*S*M]`` product; no [., ., F] broadcast tensor is
  built.  The expanded form is kept (not ``(x - mu)^2``) so that scores
  match the JAX package's.
* **Decode is one batched loop** (``ops/viterbi.py``): log-space Viterbi
  over [B, W, S] log-deltas scores a whole utterance batch against the
  whole vocabulary.
* **Training** is segmental (Viterbi) EM or Baum-Welch (``HmmConfig.
  train_mode``) from a uniform segmentation, with a universal background
  GMM (UBM) fitted over every frame, the MAP prior when ``map_tau > 0``
  and the filler model of the utterance-verification LLR.  Every word
  trains at once along a leading word axis (the JAX package's ``vmap``);
  ``n_iter`` iterations are a Python loop (its ``fori_loop``).

Precision: the three expanded terms are large and cancel, and the EM
moments take ``E[x^2] - mean^2``; reduced precision corrupts both (bf16
gave chance-level decoding and broken fitted models on the TPU, the JAX
package's ``Precision.HIGHEST`` notes).  Every product here is a float32
``torch.matmul`` / ``torch.einsum``, and the package turns TF32 off for
all of them on the card (``dsp_tpu_torch/__init__.py``); this module
relies on that and adds no autocast.

Deviations the tests pin: the initial jitter is a standard-normal draw
from a ``torch.Generator`` on the CPU seeded with ``HmmConfig.seed`` (+ the
word's index), moved to the device afterwards, so a fit on the card and a
fit on the CPU start from the same parameters; ``jax.random`` bits cannot
be reproduced, so :func:`init_params`, :func:`fit_ubm` and
:func:`fit_words_batched` take the draw as a tensor and the parity tests
hand them JAX's own.  The segmental E-step decodes the batch with the
batched ``viterbi_decode`` and takes the summed log-likelihood from that
decode.  Checkpoints are the JAX package's ``.npz``, field for field.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import HmmConfig, PipelineConfig
from dsp_tpu_torch.models.knn_dtw import (REJECT, _check_mesh,
                                          check_frontend_signature,
                                          frontend_signature, grammar_masks)
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops.viterbi import viterbi_decode, viterbi_score

NEG_INF = -1e30
LOG_2PI = float(np.log(2.0 * np.pi))


class HmmParams(NamedTuple):
    """Left-to-right GMM-HMM parameters; leading dims may batch words."""

    log_pi: torch.Tensor    # [..., S]
    log_a: torch.Tensor     # [..., S, S]
    means: torch.Tensor     # [..., S, M, F]
    log_var: torch.Tensor   # [..., S, M, F]
    log_mix: torch.Tensor   # [..., S, M]


def params_from_numpy(arrays, device: str | torch.device = "cuda") -> HmmParams:
    """Numpy arrays of either package's ``HmmParams`` (a tuple in field order
    or a mapping by field name) -> the port's float32 tensors on ``device``."""
    if not isinstance(arrays, tuple):
        arrays = tuple(arrays[f] for f in HmmParams._fields)
    return HmmParams(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                       for a in arrays))


def ubm_from_numpy(arrays, device: str | torch.device = "cuda"):
    """The UBM (means, log_var, log_mix) as numpy -> float32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in arrays)


def params_to_numpy(params: HmmParams) -> HmmParams:
    """The inverse of :func:`params_from_numpy`: host numpy arrays."""
    return HmmParams(*(a.detach().cpu().numpy() for a in params))


def normal_draw(shape, seed: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """Standard-normal float32 ``shape`` from a CPU ``torch.Generator``
    seeded with ``seed``, then moved to ``device``: the same numbers on
    every device."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32).to(device)


# --------------------------------------------------------------- emissions
def gmm_loglik_flat(x: torch.Tensor, means: torch.Tensor,
                    log_var: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log-lik as matrix products.

    ``means`` / ``log_var`` [K, F] score ``x`` [..., F] -> [..., K]; batched
    params [*P, K, F] score ``x`` [*P, R, F] -> [*P, R, K] (one parameter
    set a leading index).  The expanded terms cancel, so the products
    must be full float32 (module docstring).
    """
    f = x.shape[-1]
    inv_var = torch.exp(-log_var)                                 # [..., K, F]
    a = torch.matmul(x * x, inv_var.transpose(-1, -2))            # [..., K]
    b = torch.matmul(x, (means * inv_var).transpose(-1, -2))
    c = torch.sum(means * means * inv_var + log_var, dim=-1)      # [..., K]
    if means.dim() > 2:
        c = c[..., None, :]
    return -0.5 * (a - 2.0 * b + c + f * LOG_2PI)


def emission_logb(x: torch.Tensor, params: HmmParams) -> torch.Tensor:
    """x [..., F] + params [*lead, S, M, F] -> logB [..., *lead, S]."""
    lead = params.means.shape[:-1]                                # (*, S, M)
    f = params.means.shape[-1]
    ll = gmm_loglik_flat(x, params.means.reshape(-1, f),
                         params.log_var.reshape(-1, f))           # [..., K]
    ll = ll.reshape(*x.shape[:-1], *lead)                         # [..., *, S, M]
    return torch.logsumexp(ll + params.log_mix, dim=-1)           # [..., *, S]


def _mixture_loglik(feats: torch.Tensor, params: HmmParams) -> torch.Tensor:
    """Paired scoring for training: feats [*W, N, T, F] against params
    [*W, S, M, F] (word w's utterances against word w's model only) ->
    per-mixture ``loglik + log_mix`` [*W, N, T, S, M]."""
    lead = feats.shape[:-3]
    n, t, f = feats.shape[-3:]
    s, m = params.log_mix.shape[-2:]
    ll = gmm_loglik_flat(feats.reshape(*lead, n * t, f),
                         params.means.reshape(*lead, s * m, f),
                         params.log_var.reshape(*lead, s * m, f))
    return (ll.reshape(*lead, n * t, s, m)
            + params.log_mix[..., None, :, :]).reshape(*lead, n, t, s, m)


# ------------------------------------------------------------------ decode
def score_words(feats: torch.Tensor, lengths: torch.Tensor,
                params: HmmParams) -> torch.Tensor:
    """feats [B, T, F] x stacked word params [W, ...] -> loglik [B, W]."""
    logb = emission_logb(feats, params)                           # [B, T, W, S]
    logb = torch.movedim(logb, 1, 0)                              # [T, B, W, S]
    return viterbi_score(params.log_pi[None], params.log_a[None],
                         logb, lengths[:, None])


def score_ubm(feats: torch.Tensor, lengths: torch.Tensor, ubm) -> torch.Tensor:
    """feats [B, T, F] x UBM (means / log_var [M, F], log_mix [M]) -> total
    log-lik [B] over the valid frames: the background score the
    utterance-verification LLR normalises against."""
    means, log_var, log_mix = ubm
    ll = gmm_loglik_flat(feats, means, log_var) + log_mix         # [B, T, M]
    fr = torch.logsumexp(ll, dim=-1)                              # [B, T]
    mask = torch.arange(feats.shape[1], device=feats.device)[None, :] < lengths[:, None]
    return torch.sum(torch.where(mask, fr, torch.zeros_like(fr)), dim=1)


# ---------------------------------------------------------------- training
def _valid(t: int, lengths: torch.Tensor) -> torch.Tensor:
    return torch.arange(t, device=lengths.device) < lengths[..., None]


def _uniform_alignment(t_max: int, length: torch.Tensor, n_states: int) -> torch.Tensor:
    """Initial state of frame t: floor(t * S / length), clipped; [..., T]."""
    t_idx = torch.arange(t_max, device=length.device)
    st = torch.div(t_idx * n_states, torch.clamp(length, min=1)[..., None],
                   rounding_mode="floor")
    return torch.clamp(st, 0, n_states - 1)


def _lr_log_a(stay_prob: torch.Tensor, n_states: int) -> torch.Tensor:
    """Left-to-right transition matrix [..., S, S] from per-state stay
    probabilities [..., S]; the final state absorbs."""
    s = n_states
    stay = torch.clamp(stay_prob, 1e-4, 1.0 - 1e-4)
    log_a = torch.full((*stay.shape, s), NEG_INF, dtype=stay.dtype, device=stay.device)
    di = torch.arange(s, device=stay.device)
    log_a[..., di, di] = torch.log(stay)
    log_a[..., di[:-1], di[:-1] + 1] = torch.log1p(-stay[..., :-1])
    log_a[..., s - 1, s - 1] = 0.0
    return log_a


def _lr_start(lead, n_states: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(log_pi [*lead, S], log_a [*lead, S, S]) of a fresh model: start in
    state 0, stay probability 0.6."""
    log_pi = torch.full((*lead, n_states), NEG_INF, device=device)
    log_pi[..., 0] = 0.0
    stay = torch.full((*lead, n_states), 0.6, device=device)
    return log_pi, _lr_log_a(stay, n_states)


def init_params(feats: torch.Tensor, lengths: torch.Tensor, cfg: HmmConfig,
                jitter: torch.Tensor) -> HmmParams:
    """Uniform-segmentation init: feats [*W, N, T, F], ``jitter`` the
    standard-normal draw [*W, S, M, F] (:func:`normal_draw`; the JAX
    package draws it from its key here)."""
    s, m = cfg.n_states, cfg.n_mix
    lead = feats.shape[:-3]
    t = feats.shape[-2]
    valid = _valid(t, lengths)                                    # [*W, N, T]
    align = _uniform_alignment(t, lengths, s)
    gamma = (torch.nn.functional.one_hot(align, s).to(feats.dtype)
             * valid[..., None])                                  # [*W, N, T, S]
    tot = torch.clamp(gamma.sum((-3, -2))[..., None], min=1e-6)   # [*W, S, 1]
    mean_s = torch.einsum("...nts,...ntf->...sf", gamma, feats) / tot
    var_s = torch.einsum("...nts,...ntf->...sf", gamma, feats * feats) / tot - mean_s**2
    var_s = torch.clamp(var_s, min=cfg.var_floor)

    # spread M components around the state mean along the state stddev
    offs = torch.linspace(-1.0, 1.0, m, device=feats.device)[None, :, None]
    means = (mean_s[..., :, None, :]
             + (offs + 0.05 * jitter) * torch.sqrt(var_s)[..., :, None, :])
    log_var = torch.log(var_s)[..., :, None, :].expand(*lead, s, m, -1).contiguous()
    log_mix = torch.full((*lead, s, m), -float(np.log(m)), device=feats.device)
    log_pi, log_a = _lr_start(lead, s, feats.device)
    return HmmParams(log_pi, log_a, means, log_var, log_mix)


class SuffStats(NamedTuple):
    """Additive sufficient statistics of one EM iteration (leading dims
    batch words)."""

    tot: torch.Tensor        # [..., S, M]    sum of responsibilities
    sx: torch.Tensor         # [..., S, M, F] weighted sum of x
    sxx: torch.Tensor        # [..., S, M, F] weighted sum of x^2
    stay_cnt: torch.Tensor   # [..., S]       self-transition counts
    trans_cnt: torch.Tensor  # [..., S]       total transition counts
    loglik: torch.Tensor     # [...]          summed log-likelihood


def _gmm_stats(feats: torch.Tensor, valid: torch.Tensor, gamma: torch.Tensor,
               mix_ll: torch.Tensor):
    """Responsibility-weighted GMM moments: feats [*W, N, T, F], state
    occupancies gamma [*W, N, T, S], ``mix_ll`` :func:`_mixture_loglik`'s."""
    resp = torch.softmax(mix_ll, dim=-1)                          # within-state
    r = resp * (gamma * valid[..., None])[..., None]              # [*W, N, T, S, M]
    tot = r.sum((-4, -3))                                         # [*W, S, M]
    sx = torch.einsum("...ntsm,...ntf->...smf", r, feats)
    sxx = torch.einsum("...ntsm,...ntf->...smf", r, feats * feats)
    return tot, sx, sxx


def _params_from_stats(stats: SuffStats, params: HmmParams,
                       cfg: HmmConfig, prior: HmmParams | None = None
                       ) -> HmmParams:
    """Closed-form M-step from the sufficient statistics.

    With ``prior`` (and cfg.map_tau > 0) the update is relevance-MAP
    adaptation (Reynolds et al.):

        mean = (sx + tau * m0) / (tot + tau)
        var  = (sxx + tau * (v0 + m0^2)) / (tot + tau) - mean^2

    which shrinks towards the UBM where a component sees few frames.
    """
    tot, sx, sxx = stats.tot, stats.sx, stats.sxx
    if prior is not None and cfg.map_tau > 0:
        tau = cfg.map_tau
        m0 = prior.means
        v0 = torch.exp(prior.log_var)
        denom = (tot + tau)[..., None]
        mean_new = (sx + tau * m0) / denom
        var_new = (sxx + tau * (v0 + m0 * m0)) / denom - mean_new**2
        var_new = torch.clamp(var_new, min=cfg.var_floor)
        mix_num = tot + tau * torch.exp(prior.log_mix)
        mix_new = mix_num / torch.clamp(mix_num.sum(-1, keepdim=True), min=1e-6)
        means, log_var = mean_new, torch.log(var_new)
    else:
        tot_safe = torch.clamp(tot, min=1e-6)[..., None]
        mean_new = sx / tot_safe
        var_new = torch.clamp(sxx / tot_safe - mean_new**2, min=cfg.var_floor)
        mix_new = tot / torch.clamp(tot.sum(-1, keepdim=True), min=1e-6)
        # keep old params for starved components
        alive = (tot > 1e-4)[..., None]
        means = torch.where(alive, mean_new, params.means)
        log_var = torch.where(alive, torch.log(var_new), params.log_var)
    mix_new = torch.clamp(mix_new, min=1e-6)
    mix_new = mix_new / mix_new.sum(-1, keepdim=True)
    stay = torch.where(stats.trans_cnt > 0,
                       stats.stay_cnt / torch.clamp(stats.trans_cnt, min=1.0),
                       torch.full_like(stats.stay_cnt, 0.6))
    return params._replace(means=means, log_var=log_var,
                           log_mix=torch.log(mix_new),
                           log_a=_lr_log_a(stay, cfg.n_states))


def _pair_valid(valid: torch.Tensor) -> torch.Tensor:
    return (valid[..., :-1] & valid[..., 1:]).to(torch.float32)


def em_suff_stats(feats: torch.Tensor, lengths: torch.Tensor, params: HmmParams,
                  cfg: HmmConfig) -> SuffStats:
    """Segmental E-step: Viterbi-align utterances feats [*W, N, T, F] to
    their word's model [*W, ...] and return the additive statistics."""
    s = cfg.n_states
    valid = _valid(feats.shape[-2], lengths)                      # [*W, N, T]
    mix_ll = _mixture_loglik(feats, params)
    logb = torch.logsumexp(mix_ll, dim=-1)                        # [*W, N, T, S]
    scores, paths = viterbi_decode(params.log_pi[..., None, :],
                                   params.log_a[..., None, :, :], logb, lengths)
    one_hot = torch.nn.functional.one_hot
    gamma = one_hot(paths, s).to(feats.dtype) * valid[..., None]
    tot, sx, sxx = _gmm_stats(feats, valid, gamma, mix_ll)

    cur, nxt = paths[..., :-1], paths[..., 1:]
    pair_valid = _pair_valid(valid)
    onehot = one_hot(cur, s).to(feats.dtype) * pair_valid[..., None]
    stay = (cur == nxt).to(feats.dtype) * pair_valid
    stay_cnt = (onehot * stay[..., None]).sum((-3, -2))
    trans_cnt = onehot.sum((-3, -2))
    return SuffStats(tot, sx, sxx, stay_cnt, trans_cnt, scores.sum(-1))


def _forward_backward(log_pi, log_a, log_b, length):
    """Log-space alphas / betas: log_b [..., T, S] (masked by length [...]).

    alpha[t] is carried through unchanged for t >= length; beta is 0 at
    t == length-1 and NEG_INF beyond, so gamma is valid on [0, length).
    Returns (alpha [..., T, S], beta [..., T, S], loglik [...]).
    """
    t_len, s = log_b.shape[-2:]
    alpha = log_pi + log_b[..., 0, :]
    alphas = [alpha]
    for ti in range(1, t_len):
        new = torch.logsumexp(alpha[..., :, None] + log_a, dim=-2) + log_b[..., ti, :]
        alpha = torch.where((ti < length)[..., None], new, alpha)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=-2)
    # loglik read at the true last frame
    last = torch.clamp(length - 1, 0, t_len - 1).to(torch.int64)
    at_last = torch.gather(alphas, -2, last[..., None, None].expand(*last.shape, 1, s))
    loglik = torch.logsumexp(at_last.squeeze(-2), dim=-1)

    zero = torch.zeros((), device=log_b.device)
    neg = torch.full((), NEG_INF, device=log_b.device)
    beta = (torch.where(length - 1 == t_len - 1, zero, neg)[..., None]
            * torch.ones(s, device=log_b.device))
    betas = [beta]
    for ti in range(t_len - 2, -1, -1):      # emission at ti+1, computing beta[ti]
        cand = torch.logsumexp(log_a + (log_b[..., ti + 1, :] + beta)[..., None, :],
                               dim=-1)
        beta = torch.where((ti == length - 1)[..., None], zero,
                           torch.where((ti < length - 1)[..., None], cand, neg))
        betas.append(beta)
    return alphas, torch.stack(betas[::-1], dim=-2), loglik


def em_suff_stats_soft(feats: torch.Tensor, lengths: torch.Tensor,
                       params: HmmParams, cfg: HmmConfig) -> SuffStats:
    """Baum-Welch E-step: forward-backward occupancies in place of a hard
    Viterbi alignment; the same additive statistics."""
    valid = _valid(feats.shape[-2], lengths)                      # [*W, N, T]
    mix_ll = _mixture_loglik(feats, params)
    logb = torch.logsumexp(mix_ll, dim=-1)                        # [*W, N, T, S]
    log_pi = params.log_pi[..., None, :]
    log_a = params.log_a[..., None, :, :]
    alphas, betas, logliks = _forward_backward(log_pi, log_a, logb, lengths)
    ll = logliks[..., None, None]

    log_gamma = alphas + betas - ll
    gamma = torch.exp(torch.clamp(log_gamma, max=0.0)) * valid[..., None]
    tot, sx, sxx = _gmm_stats(feats, valid, gamma, mix_ll)

    # transition occupancies (left-to-right: stay s->s, advance s->s+1)
    pair_valid = _pair_valid(valid)[..., None]
    a_diag = torch.diagonal(log_a, dim1=-2, dim2=-1)[..., None, :]        # [*W, 1, 1, S]
    lx = alphas[..., :-1, :] + a_diag + (logb[..., 1:, :] + betas[..., 1:, :]) - ll
    a_up = torch.diagonal(log_a, offset=1, dim1=-2, dim2=-1)[..., None, :]
    lx_up = (alphas[..., :-1, :-1] + a_up
             + (logb[..., 1:, 1:] + betas[..., 1:, 1:]) - ll)
    lx_up = torch.nn.functional.pad(lx_up, (0, 1), value=NEG_INF)
    stay_cnt = (torch.exp(torch.clamp(lx, max=0.0)) * pair_valid).sum((-3, -2))
    adv_cnt = (torch.exp(torch.clamp(lx_up, max=0.0)) * pair_valid).sum((-3, -2))
    return SuffStats(tot, sx, sxx, stay_cnt, stay_cnt + adv_cnt, logliks.sum(-1))


def _suff_stats(feats, lengths, params, cfg):
    if cfg.train_mode == "baum_welch":
        return em_suff_stats_soft(feats, lengths, params, cfg)
    return em_suff_stats(feats, lengths, params, cfg)


def _em_iteration(feats: torch.Tensor, lengths: torch.Tensor, params: HmmParams,
                  cfg: HmmConfig, prior: HmmParams | None = None):
    """One EM iteration (E-step per ``cfg.train_mode``) -> (params, loglik)."""
    stats = _suff_stats(feats, lengths, params, cfg)
    return _params_from_stats(stats, params, cfg, prior), stats.loglik


def fit_word(feats: torch.Tensor, lengths: torch.Tensor,
             cfg: HmmConfig = HmmConfig(), seed: int | None = None,
             mesh=None) -> HmmParams:
    """Train one word model on its utterances feats [N, T, F] (on their
    device), starting from :func:`normal_draw` of ``seed`` (default
    ``cfg.seed``).

    With ``mesh`` the E-step splits the utterances over the 'data' axis and
    sums the statistics across it (``parallel/em.py:em_step_sharded``,
    segmental whatever ``cfg.train_mode`` says, as in the JAX package);
    the utterance count is padded to the axis with zero-length utterances,
    whose statistics vanish.  Every rank starts from the same draw."""
    mesh = _check_mesh(mesh)
    jitter = normal_draw((cfg.n_states, cfg.n_mix, feats.shape[-1]),
                         cfg.seed if seed is None else seed, feats.device)
    params = init_params(feats, lengths, cfg, jitter)
    if mesh is None:
        for _ in range(cfg.n_iter):
            params, _ = _em_iteration(feats, lengths, params, cfg)
        return params
    from dsp_tpu_torch.parallel.em import em_step_sharded
    from dsp_tpu_torch.parallel.mesh import mesh_shape, pad_rows_to_multiple

    nd = mesh_shape(mesh)[0]
    f_p, _ = pad_rows_to_multiple(feats, nd)
    l_p, _ = pad_rows_to_multiple(lengths, nd)
    for _ in range(cfg.n_iter):
        params, _ = em_step_sharded(mesh, f_p, l_p, params, cfg)
    return HmmParams(*(a.to(feats.device) for a in params))


def stack_params(params_list) -> HmmParams:
    return HmmParams(*(torch.stack([getattr(p, f) for p in params_list])
                       for f in HmmParams._fields))


def fit_ubm(feats: torch.Tensor, lengths: torch.Tensor, cfg: HmmConfig,
            jitter: torch.Tensor):
    """Universal background GMM over all frames of feats [N, T, F]:
    (means, log_var, log_mix), [M, F], [M, F], [M].  ``jitter`` is the
    standard-normal draw [M, F] that spreads the initial means."""
    f = feats.shape[-1]
    m = cfg.n_mix
    x = feats.reshape(-1, f)                                      # [NT, F]
    wts = _valid(feats.shape[-2], lengths).reshape(-1).to(torch.float32)   # [NT]
    total = torch.clamp(wts.sum(), min=1.0)
    gmean = torch.matmul(wts, x) / total
    gvar = torch.clamp(torch.matmul(wts, x * x) / total - gmean**2, min=cfg.var_floor)
    # init: global mean / var with jittered means
    means = gmean[None] + 0.3 * jitter * torch.sqrt(gvar)[None]
    log_var = torch.log(gvar)[None].expand(m, f)
    log_mix = torch.full((m,), -float(np.log(m)), device=feats.device)
    for _ in range(cfg.ubm_iters):
        ll = gmm_loglik_flat(x, means, log_var) + log_mix         # [NT, M]
        resp = torch.softmax(ll, dim=-1) * wts[:, None]
        tot = torch.clamp(resp.sum(0), min=1e-6)                  # [M]
        means = torch.matmul(resp.T, x) / tot[:, None]
        var = torch.clamp(torch.matmul(resp.T, x * x) / tot[:, None] - means**2,
                          min=cfg.var_floor)
        mix = torch.clamp(tot / tot.sum(), min=1e-6)
        log_var, log_mix = torch.log(var), torch.log(mix / mix.sum())
    return means, log_var, log_mix


def ubm_prior(ubm, cfg: HmmConfig) -> HmmParams:
    """Tile the UBM across HMM states as the MAP prior (every state's
    mixtures start at, and shrink towards, the universal model)."""
    means, log_var, log_mix = ubm
    s = cfg.n_states
    log_pi, log_a = _lr_start((), s, means.device)
    return HmmParams(log_pi, log_a, means.expand(s, *means.shape),
                     log_var.expand(s, *log_var.shape),
                     log_mix.expand(s, *log_mix.shape))


def fit_words_batched(feats_w: torch.Tensor, lengths_w: torch.Tensor,
                      jitter_w: torch.Tensor | None, cfg: HmmConfig,
                      prior: HmmParams | None = None) -> HmmParams:
    """EM for every word model at once along the leading word axis.

    feats_w [W, N, T, F] / lengths_w [W, N]: each word's utterances padded
    to a common N with zero-length entries (their statistics vanish
    through the validity masks).  ``jitter_w`` [W, S, M, F] is each word's
    standard-normal draw (the JAX package derives it from ``seeds``).

    With ``prior`` (a UBM tiled over states, :func:`ubm_prior`) and
    cfg.map_tau > 0 every word starts AT the prior and the M-step
    MAP-shrinks towards it, and ``jitter_w`` is not read.
    """
    if prior is not None and cfg.map_tau > 0:
        w = feats_w.shape[0]
        params = HmmParams(*(a.expand(w, *a.shape).contiguous() for a in prior))
    else:
        params = init_params(feats_w, lengths_w, cfg, jitter_w)
    for _ in range(cfg.n_iter):
        params, _ = _em_iteration(feats_w, lengths_w, params, cfg, prior)
    return params


def stack_words(per_word, device: str | torch.device = "cuda"):
    """Each word's Features [N_w, T, F] -> (feats_w [W, N, T, F], lengths_w
    [W, N]) on ``device``, padded to the largest N with zero-length
    utterances (no weight in any statistic)."""
    n_max = max(fw.feats.shape[0] for fw in per_word)
    t, f_dim = per_word[0].feats.shape[1:]
    feats_w = torch.zeros((len(per_word), n_max, t, f_dim), device=device)
    lens_w = torch.zeros((len(per_word), n_max), dtype=torch.int32, device=device)
    for i, fw in enumerate(per_word):
        feats_w[i, :fw.feats.shape[0]] = fw.feats
        lens_w[i, :fw.feats.shape[0]] = fw.length
    return feats_w, lens_w


def word_jitter(cfg: HmmConfig, n_words: int, f_dim: int,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Each word's initial draw [W, S, M, F]: word w's from seed
    ``cfg.seed + w``, as the JAX package seeds its keys."""
    return torch.stack([normal_draw((cfg.n_states, cfg.n_mix, f_dim), cfg.seed + i, device)
                        for i in range(n_words)])


# --------------------------------------------------------------- recognizer
class GmmHmmRecognizer:
    """Word-per-HMM recognizer with the KnnDtwRecognizer's surface.

    ``device`` is where features, parameters and scoring live: the card
    (``"cuda"``) unless the caller passes ``"cpu"``, with no probe and no
    fallback.  ``noise_adapt=True`` estimates each batch's noise floor from
    its VAD-rejected frames and PMC-adapts the word models and the UBM
    together before scoring (``ops/noise_adapt.py``).  ``mesh`` (a
    ('data', 'bank') ``DeviceMesh``) decodes data-parallel over every rank
    of it; ``fit(mesh=)`` trains over a mesh.  ``noise_adapt`` does not
    compose with a mesh.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 hmm: HmmConfig = HmmConfig(),
                 device: str | torch.device = "cuda", mesh=None,
                 noise_adapt: bool = False):
        self.cfg = cfg
        self.hmm = hmm
        self.device = torch.device(device)
        self.mesh = _check_mesh(mesh)           # data-parallel decode mesh
        self.labels: list[str] = []
        self.params: HmmParams | None = None   # stacked [W, ...]
        self.ubm = None   # (means [M, F], log_var [M, F], log_mix [M]) over all
        #   training frames: the MAP prior and the rejection LLR's filler
        self.noise_adapt = noise_adapt
        self.reject_threshold: float | None = None   # calibrate_rejection

    def extract(self, signals) -> pl.Features:
        """Host list of signals -> Features on the recognizer's device."""
        return pl.extract_signals(signals, self.cfg, self.device)

    def fit(self, corpus: dict, mesh=None, batched: bool = True) -> None:
        """corpus: {label: [signals]} -> per-word EM training.

        ``batched`` (default) trains every word model at once
        (:func:`fit_words_batched`) after the UBM; ``batched=False`` is the
        per-word loop (:func:`fit_word`), which fits no UBM, as in the JAX
        package.  ``mesh``: a ('data', 'bank') mesh; batched mode splits
        the words over 'bank' and the utterances over 'data' where they
        divide (``parallel/em.py:fit_words_sharded``; otherwise every rank
        fits them all), the loop splits utterances only.  The UBM is fitted
        whole on every rank."""
        mesh = _check_mesh(mesh)
        hmm = self.hmm
        self.labels = sorted(corpus.keys())
        if not batched:
            trained = []
            for w, lab in enumerate(self.labels):
                feats = self.extract(corpus[lab])
                trained.append(fit_word(feats.feats, feats.length, hmm,
                                        seed=hmm.seed + w, mesh=mesh))
            self.params = stack_params(trained)
            return

        feats_w, lens_w = stack_words([self.extract(corpus[lab]) for lab in self.labels],
                                      self.device)
        w, n_max, t, f_dim = feats_w.shape
        self.ubm = fit_ubm(feats_w.reshape(w * n_max, t, f_dim),
                           lens_w.reshape(w * n_max), hmm,
                           normal_draw((hmm.n_mix, f_dim), hmm.seed, self.device))
        prior = ubm_prior(self.ubm, hmm) if hmm.map_tau > 0 else None
        jitter = word_jitter(hmm, w, f_dim, self.device)
        if mesh is not None:
            from dsp_tpu_torch.parallel.em import fit_words_sharded
            from dsp_tpu_torch.parallel.mesh import mesh_shape

            nd, nb = mesh_shape(mesh)
            if w % nb == 0 and n_max % nd == 0:
                params = fit_words_sharded(mesh, feats_w, lens_w, jitter, hmm,
                                           prior)
                self.params = HmmParams(*(a.to(self.device) for a in params))
                return
        self.params = fit_words_batched(feats_w, lens_w, jitter, hmm, prior)

    def _scoring_models(self, signals):
        """(word params, ubm) for scoring ``signals``: PMC-adapted together
        when ``noise_adapt`` is on, since the rejection LLR compares word
        scores against the UBM in one compensated feature space."""
        if not self.noise_adapt:
            return self.params, self.ubm
        from dsp_tpu_torch.ops.noise_adapt import (estimate_noise_cepstrum,
                                                   pmc_adapt_means, pmc_supported)

        f = self.cfg.frontend
        reason = pmc_supported(f)
        if reason:
            raise ValueError(f"noise_adapt unavailable: {reason}")
        if _check_mesh(self.mesh) is not None:
            raise ValueError("noise_adapt with a mesh is not supported "
                             "yet — clear the mesh or adapt offline")
        mats = fe.make_matrices(f, self.device)
        quantum = self.cfg.max_samples
        n_len = max(1, max(len(np.asarray(s)) for s in signals))
        x, n = pl.pad_signals(signals, quantum * -(-n_len // quantum), self.device)
        noise_c, _ = estimate_noise_cepstrum(x, n, mats, f, self.cfg.vad)
        means = pmc_adapt_means(self.params.means, noise_c, mats, f)
        ubm = self.ubm
        if ubm is not None:
            ubm = (pmc_adapt_means(ubm[0], noise_c, mats, f), ubm[1], ubm[2])
        return self.params._replace(means=means), ubm

    def classify_batch(self, signals, return_scores: bool = False, reject=None):
        """List of signals -> labels (and Viterbi log-liks [B, W], numpy).

        ``reject``: utterance verification on the per-frame (best-word
        Viterbi - UBM) log-likelihood ratio; ``True`` takes the calibrated
        threshold (:meth:`calibrate_rejection`), a number is explicit, and
        utterances below it return ``REJECT``.  Composes with
        ``noise_adapt``; with a mesh the decode is data-parallel
        (:meth:`_score_sharded`)."""
        if self.params is None:
            raise ValueError("model not fitted")
        thr = self._resolve_reject(reject)
        params, ubm = self._scoring_models(signals)
        feats = None
        if _check_mesh(self.mesh) is not None:
            scores = self._score_sharded(signals, params)
        else:
            feats = self.extract(signals)
            scores = score_words(feats.feats, feats.length, params).cpu().numpy()
        labels = [self.labels[int(i)] for i in scores.argmax(axis=-1)]
        if thr is not None:
            if feats is None:                    # mesh path: extract here
                feats = self.extract(signals)
            llr = self._utterance_llr(feats, scores, ubm)
            labels = [REJECT if not (s >= thr) else lab
                      for lab, s in zip(labels, llr)]
        if return_scores:
            return labels, scores
        return labels

    def _score_sharded(self, signals, params: HmmParams) -> np.ndarray:
        """Data-parallel Viterbi decode: the utterances split over every
        rank of the mesh (padded with silent rows, every length clamped to
        at least 1 after padding, as in the JAX package), the word models
        whole on each; the [B, W] log-likelihoods are gathered back."""
        from dsp_tpu_torch import parallel as par
        from dsp_tpu_torch.parallel.mesh import gather_flat, mesh_shape, shard_flat

        x, n = pl.pad_signals(signals, self.cfg.max_samples, "cpu")
        nd, nb = mesh_shape(self.mesh)
        x, b_orig = par.pad_axis_to_multiple(x.numpy(), nd * nb)
        n, _ = par.pad_axis_to_multiple(n.numpy(), nd * nb)
        x, n = shard_flat(self.mesh, x, np.maximum(n, 1))
        feats = pl.extract_features(x, n, self.cfg)
        scores = score_words(feats.feats, feats.length,
                             HmmParams(*par.replicate(self.mesh, *params)))
        return gather_flat(scores, self.mesh)[:b_orig].cpu().numpy()

    def _utterance_llr(self, feats: pl.Features, scores: np.ndarray,
                       ubm) -> np.ndarray:
        """[B] per-frame LLR: (max-word loglik - UBM loglik) / frames."""
        if ubm is None:
            raise ValueError(
                "rejection needs the UBM this model's fit() stores — "
                "older checkpoint? refit to enable reject")
        ubm_s = score_ubm(feats.feats, feats.length, ubm).cpu().numpy()
        nfr = np.maximum(feats.length.cpu().numpy(), 1)
        return (scores.max(axis=-1) - ubm_s) / nfr

    def _resolve_reject(self, reject) -> float | None:
        """None/False = off; True = the calibrated stored threshold; a
        number = explicit LLR threshold (accept iff llr >= thr)."""
        if reject is None or reject is False:
            return None
        if reject is True:
            if self.reject_threshold is None:
                raise ValueError(
                    "reject=True but no rejection threshold is stored — "
                    "calibrate_rejection(corpus) first or pass an explicit "
                    "number")
            return float(self.reject_threshold)
        return float(reject)

    def calibrate_rejection(self, corpus: dict, genuine_q: float = 0.1,
                            impostor_q: float = 0.98) -> float:
        """OOV-rejection LLR threshold from a labeled corpus (typically the
        training corpus).

        GENUINE: each utterance's (best-word score - UBM) / frames;
        IMPOSTOR: the same with the utterance's own word masked out, what
        it would score were its word missing from the vocabulary.
        Threshold = midpoint of the genuine ``genuine_q`` and impostor
        ``impostor_q`` quantiles; accept iff llr >= threshold.  Stored on
        ``self.reject_threshold`` (saved with the model)."""
        if self.params is None:
            raise ValueError("model not fitted")
        if len(self.labels) < 2:
            raise ValueError("calibrate_rejection needs >= 2 words "
                             "(no impostor scores with one word)")
        sigs, want = [], []
        for lab, xs in corpus.items():
            if lab not in self.labels:
                raise ValueError(f"corpus label {lab!r} is not in the "
                                 "model vocabulary")
            sigs.extend(xs)
            want.extend([self.labels.index(lab)] * len(xs))
        params, ubm = self._scoring_models(sigs)
        feats = self.extract(sigs)
        scores = score_words(feats.feats, feats.length, params).cpu().numpy()
        llr_all = self._utterance_llr(feats, scores, ubm)
        masked = scores.copy()
        masked[np.arange(len(want)), np.asarray(want)] = -np.inf
        llr_imp = self._utterance_llr(feats, masked, ubm)
        self.reject_threshold = float(
            (np.quantile(llr_all, genuine_q)
             + np.quantile(llr_imp, impostor_q)) / 2.0)
        return self.reject_threshold

    def classify_nbest(self, signals, n: int = 3):
        """Top-n label hypotheses per utterance: ``[[(label, log_lik,
        weight)]]`` sorted best-first (``pipeline.nbest_from_scores`` over
        the per-word Viterbi log-liks)."""
        if not len(signals):
            return []
        _, scores = self.classify_batch(signals, return_scores=True)
        return pl.nbest_from_scores(scores, self.labels, n, higher_better=True)

    def resolve_grammar(self, grammar):
        """A grammar argument -> word-level masks, as
        ``KnnDtwRecognizer.resolve_grammar``; the HMM family has one model
        a label, so a unit is a word (masks in ``self.labels`` order)."""
        return grammar_masks(grammar, self.labels, self.labels, "trained")

    def classify_connected(self, signals, max_segments: int = 8,
                           method: str = "vad", word_penalty: float = 0.0,
                           grammar=None):
        """Recordings of SEVERAL words -> one label list a recording.

        ``method="vad"``: the multi-segment VAD split
        (``pipeline.decode_connected``) feeds every segment through the
        batched Viterbi scorer of :meth:`classify_batch`; needs silence
        between words.  ``method="level"``: the level-synchronous connected
        Viterbi (``ops/connected_viterbi.py``) through the word-HMM network,
        so gapless recordings decode; ``max_segments`` caps the word count
        and ``word_penalty`` (>= 0, subtracted a word) biases it.
        ``grammar`` (``"level"`` only) constrains the DP to a word syntax
        (:meth:`resolve_grammar`); a recording the grammar cannot explain
        gives ``[]``.  Both compose with ``noise_adapt`` (models adapted
        to the recordings' own noise floor)."""
        if self.params is None:
            raise ValueError("model not fitted")
        if grammar is not None and method != "level":
            raise ValueError(
                "grammar constraints require method='level' (the VAD "
                "splitter classifies segments independently — there is "
                "no joint sequence to constrain)")
        params = self._scoring_models(signals)[0] if len(signals) else self.params
        if method == "level":
            from dsp_tpu_torch.ops import level_building as lb
            from dsp_tpu_torch.ops.connected_viterbi import (
                connected_viterbi, connected_viterbi_grammar)

            backtrack_fn = None
            if grammar is None:
                def dp_fn(feats):
                    scores, words, starts = connected_viterbi(
                        feats.feats, feats.length, params, max_segments,
                        word_penalty)
                    # the MIN convention of level building: NEG_INF -> BIG
                    return -scores, words, starts
            else:
                start_m, pair_m, end_m = self.resolve_grammar(grammar)
                start_t = torch.as_tensor(start_m, device=self.device)
                pair_t = torch.as_tensor(pair_m, device=self.device)

                def dp_fn(feats):
                    scores, starts = connected_viterbi_grammar(
                        feats.feats, feats.length, params, start_t, pair_t,
                        max_segments, word_penalty)
                    return -scores, starts

                def backtrack_fn(costs, starts, t_valid):
                    return lb.backtrack_grammar(costs, starts, pair_m, end_m,
                                                t_valid)

            id_lists, _ = pl.decode_level_generic(
                signals, self.cfg, dp_fn, torch.arange(len(self.labels)),
                backtrack_fn, self.device)
            return [[self.labels[i] for i in ids] for ids in id_lists]
        if method != "vad":
            raise ValueError(f"unknown connected method {method!r} (vad | level)")
        return pl.decode_connected(
            signals, self.cfg, max_segments,
            lambda flat: score_words(flat.feats, flat.length, params).argmax(-1),
            lambda ids: [self.labels[int(i)] for i in ids], self.device)[0]

    def recognize(self, signal, reject=None) -> str:
        return self.classify_batch([signal], reject=reject)[0]

    def evaluate(self, corpus: dict, reject=None) -> dict:
        """{label: [signals]} -> accuracy + confusion.  With ``reject``,
        corpus labels not in the vocabulary count correct iff rejected."""
        thr = self._resolve_reject(reject)
        if thr is None:
            return pl.evaluate_corpus(self.classify_batch, corpus)
        mapped: dict = {}
        for lab, xs in corpus.items():
            mapped.setdefault(lab if lab in self.labels else REJECT, []).extend(xs)
        return pl.evaluate_corpus(
            lambda s: self.classify_batch(s, reject=thr), mapped)

    # ---------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        """Write the model in the JAX package's ``.npz`` format."""
        if self.params is None:
            raise ValueError("model not fitted")
        extra = {}
        if self.ubm is not None:
            extra = {f"ubm_{n}": a.cpu().numpy() for n, a in
                     zip(("means", "log_var", "log_mix"), self.ubm)}
        np.savez(path, labels=json.dumps(self.labels),
                 frontend=json.dumps(frontend_signature(self.cfg)),
                 reject_threshold=(np.nan if self.reject_threshold is None
                                   else float(self.reject_threshold)),
                 **params_to_numpy(self.params)._asdict(), **extra)

    @classmethod
    def load(cls, path: str, cfg: PipelineConfig = PipelineConfig(),
             hmm: HmmConfig = HmmConfig(),
             device: str | torch.device = "cuda") -> "GmmHmmRecognizer":
        """Read a model saved by either package."""
        data = np.load(path, allow_pickle=False)
        check_frontend_signature(data, cfg, path)
        rec = cls(cfg, hmm, device=device)
        rec.labels = json.loads(str(data["labels"]))
        rec.params = params_from_numpy(data, rec.device)
        if "ubm_means" in data.files:
            rec.ubm = ubm_from_numpy([data[f"ubm_{n}"] for n in
                                      ("means", "log_var", "log_mix")], rec.device)
        if "reject_threshold" in data.files:
            rt = float(data["reject_threshold"])
            rec.reject_threshold = rt if np.isfinite(rt) else None
        return rec
