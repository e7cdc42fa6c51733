"""Plain reference of the GMM-HMM word scorer that the benchmark judges.

Written from the recognizer's stated equations, in plain PyTorch and
float64 by default, importing nothing of the program.  A frame is
x in R^F; word w has S left-to-right states, each of M diagonal
Gaussians:

* log b_ws(x) = logsumexp_m [log c_wsm - 1/2 sum_f ((x_f - mu_wsmf)^2 /
  var_wsmf + log var_wsmf + log 2 pi)], in that direct form (not the
  program's expanded matrix products);
* delta_0 = log pi_w + log b_w(x_0);
* delta_t(s) = max(delta_{t-1}(s) + log a_w(s, s),
  delta_{t-1}(s - 1) + log a_w(s - 1, s)) + log b_ws(x_t) for t < len,
  and delta_t = delta_{t-1} after: the two predecessors of a
  left-to-right topology, read from the dense ``log_a``;
* score_w = max_s delta_{len-1}(s) (the best final state over all S);
  the label is argmax_w score_w.

The features come from ``plain.py``'s front end.  ``dtype`` sets the
precision of every sum; TF32 is turned off inside (this module computes
no matrix product, so the control's TF32 reaches only the front end).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

FIELDS = ("log_pi", "log_a", "means", "log_var", "log_mix")
ELEMS_PER_BLOCK = 1 << 27      # (x - mu)^2 terms a block of utterances holds


@contextlib.contextmanager
def no_tf32():
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def as_tensors(params, device, dtype=torch.float64) -> dict:
    """Word models as a mapping (or tuple in :data:`FIELDS` order) of
    arrays: ``log_pi`` [W, S], ``log_a`` [W, S, S], ``means`` /
    ``log_var`` [W, S, M, F], ``log_mix`` [W, S, M] -> tensors."""
    if isinstance(params, tuple):
        params = dict(zip(FIELDS, params))
    return {k: torch.as_tensor(np.asarray(params[k]), dtype=dtype, device=device)
            for k in FIELDS}


def log_emissions(feats: torch.Tensor, p: dict) -> torch.Tensor:
    """feats [B, T, F] -> log b [B, T, W, S], in blocks of utterances."""
    b, t, f = feats.shape
    w, s, m, _ = p["means"].shape
    mu = p["means"].reshape(w * s * m, f)
    var = torch.exp(p["log_var"]).reshape(w * s * m, f)
    log_var = p["log_var"].reshape(w * s * m, f)
    log_mix = p["log_mix"].reshape(w * s * m)
    step = max(1, ELEMS_PER_BLOCK // (t * w * s * m * f))
    out = []
    for lo in range(0, b, step):
        d = feats[lo:lo + step, :, None, :] - mu                    # [n, T, WSM, F]
        q = (d * d / var + log_var + math.log(2.0 * math.pi)).sum(-1)
        ll = (log_mix - 0.5 * q).reshape(-1, t, w, s, m)
        out.append(torch.logsumexp(ll, dim=-1))
    return torch.cat(out)


def viterbi(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
            lens: torch.Tensor) -> torch.Tensor:
    """log_pi [W, S], log_a [W, S, S], log b [B, T, W, S], lengths [B] ->
    best-path scores [B, W]."""
    t = log_b.shape[1]
    stay = torch.diagonal(log_a, dim1=-2, dim2=-1)                # a(s, s)       [W, S]
    adv = torch.diagonal(log_a, offset=1, dim1=-2, dim2=-1)       # a(s - 1, s)   [W, S-1]
    lens = lens.to(torch.int64)
    delta = log_pi + log_b[:, 0]                                  # [B, W, S]
    none = torch.full_like(delta[..., :1], -torch.inf)
    for ti in range(1, t):
        from_left = torch.cat([none, delta[..., :-1] + adv], dim=-1)
        new = torch.maximum(delta + stay, from_left) + log_b[:, ti]
        delta = torch.where((ti < lens)[:, None, None], new, delta)
    return delta.amax(-1)


def word_scores(feats: torch.Tensor, lens: torch.Tensor, params,
                dtype=torch.float64) -> torch.Tensor:
    """Features [B, T, F] and lengths [B] against the word models
    ``params`` -> scores [B, W] in ``dtype``, on the features' device."""
    with no_tf32():
        p = as_tensors(params, feats.device, dtype)
        log_b = log_emissions(feats.to(dtype), p)
        return viterbi(p["log_pi"], p["log_a"], log_b, lens.to(feats.device))
