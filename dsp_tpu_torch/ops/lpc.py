"""LPC / LPCC front-end ops in PyTorch (port of ``dsp_tpu/ops/lpc.py``).

The Levinson-Durbin recursion is sequential in the prediction order only
(p = 12 steps), and each step is vectorized over every frame of the
batch; the LPCC cepstral recursion is the same shape (n_ceps steps).
Each step keeps the JAX package's masked full-width form and its 1e-10
floors on the frame energy, each step's error and the gain.
Autocorrelation is p+1 shift-multiply reductions.

Oracle: ``dsp_tpu/golden/lpc.py``.
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.config import FrontendConfig
from dsp_tpu_torch.ops import frontend as fe


def autocorrelation(frames: torch.Tensor, order: int) -> torch.Tensor:
    """[..., L] -> [..., order+1] raw autocorrelation lags."""
    length = frames.shape[-1]
    return torch.stack([(frames[..., : length - k] * frames[..., k:]).sum(dim=-1)
                        for k in range(order + 1)], dim=-1)


def levinson_durbin(r: torch.Tensor, order: int):
    """Batched Levinson-Durbin: r [..., order+1] -> (a [..., order], E [...])."""
    a = torch.zeros((*r.shape[:-1], order), dtype=r.dtype, device=r.device)
    e = torch.clamp(r[..., 0], min=1e-10)
    idx = torch.arange(order, device=r.device)
    for k in range(order):
        # acc = r[k+1] - sum_{j<k} a[j] r[k-j]
        mask = (idx < k).to(r.dtype)
        r_rev = r[..., torch.clamp(k - idx, 0, order)]
        acc = r[..., k + 1] - (a * r_rev * mask).sum(dim=-1)
        lam = acc / e
        # a[j] <- a[j] - lam * a[k-1-j]  (j < k);  a[k] <- lam
        a_rev = a[..., torch.clamp(k - 1 - idx, 0, order - 1)]
        new_a = a - lam[..., None] * a_rev * mask
        a = torch.where(idx == k, lam[..., None], new_a)
        e = torch.clamp(e * (1.0 - lam * lam), min=1e-10)
    return a, e


def lpcc_from_lpc(a: torch.Tensor, gain: torch.Tensor, n_ceps: int) -> torch.Tensor:
    """LPC coefficients -> cepstra [..., n_ceps] (c[0] = ln E)."""
    p = a.shape[-1]
    a_pad = torch.nn.functional.pad(a, (0, max(0, n_ceps - p)))
    kidx = torch.arange(n_ceps, device=a.device)
    ks = kidx.to(a.dtype)
    c = torch.zeros((*a.shape[:-1], n_ceps), dtype=a.dtype, device=a.device)
    c = torch.where(kidx == 0, torch.log(torch.clamp(gain, min=1e-10))[..., None], c)
    for n in range(1, n_ceps):
        # c[n] = a[n-1] + sum_{k=1..n-1} (k/n) c[k] a[n-k-1]
        a_n = a_pad[..., min(n - 1, n_ceps - 1)]
        a_shift = a_pad[..., torch.clamp(n - kidx - 1, 0, n_ceps - 1)]
        mask = ((kidx >= 1) & (kidx < n) & (n - kidx - 1 < p)).to(a.dtype)
        term = ((ks / n) * c * a_shift * mask).sum(dim=-1)
        val = (a_n if n - 1 < p else torch.zeros_like(a_n)) + term
        c = torch.where(kidx == n, val[..., None], c)
    return c


def lpcc_from_frames(frames: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Pre-emphasised frames [..., T, L] -> LPCC [..., T, n_mfcc] (Hamming
    window, autocorrelation, Levinson-Durbin, cepstral recursion)."""
    wframes = frames * fe.make_matrices(cfg, frames.device).window
    r = autocorrelation(wframes, cfg.lpc_order)
    a, e = levinson_durbin(r, cfg.lpc_order)
    return lpcc_from_lpc(a, e, cfg.n_mfcc)


def lpcc(x: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Signal [..., N] -> LPCC [..., T, n_mfcc]."""
    if cfg.denoise is not None:
        raise ValueError("FrontendConfig.denoise is a power-spectrum "
                         "operation; feature_type='lpcc' does not support "
                         "it (LPC analyses the time-domain frames)")
    y = fe.preemphasis(x, cfg.preemphasis)
    return lpcc_from_frames(fe.frame(y, cfg.frame_len, cfg.hop_len), cfg)
