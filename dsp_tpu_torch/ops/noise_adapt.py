"""Noise-mismatch compensation for the GMM-HMM family (port of
``dsp_tpu/ops/noise_adapt.py``).

Log-add Parallel Model Combination (Gales & Young, 1993): estimate the
test-time noise floor from the frames the VAD rejected, map every
Gaussian mean back to the log-mel domain, add the noise power there and
map forward, with no labels and no retraining data.

The inversion follows the front end: MFCC = lifter * DCT(log(mel power))
(``ops/frontend.py:mfcc_from_pspec``, natural log).  The static mean is
un-liftered and lifted back to log-mel through the pseudo-inverse of the
truncated DCT (D @ pinv(D) = I on the kept coefficients, so zero noise
gives the means back), combined as ``log(exp(m) + g * exp(n))`` and
projected again.  Delta blocks pass through: stationary noise has
(approximately) zero cepstral deltas.  The front end must be the
default's in two respects, ``use_energy=False`` and ``cmn=False``;
callers gate on :func:`pmc_supported`.

Deviations the tests pin: frames are ranked by energy with
``torch.argsort(..., stable=True)`` (the JAX package's ``jnp.argsort`` is
stable too, so ties pick the same frames), the cepstra come from the
port's DFT-GEMM chain (``ops/frontend.py:mfcc``, the JAX call's
``use_fft=False``), and the pseudo-inverse is ``torch.linalg.pinv`` of the
same float32 DCT matrix.
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.config import FrontendConfig, VadConfig
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops import vad as tvad


def estimate_noise_cepstrum(signals: torch.Tensor, n_samples: torch.Tensor,
                            mats: fe.FrontendMatrices,
                            cfg: FrontendConfig = FrontendConfig(),
                            vad_cfg: VadConfig = VadConfig()):
    """Batch [B, N] -> (mean static cepstrum [C] of the VAD-rejected frames,
    rejected-frame count, both tensors on the signals' device).

    Pools every valid frame outside the detected speech window across the
    whole batch.  When the batch has no rejected frame (speech wall to
    wall), falls back to the lowest-energy ``ss_frac`` of each signal's
    valid frames (at least 3), the spectral-subtraction denoiser's floor
    rule.
    """
    c = fe.mfcc(signals, cfg, mats)                               # [B, T, C]
    t_rec = c.shape[-2]
    n = n_samples.to(torch.int64)
    n_frames = torch.clamp(1 + torch.div(n - cfg.frame_len, cfg.hop_len,
                                         rounding_mode="floor"), min=0)
    start, end, _ = tvad.detect_endpoints(signals, cfg, vad_cfg, n)
    idx = torch.arange(t_rec, device=signals.device)
    valid = idx < n_frames[:, None]                               # [B, T]
    rejected = valid & ((idx < start[:, None]) | (idx >= end[:, None]))
    # the fallback's picks rank raw frames, on the VAD's grid
    frames_ = fe.frame(signals, cfg.frame_len, cfg.hop_len)
    e = torch.sum(frames_ * frames_, dim=-1)
    k_dyn = torch.clamp((valid.sum(-1).to(torch.float32) * cfg.ss_frac)
                        .to(torch.int32), min=3)
    keyed = torch.where(valid, e, torch.full_like(e, float("inf")))
    order = torch.argsort(keyed, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    low_e = (rank < k_dyn[:, None]) & valid
    n_rej = rejected.sum()
    pick = torch.where(n_rej > 0, rejected, low_e).to(c.dtype)[..., None]
    mean = (torch.sum(c * pick, dim=(0, 1))
            / torch.clamp(torch.sum(pick), min=1.0))              # [C]
    return mean, n_rej


def pmc_adapt_means(means: torch.Tensor, noise_ceps: torch.Tensor,
                    mats: fe.FrontendMatrices,
                    cfg: FrontendConfig = FrontendConfig(),
                    gain: float = 1.0,
                    n_static: int | None = None) -> torch.Tensor:
    """Log-add PMC on Gaussian means [..., F] -> adapted means.

    Only the first ``n_static`` (default ``cfg.n_mfcc``) coefficients, the
    static cepstral block, are compensated; delta blocks pass through.
    ``gain`` scales the estimated noise power (1.0 trusts the estimate).
    """
    n_static = cfg.n_mfcc if n_static is None else n_static
    static = means[..., :n_static]                                # [..., C]
    lifter = mats.lifter                                          # [C]
    d = mats.dct_t.T                                              # [C, M]
    d_pinv = torch.linalg.pinv(d)                                 # [M, C]

    def to_logmel(ceps):
        return torch.matmul(ceps / lifter, d_pinv.T)              # [..., M]

    noise_logmel = to_logmel(noise_ceps)                          # [M]
    m = to_logmel(static)                                         # [..., M]
    # log-add in the mel-power domain, floored like the forward path
    combined = torch.log(torch.clamp(torch.exp(m) + gain * torch.exp(noise_logmel),
                                     min=cfg.log_floor))
    adapted = torch.matmul(combined, d.T) * lifter                # [..., C]
    return torch.cat([adapted, means[..., n_static:]], dim=-1)


def pmc_supported(cfg: FrontendConfig) -> str | None:
    """None when PMC applies to this front end; else the reason it can't."""
    if cfg.feature_type != "mfcc":
        return "PMC inverts the MFCC chain (feature_type='mfcc' only)"
    if cfg.use_energy:
        return "use_energy replaces c0 — the cepstral inversion breaks"
    if cfg.cmn:
        return ("cmn already removes stationary offsets; PMC on CMN'd "
                "means is not modeled")
    return None
