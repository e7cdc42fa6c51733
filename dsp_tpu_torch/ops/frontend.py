"""MFCC front-end ops in PyTorch (port of ``dsp_tpu/ops/frontend.py``).

The chain is the JAX package's, as elementwise ops and fp32 matrix
products:

    frames --(window)--> [*, L]
      @ DFT_cos / DFT_sin [L, K]      (rFFT power as two GEMMs; zero-padding
                                       to NFFT is implicit)
      square+add -> power [*, K]
      @ mel_fb [K, M] -> log -> @ DCT [M, C] -> lifter

Where ``n_fft`` is below the frame length the window, fold and DFT run in
float64 (:func:`power_spectrum`).  The constant matrices are built in
float64 numpy from the same formulas as ``dsp_tpu/golden/frontend.py``
(``hamming``, ``mel_filterbank``, ``dct_matrix``, ``lifter_coeffs`` are
copied here) and must equal ``dsp_tpu.ops.frontend._matrices_np`` exactly
(tests/test_torch_config.py).

Every function takes tensors with the batch dimensions written out in
front; the time axis is -2 for feature tensors and -1 for signals.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dsp_tpu_torch.config import FrontendConfig


class FrontendMatrices(NamedTuple):
    """Constant matrices of the front-end, float32 on one device."""

    window: torch.Tensor     # [L]
    dft_cos: torch.Tensor    # [L, K]  cos(2 pi k n / NFFT)
    dft_sin: torch.Tensor    # [L, K]  -sin(2 pi k n / NFFT)
    mel_fb_t: torch.Tensor   # [K, M]
    dct_t: torch.Tensor      # [M, C]
    lifter: torch.Tensor     # [C]


# ---------------------------------------------------------------- constants
def hamming(n: int) -> np.ndarray:
    """Symmetric Hamming window: 0.54 - 0.46 cos(2 pi k / (n-1))."""
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """HTK-style triangular mel filterbank [n_mels, n_fft//2 + 1].

    Filter m rises linearly (in FFT-bin index) from bin point m to m+1 and
    falls to m+2, with the n_mels+2 bin points equally spaced on the mel
    scale between fmin and fmax and rounded down to FFT bins
    (floor((n_fft+1) * f / sr)).  Unnormalised (peak 1).
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / sample_rate).astype(np.int64)
    fb = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = bins[m], bins[m + 1], bins[m + 2]
        for k in range(left, center):
            if center > left:
                fb[m, k] = (k - left) / (center - left)
        for k in range(center, right):
            if right > center:
                fb[m, k] = (right - k) / (right - center)
    return fb


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_out, n_in] (scipy.fft.dct norm='ortho')."""
    k = np.arange(n_out, dtype=np.float64)[:, None]
    n = np.arange(n_in, dtype=np.float64)[None, :]
    mat = np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= np.sqrt(0.5)
    return mat


def lifter_coeffs(n_mfcc: int, lifter: int) -> np.ndarray:
    """Sinusoidal liftering weights: 1 + (L/2) sin(pi k / L)."""
    if lifter <= 0:
        return np.ones(n_mfcc, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    return 1.0 + (lifter / 2.0) * np.sin(np.pi * k / lifter)


@functools.lru_cache(maxsize=8)
def matrices_np(cfg: FrontendConfig):
    """(window, dft_cos, dft_sin, mel_fb_t, dct_t, lifter), float64 numpy."""
    length, k = cfg.frame_len, cfg.n_bins
    n = np.arange(length, dtype=np.float64)[:, None]
    kk = np.arange(k, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * kk / cfg.n_fft
    return (
        hamming(length),
        np.cos(ang),
        -np.sin(ang),
        mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate,
                       cfg.fmin, cfg.fmax_hz).T,
        dct_matrix(cfg.n_mfcc, cfg.n_mels).T,
        lifter_coeffs(cfg.n_mfcc, cfg.lifter),
    )


@functools.lru_cache(maxsize=8)
def make_matrices(cfg: FrontendConfig = FrontendConfig(),
                  device: str | torch.device = "cuda") -> FrontendMatrices:
    """Front-end constants as contiguous float32 tensors on ``device``.

    Cached per (config, device): the tensors are read-only constants."""
    return FrontendMatrices(*(
        torch.as_tensor(np.ascontiguousarray(m), dtype=torch.float32,
                        device=device)
        for m in matrices_np(cfg)))


# ---------------------------------------------------------------- signal ops
def preemphasis(x: torch.Tensor, alpha: float = 0.97) -> torch.Tensor:
    """y[n] = x[n] - alpha x[n-1], y[0] = x[0]; any leading batch dims."""
    shifted = torch.nn.functional.pad(x[..., :-1], (1, 0))
    return x - alpha * shifted


def frame(x: torch.Tensor, frame_len: int, hop_len: int) -> torch.Tensor:
    """[..., N] -> [..., T, frame_len] with T = 1 + (N - frame_len)//hop."""
    n = x.shape[-1]
    if n < frame_len:
        raise ValueError(f"signal ({n}) shorter than one frame ({frame_len})")
    return x.unfold(-1, frame_len, hop_len)


def power_spectrum_fft(wframes: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Exact rFFT power spectrum (the parity path; ``torch.fft.rfft``
    truncates or zero-pads each frame to ``n_fft``)."""
    spec = torch.fft.rfft(wframes, n=n_fft, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2) / float(n_fft)


def power_spectrum_dft(wframes: torch.Tensor, mats: FrontendMatrices,
                       n_fft: int) -> torch.Tensor:
    """rFFT power as two fp32 GEMMs (TF32 is off package-wide)."""
    re = torch.matmul(wframes, mats.dft_cos)
    im = torch.matmul(wframes, mats.dft_sin)
    return (re * re + im * im) / float(n_fft)


@functools.lru_cache(maxsize=8)
def fold_matrices(cfg: FrontendConfig, device: str | torch.device = "cuda"):
    """float64 constants of the folded spectrum: the window [L] and one
    period's DFT, cos / -sin [n_fft, K] (the first n_fft rows of
    :func:`matrices_np`'s)."""
    window, cos, sin = matrices_np(cfg)[:3]
    return tuple(torch.as_tensor(np.ascontiguousarray(m), dtype=torch.float64,
                                 device=device)
                 for m in (window, cos[:cfg.n_fft], sin[:cfg.n_fft]))


def power_spectrum(frames_: torch.Tensor, mats: FrontendMatrices,
                   cfg: FrontendConfig) -> torch.Tensor:
    """Frames [..., T, L] -> windowed power spectrum [..., T, K], in the
    frames' dtype.

    Where ``n_fft < L`` each point of the transform sums the samples folded
    onto it (the DFT matrix aliases sample n onto n mod n_fft), and the
    quietest mel bands of speech frames, ~1e-7 of a frame's energy, sink to
    float32 rounding in the fold and the transform.  There the window, the
    fold and one period's DFT run in float64 and only the power returns to
    the frames' dtype, as in the fused kernel's folded path
    (``csrc/mfcc_fused.cu``); the JAX package keeps float32 there.
    Otherwise: :func:`power_spectrum_dft`."""
    length, n_fft = frames_.shape[-1], cfg.n_fft
    if n_fft >= length:
        return power_spectrum_dft(frames_ * mats.window, mats, n_fft)
    window, cos, sin = fold_matrices(cfg, frames_.device)
    wx = torch.nn.functional.pad(frames_.to(torch.float64) * window, (0, -length % n_fft))
    folded = wx.reshape(*wx.shape[:-1], -1, n_fft).sum(dim=-2)
    re, im = torch.matmul(folded, cos), torch.matmul(folded, sin)
    return ((re * re + im * im) / float(n_fft)).to(frames_.dtype)


def spectral_subtract(pspec: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Berouti spectral subtraction on [..., T, K] power spectrograms.

    Noise PSD is the mean over the k lowest-energy frames with energy > 0
    (zero-padding frames rank +inf and are excluded), then
    ``max(P - ss_alpha*N, ss_beta*P)``.  All-silent input is a no-op.
    Sorting is stable, as in the JAX package, so ties pick the same frames.
    """
    e = pspec.sum(dim=-1)                                     # [..., T]
    valid = e > 0.0
    n_valid = valid.sum(dim=-1, keepdim=True)                 # [..., 1]
    k_dyn = torch.clamp((n_valid.to(torch.float32) * cfg.ss_frac)
                        .to(torch.int32), min=3)
    keyed = torch.where(valid, e, torch.full_like(e, float("inf")))
    order = torch.argsort(keyed, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)          # [..., T]
    pick = ((rank < k_dyn) & valid).to(pspec.dtype)
    cnt = pick.sum(dim=-1)[..., None]
    noise = ((pspec * pick[..., None]).sum(dim=-2)
             / torch.clamp(cnt, min=1.0))                     # [..., K]
    sub = pspec - cfg.ss_alpha * noise[..., None, :]
    return torch.maximum(sub, cfg.ss_beta * pspec)


def mfcc_from_pspec(pspec: torch.Tensor, frames_: torch.Tensor,
                    mats: FrontendMatrices,
                    cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Power spectrogram [..., T, K] (+ raw frames for the energy
    coefficient) -> MFCC [..., T, C]."""
    mel_e = torch.matmul(pspec, mats.mel_fb_t)
    log_mel = torch.log(torch.clamp(mel_e, min=cfg.log_floor))
    ceps = torch.matmul(log_mel, mats.dct_t) * mats.lifter
    if cfg.use_energy:
        frame_e = (frames_ * frames_).sum(dim=-1)
        c0 = torch.log(torch.clamp(frame_e, min=cfg.log_floor))
        ceps = torch.cat([c0[..., None], ceps[..., 1:]], dim=-1)
    return ceps


def mfcc_from_frames(frames_: torch.Tensor, mats: FrontendMatrices,
                     cfg: FrontendConfig = FrontendConfig(),
                     use_fft: bool = False) -> torch.Tensor:
    """Frames of the pre-emphasised signal [..., T, L] -> MFCC [..., T, C].

    The plain version of the fused MFCC kernel (kernels/mfcc_fused.py);
    ``use_fft`` takes the power spectrum from :func:`power_spectrum_fft`
    instead."""
    pspec = (power_spectrum_fft(frames_ * mats.window, cfg.n_fft) if use_fft
             else power_spectrum(frames_, mats, cfg))
    if cfg.denoise == "spectral_subtraction":
        pspec = spectral_subtract(pspec, cfg)
    elif cfg.denoise is not None:
        raise ValueError(f"unknown FrontendConfig.denoise {cfg.denoise!r}")
    return mfcc_from_pspec(pspec, frames_, mats, cfg)


def mfcc(x: torch.Tensor, cfg: FrontendConfig = FrontendConfig(),
         mats: FrontendMatrices | None = None,
         use_fft: bool = False) -> torch.Tensor:
    """Signal [..., N] -> MFCC [..., T, n_mfcc] (whatever
    ``cfg.feature_type`` says: the pipeline picks LPCC, ``ops/lpc.py``)."""
    if mats is None:
        mats = make_matrices(cfg, x.device)
    y = preemphasis(x, cfg.preemphasis)
    frames_ = frame(y, cfg.frame_len, cfg.hop_len)
    return mfcc_from_frames(frames_, mats, cfg, use_fft)


def time_normalize(feats: torch.Tensor, length: torch.Tensor,
                   target_len: int) -> torch.Tensor:
    """Linear time normalisation: [..., T, F] + true lengths [...] ->
    [..., L, F].

    Resamples every utterance to ``target_len`` frames by linear
    interpolation on the grid p = linspace(0, length-1, L), as
    numpy.interp would (the linear-time-warp matcher's front half)."""
    t = feats.shape[-2]
    scale = (torch.clamp(length - 1, min=0).to(torch.float32)
             / max(target_len - 1, 1))
    pos = (torch.arange(target_len, dtype=torch.float32, device=feats.device)
           * scale[..., None])                                  # [..., L]
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, t - 1)
    hi = torch.clamp(lo + 1, 0, t - 1)
    frac = (pos - lo.to(torch.float32))[..., None]
    f_lo = torch.take_along_dim(feats, lo[..., None], dim=-2)
    f_hi = torch.take_along_dim(feats, hi[..., None], dim=-2)
    return f_lo + frac * (f_hi - f_lo)


# --------------------------------------------------------------- delta / CMN
def _delta_denom(width: int) -> float:
    return 2.0 * sum(n * n for n in range(1, width + 1))


def deltas(feats: torch.Tensor, width: int = 2) -> torch.Tensor:
    """Regression deltas with edge replication (static length)."""
    t = feats.shape[-2]
    idx = torch.arange(t, device=feats.device)
    acc = torch.zeros_like(feats)
    for n in range(1, width + 1):
        hi = torch.clamp(idx + n, max=t - 1)
        lo = torch.clamp(idx - n, min=0)
        acc = acc + n * (feats.index_select(-2, hi)
                         - feats.index_select(-2, lo))
    return acc / _delta_denom(width)


def masked_deltas(feats: torch.Tensor, length: torch.Tensor,
                  width: int = 2) -> torch.Tensor:
    """Deltas where the replicated edge is the *true* last frame.

    feats [B, T, F], length [B]: gather indices are clamped to
    [0, length-1] so padded frames never leak into the deltas of valid
    frames (padding invariance).
    """
    t = feats.shape[-2]
    idx = torch.arange(t, device=feats.device)[None, :]       # [1, T]
    hi_cap = torch.clamp(length - 1, min=0)[:, None]          # [B, 1]
    zero = torch.zeros_like(hi_cap)

    def rows(shift: int) -> torch.Tensor:
        i = torch.minimum(torch.maximum(idx + shift, zero), hi_cap)
        return torch.take_along_dim(feats, i[..., None], dim=-2)

    acc = torch.zeros_like(feats)
    for n in range(1, width + 1):
        acc = acc + n * (rows(n) - rows(-n))
    return acc / _delta_denom(width)


def causal_cmn(feats: torch.Tensor, alpha: float) -> torch.Tensor:
    """Causal cepstral mean subtraction (FrontendConfig.cmn_mode="causal").

    Bias-corrected exponential running mean over the time axis (-2):

        num_t = alpha * num_{t-1} + (1 - alpha) * c_t,   num_{-1} = 0
        m_t   = num_t / (1 - alpha^(t+1))
        out_t = c_t - m_t

    A plain loop over T (the JAX package uses an associative scan; the
    two round differently within float32 tolerance).  Prefix-stable: row
    t sees only rows <= t.
    """
    t = feats.shape[-2]
    num = torch.zeros_like(feats[..., 0, :])
    out = torch.empty_like(feats)
    for i in range(t):
        num = alpha * num + (1.0 - alpha) * feats[..., i, :]
        out[..., i, :] = feats[..., i, :] - num / (1.0 - alpha ** (i + 1))
    return out


def add_deltas(feats: torch.Tensor, cfg: FrontendConfig,
               length: torch.Tensor | None = None) -> torch.Tensor:
    """Stack [c, delta, delta-delta] -> [..., T, 3*n_mfcc]."""
    if not cfg.add_deltas:
        return feats
    if length is None:
        d1 = deltas(feats, cfg.delta_width)
        d2 = deltas(d1, cfg.delta_width)
    else:
        d1 = masked_deltas(feats, length, cfg.delta_width)
        d2 = masked_deltas(d1, length, cfg.delta_width)
    return torch.cat([feats, d1, d2], dim=-1)
