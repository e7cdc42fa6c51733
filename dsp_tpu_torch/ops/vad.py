"""Vectorized endpoint detection (port of ``dsp_tpu/ops/vad.py``).

The energy/ZCR double-threshold detector of ``dsp_tpu/golden/vad.py``
with no sequential state machine: every run length comes from a cummax,

    run_end[t] = t - cummax_t( where(!f, t, -1) )

is the length of the consecutive-True run ending at t.  Reversing gives
runs starting at t; first/last qualifying positions come from argmax
over booleans.  All functions take a batch dimension in front:
energies/ZCR [B, T], lengths [B].  Endpoints are integer-equal to the
JAX package (tests/test_torch_vad.py).
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.config import FrontendConfig, VadConfig
from dsp_tpu_torch.ops import frontend as fe

ZCR_ABS_FLOOR = 5.0     # golden/vad.py: ZT = z_noise * zcr_mult + 5


def short_time_energy(frames: torch.Tensor) -> torch.Tensor:
    return (frames * frames).sum(dim=-1)


def zero_crossing_rate(frames: torch.Tensor) -> torch.Tensor:
    s = frames >= 0.0
    return (s[..., 1:] != s[..., :-1]).to(frames.dtype).sum(dim=-1)


def _run_ending_at(flag: torch.Tensor) -> torch.Tensor:
    """Length of consecutive-True run ending at each position (inclusive)."""
    t = flag.shape[-1]
    idx = torch.arange(t, device=flag.device).expand_as(flag)
    last_false = torch.cummax(
        torch.where(flag, torch.full_like(idx, -1), idx), dim=-1).values
    return idx - last_false


def _run_starting_at(flag: torch.Tensor) -> torch.Tensor:
    return _run_ending_at(flag.flip(-1)).flip(-1)


def _first_true(flag: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none)."""
    return torch.argmax(flag.to(torch.int32), dim=-1)


def _noise_thresholds(e: torch.Tensor, z: torch.Tensor, length: torch.Tensor,
                      vcfg: VadConfig):
    """Threshold computation -> (th, tl, zt, valid, idx), batched over B.

    Mirrors golden/vad.py:thresholds, incl. the ``two_pass`` mode's
    integer-percent rank arithmetic.  The ceiling index is clamped at 0
    for an empty utterance (ROADMAP.md queue 3); every sorted entry is
    +inf then, so the result equals the JAX package's wrapped index.
    """
    t = e.shape[-1]
    idx = torch.arange(t, device=e.device)[None, :]           # [1, T]
    length = length[:, None]                                  # [B, 1]
    valid = idx < length

    n_init = torch.clamp(length, max=vcfg.n_init)
    init_mask = (idx < n_init).to(e.dtype)
    denom = torch.clamp(init_mask.sum(dim=-1, keepdim=True), min=1.0)
    e_noise = (e * init_mask).sum(dim=-1, keepdim=True) / denom + vcfg.e_abs_floor
    z_noise = (z * init_mask).sum(dim=-1, keepdim=True) / denom
    th = e_noise * vcfg.e_high_mult
    tl = e_noise * vcfg.e_low_mult
    zt = z_noise * vcfg.zcr_mult + ZCR_ABS_FLOOR
    if vcfg.threshold_mode == "two_pass":
        fp = round(vcfg.tp_floor_frac * 100)
        cq = round(vcfg.tp_ceil_q * 100)
        inf = torch.full_like(e, float("inf"))
        e_sorted = torch.sort(torch.where(valid, e, inf), dim=-1).values
        k = torch.clamp(torch.div(fp * length + 99, 100, rounding_mode="floor"),
                        min=1)                                # ceil(frac*n)
        floor = (torch.where(idx < k, e_sorted, torch.zeros_like(e))
                 .sum(dim=-1, keepdim=True) / k.to(e.dtype)) + vcfg.e_abs_floor
        ceil_at = torch.div(cq * torch.clamp(length - 1, min=0), 100,
                            rounding_mode="floor")
        ceil = torch.take_along_dim(e_sorted, ceil_at, dim=-1)
        use = ceil >= vcfg.tp_min_contrast * floor
        th = torch.where(use, floor + vcfg.tp_high * (ceil - floor), th)
        tl = torch.where(use, floor + vcfg.tp_low * (ceil - floor), tl)
    elif vcfg.threshold_mode != "noise_mult":
        raise ValueError(
            f"unknown VadConfig.threshold_mode {vcfg.threshold_mode!r}")
    return th, tl, zt, valid, idx


def detect_endpoints_frames(e: torch.Tensor, z: torch.Tensor,
                            length: torch.Tensor | None = None,
                            vcfg: VadConfig = VadConfig()):
    """Core detector on per-frame energy/ZCR [B, T].

    ``length`` [B] counts the valid frames; frames beyond it are ignored.
    Returns (start [B], end_exclusive [B], found [B]).
    """
    b, t = e.shape
    if length is None:
        length = torch.full((b,), t, dtype=torch.int64, device=e.device)
    length = length.to(torch.int64)
    th, tl, zt, valid, idx = _noise_thresholds(e, z, length, vcfg)

    high = (e > th) & valid
    qual = _run_ending_at(high) >= vcfg.min_speech_frames
    found = qual.any(dim=-1)
    t_first = _first_true(qual)                       # first qualifying end
    start_core = t_first - vcfg.min_speech_frames + 1
    end_core = t - 1 - _first_true(qual.flip(-1))     # last qualifying end

    audible = ((e > tl) | (z > zt)) & valid
    back = _run_ending_at(audible)                    # run ending at t
    fwd = _run_starting_at(audible)                   # run starting at t

    def at(x, i):
        return torch.take_along_dim(x, i[:, None], dim=-1)[:, 0]

    start = torch.where(
        start_core > 0,
        start_core - at(back, torch.clamp(start_core - 1, min=0)),
        torch.zeros_like(start_core))
    end = torch.where(
        end_core + 1 < length,
        end_core + at(fwd, torch.clamp(end_core + 1, max=t - 1)),
        end_core)
    end_excl = torch.minimum(length, end + 1 + vcfg.hangover_frames)

    start = torch.where(found, start, torch.zeros_like(start))
    end_excl = torch.where(found, end_excl, length)
    return start, end_excl, found


def detect_endpoints(x: torch.Tensor,
                     fcfg: FrontendConfig = FrontendConfig(),
                     vcfg: VadConfig = VadConfig(),
                     length_samples: torch.Tensor | None = None):
    """Signals [B, N] -> (start_frame [B], end_frame_exclusive [B], found [B]).

    Frames the RAW signal (no pre-emphasis) on the standard grid, like the
    golden spec.  ``length_samples`` [B] masks padded signal tails.
    """
    frames = fe.frame(x, fcfg.frame_len, fcfg.hop_len)
    e = short_time_energy(frames)
    z = zero_crossing_rate(frames)
    if length_samples is None:
        n_frames = None
    else:
        n_frames = torch.clamp(
            1 + torch.div(length_samples.to(torch.int64) - fcfg.frame_len,
                          fcfg.hop_len, rounding_mode="floor"), min=0)
    return detect_endpoints_frames(e, z, n_frames, vcfg)
