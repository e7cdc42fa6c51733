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


def _rank_positions(flag: torch.Tensor, size: int) -> torch.Tensor:
    """Positions of the first ``size`` True entries of each row [B, T] ->
    [B, size], in time order, 0 where a row has fewer (``jnp.nonzero(...,
    size=size, fill_value=0)`` of the JAX package, with no read-back):
    each True entry's rank is its prefix count, and entries of rank
    >= ``size`` are written to a dropped spare column."""
    b, t = flag.shape
    rank = torch.cumsum(flag.to(torch.int64), dim=-1) - 1
    sel = flag & (rank < size)
    slot = torch.where(sel, rank, torch.full_like(rank, size))
    pos = torch.arange(t, device=flag.device).expand(b, t)
    out = torch.zeros((b, size + 1), dtype=torch.int64, device=flag.device)
    return out.scatter_(1, slot, torch.where(sel, pos, torch.zeros_like(pos)))[:, :size]


def detect_segments_frames(e: torch.Tensor, z: torch.Tensor,
                           length: torch.Tensor | None = None,
                           vcfg: VadConfig = VadConfig(),
                           max_segments: int = 8):
    """Connected-word splitter on per-frame energy/ZCR [B, T].

    Matches ``dsp_tpu.golden.vad.detect_segments`` frame for frame with no
    sequential state: core runs, audible extension, gap bridging,
    hangover and the short-segment drop are each a run-length computation
    on boolean masks (the cummax trick).  Returns ``(starts [B, S],
    ends_exclusive [B, S], n_segs [B])`` with ``S = max_segments``; rows
    past ``n_segs`` are 0.  A recording with more than ``S`` utterances
    keeps its first ``S`` in time order.
    """
    b, t = e.shape
    if length is None:
        length = torch.full((b,), t, dtype=torch.int64, device=e.device)
    length = length.to(torch.int64)
    th, tl, zt, valid, idx = _noise_thresholds(e, z, length, vcfg)
    pos = idx.expand(b, t)

    def cummax_where(flag, fill):
        return torch.cummax(torch.where(flag, pos, torch.full_like(pos, fill)),
                            dim=-1).values

    high = (e > th) & valid
    audible = ((e > tl) | (z > zt)) & valid

    # 1. core: frame sits inside a run of >= min_speech_frames highs
    run_total = _run_ending_at(high) + _run_starting_at(high) - 1
    core = high & (run_total >= vcfg.min_speech_frames)

    # 2. regions: maximal (audible|core)-runs containing a core frame
    conn = audible | core
    run_start = idx - _run_ending_at(conn) + 1
    run_end = idx + _run_starting_at(conn) - 1
    last_core = cummax_where(core, -1)
    # the reference's reversed cummax, kept as it is: ncr runs over the
    # reversed flags with unreversed positions
    ncr = cummax_where(core.flip(-1), -1)
    next_core = t - 1 - ncr.flip(-1)       # == t when no core at/after idx
    region = conn & ((last_core >= run_start) | (next_core <= run_end))

    # 3. bridge interior silence gaps shorter than max_silence_frames
    gap = ~region
    g_start = idx - _run_ending_at(gap) + 1
    g_end = idx + _run_starting_at(gap) - 1
    bridge = (gap & (g_end - g_start + 1 < vcfg.max_silence_frames)
              & (g_start > 0) & (g_end <= length[:, None] - 2))
    merged = region | bridge

    # 4. hangover after each region end (touching regions merge)
    prev_m = cummax_where(merged, -(1 << 30))
    final = merged | ((idx - prev_m <= vcfg.hangover_frames) & valid)

    # 5. drop regions shorter than min_utterance_frames
    f_len = _run_ending_at(final) + _run_starting_at(final) - 1
    keep = final & (f_len >= vcfg.min_utterance_frames)

    edge = torch.zeros((b, 1), dtype=torch.bool, device=e.device)
    rising = keep & ~torch.cat([edge, keep[:, :-1]], dim=-1)
    falling = keep & ~torch.cat([keep[:, 1:], edge], dim=-1)
    n_segs = torch.clamp(rising.sum(dim=-1), max=max_segments)
    live = torch.arange(max_segments, device=e.device)[None, :] < n_segs[:, None]
    starts = _rank_positions(rising, max_segments)
    ends = _rank_positions(falling, max_segments) + 1
    zero = torch.zeros_like(starts)
    return torch.where(live, starts, zero), torch.where(live, ends, zero), n_segs


def detect_segments(x: torch.Tensor,
                    fcfg: FrontendConfig = FrontendConfig(),
                    vcfg: VadConfig = VadConfig(),
                    length_samples: torch.Tensor | None = None,
                    max_segments: int = 8):
    """Signals [B, N] -> (starts [B, S], ends_exclusive [B, S], n_segs [B])
    in frames: the connected-word counterpart of :func:`detect_endpoints`,
    on the same raw-signal framing."""
    frames = fe.frame(x, fcfg.frame_len, fcfg.hop_len)
    e = short_time_energy(frames)
    z = zero_crossing_rate(frames)
    if length_samples is None:
        n_frames = None
    else:
        n_frames = torch.clamp(
            1 + torch.div(length_samples.to(torch.int64) - fcfg.frame_len,
                          fcfg.hop_len, rounding_mode="floor"), min=0)
    return detect_segments_frames(e, z, n_frames, vcfg, max_segments)
