"""Streaming chunked front-end and causal VAD (port of ``dsp_tpu/ops/streaming.py``).

BASELINE config 2: audio arrives in fixed chunks of ``chunk_len`` samples
and each chunk advances a carried :class:`StreamState`:

* **Chunked MFCC on the offline grid.**  The carry holds the raw samples
  that have not filled a frame yet (the residual) and the sample before
  them (pre-emphasis continuity), so the valid frames of every chunk,
  concatenated, are the offline framing grid.  ``chunk_len`` must be a
  multiple of the hop.
* **Causal VAD.**  A two-state (silence / speech) double-threshold machine
  steps through the chunk's frames; the classic candidate state is the
  run counter ``run_high`` reaching ``min_speech_frames``.  It cannot see
  the future, so it does not equal the offline detector: the backward
  extension is the run of audible frames at trigger time.
* **Causal denoise.**  With ``denoise="spectral_subtraction"`` the carry
  sums the power spectra of the first ``n_init`` valid frames (the VAD's
  noise frames), and each frame subtracts that running mean.

One implementation runs S streams at once over a leading stream axis
(:func:`process_chunk_batch`, the JAX package's ``vmap``); :func:`process_chunk`
is its one-stream case.  The state stays on the device: no call reads a
value back to the host, and the VAD's transitions are ``torch.where``.
The per-frame VAD step is a Python loop of small tensor ops (``lax.scan``
in the JAX package).  Every shape is static: a chunk gives ``chunk_len /
hop`` frame slots with validity flags, and an utterance end is a per-frame
flag with its start and end indices.  Counters and indices are int32, as
in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsp_tpu_torch.config import FrontendConfig, VadConfig
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops import vad as tvad
from dsp_tpu_torch.utils.logging import warn_once

# Two states: the candidate state of the classic detector is the run
# counter (run_high must reach min_speech_frames before SIL -> SPEECH).
SIL, SPEECH = 0, 2


class StreamState(NamedTuple):
    """Carry between chunks; the fields, their order and dtypes are the JAX
    package's, each with a leading stream axis under the batched calls."""

    prev_sample: torch.Tensor  # [] f32 sample before the residual (pre-emphasis)
    residual: torch.Tensor     # [R] f32 raw samples not yet framed
    n_samples: torch.Tensor    # [] i32 raw samples consumed so far
    frame_idx: torch.Tensor    # [] i32 global index of the next emitted frame
    # --- VAD state ---
    vad_state: torch.Tensor    # [] i32 SIL or SPEECH
    noise_e: torch.Tensor      # [] f32 running noise energy sum
    noise_z: torch.Tensor      # [] f32 running noise ZCR sum
    n_noise: torch.Tensor      # [] f32 frames summed into the noise stats
    run_high: torch.Tensor     # [] i32 consecutive high-energy frames
    run_low: torch.Tensor      # [] i32 consecutive inaudible frames
    run_audible: torch.Tensor  # [] i32 consecutive audible frames
    utt_start: torch.Tensor    # [] i32 start frame of the current utterance
    # --- denoise state (zero when FrontendConfig.denoise is None) ---
    noise_psd: torch.Tensor    # [K] f32 noise power-spectrum sum over the
    #                              same first-n_init valid frames (count n_noise)


class ChunkOutput(NamedTuple):
    mfcc: torch.Tensor           # [Tc, n_mfcc]
    energy: torch.Tensor         # [Tc]
    zcr: torch.Tensor            # [Tc]
    frame_valid: torch.Tensor    # [Tc] bool: the frame exists on the offline grid
    in_speech: torch.Tensor      # [Tc] bool
    utt_end: torch.Tensor        # [Tc] bool: an utterance ended at this frame
    utt_start_idx: torch.Tensor  # [Tc] i32 global start frame of the ended utterance
    utt_end_idx: torch.Tensor    # [Tc] i32 global end frame (exclusive)


def residual_len(cfg: FrontendConfig, chunk_len: int) -> int:
    """Residual size that keeps chunk framing on the offline grid."""
    if chunk_len % cfg.hop_len != 0:
        raise ValueError("chunk_len must be a multiple of hop_len")
    if chunk_len < cfg.frame_len:
        raise ValueError("chunk_len must be >= frame_len")
    return ((chunk_len - cfg.frame_len) % cfg.hop_len
            + cfg.frame_len - cfg.hop_len)


def init_state_batch(n_streams: int, cfg: FrontendConfig, chunk_len: int,
                     device: str | torch.device = "cuda") -> StreamState:
    """Zero carry of ``n_streams`` concurrent streams on ``device``."""
    r = residual_len(cfg, chunk_len)
    s = (n_streams,)

    def f32(*shape):
        return torch.zeros(s + shape, dtype=torch.float32, device=device)

    def i32():
        return torch.zeros(s, dtype=torch.int32, device=device)

    return StreamState(
        prev_sample=f32(), residual=f32(r), n_samples=i32(), frame_idx=i32(),
        vad_state=i32(), noise_e=f32(), noise_z=f32(), n_noise=f32(),
        run_high=i32(), run_low=i32(), run_audible=i32(), utt_start=i32(),
        noise_psd=f32(cfg.n_bins))


def init_state(cfg: FrontendConfig, chunk_len: int,
               device: str | torch.device = "cuda") -> StreamState:
    """Zero carry of one stream on ``device``."""
    return StreamState(*(a[0] for a in init_state_batch(1, cfg, chunk_len, device)))


def _vad_frames(vcfg: VadConfig, carry, e, z, fidx, valid):
    """The causal detector over a chunk's frames, one frame at a time;
    ``carry`` is (vad_state, noise_e, noise_z, n_noise, run_high, run_low,
    run_audible, utt_start), each [S]; e, z, fidx, valid are [S, Tc].

    Always the noise_mult rule: ``two_pass`` thresholds need the whole
    utterance's energies, which a causal detector cannot see."""
    if vcfg.threshold_mode == "two_pass":
        warn_once("stream-two-pass",
                  "two_pass VAD thresholds are offline-only; the "
                  "streaming detector keeps the causal noise_mult rule")
    state, ne, nz, nn, rh, rl, ra, us = carry
    outs = []
    for t in range(e.shape[-1]):
        et, zt_, ft, vt = e[:, t], z[:, t], fidx[:, t], valid[:, t]
        # noise statistics: fp32 sums frame by frame, in the JAX order
        collect = (nn < vcfg.n_init) & vt
        ne = ne + torch.where(collect, et, 0.0)
        nz = nz + torch.where(collect, zt_, 0.0)
        nn = nn + torch.where(collect, 1.0, 0.0)

        e_noise = ne / torch.clamp(nn, min=1.0) + vcfg.e_abs_floor
        th = e_noise * vcfg.e_high_mult
        tl = e_noise * vcfg.e_low_mult
        zt = (nz / torch.clamp(nn, min=1.0)) * vcfg.zcr_mult + tvad.ZCR_ABS_FLOOR

        high = (et > th) & vt
        audible = ((et > tl) | (zt_ > zt)) & vt

        rh = torch.where(high, rh + 1, 0)
        ra = torch.where(audible, ra + 1, 0)
        rl = torch.where(audible, 0, rl + 1)

        trigger = (state != SPEECH) & (rh >= vcfg.min_speech_frames)
        # backward extension approximation: the audible run ending here
        new_start = ft - torch.clamp(ra, min=vcfg.min_speech_frames) + 1
        us = torch.where(trigger, torch.clamp(new_start, min=0), us)

        ending = (state == SPEECH) & (rl >= vcfg.max_silence_frames)
        end_idx = ft - vcfg.max_silence_frames + 1 + vcfg.hangover_frames
        end_idx = torch.maximum(end_idx, us + 1)

        state = torch.where(trigger, SPEECH, torch.where(ending, SIL, state))
        outs.append((state == SPEECH, ending, us, end_idx))
    stacked = tuple(torch.stack(o, dim=-1) for o in zip(*outs))
    return (state, ne, nz, nn, rh, rl, ra, us), stacked


def process_chunk_batch(state: StreamState, chunks: torch.Tensor,
                        mats: fe.FrontendMatrices,
                        fcfg: FrontendConfig = FrontendConfig(),
                        vcfg: VadConfig = VadConfig(),
                        chunk_len: int = 1600):
    """S concurrent streams, one chunk each: a stacked state
    (:func:`init_state_batch`) and chunks [S, chunk_len] -> (state',
    :class:`ChunkOutput` with a leading stream axis).  Streams are
    independent; a server advances every live session with one call."""
    r = residual_len(fcfg, chunk_len)
    tc = chunk_len // fcfg.hop_len
    hop = fcfg.hop_len

    buf = torch.cat([state.residual, chunks.to(torch.float32)], dim=-1)
    n = buf.shape[-1]
    frames_raw = fe.frame(buf, fcfg.frame_len, hop)[:, :tc]

    # pre-emphasis with cross-chunk continuity
    prev = torch.cat([state.prev_sample[:, None], buf[:, :-1]], dim=-1)
    y = buf - fcfg.preemphasis * prev
    frames_y = fe.frame(y, fcfg.frame_len, hop)[:, :tc]

    # frame f of this chunk starts at global sample (n_samples - R) + f*hop
    steps = torch.arange(tc, dtype=torch.int32, device=buf.device) * hop
    starts = state.n_samples[:, None] - r + steps
    frame_valid = starts >= 0
    n_valid = torch.cumsum(frame_valid, dim=-1, dtype=torch.int32)
    fidx = state.frame_idx[:, None] + n_valid - 1

    noise_psd = state.noise_psd
    if fcfg.denoise == "spectral_subtraction":
        # the offline estimate (the k lowest-energy frames of the whole
        # recording) is non-causal; the carry sums the PSD of the VAD's
        # first n_init valid frames instead (count shared via n_noise)
        pspec = fe.power_spectrum(frames_y, mats, fcfg)
        vf = frame_valid.to(torch.float32)
        n_before = state.n_noise[:, None] + torch.cumsum(vf, dim=-1) - vf
        collect = vf * (n_before < vcfg.n_init).to(torch.float32)
        noise_psd = state.noise_psd + (pspec * collect[..., None]).sum(dim=-2)
        cnt = torch.clamp(state.n_noise + collect.sum(dim=-1), min=1.0)
        sub = pspec - fcfg.ss_alpha * (noise_psd / cnt[:, None])[:, None, :]
        pspec = torch.maximum(sub, fcfg.ss_beta * pspec)
        mfcc = fe.mfcc_from_pspec(pspec, frames_y, mats, fcfg)
    elif fcfg.denoise is not None:
        raise ValueError(f"unknown FrontendConfig.denoise {fcfg.denoise!r}")
    else:
        mfcc = fe.mfcc_from_frames(frames_y, mats, fcfg)
    e = tvad.short_time_energy(frames_raw)
    z = tvad.zero_crossing_rate(frames_raw)

    carry = (state.vad_state, state.noise_e, state.noise_z, state.n_noise,
             state.run_high, state.run_low, state.run_audible, state.utt_start)
    carry, (in_speech, utt_end, utt_start_idx, utt_end_idx) = _vad_frames(
        vcfg, carry, e, z, fidx, frame_valid)

    new_state = StreamState(
        prev_sample=buf[:, n - r - 1],
        # not buf[:, -r:]: with r == 0 (frame_len == hop_len) that is the
        # whole buffer, and the residual would grow by chunk_len a chunk
        residual=buf[:, n - r:],
        n_samples=state.n_samples + chunk_len,
        frame_idx=state.frame_idx + n_valid[:, -1],
        vad_state=carry[0], noise_e=carry[1], noise_z=carry[2],
        n_noise=carry[3], run_high=carry[4], run_low=carry[5],
        run_audible=carry[6], utt_start=carry[7],
        noise_psd=noise_psd,
    )
    out = ChunkOutput(mfcc, e, z, frame_valid, in_speech,
                      utt_end, utt_start_idx, utt_end_idx)
    return new_state, out


def process_chunk(state: StreamState, chunk: torch.Tensor,
                  mats: fe.FrontendMatrices,
                  fcfg: FrontendConfig = FrontendConfig(),
                  vcfg: VadConfig = VadConfig(),
                  chunk_len: int = 1600):
    """One audio chunk [chunk_len] -> (state', :class:`ChunkOutput`): the
    one-stream case of :func:`process_chunk_batch`."""
    new_state, out = process_chunk_batch(
        StreamState(*(a[None] for a in state)), chunk[None], mats, fcfg,
        vcfg, chunk_len)
    return (StreamState(*(a[0] for a in new_state)),
            ChunkOutput(*(a[0] for a in out)))


def shard_streams(mesh, state: StreamState, chunks):
    """Streams placed on a device mesh: not ported yet."""
    raise NotImplementedError(
        "shard_streams is not ported yet (queue 1, item 15 in ROADMAP.md)")
