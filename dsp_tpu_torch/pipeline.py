"""Isolated-word pipeline in PyTorch (port of ``dsp_tpu/pipeline.py``).

Padded signals [B, max_samples] -> VAD endpoints -> MFCC + delta/delta-delta
features [B, max_frames, 39] -> all-pairs banded DTW against the template
bank -> argmin or kNN vote.  Everything runs on the device the signals lie
on; the entry points that take host signals put them on the card unless
the caller asks for the CPU, with no probe and no fallback.

Static-shape discipline as in the JAX package: signals are padded to
``cfg.max_samples`` and variable lengths travel as integer tensors next to
the data.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsp_tpu_torch.config import DtwConfig, PipelineConfig
from dsp_tpu_torch.ops import dtw as tdtw
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops import vad as tvad

# Distances at or above this are dead (unreachable or masked) candidates:
# unreachable pairs arrive normalised (BIG/(la+lb) ~ 2.5e27), every
# genuine distance sits far below it (pipeline.vote_topk in the JAX package).
DEAD = 1e20


class Features(NamedTuple):
    feats: torch.Tensor    # [B, T_max, n_feats]
    length: torch.Tensor   # [B] valid frame count (int32)


def pad_signals(signals, max_samples: int, device: str | torch.device = "cuda"):
    """Host list of 1-D signals -> (padded [B, max_samples] f32, lengths [B] i32)."""
    out = np.zeros((len(signals), max_samples), dtype=np.float32)
    lens = np.zeros(len(signals), dtype=np.int32)
    for i, s in enumerate(signals):
        s = np.asarray(s, dtype=np.float32)[:max_samples]
        out[i, : len(s)] = s
        lens[i] = len(s)
    return (torch.from_numpy(out).to(device), torch.from_numpy(lens).to(device))


def _cepstra(signals: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """Padded signals [B, N] -> cepstra [B, T, n_mfcc]."""
    f = cfg.frontend
    if f.feature_type != "mfcc":
        raise NotImplementedError(
            f"feature_type={f.feature_type!r} is not ported yet "
            "(ROADMAP.md queue 1, item 14)")
    if f.impl == "pallas":
        from dsp_tpu_torch.kernels.mfcc_fused import mfcc_fused
        return mfcc_fused(signals, f)
    if f.impl != "xla":
        raise ValueError(f"unknown FrontendConfig.impl {f.impl!r}")
    return fe.mfcc(signals, f, fe.make_matrices(f, signals.device))


def _finalize_window(c: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                     cfg: PipelineConfig, t_max: int | None = None) -> Features:
    """Cepstra [B, T_rec, C] + frame windows [start, end) -> masked Features.

    Gathers ``t_max`` (default ``cfg.max_frames``) frames from each
    ``start`` (window length clamped to [1, t_max]), then applies CMN and
    delta stacking as the JAX package's isolated path does.
    """
    f = cfg.frontend
    t_max = cfg.max_frames if t_max is None else t_max
    length = torch.clamp(end - start, min=1, max=t_max)            # [B]
    steps = torch.arange(t_max, device=c.device)
    idx = torch.clamp(start[:, None] + steps, 0, c.shape[1] - 1)   # [B, t_max]
    c = torch.take_along_dim(c, idx[..., None], dim=1)
    valid = (steps[None, :] < length[:, None])[..., None]          # [B, t_max, 1]
    if f.cmn:
        if f.cmn_mode == "causal":
            # prefix-stable: valid rows never see the clamped tail rows
            c = fe.causal_cmn(c, f.cmn_alpha)
        elif f.cmn_mode == "utterance":
            mean = ((c * valid.to(c.dtype)).sum(dim=1, keepdim=True)
                    / length.to(c.dtype)[:, None, None])
            c = c - mean
        else:
            raise ValueError(f"unknown FrontendConfig.cmn_mode {f.cmn_mode!r}")
    feats = fe.add_deltas(c, f, length)
    feats = torch.where(valid, feats, torch.zeros_like(feats))
    return Features(feats, length.to(torch.int32))


def _endpoints(signals: torch.Tensor, n_samples: torch.Tensor,
               cfg: PipelineConfig):
    """Frame window [start, end) per signal: the VAD's, or the whole signal
    with ``use_vad=False``."""
    f = cfg.frontend
    n_samples = n_samples.to(torch.int64)
    if cfg.use_vad:
        start, end, _ = tvad.detect_endpoints(signals, f, cfg.vad, n_samples)
        return start, end
    end = torch.clamp(1 + torch.div(n_samples - f.frame_len, f.hop_len,
                                    rounding_mode="floor"), min=0)
    return torch.zeros_like(n_samples), end


def extract_features(signals: torch.Tensor, n_samples: torch.Tensor,
                     cfg: PipelineConfig = PipelineConfig()) -> Features:
    """Padded signal batch [B, max_samples] + true lengths [B] -> Features.

    With ``FrontendConfig.impl="pallas"`` the cepstra come from the fused
    MFCC kernel (plain version for CPU tensors)."""
    c = _cepstra(signals, cfg)
    return _finalize_window(c, *_endpoints(signals, n_samples, cfg), cfg)


def extract_recording_features(signals: torch.Tensor, n_samples: torch.Tensor,
                               cfg: PipelineConfig, t_max: int) -> Features:
    """Padded recordings [B, N] -> whole-recording Features [B, t_max, F].

    One global VAD window (first onset to last offset) per recording, or
    the whole recording with ``use_vad=False``; CMN over that window and
    deltas as always.  ``t_max`` must cover the recording's frame count.
    The cepstra come from the plain MFCC whatever ``FrontendConfig.impl``
    says, as in the JAX package."""
    f = cfg.frontend
    if f.feature_type == "lpcc":
        raise NotImplementedError(
            "feature_type='lpcc' is not ported yet (ROADMAP.md queue 1, "
            "item 14)")
    c = fe.mfcc(signals, f, fe.make_matrices(f, signals.device))
    return _finalize_window(c, *_endpoints(signals, n_samples, cfg), cfg, t_max)


def group_by_padded_len(signals, quantum: int) -> dict:
    """Signal indices grouped by padded length ``ceil(len / quantum) *
    quantum``, shortest first, stable; one batch per group."""
    order = np.argsort([len(np.asarray(s)) for s in signals], kind="stable")
    groups: dict = {}
    for i in order:
        n_len = max(1, len(np.asarray(signals[i])))
        pad_len = quantum * -(-n_len // quantum)
        groups.setdefault(pad_len, []).append(int(i))
    return groups


def extract_signals(signals, cfg: PipelineConfig,
                    device: str | torch.device = "cuda") -> Features:
    """Host list of 1-D signals -> Features on ``device``."""
    x, n = pad_signals(signals, cfg.max_samples, device)
    return extract_features(x, n, cfg)


def dtw_pairs(q_feats: torch.Tensor, q_lens: torch.Tensor,
              bank_feats: torch.Tensor, bank_lens: torch.Tensor,
              dtw_cfg: DtwConfig) -> torch.Tensor:
    """All-pairs DTW distances [B, K], routed to the production impl.

    ``impl="auto"`` takes the DTW kernel for CUDA tensors at every batch
    size, single-utterance ``recognize`` included: the device is the only
    switch.  (The JAX package keeps small batches on its scan; on a CUDA
    card the plain row loop is thousands of tiny launches and loses even
    at one pair, PERF.md section 6.)  The pure band without a warp-scale
    window (``max_warp_scale=None``) has no kernel and runs the scan, as
    do CPU tensors.
    """
    impl = dtw_cfg.impl
    if impl == "auto":
        kernel_takes = (dtw_cfg.band_frac is None
                        or dtw_cfg.max_warp_scale is not None)
        impl = ("fused_banded"
                if q_feats.device.type == "cuda" and kernel_takes else "scan")
    if impl == "fused_banded":
        from dsp_tpu_torch.kernels.dtw_fused_banded import dtw_batch_fused_banded
        return dtw_batch_fused_banded(
            q_feats.contiguous(), q_lens.to(torch.int32).contiguous(),
            bank_feats.contiguous(), bank_lens.to(torch.int32).contiguous(),
            dtw_cfg)
    if impl in ("pallas", "fused"):
        raise NotImplementedError(
            f"DtwConfig.impl={impl!r} is not ported yet (ROADMAP.md queue 1, "
            "item 14: TPU kernels 4 and 5); use impl='auto', 'scan' or "
            "'fused_banded'")
    if impl != "scan":
        raise ValueError(f"unknown DtwConfig.impl {impl!r}")
    return tdtw.dtw_batch(q_feats, q_lens, bank_feats, bank_lens, dtw_cfg)


def classify_features(feats: Features, bank: Features,
                      bank_label_ids: torch.Tensor,
                      n_labels: int | None = None, k: int = 1,
                      cfg: PipelineConfig = PipelineConfig()):
    """Features [B] x template bank [K] -> (label_ids [B], distances [B,K]).

    k=1 is plain nearest-template; k>1 does a kNN majority vote with
    distance-sum tie-breaking."""
    dists = dtw_pairs(feats.feats, feats.length, bank.feats, bank.length,
                      cfg.dtw)
    if k <= 1:
        best_d, best = torch.min(dists, dim=-1)
        ids = bank_label_ids[best]
        # all-dead row (e.g. slope="itakura" with no admissible length
        # ratio) -> sentinel -1, matching vote_topk
        return torch.where(best_d < DEAD, ids, torch.full_like(ids, -1)), dists
    if n_labels is None:
        raise ValueError("n_labels required for k > 1")
    return knn_vote(dists, bank_label_ids, n_labels, k), dists


def knn_vote(dists: torch.Tensor, bank_label_ids: torch.Tensor,
             n_labels: int, k: int) -> torch.Tensor:
    """kNN majority vote over distances [B, K] -> label ids [B].

    The k nearest are taken by a stable sort, so equal distances keep
    bank order as ``lax.top_k`` does.  Ties are broken lexicographically:
    (votes desc, distance-sum asc)."""
    k = min(k, dists.shape[-1])
    top_idx = torch.argsort(dists, dim=-1, stable=True)[:, :k]     # [B, k]
    top_labels = bank_label_ids[top_idx]
    top_d = torch.take_along_dim(dists, top_idx, dim=1)
    return vote_topk(top_d, top_labels, n_labels)


def vote_topk(top_d: torch.Tensor, top_labels: torch.Tensor,
              n_labels: int) -> torch.Tensor:
    """Majority vote over already-selected candidates [B, k] -> ids [B].

    Dead candidates (distance >= 1e20) cast no vote; a row with no live
    candidate returns the sentinel -1."""
    onehot = torch.nn.functional.one_hot(top_labels.to(torch.int64),
                                         n_labels).to(top_d.dtype)  # [B, k, L]
    live = (top_d < DEAD).to(onehot.dtype)[..., None]
    onehot = onehot * live
    votes = onehot.sum(dim=1)                                       # [B, L]
    dist_sum = (onehot * top_d[..., None]).sum(dim=1)               # [B, L]
    tied = votes == votes.max(dim=-1, keepdim=True).values
    ids = torch.argmin(torch.where(tied, dist_sum,
                                   torch.full_like(dist_sum, float("inf"))),
                       dim=-1)
    any_live = (live[..., 0] > 0).any(dim=1)
    return torch.where(any_live, ids, torch.full_like(ids, -1))


def recognize_batch(signals: torch.Tensor, n_samples: torch.Tensor,
                    bank: Features, bank_label_ids: torch.Tensor,
                    cfg: PipelineConfig = PipelineConfig()):
    """Padded signals -> (label_ids [B], distances [B, K]) on their device."""
    feats = extract_features(signals, n_samples, cfg)
    return classify_features(feats, bank, bank_label_ids, cfg=cfg)
