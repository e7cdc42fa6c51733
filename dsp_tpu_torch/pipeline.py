"""Isolated-word pipeline in PyTorch (port of ``dsp_tpu/pipeline.py``).

Padded signals [B, max_samples] -> VAD endpoints -> MFCC + delta/delta-delta
features [B, max_frames, 39] -> all-pairs DTW against the template bank
(routed by ``DtwConfig.impl``: :func:`dtw_pairs`) -> argmin or kNN vote.
Beside it: the linear-time-warp matcher, the LTW-shortlist cascade with a
DTW rerank, length-bucketed classify, and the host readouts (n-best,
edit distance, corpus evaluation).  Everything runs on the device the
signals lie on; the entry points that take host signals put them on the
card unless the caller asks for the CPU, with no probe and no fallback.

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
from dsp_tpu_torch.ops import level_building as lb
from dsp_tpu_torch.ops import lpc
from dsp_tpu_torch.ops import vad as tvad
from dsp_tpu_torch.utils import profiling

# Distances at or above this are dead (unreachable or masked) candidates:
# unreachable pairs arrive normalised (BIG/(la+lb) ~ 2.5e27), every
# genuine distance sits far below it (pipeline.vote_topk in the JAX package).
DEAD = 1e20


class Features(NamedTuple):
    feats: torch.Tensor    # [B, T_max, n_feats]
    length: torch.Tensor   # [B] valid frame count (int32)


def pad_signals(signals, max_samples: int, device: str | torch.device = "cuda"):
    """Host list of 1-D signals -> (padded [B, max_samples] f32, lengths [B] i32).

    Spans ``dsp.pad`` (the fill) and ``dsp.h2d`` (the copies); where
    ``device`` is not the CPU, counts the bytes copied (``h2d_bytes``) and
    the two blocking copies (``host_syncs``)."""
    with profiling.stage("dsp.pad"):
        out = np.zeros((len(signals), max_samples), dtype=np.float32)
        lens = np.zeros(len(signals), dtype=np.int32)
        for i, s in enumerate(signals):
            s = np.asarray(s, dtype=np.float32)[:max_samples]
            out[i, : len(s)] = s
            lens[i] = len(s)
    with profiling.stage("dsp.h2d"):
        x, n = torch.from_numpy(out).to(device), torch.from_numpy(lens).to(device)
        if x.device.type != "cpu":
            profiling.count("h2d_bytes", out.nbytes + lens.nbytes)
            profiling.count("host_syncs", 2)
    return x, n


def _cepstra(signals: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """Padded signals [B, N] -> cepstra [B, T, n_mfcc].

    ``feature_type`` is read before ``impl``: LPCC has no kernel, so
    ``impl="pallas"`` with ``"lpcc"`` computes plain LPCC, as in the JAX
    package."""
    f = cfg.frontend
    if f.feature_type == "lpcc":
        return lpc.lpcc(signals, f)
    if f.impl == "pallas":
        from dsp_tpu_torch.kernels.mfcc_fused import mfcc_fused
        return mfcc_fused(signals, f)
    if f.impl != "xla":
        raise ValueError(f"unknown FrontendConfig.impl {f.impl!r}")
    return fe.mfcc(signals, f, fe.make_matrices(f, signals.device))


def _finalize_window(c: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                     cfg: PipelineConfig, t_max: int | None = None,
                     rows: torch.Tensor | None = None) -> Features:
    """Cepstra [B, T_rec, C] + frame windows [start, end) -> masked Features.

    Gathers ``t_max`` (default ``cfg.max_frames``) frames from each
    ``start`` (window length clamped to [1, t_max]), then applies CMN and
    delta stacking as the JAX package's isolated path does.  ``rows`` [W]
    names the recording of each of W windows (the connected splitter's
    segments); by default window b is recording b's.  The isolated, the
    per-segment and the whole-recording extractors all finish here, so a
    window's features are bit-identical whichever of them cut it.
    """
    f = cfg.frontend
    t_max = cfg.max_frames if t_max is None else t_max
    length = torch.clamp(end - start, min=1, max=t_max)            # [W]
    steps = torch.arange(t_max, device=c.device)
    idx = torch.clamp(start[:, None] + steps, 0, c.shape[1] - 1)   # [W, t_max]
    if rows is None:
        c = torch.take_along_dim(c, idx[..., None], dim=1)
    else:
        c = c[rows[:, None], idx]
    valid = (steps[None, :] < length[:, None])[..., None]          # [W, t_max, 1]
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
    MFCC kernel (plain version for CPU tensors).  Spans ``dsp.frontend``
    around ``dsp.mfcc``, ``dsp.vad`` and ``dsp.deltas``."""
    with profiling.stage("dsp.frontend"):
        with profiling.stage("dsp.mfcc"):
            c = _cepstra(signals, cfg)
        with profiling.stage("dsp.vad"):
            start, end = _endpoints(signals, n_samples, cfg)
        with profiling.stage("dsp.deltas"):
            return _finalize_window(c, start, end, cfg)


def _plain_cepstra(signals: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """Padded recordings [B, N] -> cepstra [B, T, n_mfcc] from the plain
    LPCC or MFCC whatever ``FrontendConfig.impl`` says: the connected-word
    front halves take it, as in the JAX package."""
    f = cfg.frontend
    if f.feature_type == "lpcc":
        return lpc.lpcc(signals, f)
    return fe.mfcc(signals, f, fe.make_matrices(f, signals.device))


def extract_recording_features(signals: torch.Tensor, n_samples: torch.Tensor,
                               cfg: PipelineConfig, t_max: int) -> Features:
    """Padded recordings [B, N] -> whole-recording Features [B, t_max, F].

    One global VAD window (first onset to last offset) per recording, or
    the whole recording with ``use_vad=False``; CMN over that window and
    deltas as always.  ``t_max`` must cover the recording's frame count.
    The cepstra come from the plain MFCC whatever ``FrontendConfig.impl``
    says, as in the JAX package."""
    c = _plain_cepstra(signals, cfg)
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
    """All-pairs DTW distances [B, K], routed by ``dtw_cfg.impl``.

    One line per route (each kernel's wrapper takes CPU tensors to its
    plain PyTorch version):

    - ``"fused_banded"``: the banded DTW kernel (windowed band, unbanded,
      either slope).
    - ``"pallas"``: the masked cost in PyTorch, then the wavefront DP
      kernel; any band, no slope.
    - ``"fused"``: the unbanded closed-form kernel; no band, no slope.
    - ``"scan"``: the plain row scan (``ops/dtw.py``).
    - ``"auto"``: for CUDA tensors, the banded kernel whenever it computes
      the config (every batch size: the device is the only switch), the
      wavefront kernel for the pure band (``max_warp_scale=None``,
      ``slope=None``), and the scan for the pure band with
      ``slope="itakura"``, which no kernel computes; CPU tensors take the
      scan.
    """
    impl = dtw_cfg.impl
    if impl == "auto":
        windowed = (dtw_cfg.band_frac is None
                    or dtw_cfg.max_warp_scale is not None)
        if q_feats.device.type != "cuda":
            impl = "scan"
        elif windowed:
            impl = "fused_banded"
        else:
            impl = "pallas" if dtw_cfg.slope is None else "scan"
    if impl in ("fused_banded", "fused"):
        if impl == "fused":
            from dsp_tpu_torch.kernels.dtw_fused import dtw_batch_fused as run
        else:
            from dsp_tpu_torch.kernels.dtw_fused_banded import (
                dtw_batch_fused_banded as run)
        return run(q_feats.contiguous(), q_lens.to(torch.int32).contiguous(),
                   bank_feats.contiguous(), bank_lens.to(torch.int32).contiguous(),
                   dtw_cfg)
    if impl == "pallas":
        from dsp_tpu_torch.kernels.dtw_pallas import dtw_batch_pallas
        return dtw_batch_pallas(q_feats, q_lens, bank_feats, bank_lens, dtw_cfg)
    if impl != "scan":
        raise ValueError(f"unknown DtwConfig.impl {impl!r}")
    return tdtw.dtw_batch(q_feats, q_lens, bank_feats, bank_lens, dtw_cfg)


def classify_features(feats: Features, bank: Features,
                      bank_label_ids: torch.Tensor,
                      n_labels: int | None = None, k: int = 1,
                      cfg: PipelineConfig = PipelineConfig()):
    """Features [B] x template bank [K] -> (label_ids [B], distances [B,K]).

    k=1 is plain nearest-template; k>1 does a kNN majority vote with
    distance-sum tie-breaking.  Spans ``dsp.dtw`` and ``dsp.argmin``."""
    if k > 1 and n_labels is None:
        raise ValueError("n_labels required for k > 1")
    with profiling.stage("dsp.dtw"):
        dists = dtw_pairs(feats.feats, feats.length, bank.feats, bank.length,
                          cfg.dtw)
    with profiling.stage("dsp.argmin"):
        if k > 1:
            return knn_vote(dists, bank_label_ids, n_labels, k), dists
        best_d, best = torch.min(dists, dim=-1)
        ids = bank_label_ids[best]
        # all-dead row (e.g. slope="itakura" with no admissible length
        # ratio) -> sentinel -1, matching vote_topk
        return torch.where(best_d < DEAD, ids, torch.full_like(ids, -1)), dists


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


def classify_features_ltw(feats: Features, bank: Features,
                          bank_label_ids: torch.Tensor, target_len: int = 64):
    """Linear-time-warp matching: resample queries and templates to
    ``target_len`` frames, then the whole bank comparison is one
    [B, L*F] @ [L*F, K] fp32 product (squared-Euclidean expansion), per
    element.  Returns (label_ids [B], distances [B, K])."""
    q = fe.time_normalize(feats.feats, feats.length, target_len)   # [B, L, F]
    t = fe.time_normalize(bank.feats, bank.length, target_len)     # [K, L, F]
    b, l, f = q.shape
    qf = q.reshape(b, l * f)
    tf = t.reshape(t.shape[0], l * f)
    cross = torch.matmul(qf, tf.T)
    d = ((qf * qf).sum(dim=-1, keepdim=True) + (tf * tf).sum(dim=-1)[None, :]
         - 2.0 * cross) / (l * f)
    d = torch.clamp(d, min=0.0)
    return bank_label_ids[torch.argmin(d, dim=-1)], d


def _smallest(d: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m smallest entries per row, ascending; equal values
    keep column order (``lax.top_k`` of -d)."""
    return torch.argsort(d, dim=-1, stable=True)[:, :m]


def rerank_pairs(feats: Features, bank: Features, cand: torch.Tensor,
                 dtw_cfg: DtwConfig) -> torch.Tensor:
    """DTW of query b against templates ``cand[b]`` [B, M] -> [B, M].

    CUDA tensors with ``slope=None`` take the wavefront kernel's paired
    entry (the JAX package's per-pair scan, same function); the Itakura
    slope and CPU tensors take the paired scan."""
    b, m = cand.shape
    flat = cand.reshape(-1)
    a = feats.feats.repeat_interleave(m, dim=0)
    la = feats.length.repeat_interleave(m, dim=0)
    tb, lb = bank.feats[flat], bank.length[flat]
    if a.device.type == "cuda" and dtw_cfg.slope is None:
        from dsp_tpu_torch.kernels.dtw_pallas import dtw_pairs_pallas
        d = dtw_pairs_pallas(a, tb, la, lb, dtw_cfg)
    else:
        d = tdtw.dtw_pairs_scan(a, la, tb, lb, dtw_cfg)
    return d.reshape(b, m)


def classify_features_cascade(feats: Features, bank: Features,
                              bank_label_ids: torch.Tensor,
                              shortlist: int = 8, k: int = 1,
                              n_labels: int | None = None, target_len: int = 64,
                              cfg: PipelineConfig = PipelineConfig()):
    """Two-stage matcher: the LTW distances shortlist ``shortlist``
    templates per query, then DTW reranks them (:func:`rerank_pairs`).

    Cost scales with B*M instead of B*K, at the price of exactness: a true
    nearest template outside the LTW top-M is lost.  Returns (label_ids
    [B], DTW distances of the shortlist [B, M], candidate indices [B, M])."""
    _, ltw_d = classify_features_ltw(feats, bank, bank_label_ids, target_len)
    m = min(shortlist, bank.feats.shape[0])
    cand = _smallest(ltw_d, m)                                     # [B, M]
    d = rerank_pairs(feats, bank, cand, cfg.dtw)
    cand_labels = bank_label_ids[cand]                             # [B, M]
    if k <= 1:
        best_d, best = torch.min(d, dim=-1)
        ids = torch.take_along_dim(cand_labels, best[:, None], dim=1)[:, 0]
        return torch.where(best_d < DEAD, ids, torch.full_like(ids, -1)), d, cand
    if n_labels is None:
        raise ValueError("n_labels required for k > 1")
    sel = _smallest(d, min(k, m))
    ids = vote_topk(torch.take_along_dim(d, sel, dim=1),
                    torch.take_along_dim(cand_labels, sel, dim=1), n_labels)
    return ids, d, cand


def classify_features_bucketed(feats: Features, bank: Features,
                               bank_label_ids: torch.Tensor,
                               n_labels: int | None = None, k: int = 1,
                               cfg: PipelineConfig = PipelineConfig(),
                               pad_to: int = 64):
    """:func:`classify_features` with host-side length bucketing.

    Queries are grouped into the query-length buckets (t_max, t_max/2,
    t_max/4); each bucket runs :func:`classify_features` on features cut
    to the bucket length, so short utterances pay a smaller DTW.  Rows
    beyond a query's length are never read and the window plan depends on
    max(T, U) = U while the bank's U covers every bucket, so each pair's
    distance equals the unbucketed one.  Bucket batches are padded to
    multiples of ``pad_to`` by repeating their last row.  Returns host
    numpy (label_ids [B] int64, distances [B, K] float32)."""
    t_max = feats.feats.shape[1]
    # the window plan's radius is band_frac * max(t, u): invariant under
    # cutting the query axis only while the bank's U covers t_max
    if bank.feats.shape[1] < t_max:
        raise ValueError(
            f"bucketed classify requires bank U ({bank.feats.shape[1]}) >= "
            f"query t_max ({t_max}); use classify_features instead")
    lens = feats.length.cpu().numpy()
    b = len(lens)
    buckets = sorted({t_max, max(t_max // 2, 1), max(t_max // 4, 1)})
    out_ids = np.zeros(b, np.int64)
    out_d = np.zeros((b, bank.feats.shape[0]), np.float32)
    assigned = np.full(b, t_max, np.int64)
    for tb in buckets:
        assigned = np.where(lens <= tb, np.minimum(assigned, tb), assigned)
    for tb in buckets:
        sel = np.where(assigned == tb)[0]
        if sel.size == 0:
            continue
        bsz = -(-sel.size // pad_to) * pad_to
        idx = torch.from_numpy(np.concatenate(
            [sel, np.full(bsz - sel.size, sel[-1])])).to(feats.feats.device)
        fb = Features(feats.feats[idx, :tb].contiguous(), feats.length[idx])
        lid, d = classify_features(fb, bank, bank_label_ids,
                                   n_labels=n_labels, k=k, cfg=cfg)
        out_ids[sel] = lid.cpu().numpy()[: sel.size]
        out_d[sel] = d.cpu().numpy()[: sel.size]
    return out_ids, out_d


def recognize_batch(signals: torch.Tensor, n_samples: torch.Tensor,
                    bank: Features, bank_label_ids: torch.Tensor,
                    cfg: PipelineConfig = PipelineConfig()):
    """Padded signals -> (label_ids [B], distances [B, K]) on their device."""
    feats = extract_features(signals, n_samples, cfg)
    return classify_features(feats, bank, bank_label_ids, cfg=cfg)


# ---------------------------------------------------------- connected words
def extract_segments_features(signals: torch.Tensor, n_samples: torch.Tensor,
                              cfg: PipelineConfig = PipelineConfig(),
                              max_segments: int = 8):
    """Padded recordings [B, N] -> per-segment Features (connected words).

    The cepstra are computed once over each whole recording (the plain
    MFCC), the multi-segment VAD (``ops/vad.py:detect_segments``) finds up
    to ``max_segments`` utterances, and each segment's frame window is cut
    by :func:`_finalize_window`, so a segment's features are bit-identical
    to the isolated pipeline's for the same window.  ``N`` may exceed
    ``cfg.max_samples``; segments longer than ``cfg.max_frames`` are cut.

    Returns ``(Features [B, S, T, F] / lengths [B, S], starts [B, S], ends
    [B, S], n_segs [B])``; rows past ``n_segs`` hold length-1 dummy
    features (mask with ``n_segs`` downstream).
    """
    c = _plain_cepstra(signals, cfg)
    starts, ends, n_segs = tvad.detect_segments(
        signals, cfg.frontend, cfg.vad, n_samples.to(torch.int64), max_segments)
    b, s = starts.shape
    rows = torch.arange(b, device=c.device).repeat_interleave(s)
    segs = _finalize_window(c, starts.reshape(-1), ends.reshape(-1), cfg,
                            rows=rows)
    return (Features(segs.feats.reshape(b, s, *segs.feats.shape[1:]),
                     segs.length.reshape(b, s)), starts, ends, n_segs)


def _flat(segs: Features) -> Features:
    b, s = segs.length.shape
    return Features(segs.feats.reshape(b * s, *segs.feats.shape[2:]),
                    segs.length.reshape(b * s))


def recognize_connected_batch(signals: torch.Tensor, n_samples: torch.Tensor,
                              bank: Features, bank_label_ids: torch.Tensor,
                              n_labels: int | None = None, k: int = 1,
                              cfg: PipelineConfig = PipelineConfig(),
                              max_segments: int = 8):
    """Padded recordings [B, N] -> per-segment labels (connected words).

    Every segment is classified against the bank in one flat [B*S] batch
    (the isolated path's matcher and kNN vote; kernel 1 on the card), and
    absent segments get label id -1.  Returns ``(label_ids [B, S], n_segs
    [B], starts [B, S], ends [B, S])``."""
    segs, starts, ends, n_segs = extract_segments_features(
        signals, n_samples, cfg, max_segments)
    label_ids, _ = classify_features(_flat(segs), bank, bank_label_ids,
                                     n_labels, k, cfg)
    label_ids = label_ids.reshape(starts.shape)
    live = torch.arange(max_segments, device=starts.device)[None, :] < n_segs[:, None]
    return (torch.where(live, label_ids, torch.full_like(label_ids, -1)),
            n_segs, starts, ends)


def segments_flat(signals, cfg: PipelineConfig = PipelineConfig(),
                  max_segments: int = 8, device: str | torch.device = "cuda"):
    """Host list of connected recordings -> flat per-segment Features.

    The family-independent half of connected-word decoding: pads the
    recordings to a whole multiple of ``cfg.max_samples``, splits each
    into utterances and returns ``(Features [B*S, T, F] on the device,
    n_segs [B], starts [B, S], ends [B, S] as host numpy)``.  Rows past
    ``n_segs`` are length-1 dummies."""
    quantum = cfg.max_samples
    n_max = max(1, max(len(np.asarray(s)) for s in signals))
    x, n = pad_signals(signals, quantum * -(-n_max // quantum), device)
    segs, starts, ends, n_segs = extract_segments_features(x, n, cfg, max_segments)
    return (_flat(segs), n_segs.cpu().numpy(), starts.cpu().numpy(),
            ends.cpu().numpy())


def decode_connected(signals, cfg: PipelineConfig, max_segments: int,
                     score_flat, ids_to_labels,
                     device: str | torch.device = "cuda"):
    """Family-independent connected-word decode over host recordings.

    ``score_flat(Features [B*S]) -> label ids [B*S]`` (a tensor) is the
    family's scorer and ``ids_to_labels(ids [n]) -> [str]`` its label
    map.  Recordings go in chunks of ``256 // max_segments`` (at most ~256
    flat segments a batch, as the isolated classify paths); the trailing
    chunk is padded with repeats of its last recording to the next power
    of two (at most log2(chunk) batch shapes, every result unchanged) and
    trimmed.  Returns ``(label_lists, starts, ends, n_segs)`` as host
    numpy.
    """
    if not len(signals):
        z = np.zeros((0, max_segments), np.int64)
        return [], z, z.copy(), np.zeros((0,), np.int64)
    chunk = max(1, 256 // max_segments)
    outs, sts, ens, nss = [], [], [], []
    for lo in range(0, len(signals), chunk):
        part = list(signals[lo:lo + chunk])
        n_real = len(part)
        size = min(chunk, 1 << max(0, n_real - 1).bit_length())
        part += [part[-1]] * (size - n_real)      # pad, bucketed shapes
        flat, n_segs, starts, ends = segments_flat(part, cfg, max_segments,
                                                   device)
        ids = score_flat(flat).cpu().reshape(len(part), max_segments)
        outs.extend(ids_to_labels(ids[b, : int(n_segs[b])])
                    for b in range(n_real))
        sts.append(starts[:n_real])
        ens.append(ends[:n_real])
        nss.append(n_segs[:n_real])
    return (outs, np.concatenate(sts), np.concatenate(ens),
            np.concatenate(nss))


def decode_connected_level(signals, cfg: PipelineConfig, bank: Features,
                           bank_label_ids, max_levels: int = 8,
                           word_penalty: float = 0.0, grammar_masks=None,
                           mesh=None, device: str | torch.device = "cuda",
                           bank_valid=None):
    """Level-building connected decode over host recordings (gapless ok).

    Word boundaries come out of the joint DP of ``ops/level_building.py``
    against the template bank, not out of an energy detector.
    ``grammar_masks`` (unit-level ``(start [K], pairs [K, K], end [K])``
    bools, ``ops/grammar.py:Grammar.unit_masks``) switch to the
    syntax-constrained DP; the end mask applies in the backtrace.  The
    local cost follows ``cfg.dtw.squared``; ``word_penalty`` is added once
    a word.  Returns ``(label_id_lists, costs)``: per recording the
    decoded templates' label ids (empty when nothing is reachable) and
    the DP cost.

    With ``mesh`` the DP runs bank-sharded over a ('data', 'bank') mesh
    (``parallel/sharding.py:level_build_sharded``, or
    ``level_build_grammar_sharded`` under a grammar); ``bank`` must then be
    padded to the bank axis with ``bank_valid`` marking its real rows, the
    grammar masks (sized to the real bank) are padded False to it, and the
    recordings are padded to the data axis.
    """
    squared = cfg.dtw.squared
    if mesh is not None:
        from dsp_tpu_torch.parallel import sharding as shd
        mesh = shd.as_mesh(mesh)
    if grammar_masks is None:
        def dp_fn(feats):
            if mesh is not None:
                return shd.level_build_sharded(
                    mesh, feats.feats, feats.length, bank.feats, bank.length,
                    bank_valid, max_levels, word_penalty, squared)
            return lb.level_build(feats.feats, feats.length, bank.feats,
                                  bank.length, max_levels, word_penalty, squared)
        return decode_level_generic(signals, cfg, dp_fn, bank_label_ids,
                                    device=device, mesh=mesh)

    start_m, pair_m, end_m = (np.asarray(m, bool) for m in grammar_masks)
    if mesh is not None and bank_valid is not None:
        valid = np.asarray(torch.as_tensor(bank_valid).cpu(), bool)
        grow = valid.shape[0] - start_m.shape[0]
        if grow > 0:                  # pad the masks to the padded bank
            start_m = np.pad(start_m, (0, grow))
            end_m = np.pad(end_m, (0, grow))
            pair_m = np.pad(pair_m, ((0, grow), (0, grow)))
        start_m = start_m & valid
        end_m = end_m & valid
        pair_m = pair_m & np.outer(valid, valid)
    start_t = torch.as_tensor(start_m, device=bank.feats.device)
    pair_t = torch.as_tensor(pair_m, device=bank.feats.device)

    def dp_fn(feats):
        if mesh is not None:
            return shd.level_build_grammar_sharded(
                mesh, feats.feats, feats.length, bank.feats, bank.length,
                bank_valid, start_t, pair_t, max_levels, word_penalty, squared)
        return lb.level_build_grammar(
            feats.feats, feats.length, bank.feats, bank.length, start_t,
            pair_t, max_levels, word_penalty, squared)

    def backtrack_fn(costs, starts, t_valid):
        return lb.backtrack_grammar(costs, starts, pair_m, end_m, t_valid)

    return decode_level_generic(signals, cfg, dp_fn, bank_label_ids,
                                backtrack_fn, device, mesh)


def decode_level_generic(signals, cfg: PipelineConfig, dp_fn, word_ids,
                         backtrack_fn=None, device: str | torch.device = "cuda",
                         mesh=None):
    """The shared loop of the level-style connected decoders.

    Groups recordings by padded length (whole multiples of
    ``cfg.max_samples``), extracts whole-recording features a group, runs
    ``dp_fn(Features)`` (the family's joint DP in the MIN convention of
    ``ops/level_building.py``; HMM callers negate their log-liks, so
    NEG_INF maps onto BIG) and reads each recording's planes back on the
    host with ``backtrack_fn(*planes_row, t_valid) -> (unit ids, cost)``
    (default ``level_building.backtrack`` over ``(costs, words, starts)``
    [L, T]).  ``word_ids`` [W] (a tensor) maps DP word indices to label
    ids.  With ``mesh`` each group is padded to a multiple of the mesh's
    data axis with silent recordings, and every length is clamped to at
    least one sample, as in the JAX package.  Returns
    ``(label_id_lists, costs)``.
    """
    if backtrack_fn is None:
        backtrack_fn = lb.backtrack
    if not len(signals):
        return [], np.zeros((0,), np.float32)
    f = cfg.frontend
    ids_np = word_ids.cpu().numpy()
    results: dict = {}
    for pad_len, idxs in group_by_padded_len(signals, cfg.max_samples).items():
        t_max = max(1, 1 + (pad_len - f.frame_len) // f.hop_len)
        group = [signals[i] for i in idxs]
        if mesh is not None:
            nd = mesh.size(0)
            group += [np.zeros(0, np.float32)] * (-len(group) % nd)
        x, n = pad_signals(group, pad_len, device)
        if mesh is not None:
            n = torch.clamp(n, min=1)
        feats = extract_recording_features(x, n, cfg, t_max)
        planes = [p.cpu().numpy() for p in dp_fn(feats)]
        lens = feats.length.cpu().numpy()
        for row, i in enumerate(idxs):
            seq, cost = backtrack_fn(*(p[row] for p in planes), int(lens[row]))
            results[i] = ([int(ids_np[v]) for v in seq], cost)
    out = [results[i] for i in range(len(signals))]
    return [ids for ids, _ in out], np.asarray([c for _, c in out], np.float32)


# ------------------------------------------------------------ host readouts
def nbest_from_scores(scores, labels, n: int = 3,
                      higher_better: bool = False):
    """Per-row top-n hypotheses: ``[B, n_labels] -> [[(label, score,
    weight)]]`` sorted best-first (host numpy, as the JAX package).

    Scores keep their native orientation (DTW distances: lower better;
    ``higher_better`` for log-likelihoods).  ``weight`` is a softmax over
    the row's z-scored scores: a relative confidence, not a calibrated
    posterior.  Dead entries (|score| >= 1e20) are dropped, so a row may
    carry fewer than ``n`` hypotheses and an all-dead row returns []."""
    scores = np.asarray(scores, np.float64)
    out = []
    for row in scores:
        live = np.abs(row) < DEAD
        k = int(live.sum())
        if k == 0:
            out.append([])
            continue
        s = row[live] if higher_better else -row[live]
        std = s.std()
        z = (s - s.mean()) / (std if std > 0 else 1.0)
        w = np.exp(z - z.max())
        w /= w.sum()
        idx_live = np.flatnonzero(live)
        order = np.argsort(-s, kind="stable")[: min(n, k)]
        out.append([(labels[int(idx_live[j])], float(row[idx_live[j]]),
                     float(w[j])) for j in order])
    return out


def edit_distance(a, b) -> int:
    """Levenshtein distance between two label sequences (host metric)."""
    d = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (x != y))
    return int(d[len(b)])


def evaluate_corpus(classify_batch, corpus: dict) -> dict:
    """{label: [signals]} -> accuracy + per-label confusion counts, with
    ``classify_batch`` the recognizer's list-of-signals -> labels call."""
    sigs, want = [], []
    for lab, xs in corpus.items():
        sigs.extend(xs)
        want.extend([lab] * len(xs))
    got = classify_batch(sigs)
    correct = sum(g == w for g, w in zip(got, want))
    confusion: dict = {}
    for g, w in zip(got, want):
        confusion.setdefault(w, {}).setdefault(g, 0)
        confusion[w][g] += 1
    return {"accuracy": correct / max(len(want), 1),
            "n": len(want), "confusion": confusion}
