"""Offline keyword spotting over the enrolled template bank (port of
``dsp_tpu/models/spotter.py:KeywordSpotter``).

Every enrolled template is matched against any contiguous span of a long,
unsegmented recording by subsequence DTW (``ops/spot.py``; the CUDA kernel
``csrc/spot_subseq.cu`` on the card), and the spotter reports
``(label, start_frame, end_frame, score)`` events.  VAD is bypassed:
spotting is the segmentation.  Scores are span-normalised DTW distances,
so one threshold serves templates of any length.

Recordings are grouped by padded length (``pipeline.group_by_padded_len``)
and sub-batched: the kernel route by its [B, K, U] outputs, the plain
route by its [B, K, T, U] cost.  The streaming, HMM and cascade spotters
belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import PipelineConfig
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer, _not_ported
from dsp_tpu_torch.ops import spot as sp

# cap on the [B, K, T, U] f32 cost of one plain-route call, and on the
# [B, K, U] outputs of one kernel call (the JAX package's budgets)
_COST_BUDGET_ELEMS = 64 * 1024 * 1024
_OUT_BUDGET_ELEMS = 16 * 1024 * 1024

# the 5-keyword-matrix threshold of the JAX package; decays at vocabulary
# scale, which calibrate_threshold addresses
DEFAULT_SPOT_THRESHOLD = 40.0


def resolve_spot_threshold(recognizer, threshold: float | None):
    """(threshold, source): explicit value > bank-stored calibration >
    fixed default."""
    if threshold is not None:
        return float(threshold), "explicit"
    stored = getattr(recognizer, "spot_threshold", None)
    if stored is not None:
        return float(stored), "bank-calibrated"
    return DEFAULT_SPOT_THRESHOLD, "default"


class KeywordSpotter:
    """Offline keyword search: recordings in, spotting events out.

    ``impl`` is the spotting route of ``ops/spot.py:subseq_dtw_batch``:
    ``"auto"`` (the kernel for a recognizer on the card, the plain route
    on the CPU), ``"fused"`` or ``"scan"``."""

    def __init__(self, recognizer: KnnDtwRecognizer,
                 threshold: float | None = None, impl: str = "auto"):
        if getattr(recognizer, "mesh", None) is not None:
            raise _not_ported("mesh (bank-sharded spotting)", "queue 1, item 15")
        self.rec = recognizer
        self.impl = impl
        self.threshold, self.threshold_source = resolve_spot_threshold(
            recognizer, threshold)
        # spotting consumes the whole recording: no VAD trim
        self.cfg: PipelineConfig = dataclasses.replace(recognizer.cfg,
                                                       use_vad=False)

    def frame_to_seconds(self, frame: int) -> float:
        f = self.cfg.frontend
        return frame * f.hop_len / f.sample_rate

    def _spot(self, streams: torch.Tensor, stream_lens: torch.Tensor):
        bank, _ = self.rec.device_bank()
        return sp.subseq_dtw_batch(streams, stream_lens, bank.feats,
                                   bank.length, squared=self.cfg.dtw.squared,
                                   impl=self.impl)

    def calibrate_threshold(self, genuine_q: float = 0.9,
                            impostor_q: float = 0.02) -> float:
        """Per-bank spotting threshold from enrollment data alone: the
        midpoint of genuine[q=0.9] (best match of a template inside another
        template of the same label) and impostor[q=0.02] (inside a template
        of another label).  Needs >= 2 templates of some label and >= 2
        labels (else ValueError)."""
        bank, ids = self.rec.device_bank()
        ids = ids.cpu().numpy()
        norm, _ = self._spot(bank.feats, bank.length)
        best = norm.amin(dim=2).cpu().numpy()           # [K_stream, K_bank]
        same = ids[:, None] == ids[None, :]
        eye = np.eye(len(ids), dtype=bool)
        genuine = best[same & ~eye]
        impostor = best[~same]
        if not len(genuine):
            raise ValueError("calibrate_threshold needs >= 2 templates "
                             "of some label (no genuine pairs in bank)")
        if not len(impostor):
            raise ValueError("calibrate_threshold needs >= 2 labels "
                             "(no impostor pairs in bank)")
        return float((np.quantile(genuine, genuine_q)
                      + np.quantile(impostor, impostor_q)) / 2.0)

    def scores(self, signals):
        """Per-recording score fields: list of (norm [K, T_i], start
        [K, T_i]) numpy arrays (T_i = the recording's frame count)."""
        if not len(signals):
            return []
        bank, _ = self.rec.device_bank()
        k, u_t = bank.feats.shape[0], bank.feats.shape[1]
        f = self.cfg.frontend
        dev = self.rec.device
        kernel = self.impl != "scan" and sp.production_impl(dev) == "fused"
        results: dict = {}
        for pad_len, idxs in pl.group_by_padded_len(signals,
                                                    self.cfg.max_samples).items():
            t_max = max(1, 1 + (pad_len - f.frame_len) // f.hop_len)
            if kernel:
                sub = max(1, _OUT_BUDGET_ELEMS // (k * t_max))
            else:
                sub = max(1, _COST_BUDGET_ELEMS // (k * u_t * t_max))
            for lo in range(0, len(idxs), sub):
                part = idxs[lo:lo + sub]
                x, n = pl.pad_signals([signals[i] for i in part], pad_len, dev)
                feats = pl.extract_recording_features(x, n, self.cfg, t_max)
                norm, start = self._spot(feats.feats, feats.length)
                norm, start = norm.cpu().numpy(), start.cpu().numpy()
                lens = feats.length.cpu().numpy()
                for row, i in enumerate(part):
                    t_i = int(lens[row])
                    results[i] = (norm[row, :, :t_i], start[row, :, :t_i])
        return [results[i] for i in range(len(signals))]

    def spot(self, signals, threshold: float | None = None):
        """Recordings -> per-recording [(label, start_frame, end_frame,
        score)] event lists (label strings, frames on the offline grid,
        span-normalised scores)."""
        thr = self.threshold if threshold is None else threshold
        ids = self.rec.device_bank()[1].cpu().numpy()
        out = []
        for norm, start in self.scores(signals):
            evs = sp.extract_events(norm, start, thr, labels=ids)
            out.append([(self.rec.labels[lbl], s, e, sc)
                        for lbl, s, e, sc in evs])
        return out
