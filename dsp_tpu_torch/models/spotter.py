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
route by its [B, K, T, U] cost.

:class:`StreamingSpotter` searches raw audio chunks online: the causal
front-end of ``ops/streaming.py``, the SPRING update of
``ops/spot.py:spot_chunk`` and a best-match hangover
(:class:`_StreamingSpotterBase`).  The HMM and cascade spotters belong to
later slices of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import PipelineConfig
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer, _not_ported
from dsp_tpu_torch.models.streaming import _np_deltas
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops import spot as sp
from dsp_tpu_torch.ops import streaming as st

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


class _StreamingSpotterBase:
    """Shared online-spotting machinery: causal front-end ingestion, delta
    finalization (~40 ms lag), best-match hangover confirmation.

    ``feed(chunk)`` returns the events confirmed by that chunk: an event is
    confirmed once ``hangover`` stream frames pass without an overlapping
    better match (or a new sub-threshold match begins after its end).
    ``flush()`` closes the stream and emits any pending match.  Frame
    indices are global stream frames (the offline grid).

    Subclasses provide the DP: ``_dp_reset()``, ``_dp_step(buf, n) ->
    (scores [K, n], starts [K, n])`` (scores minimised against
    ``self.threshold``: negate a higher-is-better field), ``_row_label``
    and ``_emit_score`` (presentation transform of the emitted score).
    ``min_gap`` widens the post-emit re-open suppression, the streaming
    analog of ``extract_events``' landmark margin.
    """

    min_gap = 0

    def __init__(self, recognizer, chunk_len: int, threshold: float,
                 hangover: int):
        self.rec = recognizer
        self.cfg = recognizer.cfg
        f = self.cfg.frontend
        if f.feature_type != "mfcc":
            raise NotImplementedError(
                f"{type(self).__name__} supports feature_type='mfcc' only")
        if f.cmn:
            raise NotImplementedError(
                "cmn is a whole-stream statistic; train/enroll a "
                "cmn=False model for streaming spotting")
        self.chunk_len = chunk_len
        self.threshold = threshold
        self.hangover = hangover
        self.mats = fe.make_matrices(f, recognizer.device)
        self._w = f.delta_width if f.add_deltas else 0
        self._lag = 2 * self._w
        # fixed DP feed-buffer width: frames a chunk can yield, + slack
        self._buf = max(8, 2 + chunk_len // f.hop_len + self._lag)
        self.reset()

    def reset(self) -> None:
        self.state = st.init_state(self.cfg.frontend, self.chunk_len,
                                   self.rec.device)
        self._dp_reset()
        self._frames: list[np.ndarray] = []   # raw 13-dim MFCC history
        self._offset = 0                      # global index of _frames[0]
        self._fed = 0                         # global frames fed to the DP
        self._pending = None                  # (row, s, e, score)
        self._last_improve = -1
        self._emitted_end = -1                # last confirmed event's end
        self._samples = 0                     # true stream samples fed

    # ------------------------------------------------------------ internals
    def _final_feats(self, upto: int, final: bool) -> np.ndarray:
        """[c, delta, delta-delta] rows for global frames [self._fed, upto);
        each row equals offline add_deltas over the whole stream (edge
        replication can only touch rows within 2w of the stream start,
        where the sliding window clamps identically)."""
        f = self.cfg.frontend
        if upto <= self._fed:
            return np.zeros((0, 0), np.float32)
        lo_ctx = max(0, self._fed - 2 * self._w)
        hi_ctx = upto + (0 if final else self._lag)
        ctx = np.stack(self._frames[lo_ctx - self._offset:
                                    hi_ctx - self._offset]).astype(np.float32)
        if not f.add_deltas:
            return ctx[self._fed - lo_ctx: upto - lo_ctx]
        d1 = _np_deltas(ctx, self._w)
        d2 = _np_deltas(d1, self._w)
        rows = np.concatenate([ctx, d1, d2], axis=1)
        return rows[self._fed - lo_ctx: upto - lo_ctx]

    def _feed_dp(self, rows: np.ndarray):
        """Feed final feature rows to the DP; update the pending match."""
        events = []
        for lo in range(0, len(rows), self._buf):
            part = rows[lo:lo + self._buf]
            buf = np.zeros((self._buf, rows.shape[1]), np.float32)
            buf[:len(part)] = part
            norm, start = self._dp_step(buf, len(part))
            events.extend(self._update_pending(norm[:, :len(part)],
                                               start[:, :len(part)]))
        return events

    def _update_pending(self, norm: np.ndarray, start: np.ndarray):
        """Advance the best-match hangover with a block of per-frame score
        columns beginning at global frame self._fed."""
        events = []
        _, c = norm.shape
        for col in range(c):
            j = self._fed + col
            r = int(np.argmin(norm[:, col]))
            sc = float(norm[r, col])
            if sc < self.threshold:
                s = int(start[r, col])
                if s <= self._emitted_end + self.min_gap:
                    # trailing columns of an already emitted occurrence
                    # stay under the threshold for a while: never re-open
                    # it (extract_events' overlap suppression, widened by
                    # min_gap for landmark scorers)
                    pass
                elif self._pending is None:
                    self._pending = (r, s, j, sc)
                    self._last_improve = j
                elif s > self._pending[2] + self.min_gap:
                    # a new match starts after the pending one ends
                    events.append(self._emit())
                    self._pending = (r, s, j, sc)
                    self._last_improve = j
                elif sc < self._pending[3]:
                    self._pending = (r, s, j, sc)
                    self._last_improve = j
            if (self._pending is not None
                    and j - self._last_improve >= self.hangover):
                events.append(self._emit())
        self._fed += c
        return events

    def _emit(self):
        r, s, e, sc = self._pending
        self._pending = None
        self._emitted_end = e
        return (self._row_label(r), s, e, self._emit_score(sc))

    @staticmethod
    def _emit_score(sc: float) -> float:
        return sc

    def _trim_history(self) -> None:
        # keep the delta context window behind the DP frontier
        keep_from = max(0, self._fed - 2 * self._w - self._offset)
        if keep_from > 2048:
            del self._frames[:keep_from]
            self._offset += keep_from

    def _ingest(self, chunk: np.ndarray):
        """Run the causal front-end on one full chunk; append only the
        frames whose analysis window lies inside the true sample count (a
        no-op mid-stream, where the front-end emits complete frames only;
        on the zero-padded flush tail it drops exactly the frames the
        offline spotter never computes)."""
        f = self.cfg.frontend
        x = torch.as_tensor(np.asarray(chunk, np.float32), device=self.rec.device)
        self.state, out = st.process_chunk(self.state, x, self.mats, f,
                                           self.cfg.vad, self.chunk_len)
        mfcc = out.mfcc.cpu().numpy()[out.frame_valid.cpu().numpy()]
        base_k = self._offset + len(self._frames)
        keep = [i for i in range(len(mfcc))
                if (base_k + i) * f.hop_len + f.frame_len <= self._samples]
        self._frames.extend(mfcc[keep])

    # ------------------------------------------------------------ public
    def feed(self, chunk: np.ndarray):
        """One audio chunk -> list of confirmed spotting events."""
        if len(chunk) != self.chunk_len:
            raise ValueError(f"chunk of {len(chunk)} samples, want {self.chunk_len}")
        self._samples += self.chunk_len
        self._ingest(chunk)
        n_total = self._offset + len(self._frames)
        rows = self._final_feats(max(self._fed, n_total - self._lag),
                                 final=False)
        events = self._feed_dp(rows) if len(rows) else []
        self._trim_history()
        return events

    def flush(self, tail: np.ndarray | None = None):
        """End of stream: process an optional final short chunk (fewer than
        ``chunk_len`` samples, padded here; frames reaching into the padding
        are dropped, so spans and scores match the offline spotter on the
        unpadded signal), feed the lagged DP tail, emit any pending match."""
        if tail is not None and len(tail):
            if len(tail) >= self.chunk_len:
                raise ValueError(f"tail of {len(tail)} samples, want fewer "
                                 f"than {self.chunk_len}")
            self._samples += len(tail)
            buf = np.zeros(self.chunk_len, np.float32)
            buf[: len(tail)] = tail
            self._ingest(buf)
        n_total = self._offset + len(self._frames)
        rows = self._final_feats(n_total, final=True)
        events = self._feed_dp(rows) if len(rows) else []
        if self._pending is not None:
            events.append(self._emit())
        return events


class StreamingSpotter(_StreamingSpotterBase):
    """Online keyword search over raw audio chunks (the SPRING DP) against
    an enrolled template bank; :class:`_StreamingSpotterBase` gives the
    feed/flush/confirmation contract."""

    def __init__(self, recognizer: KnnDtwRecognizer, chunk_len: int = 1600,
                 threshold: float | None = None, hangover: int = 25):
        bank, ids = recognizer.device_bank()
        self._bank = bank
        self._ids = ids.cpu().numpy()
        # the offline spotter's resolution: explicit > bank-stored
        # calibration > fixed default
        thr, self.threshold_source = resolve_spot_threshold(recognizer, threshold)
        super().__init__(recognizer, chunk_len, thr, hangover)

    def _dp_reset(self) -> None:
        k, t = self._bank.feats.shape[0], self._bank.feats.shape[1]
        self.dp = sp.spot_init(k, t, self.rec.device)

    def _dp_step(self, buf: np.ndarray, n_valid: int):
        self.dp, norm, start = sp.spot_chunk(
            self.dp, torch.from_numpy(buf).to(self.rec.device), n_valid,
            self._bank.feats, self._bank.length, squared=self.cfg.dtw.squared)
        return norm.cpu().numpy(), start.cpu().numpy()

    def _row_label(self, r: int) -> str:
        return self.rec.labels[int(self._ids[r])]
