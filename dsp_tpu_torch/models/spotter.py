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
(:class:`_StreamingSpotterBase`).

The GMM-HMM family spots through :class:`HmmSpotter` (the keyword/filler
Viterbi of ``ops/spot_hmm.py`` against the recognizer's UBM) and its online
form :class:`StreamingHmmSpotter`.  :class:`CascadeSpotter` takes the HMM
spotter's landmarks as candidates and reranks each widened window against
the template bank by subsequence DTW (``ops/spot.py:rerank_windows``, kernel
3 on the card); :class:`StreamingCascadeSpotter` is its online form.
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
from dsp_tpu_torch.ops.spot_hmm import spot_hmm_batch, spot_hmm_chunk, spot_hmm_init

# cap on the [B, K, T, U] f32 cost of one plain-route call, and on the
# [B, K, U] outputs of one kernel call (the JAX package's budgets)
_COST_BUDGET_ELEMS = 64 * 1024 * 1024
_OUT_BUDGET_ELEMS = 16 * 1024 * 1024


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p

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


def _require_filler(recognizer) -> None:
    if recognizer.params is None:
        raise ValueError("recognizer not fitted")
    if getattr(recognizer, "ubm", None) is None:
        raise ValueError("recognizer has no UBM filler model: fit() stores one "
                         "(batched mode, the default); fit again or load a "
                         "checkpoint that holds one")


class StreamingHmmSpotter(_StreamingSpotterBase):
    """Online HMM keyword/filler spotting: the frame-synchronous column
    update of ``ops/spot_hmm.py:spot_hmm_chunk`` under the
    :class:`_StreamingSpotterBase` contract.  The update carries the [W, S]
    Viterbi front and, per path, the UBM prefix at its entry frame (the
    streaming replacement for the offline readout's prefix lookup).  It is
    invariant to chunk boundaries; witnesses equal the offline spotter's
    and LLRs agree to emission-GEMM rounding.

    ``threshold`` is the per-frame LLR floor (> 0 beats the filler), in
    :class:`HmmSpotter`'s units; the confirmation logic minimises -LLR
    inside.  ``min_gap`` widens the post-emit suppression as the offline
    landmark extractor's margin does.  Needs a fitted recognizer with its
    UBM (``fit`` stores one)."""

    def __init__(self, recognizer, chunk_len: int = 1600,
                 threshold: float = 0.0, hangover: int = 25,
                 min_gap: int = 45):
        _require_filler(recognizer)
        self._params = recognizer.params
        self._ubm = recognizer.ubm
        self.min_gap = min_gap
        super().__init__(recognizer, chunk_len, -threshold, hangover)

    def _dp_reset(self) -> None:
        w, s = self._params.log_pi.shape
        self.dp = spot_hmm_init(w, s, self.rec.device)

    def _dp_step(self, buf: np.ndarray, n_valid: int):
        self.dp, llr, start = spot_hmm_chunk(
            self.dp, torch.from_numpy(buf).to(self.rec.device), n_valid,
            self._params, self._ubm)
        return -llr.cpu().numpy(), start.cpu().numpy()

    def _row_label(self, r: int) -> str:
        return self.rec.labels[r]

    @staticmethod
    def _emit_score(sc: float) -> float:
        return -sc          # back to LLR units (higher is better)


def _check_frame_grid(hmm_recognizer, bank_recognizer) -> None:
    fh, fb = hmm_recognizer.cfg.frontend, bank_recognizer.cfg.frontend
    if (fh.sample_rate, fh.frame_len, fh.hop_len) != \
            (fb.sample_rate, fb.frame_len, fb.hop_len):
        raise ValueError(
            "cascade stages must share a frame grid: hmm "
            f"(sr={fh.sample_rate}, frame={fh.frame_len}, "
            f"hop={fh.hop_len}) vs bank (sr={fb.sample_rate}, "
            f"frame={fb.frame_len}, hop={fb.hop_len})")
    if torch.device(hmm_recognizer.device) != torch.device(bank_recognizer.device):
        raise ValueError("cascade stages must share a device: hmm on "
                         f"{hmm_recognizer.device}, bank on {bank_recognizer.device}")


def _rerank(wins, bank, squared: bool, n_rows: int):
    """Stage 2 over host windows [(mid, rows [n, F])]: one padded
    ``rerank_windows`` call a part of ``n_rows`` windows, each window
    padded to a multiple of 32 frames.  Returns numpy (row, end, start,
    score) per window."""
    w_pad = -(-max(len(w) for _, w in wins) // 32) * 32
    dev = bank.feats.device
    outs = []
    for base in range(0, len(wins), n_rows):
        part = wins[base:base + n_rows]
        x = np.zeros((n_rows, w_pad, part[0][1].shape[1]), np.float32)
        lens = np.ones((n_rows,), np.int32)
        mids = np.zeros((n_rows,), np.float32)
        for n, (mid, w) in enumerate(part):
            x[n, :len(w)] = w
            lens[n] = len(w)
            mids[n] = mid
        # the rescore must contain the landmark midpoint: the window also
        # covers neighbouring words, and an unconstrained argmin would
        # elect a stronger neighbour, collapsing two occurrences into one
        # after suppression
        got = sp.rerank_windows(torch.from_numpy(x).to(dev), torch.from_numpy(lens).to(dev),
                                torch.from_numpy(mids).to(dev), bank.feats, bank.length,
                                squared=squared)
        outs.append([a.cpu().numpy()[:len(part)] for a in got])
    return [np.concatenate(a) for a in zip(*outs)]


class CascadeSpotter:
    """Two-stage keyword spotting: HMM landmark scan, then an exact DTW
    rerank.

    * **Stage 1, candidates** (:class:`HmmSpotter` at a permissive LLR
      floor): O(W·S) max-plus work a frame against the full-bank
      subsequence DTW's O(K·U) cells.  Its labels are ignored: only the
      landmark spans matter, so its cross-keyword confusions do not.
    * **Stage 2, exact rerank**: each candidate span, widened by the
      bank's longest template plus ``margin`` frames on each side, is cut
      from the stream's features and matched against the whole bank by
      subsequence DTW (``ops/spot.py:rerank_windows``, kernel 3 on the
      card), the windows padded to a multiple of 32 frames and batched at
      a power-of-two row count.  The best (template, end column) that
      contains the landmark's midpoint relabels the candidate;
      ``threshold`` is :class:`KeywordSpotter`'s span-normalised DTW
      floor, so calibrations transfer.

    Duplicate landmarks inside one occurrence rescore to overlapping DTW
    spans and are suppressed best score first, which lets stage 1 run at
    a smaller ``min_gap`` (``cand_min_gap``, 25) than the standalone HMM
    spotter's 45.  Both recognizers must share a frame grid and a device;
    feature configs may differ (each stage extracts its own).  Enroll a
    ``cmn=False`` bank, as for :class:`KeywordSpotter`."""

    def __init__(self, hmm_recognizer, bank_recognizer,
                 threshold: float | None = None,
                 hmm_threshold: float = -45.0,
                 margin: int = 12, cand_min_gap: int = 25):
        _check_frame_grid(hmm_recognizer, bank_recognizer)
        self.stage1 = HmmSpotter(hmm_recognizer, threshold=hmm_threshold,
                                 min_gap=cand_min_gap)
        self.rec = bank_recognizer
        self.threshold, self.threshold_source = resolve_spot_threshold(
            bank_recognizer, threshold)
        self.hmm_threshold = hmm_threshold
        self.margin = margin
        self.cfg = dataclasses.replace(bank_recognizer.cfg, use_vad=False)

    def frame_to_seconds(self, frame: int) -> float:
        f = self.cfg.frontend
        return frame * f.hop_len / f.sample_rate

    def rescored(self, signals):
        """Stage-1 candidates rescored by the bank: per-stream lists of
        ``(label, start_frame, end_frame, dtw_score)``, unfiltered and
        unsuppressed (every candidate window yields its best bank match),
        so a caller can sweep ``threshold`` without running either stage
        again.  One front-end pass feeds both stages when their front-end
        configs match."""
        out = [[] for _ in signals]
        for i, ev in self._rescore(*self._candidates(signals)):
            out[i].append(ev)
        return out

    def _candidates(self, signals):
        """Features, the stage-1 scan, its events and their widened windows:
        ([(mid, rows [n, F])], [(stream, lo)]) on the host."""
        wins, owners = [], []            # (mid, rows), (stream, lo)
        if not len(signals):
            return wins, owners
        params, ubm = self.stage1.rec._scoring_models(signals)
        same_fe = self.stage1.cfg.frontend == self.cfg.frontend
        f = self.cfg.frontend
        # a landmark is a few frames at a word's high-contrast core, so the
        # whole occurrence can start up to about one template length before
        # it and end as far after: extend by the longest template + margin
        ext = int(self.rec.device_bank()[0].length.max()) + self.margin
        for pad_len, idxs in pl.group_by_padded_len(signals, self.cfg.max_samples).items():
            t_max = max(1, 1 + (pad_len - f.frame_len) // f.hop_len)
            x, n = pl.pad_signals([signals[i] for i in idxs], pad_len, self.rec.device)
            feats = pl.extract_recording_features(x, n, self.cfg, t_max)
            s1 = feats if same_fe else pl.extract_recording_features(
                x, n, self.stage1.cfg, t_max)
            llr, start = spot_hmm_batch(s1.feats, s1.length, params, ubm)
            llr, start = llr.cpu().numpy(), start.cpu().numpy()
            fh, lens = feats.feats.cpu().numpy(), feats.length.cpu().numpy()
            for row, i in enumerate(idxs):
                t_i = int(lens[row])
                evs = sp.extract_events(-llr[row, :, :t_i], start[row, :, :t_i],
                                        -self.hmm_threshold,
                                        min_gap=self.stage1.min_gap)
                for _r, s, e, _neg in evs:
                    lo = max(0, s - ext)
                    hi = min(t_i, e + 1 + ext)
                    if hi - lo >= 2:
                        wins.append(((s + e) / 2.0 - lo, fh[row, lo:hi]))
                        owners.append((i, lo))
        return wins, owners

    def _rescore(self, wins, owners):
        """Stage 2 over :meth:`_candidates`' windows: (stream, event) pairs,
        one a window that has a bank match containing its midpoint."""
        if not wins:
            return []
        bank, ids = self.rec.device_bank()
        ids = ids.cpu().numpy()
        w_pad = -(-max(len(w) for _, w in wins) // 32) * 32
        k, u_t = bank.feats.shape[0], bank.feats.shape[1]
        if sp.production_impl(self.rec.device) == "fused":
            # the kernel keeps no cost intermediate: its [N, K, W] outputs
            # bound the batch
            sub = max(1, _OUT_BUDGET_ELEMS // (k * w_pad))
        else:
            # the plain route's [n, K, T, W] cost; 8x the stream budget,
            # since windows are short
            sub = max(1, 8 * _COST_BUDGET_ELEMS // (k * u_t * w_pad))
        # one padded row count: full parts share a shape, the tail pads up
        n_rows = min(sub, _next_pow2(max(8, len(wins))))
        r, j, s, score = _rerank(wins, bank, self.cfg.dtw.squared, n_rows)
        return [(i, (self.rec.labels[int(ids[r[n]])], lo + int(s[n]), lo + int(j[n]),
                     float(score[n])))
                for n, (i, lo) in enumerate(owners) if score[n] < 0.5 * sp.BIG]

    @staticmethod
    def suppress(events):
        """Greedy best-score-first overlap suppression (the rescored spans
        are whole-word DTW spans, so plain overlap is the criterion)."""
        kept = []
        for lab, s, e, sc in sorted(events, key=lambda ev: ev[3]):
            if all(e < ks or s > ke for _, ks, ke, _ in kept):
                kept.append((lab, s, e, sc))
        kept.sort(key=lambda ev: ev[1])
        return kept

    def spot(self, signals, threshold: float | None = None):
        """Recordings -> [(label, start_frame, end_frame, score)] lists (DTW
        span-normalised scores, :class:`KeywordSpotter`'s units)."""
        thr = self.threshold if threshold is None else threshold
        return [self.suppress([ev for ev in evs if ev[3] < thr])
                for evs in self.rescored(signals)]


class _CausalFeatureStream:
    """The front-end half of :class:`_StreamingSpotterBase` with no DP: a
    causal raw-cepstra history and windows cut on demand, so that the
    streaming cascade reranks windows equal row for row to the offline
    whole-recording features.

    A [c, delta, delta-delta] row needs 2 * delta_width raw frames of
    context on each side, so the rows of ``window(lo, hi)`` are final once
    ``hi + 2w`` raw frames exist, or once the stream has ended (edge
    replication at the true last frame, as offline)."""

    def __init__(self, cfg, chunk_len: int, device):
        self.cfg, self.chunk_len, self.device = cfg, chunk_len, device
        f = cfg.frontend
        self.mats = fe.make_matrices(f, device)
        self._w = f.delta_width if f.add_deltas else 0
        self.lag = 2 * self._w
        self.reset()

    def reset(self) -> None:
        self.state = st.init_state(self.cfg.frontend, self.chunk_len, self.device)
        self._frames: list[np.ndarray] = []
        self._samples = 0

    def ingest(self, chunk: np.ndarray, true_samples: int) -> None:
        """One full chunk (zero-padded at flush; ``true_samples`` is the
        unpadded count it advances the stream by)."""
        f = self.cfg.frontend
        self._samples += true_samples
        x = torch.as_tensor(np.asarray(chunk, np.float32), device=self.device)
        self.state, out = st.process_chunk(self.state, x, self.mats, f,
                                           self.cfg.vad, self.chunk_len)
        mfcc = out.mfcc.cpu().numpy()[out.frame_valid.cpu().numpy()]
        base = len(self._frames)
        keep = [i for i in range(len(mfcc))
                if (base + i) * f.hop_len + f.frame_len <= self._samples]
        self._frames.extend(mfcc[keep])

    @property
    def n_frames(self) -> int:
        return len(self._frames)

    def ready(self, hi: int, final: bool) -> bool:
        """Are rows [.., hi) of ``window`` final yet?"""
        return (hi + self.lag <= len(self._frames)) or \
            (final and hi <= len(self._frames))

    def window(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the offline features over the whole stream."""
        c_lo = max(0, lo - self.lag)
        c_hi = min(hi + self.lag, len(self._frames))
        ctx = np.stack(self._frames[c_lo:c_hi]).astype(np.float32)
        if self._w == 0:
            return ctx[lo - c_lo: hi - c_lo]
        d1 = _np_deltas(ctx, self._w)
        d2 = _np_deltas(d1, self._w)
        rows = np.concatenate([ctx, d1, d2], axis=1)
        return rows[lo - c_lo: hi - c_lo]


class StreamingCascadeSpotter:
    """Online two-stage spotting: :class:`StreamingHmmSpotter` landmarks
    confirm online, and each confirmed candidate reranks against the
    template bank (the constrained argmin of :class:`CascadeSpotter`) as
    soon as its widened window's rows are final, so rescored whole-word
    events emit with bounded lag:

        lag <= stage-1 hangover + (longest template + margin) + 2w frames.

    Offline and streaming agree on gap-separated keywords: stage 1's DP is
    invariant to chunk boundaries, the rerank windows are the offline rows
    (:class:`_CausalFeatureStream`), and the emission queue applies the
    same greedy best-score-first overlap suppression locally (a pending
    event emits once a later candidate starts after its end).

    A candidate is ready on its whole window's end while the stream runs;
    only at the end of the stream is that end clamped to the frames
    received.  (The JAX package clamps it while the stream runs, so at
    ``add_deltas=False`` it reranks windows cut short and parts from its
    offline cascade.)

    :class:`CascadeSpotter`'s envelope plus the streaming base's: a shared
    frame grid and device, ``feature_type='mfcc'``, a ``cmn=False`` bank."""

    def __init__(self, hmm_recognizer, bank_recognizer,
                 chunk_len: int = 1600, threshold: float | None = None,
                 hmm_threshold: float = -45.0, margin: int = 12,
                 cand_min_gap: int = 25, hangover: int = 25):
        _check_frame_grid(hmm_recognizer, bank_recognizer)
        if bank_recognizer.cfg.frontend.cmn:
            raise NotImplementedError(
                "cmn is a whole-stream statistic; enroll a cmn=False "
                "bank for streaming cascade spotting")
        self.rec = bank_recognizer
        self.cfg = dataclasses.replace(bank_recognizer.cfg, use_vad=False)
        self.threshold, self.threshold_source = resolve_spot_threshold(
            bank_recognizer, threshold)
        self.margin = margin
        self.chunk_len = chunk_len
        self.stage1 = StreamingHmmSpotter(
            hmm_recognizer, chunk_len, threshold=hmm_threshold,
            hangover=hangover, min_gap=cand_min_gap)
        bank, ids = bank_recognizer.device_bank()
        self._bank, self._ids = bank, ids.cpu().numpy()
        self._ext = int(bank.length.max()) + margin
        self._feats = _CausalFeatureStream(self.cfg, chunk_len, bank_recognizer.device)
        self.reset()

    def reset(self) -> None:
        self.stage1.reset()
        self._feats.reset()
        self._cands: list[tuple[int, float, int]] = []   # (lo, mid, hi)
        self._pend_out = None          # rescored event awaiting suppression

    def frame_to_seconds(self, frame: int) -> float:
        f = self.cfg.frontend
        return frame * f.hop_len / f.sample_rate

    # ------------------------------------------------------------ internals
    def _rerank_ready(self, final: bool):
        """Rerank every queued candidate whose window rows are final;
        returns rescored (label, s, e, score) events under the threshold."""
        n_frames = self._feats.n_frames
        # ready on the window's whole end; clamped only once the stream has
        # ended, so no window is reranked cut short
        ready = [c for c in self._cands
                 if self._feats.ready(min(c[2], n_frames) if final else c[2], final)]
        if not ready:
            return []
        self._cands = [c for c in self._cands if c not in ready]
        wins, los = [], []
        for lo, mid, hi in ready:
            hi = min(hi, n_frames)
            if hi - lo >= 2:
                wins.append((mid, self._feats.window(lo, hi)))
                los.append(lo)
        if not wins:
            return []
        r, j, s, score = _rerank(wins, self._bank, self.cfg.dtw.squared,
                                 _next_pow2(max(8, len(wins))))
        out = []
        for n, lo in enumerate(los):
            if score[n] < min(self.threshold, 0.5 * sp.BIG):
                out.append((self.rec.labels[int(self._ids[r[n]])],
                            lo + int(s[n]), lo + int(j[n]), float(score[n])))
        return out

    def _suppressed(self, rescored, final: bool):
        """Greedy suppression without retraction: a pending event emits once
        a later candidate starts after its end; an overlapping better one
        replaces it (:meth:`CascadeSpotter.suppress` for gap-separated
        keywords)."""
        events = []
        for ev in sorted(rescored, key=lambda e: e[1]):
            if self._pend_out is None:
                self._pend_out = ev
            elif ev[1] > self._pend_out[2]:
                events.append(self._pend_out)
                self._pend_out = ev
            elif ev[3] < self._pend_out[3]:
                self._pend_out = ev
        if final and self._pend_out is not None:
            events.append(self._pend_out)
            self._pend_out = None
        return events

    def _emit_horizon(self):
        """Bounded-lag release of the pending event: once the stage-1
        frontier is a whole window extension + suppression gap past its
        end, no candidate is queued, and stage 1 holds no pending match
        that could rerank back into it, no later overlapping rescore can
        arise for gap-separated keywords, so emit now instead of at the
        next keyword or the flush."""
        if self._pend_out is None or self._cands:
            return []
        horizon = self._ext + self.stage1.min_gap + self.stage1.hangover
        s1p = self.stage1._pending
        if (self.stage1._fed - self._pend_out[2] > horizon
                and (s1p is None or s1p[1] - self._ext > self._pend_out[2])):
            ev, self._pend_out = self._pend_out, None
            return [ev]
        return []

    def _advance(self, s1_events, final: bool):
        for _lab, s, e, _llr in s1_events:
            lo = max(0, s - self._ext)
            self._cands.append((lo, (s + e) / 2.0 - lo, e + 1 + self._ext))
        events = self._suppressed(self._rerank_ready(final), final)
        if not final:
            events.extend(self._emit_horizon())
        return events

    # ------------------------------------------------------------ public
    def feed(self, chunk: np.ndarray):
        """One audio chunk -> confirmed rescored events ``(label,
        start_frame, end_frame, dtw_score)``."""
        if len(chunk) != self.chunk_len:
            raise ValueError(f"chunk of {len(chunk)} samples, want {self.chunk_len}")
        self._feats.ingest(chunk, len(chunk))
        return self._advance(self.stage1.feed(chunk), final=False)

    def flush(self, tail: np.ndarray | None = None):
        """End of stream (an optional short last chunk): close stage 1,
        rerank every remaining candidate, emit everything pending."""
        if tail is not None and len(tail):
            if len(tail) >= self.chunk_len:
                raise ValueError(f"tail of {len(tail)} samples, want fewer "
                                 f"than {self.chunk_len}")
            buf = np.zeros(self.chunk_len, np.float32)
            buf[: len(tail)] = tail
            self._feats.ingest(buf, len(tail))
        return self._advance(self.stage1.flush(tail), final=True)


class HmmSpotter:
    """HMM keyword spotting: open-endpoint Viterbi against the UBM filler.

    Each trained word HMM may enter at any stream frame and exit at any
    later frame; spans score by the per-frame Viterbi log-likelihood ratio
    against the recognizer's universal background GMM
    (``ops/spot_hmm.py``), so a fitted :class:`GmmHmmRecognizer` (which
    stores its UBM) spots keywords with no extra training.  With the
    recognizer's ``noise_adapt`` on, the word HMMs and the filler are
    PMC-adapted together to the streams' noise floor.

    ``threshold`` is the per-frame LLR floor: > 0 means the word HMM
    explains the span better than the background model.  ``min_gap``
    (frames) widens the landmark suppression: the LLR peaks on a word's
    core, so a second landmark inside one occurrence may not literally
    overlap the first (45 is the JAX package's best F1 on its spotting
    matrix)."""

    def __init__(self, recognizer, threshold: float = 0.0,
                 min_gap: int = 45):
        _require_filler(recognizer)
        self.rec = recognizer
        self.threshold = threshold
        self.min_gap = min_gap
        self.cfg = dataclasses.replace(recognizer.cfg, use_vad=False)

    def scores(self, signals):
        """Per-recording (llr [W, T_i], start [W, T_i]) numpy fields."""
        if not len(signals):
            return []
        params, ubm = self.rec._scoring_models(signals)
        f = self.cfg.frontend
        results: dict = {}
        for pad_len, idxs in pl.group_by_padded_len(signals, self.cfg.max_samples).items():
            t_max = max(1, 1 + (pad_len - f.frame_len) // f.hop_len)
            x, n = pl.pad_signals([signals[i] for i in idxs], pad_len, self.rec.device)
            feats = pl.extract_recording_features(x, n, self.cfg, t_max)
            llr, start = spot_hmm_batch(feats.feats, feats.length, params, ubm)
            llr, start = llr.cpu().numpy(), start.cpu().numpy()
            lens = feats.length.cpu().numpy()
            for row, i in enumerate(idxs):
                t_i = int(lens[row])
                results[i] = (llr[row, :, :t_i], start[row, :, :t_i])
        return [results[i] for i in range(len(signals))]

    def spot(self, signals, threshold: float | None = None):
        """Recordings -> [(label, start_frame, end_frame, llr)] lists."""
        thr = self.threshold if threshold is None else threshold
        out = []
        for llr, start in self.scores(signals):
            # extract_events minimises: negate the LLR field
            evs = sp.extract_events(-llr, start, -thr, min_gap=self.min_gap)
            out.append([(self.rec.labels[r], s, e, -neg) for r, s, e, neg in evs])
        return out
