"""Online recognizer: streaming front-end + template matching (port of
``dsp_tpu/models/streaming.py``).

The live-demo loop: chunks of audio -> causal endpoint detection -> on an
utterance end, classify its frames with the offline recognizer's matcher.
The host moves chunks and collects events; the front-end and VAD run in
``ops/streaming.py:process_chunk`` on the recognizer's device, and each
closed utterance is classified there as the offline recognizer classifies
(kernel 1, ``csrc/dtw_banded.cu``, on the card).
:class:`StreamingConnectedRecognizer` decodes gapless multi-word
utterances online instead, through streaming level building (plain
PyTorch on the device, no kernel of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import PipelineConfig
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops import level_building as lb
from dsp_tpu_torch.ops import streaming as st


class StreamingRecognizer:
    """Feed audio chunks, get (label, start_frame, end_frame) events."""

    def __init__(self, recognizer: KnnDtwRecognizer, chunk_len: int = 1600,
                 history_frames: int | None = None):
        self.rec = recognizer
        self.cfg: PipelineConfig = recognizer.cfg
        if self.cfg.frontend.feature_type != "mfcc":
            # the streaming front-end computes MFCC only; matching LPCC
            # bank templates against MFCC queries would silently collapse
            raise NotImplementedError(
                "StreamingRecognizer supports feature_type='mfcc' only "
                f"(got {self.cfg.frontend.feature_type!r})")
        self.chunk_len = chunk_len
        self.mats = fe.make_matrices(self.cfg.frontend, recognizer.device)
        # keep enough history for the longest classifiable utterance plus
        # VAD hangover; bounds host memory on long-running streams
        self.history_frames = history_frames or 4 * self.cfg.max_frames
        self.reset()

    def reset(self) -> None:
        self.state = st.init_state(self.cfg.frontend, self.chunk_len,
                                   self.rec.device)
        self._frames: list[np.ndarray] = []   # recent MFCC frames, host side
        self._offset = 0                      # global index of _frames[0]

    def _trim_history(self) -> None:
        extra = len(self._frames) - self.history_frames
        if extra > 0:
            del self._frames[:extra]
            self._offset += extra

    def feed(self, chunk: np.ndarray):
        """One chunk [chunk_len] -> list of recognized utterance events."""
        if len(chunk) != self.chunk_len:
            raise ValueError(f"chunk of {len(chunk)} samples, want {self.chunk_len}")
        x = torch.as_tensor(np.asarray(chunk, np.float32), device=self.rec.device)
        self.state, out = st.process_chunk(self.state, x, self.mats,
                                           self.cfg.frontend, self.cfg.vad,
                                           self.chunk_len)
        # the one read-back a chunk
        mfcc, valid, ends, starts, stops = (
            a.cpu().numpy() for a in (out.mfcc, out.frame_valid, out.utt_end,
                                      out.utt_start_idx, out.utt_end_idx))
        self._frames.extend(mfcc[valid])

        events = []
        min_frames = self.cfg.vad.min_utterance_frames
        for t in np.nonzero(ends)[0]:
            start = int(starts[t])
            end = min(int(stops[t]), self._offset + len(self._frames))
            if end - start >= min_frames:
                ev = self._classify(start, end)
                if ev is not None:
                    events.append(ev)
        self._trim_history()
        return events

    def _classify(self, start: int, end: int):
        # global frame indices -> positions in the trimmed history window
        lo = max(start - self._offset, 0)
        hi = max(end - self._offset, lo)
        if hi <= lo:
            # the utterance fell behind the trimmed history window
            # (history_frames < the VAD's silence + hangover horizon):
            # nothing to classify, and callers drop the None event
            return None
        seg = np.stack(self._frames[lo:hi])                   # [T', n_mfcc]
        f = self.cfg.frontend
        t_max = self.cfg.max_frames
        padded = np.zeros((t_max, seg.shape[1]), dtype=np.float32)
        padded[: len(seg)] = seg[:t_max]
        n_valid = min(len(seg), t_max)
        if f.cmn:
            # as pipeline._finalize_window, so streamed queries live in the
            # feature space of the CMN-normalised bank
            valid = (np.arange(t_max) < n_valid)[:, None]
            if f.cmn_mode == "causal":
                padded[:n_valid] = fe.causal_cmn(
                    torch.from_numpy(padded[:n_valid]), f.cmn_alpha).numpy()
                padded = np.where(valid, padded, 0.0).astype(np.float32)
            else:
                mean = (padded * valid).sum(0, keepdims=True) / max(n_valid, 1)
                padded = np.where(valid, padded - mean, 0.0).astype(np.float32)
        dev = self.rec.device
        length = torch.tensor([n_valid], dtype=torch.int32, device=dev)
        feats = fe.add_deltas(torch.from_numpy(padded)[None].to(dev), f, length)
        keep = (torch.arange(t_max, device=dev) < n_valid)[None, :, None]
        query = pl.Features(torch.where(keep, feats, 0.0), length)
        bank, ids = self.rec.device_bank()
        # the offline recognizer's matcher routing and kNN vote, so a
        # streamed utterance and classify_batch of the same frames agree
        r = self.rec
        if r.matcher == "ltw":
            label_ids, _ = pl.classify_features_ltw(query, bank, ids, r.ltw_len)
        elif r.matcher == "cascade":
            label_ids, _, _ = pl.classify_features_cascade(
                query, bank, ids, r.shortlist, r.k, n_labels=len(r.labels),
                target_len=r.ltw_len, cfg=self.cfg)
        else:
            label_ids, _ = pl.classify_features(
                query, bank, ids, n_labels=len(r.labels), k=r.k, cfg=self.cfg)
        return r._ids_to_labels(label_ids)[0], start, end

    def flush(self):
        """Force-close a speech segment in progress (end of stream)."""
        if int(self.state.vad_state) == st.SPEECH:
            start = int(self.state.utt_start)
            end = self._offset + len(self._frames)
            if end - start >= self.cfg.vad.min_utterance_frames:
                ev = self._classify(start, end)
                return [ev] if ev is not None else []
        return []


def _np_deltas(c: np.ndarray, width: int) -> np.ndarray:
    """Host mirror of ``ops/frontend.deltas`` (edge-replicated regression
    deltas) for incremental streaming feature assembly."""
    t = len(c)
    denom = 2.0 * sum(n * n for n in range(1, width + 1))
    idx = np.arange(t)
    acc = np.zeros_like(c)
    for n in range(1, width + 1):
        hi = np.minimum(idx + n, t - 1)
        lo = np.maximum(idx - n, 0)
        acc += n * (c[hi] - c[lo])
    return acc / denom


def _np_causal_cmn(c: np.ndarray, alpha: float) -> np.ndarray:
    """Host causal cepstral mean subtraction (``FrontendConfig.cmn_mode=
    "causal"``) with a float64 running mean, as the JAX package's
    streaming connected recognizer takes it from its golden front-end:

        num_t = alpha * num_{t-1} + (1 - alpha) * c_t
        out_t = c_t - num_t / (1 - alpha^(t+1))

    Prefix-stable: row t sees only rows <= t."""
    out = np.zeros_like(c)
    num = np.zeros(c.shape[-1], dtype=np.float64)
    for t in range(c.shape[0]):
        num = alpha * num + (1.0 - alpha) * c[t].astype(np.float64)
        out[t] = c[t] - num / (1.0 - alpha ** (t + 1))
    return out


class StreamingConnectedRecognizer:
    """Online gapless connected-word decoding.

    The streaming front-end and causal VAD (``ops/streaming.py``) find
    utterance boundaries; inside an open utterance every frame whose
    features are final flows into streaming level building
    (``ops/level_building.py:level_build_chunk``, bit-equal to the batch
    DP under any chunking), so :meth:`hypothesis` gives the running best
    word sequence mid-utterance, and a closed utterance emits a ``(labels,
    start_frame, end_frame)`` event as :class:`StreamingRecognizer` does
    for isolated words.  Words inside an utterance need no gaps.

    A frame's [c, delta, delta-delta] row is final once ``2 *
    delta_width`` more frames exist, so the DP runs that many frames
    behind the audio; the utterance's last frames are completed with the
    true end clamp at close, as ``ops/frontend.add_deltas`` does.  The DP
    is fed one ``[1, F]`` row a call, as the JAX package does (~70 small
    device ops a frame at L = 4); the planes are read back once a chunk.
    ``feature_type="mfcc"`` only, and no utterance-mode CMN (an
    utterance-wide statistic would change frames the DP already took);
    ``cmn_mode="causal"`` streams.  Offline throughput belongs to
    ``classify_connected(method="level")``.
    """

    def __init__(self, recognizer: KnnDtwRecognizer, chunk_len: int = 1600,
                 max_levels: int = 8, word_penalty: float = 0.0):
        self.rec = recognizer
        self.cfg: PipelineConfig = recognizer.cfg
        f = self.cfg.frontend
        if f.feature_type != "mfcc":
            raise NotImplementedError(
                "StreamingConnectedRecognizer supports feature_type='mfcc' only")
        if f.cmn and f.cmn_mode != "causal":
            raise NotImplementedError(
                "cmn_mode='utterance' cannot stream; enroll a cmn=False "
                "or cmn_mode='causal' bank for streaming connected decoding")
        self.chunk_len = chunk_len
        self.max_levels = max_levels
        self.word_penalty = word_penalty
        self.mats = fe.make_matrices(f, recognizer.device)
        self._bank, ids = recognizer.device_bank()
        self._ids = ids.cpu().numpy()
        self._lag = 2 * f.delta_width
        self.reset()

    def reset(self) -> None:
        self.state = st.init_state(self.cfg.frontend, self.chunk_len,
                                   self.rec.device)
        self._frames: list[np.ndarray] = []   # raw MFCC frames, host side
        self._offset = 0                      # global index of _frames[0]
        self._utt = None                      # the open utterance's DP

    # ------------------------------------------------------------ internals
    def _open_utt(self, start: int) -> None:
        k, u = self._bank.feats.shape[:2]
        self._utt = {
            "start": start,                   # global frame index
            "fed": 0,                         # frames fed to the DP
            "state": lb.level_stream_init(self.max_levels, k, u, self.rec.device),
            "planes": ([], [], []),           # host [L, t] columns a feed
        }

    def _utt_feats(self, n_avail: int) -> np.ndarray:
        """Features of the open utterance's first ``n_avail`` frames, clamped
        as if it were ``n_avail`` long: rows before the last ``lag`` (all
        rows at the close) equal ``add_deltas`` over the closed utterance."""
        f = self.cfg.frontend
        lo = self._utt["start"] - self._offset
        c = np.stack(self._frames[lo:lo + n_avail]).astype(np.float32)
        if f.cmn:
            # causal mode only (the constructor's check): prefix-stable, so
            # rows already fed are reproduced bit for bit
            c = _np_causal_cmn(c, f.cmn_alpha)
        if not f.add_deltas:
            return c
        d1 = _np_deltas(c, f.delta_width)
        d2 = _np_deltas(d1, f.delta_width)
        return np.concatenate([c, d1, d2], axis=1)

    def _feed_dp(self, upto: int, final: bool) -> None:
        """Advance the DP to utterance frame ``upto`` (exclusive)."""
        utt = self._utt
        if upto <= utt["fed"]:
            return
        rows = self._utt_feats(upto if final else upto + self._lag)[utt["fed"]:upto]
        rows = torch.as_tensor(rows, device=self.rec.device)
        new = ([], [], [])
        for i in range(rows.shape[0]):        # one [1, F] row a call
            utt["state"], planes = lb.level_build_chunk(
                utt["state"], rows[i:i + 1], self._bank.feats, self._bank.length,
                self.word_penalty, self.cfg.dtw.squared)
            for acc, x in zip(new, planes):
                acc.append(x)
        for acc, x in zip(utt["planes"], new):
            acc.append(torch.cat(x, dim=1).cpu().numpy())
        utt["fed"] = upto

    def _decode(self, t_valid: int):
        cs, ws, ss = (np.concatenate(p, axis=1) for p in self._utt["planes"])
        seq, cost = lb.backtrack(cs, ws, ss, t_valid, max_levels=self.max_levels)
        return [self.rec.labels[int(self._ids[v])] for v in seq], cost

    def _close_utt(self, end: int):
        utt = self._utt
        n = end - utt["start"]
        event = None
        if n >= self.cfg.vad.min_utterance_frames and n > 0:
            self._feed_dp(n, final=True)
            labels, _ = self._decode(n)
            if labels:
                event = (labels, utt["start"], end)
        self._utt = None
        return event

    def _trim_history(self) -> None:
        keep_from = (self._utt["start"] - self._offset
                     if self._utt else len(self._frames))
        extra = min(keep_from, len(self._frames) - 4 * self.cfg.max_frames)
        if extra > 0:
            del self._frames[:extra]
            self._offset += extra

    # --------------------------------------------------------------- public
    def feed(self, chunk: np.ndarray):
        """One audio chunk [chunk_len] -> finished-utterance events
        ``(word labels, start frame, end frame)``."""
        if len(chunk) != self.chunk_len:
            raise ValueError(f"chunk of {len(chunk)} samples, want {self.chunk_len}")
        x = torch.as_tensor(np.asarray(chunk, np.float32), device=self.rec.device)
        self.state, out = st.process_chunk(self.state, x, self.mats,
                                           self.cfg.frontend, self.cfg.vad,
                                           self.chunk_len)
        mfcc, valid, ends, starts, stops = (
            a.cpu().numpy() for a in (out.mfcc, out.frame_valid, out.utt_end,
                                      out.utt_start_idx, out.utt_end_idx))
        self._frames.extend(mfcc[valid])
        n_total = self._offset + len(self._frames)

        events = []
        for t in np.nonzero(ends)[0]:
            if self._utt is None:
                self._open_utt(int(starts[t]))
            ev = self._close_utt(min(int(stops[t]), n_total))
            if ev is not None:
                events.append(ev)
        if self._utt is None and int(self.state.vad_state) == st.SPEECH:
            self._open_utt(int(self.state.utt_start))
        if self._utt is not None:
            # stream the DP up to the last frame whose features are final
            avail = n_total - self._utt["start"]
            self._feed_dp(max(0, avail - self._lag), final=False)
        self._trim_history()
        return events

    def hypothesis(self):
        """Running best word sequence of the open utterance (from the frames
        fed so far), or None outside speech."""
        if self._utt is None or self._utt["fed"] == 0:
            return None
        return self._decode(self._utt["fed"])[0]

    def flush(self):
        """End of stream: close any open utterance."""
        if self._utt is None:
            return []
        ev = self._close_utt(self._offset + len(self._frames))
        return [ev] if ev is not None else []
