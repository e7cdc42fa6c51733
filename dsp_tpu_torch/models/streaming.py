"""Online recognizer: streaming front-end + template matching (port of
``dsp_tpu/models/streaming.py``).

The live-demo loop: chunks of audio -> causal endpoint detection -> on an
utterance end, classify its frames with the offline recognizer's matcher.
The host moves chunks and collects events; the front-end and VAD run in
``ops/streaming.py:process_chunk`` on the recognizer's device, and each
closed utterance is classified there as the offline recognizer classifies
(kernel 1, ``csrc/dtw_banded.cu``, on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import PipelineConfig
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer, _not_ported
from dsp_tpu_torch.ops import frontend as fe
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


class StreamingConnectedRecognizer:
    """Online gapless connected-word decoding: streaming front-end plus
    streaming level building.  Needs the connected-word slice."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("StreamingConnectedRecognizer", "queue 1, item 13")
