"""Operations, bytes and peaks: the arithmetic of the benchmark's shares.

The peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, at its 700 W
limit): 67 TFLOP/s in float32 outside the tensor cores, which is the
recognizer's precision (TF32 is off), and 3.35 TB/s of HBM3.

The DTW's work is counted at the lengths the inputs have after the
endpoint detector: a pair's cells inside its lengths, band and window
(:func:`cell_table`, summed from ``reference/plain.py``'s own mask), each
2F + 3 operations (F squared differences summed, the step's add and two
mins).
Its bytes are the features, lengths and distances once.  The front end's
operations are counted from shapes, as an FFT would need them
(:func:`frontend_flops`).  Every count is the same whatever kernel
computes it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from benchmark.reference import plain

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
CELLS_PER_BLOCK = 1 << 24     # mask cells built at once


def pair_cells(la, lb, t: int, u: int, band_frac, max_scale, device="cpu") -> np.ndarray:
    """[P] int64: the DP cells of each pair of lengths (la[p], lb[p]) at
    padded shape [t, u], by the reference's own mask, in blocks of pairs."""
    la = torch.as_tensor(np.asarray(la), dtype=torch.int64, device=device)
    lb = torch.as_tensor(np.asarray(lb), dtype=torch.int64, device=device)
    step = max(1, CELLS_PER_BLOCK // (t * u))
    out = [plain.valid_cells_mask(la[lo:lo + step], lb[lo:lo + step], t, u, band_frac,
                                  max_scale).sum((1, 2)).cpu()
           for lo in range(0, la.shape[0], step)]
    return torch.cat(out).numpy().astype(np.int64)


@functools.lru_cache(maxsize=8)
def cell_table(t: int, u: int, band_frac, max_scale, device="cpu") -> np.ndarray:
    """[t + 1, u + 1] int64: entry [la, lb] counts the DP cells of a pair of
    lengths la <= t and lb <= u at padded shape [t, u] (row and column 0
    are unused)."""
    la = np.repeat(np.arange(1, t + 1), u)
    lb = np.tile(np.arange(1, u + 1), t)
    table = np.zeros((t + 1, u + 1), np.int64)
    table[1:, 1:] = pair_cells(la, lb, t, u, band_frac, max_scale, device).reshape(t, u)
    return table


def dtw_cells(q_lens, b_lens, table: np.ndarray) -> int:
    """DP cells of all pairs of ``q_lens`` x ``b_lens``."""
    qh = np.bincount(np.asarray(q_lens), minlength=table.shape[0])
    bh = np.bincount(np.asarray(b_lens), minlength=table.shape[1])
    return int(qh @ table @ bh)


def dtw_flops(cells: int, n_feats: int) -> float:
    return float(cells) * (2.0 * n_feats + 3.0)


def dtw_bytes(n_queries: int, t: int, n_templates: int, u: int, n_feats: int) -> float:
    """Features, lengths and distances of one all-pairs call, once."""
    return 4.0 * ((n_queries * t + n_templates * u) * n_feats
                  + n_queries + n_templates + n_queries * n_templates)


def least_seconds(flops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S)


def frontend_flops(n_signals: int, n_samples: int, t_max: int, frame_len: int = 400,
                   hop: int = 160, n_fft: int = 512, n_mels: int = 26,
                   n_mfcc: int = 13) -> float:
    """Operations of the front end over padded signals, from shapes:
    pre-emphasis (2 a sample); per frame the window (L), a real FFT
    (2.5 n log2 n), the power (3 a bin), the mel product (2 x bins x
    mels), the log, the DCT (2 x mels x ceps) and lifter, the endpoint
    detector's energy (2 L) and zero crossings (L); per feature frame two
    regression passes over the cepstra (7 a coefficient each)."""
    frames = 1 + (n_samples - frame_len) // hop
    bins = n_fft // 2 + 1
    per_frame = (frame_len + 2.5 * n_fft * math.log2(n_fft) + 3 * bins
                 + 2 * bins * n_mels + n_mels + 2 * n_mels * n_mfcc + n_mfcc
                 + 3 * frame_len)
    return float(n_signals) * (2.0 * n_samples + frames * per_frame
                               + t_max * 2 * 7 * n_mfcc)
