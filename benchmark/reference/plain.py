"""Plain reference of the kNN-DTW recognizer that the benchmark judges.

Written from the recognizer's stated semantics, in plain PyTorch and
float64 by default, and importing nothing of the program:

* front end: pre-emphasis 0.97, 25 ms Hamming frames every 10 ms, the
  512-point power spectrum |X|^2 / 512 (as a DFT product), 26 HTK mel
  filters, log floored at 1e-10, orthonormal DCT-II to 13 coefficients,
  lifter 22;
* the energy / zero-crossing endpoint detector (Rabiner's two levels,
  thresholds 4x and 1.5x the first 10 frames' energy, ZCR 2x + 5,
  5 frames to start, 8 frames of hangover) on the raw signal's frames;
* the window of frames it finds, clamped to [1, max_frames], with
  regression deltas and delta-deltas (+/- 2 frames, the true last frame
  replicated) stacked to 39 features, zero past the length;
* DTW with Euclidean local cost, steps (1,0), (0,1), (1,1), inside the
  integer Sakoe-Chiba band and the quantised sliding window of
  :func:`plan_window` (a frozen copy of the program's schedule, which is
  part of its banded semantics), normalised by the two lengths; pairs
  with no admissible path are dead (``inf``);
* the label of the nearest template (k = 1).

``dtype`` sets the precision of every product and sum.  The control of
the benchmark's comparison runs this in float32 with TF32 products
(``check.control``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

LANE = 128


# ------------------------------------------------------------- constants
def hamming(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def mel_filterbank(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    """HTK triangles [n_mels, n_fft//2 + 1] between 0 and sr/2, bin points
    floor((n_fft + 1) f / sr), peak 1."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    mel = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    bins = np.floor((n_fft + 1) * hz / sr).astype(np.int64)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(n_mels):
        left, center, right = bins[m], bins[m + 1], bins[m + 2]
        for k in range(left, center):
            fb[m, k] = (k - left) / (center - left)
        for k in range(center, right):
            fb[m, k] = (right - k) / (right - center)
    return fb


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    k = np.arange(n_out, dtype=np.float64)[:, None]
    n = np.arange(n_in, dtype=np.float64)[None, :]
    mat = np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in)) * np.sqrt(2.0 / n_in)
    mat[0] *= np.sqrt(0.5)
    return mat


class Frontend:
    """The front end's constants on one device, in one dtype."""

    def __init__(self, sr: int, device, dtype=torch.float64, frame_len: int = 400,
                 hop: int = 160, n_fft: int = 512, n_mels: int = 26, n_mfcc: int = 13,
                 lifter: int = 22):
        self.frame_len, self.hop, self.n_fft = frame_len, hop, n_fft
        self.dtype, self.device = dtype, torch.device(device)
        n = np.arange(frame_len, dtype=np.float64)[:, None]
        k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * n * k / n_fft
        lift = (1.0 + (lifter / 2.0) * np.sin(np.pi * np.arange(n_mfcc) / lifter) if lifter
                else np.ones(n_mfcc))             # lifter 0: none

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

        self.window, self.cos, self.sin = t(hamming(frame_len)), t(np.cos(ang)), t(-np.sin(ang))
        self.mel_t = t(mel_filterbank(n_mels, n_fft, sr).T)
        self.dct_t = t(dct_matrix(n_mfcc, n_mels).T)
        self.lifter = t(lift)

    def frames(self, x: torch.Tensor) -> torch.Tensor:
        return x.unfold(-1, self.frame_len, self.hop)

    def cepstra(self, x: torch.Tensor) -> torch.Tensor:
        """Signals [B, N] -> cepstra [B, T, 13]."""
        x = x.to(self.dtype)
        y = torch.cat([x[:, :1], x[:, 1:] - 0.97 * x[:, :-1]], dim=1)
        fw = self.frames(y) * self.window
        re, im = fw @ self.cos, fw @ self.sin
        power = (re * re + im * im) / float(self.n_fft)
        log_mel = torch.log(torch.clamp(power @ self.mel_t, min=1e-10))
        return (log_mel @ self.dct_t) * self.lifter


# ------------------------------------------------------------------ VAD
def _run_ending_at(flag: torch.Tensor) -> torch.Tensor:
    """Length of the run of True ending at each position."""
    idx = torch.arange(flag.shape[-1], device=flag.device).expand_as(flag)
    last_false = torch.cummax(torch.where(flag, -1, idx), dim=-1).values
    return idx - last_false


def _first_true(flag: torch.Tensor) -> torch.Tensor:
    """First True index of each row, 0 where there is none."""
    t = flag.shape[-1]
    idx = torch.arange(t, device=flag.device).expand_as(flag)
    first = torch.where(flag, idx, t).min(dim=-1).values
    return torch.where(first == t, 0, first)


def endpoints(e: torch.Tensor, z: torch.Tensor, n_frames: torch.Tensor,
              scale: float = 1.0):
    """Frame energies / zero crossings [B, T] and valid frame counts [B]
    -> (start [B], end exclusive [B]).  ``scale`` multiplies both energy
    thresholds (the comparison's rounding margin, :func:`vad_windows`)."""
    b, t = e.shape
    idx = torch.arange(t, device=e.device)[None, :]
    length = n_frames[:, None]
    valid = idx < length
    init = (idx < torch.clamp(length, max=10)).to(e.dtype)
    denom = torch.clamp(init.sum(-1, keepdim=True), min=1.0)
    e_noise = (e * init).sum(-1, keepdim=True) / denom + 1e-6
    z_noise = (z * init).sum(-1, keepdim=True) / denom
    th, tl = e_noise * 4.0 * scale, e_noise * 1.5 * scale
    zt = z_noise * 2.0 + 5.0

    high = (e > th) & valid
    qual = _run_ending_at(high) >= 5
    found = qual.any(-1)
    start_core = _first_true(qual) - 4
    end_core = t - 1 - _first_true(qual.flip(-1))
    audible = ((e > tl) | (z > zt)) & valid
    back = _run_ending_at(audible)
    fwd = _run_ending_at(audible.flip(-1)).flip(-1)

    def at(v, i):
        return torch.take_along_dim(v, i[:, None], dim=-1)[:, 0]

    start = torch.where(start_core > 0,
                        start_core - at(back, torch.clamp(start_core - 1, min=0)),
                        torch.zeros_like(start_core))
    end = torch.where(end_core + 1 < n_frames,
                      end_core + at(fwd, torch.clamp(end_core + 1, max=t - 1)), end_core)
    end_excl = torch.minimum(n_frames, end + 9)
    return (torch.where(found, start, torch.zeros_like(start)),
            torch.where(found, end_excl, n_frames))


# rounding margin of the thresholds: the program sums 400 squares in
# float32 (relative error ~1e-6); a frame within 1e-5 of a threshold
# may land on either side of it there
VAD_MARGIN = 1e-5


def vad_windows(fe: Frontend, x: torch.Tensor, n_samples: torch.Tensor):
    """Signals [B, N] -> the endpoint windows a correct program may find:
    a list of B tuples of distinct (start, end) pairs, the first computed
    at the thresholds themselves, more where a frame lies within
    :data:`VAD_MARGIN` of a threshold (energies in float64 whatever the
    front end's dtype)."""
    frames = fe.frames(x.to(torch.float64))
    e = (frames * frames).sum(-1)
    sign = frames >= 0.0
    z = (sign[..., 1:] != sign[..., :-1]).to(torch.float64).sum(-1)
    n_frames = torch.clamp(1 + torch.div(n_samples.to(torch.int64) - fe.frame_len,
                                         fe.hop, rounding_mode="floor"), min=0)
    outs = [torch.stack(endpoints(e, z, n_frames, s), dim=1).cpu().numpy()
            for s in (1.0, 1.0 - VAD_MARGIN, 1.0 + VAD_MARGIN)]
    res = []
    for i in range(x.shape[0]):
        seen = []
        for o in outs:
            w = (int(o[i, 0]), int(o[i, 1]))
            if w not in seen:
                seen.append(w)
        res.append(tuple(seen))
    return res


# --------------------------------------------------------------- features
def _masked_deltas(c: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    t = c.shape[1]
    idx = torch.arange(t, device=c.device)[None, :]
    cap = torch.clamp(length - 1, min=0)[:, None]
    acc = torch.zeros_like(c)
    for n in (1, 2):
        hi = torch.minimum(torch.clamp(idx + n, min=0), cap)
        lo = torch.minimum(torch.clamp(idx - n, min=0), cap)
        acc = acc + n * (torch.take_along_dim(c, hi[..., None], 1)
                         - torch.take_along_dim(c, lo[..., None], 1))
    return acc / 10.0


def features(ceps: torch.Tensor, start: torch.Tensor, end: torch.Tensor, t_max: int):
    """Cepstra [B, T, 13] and windows -> (features [B, t_max, 39], lengths [B])."""
    length = torch.clamp(end - start, min=1, max=t_max)
    steps = torch.arange(t_max, device=ceps.device)
    idx = torch.clamp(start[:, None] + steps, 0, ceps.shape[1] - 1)
    c = torch.take_along_dim(ceps, idx[..., None], dim=1)
    d1 = _masked_deltas(c, length)
    d2 = _masked_deltas(d1, length)
    f = torch.cat([c, d1, d2], dim=-1)
    valid = (steps[None, :] < length[:, None])[..., None]
    return torch.where(valid, f, torch.zeros_like(f)), length


# ------------------------------------------------------------ band rule
def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_window(band_frac, t: int, u: int, max_scale):
    """(W, S_MAX, row_block) of the sliding window schedule for padded
    shape [t, u]; W = u rounded up to 128 lanes means no window."""
    u_pad = round_up(u, LANE)
    if band_frac is None or max_scale is None:
        return u_pad, 0, 32
    radius = max(1.0, band_frac * max(t, u))
    width = int(2 * radius) + 1
    w = row_block = None
    for rb in (32, 16):
        need = width + int(math.ceil(rb * max_scale)) + 8 + 8 + 2
        w_rb = min(u_pad, round_up(need, LANE))
        if w is None or w_rb < w:
            w, row_block = w_rb, rb
    s_max = 0 if w == u_pad else round_up(int(row_block * max_scale) + 8, 8)
    return w, s_max, row_block


def band_r2(la: torch.Tensor, lb: torch.Tensor, band_frac: float) -> torch.Tensor:
    """Integer band threshold: cell (i, j) is in band iff
    |j (la-1) - i (lb-1)| <= r2, with r2 from float32 products and a floor."""
    lam1 = torch.clamp(la - 1, min=1)
    radius = torch.clamp(torch.tensor(np.float32(band_frac), device=la.device)
                         * torch.maximum(la, lb).to(torch.float32), min=1.0)
    return torch.floor(radius * lam1.to(torch.float32)).to(torch.int64)


def valid_cells_mask(la: torch.Tensor, lb: torch.Tensor, t: int, u: int,
                     band_frac, max_scale) -> torch.Tensor:
    """[P, t, u] bool: cell inside pair p's lengths, band and window."""
    la, lb = la.to(torch.int64), lb.to(torch.int64)
    dev = la.device
    i = torch.arange(t, device=dev)[None, :, None]
    j = torch.arange(u, device=dev)[None, None, :]
    ok = (i < la[:, None, None]) & (j < lb[:, None, None])
    if band_frac is None:
        return ok
    lam1 = torch.clamp(la - 1, min=1)
    lbm1 = lb - 1
    r2 = band_r2(la, lb, band_frac)
    ok = ok & ((j * lam1[:, None, None] - i * lbm1[:, None, None]).abs()
               <= r2[:, None, None])
    w, s_max, rb = plan_window(band_frac, t, u, max_scale)
    if max_scale is None or w >= round_up(u, LANE):
        return ok
    nb = -(-t // rb)
    i0 = torch.arange(nb, device=dev)[None, :] * rb
    num = torch.clamp(i0 * lbm1[:, None] - r2[:, None], min=0)
    jlo = torch.div(num + lam1[:, None] - 1, lam1[:, None], rounding_mode="floor")
    off = torch.clamp(torch.div(jlo, 8, rounding_mode="floor") * 8 - 8, min=0)
    clip8 = torch.div(torch.clamp(lb - w, min=0) + 7, 8, rounding_mode="floor") * 8
    off = torch.minimum(off, clip8[:, None])
    offs, prev = [], torch.zeros_like(lb)
    for blk in range(nb):
        prev = torch.minimum(off[:, blk], prev + s_max)
        offs.append(prev)
    off_i = torch.stack(offs, dim=1)[:, torch.arange(t, device=dev) // rb][..., None]
    return ok & (j >= off_i) & (j < off_i + w)


# ------------------------------------------------------------------ DTW
def dtw(qf: torch.Tensor, ql: torch.Tensor, bf: torch.Tensor, bl: torch.Tensor,
        band_frac, max_scale, cells_per_block: int = 1 << 27) -> torch.Tensor:
    """All pairs: queries [B, T, F] x templates [K, U, F] -> distances
    [B, K] in the features' dtype, ``inf`` where no path is admissible.

    The local cost is sqrt(|a|^2 + |b|^2 - 2 a.b); the DP walks the
    anti-diagonals, all pairs of a block of queries at once."""
    b, t, f = qf.shape
    k, u, _ = bf.shape
    out = torch.empty((b, k), dtype=qf.dtype, device=qf.device)
    nq = max(1, cells_per_block // (k * t * u))
    sq_b = (bf * bf).sum(-1)                                    # [K, U]
    s_idx = torch.arange(t + u - 1, device=qf.device)
    rows = torch.arange(t, device=qf.device)
    for lo in range(0, b, nq):
        q = qf[lo:lo + nq]
        n = q.shape[0]
        cross = (q.reshape(n * t, f) @ bf.reshape(k * u, f).T).reshape(n, t, k, u)
        sq = ((q * q).sum(-1)[:, :, None, None] + sq_b[None, None] - 2.0 * cross)
        cost = torch.sqrt(torch.clamp(sq, min=0.0)).permute(0, 2, 1, 3)  # [n, K, T, U]
        la = ql[lo:lo + n].to(torch.int64)[:, None].expand(n, k).reshape(-1)
        lb = bl.to(torch.int64)[None, :].expand(n, k).reshape(-1)
        ok = valid_cells_mask(la, lb, t, u, band_frac, max_scale)
        cost = torch.where(ok, cost.reshape(n * k, t, u), torch.inf)
        out[lo:lo + n] = _wavefront(cost, la, lb, s_idx, rows).reshape(n, k)
    return out


def _wavefront(cost: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               s_idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """DP over masked costs [P, T, U] along anti-diagonals s = i + j:
    diagonal s is held as [P, T] by row i (``inf`` where j = s - i is off
    the grid).  Returns D[la-1, lb-1] / (la + lb)."""
    p, t, u = cost.shape
    flat = torch.cat([cost.reshape(p, t * u),
                      torch.full((p, 1), torch.inf, dtype=cost.dtype, device=cost.device)],
                     dim=1)
    inf_col = torch.full((p, 1), torch.inf, dtype=cost.dtype, device=cost.device)
    prev2 = torch.full((p, t), torch.inf, dtype=cost.dtype, device=cost.device)
    prev = prev2.clone()
    target = la + lb - 2
    ans = torch.full((p,), torch.inf, dtype=cost.dtype, device=cost.device)
    pick = (la - 1)[:, None]
    for s in s_idx.tolist():
        j = s - rows
        idx = torch.where((j >= 0) & (j < u), rows * u + j, t * u)
        c = flat[:, idx]
        if s == 0:
            cur = c
        else:
            up_diag = torch.cat([inf_col, prev[:, :-1]], dim=1)      # D[i-1, j]
            diag = torch.cat([inf_col, prev2[:, :-1]], dim=1)        # D[i-1, j-1]
            cur = c + torch.minimum(torch.minimum(up_diag, prev), diag)
        ans = torch.where(target == s, torch.take_along_dim(cur, pick, dim=1)[:, 0], ans)
        prev2, prev = prev, cur
    return ans / (la + lb).to(cost.dtype)
