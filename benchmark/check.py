"""The comparison that decides ``correct``: the program's labels and
distances against the plain reference (``reference/plain.py``), on the
same clips.

Two numbers are compared, each with a limit from the configuration's
file (``limits``):

* ``dist_gap``: the widest relative gap |d - d_ref| / d_ref over every
  (query, template) distance of the sampled requests; a pair dead on one
  side only (no admissible path; the program's 1e20 and more) or a NaN
  reads ``inf``.  Where a frame of a clip lies within the rounding margin
  of an endpoint threshold (``plain.VAD_MARGIN``), the reference gives
  each window the detector may find there, and the nearest counts.
* ``label_errors``: queries whose label is not that of a template at the
  least of the program's own distances of its row (``-1`` where every
  pair of the row is dead).  With ``dist_gap`` within its limit that
  template is the reference's nearest to within the limit.

:func:`control` is the reference in the program's place one precision
down (float32 with TF32 products): the comparison has to fail it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import plain

DEAD = 1e20           # the program's distances at or above this are dead
BLOCK = 512           # clips a block of the reference's front end


class Side(NamedTuple):
    """The reference's features of a set of clips."""

    feats: torch.Tensor          # [N, t_max, 39]
    lens: torch.Tensor           # [N]
    alts: dict                   # index -> [(feats [1, t_max, 39], lens [1])]


def side(fe: plain.Frontend, clips: np.ndarray, t_max: int) -> Side:
    """Features of ``clips`` [N, samples] (all of full length) by blocks."""
    feats, lens, alts = [], [], {}
    for lo in range(0, clips.shape[0], BLOCK):
        x = torch.as_tensor(clips[lo:lo + BLOCK], device=fe.device)
        n = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64, device=fe.device)
        ceps = fe.cepstra(x)
        wins = plain.vad_windows(fe, x, n)
        start = torch.tensor([w[0][0] for w in wins], device=fe.device)
        end = torch.tensor([w[0][1] for w in wins], device=fe.device)
        f, ln = plain.features(ceps, start, end, t_max)
        feats.append(f)
        lens.append(ln)
        for i, w in enumerate(wins):
            if len(w) > 1:
                alts[lo + i] = [plain.features(ceps[i:i + 1], torch.tensor([s], device=fe.device),
                                               torch.tensor([e], device=fe.device), t_max)
                                for s, e in w[1:]]
    return Side(torch.cat(feats), torch.cat(lens), alts)


def lengths(fe: plain.Frontend, clips: np.ndarray, t_max: int) -> np.ndarray:
    """Feature lengths [N] the endpoint detector gives ``clips`` (the
    first window of each): the inputs' lengths that the cell counts use."""
    out = []
    for lo in range(0, clips.shape[0], BLOCK):
        x = torch.as_tensor(clips[lo:lo + BLOCK], device=fe.device)
        n = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64, device=fe.device)
        out += [min(max(w[0][1] - w[0][0], 1), t_max) for w in plain.vad_windows(fe, x, n)]
    return np.asarray(out, dtype=np.int64)


def _relgap(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """|p - r| / r elementwise; 0 where both are dead, inf where one is."""
    p_dead, r_dead = ~torch.isfinite(p), ~torch.isfinite(r)
    g = (p - r).abs() / torch.clamp(r, min=1e-3)
    g = torch.where(p_dead | r_dead, torch.inf, g)
    return torch.where(p_dead & r_dead & ~torch.isnan(p), torch.zeros_like(g), g)


def compare(prog_ids: np.ndarray, prog_d: np.ndarray, bank_ids: np.ndarray,
            q: Side, b: Side, band_frac, max_scale) -> dict:
    """The compared numbers of one set of requests: ``prog_ids`` [B] and
    ``prog_d`` [B, K] as the program returned them for the queries of
    ``q``, against the reference over ``q`` x ``b``."""
    dev = q.feats.device
    ref = plain.dtw(q.feats, q.lens, b.feats, b.lens, band_frac, max_scale)
    p = torch.as_tensor(np.asarray(prog_d, dtype=np.float64), device=dev)
    p = torch.where(p >= DEAD, torch.inf, p)
    gap = _relgap(p, ref)
    for i, alts in q.alts.items():
        for f, ln in alts:
            gap[i] = torch.minimum(gap[i], _relgap(p[i], plain.dtw(
                f, ln, b.feats, b.lens, band_frac, max_scale)[0]))
    for k, alts in b.alts.items():
        for f, ln in alts:
            gap[:, k] = torch.minimum(gap[:, k], _relgap(p[:, k], plain.dtw(
                q.feats, q.lens, f, ln, band_frac, max_scale)[:, 0]))
            for i, q_alts in q.alts.items():
                for fq, lq in q_alts:
                    gap[i, k] = torch.minimum(gap[i, k], _relgap(p[i, k], plain.dtw(
                        fq, lq, f, ln, band_frac, max_scale)[0, 0]))
    d = np.where(np.asarray(prog_d) >= DEAD, np.inf, np.asarray(prog_d, dtype=np.float64))
    errors = 0
    for i in range(d.shape[0]):
        best = d[i].min()
        want = {-1} if not np.isfinite(best) else set(np.asarray(bank_ids)[d[i] == best].tolist())
        errors += int(int(prog_ids[i]) not in want)
    return {"dist_gap": float(gap.max()), "label_errors": errors,
            "marginal_clips": len(q.alts) + len(b.alts)}


@contextlib.contextmanager
def tf32():
    """Matrix products in TF32 inside the block."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def control(fe: plain.Frontend, bank: np.ndarray, queries: np.ndarray, bank_ids: np.ndarray,
            t_max: int, band_frac, max_scale):
    """The reference in the program's place with TF32 products, over the
    front end ``fe`` in float32: (label ids [B], distances [B, K] with
    1e30 where dead)."""
    with tf32():
        b = side(fe, bank, t_max)
        q = side(fe, queries, t_max)
        d = plain.dtw(q.feats, q.lens, b.feats, b.lens, band_frac, max_scale)
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, 1e30)).cpu().numpy()
    best = d.argmin(axis=1)
    ids = np.where(d[np.arange(len(best)), best] < DEAD, np.asarray(bank_ids)[best], -1)
    return ids, d
