"""DTW alignment paths and DBA template averaging (port of
``dsp_tpu/ops/align.py``).

* :func:`dtw_alignment_pairs` — the full DP table of every pair, by the
  same row step as ``ops/dtw.py:dtw_from_cost`` (min-plus doubling scan,
  or the Itakura two-state rows), read back to the host once; the
  backtrace then walks all pairs together in numpy, T+U-1 steps, and the
  path comes out end-first, padded with -1.  :func:`dtw_alignment` is
  one pair of it.
* :func:`medoid` — argmin of the summed all-pairs DTW distance.
* :func:`dba_average` — DTW Barycenter Averaging: align every recording
  to the center, then average the frames mapped to each center frame.
  The average is a one-hot GEMM per recording, ``[U, L] @ [L, F]``,
  summed over the recordings in a fixed order: a scatter-add of floats
  (``index_add_``) takes CUDA's atomics, whose order of summation, and
  so the centers' last bits, change from run to run.

Oracle: ``dsp_tpu/golden/dtw.py`` with ``return_path=True``.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.ops.dtw import (BIG, _itakura_row_step, _one_len, _row_step,
                                   dtw_batch, masked_cost_pairs)


def _dp_table(cost: torch.Tensor) -> torch.Tensor:
    """Full DP tables D [..., T, U] from masked costs [..., T, U], by
    ``ops/dtw.py:dtw_from_cost``'s row step, so the end cell over (la+lb)
    equals its distance bit for bit."""
    d_prev = torch.full_like(cost[..., 0, :], BIG)
    rows = []
    for i in range(cost.shape[-2]):
        d_prev = _row_step(d_prev, cost[..., i, :], i == 0)
        rows.append(d_prev)
    return torch.stack(rows, dim=-2)


def _dp_tables_itakura(cost: torch.Tensor):
    """(D, N) tables [..., T, U] of the Itakura recurrence, by
    ``ops/dtw.py:dtw_from_cost_itakura``'s row step."""
    d_prev = torch.full_like(cost[..., 0, :], BIG)
    n_prev = torch.full_like(d_prev, BIG)
    d_rows, n_rows = [], []
    for i in range(cost.shape[-2]):
        d_prev, n_prev = _itakura_row_step(d_prev, n_prev, cost[..., i, :], i == 0)
        d_rows.append(d_prev)
        n_rows.append(n_prev)
    return torch.stack(d_rows, dim=-2), torch.stack(n_rows, dim=-2)


def _backtrace(table: np.ndarray, len_a: np.ndarray, len_b: np.ndarray,
               steps: int):
    """End-first paths of P pairs through tables [P, T, U] (host numpy).

    Each step moves to the smallest of (diag, up, left), the first of
    equal values winning (``jnp.argmin`` over that stack)."""
    p = table.shape[0]
    rows = np.arange(p)
    i, j = len_a - 1, len_b - 1
    done = np.zeros(p, bool)
    path_i = np.full((p, steps), -1, np.int64)
    path_j = np.full((p, steps), -1, np.int64)
    big = np.float32(BIG)
    for s in range(steps):
        path_i[:, s] = np.where(done, -1, i)
        path_j[:, s] = np.where(done, -1, j)
        im, jm = np.maximum(i - 1, 0), np.maximum(j - 1, 0)
        d_diag = np.where((i > 0) & (j > 0), table[rows, im, jm], big)
        d_up = np.where(i > 0, table[rows, im, j], big)
        d_left = np.where(j > 0, table[rows, i, jm], big)
        best = np.where(d_up < d_diag, 1, 0)
        best = np.where(d_left < np.minimum(d_diag, d_up), 2, best)
        at_origin = (i == 0) & (j == 0)
        stop = at_origin | done
        done = done | at_origin
        i = np.where(stop, 0, np.where(best != 2, i - 1, i))
        j = np.where(stop, 0, np.where(best != 1, j - 1, j))
    return path_i, path_j


def _backtrace_itakura(cost: np.ndarray, dtab: np.ndarray, ntab: np.ndarray,
                       len_a: np.ndarray, len_b: np.ndarray, steps: int):
    """End-first Itakura paths of P pairs via the two-state tables (host
    numpy).  Tie rules as ``dsp_tpu/ops/align.py:_backtrace_itakura``: the
    non-vertical branch first, then the (1,1) step on ``d1 <= d2``."""
    p = cost.shape[0]
    rows = np.arange(p)
    i, j = len_a - 1, len_b - 1
    vert_ok = np.ones(p, bool)
    done = np.zeros(p, bool)
    path_i = np.full((p, steps), -1, np.int64)
    path_j = np.full((p, steps), -1, np.int64)
    big = np.float32(BIG)
    for s in range(steps):
        im = np.maximum(i - 1, 0)
        ndm1 = np.where(i > 0, ntab[rows, im, j], big)
        vert = vert_ok & (i > 0) & (cost[rows, i, j] + ndm1 < ntab[rows, i, j])
        d1 = np.where((i > 0) & (j > 0), dtab[rows, im, np.maximum(j - 1, 0)], big)
        d2 = np.where((i > 0) & (j > 1), dtab[rows, im, np.maximum(j - 2, 0)], big)
        dj = np.where(vert, 0, np.where(d1 <= d2, 1, 2))
        path_i[:, s] = np.where(done, -1, i)
        path_j[:, s] = np.where(done, -1, j)
        done = done | (i == 0)
        i = np.where(done, 0, i - 1)
        # j < 0 only on unreachable end cells (an all-BIG walk): clamp at 0
        j = np.where(done, 0, np.maximum(j - dj, 0))
        vert_ok = ~vert
    return path_i, path_j


def dtw_alignment_pairs(a: torch.Tensor, len_a: torch.Tensor,
                        b: torch.Tensor, len_b: torch.Tensor,
                        cfg: DtwConfig = DtwConfig()):
    """Align a [P,T,F] to b [P,U,F] pair by pair.

    Returns (dist [P] on the inputs' device, path_i [P, L], path_j [P, L],
    n_steps [P]) with L = T+U-1, the paths as host int64 numpy, each
    emitted end-first — entry 0 is (len_a-1, len_b-1), entry n_steps-1 is
    (0, 0) — and padded with -1.  With ``cfg.slope="itakura"`` the paths
    obey the slope-constrained step set (backtraced from the (D, N)
    tables)."""
    if cfg.slope not in (None, "itakura"):
        raise ValueError(f"unknown DtwConfig.slope {cfg.slope!r}")
    t, u = a.shape[1], b.shape[1]
    la, lb = len_a.to(torch.int64), len_b.to(torch.int64)
    cost = masked_cost_pairs(a, la, b, lb, cfg)
    if cfg.slope == "itakura":
        dtab, ntab = _dp_tables_itakura(cost)
    else:
        dtab = _dp_table(cost)
    end = dtab[torch.arange(a.shape[0], device=a.device), la - 1, lb - 1]
    dist = end / (la + lb).to(cost.dtype)
    la_h, lb_h = la.cpu().numpy(), lb.cpu().numpy()
    if cfg.slope == "itakura":
        path_i, path_j = _backtrace_itakura(
            cost.cpu().numpy(), dtab.cpu().numpy(), ntab.cpu().numpy(),
            la_h, lb_h, t + u - 1)
    else:
        path_i, path_j = _backtrace(dtab.cpu().numpy(), la_h, lb_h, t + u - 1)
    return dist, path_i, path_j, (path_i >= 0).sum(axis=1)


def dtw_alignment(a: torch.Tensor, b: torch.Tensor,
                  len_a: torch.Tensor | int | None = None,
                  len_b: torch.Tensor | int | None = None,
                  cfg: DtwConfig = DtwConfig()):
    """Align a [T,F] to b [U,F] -> (dist, path_i [T+U-1], path_j [T+U-1],
    n_steps): one pair of :func:`dtw_alignment_pairs`."""
    la = _one_len(a.shape[0] if len_a is None else len_a, a)
    lb = _one_len(b.shape[0] if len_b is None else len_b, a)
    dist, pi, pj, n = dtw_alignment_pairs(a[None], la, b[None], lb, cfg)
    return dist[0], pi[0], pj[0], int(n[0])


def medoid(feats: torch.Tensor, lens: torch.Tensor,
           cfg: DtwConfig = DtwConfig(), dtw_fn=dtw_batch) -> int:
    """Index of the recording of feats [N, T, F] minimising its total DTW
    distance to the rest; ``dtw_fn(q, q_lens, bank, bank_lens, cfg) ->
    [N, N]`` computes the distances (the plain scan by default)."""
    d = dtw_fn(feats, lens, feats, lens, cfg)
    return int(torch.argmin(d.sum(dim=-1)))


def dba_average(feats: torch.Tensor, lens: torch.Tensor,
                center: torch.Tensor, len_c: torch.Tensor | int,
                n_iter: int = 3, cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """DTW Barycenter Averaging of feats [N, T, F] onto center [U, F].

    Each of ``n_iter`` rounds aligns the center to every recording (one
    batched DP, one backtrace) and replaces each center frame by the mean
    of the recording frames mapped to it; a frame no path visits keeps its
    value, and frames beyond ``len_c`` stay zero.  Returns the new center
    (same shape)."""
    n = feats.shape[0]
    u = center.shape[0]
    dev = feats.device
    len_c = int(len_c)
    la = torch.full((n,), len_c, dtype=torch.int64, device=dev)
    lens = lens.to(torch.int64)
    codes = torch.arange(u, device=dev)
    inside = (codes < len_c)[:, None]
    for _ in range(n_iter):
        _, pi, pj, _ = dtw_alignment_pairs(center.expand(n, -1, -1), la,
                                           feats, lens, cfg)
        pi_t = torch.from_numpy(pi).to(dev)                       # [N, L]
        pj_t = torch.from_numpy(np.maximum(pj, 0)).to(dev)
        # padding steps (-1) match no center frame
        onehot = (pi_t[..., None] == codes).to(feats.dtype)       # [N, L, U]
        frames = torch.take_along_dim(feats, pj_t[..., None], dim=1)   # [N, L, F]
        sums = torch.bmm(onehot.transpose(1, 2), frames).sum(dim=0)    # [U, F]
        tot = onehot.sum(dim=(0, 1))[:, None]                           # [U, 1]
        new = torch.where(tot > 0, sums / torch.clamp(tot, min=1.0), center)
        center = torch.where(inside, new, torch.zeros_like(new))
    return center
