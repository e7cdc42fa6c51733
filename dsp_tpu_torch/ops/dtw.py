"""Plain DTW in PyTorch (port of ``dsp_tpu/ops/dtw.py``): all pairs
(:func:`dtw_batch`), paired (:func:`dtw_pairs_scan`), one pair
(:func:`dtw_distance`), and the bidirectional half-depth scan
(:func:`dtw_batch_bidi`).

This is the port's CPU path and, on the card, the oracle that the DTW
kernels are held to (kernels/dtw_fused_banded.py; the wavefront kernel of
kernels/dtw_pallas.py reads :func:`masked_cost` / :func:`masked_cost_pairs`).

* **Local cost.**  Euclidean cost expands to ``|a|^2 + |b|^2 - 2 a.b``;
  the cross term is one batched fp32 GEMM over every (query, template)
  pair, as in the JAX package.  Cells outside the length, the integer
  Sakoe-Chiba band (``band_r2``) or the quantised window schedule
  (``window_valid``, from ``window_plan.plan_window``) hold ``BIG``.

* **Row recurrence.**  A Python loop walks the T rows.  Within a row,

      D[i,j] = c[i,j] + min(m[j], D[i,j-1]),   m[j] = min(D[i-1,j], D[i-1,j-1])

  is affine in the (min,+) semiring, D_j = min(A_j, D_{j-1} + c_j) with
  A_j = m_j + c_j, and the pairs (A, c) compose associatively
  (``_minplus_combine``).  Each row is solved by a Hillis-Steele doubling
  scan over that algebra: log2(U) whole-row tensor steps.  The JAX
  package uses ``lax.associative_scan`` over the same algebra; the two
  trees sum in another order, so distances agree to float32 rounding.

The answer is read from cell (len_a-1, len_b-1) and divided by
(len_a + len_b).  Unreachable pairs come out >= 1e20 (BIG-scaled), as in
the JAX scan.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.window_plan import LANE, plan_window, round_up

BIG = 1e30

# Upper bound on the [B, K, T, U] cost cells materialised at once by
# dtw_batch (1 GiB of float32); larger batches run in query chunks.
_MAX_COST_CELLS = 1 << 28


def pairwise_sq_cost(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean cost: a [..., T, F], b [..., U, F] -> [..., T, U] (>=0)."""
    cross = torch.matmul(a, b.transpose(-1, -2))
    sq_a = (a * a).sum(dim=-1, keepdim=True)
    sq_b = (b * b).sum(dim=-1)[..., None, :]
    return torch.clamp(sq_a + sq_b - 2.0 * cross, min=0.0)


def _minplus_combine(e1, e2):
    """Compose D -> min(A2, (min(A1, D + c1)) + c2); e1 is the earlier op.

    An optional third member is a payload (the spotting DP's start
    witness) that follows the winning term; a tie keeps the later op's
    (``take2 = a2 <= a1 + c2``), as ``dsp_tpu/ops/spot.py:_combine``."""
    a1, c1, *s1 = e1
    a2, c2, *s2 = e2
    via1 = a1 + c2
    out = (torch.minimum(a2, via1), c1 + c2)
    if s1:
        out += (torch.where(a2 <= via1, s2[0], s1[0]),)
    return out


def _minplus_scan(a: torch.Tensor, c: torch.Tensor,
                  s: torch.Tensor | None = None):
    """Inclusive Hillis-Steele scan of (a, c[, s]) along the last axis ->
    the A part, or (A, payload) when a payload ``s`` is given."""
    elems = (a, c) if s is None else (a, c, s)
    u = a.shape[-1]
    step = 1
    while step < u:
        new = _minplus_combine(tuple(e[..., :-step] for e in elems),
                               tuple(e[..., step:] for e in elems))
        elems = tuple(torch.cat([e[..., :step], n], dim=-1)
                      for e, n in zip(elems, new))
        step *= 2
    return elems[0] if s is None else (elems[0], elems[2])


def _start_column(d_prev: torch.Tensor, first_row: bool) -> torch.Tensor:
    return torch.full_like(d_prev[..., :1], 0.0 if first_row else BIG)


def _row_step(d_prev: torch.Tensor, c_row: torch.Tensor,
              first_row: bool) -> torch.Tensor:
    """One row of the unconstrained DP: D_i [..., U] from D_{i-1} and the
    row's costs (every scan of this module and ``ops/align.py``'s tables
    take this step, so their cells agree bit for bit)."""
    shifted = torch.cat([_start_column(d_prev, first_row), d_prev[..., :-1]], dim=-1)
    return _minplus_scan(torch.minimum(d_prev, shifted) + c_row, c_row)


def _itakura_row_step(d_prev: torch.Tensor, n_prev: torch.Tensor,
                      c_row: torch.Tensor, first_row: bool):
    """One row of the Itakura DP -> (D_i, N_i):

        N_i = c_i + min(shift1(D_{i-1}), shift2(D_{i-1}))
        D_i = min(N_i, c_i + N_{i-1})"""
    u = d_prev.shape[-1]
    s1 = torch.cat([_start_column(d_prev, first_row), d_prev[..., :-1]], dim=-1)
    s2 = torch.cat([torch.full_like(d_prev[..., :2], BIG), d_prev[..., :-2]],
                   dim=-1)[..., :u]
    n_row = c_row + torch.minimum(s1, s2)
    return torch.minimum(n_row, c_row + n_prev), n_row


def _one_len(n, like: torch.Tensor) -> torch.Tensor:
    """A length (int or tensor) as the [1] int64 tensor of one pair."""
    return torch.as_tensor(n, device=like.device).reshape(1).to(torch.int64)


def _read_answer(d_row: torch.Tensor, len_b: torch.Tensor) -> torch.Tensor:
    col = torch.clamp(len_b.to(torch.int64) - 1, min=0)[..., None]
    return torch.take_along_dim(d_row, col, dim=-1)[..., 0]


def dtw_from_cost(cost: torch.Tensor, len_a: torch.Tensor,
                  len_b: torch.Tensor) -> torch.Tensor:
    """DP over masked costs [..., T, U] -> normalised distances [...].

    ``cost`` must already be BIG at masked cells.  Rows >= len_a are
    never read."""
    t = cost.shape[-2]
    d_prev = torch.full_like(cost[..., 0, :], BIG)
    acc = torch.zeros_like(cost[..., 0, 0])
    for i in range(t):
        d_prev = _row_step(d_prev, cost[..., i, :], i == 0)
        acc = torch.where(len_a == i + 1, _read_answer(d_prev, len_b), acc)
    return acc / (len_a + len_b).to(cost.dtype)


def dtw_from_cost_itakura(cost: torch.Tensor, len_a: torch.Tensor,
                          len_b: torch.Tensor) -> torch.Tensor:
    """Itakura slope-constrained DP over masked costs [..., T, U].

    Steps {(1,0),(1,1),(1,2)}, no two consecutive (1,0)
    (:func:`_itakura_row_step`); each row is elementwise work on the
    previous row."""
    t = cost.shape[-2]
    d_prev = torch.full_like(cost[..., 0, :], BIG)
    n_prev = torch.full_like(d_prev, BIG)
    acc = torch.zeros_like(cost[..., 0, 0])
    for i in range(t):
        d_prev, n_prev = _itakura_row_step(d_prev, n_prev, cost[..., i, :], i == 0)
        acc = torch.where(len_a == i + 1, _read_answer(d_prev, len_b), acc)
    return acc / (len_a + len_b).to(cost.dtype)


def band_r2(len_a: torch.Tensor, len_b: torch.Tensor,
            band_frac: float) -> torch.Tensor:
    """Integer Sakoe-Chiba threshold: in-band iff |j*lam1 - i*lbm1| <= r2.

    The band |j - i*(lb-1)/(la-1)| <= radius is evaluated in the integer
    domain (multiplied through by la-1); every implementation computes
    the same boundary cells from the same f32 multiply + floor.
    """
    lam1 = torch.clamp(len_a - 1, min=1)
    frac = torch.tensor(np.float32(band_frac), device=len_a.device)
    radius = torch.clamp(frac * torch.maximum(len_a, len_b).to(torch.float32),
                         min=1.0)
    return torch.floor(radius * lam1.to(torch.float32)).to(torch.int32)


def window_offsets(t: int, u: int, len_a: torch.Tensor, len_b: torch.Tensor,
                   r2: torch.Tensor, cfg: DtwConfig):
    """Per-row-block window starts of the banded window schedule.

    The integer recursion of the JAX package (and of the CUDA kernel):
    off quantised to 8, -8 slack, right edge clipped to len_b, advance
    clamped to S_MAX per block.  Lengths broadcast to a shape P; returns
    (offs [*P, nb], w, row_block), or None when the window is the full row.
    """
    w, s_max, _, rb, _ = plan_window(cfg.band_frac, t, u, cfg.max_warp_scale)
    if w >= round_up(u, LANE):
        return None
    lam1 = torch.clamp(len_a - 1, min=1).to(torch.int32)[..., None]
    lbm1 = (len_b - 1).to(torch.int32)[..., None]
    r2 = r2[..., None]
    nb = -(-t // rb)
    i0 = torch.arange(nb, dtype=torch.int32, device=len_a.device) * rb
    num = torch.clamp(i0 * lbm1 - r2, min=0)
    jlo = torch.div(num + lam1 - 1, lam1, rounding_mode="floor")
    off_raw = torch.clamp(torch.div(jlo, 8, rounding_mode="floor") * 8 - 8,
                          min=0)
    clip8 = torch.div(torch.clamp(len_b[..., None].to(torch.int32) - w, min=0)
                      + 7, 8, rounding_mode="floor") * 8
    off_raw = torch.minimum(off_raw, clip8)
    offs = []
    prev = torch.zeros_like(off_raw[..., 0])
    for blk in range(nb):
        prev = torch.minimum(off_raw[..., blk], prev + s_max)
        offs.append(prev)
    return torch.stack(offs, dim=-1), w, rb


def window_valid(t: int, u: int, len_a: torch.Tensor, len_b: torch.Tensor,
                 r2: torch.Tensor, cfg: DtwConfig) -> torch.Tensor:
    """[*P, t, u] bool: cell inside the banded window schedule (True
    everywhere if the schedule is disabled or the window is the full row)."""
    shape = torch.broadcast_shapes(len_a.shape, len_b.shape)
    plan = (None if cfg.max_warp_scale is None
            else window_offsets(t, u, len_a, len_b, r2, cfg))
    if plan is None:
        return torch.ones(*shape, t, u, dtype=torch.bool, device=len_a.device)
    offs, w, rb = plan
    rows = torch.arange(t, device=len_a.device) // rb
    off_i = offs[..., rows][..., None]                        # [*P, t, 1]
    j = torch.arange(u, dtype=torch.int32, device=len_a.device)
    return (j >= off_i) & (j < off_i + w)


def _mask_cost(sq: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               cfg: DtwConfig, window_mask: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Squared costs [*P, T, U] + lengths broadcastable to P -> local cost
    (sqrt unless ``cfg.squared``) with BIG at cells outside the lengths,
    the integer band and the window schedule.

    ``window_mask`` [*P, T, U] (True = inside) replaces the window
    schedule: the bidirectional scan hands each half-depth pass its slice
    of the full problem's schedule, which a schedule planned from the
    half's own row count would narrow."""
    cost = sq if cfg.squared else torch.sqrt(sq)
    t, u = cost.shape[-2:]
    dev = cost.device
    la, lb = la.to(torch.int32), lb.to(torch.int32)
    j = torch.arange(u, dtype=torch.int32, device=dev)
    invalid = (j >= lb[..., None, None]).expand(cost.shape)
    if cfg.band_frac is not None:
        i = torch.arange(t, dtype=torch.int32, device=dev)[:, None]
        lam1 = torch.clamp(la - 1, min=1)[..., None, None]
        lbm1 = (lb - 1)[..., None, None]
        r2 = band_r2(la, lb, cfg.band_frac)                   # [*P]
        invalid = invalid | (torch.abs(j * lam1 - i * lbm1) > r2[..., None, None])
        if window_mask is None:
            window_mask = window_valid(t, u, la, lb, r2, cfg)
        invalid = invalid | ~window_mask
    return torch.where(invalid, torch.full_like(cost, BIG), cost)


def masked_cost(queries: torch.Tensor, q_lens: torch.Tensor,
                bank: torch.Tensor, bank_lens: torch.Tensor,
                cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """All-pairs local cost [B, K, T, U] with length, band and window masks."""
    return _mask_cost(pairwise_sq_cost(queries[:, None], bank[None]),
                      q_lens[:, None], bank_lens[None, :], cfg)


def masked_cost_pairs(a: torch.Tensor, len_a: torch.Tensor,
                      b: torch.Tensor, len_b: torch.Tensor,
                      cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """Paired local cost: a [P,T,F] x b [P,U,F] -> [P,T,U], pair p of
    a[p] against b[p], with the masks of :func:`masked_cost`."""
    return _mask_cost(pairwise_sq_cost(a, b), len_a, len_b, cfg)


def _dp_for(cfg: DtwConfig):
    if cfg.slope not in (None, "itakura"):
        raise ValueError(f"unknown DtwConfig.slope {cfg.slope!r}")
    return dtw_from_cost_itakura if cfg.slope == "itakura" else dtw_from_cost


def dtw_batch(queries: torch.Tensor, q_lens: torch.Tensor,
              bank: torch.Tensor, bank_lens: torch.Tensor,
              cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """All-pairs DTW: queries [B,T,F] x bank [K,U,F] -> distances [B,K].

    Queries run in chunks so that at most ``_MAX_COST_CELLS`` cost cells
    exist at once; chunking changes no result."""
    dp = _dp_for(cfg)
    b, t, _ = queries.shape
    k, u, _ = bank.shape
    step = max(1, _MAX_COST_CELLS // max(1, k * t * u))
    outs = []
    for lo in range(0, b, step):
        ql = q_lens[lo:lo + step]
        cost = masked_cost(queries[lo:lo + step], ql, bank, bank_lens, cfg)
        outs.append(dp(cost, ql[:, None].to(torch.int64),
                       bank_lens[None, :].to(torch.int64)))
    return torch.cat(outs, dim=0)


def dtw_distance(a: torch.Tensor, b: torch.Tensor,
                 len_a: torch.Tensor | int | None = None,
                 len_b: torch.Tensor | int | None = None,
                 cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """DTW distance between a [T,F] and b [U,F] (padded, with true
    lengths; default the whole sequences) -> scalar tensor: one pair of
    :func:`dtw_batch`, through the same masked cost and row DP."""
    la = _one_len(a.shape[0] if len_a is None else len_a, a)
    lb = _one_len(b.shape[0] if len_b is None else len_b, a)
    cost = masked_cost_pairs(a[None], la, b[None], lb, cfg)
    return _dp_for(cfg)(cost, la, lb)[0]


def dtw_pairs_scan(a: torch.Tensor, len_a: torch.Tensor,
                   b: torch.Tensor, len_b: torch.Tensor,
                   cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """Paired DTW: a [P,T,F] vs b [P,U,F] -> distances [P] (the JAX
    package's ``dtw_distance`` per pair), in chunks of at most
    ``_MAX_COST_CELLS`` cost cells."""
    dp = _dp_for(cfg)
    p, t, _ = a.shape
    step = max(1, _MAX_COST_CELLS // max(1, t * b.shape[1]))
    outs = [torch.zeros((0,), dtype=a.dtype, device=a.device)]
    for lo in range(0, p, step):
        la, lb = len_a[lo:lo + step], len_b[lo:lo + step]
        cost = masked_cost_pairs(a[lo:lo + step], la, b[lo:lo + step], lb, cfg)
        outs.append(dp(cost, la.to(torch.int64), lb.to(torch.int64)))
    return torch.cat(outs, dim=0)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, T, ...] gathered along axis 1 at per-row indices idx [N, R]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _bidi_chunk(queries, q_lens, bank, bank_lens, cfg: DtwConfig):
    """All-pairs bidirectional DTW of one query chunk -> [B, K]."""
    b, t, _ = queries.shape
    k, u, _ = bank.shape
    dev = queries.device
    la, lb = q_lens.to(torch.int64), bank_lens.to(torch.int64)
    n_rows = t // 2 + 1
    idx_n = torch.arange(n_rows, device=dev)
    idx_u = torch.arange(u, device=dev)
    m_f = torch.div(la, 2, rounding_mode="floor")
    m_r = la - 1 - m_f                              # reversed row index of m_f
    rows_r = torch.clamp(la[:, None] - 1 - idx_n, 0, t - 1)          # [B, n_rows]
    cols_r = torch.clamp(lb[:, None] - 1 - idx_u, 0, u - 1)          # [K, U]
    a_r = _take_rows(queries, rows_r)
    b_rev = _take_rows(bank, cols_r)
    la2, lb2 = la[:, None], lb[None, :]
    # The rhombus band is point-symmetric under (i, j) -> (la-1-i, lb-1-j),
    # so each half evaluates it in its own coordinates; the quantised
    # window schedule is planned over the full row count and handed to
    # the forward half as its row prefix, to the backward half reflected.
    wv_f = wv_b = None
    if cfg.band_frac is not None and cfg.max_warp_scale is not None:
        wv = window_valid(t, u, la2, lb2, band_r2(la2, lb2, cfg.band_frac), cfg)
        wv_f = wv[..., :n_rows, :]
        wv_b = wv[torch.arange(b, device=dev)[:, None, None, None],
                  torch.arange(k, device=dev)[None, :, None, None],
                  rows_r[:, None, :, None], cols_r[None, :, None, :]]
    cost_f = _mask_cost(pairwise_sq_cost(queries[:, None, :n_rows], bank[None]),
                        la2, lb2, cfg, wv_f)                        # [B, K, n_rows, U]
    cost_b = _mask_cost(pairwise_sq_cost(a_r[:, None], b_rev[None]),
                        la2, lb2, cfg, wv_b)
    cost2 = torch.stack([cost_f, cost_b], dim=-2)                   # [B, K, n_rows, 2, U]
    m2 = torch.stack([m_f, m_r], dim=-1)[:, None, :, None]          # [B, 1, 2, 1]
    d_prev = torch.full_like(cost2[..., 0, :, :], BIG)
    kept = torch.full_like(d_prev, BIG)
    for i in range(n_rows):
        d_prev = _row_step(d_prev, cost2[..., i, :, :], i == 0)
        kept = torch.where(m2 == i, d_prev, kept)
    f_row = kept[..., 0, :]
    # align the backward row: B[m_f, j] = F_rev[m_r, lb-1-j]
    b_row = torch.take_along_dim(kept[..., 1, :], cols_r[None], dim=-1)
    m_row = torch.clamp(m_f, 0, n_rows - 1)[:, None, None, None].expand(b, k, 1, u)
    c_row = torch.take_along_dim(cost_f, m_row, dim=-2)[..., 0, :]
    comb = f_row + b_row - c_row
    # columns >= lb hold BIG + finite - BIG == 0 in float32: mask them out
    total = torch.where(idx_u < lb[None, :, None], comb,
                        torch.full_like(comb, BIG)).amin(dim=-1)
    return total / (la2 + lb2).to(queries.dtype)


def dtw_batch_bidi(queries: torch.Tensor, q_lens: torch.Tensor,
                   bank: torch.Tensor, bank_lens: torch.Tensor,
                   cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """All-pairs DTW by bidirectional (Hirschberg-split) row scans ->
    [B, K], the same function as :func:`dtw_batch`.

    Every monotone warp path visits row m = len_a // 2, so
    D = min_j (F[m, j] + B[m, j] - cost[m, j]) with F the forward DP into
    (m, j) and B the backward DP from it (a forward DP on the reversed
    sequences).  Both half-depth scans run stacked in one row loop of
    T // 2 + 1 rows.  A measured-negative path in the JAX package that no
    default reaches; queries run in chunks of at most ``_MAX_COST_CELLS``
    cost cells."""
    if cfg.slope is not None:
        # the F+B merge at the split row cannot see the vertical-step
        # flag across the seam (two (1,0) steps could meet there)
        raise ValueError("dtw_batch_bidi does not support cfg.slope")
    b, t, _ = queries.shape
    k, u, _ = bank.shape
    step = max(1, _MAX_COST_CELLS // max(1, 2 * k * (t // 2 + 1) * u))
    return torch.cat([_bidi_chunk(queries[lo:lo + step], q_lens[lo:lo + step],
                                  bank, bank_lens, cfg)
                      for lo in range(0, b, step)]
                     + [queries.new_zeros((0, k))], dim=0)


def dtw_distance_bidi(a: torch.Tensor, b: torch.Tensor,
                      len_a: torch.Tensor | int, len_b: torch.Tensor | int,
                      cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """Bidirectional DTW of one pair a [T,F] vs b [U,F] -> scalar tensor."""
    return dtw_batch_bidi(a[None], _one_len(len_a, a), b[None], _one_len(len_b, a),
                          cfg)[0, 0]
