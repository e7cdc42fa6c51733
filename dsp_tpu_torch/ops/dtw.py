"""Plain DTW in PyTorch (port of ``dsp_tpu/ops/dtw.py``): all pairs
(:func:`dtw_batch`) and paired (:func:`dtw_pairs_scan`).

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
        c_row = cost[..., i, :]
        shifted = torch.cat([_start_column(d_prev, i == 0), d_prev[..., :-1]],
                            dim=-1)
        a = torch.minimum(d_prev, shifted) + c_row
        d_prev = _minplus_scan(a, c_row)
        acc = torch.where(len_a == i + 1, _read_answer(d_prev, len_b), acc)
    return acc / (len_a + len_b).to(cost.dtype)


def dtw_from_cost_itakura(cost: torch.Tensor, len_a: torch.Tensor,
                          len_b: torch.Tensor) -> torch.Tensor:
    """Itakura slope-constrained DP over masked costs [..., T, U].

    Steps {(1,0),(1,1),(1,2)}, no two consecutive (1,0):

        N_i = c_i + min(shift1(D_{i-1}), shift2(D_{i-1}))
        D_i = min(N_i, c_i + N_{i-1})

    Each row is elementwise work on the previous row."""
    t, u = cost.shape[-2:]
    d_prev = torch.full_like(cost[..., 0, :], BIG)
    n_prev = torch.full_like(d_prev, BIG)
    acc = torch.zeros_like(cost[..., 0, 0])
    big2 = torch.full_like(d_prev[..., :2], BIG)
    for i in range(t):
        c_row = cost[..., i, :]
        s1 = torch.cat([_start_column(d_prev, i == 0), d_prev[..., :-1]], dim=-1)
        s2 = torch.cat([big2, d_prev[..., :-2]], dim=-1)[..., :u]
        n_row = c_row + torch.minimum(s1, s2)
        d_prev = torch.minimum(n_row, c_row + n_prev)
        n_prev = n_row
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
               cfg: DtwConfig) -> torch.Tensor:
    """Squared costs [*P, T, U] + lengths broadcastable to P -> local cost
    (sqrt unless ``cfg.squared``) with BIG at cells outside the lengths,
    the integer band and the window schedule."""
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
        invalid = invalid | ~window_valid(t, u, la, lb, r2, cfg)
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
