"""Windowed Sakoe-Chiba banded DTW (port of ``dsp_tpu/ops/dtw_banded.py``).

Each row's DP state is a W-wide window that slides along the stretched
diagonal

    o(i) = clip(floor(i * (len_b-1)/(len_a-1)) - W/2, 0, U - W)

so the row scan's width is W, not U.  With W >= 2*radius + 4
(:func:`window_for_band`) the window holds the whole band and the
distances equal the masked full-width scan's (``ops/dtw.py``).  The
window realignment between rows is a gather at per-pair offsets.  A
measured-negative path in the JAX package that no default reaches: on
the card the banded DTW kernel computes the same band (``pipeline.dtw_pairs``).
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.ops.dtw import _MAX_COST_CELLS, BIG, _minplus_scan, _one_len, masked_cost


def window_for_band(band_frac: float, t: int, u: int, lane: int = 128) -> int:
    """Smallest lane-multiple window that contains the Sakoe-Chiba band."""
    radius = max(1.0, band_frac * max(t, u))
    w = int(2 * radius + 4)
    w = -(-w // lane) * lane
    return min(w, -(-u // lane) * lane)


def _windowed_dp(cost: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
                 w: int) -> torch.Tensor:
    """Sliding-window DP over masked costs [*P, T, U] with lengths
    broadcastable to P -> normalised distances [*P]."""
    t, u = cost.shape[-2:]
    dev = cost.device
    scale = (lb - 1).to(torch.float32) / torch.clamp(la - 1, min=1)
    rows = torch.arange(t, device=dev, dtype=torch.float32)
    offsets = torch.clamp((rows * scale[..., None]).to(torch.int64) - w // 2,
                          0, max(u - w, 0))                          # [*P, T]
    idx_w = torch.arange(w, device=dev)
    end_w = (lb - 1)[..., None] - offsets                            # [*P, T]
    d_prev = torch.full(cost.shape[:-2] + (w,), BIG, dtype=cost.dtype, device=dev)
    big_w = torch.full_like(d_prev, BIG)
    acc = torch.zeros_like(d_prev[..., 0])
    o_prev = torch.zeros_like(offsets[..., 0])
    for i in range(t):
        o = offsets[..., i]
        c_win = torch.take_along_dim(cost[..., i, :], o[..., None] + idx_w, dim=-1)
        # realign the previous window: aligned[x] = d_prev[x + delta]
        delta = torch.clamp(o - o_prev, 0, w)[..., None]
        aligned = torch.take_along_dim(torch.cat([d_prev, big_w], dim=-1),
                                       delta + idx_w, dim=-1)
        # the j-1 terms, with the virtual origin at (0, -1)
        start = torch.where((o == 0) & (i == 0), 0.0, BIG).to(cost.dtype)[..., None]
        shifted = torch.cat([start, aligned[..., :-1]], dim=-1)
        d_prev = _minplus_scan(torch.minimum(aligned, shifted) + c_win, c_win)
        hit = (d_prev * (idx_w == end_w[..., i, None]).to(cost.dtype)).sum(dim=-1)
        acc = torch.where(la == i + 1, hit, acc)
        o_prev = o
    return acc / (la + lb).to(cost.dtype)


def dtw_batch_windowed(queries: torch.Tensor, q_lens: torch.Tensor,
                       bank: torch.Tensor, bank_lens: torch.Tensor,
                       window: int = 128,
                       cfg: DtwConfig = DtwConfig(band_frac=0.1)) -> torch.Tensor:
    """All-pairs windowed banded DTW: [B,T,F] x [K,U,F] -> [B, K].

    Requires ``cfg.band_frac`` (the band mask defines the function; the
    window only bounds the scan) and no slope.  Queries run in chunks of
    at most ``_MAX_COST_CELLS`` cost cells."""
    if cfg.band_frac is None:
        raise ValueError("windowed DTW requires DtwConfig.band_frac")
    if cfg.slope is not None:
        raise ValueError("dtw_batch_windowed implements the unconstrained "
                         "step set only; use ops/dtw.py or the banded kernel "
                         "for cfg.slope")
    b, t, _ = queries.shape
    k, u, _ = bank.shape
    w = min(window, u)
    step = max(1, _MAX_COST_CELLS // max(1, k * t * u))
    outs = [queries.new_zeros((0, k))]
    for lo in range(0, b, step):
        ql = q_lens[lo:lo + step].to(torch.int64)
        cost = masked_cost(queries[lo:lo + step], ql, bank, bank_lens, cfg)
        outs.append(_windowed_dp(cost, ql[:, None], bank_lens[None, :].to(torch.int64), w))
    return torch.cat(outs, dim=0)


def dtw_distance_windowed(a: torch.Tensor, b: torch.Tensor,
                          len_a: torch.Tensor | int, len_b: torch.Tensor | int,
                          window: int,
                          cfg: DtwConfig = DtwConfig(band_frac=0.1)) -> torch.Tensor:
    """Windowed banded DTW of one pair a [T,F] vs b [U,F] -> scalar tensor."""
    return dtw_batch_windowed(a[None], _one_len(len_a, a), b[None], _one_len(len_b, a),
                              window, cfg)[0, 0]
