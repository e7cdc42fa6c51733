"""All-pairs windowed-banded DTW: CUDA kernel wrapper and its plain version.

Port of ``dsp_tpu/kernels/dtw_fused_banded.py:dtw_batch_fused_banded``.
The kernel (``csrc/dtw_banded.cu``) runs one warp per (query, template)
pair over strips of 32 rows, walking only the columns of
:func:`strip_columns`; its header says what it computes and what bounds it.

:func:`dtw_batch_fused_banded` takes CUDA tensors to the kernel and CPU
tensors to :func:`dtw_batch_plain` (``ops/dtw.py:dtw_batch``, the same
windowed-band semantics); it never falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.ops import dtw as tdtw
from dsp_tpu_torch.window_plan import LANE, plan_window, round_up

STRIP = 32      # rows a warp walks together, one a lane


def _check_config(cfg: DtwConfig) -> None:
    if cfg.slope not in (None, "itakura"):
        raise ValueError(f"unknown DtwConfig.slope {cfg.slope!r}")
    if cfg.band_frac is not None and cfg.max_warp_scale is None:
        raise ValueError(
            "the fused banded kernel implements the windowed band "
            "(DtwConfig.max_warp_scale set); use impl='scan' for the "
            "pure unbounded-slope band")


def _window(cfg: DtwConfig, t_pad: int, u_pad: int):
    """(w, s_max, rb, banded, windowed) as the wrapper passes them."""
    w, s_max, _, rb, _ = plan_window(cfg.band_frac, t_pad, u_pad, cfg.max_warp_scale)
    banded = cfg.band_frac is not None
    return w, s_max, rb, banded, banded and w < round_up(u_pad, LANE)


def _row_columns(la: int, lb: int, cfg: DtwConfig, t_pad: int, u_pad: int):
    """Valid columns (lo, hi) of each row i < la of pair (la, lb), as the
    kernel's ``Pair::row`` computes them (empty: lo > hi).  Lengths are
    clamped to [1, t_pad] and [1, u_pad], as the kernel clamps them."""
    la, lb = min(max(la, 1), t_pad), min(max(lb, 1), u_pad)
    w, s_max, rb, banded, windowed = _window(cfg, t_pad, u_pad)
    lam1, lbm1, r2 = max(la - 1, 1), lb - 1, 0
    if banded:    # f32 multiply + floor, as ops/dtw.py:band_r2
        radius = max(np.float32(1.0), np.float32(cfg.band_frac) * np.float32(max(la, lb)))
        r2 = int(np.floor(np.float32(radius) * np.float32(lam1)))
    offs, prev = [], 0
    clip8 = (max(lb - w, 0) + 7) // 8 * 8
    for blk in range(-(-t_pad // rb) if windowed else 0):
        jlo = (max(blk * rb * lbm1 - r2, 0) + lam1 - 1) // lam1
        prev = min(max(jlo // 8 * 8 - 8, 0), clip8, prev + s_max)
        offs.append(prev)
    rows = []
    for i in range(la):
        lo, hi = 0, lb - 1
        if banded:
            num = i * lbm1 - r2
            if num > 0:
                lo = (num + lam1 - 1) // lam1
            hi = min(hi, (i * lbm1 + r2) // lam1)
        if windowed:
            off = offs[i // rb]
            lo, hi = max(lo, off), min(hi, off + w - 1)
        rows.append((lo, hi))
    return rows


def strip_columns(la: int, lb: int, cfg: DtwConfig, t_pad: int, u_pad: int):
    """The columns the kernel walks for pair (la, lb) at padded shape
    (t_pad, u_pad): a list of (r0, r1, jlo, jhi), one per strip of rows
    r0..r1 (at most :data:`STRIP`), each walking columns jlo..jhi for every
    row.  A row's valid columns form one interval whose ends never decrease
    down the rows, so jlo is the first row's start and jhi the last row's
    end.  The walk stops before a strip with no valid cell: every later
    cell is unreachable."""
    rows = _row_columns(la, lb, cfg, t_pad, u_pad)
    strips = []
    for r0 in range(0, len(rows), STRIP):
        r1 = min(r0 + STRIP, len(rows)) - 1
        jlo, jhi = rows[r0][0], rows[r1][1]
        if jhi < jlo:
            break
        strips.append((r0, r1, jlo, jhi))
    return strips


def dtw_batch_plain(queries: torch.Tensor, q_lens: torch.Tensor,
                    bank: torch.Tensor, bank_lens: torch.Tensor,
                    cfg: DtwConfig = DtwConfig(band_frac=0.1)) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B,T,F] x [K,U,F] -> [B,K]."""
    _check_config(cfg)
    return tdtw.dtw_batch(queries, q_lens, bank, bank_lens, cfg)


def dtw_batch_fused_banded(queries: torch.Tensor, q_lens: torch.Tensor,
                           bank: torch.Tensor, bank_lens: torch.Tensor,
                           cfg: DtwConfig = DtwConfig(band_frac=0.1)) -> torch.Tensor:
    """All-pairs (windowed-)banded DTW: [B,T,F] x [K,U,F] -> [B,K] float32.

    ``q_lens`` [B] and ``bank_lens`` [K] are int32 true lengths.  With
    ``band_frac=None`` the result is plain unbanded DTW.  Pairs that are
    unreachable come out >= 1e20.  A block stages one template in shared
    memory (at most 227 KB), so at F=39 and T=198 the kernel takes U up
    to 1,357 frames (1,325 with the Itakura slope); T costs only 4 bytes
    a 16-32 rows.  Beyond that the launch fails and this raises.
    """
    _check_config(cfg)
    if queries.device.type == "cpu":
        return dtw_batch_plain(queries, q_lens, bank, bank_lens, cfg)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    dev = queries.device
    for name, x, dtype, ndim in (("queries", queries, torch.float32, 3),
                                 ("bank", bank, torch.float32, 3),
                                 ("q_lens", q_lens, torch.int32, 1),
                                 ("bank_lens", bank_lens, torch.int32, 1)):
        if x.device != dev or x.dtype != dtype or x.dim() != ndim:
            raise ValueError(f"{name}: want {dtype} with {ndim} dims on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, t, f = queries.shape
    k, u, f2 = bank.shape
    if f2 != f or q_lens.shape[0] != b or bank_lens.shape[0] != k:
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"bank {tuple(bank.shape)}, q_lens "
                         f"{tuple(q_lens.shape)}, bank_lens {tuple(bank_lens.shape)}")
    if b > 65535:
        raise ValueError(f"at most 65535 queries per launch, got {b}")
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0 or k == 0:
        return out
    w, s_max, rb, banded, windowed = _window(cfg, t, u)
    _build.launch("dtw_banded", dev, queries.data_ptr(), q_lens.data_ptr(),
                  bank.data_ptr(), bank_lens.data_ptr(), out.data_ptr(), b, k, t,
                  u, f, w, s_max, rb, int(banded), int(windowed),
                  float(np.float32(cfg.band_frac)) if banded else 0.0,
                  int(cfg.squared), int(cfg.slope == "itakura"))
    return out
