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
MAX_WARPS = 8   # pairs a block, one warp each
WINDOW_ROWS = 2 * STRIP - 1   # template rows a chunk of 32 steps reads
QF = 40         # features summed at a time: the template row stride's unit
SMEM_OPTIN = 232_448   # shared memory a block may use on the H100 (227 KB)


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


def valid_cells(la: int, lb: int, cfg: DtwConfig, t_pad: int, u_pad: int) -> int:
    """Cells of pair (la, lb) inside its length, band and window: the DP's
    work (``ops/dtw.py:masked_cost``'s valid cells in rows < la)."""
    return sum(max(0, hi - lo + 1) for lo, hi in _row_columns(la, lb, cfg, t_pad, u_pad))


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


def _feature_stride(f_dim: int) -> int:
    return (-(-f_dim // QF) * QF) | 1


def smem_bytes(warps: int, t_pad: int, u_pad: int, f_dim: int, rb: int,
               itakura: bool, window: bool) -> int:
    """Shared memory of one block, as ``csrc/dtw_banded.cu`` sizes it: the
    whole template (staged mode) or a window of 63 template rows a warp
    (window mode), and a warp's cost tile, staged row, edge row and window
    offsets."""
    ns, fs = (2 if itakura else 1), _feature_stride(f_dim)
    per_warp = (STRIP * (STRIP + 1) + ns * STRIP + ns * u_pad + -(-t_pad // rb)
                + (WINDOW_ROWS * fs if window else 0))
    return 4 * ((0 if window else u_pad * fs) + warps * per_warp)


def launch_plan(n_queries: int, t_pad: int, u_pad: int, f_dim: int, rb: int,
                itakura: bool, optin: int = SMEM_OPTIN) -> tuple[bool, int, int]:
    """(window mode, warps a block, shared bytes) of a launch, the rule of
    ``csrc/dtw_banded.cu:dtw_banded``: no more warps than queries need;
    window mode where the whole template does not fit a one-warp block;
    half the warps while the block does not fit.  The launch fails where
    the bytes still exceed ``optin``."""
    warps = MAX_WARPS
    while warps > 1 and warps // 2 >= n_queries:
        warps //= 2
    window = smem_bytes(1, t_pad, u_pad, f_dim, rb, itakura, False) > optin
    while warps > 1 and smem_bytes(warps, t_pad, u_pad, f_dim, rb, itakura, window) > optin:
        warps //= 2
    return window, warps, smem_bytes(warps, t_pad, u_pad, f_dim, rb, itakura, window)


def config_plan(n_queries: int, t_pad: int, u_pad: int, f_dim: int,
                cfg: DtwConfig) -> tuple[bool, int, int]:
    """:func:`launch_plan` of a launch under ``cfg`` (its row block and slope)."""
    return launch_plan(n_queries, t_pad, u_pad, f_dim, _window(cfg, t_pad, u_pad)[2],
                       cfg.slope == "itakura")


def max_template_frames(t_pad: int, f_dim: int, cfg: DtwConfig,
                        optin: int = SMEM_OPTIN) -> int:
    """The longest template (frames) the kernel takes against queries of
    ``t_pad`` frames: the largest U whose one-warp launch fits ``optin``."""
    def fits(u):
        rb = _window(cfg, t_pad, u)[2]
        return launch_plan(1, t_pad, u, f_dim, rb, cfg.slope == "itakura", optin)[2] <= optin

    lo, hi = 1, optin // 4     # fits(lo); not fits(hi): the edge row alone is u floats
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


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
    memory (at most 227 KB) where it fits a one-warp block (at F=39 and
    T=198: U up to 1,357 frames, 1,325 with the Itakura slope); longer
    templates run in the kernel's window mode, where a warp stages the 63
    template rows a chunk reads and its edge row of U floats (two with
    Itakura) bounds U: at F=39, T=198 and band 0.17 up to 54,428 frames
    (27,201 with Itakura), :func:`max_template_frames` for other shapes.
    Beyond that the launch fails and this raises RuntimeError.  Any number
    of queries runs, in launches of at most 65,535.
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
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    w, s_max, rb, banded, windowed = _window(cfg, t, u)
    for lo, hi in _build.row_slices(b):
        _build.launch("dtw_banded", dev, queries[lo].data_ptr(), q_lens[lo].data_ptr(),
                      bank.data_ptr(), bank_lens.data_ptr(), out[lo].data_ptr(), hi - lo,
                      k, t, u, f, w, s_max, rb, int(banded), int(windowed),
                      float(np.float32(cfg.band_frac)) if banded else 0.0,
                      int(cfg.squared), int(cfg.slope == "itakura"))
    return out
