"""All-pairs windowed-banded DTW: CUDA kernel wrapper and its plain version.

Port of ``dsp_tpu/kernels/dtw_fused_banded.py:dtw_batch_fused_banded``.
The kernel (``csrc/dtw_banded.cu``) runs one warp per (query, template)
pair over strips of 32 rows, walking only the columns of
:func:`strip_columns` and computing only the costs of :func:`cost_tiles`;
its header says what it computes and what bounds it.

:func:`dtw_batch_fused_banded` takes CUDA tensors to the kernel and CPU
tensors to :func:`dtw_batch_plain` (``ops/dtw.py:dtw_batch``, the same
windowed-band semantics); it never falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels.dtw_fused import resident_warps
from dsp_tpu_torch.ops import dtw as tdtw
from dsp_tpu_torch.utils import profiling
from dsp_tpu_torch.window_plan import LANE, plan_window, round_up

STRIP = 32      # rows a warp walks together, one a lane
MAX_WARPS = 16  # warps a block, each taking the block's queries one at a time
TILE_SIDE = 4   # a cost tile: 4 rows x 4 columns, one lane's at a time
RING = 64       # cost columns a warp keeps a row: the blocks of two chunks
SMEM_OPTIN = 232_448   # shared memory a block may use on the H100 (227 KB)
SM_COUNT = 132         # SMs of the H100 (SXM5)
PAIRS_A_WARP = 8       # the most queries a block takes a warp


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


def cost_tiles(la: int, lb: int, cfg: DtwConfig, t_pad: int, u_pad: int):
    """The cost tiles the kernel computes for pair (la, lb) at padded shape
    (t_pad, u_pad): a list of (i0, j0), each the tile of rows i0 .. i0 + 3
    and columns j0 .. j0 + 3.  In each strip of :func:`strip_columns`
    (rows r0 .., columns jlo ..), tile row t holds rows r0 + 4t .. + 3 of
    the strip, and its tiles start at columns jlo + 4k: those that meet a
    row's valid interval (the kernel walks the tiles from its first row's
    lo to its last row's hi and skips the others).  Cells past the lengths
    inside a tile are computed and never read."""
    rows = _row_columns(la, lb, cfg, t_pad, u_pad)
    tiles = []
    for r0, r1, jlo, _ in strip_columns(la, lb, cfg, t_pad, u_pad):
        for i0 in range(r0, r1 + 1, TILE_SIDE):
            ks = {k for lo, hi in rows[i0:min(i0 + TILE_SIDE, r1 + 1)] if lo <= hi
                  for k in range((lo - jlo) // TILE_SIDE, (hi - jlo) // TILE_SIDE + 1)}
            tiles += [(i0, jlo + TILE_SIDE * k) for k in sorted(ks)]
    return tiles


def _feature_stride(f_dim: int) -> int:
    return f_dim | 1


def smem_bytes(warps: int, t_pad: int, u_pad: int, f_dim: int, rb: int,
               itakura: bool, window: bool) -> int:
    """Shared memory of one block, as ``csrc/dtw_banded.cu`` sizes it: the
    whole template (staged mode; none in window mode), a warp's cost ring,
    query strip, staged row, edge row and window offsets, and the block's
    next query."""
    ns, fs = (2 if itakura else 1), _feature_stride(f_dim)
    per_warp = STRIP * RING + STRIP * fs + ns * STRIP + ns * u_pad + -(-t_pad // rb)
    return 4 * ((0 if window else u_pad * fs) + warps * per_warp + 1)


def launch_plan(n_queries: int, t_pad: int, u_pad: int, f_dim: int, rb: int,
                itakura: bool, optin: int = SMEM_OPTIN) -> tuple[bool, int, int]:
    """(window mode, warps a block, shared bytes) of a launch, which the
    wrapper hands to ``csrc/dtw_banded.cu:dtw_banded``: window mode where
    the whole template does not fit a one-warp block; then, of the block
    sizes up to :data:`MAX_WARPS` that fit ``optin`` and that the queries
    fill, the one that keeps most warps on an SM
    (``dtw_fused.resident_warps``: this kernel too takes 128 registers a
    thread), the larger on a tie.  The launch fails where even one warp
    exceeds ``optin``."""
    window = smem_bytes(1, t_pad, u_pad, f_dim, rb, itakura, False) > optin

    def smem(warps):
        return smem_bytes(warps, t_pad, u_pad, f_dim, rb, itakura, window)

    top = min(MAX_WARPS, max(1, n_queries))
    fits = [w for w in range(1, top + 1) if smem(w) <= optin] or [1]
    warps = max(fits, key=lambda w: (resident_warps(w, smem(w)), w))
    return window, warps, smem(warps)


def queries_a_block(n_queries: int, n_templates: int, warps: int, smem: int) -> int:
    """Queries a block of ``warps`` warps and ``smem`` shared bytes takes
    (its warps take them one at a time): :data:`PAIRS_A_WARP` a warp where
    the launch's pairs keep every warp the card holds on 4 or more, fewer
    down to one a warp where they do not, spread evenly over a template's
    blocks.  (A block past what an SM holds counts as one, so that its
    launch reaches the kernel's entry and fails there.)"""
    held = SM_COUNT * max(1, resident_warps(warps, smem))
    per_warp = max(1, min(PAIRS_A_WARP, n_queries * n_templates // (4 * held)))
    blocks = -(-n_queries // (warps * per_warp))
    return -(-n_queries // blocks)


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
    T=198: U up to 1,369 frames, 1,335 with the Itakura slope); longer
    templates run in the kernel's window mode, where the cost tiles read
    the template from device memory and a warp's edge row of U floats (two
    with Itakura) bounds U: at F=39, T=198 and band 0.17 up to 54,770
    frames (27,372 with Itakura), :func:`max_template_frames` for other
    shapes.  Beyond that the launch fails and this raises RuntimeError.
    Any number of queries runs, in launches of at most 65,535, each
    counted in ``utils.profiling`` as ``dtw_banded.tiled`` (staged mode)
    or ``dtw_banded.window``.
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
    itakura = cfg.slope == "itakura"
    for lo, hi in _build.row_slices(b):
        window, warps, smem = launch_plan(hi - lo, t, u, f, rb, itakura)
        per_block = queries_a_block(hi - lo, k, warps, smem)
        _build.launch("dtw_banded", dev, queries[lo].data_ptr(), q_lens[lo].data_ptr(),
                      bank.data_ptr(), bank_lens.data_ptr(), out[lo].data_ptr(), hi - lo,
                      k, t, u, f, w, s_max, rb, int(banded), int(windowed),
                      float(np.float32(cfg.band_frac)) if banded else 0.0,
                      int(cfg.squared), int(itakura), int(window),
                      min(warps, per_block), per_block)
        profiling.count("dtw_banded.window" if window else "dtw_banded.tiled")
    return out
