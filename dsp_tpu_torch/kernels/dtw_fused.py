"""Unbanded all-pairs DTW from features: CUDA kernel wrapper and its plain
version.

Port of ``dsp_tpu/kernels/dtw_fused.py:dtw_batch_fused``
(``DtwConfig.impl="fused"``).  Features go in and distances come out; the
cost never reaches device memory.  The kernel (``csrc/dtw_fused.cu``, whose
header says what bounds it) solves the direct min-plus recurrence cell by
cell, one warp a pair over strips of 32 query rows (:func:`strips` states
its walk, :func:`launch_plan` its launch).  The plain version keeps the TPU
kernel's closed form, two scans over the columns a row:

    CS_j = c_0 + ... + c_j
    D_j  = CS_j + min_{l <= j} (m_l - CS_{l-1}),   m_l = min(D_{i-1,l}, D_{i-1,l-1})

with BIG (1e30) at columns >= len_b.  BIG must stay a suffix of the row
so the prefix sums stay finite, which is why the closed form is unbanded
only: a band would put BIG cells inside the row.  CS cancels about 1e-4
in absolute terms on row sums of ~200 costs, so the kernel, its plain
version and the scan agree to rtol 1e-4 / atol 1e-5
(tests/test_pallas_dtw.py:103).

:func:`dtw_batch_fused` takes CUDA tensors to the kernel and CPU tensors
to :func:`dtw_batch_fused_plain`; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.ops import dtw as tdtw

BIG = tdtw.BIG
STRIP = 32          # query rows a warp walks together, one a lane; steps a chunk
COST_GROUP = 8      # template columns whose costs a lane sums side by side
QF = 40             # features summed at a time: the template row stride's unit
RING = 64           # cost columns a lane keeps (this chunk's block and the last)
EDGE_PAD = 64       # BIG columns past the edge row's lb
# the most warps (pairs) a block takes (csrc/dtw_fused.cu allows 8;
# chip_smoke.py times a cap of 4 beside it)
BLOCK_WARPS = 8
SMEM_OPTIN = 232_448   # shared memory a block may use on the H100 (227 KB)
SM_SMEM = 233_472      # shared memory of an SM (228 KB)
SM_WARPS = 16          # warps an SM holds at the kernel's 128 registers a thread
# device memory a window-mode launch takes for its edge rows (256 MB)
WINDOW_SCRATCH_FLOATS = 1 << 26


def _check_config(cfg: DtwConfig) -> None:
    if cfg.band_frac is not None:
        raise ValueError("fused DTW supports unbanded matching only "
                         "(prefix-sum closed form; see module docstring)")
    if cfg.slope is not None:
        raise ValueError("fused DTW does not support cfg.slope; use "
                         "impl='scan' or 'fused_banded'")


def strips(la: int, lb: int, t_pad: int, u_pad: int):
    """The kernel's walk of pair (la, lb) at padded shape (t_pad, u_pad): a
    list of (r0, n_rows, n_steps), one per strip of rows r0 .. r0+n_rows-1.
    Lane l (row r0 + l) is on column s - l at step s of the strip's n_steps
    = lb + n_rows - 1; it computes a cell where 0 <= s - l < lb and l <
    n_rows, and nothing on the rest (the ramp, and lanes past the last row).
    Lengths are clamped to [1, t_pad] and [1, u_pad], as the kernel clamps
    them."""
    la, lb = min(max(la, 1), t_pad), min(max(lb, 1), u_pad)
    return [(r0, min(STRIP, la - r0), lb + min(STRIP, la - r0) - 1)
            for r0 in range(0, la, STRIP)]


def cost_cells(la: int, lb: int, t_pad: int, u_pad: int) -> int:
    """Local costs the kernel computes for pair (la, lb): every lane of a
    strip, against the template's columns in groups of :data:`COST_GROUP`."""
    lb = min(max(lb, 1), u_pad)
    return len(strips(la, lb, t_pad, u_pad)) * STRIP * -(-lb // COST_GROUP) * COST_GROUP


def smem_bytes(warps: int, u_pad: int, f_dim: int, window: bool) -> int:
    """Shared memory of one block, as ``csrc/dtw_fused.cu`` sizes it: the
    template with its |b|^2 up to a whole cost block (staged mode), then a
    warp's 32 template frames of a chunk (window mode), cost ring, staged
    last row and edge row (window mode: 32 columns of it; the row is in
    device memory)."""
    fs = -(-f_dim // QF) * QF
    rows = -(-u_pad // STRIP) * STRIP
    per_warp = ((STRIP * fs + STRIP if window else 0) + RING * STRIP + STRIP
                + (STRIP if window else -(-(u_pad + EDGE_PAD) // 4) * 4))
    staged = 0 if window else rows * fs + rows
    return 4 * (staged + warps * per_warp)


def resident_warps(warps: int, smem: int) -> int:
    """Warps an SM holds of blocks of ``warps`` warps and ``smem`` shared
    bytes: as many blocks as its shared memory takes (each reserving 1 KB
    more), at most :data:`SM_WARPS`."""
    return min(SM_WARPS, warps * (SM_SMEM // (smem + 1024)))


def launch_plan(n_queries: int, u_pad: int, f_dim: int) -> tuple[bool, int, int]:
    """(window mode, warps a block, shared bytes) of a launch: window mode
    where the whole template does not fit a one-warp block; then, of the
    block sizes up to :data:`BLOCK_WARPS` that fit and that the queries
    fill, the one that keeps most warps on an SM (:func:`resident_warps`),
    the larger on a tie."""
    top = min(BLOCK_WARPS, max(1, n_queries))
    window = smem_bytes(1, u_pad, f_dim, False) > SMEM_OPTIN
    fits = [w for w in range(1, top + 1)
            if smem_bytes(w, u_pad, f_dim, window) <= SMEM_OPTIN] or [1]
    warps = max(fits, key=lambda w: (resident_warps(w, smem_bytes(w, u_pad, f_dim, window)), w))
    return window, warps, smem_bytes(warps, u_pad, f_dim, window)


def window_rows(n_templates: int, u_pad: int) -> int:
    """Queries a window-mode launch takes: as many as keep its edge rows
    (one of ``u_pad`` floats a pair, in device memory) within
    :data:`WINDOW_SCRATCH_FLOATS`, at least one, at most a grid's rows."""
    return max(1, min(_build.MAX_GRID_ROWS,
                      WINDOW_SCRATCH_FLOATS // max(1, n_templates * u_pad)))


def _closed_form(queries: torch.Tensor, q_lens: torch.Tensor,
                 bank: torch.Tensor, bank_lens: torch.Tensor,
                 squared: bool) -> torch.Tensor:
    sq = tdtw.pairwise_sq_cost(queries[:, None], bank[None])   # [b, K, T, U]
    c = sq if squared else torch.sqrt(sq)
    t, u = c.shape[-2:]
    la = torch.clamp(q_lens.to(torch.int64), 1, t)
    lb = torch.clamp(bank_lens.to(torch.int64), 1, u)
    valid = torch.arange(u, device=c.device) < lb[:, None]      # [K, U]
    c = torch.where(valid[:, None, :], c, torch.full_like(c, BIG))
    cs = torch.cumsum(c, dim=-1)
    cs_shift = torch.cat([torch.zeros_like(cs[..., :1]), cs[..., :-1]], dim=-1)
    d_prev = torch.full_like(c[..., 0, :], BIG)                 # [b, K, U]
    kept = d_prev.clone()
    start = torch.full_like(d_prev[..., :1], BIG)
    for i in range(t):
        shifted = torch.cat([torch.zeros_like(start) if i == 0 else start,
                             d_prev[..., :-1]], dim=-1)
        m = torch.minimum(d_prev, shifted)
        e = torch.where(valid, m - cs_shift[..., i, :], torch.full_like(m, BIG))
        d_prev = cs[..., i, :] + torch.cummin(e, dim=-1).values
        kept = torch.where((la - 1 == i)[:, None, None], d_prev, kept)
    col = (lb - 1)[None, :, None].expand(kept.shape[0], -1, 1)
    raw = torch.gather(kept, -1, col)[..., 0]
    return raw / (q_lens[:, None] + bank_lens[None, :]).to(raw.dtype)


def dtw_batch_fused_plain(queries: torch.Tensor, q_lens: torch.Tensor,
                          bank: torch.Tensor, bank_lens: torch.Tensor,
                          cfg: DtwConfig = DtwConfig(band_frac=None)) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B,T,F] x [K,U,F] -> [B,K].

    The expanded cost, ``torch.cumsum`` over columns, then per row
    ``torch.cummin`` of m - CS_{j-1}.  Queries run in chunks of at most
    ``ops/dtw.py``'s ``_MAX_COST_CELLS`` cost cells."""
    _check_config(cfg)
    b, t, _ = queries.shape
    k, u, _ = bank.shape
    step = max(1, tdtw._MAX_COST_CELLS // max(1, k * t * u))
    outs = [torch.zeros((0, k), dtype=torch.float32, device=queries.device)]
    for lo in range(0, b, step):
        outs.append(_closed_form(queries[lo:lo + step], q_lens[lo:lo + step],
                                 bank, bank_lens, cfg.squared))
    return torch.cat(outs)


def dtw_batch_fused(queries: torch.Tensor, q_lens: torch.Tensor,
                    bank: torch.Tensor, bank_lens: torch.Tensor,
                    cfg: DtwConfig = DtwConfig(band_frac=None)) -> torch.Tensor:
    """All-pairs unbanded DTW: [B,T,F] x [K,U,F] -> [B,K] float32.

    ``q_lens`` [B] and ``bank_lens`` [K] are int32 true lengths, clamped
    to [1, T] and [1, U].  Raises ValueError on a band or a slope (as the
    TPU kernel does).  Any query length, template length and feature width
    runs: templates that do not fit a block's shared memory (at F = 39 past
    1,312 frames) keep their edge rows in device memory, and such launches
    take :func:`window_rows` queries at a time.  Any number of queries
    runs, in launches of at most 65,535."""
    _check_config(cfg)
    if queries.device.type == "cpu":
        return dtw_batch_fused_plain(queries, q_lens, bank, bank_lens, cfg)
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
    if t < 1 or u < 1 or f < 1:
        raise ValueError(f"empty queries {tuple(queries.shape)} or templates "
                         f"{tuple(bank.shape)}")
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    window = launch_plan(b, u, f)[0]
    rows = window_rows(k, u) if window else _build.MAX_GRID_ROWS
    scratch = torch.empty(((min(rows, b) * k * u) if window else 0,), dtype=torch.float32,
                          device=dev)
    for lo, hi in _build.row_slices(b, rows):
        window, warps, _ = launch_plan(hi - lo, u, f)
        _build.launch("dtw_fused", dev, queries[lo].data_ptr(), q_lens[lo].data_ptr(),
                      bank.data_ptr(), bank_lens.data_ptr(), out[lo].data_ptr(),
                      scratch.data_ptr(), hi - lo, k, t, u, f, int(cfg.squared), warps,
                      int(window))
    return out


def occupancy(u_pad: int, f_dim: int, warps: int) -> tuple[int, int]:
    """(warps resident on an SM, registers a thread) of the kernel in
    staged mode at ``warps`` warps a block, as the CUDA occupancy
    calculator gives them for the current card (no launch)."""
    blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.lib().dtw_fused_occupancy(warps, u_pad, f_dim,
                                           ctypes.byref(blocks), ctypes.byref(regs))
    if err:
        raise RuntimeError(f"dtw_fused_occupancy failed: cudaError {err}")
    return blocks.value * warps, regs.value
