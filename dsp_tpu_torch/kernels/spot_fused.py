"""All-pairs subsequence DTW (keyword spotting): CUDA kernel wrapper.

Port of ``dsp_tpu/kernels/spot_fused.py:subseq_dtw_fused``.  The kernel
(``csrc/spot_subseq.cu``) runs one warp per (stream, template) pair over
strips of 32 stream columns (:func:`strips` states its walk,
:func:`launch_plan` its launch); its state is one column of the
template's length, so any stream length runs.  Its header says what it
computes and what bounds it.

:func:`subseq_dtw_fused` takes CUDA tensors to the kernel and CPU tensors
to :func:`subseq_dtw_batch_plain` (``ops/spot.py``, the reference's scan
route); it never falls back from one to the other.  Columns at or beyond
a stream's length hold norm 1e30 in both; their start witness is
unspecified (the kernel writes the column index).
"""

from __future__ import annotations

import ctypes

import torch

from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels.dtw_fused import resident_warps
from dsp_tpu_torch.ops.spot import subseq_dtw_batch_plain

STRIP = 32          # stream columns a warp walks together, one a lane; steps a chunk
COST_GROUP = 8      # template rows whose costs a lane sums side by side
QF = 40             # features a row stride unit
RING = 64           # cost rows a lane keeps (this chunk's block and the last)
EDGE_PAD = 64       # rows past the edge column's tl
MAX_WARPS = 8       # warps a block csrc/spot_subseq.cu allows (its progress counters)
# the most warps a block takes (chip_smoke.py times a cap of 4 beside it)
BLOCK_WARPS = 8
SM_COUNT = 132      # SMs of the H100 (SXM5)
SMEM_OPTIN = 232_448   # shared memory a block may use on the H100 (227 KB)
# device memory a window-mode launch takes for its edge columns (256 MB)
WINDOW_SCRATCH_WORDS = 1 << 26


def strips(sl: int, tl: int, u_pad: int, t_pad: int):
    """The kernel's walk of pair (stream length sl, template length tl) at
    padded shape (u_pad, t_pad): a list of (c0, n_cols, n_steps), one per
    strip of stream columns c0 .. c0+n_cols-1.  Lane l (column c0 + l) is
    on template row s - l at step s of the strip's n_steps = tl + n_cols -
    1; it computes a cell where 0 <= s - l < tl and l < n_cols, and nothing
    on the rest (the ramp, and lanes past the stream's end).  With W warps
    a stream, warp w walks strips w, w + W, ...  Lengths are clamped to
    [1, u_pad] and [1, t_pad], as the kernel clamps them."""
    sl, tl = min(max(sl, 1), u_pad), min(max(tl, 1), t_pad)
    return [(c0, min(STRIP, sl - c0), tl + min(STRIP, sl - c0) - 1)
            for c0 in range(0, sl, STRIP)]


def cost_cells(sl: int, tl: int, u_pad: int, t_pad: int) -> int:
    """Local costs the kernel computes for a pair: every lane of a strip,
    against the template's rows in groups of :data:`COST_GROUP`."""
    tl = min(max(tl, 1), t_pad)
    return len(strips(sl, tl, u_pad, t_pad)) * STRIP * -(-tl // COST_GROUP) * COST_GROUP


def smem_bytes(warps: int, t_pad: int, f_dim: int, window: bool) -> int:
    """Shared memory of one block, as ``csrc/spot_subseq.cu`` sizes it: the
    template with its |a|^2 up to a whole cost block (staged mode), then a
    warp's 32 template rows of a chunk (window mode), cost ring, staged last column and edge column (D and witness
    each; window mode: 32 rows of it, the column being in device memory),
    and a progress counter a warp."""
    fs = -(-f_dim // QF) * QF
    rows = -(-t_pad // STRIP) * STRIP
    per_warp = ((STRIP * fs + STRIP if window else 0) + RING * STRIP + 2 * STRIP
                + 2 * (STRIP if window else -(-(t_pad + EDGE_PAD) // 4) * 4))
    staged = 0 if window else rows * fs + rows
    return 4 * (staged + warps * per_warp + MAX_WARPS)


def launch_plan(n_streams: int, n_templates: int, u_pad: int,
                t_pad: int, f_dim: int) -> tuple[bool, int, int, int]:
    """(window mode, warps a block, warps a stream, shared bytes) of a
    launch.  Window mode where the whole template does not fit a one-warp
    block.  Warps a block, for W warps a stream: of the multiples of W up
    to :data:`BLOCK_WARPS` that fit and that the streams fill, the one that
    keeps most warps on an SM (``dtw_fused.resident_warps``), the larger on
    a tie.  Warps a stream: doubled, up to 8, while each warp keeps a strip
    of its own, a block fits, and the pairs' warps stay within what the
    card holds at once (:data:`SM_COUNT` x that block's resident warps)."""
    window = smem_bytes(1, t_pad, f_dim, False) > SMEM_OPTIN

    def block(w_pair: int) -> tuple[int, int]:
        """(warps a block, warps it keeps on an SM); (0, 0) where none fits."""
        fits = [w for w in range(w_pair, min(BLOCK_WARPS, max(1, n_streams) * w_pair) + 1,
                                 w_pair) if smem_bytes(w, t_pad, f_dim, window) <= SMEM_OPTIN]
        return max(((resident_warps(w, smem_bytes(w, t_pad, f_dim, window)), w)
                    for w in fits), default=(0, 0))[::-1]

    w_pair = 1
    while w_pair * 2 <= min(BLOCK_WARPS, 8) and w_pair * 2 * STRIP <= u_pad:
        warps, resident = block(w_pair * 2)
        if not warps or n_streams * n_templates * w_pair * 2 > SM_COUNT * resident:
            break
        w_pair *= 2
    warps = block(w_pair)[0] or 1
    return window, warps, w_pair, smem_bytes(warps, t_pad, f_dim, window)


def window_rows(n_templates: int, t_pad: int) -> int:
    """Streams a window-mode launch takes: as many as keep their edge
    columns (2 x t_pad words a warp, up to 8 warps a stream, in device
    memory) within :data:`WINDOW_SCRATCH_WORDS`, at least
    one, at most a grid's rows."""
    per_stream = n_templates * 8 * 2 * t_pad
    return max(1, min(_build.MAX_GRID_ROWS, WINDOW_SCRATCH_WORDS // max(1, per_stream)))


def subseq_dtw_fused(streams: torch.Tensor, stream_lens: torch.Tensor,
                     bank: torch.Tensor, bank_lens: torch.Tensor,
                     squared: bool = False):
    """All-pairs subsequence DTW: streams [B,U,F] x bank [K,T,F] ->
    (norm [B,K,U] float32, start [B,K,U] int32).

    Lengths are int32 [B] and [K], clamped to >= 1.  Any stream length,
    template length and feature width runs: templates that do not fit a
    block's shared memory (at F = 39 past 1,280 frames) keep their edge
    columns in device memory, and such launches take :func:`window_rows`
    streams at a time.  Any number of streams runs, in launches of at most
    65,535."""
    if streams.device.type == "cpu":
        return subseq_dtw_batch_plain(streams, stream_lens, bank, bank_lens,
                                      squared)
    if streams.device.type != "cuda":
        raise ValueError(f"unsupported device {streams.device}")
    dev = streams.device
    for name, x, dtype, ndim in (("streams", streams, torch.float32, 3),
                                 ("bank", bank, torch.float32, 3),
                                 ("stream_lens", stream_lens, torch.int32, 1),
                                 ("bank_lens", bank_lens, torch.int32, 1)):
        if x.device != dev or x.dtype != dtype or x.dim() != ndim:
            raise ValueError(f"{name}: want {dtype} with {ndim} dims on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, u, f = streams.shape
    k, t, f2 = bank.shape
    if f2 != f or stream_lens.shape[0] != b or bank_lens.shape[0] != k:
        raise ValueError(f"shape mismatch: streams {tuple(streams.shape)}, "
                         f"bank {tuple(bank.shape)}, stream_lens "
                         f"{tuple(stream_lens.shape)}, bank_lens "
                         f"{tuple(bank_lens.shape)}")
    if t < 1 or f < 1:
        raise ValueError(f"empty templates {tuple(bank.shape)}")
    norm = torch.empty((b, k, u), dtype=torch.float32, device=dev)
    start = torch.empty((b, k, u), dtype=torch.int32, device=dev)
    if k == 0 or u == 0:
        return norm, start
    window = launch_plan(b, k, u, t, f)[0]
    rows = window_rows(k, t) if window else _build.MAX_GRID_ROWS
    scratch = torch.empty(((min(rows, b) * k * 8 * 2 * t) if window else 0,),
                          dtype=torch.float32, device=dev)
    for lo, hi in _build.row_slices(b, rows):
        window, warps, w_pair, _ = launch_plan(hi - lo, k, u, t, f)
        _build.launch("spot_subseq", dev, streams[lo].data_ptr(), stream_lens[lo].data_ptr(),
                      bank.data_ptr(), bank_lens.data_ptr(), norm[lo].data_ptr(),
                      start[lo].data_ptr(), scratch.data_ptr(), hi - lo, k, u, t, f,
                      int(squared), warps, w_pair, int(window))
    return norm, start


def occupancy(t_pad: int, f_dim: int, warps: int) -> tuple[int, int]:
    """(warps resident on an SM, registers a thread) of the kernel in
    staged mode at ``warps`` warps a block, as the CUDA occupancy
    calculator gives them for the current card (no launch)."""
    blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.lib().spot_subseq_occupancy(warps, t_pad, f_dim,
                                             ctypes.byref(blocks), ctypes.byref(regs))
    if err:
        raise RuntimeError(f"spot_subseq_occupancy failed: cudaError {err}")
    return blocks.value * warps, regs.value
