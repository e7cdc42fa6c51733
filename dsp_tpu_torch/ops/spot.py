"""Keyword spotting: subsequence DTW in PyTorch (port of ``dsp_tpu/ops/spot.py``).

A keyword template [T, F] is matched against any contiguous span of a
long stream [U, F]: open begin (the virtual row above the table is 0, so
a path may start at any stream column) and open end (every cell of the
template's last row is a candidate match end).  Each column carries a
start witness, the stream column where the best path began, and scores
are normalised over the matched span:

    norm[j] = D[T-1, j] / (T + j - s[j] + 1)

* **Plain route** (:func:`subseq_dtw_batch_plain`): the local cost of
  every (stream, template) pair is one batched fp32 GEMM
  (``ops/dtw.py:pairwise_sq_cost``); the DP is a row loop whose rows are
  solved by the Hillis-Steele min-plus scan of ``ops/dtw.py`` carrying
  the witness.  Ties prefer diagonal, then vertical, then horizontal,
  and a fresh start wins row-0 ties (``dsp_tpu/golden/spot.py``).
* **Kernel route**: ``kernels/spot_fused.py`` (CUDA C++,
  ``csrc/spot_subseq.cu``), whose state is O(T) whatever the stream
  length.

:func:`subseq_dtw_batch` routes by device: CUDA tensors to the kernel,
CPU tensors to the plain route.  Event extraction from the per-column
score field is host numpy (:func:`extract_events`).

* **Streaming** (:func:`spot_chunk`): the SPRING column update.  Each new
  stream frame advances a [K, T] state (every template's DP column and
  its start witnesses): the frame's local costs are the offline route's
  ``pairwise_sq_cost`` of that frame, and its vertical continuation is
  the same min-plus scan along the template axis.  Ties prefer the
  diagonal, then the horizontal, then the vertical predecessor here (the
  horizontal one joins the pre-scan min), so on exact float ties a witness can differ from the
  offline route's; values cannot.  Every frame is the same computation
  whatever the chunking, so feeding a stream in any chunks is bit-exact.
  Plain PyTorch on every device: a loop over the chunk's frames, each a
  few whole-state tensor ops, with no read-back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsp_tpu_torch.ops.dtw import (_MAX_COST_CELLS, BIG, _minplus_scan,
                                   pairwise_sq_cost)


def subseq_cost(tmpl: torch.Tensor, stream: torch.Tensor, len_b: torch.Tensor,
                squared: bool = False) -> torch.Tensor:
    """Local cost template [..., T, F] x stream [..., U, F] -> [..., T, U],
    BIG at stream columns >= ``len_b`` (broadcast over the leading dims).
    No band: the stream is unbounded relative to the template."""
    sq = pairwise_sq_cost(tmpl, stream)
    c = sq if squared else torch.sqrt(sq)
    cols = torch.arange(stream.shape[-2], device=c.device)
    keep = cols < torch.as_tensor(len_b, device=c.device)[..., None, None]
    return torch.where(keep, c, torch.full_like(c, BIG))


def subseq_dtw_from_cost(cost: torch.Tensor, len_a: torch.Tensor,
                         len_b: torch.Tensor):
    """Subsequence DP over costs [..., T, U] (template rows, stream columns;
    BIG already at columns >= len_b).

    Returns (norm [..., U], start [..., U] int32): per end column the
    span-normalised match cost and the stream column the match began at.
    Columns >= len_b are BIG.  Rows >= len_a are never read."""
    t, u = cost.shape[-2:]
    len_a = torch.as_tensor(len_a, device=cost.device)
    len_b = torch.as_tensor(len_b, device=cost.device)
    iota = torch.arange(u, dtype=torch.int32, device=cost.device)
    d_prev = torch.full_like(cost[..., 0, :], BIG)
    s_prev = torch.zeros(d_prev.shape, dtype=torch.int32, device=cost.device)
    acc_d, acc_s = d_prev, s_prev
    n_rows = min(t, int(len_a.max())) if len_a.numel() else 0
    for i in range(n_rows):
        c_row = cost[..., i, :]
        if i == 0:
            # open begin: the virtual row above row 0 is 0 with witness j
            m = torch.zeros_like(c_row)
            sm = iota.expand(c_row.shape)
        else:
            shifted = torch.cat([torch.full_like(d_prev[..., :1], BIG),
                                 d_prev[..., :-1]], dim=-1)
            shifted_s = torch.cat([torch.zeros_like(s_prev[..., :1]),
                                   s_prev[..., :-1]], dim=-1)
            # diagonal preferred over vertical on ties (golden order)
            m = torch.minimum(shifted, d_prev)
            sm = torch.where(shifted <= d_prev, shifted_s, s_prev)
        d_prev, s_prev = _minplus_scan(m + c_row, c_row, sm)
        at_end = (len_a == i + 1)[..., None]
        acc_d = torch.where(at_end, d_prev, acc_d)
        acc_s = torch.where(at_end, s_prev, acc_s)
    span = (iota - acc_s + 1).to(cost.dtype)
    norm = acc_d / (len_a.to(cost.dtype)[..., None] + span)
    norm = torch.where(iota < len_b[..., None], norm, torch.full_like(norm, BIG))
    return norm, acc_s


def subseq_dtw_batch_plain(streams: torch.Tensor, stream_lens: torch.Tensor,
                           bank: torch.Tensor, bank_lens: torch.Tensor,
                           squared: bool = False):
    """Plain all-pairs spotting: streams [B,U,F] x bank [K,T,F] ->
    (norm [B,K,U], start [B,K,U] int32).  Streams run in chunks so that at
    most ``_MAX_COST_CELLS`` cost cells exist at once; chunking changes no
    result."""
    b, u, _ = streams.shape
    k, t, _ = bank.shape
    step = max(1, _MAX_COST_CELLS // max(1, k * t * u))
    norms, starts = [], []
    for lo in range(0, b, step):
        sl = stream_lens[lo:lo + step][:, None]                  # [b, 1]
        cost = subseq_cost(bank[None], streams[lo:lo + step, None], sl,
                           squared)                              # [b,K,T,U]
        norm, start = subseq_dtw_from_cost(cost, bank_lens[None, :], sl)
        norms.append(norm)
        starts.append(start)
    if not norms:
        return (torch.empty((0, k, u), dtype=streams.dtype, device=streams.device),
                torch.empty((0, k, u), dtype=torch.int32, device=streams.device))
    return torch.cat(norms), torch.cat(starts)


def subseq_dtw_batch(streams: torch.Tensor, stream_lens: torch.Tensor,
                     bank: torch.Tensor, bank_lens: torch.Tensor,
                     squared: bool = False, impl: str = "auto"):
    """Spot every bank template in every stream.

    streams [B,U,F], bank [K,T,F] -> (norm [B,K,U], start [B,K,U]).
    ``impl="auto"`` takes the kernel for CUDA tensors at every stream
    length (its state does not grow with U) and the plain route for CPU
    tensors: the device is the only switch.  ``"scan"`` and ``"fused"``
    force a path."""
    if impl == "auto":
        impl = production_impl(streams.device)
    if impl == "fused":
        from dsp_tpu_torch.kernels.spot_fused import subseq_dtw_fused
        return subseq_dtw_fused(
            streams.contiguous(), stream_lens.to(torch.int32).contiguous(),
            bank.contiguous(), bank_lens.to(torch.int32).contiguous(),
            squared=squared)
    if impl != "scan":
        raise ValueError(f"unknown spotting impl {impl!r}")
    return subseq_dtw_batch_plain(streams, stream_lens, bank, bank_lens, squared)


class SpotState(NamedTuple):
    """SPRING DP state: one column per template.

    d_col [K, T] f32: D[:, j] after the last fed frame (BIG before any).
    s_col [K, T] i32: start witness of the best path into each cell.
    n_fed [] i32: stream frames consumed so far."""

    d_col: torch.Tensor
    s_col: torch.Tensor
    n_fed: torch.Tensor


def spot_init(n_templates: int, t: int, device: str | torch.device = "cuda",
              dtype=torch.float32) -> SpotState:
    return SpotState(
        torch.full((n_templates, t), BIG, dtype=dtype, device=device),
        torch.zeros((n_templates, t), dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def spot_chunk(state: SpotState, chunk: torch.Tensor, n_valid,
               bank: torch.Tensor, bank_lens: torch.Tensor,
               squared: bool = False):
    """Advance the SPRING state by a chunk of stream frames.

    chunk [C, F] (the first ``n_valid`` rows real; an int or an int
    tensor), bank [K, T, F].  Returns (state', norm [K, C], start [K, C]):
    per frame the span-normalised score of the best match of each template
    ending there (BIG at invalid frames) and its start frame."""
    k, t, _ = bank.shape
    c = chunk.shape[0]
    dev = bank.device
    valid = torch.arange(c, device=dev) < n_valid
    end_row = (bank_lens.to(torch.int64) - 1)[:, None]          # [K, 1]
    lens_f = bank_lens.to(bank.dtype)
    zero_col = torch.zeros((k, 1), dtype=bank.dtype, device=dev)
    d_col, s_col, j = state
    norms, starts = [], []
    for col in range(c):
        # the frame's local costs, [K, T]: the offline route's product, one
        # frame at a time, so that every frame's costs are the same
        # computation whatever the chunking (a BLAS picks its kernel by
        # shape, and a chunk-wide product rounds apart at other widths)
        c_col = pairwise_sq_cost(bank, chunk[col:col + 1])[..., 0]
        if not squared:
            c_col = torch.sqrt(c_col)
        v = valid[col]
        # open begin: the virtual row above is 0 with witness j
        up = torch.cat([zero_col, d_col[:, :-1]], dim=1)        # D[i-1, j-1]
        up_s = torch.cat([j.expand(k, 1), s_col[:, :-1]], dim=1)
        # d_col is the horizontal predecessor D[i, j-1]; ties prefer the
        # diagonal, then the horizontal, then (in the scan) the vertical
        m = torch.minimum(up, d_col)
        sm = torch.where(up <= d_col, up_s, s_col)
        new_d, new_s = _minplus_scan(m + c_col, c_col, sm)
        d_col = torch.where(v, new_d, d_col)
        s_col = torch.where(v, new_s, s_col)
        d_end = torch.take_along_dim(new_d, end_row, dim=1)[:, 0]
        s_end = torch.take_along_dim(new_s, end_row, dim=1)[:, 0]
        span = (j - s_end + 1).to(d_end.dtype)
        norms.append(torch.where(v, d_end / (lens_f + span), BIG))
        starts.append(s_end)
        j = j + v.to(torch.int32)
    return (SpotState(d_col, s_col, j),
            torch.stack(norms, dim=1), torch.stack(starts, dim=1))


def production_impl(device) -> str:
    """What ``subseq_dtw_batch(impl="auto")`` resolves to on ``device``;
    callers use it to pick sub-batching budgets (the plain route holds a
    [B,K,T,U] cost, the kernel only its [B,K,U] outputs)."""
    return "fused" if torch.device(device).type == "cuda" else "scan"


def rerank_windows(wins: torch.Tensor, win_lens: torch.Tensor,
                   mids: torch.Tensor, bank: torch.Tensor,
                   bank_lens: torch.Tensor, squared: bool = False):
    """Cascade stage-2 rerank, argmin on the device.

    wins [N,W,F] candidate windows, mids [N] landmark midpoints (window
    frames).  Each window is matched against the whole bank; the best
    (template, end column) must contain the midpoint (start <= mid <=
    end).  Returns per window (row [N], end [N], start [N], score [N])."""
    norm, start = subseq_dtw_batch(wins, win_lens, bank, bank_lens,
                                   squared=squared)              # [N,K,W]
    n, k, w = norm.shape
    cols = torch.arange(w, dtype=torch.int32, device=norm.device)[None, None, :]
    mid3 = mids[:, None, None]
    ok = (cols.to(mids.dtype) >= mid3) & (start.to(mids.dtype) <= mid3)
    flat = torch.where(ok, norm, torch.full_like(norm, BIG)).reshape(n, k * w)
    # first minimum in host order, as jnp.argmin
    idx = torch.argmin(flat, dim=1).to(torch.int32)
    r, j = idx // w, idx % w
    score = torch.take_along_dim(flat, idx[:, None].long(), dim=1)[:, 0]
    s = torch.take_along_dim(start.reshape(n, k * w), idx[:, None].long(),
                             dim=1)[:, 0]
    return r, j, s, score


def extract_events(norm: np.ndarray, start: np.ndarray, threshold: float,
                   labels: np.ndarray | None = None, min_gap: int = 0):
    """Greedy best-first spotting events from per-column scores.

    norm/start [K, U] (numpy).  Emits the globally best column under
    threshold, suppresses every column whose span overlaps it (across all
    templates, widened by ``min_gap`` frames on both sides), repeats.
    Returns [(label, start, end, score)] sorted by start.  A copy of the
    JAX package's host function."""
    norm = np.atleast_2d(np.asarray(norm, dtype=np.float64)).copy()
    start = np.atleast_2d(np.asarray(start, dtype=np.int64))
    k, u = norm.shape
    cols = np.arange(u)[None, :]
    events = []
    while True:
        flat = int(np.argmin(norm))
        r, j = divmod(flat, u)
        score = norm[r, j]
        if not score < threshold:
            break
        s, e = int(start[r, j]), int(j)
        lbl = int(labels[r]) if labels is not None else r
        events.append((lbl, s, e, float(score)))
        norm[(start <= e + min_gap) & (cols >= s - min_gap)] = BIG
    events.sort(key=lambda ev: ev[1])
    return events
