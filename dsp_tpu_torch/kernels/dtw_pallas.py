"""Wavefront DTW over a masked cost: CUDA kernel wrapper and its plain version.

Port of ``dsp_tpu/kernels/dtw_pallas.py``, with its names kept:
:func:`skew_cost`, :func:`dtw_from_cost_pallas`, :func:`dtw_pairs_pallas`
and :func:`dtw_batch_pallas` (``DtwConfig.impl="pallas"``).  The masked
cost comes from ``ops/dtw.py`` (plain PyTorch, a batched fp32 GEMM), as in
the JAX package; the DP over it is the kernel ``csrc/dtw_wavefront.cu``,
whose header says what it computes and what bounds it.

:func:`dtw_from_cost_pallas` takes CUDA tensors to the kernel and CPU
tensors to :func:`dtw_from_cost_plain`, the same diagonal recurrence in
PyTorch over :func:`skew_cost`'s layout; it never falls back from one to
the other.  The kernel needs no skewed copy of the cost.
"""

from __future__ import annotations

import ctypes

import torch

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.ops import dtw as tdtw

BIG = tdtw.BIG
# pairs a block of the kernel, one warp each: 4 rather than 8 leaves less
# warp time idle behind a block's longest pair (csrc/dtw_wavefront.cu)
BLOCK_WARPS = 4


def _check_slope(cfg: DtwConfig) -> None:
    if cfg.slope is not None:
        raise ValueError("wavefront DTW does not support cfg.slope; use "
                         "impl='scan' or 'fused_banded'")


def skew_cost(cost: torch.Tensor, big: float = BIG) -> torch.Tensor:
    """[..., T, U] -> [..., T+U-1, T] with skew[..., k, i] = cost[..., i, k-i].

    Pad each row by T (BIG), reinterpret the flat buffer with row stride
    U+T-1 (row i then starts i cells further right), transpose: the
    diagonal-major layout, with every out-of-range cell on BIG padding."""
    t, u = cost.shape[-2:]
    lead = cost.shape[:-2]
    a = torch.nn.functional.pad(cost, (0, t), value=big)
    flat = a.reshape(*lead, t * (u + t))[..., : t * (u + t - 1)]
    return flat.reshape(*lead, t, u + t - 1).transpose(-1, -2)


def dtw_from_cost_plain(cost: torch.Tensor, len_a: torch.Tensor,
                        len_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: masked cost [P,T,U] + lengths
    [P] -> distances [P].  Walks the T+U-1 anti-diagonals of the skewed
    cost, d_k[i] = c_k[i] + min(d_{k-1}[i], d_{k-1}[i-1], d_{k-2}[i-1]),
    with the origin entering as d_{-2}[-1] = 0 at k = 0, and reads row
    la-1 at k = la+lb-2.  Lengths are clamped to [1, T] and [1, U]."""
    p, t, u = cost.shape
    skew = skew_cost(cost)                                     # [P, T+U-1, T]
    la = torch.clamp(len_a.to(torch.int64), 1, t)
    lb = torch.clamp(len_b.to(torch.int64), 1, u)
    target = la + lb - 2
    row = (la - 1)[:, None]
    prev1 = torch.full((p, t), BIG, dtype=cost.dtype, device=cost.device)
    prev2 = prev1.clone()
    big_col = torch.full((p, 1), BIG, dtype=cost.dtype, device=cost.device)
    origin = torch.zeros_like(big_col)
    acc = torch.full((p,), BIG, dtype=cost.dtype, device=cost.device)
    for k in range(t + u - 1):
        s1 = torch.cat([big_col, prev1[:, :-1]], dim=1)
        s2 = torch.cat([origin if k == 0 else big_col, prev2[:, :-1]], dim=1)
        new = skew[:, k, :] + torch.minimum(prev1, torch.minimum(s1, s2))
        acc = torch.where(target == k, torch.gather(new, 1, row)[:, 0], acc)
        prev2, prev1 = prev1, new
    return acc / (len_a + len_b).to(cost.dtype)


def dtw_from_cost_pallas(cost: torch.Tensor, len_a: torch.Tensor,
                         len_b: torch.Tensor) -> torch.Tensor:
    """Masked costs [P, T, U] + int32 lengths [P] -> DTW distances [P].

    ``cost`` must be BIG (1e30) at masked cells, as ``ops/dtw.py``'s
    ``masked_cost`` builds it; only cells i < len_a, j < len_b are read.
    Lengths are clamped to [1, T] and [1, U]."""
    if cost.device.type == "cpu":
        return dtw_from_cost_plain(cost, len_a, len_b)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    dev = cost.device
    for name, x, dtype, ndim in (("cost", cost, torch.float32, 3),
                                 ("len_a", len_a, torch.int32, 1),
                                 ("len_b", len_b, torch.int32, 1)):
        if x.device != dev or x.dtype != dtype or x.dim() != ndim:
            raise ValueError(f"{name}: want {dtype} with {ndim} dims on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p, t, u = cost.shape
    if len_a.shape[0] != p or len_b.shape[0] != p:
        raise ValueError(f"shape mismatch: cost {tuple(cost.shape)}, len_a "
                         f"{tuple(len_a.shape)}, len_b {tuple(len_b.shape)}")
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    if p == 0:
        return out
    if t == 0 or u == 0:
        raise ValueError(f"empty cost matrices {tuple(cost.shape)}")
    _build.launch("dtw_wavefront", dev, cost.data_ptr(), len_a.data_ptr(),
                  len_b.data_ptr(), out.data_ptr(), p, t, u, BLOCK_WARPS)
    return out


def occupancy(u_pad: int, warps: int = BLOCK_WARPS) -> tuple[int, int]:
    """(warps resident on an SM, registers a thread) of the kernel at
    ``warps`` warps a block and ``u_pad`` template frames, as the CUDA
    occupancy calculator gives them for the current card (no launch)."""
    blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.lib().dtw_wavefront_occupancy(warps, u_pad, ctypes.byref(blocks),
                                                ctypes.byref(regs))
    if err:
        raise RuntimeError(f"dtw_wavefront_occupancy failed: cudaError {err}")
    return blocks.value * warps, regs.value


def dtw_pairs_pallas(a: torch.Tensor, b: torch.Tensor,
                     len_a: torch.Tensor, len_b: torch.Tensor,
                     cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """Paired DTW: a [P,T,F] vs b [P,U,F] -> [P] distances (the cascade's
    rerank).  Pairs run in chunks of at most ``ops/dtw.py``'s
    ``_MAX_COST_CELLS`` cost cells; chunking changes no result."""
    _check_slope(cfg)
    p, t, _ = a.shape
    step = max(1, tdtw._MAX_COST_CELLS // max(1, t * b.shape[1]))
    la, lb = len_a.to(torch.int32), len_b.to(torch.int32)
    outs = [torch.zeros((0,), dtype=torch.float32, device=a.device)]
    for lo in range(0, p, step):
        sl = slice(lo, lo + step)
        cost = tdtw.masked_cost_pairs(a[sl], la[sl], b[sl], lb[sl], cfg)
        outs.append(dtw_from_cost_pallas(cost, la[sl].contiguous(),
                                         lb[sl].contiguous()))
    return torch.cat(outs)


def dtw_batch_pallas(queries: torch.Tensor, q_lens: torch.Tensor,
                     bank: torch.Tensor, bank_lens: torch.Tensor,
                     cfg: DtwConfig = DtwConfig()) -> torch.Tensor:
    """All-pairs DTW [B,T,F] x [K,U,F] -> [B,K] through the wavefront kernel.

    Queries run in chunks so that at most ``_MAX_COST_CELLS`` cost cells
    exist at once, as ``ops/dtw.py:dtw_batch`` does; one launch a chunk."""
    _check_slope(cfg)
    b, t, _ = queries.shape
    k, u, _ = bank.shape
    step = max(1, tdtw._MAX_COST_CELLS // max(1, k * t * u))
    ql, bl = q_lens.to(torch.int32), bank_lens.to(torch.int32)
    outs = [torch.zeros((0, k), dtype=torch.float32, device=queries.device)]
    for lo in range(0, b, step):
        qc = ql[lo:lo + step]
        n = qc.shape[0]
        cost = tdtw.masked_cost(queries[lo:lo + step], qc, bank, bl, cfg)
        la = qc[:, None].expand(n, k).reshape(-1).contiguous()
        lb = bl[None, :].expand(n, k).reshape(-1).contiguous()
        outs.append(dtw_from_cost_pallas(cost.reshape(n * k, t, u), la,
                                         lb).reshape(n, k))
    return torch.cat(outs)
