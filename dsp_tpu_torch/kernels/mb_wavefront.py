"""Microbenchmark kernels of the wavefront design: wrappers and plain versions.

Port of the six Pallas kernels of ``scripts/mb_wavefront.py``, named after
its functions: :func:`dp_diet` (E1), :func:`dma_fetch` (E0),
:func:`anatomy` and :func:`trivial` (E1b), :func:`transpose` (E2) and
:func:`skew` (E3), with :func:`cost` (E4, no kernel: one fp32 einsum, as
the JAX script leaves it to XLA).  The kernels are ``csrc/mb_wavefront.cu``,
whose header says what bounds each and what its design does about it.

Each wrapper takes CUDA tensors to its kernel and CPU tensors to its plain
version (``*_plain``, the same function in PyTorch); it never falls back
from one to the other.  ``_build.LAUNCHES["mb_<name>"]`` counts each
kernel's launches.  The knobs ``warps`` (warps a block, one warp a pair or
row) and ``block_rows`` (thread rows of a 32-wide tile block) change the
launch geometry, never the result.
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.kernels import _build

BIG = 1e30
WARPS = 4
BLOCK_ROWS = 4          # fastest of 4, 8 and 16 for E2 and E3 on an H100 (PERF.md)
CELL_WIDTHS = (32, 64, 128, 256, 512)   # T or width: T / 32 cells a lane
MAX_ROLLS = 2


def _want(name: str, x: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got {x.dtype} "
                         f"{tuple(x.shape)}")


def _want_3d(name: str, x: torch.Tensor) -> tuple[int, int, int]:
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"{name}: want a float32 tensor with 3 dims, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return tuple(x.shape)


def _on_card(name: str, x: torch.Tensor, *rest: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version), True for contiguous CUDA
    tensors (the kernel); raises on anything else."""
    if rest:
        dev = x.device
        if any(y.device != dev for y in rest):
            raise ValueError(f"{name}: tensors on "
                             f"{[str(y.device) for y in (x, *rest)]}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"{name}: unsupported device {x.device}")
        return False
    if not x.is_contiguous() or (rest and not all(y.is_contiguous() for y in rest)):
        raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _cells(name: str, what: str, n: int) -> None:
    if n not in CELL_WIDTHS:
        raise ValueError(f"{name}: {what} = {n}; the kernel takes {what} in "
                         f"{CELL_WIDTHS}")


def _aligned(name: str, x: torch.Tensor) -> None:
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned for vector loads")


def _knob(name: str, what: str, v: int, hi: int) -> None:
    if not 1 <= v <= hi:
        raise ValueError(f"{name}: {what} = {v}, want 1..{hi}")


# ---------------------------------------------------------------- E1: DP
def dp_diet_plain(skew: torch.Tensor, ktarget: torch.Tensor,
                  la: torch.Tensor) -> torch.Tensor:
    """The op-diet wavefront DP in PyTorch: skew [P,D,T], ktarget and la
    int32 [P,1] -> [P,1].  Over k = 0..D-1, new = skew[:,k] + min(prev1,
    roll(prev1, 1), roll(prev2, 1)) with the roll wrapping; prev1 starts
    BIG, prev2 BIG but 0 at T-1 (the origin the wrap carries into lane 0);
    acc starts 0 and takes new where k == ktarget; out = acc[la-1], summed
    against a one-hot as the JAX kernel does (0 if la-1 is outside [0, T))."""
    p, d, t = skew.shape
    prev1 = torch.full((p, t), BIG, dtype=skew.dtype, device=skew.device)
    prev2 = prev1.clone()
    prev2[:, t - 1] = 0.0
    acc = torch.zeros_like(prev1)
    for k in range(d):
        s1, s2 = torch.roll(prev1, 1, 1), torch.roll(prev2, 1, 1)
        new = skew[:, k, :] + torch.minimum(prev1, torch.minimum(s1, s2))
        acc = torch.where(ktarget == k, new, acc)
        prev2, prev1 = prev1, new
    lane = torch.arange(t, device=skew.device)[None, :]
    onehot = (lane == la - 1).to(skew.dtype)
    return (acc * onehot).sum(1, keepdim=True)


def dp_diet(skew: torch.Tensor, ktarget: torch.Tensor, la: torch.Tensor,
            warps: int = WARPS) -> torch.Tensor:
    """E1 (``scripts/mb_wavefront.py:dp_diet``): the same function as
    :func:`dp_diet_plain`; every pair and every diagonal, one warp a pair.
    The kernel takes T in ``CELL_WIDTHS``."""
    p, d, t = _want_3d("dp_diet", skew)
    _want("dp_diet ktarget", ktarget, torch.int32, (p, 1))
    _want("dp_diet la", la, torch.int32, (p, 1))
    if not _on_card("dp_diet", skew, ktarget, la):
        return dp_diet_plain(skew, ktarget, la)
    _cells("dp_diet", "T", t)
    _aligned("dp_diet", skew)
    _knob("dp_diet", "warps", warps, 32)
    if p == 0 or d == 0:     # no diagonal: acc stays 0
        return torch.zeros((p, 1), dtype=torch.float32, device=skew.device)
    out = torch.empty((p, 1), dtype=torch.float32, device=skew.device)
    _build.launch("mb_dp_diet", skew.device, skew.data_ptr(), ktarget.data_ptr(),
                  la.data_ptr(), out.data_ptr(), p, d, t, warps)
    return out


# ---------------------------------------------------------- E0: the fetch
_SALT = 0x7FC0_0001    # a NaN pattern: the XOR of the loads never matters


def dma_fetch_plain(skew: torch.Tensor, ktarget: torch.Tensor) -> torch.Tensor:
    """out[p] = sum over kb < D/8 of (skew[p, 8kb, 0] + ktarget[p]), in kb
    order: the Pallas kernel's accumulator over its (P, D/8) grid."""
    p, d, _ = skew.shape
    acc = torch.zeros((p, 1), dtype=skew.dtype, device=skew.device)
    kt = ktarget.to(skew.dtype)
    for kb in range(d // 8):
        acc = acc + skew[:, 8 * kb, :1] + kt
    return acc


def dma_fetch(skew: torch.Tensor, ktarget: torch.Tensor,
              warps: int = WARPS) -> torch.Tensor:
    """E0 (``scripts/mb_wavefront.py:bench_dma``): :func:`dma_fetch_plain`'s
    result, with every byte of ``skew`` loaded in :func:`dp_diet`'s order
    and launch geometry, so that its time is E1's copy floor."""
    p, d, t = _want_3d("dma_fetch", skew)
    _want("dma_fetch ktarget", ktarget, torch.int32, (p, 1))
    if not _on_card("dma_fetch", skew, ktarget):
        return dma_fetch_plain(skew, ktarget)
    _cells("dma_fetch", "T", t)
    _aligned("dma_fetch", skew)
    _knob("dma_fetch", "warps", warps, 32)
    if p == 0 or d == 0:
        return torch.zeros((p, 1), dtype=torch.float32, device=skew.device)
    out = torch.empty((p, 1), dtype=torch.float32, device=skew.device)
    sink = torch.empty((1,), dtype=torch.int32, device=skew.device)
    _build.launch("mb_dma_fetch", skew.device, skew.data_ptr(), ktarget.data_ptr(),
                  out.data_ptr(), sink.data_ptr(), _SALT, p, d, t, warps)
    return out


# ------------------------------------------------ E1b: op-cost anatomy
def anatomy_plain(x: torch.Tensor, n_rolls: int, steps: int) -> torch.Tensor:
    """x [rows, width] -> same shape: ``steps`` times s = prev1 rolled by
    one (with wrap) ``n_rolls`` times, new = min(prev1, s) + prev2 * 0.5,
    (prev1, prev2) = (new, prev1); returns prev1 + prev2."""
    prev1 = prev2 = x
    for _ in range(steps):
        s = prev1
        for _ in range(n_rolls):
            s = torch.roll(s, 1, 1)
        prev1, prev2 = torch.minimum(prev1, s) + prev2 * 0.5, prev1
    return prev1 + prev2


def anatomy(x: torch.Tensor, n_rolls: int, steps: int, warps: int = WARPS,
            cycles: torch.Tensor | None = None) -> torch.Tensor:
    """E1b (``scripts/mb_wavefront.py:_anatomy_kernel``): the same function
    as :func:`anatomy_plain`, one warp a row, the state in registers.  With
    ``cycles`` (int64 [rows] on the card) each row's SM clock cycles over
    its step loop are written there."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"anatomy: want a float32 tensor with 2 dims, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not 0 <= n_rolls <= MAX_ROLLS or steps < 0:
        raise ValueError(f"anatomy: n_rolls {n_rolls} (want 0..{MAX_ROLLS}), "
                         f"steps {steps} (want >= 0)")
    rows, width = x.shape
    extra = () if cycles is None else (cycles,)
    if not _on_card("anatomy", x, *extra):
        if cycles is not None:
            raise ValueError("anatomy: cycles are counted only on the card")
        return anatomy_plain(x, n_rolls, steps)
    if cycles is not None:
        _want("anatomy cycles", cycles, torch.int64, (rows,))
    _cells("anatomy", "width", width)
    _aligned("anatomy", x)
    _knob("anatomy", "warps", warps, 32)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    _build.launch("mb_anatomy", x.device, x.data_ptr(), out.data_ptr(),
                  None if cycles is None else cycles.data_ptr(), rows, width,
                  n_rolls, steps, warps)
    return out


def trivial_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def trivial(x: torch.Tensor) -> torch.Tensor:
    """E1b's launch baseline (the ``x * 2`` kernel of
    ``scripts/mb_wavefront.py:179``), any float32 shape."""
    if x.dtype != torch.float32:
        raise ValueError(f"trivial: want float32, got {x.dtype}")
    if not _on_card("trivial", x):
        return trivial_plain(x)
    n = x.numel()
    if n >= 2**31:
        raise ValueError(f"trivial: {n} elements, want < 2**31")
    out = torch.empty_like(x)
    if n:
        _build.launch("mb_trivial", x.device, x.data_ptr(), out.data_ptr(), n)
    return out


# ------------------------------------------------------- E2: transpose
def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def _tiles_ok(name: str, n: int) -> None:
    if n >= 2**31:
        raise ValueError(f"{name}: {n} tiles of 32 x 32, want < 2**31")


def transpose(x: torch.Tensor, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """E2 (``scripts/mb_wavefront.py:_tr_kernel``): x [P, R, C] -> [P, C, R]."""
    p, r, c = _want_3d("transpose", x)
    if not _on_card("transpose", x):
        return transpose_plain(x)
    _knob("transpose", "block_rows", block_rows, 32)
    _tiles_ok("transpose", p * -(-r // 32) * -(-c // 32))
    out = torch.empty((p, c, r), dtype=x.dtype, device=x.device)
    if out.numel():
        _build.launch("mb_transpose", x.device, x.data_ptr(), out.data_ptr(), p, r,
                      c, block_rows)
    return out


# ---------------------------------------------------- E3: skew construct
def _check_skew(t: int, u: int, d_pad: int) -> None:
    if t + u > d_pad:
        raise ValueError(f"skew: t_pad + u_pad = {t} + {u} > d_pad = {d_pad}")


def skew_plain(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """cost [Q, T, U] -> [Q, d_pad, T], out[q, d, i] = cost[q, i, d - i]
    where 0 <= d - i < U, else BIG: a gather at the diagonal indices."""
    q, t, u = x.shape
    d = torch.arange(d_pad, device=x.device)[:, None]
    i = torch.arange(t, device=x.device)[None, :]
    j = d - i
    out = x[:, i.expand(d_pad, t), j.clamp(0, max(u - 1, 0))]
    return out.masked_fill_(~((j >= 0) & (j < u)), BIG)


def skew(x: torch.Tensor, d_pad: int, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """E3 (``scripts/mb_wavefront.py:_skew_kernel``): the cost x [Q, T, U]
    in the diagonal-major layout [Q, d_pad, T] (``dtw_pallas.skew_cost``'s,
    padded with BIG rows to d_pad).  Needs T + U <= d_pad, as the JAX
    kernel does."""
    q, t, u = _want_3d("skew", x)
    _check_skew(t, u, d_pad)
    if not _on_card("skew", x):
        return skew_plain(x, d_pad)
    _knob("skew", "block_rows", block_rows, 32)
    _tiles_ok("skew", q * -(-t // 32) * -(-d_pad // 32))
    out = torch.empty((q, d_pad, t), dtype=x.dtype, device=x.device)
    if out.numel():
        _build.launch("mb_skew", x.device, x.data_ptr(), out.data_ptr(), q, t, u,
                      d_pad, block_rows)
    return out


# --------------------------------------------- E4: batched cost, no kernel
def cost(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """E4 (``scripts/mb_wavefront.py:bench_cost``): q [B,T,F], b [K,U,F] ->
    squared distances [B*K, T, U] = max(|q|^2 + |b|^2 - 2 q.b, 0), the
    cross term one fp32 einsum (TF32 is off, ``dsp_tpu_torch/__init__``)."""
    bq, t, _ = q.shape
    k, u, _ = b.shape
    cr = torch.einsum("btf,kuf->bktu", q, b)
    sa = torch.sum(q * q, -1)[:, None, :, None]
    sb = torch.sum(b * b, -1)[None, :, None, :]
    return torch.clamp_min(sa + sb - 2 * cr, 0.0).reshape(bq * k, t, u)
