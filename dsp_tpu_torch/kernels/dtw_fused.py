"""Unbanded all-pairs DTW in closed form: CUDA kernel wrapper and its plain
version.

Port of ``dsp_tpu/kernels/dtw_fused.py:dtw_batch_fused``
(``DtwConfig.impl="fused"``).  Features go in and distances come out; the
cost never reaches device memory.  Each row of the DP is solved in the
TPU kernel's closed form, two scans over the columns:

    CS_j = c_0 + ... + c_j
    D_j  = CS_j + min_{l <= j} (m_l - CS_{l-1}),   m_l = min(D_{i-1,l}, D_{i-1,l-1})

with BIG (1e30) at columns >= len_b.  BIG must stay a suffix of the row
so the prefix sums stay finite, which is why the closed form is unbanded
only: a band would put BIG cells inside the row.  CS cancels about 1e-4
in absolute terms on row sums of ~200 costs, so the kernel, its plain
version and the scan agree to rtol 1e-4 / atol 1e-5
(tests/test_pallas_dtw.py:103).

:func:`dtw_batch_fused` takes CUDA tensors to the kernel
(``csrc/dtw_fused.cu``, whose header says what bounds it) and CPU tensors
to :func:`dtw_batch_fused_plain`, the same closed form in PyTorch; it
never falls back from one to the other.
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.config import DtwConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.ops import dtw as tdtw

BIG = tdtw.BIG
MAX_TEMPLATE_FRAMES = 1024   # one thread per template column
MAX_FEATURES = 128           # the widest instantiation of the kernel


def _check_config(cfg: DtwConfig) -> None:
    if cfg.band_frac is not None:
        raise ValueError("fused DTW supports unbanded matching only "
                         "(prefix-sum closed form; see module docstring)")
    if cfg.slope is not None:
        raise ValueError("fused DTW does not support cfg.slope; use "
                         "impl='scan' or 'fused_banded'")


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
    TPU kernel does), beyond 1,024 template frames or 128 features, and
    where the query's shared memory (T x round_up(F, 4) floats) exceeds
    227 KB the launch fails and this raises RuntimeError.  Any number of
    queries runs, in launches of at most 65,535."""
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
    if not 1 <= u <= MAX_TEMPLATE_FRAMES or not 1 <= f <= MAX_FEATURES or t < 1:
        raise ValueError(
            f"templates of {u} frames x {f} features do not fit one block "
            f"(at most {MAX_TEMPLATE_FRAMES} frames and {MAX_FEATURES} features)")
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    for lo, hi in _build.row_slices(b):    # one block a pair: queries along gridDim.y
        _build.launch("dtw_fused", dev, queries[lo].data_ptr(), q_lens[lo].data_ptr(),
                      bank.data_ptr(), bank_lens.data_ptr(), out[lo].data_ptr(), hi - lo,
                      k, t, u, f, int(cfg.squared))
    return out
