"""All-pairs windowed-banded DTW: CUDA kernel wrapper and its plain version.

Port of ``dsp_tpu/kernels/dtw_fused_banded.py:dtw_batch_fused_banded``.
The kernel (``csrc/dtw_banded.cu``) runs one thread block per (query,
template) pair; its header says what it computes and what bounds it.

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

LAUNCHES = 0    # kernel launches since the last reset (main-path proof)


def _check_config(cfg: DtwConfig) -> None:
    if cfg.slope not in (None, "itakura"):
        raise ValueError(f"unknown DtwConfig.slope {cfg.slope!r}")
    if cfg.band_frac is not None and cfg.max_warp_scale is None:
        raise ValueError(
            "the fused banded kernel implements the windowed band "
            "(DtwConfig.max_warp_scale set); use impl='scan' for the "
            "pure unbounded-slope band")


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
    unreachable come out >= 1e20.  A block stages both feature matrices in
    shared memory (at most 227 KB), so at F=39 the kernel takes T + U up
    to about 1,400 frames; beyond that the launch fails and this raises.
    """
    global LAUNCHES
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
    w, s_max, _, rb, _ = plan_window(cfg.band_frac, t, u, cfg.max_warp_scale)
    banded = cfg.band_frac is not None
    windowed = banded and w < round_up(u, LANE)
    err = _build.lib().dtw_banded(
        queries.data_ptr(), q_lens.data_ptr(), bank.data_ptr(),
        bank_lens.data_ptr(), out.data_ptr(), b, k, t, u, f, w, s_max, rb,
        int(banded), int(windowed),
        float(np.float32(cfg.band_frac)) if banded else 0.0,
        int(cfg.squared), int(cfg.slope == "itakura"),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dtw_banded")
    LAUNCHES += 1
    return out
