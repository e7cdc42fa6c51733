"""Fused MFCC front-end: CUDA kernel wrapper and its plain version.

Port of ``dsp_tpu/kernels/mfcc_pallas.py`` (``mfcc_frames_pallas``,
``mfcc_pallas``).  The kernel (``csrc/mfcc_fused.cu``) takes pre-emphasised
frames [N, L] to cepstra [N, n_mfcc] in one pass, in one of two modes that
:func:`launch_plan` picks from the config: ``fft`` (a warp a frame, a
radix-2 FFT in shared memory) where ``n_fft`` is a power of two and a
frame's buffers fit a block, else ``gemm`` (the DFT as two GEMMs).  Where
``n_fft`` is below the frame length both take the spectrum in float64
(:func:`folded`).  The source's header says what bounds each.  Pre-emphasis and framing stay
plain PyTorch, as in the JAX package.

:func:`mfcc_frames_fused` takes CUDA tensors to the kernel and CPU tensors
to :func:`mfcc_frames_plain` (``ops/frontend.py:mfcc_from_frames``); it
never falls back from one to the other.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dsp_tpu_torch.config import FrontendConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.ops import frontend as fe


SMEM_OPTIN = 232_448    # shared memory a block may use on the H100 (227 KB)
BLOCK_WARPS = 8         # FFT mode: warps a block, fewer where they do not fit
FRAMES_PER_WARP = 4     # FFT mode: frames a warp takes in turn
GEMM_WARPS, GEMM_FRAMES_PER_WARP = 8, 4   # csrc/mfcc_fused.cu THREADS / 32, ROWS_PER_WARP
MODES = {"gemm": 0, "fft": 1}             # the C entry's mode argument


class Plan(NamedTuple):
    mode: str             # "fft" | "gemm"
    frames_per_warp: int
    warps: int            # warps a block
    smem_bytes: int


def _round_up4(v: int) -> int:
    return (v + 3) & ~3


def folded(cfg: FrontendConfig) -> bool:
    """``n_fft`` below the frame length: the kernel's float64 folded path."""
    return cfg.n_fft < cfg.frame_len


def fold_smem_bytes(cfg: FrontendConfig, warps: int) -> int:
    """Shared bytes of the folded path: a float64 buffer of ``n_fft`` points
    a warp (none where ``n_fft`` is not below the frame length)."""
    return 8 * cfg.n_fft * warps if folded(cfg) else 0


def fft_smem_bytes(cfg: FrontendConfig, warps: int) -> int:
    """Shared bytes of an FFT-mode block (``csrc/mfcc_fused.cu``,
    ``mfcc_fft_block_floats`` + warps x ``mfcc_fft_warp_floats``, and the
    folded path's buffers)."""
    half, m, c = cfg.n_fft // 2, cfg.n_mels, cfg.n_mfcc
    block = 4 * half + _round_up4(cfg.frame_len) + m * c + c + mel_nnz(cfg) + 3 * m
    per_warp = 2 * (half + (half >> 5)) + half + 1 + m
    return 4 * (block + warps * per_warp) + fold_smem_bytes(cfg, warps)


def gemm_smem_bytes(cfg: FrontendConfig) -> int:
    """Shared bytes of a GEMM-mode block (``mfcc_fused_smem_bytes``): 32
    frames, 16-sample tiles, 288-bin passes, and the folded path's
    buffers."""
    tm, kt, pass_ = 32, 16, 288
    n_pass = -(-cfg.n_bins // pass_)
    return (4 * (tm * kt + 2 * kt * pass_ + tm * (n_pass * pass_ + 1)
                 + tm * cfg.n_mels + tm) + fold_smem_bytes(cfg, GEMM_WARPS))


@functools.lru_cache(maxsize=32)
def launch_plan(cfg: FrontendConfig) -> Plan:
    """The kernel's mode, frames a warp, warps a block and shared bytes for
    ``cfg``: :func:`fft_plan` where it gives one, else :func:`gemm_plan`.
    Raises ``ValueError`` where neither mode's block fits.

    Where ``n_fft < frame_len`` (:func:`folded`) either mode takes its
    frames through the float64 folded path (``csrc/mfcc_fused.cu``), as the
    plain version does (``ops/frontend.py:power_spectrum``)."""
    return fft_plan(cfg) or gemm_plan(cfg)


def fft_plan(cfg: FrontendConfig) -> Plan | None:
    """The FFT mode's plan where ``n_fft`` is a power of two (at least 4)
    and a block of one warp fits :data:`SMEM_OPTIN`, with as many warps up
    to :data:`BLOCK_WARPS` as fit; else None."""
    n_fft = cfg.n_fft
    if n_fft < 4 or n_fft & (n_fft - 1):
        return None
    fits = [w for w in range(BLOCK_WARPS, 0, -1) if fft_smem_bytes(cfg, w) <= SMEM_OPTIN]
    if not fits:
        return None
    return Plan("fft", FRAMES_PER_WARP, fits[0], fft_smem_bytes(cfg, fits[0]))


def gemm_plan(cfg: FrontendConfig) -> Plan:
    """The GEMM mode's plan for ``cfg`` (any ``n_fft`` whose block fits);
    raises ``ValueError`` where it does not."""
    smem = gemm_smem_bytes(cfg)
    if smem > SMEM_OPTIN:
        raise ValueError(f"the fused MFCC kernel takes no n_fft={cfg.n_fft} at "
                         f"n_mels={cfg.n_mels}: a GEMM-mode block needs {smem} "
                         f"shared bytes, over {SMEM_OPTIN}")
    return Plan("gemm", GEMM_FRAMES_PER_WARP, GEMM_WARPS, smem)


def fft_twiddles_np(n_fft: int) -> np.ndarray:
    """e^{-2 pi i k / n_fft} for k < n_fft/2 as float64 [n_fft/2, 2] (re, im)."""
    ang = 2.0 * np.pi * np.arange(n_fft // 2, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1)


@functools.lru_cache(maxsize=16)
def fold_twiddles(n_fft: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """The folded path's table: e^{-2 pi i m / n_fft} for m < n_fft as
    float64 [n_fft, 2] (re, im) on ``device`` (cached)."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return torch.as_tensor(np.stack([np.cos(ang), -np.sin(ang)], axis=-1), device=device)


@functools.lru_cache(maxsize=16)
def fft_twiddles(n_fft: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """The FFT mode's twiddle table: :func:`fft_twiddles_np` cast to float32
    on ``device`` (cached per device, like ``make_matrices``)."""
    return torch.as_tensor(fft_twiddles_np(n_fft), dtype=torch.float32, device=device)


def mel_ranges(cfg: FrontendConfig) -> np.ndarray:
    """First and last nonzero bin of each mel filter, int64 [n_mels, 2], read
    off ``mel_fb_t``; a filter with no nonzero bin is (0, -1)."""
    fb = fe.matrices_np(cfg)[3].T                        # [M, K]
    out = np.zeros((cfg.n_mels, 2), dtype=np.int64)
    out[:, 1] = -1
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if nz.size:
            out[m] = nz[0], nz[-1]
    return out


def mel_nnz(cfg: FrontendConfig) -> int:
    """Weights the FFT mode stages: every bin of every filter's range."""
    r = mel_ranges(cfg)
    return int((r[:, 1] - r[:, 0] + 1).sum())


def mel_pack_np(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """The mel filters as the FFT mode reads them: int32 [n_mels, 3] of (first
    bin, bin count, offset into the weights), and the float64 weights of each
    filter's range, filter after filter."""
    fb = fe.matrices_np(cfg)[3].T
    r = mel_ranges(cfg)
    counts = r[:, 1] - r[:, 0] + 1
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    weights = np.concatenate([fb[m, lo:hi + 1] for m, (lo, hi) in enumerate(r)])
    return np.stack([r[:, 0], counts, offsets], axis=-1).astype(np.int32), weights


@functools.lru_cache(maxsize=16)
def mel_pack(cfg: FrontendConfig, device: str | torch.device = "cuda"):
    """:func:`mel_pack_np` on ``device``, the weights as float32 (cached)."""
    rng, w = mel_pack_np(cfg)
    return (torch.as_tensor(rng, device=device),
            torch.as_tensor(w, dtype=torch.float32, device=device))


def _check_config(cfg: FrontendConfig, width: int) -> None:
    if cfg.denoise is not None:
        raise ValueError("the fused MFCC kernel does not implement "
                         "FrontendConfig.denoise (needs a cross-frame "
                         "noise estimate); use impl='xla'")
    if width != cfg.frame_len:
        raise ValueError(f"frames width {width} != cfg.frame_len "
                         f"{cfg.frame_len} — framed under a different "
                         "FrontendConfig?")


def mfcc_frames_plain(frames: torch.Tensor,
                      cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Plain PyTorch version of the kernel: frames [N, L] -> [N, n_mfcc]."""
    _check_config(cfg, frames.shape[-1])
    return fe.mfcc_from_frames(frames, fe.make_matrices(cfg, frames.device), cfg)


def mfcc_frames_fused(frames: torch.Tensor,
                      cfg: FrontendConfig = FrontendConfig(),
                      plan: Plan | None = None) -> torch.Tensor:
    """Pre-emphasised frames [N, L] float32 -> MFCC [N, n_mfcc].

    ``plan`` defaults to :func:`launch_plan`'s; a caller that holds the two
    modes against each other at one ``n_fft`` passes the other's."""
    if frames.dim() != 2:
        raise ValueError(f"frames must be [N, L], got {tuple(frames.shape)}")
    _check_config(cfg, frames.shape[1])
    if frames.device.type == "cpu":
        return mfcc_frames_plain(frames, cfg)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError(f"frames must be contiguous float32, got {frames.dtype}"
                         f"{'' if frames.is_contiguous() else ' (strided)'}")
    n = frames.shape[0]
    out = torch.empty((n, cfg.n_mfcc), dtype=torch.float32, device=frames.device)
    if n == 0:
        return out
    plan = launch_plan(cfg) if plan is None else plan
    mats = fe.make_matrices(cfg, frames.device)
    if plan.mode == "fft":
        rng, mel_w = mel_pack(cfg, frames.device)
        ptrs = (None, None, fft_twiddles(cfg.n_fft, frames.device).data_ptr(),
                rng.data_ptr(), mel_w.data_ptr(), None)
        n_mel_w = mel_w.numel()
    else:
        ptrs = (mats.dft_cos.data_ptr(), mats.dft_sin.data_ptr(), None, None, None,
                mats.mel_fb_t.data_ptr())
        n_mel_w = 0
    fold = ((fe.fold_matrices(cfg, frames.device)[0].data_ptr(),
             fold_twiddles(cfg.n_fft, frames.device).data_ptr())
            if folded(cfg) else (None, None))
    _build.launch("mfcc_fused", frames.device, frames.data_ptr(),
                  mats.window.data_ptr(), *ptrs, mats.dct_t.data_ptr(),
                  mats.lifter.data_ptr(), *fold, out.data_ptr(), n, cfg.frame_len,
                  cfg.n_fft, cfg.n_mels, cfg.n_mfcc, n_mel_w, float(cfg.log_floor),
                  int(cfg.use_energy), MODES[plan.mode], plan.warps,
                  plan.frames_per_warp, plan.smem_bytes)
    return out


def mfcc_fused(x: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Signals [..., N] -> MFCC [..., T, n_mfcc] through the fused kernel.

    Batch dims are flattened into the frame axis so one launch serves
    the whole batch."""
    y = fe.preemphasis(x, cfg.preemphasis)
    frames = fe.frame(y, cfg.frame_len, cfg.hop_len)
    lead = frames.shape[:-1]
    # one signal's frames reshape to an overlapping view, not a copy
    ceps = mfcc_frames_fused(frames.reshape(-1, cfg.frame_len).contiguous(), cfg)
    return ceps.reshape(*lead, cfg.n_mfcc)
