"""Fused MFCC front-end: CUDA kernel wrapper and its plain version.

Port of ``dsp_tpu/kernels/mfcc_pallas.py`` (``mfcc_frames_pallas``,
``mfcc_pallas``).  The kernel (``csrc/mfcc_fused.cu``) takes pre-emphasised
frames [N, L] to cepstra [N, n_mfcc] in one pass; its header says what
bounds it.  Pre-emphasis and framing stay plain PyTorch, as in the JAX
package.

:func:`mfcc_frames_fused` takes CUDA tensors to the kernel and CPU tensors
to :func:`mfcc_frames_plain` (``ops/frontend.py:mfcc_from_frames``); it
never falls back from one to the other.
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.config import FrontendConfig
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.ops import frontend as fe


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
                      cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Pre-emphasised frames [N, L] float32 -> MFCC [N, n_mfcc]."""
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
    mats = fe.make_matrices(cfg, frames.device)
    _build.launch("mfcc_fused", frames.device, frames.data_ptr(),
                  mats.window.data_ptr(), mats.dft_cos.data_ptr(),
                  mats.dft_sin.data_ptr(), mats.mel_fb_t.data_ptr(),
                  mats.dct_t.data_ptr(), mats.lifter.data_ptr(), out.data_ptr(), n,
                  cfg.frame_len, cfg.n_bins, cfg.n_mels, cfg.n_mfcc,
                  float(cfg.n_fft), float(cfg.log_floor), int(cfg.use_energy))
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
