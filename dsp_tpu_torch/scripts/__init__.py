"""Command-line scripts of the port (run with ``python -m``).

``mb_wavefront`` measures kernels 6-10.  The evaluation scripts
(``results_matrix``, ``robustness``, ``hostile_vad``, ``hostile_matrix``,
``oov_eval``, ``spot_eval``, ``connected_eval``, ``grammar_eval``) and the
measurement scripts (``cascade_timing``, ``serve_latency``, ``fe_profile``,
``mb_long_t``, ``mb_fused_banded``, ``mb_spot_fused``, ``roofline``) are
the JAX package's ``scripts/`` of the same names: the same flags, corpora,
shapes and lines, on the device ``--device`` names (default ``cuda``; no
probe, no fallback).  ``fe_profile`` and the ``mb_*`` scripts time with
CUDA events and refuse any other device; ``roofline`` needs none.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

BIG_FLOOR = 1e20      # distances at or past this are unreachable pairs


def describe_device(device) -> str:
    """What the JAX scripts print as ``jax.devices()[0]``: the torch device
    and, on a card, ``nvidia-smi``'s name and power limit of it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    return f"cuda:{index} ({smi})"


def require_card(device="cuda", what: str = "this script") -> torch.device:
    """The device, if it is a CUDA card that torch can reach; else raise."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on a CUDA card only (device {dev}, "
                           f"torch.cuda.is_available() {torch.cuda.is_available()})")
    return dev


def dtw_inputs(b: int, k: int, t: int, f: int, device):
    """Standard-normal queries [b, t, f] then templates [k, t, f] from
    ``default_rng(0)`` (drawn in float64, then cast, as the JAX scripts
    draw them), with full int32 lengths, on ``device``."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, t, f)).astype(np.float32)).to(device)
    bank = torch.from_numpy(rng.standard_normal((k, t, f)).astype(np.float32)).to(device)
    ql = torch.full((b,), t, dtype=torch.int32, device=device)
    bl = torch.full((k,), t, dtype=torch.int32, device=device)
    return q, ql, bank, bl


def compare_dtw(got, want, rtol: float, atol: float = 0.0):
    """Two distance arrays [B, K] (tensors on any device): the BIG/finite
    pattern must match and the finite entries agree at ``rtol`` (and
    ``atol``); else RuntimeError.  Returns (max relative error, max
    absolute error, finite share)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.shape != want.shape:
        raise RuntimeError(f"dtw shape {got.shape} != {want.shape}")
    if np.isnan(got).any():
        raise RuntimeError("dtw kernel produced NaN")
    dead_g, dead_w = got >= BIG_FLOOR, want >= BIG_FLOOR
    if (dead_g != dead_w).any():
        raise RuntimeError(f"dtw BIG/finite pattern differs in {(dead_g != dead_w).sum()} pairs")
    fin = ~dead_w
    if not fin.any():
        return 0.0, 0.0, 0.0
    abs_err = np.abs(got[fin] - want[fin])
    rel = abs_err / np.abs(want[fin])
    if (abs_err > atol + rtol * np.abs(want[fin])).any():
        raise RuntimeError(f"dtw distances differ: max rel err {rel.max():.3e} > {rtol} "
                           f"(max abs err {abs_err.max():.3e}, atol {atol})")
    return float(rel.max()), float(abs_err.max()), float(fin.mean())


def compare_spot(got, want, s_lens, b_lens, what: str, rtol: float = 2e-4) -> dict:
    """Tie-aware comparison of two (norm [B,K,U], start [B,K,U]) fields
    (numpy): identical BIG pattern; norms at ``rtol`` where the witnesses
    agree; raw costs at 1e-4 where they differ, at under 0.1% of the valid
    (stream, template, end column) sites (``tests/test_tpu_device.py:333``);
    else RuntimeError."""
    (gn, gs), (wn, ws) = got, want
    if gn.shape != wn.shape or gs.shape != ws.shape:
        raise RuntimeError(f"{what}: shapes {gn.shape} vs {wn.shape}")
    if np.isnan(gn).any():
        raise RuntimeError(f"{what}: NaN in the kernel's norms")
    if ((gn >= BIG_FLOOR) != (wn >= BIG_FLOOR)).any():
        raise RuntimeError(f"{what}: BIG/finite pattern differs at "
                           f"{((gn >= BIG_FLOOR) != (wn >= BIG_FLOOR)).sum()} sites")
    j = np.arange(gn.shape[-1])[None, None, :]
    valid = np.broadcast_to(j < np.asarray(s_lens)[:, None, None], gn.shape)
    agree, flip = valid & (gs == ws), valid & (gs != ws)
    abs_err = np.abs(gn - wn)[agree]
    rel = abs_err / np.maximum(np.abs(wn[agree]), 1e-30)
    if ((abs_err > rtol * np.abs(wn[agree]) + 1e-5)).any():
        raise RuntimeError(f"{what}: norms differ where the witnesses agree: max rel err "
                           f"{rel.max():.3e}")
    tl = np.maximum(np.asarray(b_lens), 1).astype(np.float64)[None, :, None]
    raw_g, raw_w = gn * (tl + j - gs + 1), wn * (tl + j - ws + 1)
    raw_rel = np.abs(raw_g - raw_w)[flip] / np.abs(raw_w[flip])
    if (raw_rel > 1e-4).any():
        raise RuntimeError(f"{what}: witnesses differ at {int(flip.sum())} sites, raw costs "
                           f"up to {raw_rel.max():.3e} apart (not near-ties)")
    share = float(flip.sum() / max(1, valid.sum()))
    if share >= 1e-3:
        raise RuntimeError(f"{what}: witnesses differ at {share:.2e} of valid sites (>= 0.1%)")
    return dict(n_sites=int(valid.sum()), max_abs_err=float(abs_err.max()) if abs_err.size else 0.0,
                max_rel_err=float(rel.max()) if rel.size else 0.0,
                witness_flips=int(flip.sum()), flip_share=share,
                max_raw_rel_at_flips=float(raw_rel.max()) if raw_rel.size else 0.0)
