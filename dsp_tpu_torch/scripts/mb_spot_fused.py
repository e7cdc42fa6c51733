"""Microbenchmark: the subsequence DTW (spotting) kernel, kernel 3.

    python -m dsp_tpu_torch.scripts.mb_spot_fused [--b 64 --u 595] [--scan]

Port of ``scripts/mb_spot_fused.py``: kernel 3
(``kernels/spot_fused.py:subseq_dtw_fused``) at the spotting shape of 64
streams of ~6 s against 100 templates (U = 595, T = 198, F = 39), on
standard-normal streams and templates and seeded lengths drawn from
``default_rng(0)`` in the JAX script's order (streams, bank, stream
lengths in [U/2, U], template lengths in [min(50, T), T]).  Times are CUDA
events over back-to-back calls (``utils/timing.chained_timeit_spread``:
the median, lowest and highest of ``--passes`` passes of ``--iters``
calls), printed as ms a call and audio seconds a second at 100 frames a
second, beside the launch plan (mode, warps a block, warps a stream).

Before timing, the kernel's output is held to its plain version
(``ops/spot.py:subseq_dtw_batch_plain``) on the card by the tie-aware rule
of ``scripts.compare_spot`` (BIG pattern identical, norms at rtol 2e-4
where the start witnesses agree, near-ties under 0.1 %); a mismatch
raises.  This takes the place of the JAX script's check across stream
tiles.  ``--scan`` also times the plain version.  ``--tiles`` (the TPU
kernel's STREAM_TILE sweep) and ``--interpret`` (Pallas interpret mode)
are TPU-only and left out.  Raises for a device that is not a CUDA card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

FRAMES_PER_S = 100.0      # hop 160 at 16 kHz


def inputs(b: int, k: int, u: int, t: int, f: int, device):
    """(streams [b, u, f], stream lengths [b], bank [k, t, f], template
    lengths [k]) drawn from ``default_rng(0)`` in the JAX script's order."""
    rng = np.random.default_rng(0)
    streams = rng.standard_normal((b, u, f)).astype(np.float32)
    bank = rng.standard_normal((k, t, f)).astype(np.float32)
    sl = rng.integers(u // 2, u + 1, size=b).astype(np.int32)
    tl = rng.integers(min(50, t), t + 1, size=k).astype(np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (streams, sl, bank, tl))


def audio_seconds(sl) -> float:
    """Audio seconds a call: the streams' frames at 100 frames a second."""
    return float(np.sum(np.asarray(sl.cpu()))) / FRAMES_PER_S


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--u", type=int, default=595)
    ap.add_argument("--t", type=int, default=198)
    ap.add_argument("--f", type=int, default=39)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--scan", action="store_true", help="also time the plain version")
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (default cuda: the card)")
    args = ap.parse_args(argv)

    from dsp_tpu_torch.kernels import spot_fused as ksp
    from dsp_tpu_torch.scripts import compare_spot, describe_device, require_card
    from dsp_tpu_torch.utils.timing import chained_timeit_spread

    dev = require_card(args.device, "mb_spot_fused")
    print(f"# device: {describe_device(dev)}")
    streams, sl, bank, tl = inputs(args.b, args.k, args.u, args.t, args.f, dev)
    audio_s = audio_seconds(sl)
    print(f"[shape] B={args.b} K={args.k} U={args.u} T={args.t} "
          f"F={args.f}  audio={audio_s:.1f}s/iter")

    out = {"audio_s": audio_s, "shape": (args.b, args.k, args.u, args.t, args.f),
           "cells": int(sl.sum()) * int(tl.sum())}
    got = ksp.subseq_dtw_fused(streams, sl, bank, tl)
    want = ksp.subseq_dtw_batch_plain(streams, sl, bank, tl)
    out["check"] = compare_spot([x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want],
                                sl.cpu().numpy(), tl.cpu().numpy(), "mb_spot_fused")
    window, warps, w_pair, _ = ksp.launch_plan(args.b, args.k, args.u, args.t, args.f)
    plan = f"{'window' if window else 'staged'} x{warps}, {w_pair} a stream"
    rows = [("fused", plan, ksp.subseq_dtw_fused)]
    if args.scan:
        rows.append(("scan", "plain", ksp.subseq_dtw_batch_plain))
    for name, label, fn in rows:
        med, lo, hi = chained_timeit_spread(fn, (streams, sl, bank, tl), n_iters=args.iters,
                                            passes=args.passes)
        print(f"[{name} {label}] {med * 1e3:8.3f} ms/iter "
              f"({lo * 1e3:.3f}..{hi * 1e3:.3f})  {audio_s / med:9.1f} audio-s/s", flush=True)
        out[name] = dict(plan=label, ms=med * 1e3, ms_lo=lo * 1e3, ms_hi=hi * 1e3,
                         audio_s_per_s=audio_s / med)
    print(f"# kernel against plain: {out['check']['witness_flips']} witness flips, "
          f"max abs err {out['check']['max_abs_err']:.3e}")
    return out


if __name__ == "__main__":
    main()
