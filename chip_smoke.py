#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dsp_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--out report.json]

Run from the repository root on a machine with one CUDA card.  Phases,
each of which raises on failure (non-zero exit):

1. build   — compile the CUDA kernels from ``dsp_tpu_torch/csrc`` (nvcc).
2. dtw     — the banded DTW kernel against its plain PyTorch version at the
             main-path shape (B=256 queries x K=100 templates, T=U=198,
             F=39, seeded lengths in [20, 198]) under four configs, plus a
             sliding-window shape (T=120, U=300, band 0.1).  The BIG/finite
             pattern must be identical and finite distances allclose at
             rtol 1e-4 (other summation order; the kernel sums (a-b)^2
             directly where the plain version expands |a|^2+|b|^2-2ab).
3. mfcc    — the fused MFCC kernel against its plain version on the
             50,688 frames of 256 synthetic 2 s utterances, use_energy off
             and on, allclose at rtol/atol 1e-3.
4. small   — ``pipeline.dtw_pairs`` with ``impl="auto"`` on small batches
             (one query against 1, 10 and 100 templates; 8 against 10):
             one kernel launch per call, distances as the plain scan's
             (rtol 1e-4), both timed.
5. main    — ``KnnDtwRecognizer(device="cuda")``: enroll 10 digits x 10
             synthetic templates, classify 1024 queries (chunks of 256)
             with the default config and with the fused front-end
             (``FrontendConfig(impl="pallas")``); kernel launch counts are
             reset just before and read just after, and the labels must
             equal those of the plain paths on the card (a mismatch is
             allowed only where the plain top-2 distances are within 1e-4
             relative); one ``recognize`` call per config must launch the
             DTW kernel once (none on the plain paths) and give the label
             the batch gave.

Kernel timings are CUDA-event medians of 5 runs after a warm-up; the main
path's alignments/s is the median of 3 synchronized host-clock passes
after the checked one, and one 256-query chunk is broken into stages
(pad + copy, features, DTW + argmin, copy back).  The last two
lines of stdout are the kernel table and the run's result, each one JSON
object; the line before them is ``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS = 5
# (name, DtwConfig overrides, (B, K, T, U)); F = 39 throughout
DTW_CASES = [
    ("default", {}, (256, 100, 198, 198)),
    ("squared", {"squared": True}, (256, 100, 198, 198)),
    ("itakura", {"slope": "itakura"}, (256, 100, 198, 198)),
    ("unbanded", {"band_frac": None}, (256, 100, 198, 198)),
    ("sliding", {"band_frac": 0.1}, (64, 32, 120, 300)),
]
# (B, K) of the small-batch phase: single-utterance recognize() against
# command-vocabulary banks, and a few queries at once
SMALL_CASES = [(1, 1), (1, 10), (1, 100), (8, 10)]
MFCC_UTTERANCES = 256      # 256 x 198 = 50,688 frames, one main-path chunk
N_QUERIES = 1024
TEMPLATES_PER_WORD = 10
MAIN_PASSES = 3            # timed classify passes after the checked one


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_dtw(got, want, rtol: float):
    """BIG/finite pattern must match; finite entries allclose at rtol.
    Returns (max relative error, max absolute error, finite share)."""
    import numpy as np

    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.shape != want.shape:
        fail(f"dtw shape {got.shape} != {want.shape}")
    if np.isnan(got).any():
        fail("dtw kernel produced NaN")
    dead_g, dead_w = got >= 1e20, want >= 1e20
    if (dead_g != dead_w).any():
        fail(f"dtw BIG/finite pattern differs in {(dead_g != dead_w).sum()} pairs")
    fin = ~dead_w
    if not fin.any():
        return 0.0, 0.0, 0.0
    abs_err = np.abs(got[fin] - want[fin])
    rel = abs_err / np.abs(want[fin])
    if (rel > rtol).any():
        fail(f"dtw distances differ: max rel err {rel.max():.3e} > {rtol}")
    return float(rel.max()), float(abs_err.max()), float(fin.mean())


def dtw_phase(rng, dev, report):
    import numpy as np
    import torch

    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw

    f = 39
    for name, overrides, (b, k, t, u) in DTW_CASES:
        cfg = DtwConfig(**overrides)
        q = torch.from_numpy(rng.standard_normal((b, t, f), np.float32)).to(dev)
        bk = torch.from_numpy(rng.standard_normal((k, u, f), np.float32)).to(dev)
        ql = torch.from_numpy(rng.integers(20, t + 1, b).astype(np.int32)).to(dev)
        bl = torch.from_numpy(rng.integers(20, u + 1, k).astype(np.int32)).to(dev)
        got = kdtw.dtw_batch_fused_banded(q, ql, bk, bl, cfg)
        torch.cuda.synchronize()
        want = kdtw.dtw_batch_plain(q, ql, bk, bl, cfg)
        rel, abs_err, fin = compare_dtw(got, want, 1e-4)
        ms = time_ms(lambda: kdtw.dtw_batch_fused_banded(q, ql, bk, bl, cfg))
        plain_ms = time_ms(lambda: kdtw.dtw_batch_plain(q, ql, bk, bl, cfg))
        print(f"dtw {name:9s} B={b} K={k} T={t} U={u}: finite {fin:.4f}  "
              f"max rel err {rel:.3e}  max abs err {abs_err:.3e}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)
        report["dtw"][name] = dict(shape=[b, k, t, u, f], finite_share=fin,
                                   max_rel_err=rel, max_abs_err=abs_err,
                                   ms=ms, plain_ms=plain_ms)


def small_phase(rng, dev, report):
    import numpy as np
    import torch

    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw

    auto, scan = DtwConfig(), DtwConfig(impl="scan")
    t, f = 198, 39
    for b, k in SMALL_CASES:
        q = torch.from_numpy(rng.standard_normal((b, t, f), np.float32)).to(dev)
        bk = torch.from_numpy(rng.standard_normal((k, t, f), np.float32)).to(dev)
        ql = torch.from_numpy(rng.integers(20, t + 1, b).astype(np.int32)).to(dev)
        bl = torch.from_numpy(rng.integers(20, t + 1, k).astype(np.int32)).to(dev)
        before = kdtw.LAUNCHES
        got = pl.dtw_pairs(q, ql, bk, bl, auto)
        torch.cuda.synchronize()
        if kdtw.LAUNCHES != before + 1:
            fail(f"dtw_pairs(impl='auto') on B={b}, K={k} launched "
                 f"{kdtw.LAUNCHES - before} kernels, want 1")
        rel, abs_err, _ = compare_dtw(got, pl.dtw_pairs(q, ql, bk, bl, scan), 1e-4)
        ms = time_ms(lambda: pl.dtw_pairs(q, ql, bk, bl, auto))
        plain_ms = time_ms(lambda: pl.dtw_pairs(q, ql, bk, bl, scan))
        print(f"small B={b:<2d} K={k:<3d}: max rel err {rel:.3e}  auto (kernel) "
              f"{ms:.3f} ms  scan {plain_ms:.3f} ms", flush=True)
        report["small"][f"{b}x{k}"] = dict(max_rel_err=rel, max_abs_err=abs_err,
                                           ms=ms, plain_ms=plain_ms)


def synth_batch(n: int, seed0: int):
    """n synthetic utterances cycling over the digits, with their labels."""
    from dsp_tpu_torch.io import DIGITS, synth_word

    labels = [DIGITS[i % len(DIGITS)] for i in range(n)]
    return [synth_word(lab, seed0 + i) for i, lab in enumerate(labels)], labels


def mfcc_phase(dev, report):
    import numpy as np
    import torch

    from dsp_tpu_torch.config import FrontendConfig
    from dsp_tpu_torch.kernels import mfcc_fused as kmf
    from dsp_tpu_torch.ops import frontend as fe

    sigs, _ = synth_batch(MFCC_UTTERANCES, 5000)
    x = torch.from_numpy(np.stack(sigs)).to(dev)
    for use_energy in (False, True):
        cfg = FrontendConfig(use_energy=use_energy)
        frames = fe.frame(fe.preemphasis(x, cfg.preemphasis), cfg.frame_len,
                          cfg.hop_len).reshape(-1, cfg.frame_len).contiguous()
        got = kmf.mfcc_frames_fused(frames, cfg)
        torch.cuda.synchronize()
        want = kmf.mfcc_frames_plain(frames, cfg)
        if got.shape != want.shape or got.shape != (len(sigs) * 198, cfg.n_mfcc):
            fail(f"mfcc shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail("mfcc kernel produced non-finite values")
        err = (got - want).abs()
        if not torch.allclose(got, want, rtol=1e-3, atol=1e-3):
            fail(f"mfcc differs: max abs err {err.max().item():.3e}")
        ms = time_ms(lambda: kmf.mfcc_frames_fused(frames, cfg))
        plain_ms = time_ms(lambda: kmf.mfcc_frames_plain(frames, cfg))
        key = "use_energy" if use_energy else "default"
        print(f"mfcc {key:10s} N={frames.shape[0]}: max abs err "
              f"{err.max().item():.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms",
              flush=True)
        report["mfcc"][key] = dict(n_frames=frames.shape[0],
                                   max_abs_err=err.max().item(), ms=ms,
                                   plain_ms=plain_ms)


def stage_ms(rec, signals, reps: int = 3) -> dict:
    """Host-clock ms of each stage of one classify chunk, each stage ended by
    a synchronize (median of ``reps``): pad + copy to the card, features
    (VAD + MFCC + deltas), DTW + argmin, labels back to the host."""
    import torch

    from dsp_tpu_torch import pipeline as pl

    bank, ids = rec.device_bank()
    times = {"pad_h2d": [], "features": [], "dtw_argmin": [], "d2h": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        x, n = pl.pad_signals(signals, rec.cfg.max_samples, rec.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        feats = pl.extract_features(x, n, rec.cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        label_ids, _ = pl.classify_features(feats, bank, ids, cfg=rec.cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        label_ids.cpu()
        t4 = time.perf_counter()
        for key, a, b in (("pad_h2d", t0, t1), ("features", t1, t2),
                          ("dtw_argmin", t2, t3), ("d2h", t3, t4)):
            times[key].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def main_phase(dev, report):
    import numpy as np
    import torch

    from dsp_tpu_torch import KnnDtwRecognizer
    from dsp_tpu_torch.config import DtwConfig, FrontendConfig, PipelineConfig
    from dsp_tpu_torch.io import DIGITS, synth_word
    from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
    from dsp_tpu_torch.kernels import mfcc_fused as kmf

    base = PipelineConfig()
    configs = {
        "plain": dataclasses.replace(base, dtw=DtwConfig(impl="scan")),
        "default": base,
        "fused": dataclasses.replace(base, frontend=FrontendConfig(impl="pallas")),
    }
    bank_sigs = {lab: [synth_word(lab, i) for i in range(TEMPLATES_PER_WORD)]
                 for lab in DIGITS}
    queries, truth = synth_batch(N_QUERIES, 1000)
    out = {}
    for name, cfg in configs.items():
        rec = KnnDtwRecognizer(cfg, device=dev)
        for lab in DIGITS:
            rec.enroll(lab, bank_sigs[lab])
        torch.cuda.synchronize()
        kdtw.LAUNCHES = 0
        kmf.LAUNCHES = 0
        labels, dists = rec.classify_batch(queries, return_distances=True, chunk=256)
        torch.cuda.synchronize()
        launches = {"dtw_banded": kdtw.LAUNCHES, "mfcc_fused": kmf.LAUNCHES}
        passes = []
        for _ in range(MAIN_PASSES):
            t0 = time.perf_counter()
            rec.classify_batch(queries, chunk=256)
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
        seconds = statistics.median(passes)
        kdtw.LAUNCHES = 0
        single = rec.recognize(queries[0])
        if single != labels[0] or kdtw.LAUNCHES != int(name != "plain"):
            fail(f"main path {name!r}: recognize() gave {single!r} with "
                 f"{kdtw.LAUNCHES} DTW launches; the batch gave {labels[0]!r}")
        acc = float(np.mean([a == b for a, b in zip(labels, truth)]))
        rate = len(queries) * rec.n_templates / seconds
        stages = stage_ms(rec, queries[:256])
        print(f"main {name:7s}: launches {launches}  accuracy {acc:.4f}  "
              f"{rate:.1f} alignments/s (median {seconds:.4f} s of {MAIN_PASSES} "
              f"passes for {len(queries)} x {rec.n_templates}); one 256-chunk, ms: "
              + "  ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
        out[name] = dict(labels=labels, dists=dists, launches=launches)
        report["main"][name] = dict(launches=launches, accuracy=acc,
                                    seconds=seconds, pass_seconds=passes,
                                    alignments_per_s=rate, chunk_stage_ms=stages)

    want = {"plain": (0, 0), "default": (1, 0), "fused": (1, 1)}
    for name, (need_dtw, need_mfcc) in want.items():
        got = out[name]["launches"]
        if bool(got["dtw_banded"]) != bool(need_dtw) or bool(got["mfcc_fused"]) != bool(need_mfcc):
            fail(f"main path {name!r} launched {got}; expected dtw>0={bool(need_dtw)}, "
                 f"mfcc>0={bool(need_mfcc)}")
    plain_d = out["plain"]["dists"]
    top2 = np.sort(plain_d, axis=1)[:, :2]
    near_tie = np.abs(top2[:, 1] - top2[:, 0]) <= 1e-4 * np.abs(top2[:, 0])
    for name in ("default", "fused"):
        diff = np.array([a != b for a, b in zip(out[name]["labels"], out["plain"]["labels"])])
        if (diff & ~near_tie).any():
            fail(f"main path {name!r}: {int((diff & ~near_tie).sum())} labels differ "
                 "from the plain path outside near-ties")
        report["main"][name]["label_mismatches_at_near_ties"] = int(diff.sum())
        if report["main"][name]["accuracy"] < 0.9:
            fail(f"main path {name!r}: accuracy {report['main'][name]['accuracy']}")
    # same features (both use the plain front-end): the kernel's distances
    # must match the plain DTW's
    rel, abs_err, _ = compare_dtw(torch.from_numpy(out["default"]["dists"]),
                                  torch.from_numpy(plain_d), 1e-4)
    report["main"]["default_vs_plain_dists"] = dict(max_rel_err=rel,
                                                    max_abs_err=abs_err)
    return out["fused"]["launches"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args()

    if not (ROOT / "dsp_tpu_torch" / "__init__.py").is_file():
        fail(f"dsp_tpu_torch/ not found beside {Path(__file__).name}; run it "
             "from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import dsp_tpu_torch  # noqa: F401  (sets the fp32 matmul policy)
    from dsp_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'ran' if _build.build_seconds is not None else 'skipped: cached'})",
          flush=True)

    report = {"dtw": {}, "mfcc": {}, "small": {}, "main": {}, "nvidia_smi": smi}
    rng = np.random.default_rng(args.seed)
    dtw_phase(rng, dev, report)
    mfcc_phase(dev, report)
    small_phase(rng, dev, report)
    launches = main_phase(dev, report)
    if {m.split(".")[0] for m in sys.modules} & {"jax", "dsp_tpu"}:
        fail("the port imported jax or dsp_tpu")

    kernels = [
        {"name": "dtw_banded", "route": "cuda",
         "source": "dsp_tpu_torch/csrc/dtw_banded.cu",
         "replaces": "dsp_tpu/kernels/dtw_fused_banded.py:415",
         "launches": launches["dtw_banded"],
         "max_abs_err": report["dtw"]["default"]["max_abs_err"],
         "ms": report["dtw"]["default"]["ms"],
         "plain_ms": report["dtw"]["default"]["plain_ms"]},
        {"name": "mfcc_fused", "route": "cuda",
         "source": "dsp_tpu_torch/csrc/mfcc_fused.cu",
         "replaces": "dsp_tpu/kernels/mfcc_pallas.py:123",
         "launches": launches["mfcc_fused"],
         "max_abs_err": report["mfcc"]["default"]["max_abs_err"],
         "ms": report["mfcc"]["default"]["ms"],
         "plain_ms": report["mfcc"]["default"]["plain_ms"]},
    ]
    report["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    for line in smi:
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
