"""Hostile-benchmark matrix: conditions x configurations.

    python -m dsp_tpu_torch.scripts.hostile_matrix [--device cuda]
    python -m dsp_tpu_torch.scripts.hostile_matrix --quick    # 1 test speaker, 4 conditions
    python -m dsp_tpu_torch.scripts.hostile_matrix --conditions clean,snr0 --configs default,2pass

Port of ``scripts/hostile_matrix.py``: kNN-DTW configurations (CMN,
spectral-subtraction denoise, bands, the Itakura slope, k = 3, the
two-pass VAD, causal CMN) on the hostile corpus (``io/hostile.py``: 35
confusable classes, held-out speakers, noise / channel-tilt / reverb
conditions).  Every cell is an ``evaluate`` through kernel 1 on the card.
A condition's row goes to stderr as it finishes; stdout gets a summary
line, the markdown matrix (best cell of each row in bold) and one JSON
object ``{"results": {condition: {config: accuracy}}, "n_queries": n}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _listed(text: str) -> tuple:
    return tuple(text.split(","))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="one test speaker and the conditions clean, snr10, "
                         "snr0 and tilt")
    ap.add_argument("--conditions", type=_listed, default=None,
                    help="comma list: run only these conditions")
    ap.add_argument("--configs", type=_listed, default=None,
                    help="comma list: run only these configurations")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    args = ap.parse_args(argv)

    from dsp_tpu_torch.config import (DtwConfig, FrontendConfig, PipelineConfig,
                                      VadConfig)
    from dsp_tpu_torch.io.hostile import hostile_vocab, make_hostile_corpus
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    from dsp_tpu_torch.scripts import describe_device

    vocab = hostile_vocab()
    train_speakers = (0, 1, 2)
    test_speakers = (4,) if args.quick else (4, 5)
    n_train_per, n_test_per = 2, 2
    conditions = (("clean", "snr10", "snr0", "tilt") if args.quick else
                  ("clean", "snr20", "snr10", "snr5", "snr0",
                   "tilt", "reverb", "tilt+snr10"))
    conditions = args.conditions or conditions

    def fcfg(**kw):
        return FrontendConfig(**kw)

    configs = [
        ("default", PipelineConfig(), {}),
        ("cmn", PipelineConfig(frontend=fcfg(cmn=True)), {}),
        ("denoise", PipelineConfig(
            frontend=fcfg(denoise="spectral_subtraction")), {}),
        ("band .10", PipelineConfig(dtw=DtwConfig(band_frac=0.10)), {}),
        ("band .25", PipelineConfig(dtw=DtwConfig(band_frac=0.25)), {}),
        ("itakura", PipelineConfig(dtw=DtwConfig(slope="itakura")), {}),
        ("k=3", PipelineConfig(), {"k": 3}),
        ("cmn+denoise", PipelineConfig(
            frontend=fcfg(cmn=True, denoise="spectral_subtraction")), {}),
        # SNR-adaptive two-pass VAD thresholds: noise_mult's TH = 4x noise
        # never fires at ~0 dB; two_pass interpolates floor..ceiling
        ("2pass", PipelineConfig(
            vad=VadConfig(threshold_mode="two_pass")), {}),
        ("2pass+dn", PipelineConfig(
            vad=VadConfig(threshold_mode="two_pass"),
            frontend=fcfg(denoise="spectral_subtraction")), {}),
        # causal CMN: the streaming mode's divergence from utterance CMN
        ("causal-cmn", PipelineConfig(
            frontend=fcfg(cmn=True, cmn_mode="causal")), {}),
    ]
    if args.configs:
        configs = [c for c in configs if c[0] in args.configs]

    train = make_hostile_corpus(vocab, speakers=train_speakers,
                                n_per=n_train_per)
    recs = []
    for name, cfg, kw in configs:
        rec = KnnDtwRecognizer(cfg, device=args.device, **kw)
        for lab, sigs in train.items():
            rec.enroll(lab, sigs)
        recs.append((name, rec))

    results = {}          # condition -> {config: accuracy}
    t0 = time.perf_counter()
    for cond in conditions:
        test = make_hostile_corpus(vocab, speakers=test_speakers,
                                   n_per=n_test_per, seed=9, condition=cond)
        row = {}
        for name, rec in recs:
            row[name] = rec.evaluate(test)["accuracy"]
        results[cond] = row
        print(f"# {cond}: " + "  ".join(f"{k}={v:.3f}" for k, v in row.items()),
              file=sys.stderr, flush=True)
    dt = time.perf_counter() - t0

    n_q = len(vocab) * len(test_speakers) * n_test_per
    print(f"device: {describe_device(args.device)}; bank "
          f"{len(vocab) * len(train_speakers) * n_train_per}"
          f" templates, {n_q} queries/condition, {dt:.0f}s total")
    print()
    names = [n for n, _, _ in configs]
    print("| condition | " + " | ".join(names) + " |")
    print("|---" * (len(names) + 1) + "|")
    for cond in conditions:
        row = results[cond]
        best = max(row.values())
        cells = [f"**{row[n]:.3f}**" if row[n] == best else f"{row[n]:.3f}"
                 for n in names]
        print(f"| {cond} | " + " | ".join(cells) + " |")
    print()
    print(json.dumps({"results": results, "n_queries": n_q}))


if __name__ == "__main__":
    main()
