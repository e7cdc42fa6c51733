"""VadConfig sweep against the hostile benchmark's low-SNR collapse.

    python -m dsp_tpu_torch.scripts.hostile_vad [--device cuda]

Port of ``scripts/hostile_vad.py``: four endpoint-detector settings (the
sensitive 4/1.5 thresholds are the shipped ``VadConfig`` defaults; the
labels name the older settings explicitly) against a clean control and
three low-SNR conditions of the hostile corpus (35 confusable classes,
held-out speakers).  Each cell is a kNN-DTW ``evaluate``: kernel 1 on the
card.  A condition's row goes to stderr as it finishes; the table, with
the best cell of each row in bold, to stdout.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    args = ap.parse_args(argv)

    import dataclasses

    from dsp_tpu_torch.config import PipelineConfig, VadConfig
    from dsp_tpu_torch.io.hostile import hostile_vocab, make_hostile_corpus
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    from dsp_tpu_torch.scripts import describe_device

    vocab = hostile_vocab()
    variants = [
        ("round-2 default (8/2)", VadConfig(e_high_mult=8.0, e_low_mult=2.0)),
        ("sensitive (4/1.5)", VadConfig(e_high_mult=4.0, e_low_mult=1.5)),
        ("sensitive+long (4/1.5,msf=8)",
         VadConfig(e_high_mult=4.0, e_low_mult=1.5, min_speech_frames=8)),
        ("conservative (12/3)", VadConfig(e_high_mult=12.0, e_low_mult=3.0)),
    ]
    conditions = ("clean", "snr10", "snr5", "snr0")

    train = make_hostile_corpus(vocab, speakers=(0, 1, 2), n_per=2)
    recs = []
    for name, vcfg in variants:
        cfg = dataclasses.replace(PipelineConfig(), vad=vcfg)
        rec = KnnDtwRecognizer(cfg, device=args.device)
        for lab, sigs in train.items():
            rec.enroll(lab, sigs)
        recs.append((name, rec))

    t0 = time.perf_counter()
    rows = {}
    for cond in conditions:
        test = make_hostile_corpus(vocab, speakers=(4, 5), n_per=2,
                                   seed=9, condition=cond)
        rows[cond] = {n: r.evaluate(test)["accuracy"] for n, r in recs}
        print(f"# {cond}: " + "  ".join(f"{k}={v:.3f}"
                                        for k, v in rows[cond].items()),
              file=sys.stderr, flush=True)

    print(f"device: {describe_device(args.device)}; {time.perf_counter()-t0:.0f}s")
    names = [n for n, _ in variants]
    print("| condition | " + " | ".join(names) + " |")
    print("|---" * (len(names) + 1) + "|")
    for cond in conditions:
        best = max(rows[cond].values())
        cells = [f"**{rows[cond][n]:.3f}**" if rows[cond][n] == best
                 else f"{rows[cond][n]:.3f}" for n in names]
        print(f"| {cond} | " + " | ".join(cells) + " |")


if __name__ == "__main__":
    main()
