"""Capability results matrix: every recognizer x accuracy + throughput.

    python -m dsp_tpu_torch.scripts.results_matrix [--device cuda]

Port of ``scripts/results_matrix.py``: all model families and matchers on
the common synthetic corpus (10 words, 5 enrollment + 10 test utterances
each) on ``--device``, one markdown table row a recognizer.  On the card
the kNN rows run kernel 1 (``dtw_banded``), except the unbanded ``fused``
row (kernel 4) and the cascade's rerank (kernel 5's paired entry); LTW is
one GEMM, and VQ and the GMM-HMMs run no kernel.  Utterances/s is the
second of two ``evaluate`` passes (the first builds the kernels).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)

    from dsp_tpu_torch.config import (DtwConfig, FrontendConfig, HmmConfig,
                                      PipelineConfig, VqConfig)
    from dsp_tpu_torch.io.dataset import DIGITS, make_corpus
    from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    from dsp_tpu_torch.models.vq import VqRecognizer
    from dsp_tpu_torch.scripts import describe_device

    dev = args.device
    train = make_corpus(DIGITS, n_per_word=5, seed=0)
    test = make_corpus(DIGITS, n_per_word=10, seed=5000)
    n_test = sum(len(v) for v in test.values())
    rows = []

    def timed_eval(rec):
        rec.evaluate(test)                 # warm: builds the kernels it runs
        t0 = time.perf_counter()
        res = rec.evaluate(test)           # labels on the host: synchronized
        dt = time.perf_counter() - t0
        return res["accuracy"], n_test / dt

    def knn(label, **kw):
        rec = KnnDtwRecognizer(device=dev, **kw)
        for lab, sigs in train.items():
            rec.enroll(lab, sigs)
        acc, rate = timed_eval(rec)
        rows.append((label, acc, rate, rec.n_templates))

    knn("kNN-DTW (default: banded 0.17, fused kernel)", cfg=PipelineConfig())
    knn("kNN-DTW (k=3)", cfg=PipelineConfig(), k=3)
    knn("kNN-DTW (banded 0.2)",
        cfg=PipelineConfig(dtw=DtwConfig(band_frac=0.2)))
    knn("kNN-DTW (fused kernel, unbanded)",
        cfg=PipelineConfig(dtw=DtwConfig(band_frac=None, impl="fused")))
    knn("kNN-DTW (Itakura slope)",
        cfg=PipelineConfig(dtw=DtwConfig(slope="itakura")))
    knn("kNN-LTW (fast matcher)", cfg=PipelineConfig(), matcher="ltw")
    knn("cascade (LTW shortlist + DTW rerank)",
        cfg=PipelineConfig(), matcher="cascade")
    knn("kNN-DTW (LPCC features)",
        cfg=PipelineConfig(frontend=FrontendConfig(feature_type="lpcc")))
    knn("kNN-DTW (CMN)",
        cfg=PipelineConfig(frontend=FrontendConfig(cmn=True)))

    # condensed bank (DBA)
    rec = KnnDtwRecognizer(PipelineConfig(), device=dev)
    for lab, sigs in train.items():
        rec.enroll(lab, sigs)
    rec.condense("dba", n_iter=3)
    acc, rate = timed_eval(rec)
    rows.append(("kNN-DTW (DBA-condensed bank)", acc, rate, rec.n_templates))

    vrec = VqRecognizer(PipelineConfig(), VqConfig(), device=dev)
    vrec.fit(train)
    acc, rate = timed_eval(vrec)
    rows.append(("VQ codebook (64 codes)", acc, rate,
                 f"{len(vrec.labels)}x64"))

    for mode in ("viterbi", "baum_welch"):
        hrec = GmmHmmRecognizer(PipelineConfig(),
                                HmmConfig(n_states=5, n_mix=2, n_iter=6,
                                          train_mode=mode), device=dev)
        hrec.fit(train)
        acc, rate = timed_eval(hrec)
        rows.append((f"GMM-HMM ({mode})", acc, rate, "-"))

    print(f"device: {describe_device(dev)}")
    print()
    print("| recognizer | accuracy | utterances/s | bank size |")
    print("|---|---|---|---|")
    for label, acc, rate, k in rows:
        print(f"| {label} | {acc:.3f} | {rate:,.0f} | {k} |")


if __name__ == "__main__":
    main()
