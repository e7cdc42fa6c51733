"""OOV-rejection operating points on the hostile corpus.

    python -m dsp_tpu_torch.scripts.oov_eval [--quick] [--conditions clean,snr5]
                                             [--enrolled 25] [--oov N] [--device cuda]

Port of ``scripts/oov_eval.py``.  Enrolls a subset of the 35-class hostile
vocabulary, calibrates the per-bank rejection thresholds (kNN:
``KnnDtwRecognizer.calibrate_rejection``; GMM-HMM: the UBM-LLR calibration)
and measures on held-out speakers the three utterance-verification rates
the threshold trades off:

* in-vocab accuracy: accepted and correct / in-vocab queries
* false-reject rate: in-vocab queries rejected
* false-accept rate: OOV queries (the unenrolled classes) accepted

at the calibrated threshold and a sweep around it (multiplicative for DTW
distances, additive for the HMM's per-frame LLR).  The sweep is post hoc
over score arrays read back once, so each condition costs one classify
pass a family: kernel 1 on the card for kNN, no kernel for the GMM-HMM.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="one test speaker; conditions default to clean")
    ap.add_argument("--conditions", default=None,
                    help="comma list (default clean,snr10,snr5; clean with "
                         "--quick)")
    ap.add_argument("--enrolled", type=int, default=25,
                    help="enrolled classes: the vocabulary's first N")
    ap.add_argument("--oov", default="",
                    help="cap the OOV classes at N")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    args = ap.parse_args(argv)

    import numpy as np

    from dsp_tpu_torch.config import HmmConfig, PipelineConfig
    from dsp_tpu_torch.io.hostile import hostile_vocab, make_hostile_corpus
    from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer, score_words
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    from dsp_tpu_torch.scripts import describe_device

    vocab = hostile_vocab()
    in_vocab, oov = vocab[:args.enrolled], vocab[args.enrolled:]
    if args.oov:
        oov = oov[: int(args.oov)]
    conditions = (args.conditions or ("clean" if args.quick else
                                      "clean,snr10,snr5")).split(",")
    train_speakers, test_speakers = (0, 1, 2), ((4,) if args.quick else (4, 5))
    n_train_per, n_test_per = 2, 2
    cfg = PipelineConfig()

    train = make_hostile_corpus(in_vocab, speakers=train_speakers,
                                n_per=n_train_per)
    rec = KnnDtwRecognizer(cfg, device=args.device)
    for lab, sigs in train.items():
        rec.enroll(lab, sigs)
    thr = rec.calibrate_rejection()
    hmm = GmmHmmRecognizer(cfg, HmmConfig(), device=args.device)
    hmm.fit(train)
    hthr = hmm.calibrate_rejection(train)
    print(f"# enrolled {len(in_vocab)} classes "
          f"({rec.n_templates} templates), {len(oov)} OOV classes; "
          f"knn threshold {thr:.2f}, hmm LLR threshold {hthr:.2f}",
          file=sys.stderr, flush=True)

    ids = np.asarray(rec._bank_label_ids)

    def knn_rates(d_in, want_ids, d_out, t):
        """Post-hoc rates at threshold t from [B, K] distance fields."""
        bd_in, bd_out = d_in.min(axis=1), d_out.min(axis=1)
        pred = ids[d_in.argmin(axis=1)]            # 1-NN label ids
        acc = float(np.mean((pred == want_ids) & (bd_in < t)))
        fr = float(np.mean(bd_in >= t))
        fa = float(np.mean(bd_out < t))
        return acc, fr, fa

    def hmm_llr(signals):
        feats = hmm.extract(signals)
        scores = score_words(feats.feats, feats.length, hmm.params).cpu().numpy()
        return scores.argmax(axis=1), hmm._utterance_llr(feats, scores, hmm.ubm)

    t0 = time.perf_counter()
    for cond in conditions:
        test_in = make_hostile_corpus(in_vocab, speakers=test_speakers,
                                      n_per=n_test_per, seed=9,
                                      condition=cond)
        test_oov = make_hostile_corpus(oov, speakers=test_speakers,
                                       n_per=n_test_per, seed=9,
                                       condition=cond)
        sig_in, want = [], []
        for lab, xs in test_in.items():
            sig_in.extend(xs)
            want.extend([rec.labels.index(lab)] * len(xs))
        want = np.asarray(want)
        sig_out = [x for xs in test_oov.values() for x in xs]

        _, d_in = rec.classify_batch(sig_in, return_distances=True)
        _, d_out = rec.classify_batch(sig_out, return_distances=True)
        print(f"\n== {cond}: {len(sig_in)} in-vocab + {len(sig_out)} OOV "
              f"queries ==")
        print("knn-dtw   thr      acc     FR      FA")
        for mult in (0.8, 0.9, 1.0, 1.1, 1.2):
            t = thr * mult
            acc, fr, fa = knn_rates(d_in, want, d_out, t)
            star = " <- calibrated" if mult == 1.0 else ""
            print(f"  x{mult:<4} {t:7.2f}  {acc:.3f}  {fr:.3f}  "
                  f"{fa:.3f}{star}")

        hpred_in, hllr_in = hmm_llr(sig_in)
        hwant = np.asarray([hmm.labels.index(rec.labels[i]) for i in want])
        _, hllr_out = hmm_llr(sig_out)
        print("gmm-hmm   thr      acc     FR      FA")
        for off in (-6.0, -3.0, 0.0, 3.0, 6.0):
            t = hthr + off
            acc = float(np.mean((hpred_in == hwant) & (hllr_in >= t)))
            fr = float(np.mean(hllr_in < t))
            fa = float(np.mean(hllr_out >= t))
            star = " <- calibrated" if off == 0.0 else ""
            print(f"  {off:+4.0f} {t:7.2f}  {acc:.3f}  {fr:.3f}  "
                  f"{fa:.3f}{star}")

    print(f"\n# device {describe_device(args.device)}; "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
