"""Connected-word recognition accuracy matrix.

    python -m dsp_tpu_torch.scripts.connected_eval [--clips 60] [--noise 0.005] [--device cuda]

Port of ``scripts/connected_eval.py``.  Builds the standard synthetic
corpus, then evaluates every model family on connected recordings of 1-5
words (``io/dataset.py:synth_connected``, seeds disjoint from
enrollment), printing word error rate (Levenshtein over label
sequences), exact-sequence accuracy and segment-count accuracy a family:
the kNN VAD split (kernel 1 on the card, once a chunk of recordings),
template level building, the GMM-HMM by the VAD split and by the
connected Viterbi, the GMM-HMM with PMC noise adaptation, and VQ (no
kernel for the last five).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=60)
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--train-noise", type=float, default=0.005,
                    help="noise level of the enrollment/training corpus "
                         "(match --noise to measure in-noise refits, the "
                         "remedy for the HMM's clean-trained emission "
                         "mismatch)")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--gapless", action="store_true",
                    help="butt words together with no silence gap: the "
                         "case the VAD splitter cannot segment and level "
                         "building exists for")
    ap.add_argument("--word-penalty", type=float, default=0.0,
                    help="level-building per-word cost bias")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    args = ap.parse_args(argv)

    from dsp_tpu_torch.config import PipelineConfig
    from dsp_tpu_torch.io.dataset import DIGITS, make_corpus, synth_connected
    from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    from dsp_tpu_torch.models.vq import VqRecognizer
    from dsp_tpu_torch.pipeline import edit_distance
    from dsp_tpu_torch.scripts import describe_device

    dev = args.device
    cfg = PipelineConfig()
    corpus = make_corpus(n_per_word=3, seed=0, noise=args.train_noise)

    rng = np.random.default_rng(args.seed)
    gap_ms = ((0.0, 1.0) if args.gapless else (250.0, 600.0))
    truths, clips = [], []
    for i in range(args.clips):
        labs = [DIGITS[int(rng.integers(10))]
                for _ in range(int(rng.integers(1, 6)))]
        truths.append(labs)
        clips.append(synth_connected(labs, args.seed + i,
                                     noise=args.noise, gap_ms=gap_ms))

    knn = KnnDtwRecognizer(cfg, k=1, device=dev)
    for lab, xs in corpus.items():
        knn.enroll(lab, xs)
    hmm = GmmHmmRecognizer(cfg, device=dev)
    hmm.fit(corpus)
    vq = VqRecognizer(cfg, device=dev)
    vq.fit(corpus)

    n_words = sum(len(t) for t in truths)
    print(f"# device: {describe_device(dev)}")
    print(f"# connected eval: {args.clips} clips, {n_words} words, "
          f"noise={args.noise}, train-noise={args.train_noise}, "
          f"gaps={'NONE (gapless)' if args.gapless else 'normal'}")
    print("| family | WER | exact-seq acc | seg-count acc |")
    print("|---|---|---|---|")
    hmm_adapt = GmmHmmRecognizer(cfg, noise_adapt=True, device=dev)
    hmm_adapt.labels, hmm_adapt.params = hmm.labels, hmm.params

    rows = [("kNN-DTW (vad split)", knn, {}),
            ("kNN-DTW (level building)", knn,
             {"method": "level", "word_penalty": args.word_penalty}),
            ("GMM-HMM", hmm, {}),
            ("GMM-HMM (connected Viterbi)", hmm,
             {"method": "level", "word_penalty": args.word_penalty}),
            ("GMM-HMM +noise-adapt", hmm_adapt, {}), ("VQ", vq, {})]
    for name, fam, kw in rows:
        got = fam.classify_connected(clips, **kw)
        errs = sum(edit_distance(g, t) for g, t in zip(got, truths))
        exact = sum(g == t for g, t in zip(got, truths))
        segs = sum(len(g) == len(t) for g, t in zip(got, truths))
        print(f"| {name} | {errs / n_words:.3f} | "
              f"{exact / args.clips:.3f} | {segs / args.clips:.3f} |",
              flush=True)


if __name__ == "__main__":
    main()
