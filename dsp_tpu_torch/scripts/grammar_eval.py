"""Does a word grammar buy accuracy?

    python -m dsp_tpu_torch.scripts.grammar_eval [--clips 40] [--noise 0.01,0.05] [--device cuda]

Port of ``scripts/grammar_eval.py``.  Samples connected gapless digit
strings without immediate repetition (a walk over the no-repeat pair
graph), then decodes them with and without telling the decoder that
grammar (``ops/grammar.py``, ``no_repeat``) at increasing noise.  Both
joint decoders are measured: template level building and the GMM-HMM's
connected Viterbi (with and without PMC noise adaptation); neither runs a
kernel.  The grammar is honest side information (every truth satisfies
it), so a WER gap is the value of syntactic constraints under noise.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=40)
    ap.add_argument("--noise", default="0.01,0.03,0.05",
                    help="comma list of additive-noise sigmas")
    ap.add_argument("--train-noise", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=300)
    ap.add_argument("--word-penalty", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    args = ap.parse_args(argv)

    from dsp_tpu_torch.config import PipelineConfig
    from dsp_tpu_torch.io.dataset import DIGITS, make_corpus, synth_connected
    from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    from dsp_tpu_torch.pipeline import edit_distance
    from dsp_tpu_torch.scripts import describe_device

    dev = args.device
    cfg = PipelineConfig()
    corpus = make_corpus(n_per_word=3, seed=0, noise=args.train_noise)
    grammar = {"no_repeat": True}

    knn = KnnDtwRecognizer(cfg, k=1, device=dev)
    for lab, xs in corpus.items():
        knn.enroll(lab, xs)
    hmm = GmmHmmRecognizer(cfg, device=dev)
    hmm.fit(corpus)
    # PMC-adapted twin: separates the grammar's contribution from the
    # clean-trained emissions' collapse at high noise
    hmm_adapt = GmmHmmRecognizer(cfg, noise_adapt=True, device=dev)
    hmm_adapt.labels, hmm_adapt.params = hmm.labels, hmm.params

    rng = np.random.default_rng(args.seed)
    truths = []
    for _ in range(args.clips):
        n = int(rng.integers(2, 6))
        labs = [DIGITS[int(rng.integers(10))]]
        for _ in range(n - 1):
            step = int(rng.integers(9))   # walk avoiding self-loops
            cur = DIGITS.index(labs[-1])
            labs.append(DIGITS[(cur + 1 + step) % 10])
        truths.append(labs)
    n_words = sum(len(t) for t in truths)

    print(f"# device: {describe_device(dev)}")
    print(f"# grammar eval: {args.clips} gapless clips, {n_words} words, "
          f"truths repeat-free; grammar = no_repeat; "
          f"train-noise={args.train_noise}")
    print("| decoder | noise | WER plain | WER grammar | exact plain | "
          "exact grammar |")
    print("|---|---|---|---|---|---|")
    for sigma in [float(x) for x in args.noise.split(",")]:
        clips = [synth_connected(t, args.seed + 7000 + i, noise=sigma,
                                 gap_ms=(0.0, 1.0))
                 for i, t in enumerate(truths)]
        for name, fam in (("kNN level building", knn),
                          ("GMM-HMM connected Viterbi", hmm),
                          ("GMM-HMM +noise-adapt", hmm_adapt)):
            cells = []
            for g in (None, grammar):
                got = fam.classify_connected(
                    clips, method="level", word_penalty=args.word_penalty,
                    grammar=g)
                errs = sum(edit_distance(a, t) for a, t in zip(got, truths))
                exact = sum(a == t for a, t in zip(got, truths))
                cells.append((errs / n_words, exact / args.clips))
            print(f"| {name} | {sigma} | {cells[0][0]:.3f} | "
                  f"{cells[1][0]:.3f} | {cells[0][1]:.3f} | "
                  f"{cells[1][1]:.3f} |", flush=True)


if __name__ == "__main__":
    main()
