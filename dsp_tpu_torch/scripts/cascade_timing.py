"""End-to-end cascade against full-DTW spotting, wall clock.

    python -m dsp_tpu_torch.scripts.cascade_timing [--keywords 35] [--device cuda]
    python -m dsp_tpu_torch.scripts.cascade_timing --keywords 10

Port of ``scripts/cascade_timing.py``: the same keyword set and the same
streams through both spotters, with host work (event extraction, window
cutting) included.  ``--keywords 35 --templates 3`` gives the DTW spotter
a 105-template subsequence scan over every stream frame (kernel 3 on the
card), while the cascade's stage 1 scans 35 GMM-HMMs (4 states x 2
mixtures; no kernel) and stage 2 reranks only the candidate windows
(kernel 3).

Reports seconds of audio processed a wall-clock second for each spotter,
the median of ``--passes`` passes, each timed on the host clock and closed
by ``torch.cuda.synchronize`` on a card, with the F1 of the last pass and
the cascade's stage-1 candidate count (the data its cost grows with).
"""

from __future__ import annotations

import argparse
import time

import torch


def f1_of(events_per_stream, truths, hop: int) -> float:
    """F1 of per-stream events ``(label, start_frame, end_frame, score)``
    against planted ``(label, start_sample, end_sample)`` truths: a hit
    covers >= 50 % of a same-label plant, one match a plant."""
    tp = fa = n_truth = 0
    for evs, truth in zip(events_per_stream, truths):
        unmatched = [(lab, s // hop, e // hop) for lab, s, e in truth]
        n_truth += len(unmatched)
        for lab, s, e, _ in evs:
            hit = None
            for k, (tl, ts, te) in enumerate(unmatched):
                ov = min(e, te) - max(s, ts) + 1
                if tl == lab and ov >= 0.5 * (te - ts + 1):
                    hit = k
                    break
            if hit is None:
                fa += 1
            else:
                tp += 1
                unmatched.pop(hit)
    p = tp / max(tp + fa, 1)
    r = tp / max(n_truth, 1)
    return 2 * p * r / max(p + r, 1e-9)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keywords", type=int, default=35)
    ap.add_argument("--templates", type=int, default=3)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--words-per-stream", type=int, default=12)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--noise", type=float, default=0.003)
    ap.add_argument("--no-calibrate", action="store_true",
                    help="fixed threshold 40 instead of the enroll-time "
                         "bank calibration")
    ap.add_argument("--distractor-weight", type=int, default=1,
                    help="replicate the distractor classes N times in "
                         "the draw vocabulary: higher = sparser "
                         "keywords (the cascade's favorable regime)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    args = ap.parse_args(argv)

    from dsp_tpu_torch.config import HmmConfig, PipelineConfig
    from dsp_tpu_torch.io.dataset import make_corpus, synth_spotting_stream, synth_word
    from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    from dsp_tpu_torch.models.spotter import CascadeSpotter, KeywordSpotter
    from dsp_tpu_torch.scripts import describe_device

    dev = torch.device(args.device)
    print(f"# device: {describe_device(dev)}")
    cfg = PipelineConfig()
    # distinct synthetic classes beyond the 10 digits: the w%02d
    # vocabulary of the 35-class configuration
    keywords = [f"w{i:02d}" for i in range(args.keywords)]
    distract = [f"d{i:02d}" for i in range(5)]

    brec = KnnDtwRecognizer(cfg, device=dev)
    for lab in keywords:
        brec.enroll(lab, [synth_word(lab, i) for i in range(args.templates)])
    hrec = GmmHmmRecognizer(cfg, HmmConfig(n_states=4, n_mix=2, n_iter=4), device=dev)
    hrec.fit(make_corpus(keywords, n_per_word=args.templates + 2, seed=0))

    out = {}
    if not args.no_calibrate:
        # the CLI's `enroll` default: a per-bank calibrated threshold stored
        # on the recognizer, which both spotters resolve
        brec.spot_threshold = KeywordSpotter(brec, threshold=0.0).calibrate_threshold()
        out["threshold"] = brec.spot_threshold
        print(f"# bank-calibrated threshold: {brec.spot_threshold:.1f} "
              f"(--no-calibrate for the fixed default "
              f"{KeywordSpotter(brec, threshold=40.0).threshold:.0f})")
    dtw = KeywordSpotter(brec)
    casc = CascadeSpotter(hrec, brec)

    vocab = keywords + distract * args.distractor_weight
    sigs, truths = [], []
    for i in range(args.streams):
        sig, truth = synth_spotting_stream(keywords, vocab, seed=7000 + i,
                                           n_words=args.words_per_stream, noise=args.noise)
        sigs.append(sig)
        truths.append(truth)
    audio_s = sum(len(s) for s in sigs) / cfg.frontend.sample_rate
    hop = cfg.frontend.hop_len

    def run(name, spot_fn):
        spot_fn(sigs[:1])                      # warm-up, excluded
        times, last = [], None
        for _ in range(args.passes):
            t0 = time.monotonic()
            last = spot_fn(sigs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times.append(time.monotonic() - t0)
        med = sorted(times)[len(times) // 2]
        f1 = f1_of(last, truths, hop)
        print(f"{name:>8}: {audio_s / med:8.1f} audio-s/s  "
              f"(median of {args.passes}: {med:.2f} s for {audio_s:.0f} "
              f"audio-s; min {min(times):.2f} max {max(times):.2f})  "
              f"F1 {f1:.2f}")
        out[name] = dict(median_s=med, min_s=min(times), max_s=max(times),
                         audio_s_per_s=audio_s / med, f1=f1, events=last)

    print(f"# {args.keywords} keywords x {args.templates} templates "
          f"({args.keywords * args.templates}-template DTW bank vs "
          f"{args.keywords}-HMM scan), {args.streams} streams x "
          f"{args.words_per_stream} words, noise {args.noise:g}")
    run("dtw", lambda ss: dtw.spot(ss))
    n_cand = sum(len(evs) for evs in casc.stage1.spot(sigs, threshold=casc.hmm_threshold))
    run("cascade", lambda ss: casc.spot(ss))
    print(f"# cascade stage-1 candidates: {n_cand} windows over "
          f"{args.streams} streams "
          f"({n_cand / max(args.streams, 1):.1f}/stream)")
    out["candidates"] = n_cand
    return out


if __name__ == "__main__":
    main()
