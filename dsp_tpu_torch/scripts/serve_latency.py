"""Single-utterance serving latency.

    python -m dsp_tpu_torch.scripts.serve_latency [--bank-size 100] [--batches 1,8,64]
    python -m dsp_tpu_torch.scripts.serve_latency --device cpu   # a smoke run, not a measurement

Port of ``scripts/serve_latency.py``.  Serving cares about the wall clock
of a request, not only batch throughput: this drives the real
``classify_batch`` path (kernel 1 on the card) at small batch sizes after
a warm-up and prints wall-clock percentiles a call: host padding, the
copy to the device, the features, DTW against the whole bank and the
label fetch.  Then the serve loop's other request modes, one request
(B = 1) at a time: the VAD split, the level-building DP (no kernel), the
same under a ``no_repeat`` word-pair grammar, and the n-best list.

The JAX script's ``--platform`` and its compile cache have no counterpart:
``--device`` names the device, and nothing is compiled ahead of the
warm-up call.
"""

from __future__ import annotations

import argparse
import time

TRUTH_WORDS = 3           # words a connected request
GRAMMAR = {"no_repeat": True}


def batch_signals(b: int, max_samples: int) -> list:
    """The batch table's requests: ``b`` digit utterances, seeds from 9000."""
    from dsp_tpu_torch.io.dataset import DIGITS, synth_word

    return [synth_word(DIGITS[i % 10], 9000 + i, max_samples=max_samples) for i in range(b)]


def build(bank_size: int, device):
    """(recognizer, request modes): a ``KnnDtwRecognizer`` (k = 1) with
    ``ceil(bank_size / 10)`` templates of each digit on ``device``, and the
    per-request modes as (name, call) pairs over a gapped and a gapless
    recording of the first three digits."""
    from dsp_tpu_torch.config import PipelineConfig
    from dsp_tpu_torch.io.dataset import DIGITS, synth_connected, synth_word
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer

    cfg = PipelineConfig()
    rec = KnnDtwRecognizer(cfg, k=1, device=device)
    per = max(1, -(-bank_size // len(DIGITS)))
    for lab in DIGITS:
        rec.enroll(lab, [synth_word(lab, i, max_samples=cfg.max_samples) for i in range(per)])

    truth = DIGITS[:TRUTH_WORDS]
    conn = synth_connected(truth, seed=77)                 # gapped
    gapless = synth_connected(truth, seed=78, gap_ms=(0.0, 1.0))
    modes = [
        ("connected (vad split)", lambda: rec.classify_connected([conn], max_segments=4)),
        ("level (gapless DP)",
         lambda: rec.classify_connected([gapless], max_segments=4, method="level")),
        ("level + grammar",
         lambda: rec.classify_connected([gapless], max_segments=4, method="level",
                                        grammar=GRAMMAR)),
        ("nbest (n=3)", lambda: rec.classify_nbest([conn[:cfg.max_samples]], n=3)),
    ]
    return rec, modes


def percentiles(lat) -> dict:
    """p50, p90 and p99 of a list of ms, as the JAX script indexes them."""
    lat = sorted(lat)
    return {f"p{round(q * 100)}": lat[min(len(lat) - 1, int(q * len(lat)))]
            for q in (0.50, 0.90, 0.99)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bank-size", type=int, default=100)
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card)")
    args = ap.parse_args(argv)

    from dsp_tpu_torch.scripts import describe_device

    print(f"# device: {describe_device(args.device)}")
    rec, modes = build(args.bank_size, args.device)
    out = {"recognizer": rec, "batches": {}, "modes": {}}
    print(f"# serving latency: bank={rec.n_templates}, {args.calls} calls/row")
    print("| batch | p50 ms | p90 ms | p99 ms | labels/s |")
    print("|---|---|---|---|---|")
    for b in (int(x) for x in args.batches.split(",") if x.strip()):
        sigs = batch_signals(b, rec.cfg.max_samples)
        rec.classify_batch(sigs)                      # warm-up
        lat = []
        for _ in range(args.calls):
            t0 = time.perf_counter()
            labels = rec.classify_batch(sigs)         # includes the label fetch
            lat.append((time.perf_counter() - t0) * 1e3)
            if len(labels) != b:
                raise RuntimeError(f"classify_batch gave {len(labels)} labels for {b}")
        p = percentiles(lat)
        rate = 1e3 * b / (sum(lat) / len(lat))
        print(f"| {b} | {p['p50']:.1f} | {p['p90']:.1f} | {p['p99']:.1f} | {rate:.0f} |",
              flush=True)
        out["batches"][b] = dict(p, labels_per_s=rate, labels=labels)

    print(f"\n# per-request modes (B=1, {args.calls} calls/row, "
          f"words/request={TRUTH_WORDS})")
    print("| request mode | p50 ms | p90 ms | p99 ms | words/s |")
    print("|---|---|---|---|---|")
    for name, call in modes:
        call()                                        # warm-up
        lat = []
        for _ in range(args.calls):
            t0 = time.perf_counter()
            got = call()
            lat.append((time.perf_counter() - t0) * 1e3)
        p = percentiles(lat)
        wps = 1e3 * TRUTH_WORDS / (sum(lat) / len(lat))
        print(f"| {name} | {p['p50']:.1f} | {p['p90']:.1f} | {p['p99']:.1f} | {wps:.0f} |",
              flush=True)
        out["modes"][name] = dict(p, words_per_s=wps, output=got)
    return out


if __name__ == "__main__":
    main()
