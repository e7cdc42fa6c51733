"""Where one main-path chunk's time goes: dispatch, front end and DTW.

    python -m dsp_tpu_torch.scripts.fe_profile [--chunk 256] [--templates 100]

Port of ``scripts/fe_profile.py``.  Times each stage of the main path as
its own call on signals and features already on the card:

    stage   call
    noop    one single-element op            -> the dispatch floor
    mfcc    batched ops/frontend.mfcc (DFT GEMMs, use_fft=False)
    vad     ops/vad.detect_endpoints only
    fe      pipeline.extract_features (MFCC + VAD + window + CMN + deltas)
    dtw     pipeline.classify_features on features on the card (kernel 1
            and the argmin)
    full    pipeline.recognize_batch (features, then dtw)

Each stage is timed with CUDA events over back-to-back calls
(``utils/timing.chained_timeit_spread``: the median, lowest and highest
of ``--passes`` passes of ``--iters`` calls).  Prints one JSON line a
stage and a closing ``attribution`` line.  The front end is the default
one (``FrontendConfig.impl``: PyTorch ops, not kernel 2), in full fp32
(TF32 is off package-wide; the JAX script's ``Precision.DEFAULT`` has no
counterpart).  The JAX script's deadline child, ``--timeout`` and
``--in-process`` exist for its remote TPU and are left out: this runs in
process on the card, and raises for any other device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def bank_label_ids(n_templates: int) -> np.ndarray:
    """The bank's label ids: the ten digits, ``n_templates // 10`` (at least
    one) templates each, cut to ``n_templates``."""
    per_word = max(1, n_templates // 10)
    return np.repeat(np.arange(10, dtype=np.int32), per_word)[:n_templates]


def stages(chunk: int, n_templates: int, device):
    """The six stages as (name, call, args), in the JAX script's order, on
    its bank (the ten digits, ``n_templates // 10`` templates each) and
    its ``chunk`` queries (digits drawn by ``default_rng(0)``, seeds from
    1000), all padded to ``max_samples``."""
    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.config import PipelineConfig
    from dsp_tpu_torch.io.dataset import DIGITS, synth_word
    from dsp_tpu_torch.ops import frontend as fe
    from dsp_tpu_torch.ops import vad as tvad

    dev = torch.device(device)
    cfg = PipelineConfig()
    mats = fe.make_matrices(cfg.frontend, dev)

    per_word = max(1, n_templates // len(DIGITS))
    bank_sigs = np.stack([synth_word(lab, i, max_samples=cfg.max_samples)
                          for lab in DIGITS for i in range(per_word)])[:n_templates]
    bank_ns = torch.full((bank_sigs.shape[0],), cfg.max_samples, dtype=torch.int32,
                         device=dev)
    bank = pl.extract_features(torch.from_numpy(bank_sigs).to(dev), bank_ns, cfg)
    ids = torch.from_numpy(bank_label_ids(n_templates)).to(dev)

    rng = np.random.default_rng(0)
    sigs = torch.from_numpy(np.stack([
        synth_word(DIGITS[rng.integers(10)], 1000 + i, max_samples=cfg.max_samples)
        for i in range(chunk)])).to(dev)
    qn = torch.full((chunk,), cfg.max_samples, dtype=torch.int32, device=dev)
    feats = pl.extract_features(sigs, qn, cfg)

    def s_noop(x):
        return x.reshape(-1)[:1] + 0.0

    def s_mfcc(x):
        return fe.mfcc(x, cfg.frontend, mats, use_fft=False)

    def s_vad(x, n):
        return tvad.detect_endpoints(x, cfg.frontend, cfg.vad, n)[:2]

    def s_fe(x, n):
        return pl.extract_features(x, n, cfg)

    def s_dtw(qf, ql):
        return pl.classify_features(pl.Features(qf, ql), bank, ids, cfg=cfg)

    def s_full(x, n):
        return pl.recognize_batch(x, n, bank, ids, cfg)

    return [
        ("noop", s_noop, (sigs,)),
        ("mfcc", s_mfcc, (sigs,)),
        ("vad", s_vad, (sigs, qn)),
        ("fe", s_fe, (sigs, qn)),
        ("dtw", s_dtw, (feats.feats, feats.length)),
        ("full", s_full, (sigs, qn)),
    ]


def stage_line(name: str, med: float, lo: float, hi: float, chunk: int,
               n_templates: int) -> dict:
    """A stage's JSON line from its seconds (median, lowest, highest)."""
    return {"stage": name, "ms": round(med * 1e3, 3),
            "ms_lo": round(lo * 1e3, 3), "ms_hi": round(hi * 1e3, 3),
            "pairs_per_s": (round(chunk * n_templates / med)
                            if name in ("dtw", "full") else None)}


def attribution(ms: dict) -> dict:
    """The closing line's numbers from the stages' seconds."""
    full, dtw, fe_s = ms["full"], ms["dtw"], ms["fe"]
    return {
        "full_ms": round(full * 1e3, 3),
        "dtw_ms": round(dtw * 1e3, 3),
        "fe_ms": round(fe_s * 1e3, 3),
        "noop_dispatch_ms": round(ms["noop"] * 1e3, 3),
        "unexplained_ms": round((full - dtw - fe_s) * 1e3, 3),
        "fe_share_of_gap": round(fe_s / max(full - dtw, 1e-9), 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--templates", type=int, default=100)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (default cuda: the card)")
    args = ap.parse_args(argv)

    from dsp_tpu_torch.scripts import describe_device, require_card
    from dsp_tpu_torch.utils.timing import chained_timeit_spread

    dev = require_card(args.device, "fe_profile")
    print(f"# device: {describe_device(dev)}")
    ms, outputs = {}, {}
    for name, fn, fargs in stages(args.chunk, args.templates, dev):
        med, lo, hi = chained_timeit_spread(fn, fargs, n_iters=args.iters, passes=args.passes)
        ms[name] = med
        outputs[name] = fn(*fargs)
        print(json.dumps(stage_line(name, med, lo, hi, args.chunk, args.templates)),
              flush=True)
    line = attribution(ms)
    print(json.dumps({"attribution": line}), flush=True)
    return {"ms": ms, "attribution": line, "outputs": outputs}


if __name__ == "__main__":
    main()
