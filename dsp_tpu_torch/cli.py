"""Command-line interface of the port: ``python -m dsp_tpu_torch``.

The subcommands of the JAX package's CLI (``dsp_tpu/cli.py``), with its
flags, defaults, stdout lines and metrics JSON keys, over the port's
recognizers: the template bank, spotting, GMM-HMM and VQ families, the
Speech Commands evaluation, the pipeline picture and the streaming demo:

    python -m dsp_tpu_torch make-corpus --out data/ --n 5
    python -m dsp_tpu_torch enroll      --corpus data/train --bank bank.npz
    python -m dsp_tpu_torch recognize   --bank bank.npz one.wav two.wav
    python -m dsp_tpu_torch evaluate    --corpus data/test --bank bank.npz
    python -m dsp_tpu_torch evaluate-connected --corpus data/connected --bank bank.npz
    python -m dsp_tpu_torch spot        --bank bank.npz stream.wav
    python -m dsp_tpu_torch evaluate-spot --corpus data/spotting --bank bank.npz
    python -m dsp_tpu_torch serve       --bank bank.npz < paths.txt
    python -m dsp_tpu_torch train-hmm   --corpus data/train --model hmm.npz
    python -m dsp_tpu_torch evaluate-hmm --corpus data/test --model hmm.npz
    python -m dsp_tpu_torch train-vq    --corpus data/train --model vq.npz
    python -m dsp_tpu_torch evaluate-vq --corpus data/test --model vq.npz
    python -m dsp_tpu_torch bench
    python -m dsp_tpu_torch warm        --bank bank.npz --batches 1,256
    python -m dsp_tpu_torch evaluate-sc2 --root speech_commands_v2/
    python -m dsp_tpu_torch plot        --word three --bank bank.npz --out p.png
    python -m dsp_tpu_torch demo        --bank bank.npz [--wav stream.wav]

Every command runs on the card; ``--device cpu`` (before the subcommand)
runs it on the CPU instead.  Without a card the default raises, as every
entry point of the port does.  Banks and models are the JAX package's
``.npz`` files, so either CLI reads what the other wrote.  Every flag maps
1:1 onto a config dataclass field; defaults are the classical values
(16 kHz, 25 ms/10 ms, 13 MFCC, lifter 22).  ``bench`` runs
``dsp_tpu_torch.bench`` (its ``BENCH_*`` knobs) on ``--device``: ``--device
cpu bench`` is ``BENCH_PLATFORM=cpu``.  ``warm`` fills the port's
compilation cache, ``build/``, where the kernels are compiled at first use
and which later processes load, then checks in its own process that the
serving programs run (:func:`cmd_warm`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from dsp_tpu_torch.config import (DtwConfig, FrontendConfig, HmmConfig, PipelineConfig,
                                  VadConfig, VqConfig)
from dsp_tpu_torch.utils.logging import RunMetrics, get_logger

log = get_logger("dsp_tpu_torch.cli")


def _pipeline_cfg(args) -> PipelineConfig:
    fe = FrontendConfig(
        sample_rate=args.sr,
        n_mfcc=args.n_mfcc,
        n_mels=args.n_mels,
        add_deltas=not args.no_deltas,
        use_energy=args.use_energy,
        cmn=args.cmn,
        cmn_mode=args.cmn_mode,
        cmn_alpha=args.cmn_alpha,
        feature_type=args.features,
        lpc_order=args.lpc_order,
        denoise=None if args.denoise == "none" else args.denoise,
    )
    band = None if args.band is not None and args.band <= 0 else args.band
    slope = None if args.slope == "none" else args.slope
    dtw = DtwConfig(band_frac=band, impl=args.dtw_impl, slope=slope)
    return PipelineConfig(
        frontend=fe, dtw=dtw,
        vad=VadConfig(threshold_mode=args.vad_mode),
        max_samples=args.max_samples,
        use_vad=not args.no_vad,
    )


def _add_trace(p: argparse.ArgumentParser):
    p.add_argument("--trace", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run, with "
                        "the pipeline's dsp.* spans, into DIR, and print the "
                        "run's counters (bytes copied to the card, host "
                        "waits) to stderr")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--n-mfcc", type=int, default=13)
    p.add_argument("--n-mels", type=int, default=26)
    p.add_argument("--max-samples", type=int, default=32000)
    p.add_argument("--no-deltas", action="store_true")
    p.add_argument("--use-energy", action="store_true")
    p.add_argument("--cmn", action="store_true",
                   help="per-utterance cepstral mean normalization")
    p.add_argument("--cmn-mode", choices=["utterance", "causal"],
                   default=FrontendConfig.cmn_mode,
                   help="'utterance' = exact mean over the utterance "
                        "(offline only); 'causal' = bias-corrected "
                        "exponential running mean — prefix-stable, so "
                        "the streaming surfaces accept it")
    p.add_argument("--cmn-alpha", type=float,
                   default=FrontendConfig.cmn_alpha,
                   help="causal-cmn forgetting factor (~2 s horizon at "
                        "the default frame rate)")
    p.add_argument("--features", choices=["mfcc", "lpcc"], default="mfcc")
    p.add_argument("--denoise", choices=["none", "spectral_subtraction"],
                   default="none",
                   help="power-spectrum noise suppression before the mel "
                        "filterbank (noise PSD from the lowest-energy "
                        "frames)")
    p.add_argument("--lpc-order", type=int, default=12)
    p.add_argument("--no-vad", action="store_true")
    p.add_argument("--vad-mode", choices=["noise_mult", "two_pass"],
                   default=VadConfig.threshold_mode,
                   help="endpoint threshold rule: 'noise_mult' = "
                        "head-frame noise estimate x multiplier (the "
                        "classical rule); 'two_pass' = whole-utterance "
                        "floor/ceiling interpolation — SNR-adaptive, "
                        "recovers speech at ~0 dB where TH=4x noise "
                        "never fires (offline only)")
    p.add_argument("--band", type=float, default=DtwConfig.band_frac,
                   help="Sakoe-Chiba band fraction (0 or negative = "
                        f"unbanded; default {DtwConfig.band_frac})")
    p.add_argument("--dtw-impl",
                   choices=["auto", "scan", "pallas", "fused",
                            "fused_banded"],
                   default=DtwConfig.impl,
                   help="auto = the banded DTW kernel on the card, the "
                        "plain scan on the CPU; fused / pallas = the "
                        "unbanded closed-form and wavefront kernels")
    p.add_argument("--slope", choices=["none", "itakura"], default="none",
                   help="DTW local slope constraint (itakura: steps "
                        "{(1,0),(1,1),(1,2)}, no repeated (1,0); length "
                        "ratios > 2 become unreachable)")
    # k / matcher / shortlist default to None sentinels so "flag passed"
    # is distinguishable from "default": evaluate/recognize/serve only
    # override a checkpoint's ENROLLED values when the user actually asked
    p.add_argument("--k", type=int, default=None, help="kNN votes "
                   "(default: the checkpoint's enrolled value, else 1)")
    p.add_argument("--matcher", choices=["dtw", "ltw", "cascade"],
                   default=None,
                   help="cascade = LTW shortlist -> DTW rerank (faster on "
                        "large banks, near-exact); default: the "
                        "checkpoint's enrolled value, else dtw")
    p.add_argument("--shortlist", type=int, default=None,
                   help="cascade: DTW-rerank candidates per query "
                        "(default: enrolled value, else 8)")
    p.add_argument("--metrics-out", default=None,
                   help="write run metrics JSON to this path")
    p.add_argument("--mesh", action="store_true",
                   help="shard the template bank over the ranks of a "
                        "torchrun world (one process a card); a single "
                        "process runs unsharded")


def _world_mesh(device):
    """A ('data', 'bank') mesh with every rank on 'bank' when this process
    is one rank of a world of more than one (torchrun's environment), else
    None."""
    import torch.distributed as dist

    from dsp_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize(device=device)
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    mesh = make_mesh(device=device)
    log.info("using a %s mesh", dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    return mesh


def _maybe_mesh(args):
    """--mesh -> :func:`_world_mesh`, else None."""
    return _world_mesh(args.device) if getattr(args, "mesh", False) else None


def _load_corpus(path: str, sr: int):
    """root/<label>/*.wav -> {label: [signals]}: the native threaded reader
    where it builds, else the Python one (the JAX CLI's choice)."""
    from dsp_tpu_torch.io import native
    from dsp_tpu_torch.io.dataset import load_corpus_dir
    if native.available():
        corpus = native.load_corpus_dir_native(path, target_sr=sr)
        log.info("read %s with the native reader (%s)", path,
                 native.library_path().name)
    else:
        corpus = load_corpus_dir(path, target_sr=sr)
        log.info("read %s with the Python reader (the native one does not "
                 "build here)", path)
    if not corpus:
        raise SystemExit(f"no <label>/*.wav found under {path}")
    return corpus


def _apply_matcher_flags(rec, args):
    """Apply --k/--matcher/--shortlist ONLY when explicitly passed
    (None sentinels keep the checkpoint's enrolled configuration)."""
    if getattr(args, "k", None) is not None:
        rec.k = args.k
    if getattr(args, "matcher", None) is not None:
        rec.matcher = args.matcher
    if getattr(args, "shortlist", None) is not None:
        rec.shortlist = args.shortlist


def _load_bank(args, cfg):
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    return KnnDtwRecognizer.load(args.bank, cfg, device=args.device)


def _load_hmm(args, cfg):
    from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
    return GmmHmmRecognizer.load(args.hmm, cfg, device=args.device)


def cmd_make_corpus(args):
    from dsp_tpu_torch.io.dataset import DIGITS, make_corpus
    from dsp_tpu_torch.io.wav import write_wav
    if args.words is None:
        # unset --words tracks the corpus family: the hostile corpus is
        # DEFINED by its full 35-class confusable vocabulary
        args.words = 35 if getattr(args, "hostile", False) else 10
    if getattr(args, "hostile", False):
        if args.connected > 0:
            raise SystemExit("make-corpus: --connected is built from the "
                             "digit vocabulary and does not combine with "
                             "--hostile (run two make-corpus invocations)")
        # adversarial corpus (io/hostile.py): confusable 35-class vocab,
        # disjoint train/test speakers, optional degradation condition
        from dsp_tpu_torch.io.hostile import hostile_vocab, make_hostile_corpus
        vocab = hostile_vocab()[: args.words] if args.words < 35 \
            else hostile_vocab()
        splits = (("train", (0, 1, 2), 0, "clean"),
                  ("test", (4, 5), 9, args.condition))
        for split, speakers, seed, cond in splits:
            corpus = make_hostile_corpus(vocab, speakers=speakers,
                                         n_per=args.n, seed=seed,
                                         condition=cond)
            for lab, sigs in corpus.items():
                d = os.path.join(args.out, split, lab)
                os.makedirs(d, exist_ok=True)
                for i, x in enumerate(sigs):
                    write_wav(os.path.join(d, f"{lab}_{i:03d}.wav"), 16000, x)
        log.info("wrote hostile corpus (test condition=%s) to %s",
                 args.condition, args.out)
        return
    for split, seed in (("train", 0), ("test", 1000)):
        corpus = make_corpus(DIGITS[: args.words], n_per_word=args.n, seed=seed)
        for lab, sigs in corpus.items():
            d = os.path.join(args.out, split, lab)
            os.makedirs(d, exist_ok=True)
            for i, x in enumerate(sigs):
                write_wav(os.path.join(d, f"{lab}_{i:03d}.wav"), 16000, x)
    log.info("wrote synthetic corpus to %s", args.out)
    if args.connected > 0:
        # connected split: multi-word recordings + a labels.tsv manifest
        # (file<TAB>space-joined words), consumed by evaluate-connected
        import numpy as np

        from dsp_tpu_torch.io.dataset import synth_connected
        d = os.path.join(args.out, "connected")
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(2000)
        vocab = DIGITS[: max(1, args.words)]    # same clamp as the splits
        gap_ms = (0.0, 1.0) if args.gapless else (250.0, 600.0)
        lines = []
        for i in range(args.connected):
            labs = [vocab[int(rng.integers(len(vocab)))]
                    for _ in range(int(rng.integers(1, 6)))]
            name = f"clip_{i:03d}.wav"
            write_wav(os.path.join(d, name), 16000,
                      synth_connected(labs, 2000 + i, gap_ms=gap_ms))
            lines.append(f"{name}\t{' '.join(labs)}")
        with open(os.path.join(d, "labels.tsv"), "w") as f:
            f.write("\n".join(lines) + "\n")
        log.info("wrote %d connected clips to %s", args.connected, d)
    if args.spotting > 0:
        # spotting split: continuous streams of keyword + distractor words
        # with an events.tsv ground truth (file<TAB>
        # label:start_sample:end_sample ...), consumed by evaluate-spot.
        # Keywords = the corpus vocabulary (what `enroll` builds a bank
        # for); distractors come from the REST of the digit vocabulary.
        from dsp_tpu_torch.io.dataset import synth_spotting_stream
        keywords = DIGITS[: args.words]
        # distractors: remaining digits, or out-of-vocabulary words when
        # the whole digit set is enrolled (synth_word is procedural in the
        # label string, so any word has a deterministic sound)
        distract = ([w for w in DIGITS if w not in keywords]
                    or ["alpha", "bravo", "charlie"])
        vocab = keywords + distract
        d = os.path.join(args.out, "spotting")
        os.makedirs(d, exist_ok=True)
        lines = []
        for i in range(args.spotting):
            sig, events = synth_spotting_stream(keywords, vocab, 3000 + i)
            name = f"stream_{i:03d}.wav"
            write_wav(os.path.join(d, name), 16000, sig)
            cells = " ".join(f"{lab}:{s}:{e}" for lab, s, e in events)
            lines.append(f"{name}\t{cells}")
        with open(os.path.join(d, "events.tsv"), "w") as f:
            f.write("\n".join(lines) + "\n")
        log.info("wrote %d spotting streams to %s", args.spotting, d)


def cmd_enroll(args):
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    cfg = _pipeline_cfg(args)
    rec = KnnDtwRecognizer(cfg, k=args.k or 1,
                           matcher=args.matcher or "dtw",
                           shortlist=args.shortlist or 8, device=args.device)
    corpus = _load_corpus(args.corpus, args.sr)
    for lab, sigs in sorted(corpus.items()):
        rec.enroll(lab, sigs)
        log.info("enrolled %-8s (%d templates)", lab, len(sigs))
    if not getattr(args, "no_spot_calibration", False):
        # per-bank spotting threshold, stored in the checkpoint so `spot`
        # is vocabulary-robust by default
        from dsp_tpu_torch.models.spotter import KeywordSpotter
        try:
            rec.spot_threshold = KeywordSpotter(
                rec, threshold=0.0).calibrate_threshold()
            log.info("spotting threshold calibrated: %.1f (stored in "
                     "bank; spot uses it when --threshold is unset)",
                     rec.spot_threshold)
        except ValueError as e:
            log.info("spotting threshold not calibrated (%s); spot "
                     "falls back to the fixed default", e)
    if not getattr(args, "no_reject_calibration", False):
        # per-bank OOV-rejection threshold (utterance verification), stored
        # in the checkpoint so `recognize --reject` works out of the box
        try:
            rec.calibrate_rejection()
            log.info("rejection threshold calibrated: %.3f (stored in "
                     "bank; recognize --reject uses it)",
                     rec.reject_threshold)
        except ValueError as e:
            log.info("rejection threshold not calibrated (%s); "
                     "--reject will need an explicit threshold", e)
    rec.save(args.bank)
    log.info("bank: %d templates, %d labels -> %s",
             rec.n_templates, len(rec.labels), args.bank)


@contextlib.contextmanager
def _traced(args, metrics: RunMetrics | None = None):
    """``--trace DIR``: the block under ``utils.profiling.trace(DIR)`` (a
    Chrome trace with the pipeline's ``dsp.*`` spans), then the changes
    of ``utils.profiling.counts()`` over it on stderr and in
    ``metrics``; without the flag, the block alone."""
    if not getattr(args, "trace", None):
        yield
        return
    from dsp_tpu_torch.utils import profiling
    before = profiling.counts()
    with profiling.trace(args.trace):
        yield
    delta = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
             if v != before.get(k, 0)}
    print(f"counts: {json.dumps(delta, sort_keys=True)}", file=sys.stderr)
    if metrics is not None:
        metrics.record(counts=delta)


def cmd_recognize(args):
    with _traced(args):
        _recognize(args)


def _recognize(args):
    from dsp_tpu_torch.io.wav import read_wav
    cfg = _pipeline_cfg(args)
    rec = _load_bank(args, cfg)
    _apply_matcher_flags(rec, args)
    reject = _reject_arg(args)
    if reject is not None and (getattr(args, "connected", False)
                               or getattr(args, "nbest", 0) > 1):
        # fail loudly rather than silently ignore the flag
        raise SystemExit("--reject applies to plain classification only "
                         "(not --connected / --nbest: the connected DP "
                         "has no per-word accept statistic and nbest "
                         "already exposes confidence weights)")
    sigs = [read_wav(p, cfg.frontend.sample_rate)[1] for p in args.wavs]
    if getattr(args, "connected", False):
        seqs = rec.classify_connected(
            sigs, max_segments=args.max_segments,
            method=getattr(args, "connected_method", "vad"),
            word_penalty=getattr(args, "word_penalty", 0.0),
            grammar=getattr(args, "grammar", None))
        for path, seq in zip(args.wavs, seqs):
            print(f"{path}\t{' '.join(seq)}")
        return
    if getattr(args, "nbest", 0) > 1:
        hyps = rec.classify_nbest(sigs, n=args.nbest)
        for path, hy in zip(args.wavs, hyps):
            cells = " ".join(f"{lab}:{d:.3f}:{w:.3f}" for lab, d, w in hy)
            print(f"{path}\t{cells}")
        return
    labels = rec.classify_batch(sigs, reject=reject)
    for path, lab in zip(args.wavs, labels):
        print(f"{path}\t{lab}")


def cmd_evaluate(args):
    cfg = _pipeline_cfg(args)
    corpus = _load_corpus(args.corpus, args.sr)
    metrics = RunMetrics("evaluate")
    with _traced(args, metrics):
        rec = _load_bank(args, cfg)
        rec.mesh = _maybe_mesh(args)
        _apply_matcher_flags(rec, args)
        result = rec.evaluate(corpus, reject=_reject_arg(args))
    metrics.record(accuracy=result["accuracy"], n=result["n"],
                   bank_size=rec.n_templates, config=cfg)
    print(json.dumps(result["confusion"], indent=2, sort_keys=True))
    print(f"accuracy: {result['accuracy']:.4f} ({result['n']} utterances)")
    if args.metrics_out:
        metrics.dump(args.metrics_out)


def cmd_evaluate_connected(args):
    """WER of any model family on connected multi-word recordings."""
    from dsp_tpu_torch.io.wav import read_wav
    from dsp_tpu_torch.pipeline import edit_distance

    cfg = _pipeline_cfg(args)
    given = [x for x in (args.bank, args.hmm, args.vq) if x]
    if len(given) != 1:
        raise SystemExit("evaluate-connected: give exactly one of "
                         "--bank / --hmm / --vq")
    if args.bank:
        rec = _load_bank(args, cfg)
        _apply_matcher_flags(rec, args)
    elif args.hmm:
        rec = _load_hmm(args, cfg)
        rec.noise_adapt = getattr(args, "noise_adapt", False)
    else:
        from dsp_tpu_torch.models.vq import VqRecognizer
        rec = VqRecognizer.load(args.vq, cfg, device=args.device)
    truths, sigs = [], []
    with open(os.path.join(args.corpus, "labels.tsv")) as f:
        for line in f:
            if not line.strip():
                continue
            name, labstr = line.rstrip("\n").split("\t")
            truths.append(labstr.split(" "))
            sigs.append(read_wav(os.path.join(args.corpus, name),
                                 cfg.frontend.sample_rate)[1])
    method = getattr(args, "connected_method", "vad")
    if method != "vad" and args.vq:
        raise SystemExit("--connected-method level supports --bank (level "
                         "building) and --hmm (connected Viterbi); the VQ "
                         "family has no frame-synchronous joint decoder")
    grammar = getattr(args, "grammar", None)
    if grammar and method == "vad":
        raise SystemExit("--grammar requires --connected-method level "
                         "(the splitter has no joint sequence to "
                         "constrain)")
    if method != "vad":
        got = rec.classify_connected(
            sigs, max_segments=args.max_segments, method=method,
            word_penalty=getattr(args, "word_penalty", 0.0),
            grammar=grammar)
    else:
        got = rec.classify_connected(sigs, max_segments=args.max_segments)
    n_words = sum(len(t) for t in truths)
    errs = sum(edit_distance(g, t) for g, t in zip(got, truths))
    exact = sum(g == t for g, t in zip(got, truths))
    wer = errs / max(n_words, 1)
    exact_acc = exact / max(len(truths), 1)
    print(f"wer: {wer:.4f} ({n_words} words)")
    print(f"exact-sequence accuracy: {exact_acc:.4f} "
          f"({len(truths)} clips)")
    if args.metrics_out:
        m = RunMetrics("evaluate-connected")
        m.record(wer=wer, exact_sequence_accuracy=exact_acc,
                 n_words=n_words, n_clips=len(truths), config=cfg)
        m.dump(args.metrics_out)


def _load_spotter(args, cfg):
    """--bank -> DTW KeywordSpotter; --hmm -> HmmSpotter (UBM filler);
    BOTH -> CascadeSpotter (HMM landmarks propose, DTW reranks)."""
    if not args.bank and not getattr(args, "hmm", None):
        raise SystemExit("spot: give --bank, --hmm, or both (cascade)")
    if getattr(args, "calibrate_threshold", False) and getattr(args, "hmm",
                                                               None):
        # the HMM/cascade thresholds are LLR-scaled, not DTW-distance
        # scaled; silently handing back the fixed default would let a user
        # believe a calibrated threshold is in force
        raise SystemExit("--calibrate-threshold applies to the DTW "
                         "spotter only (--bank without --hmm)")
    if args.bank and getattr(args, "hmm", None):
        from dsp_tpu_torch.models.spotter import CascadeSpotter
        hrec = _load_hmm(args, cfg)
        brec = _load_bank(args, cfg)
        hthr = getattr(args, "hmm_threshold", None)
        sp = CascadeSpotter(
            hrec, brec, threshold=args.threshold,
            **({} if hthr is None else {"hmm_threshold": hthr}))
        log.info("cascade stage-2 threshold %.1f (%s)", sp.threshold,
                 sp.threshold_source)
        return sp, brec
    if getattr(args, "hmm", None):
        from dsp_tpu_torch.models.spotter import HmmSpotter
        rec = _load_hmm(args, cfg)
        thr = args.threshold if args.threshold is not None else 0.0
        return HmmSpotter(rec, threshold=thr), rec
    from dsp_tpu_torch.models.spotter import KeywordSpotter
    rec = _load_bank(args, cfg)
    rec.mesh = _maybe_mesh(args)     # --mesh: the bank-sharded spotter
    spotter = KeywordSpotter(rec, threshold=args.threshold)
    if getattr(args, "calibrate_threshold", False):
        # eager recalculation (e.g. an old bank saved without one)
        if args.threshold is not None:
            raise SystemExit("give --threshold or --calibrate-threshold,"
                             " not both")
        spotter.threshold = spotter.calibrate_threshold()
        spotter.threshold_source = "recalibrated"
    log.info("spotting threshold %.1f (%s)", spotter.threshold,
             spotter.threshold_source)
    return spotter, rec


def cmd_spot(args):
    """Keyword search in unsegmented WAVs (models/spotter.py)."""
    from dsp_tpu_torch.io.wav import read_wav
    cfg = _pipeline_cfg(args)
    sigs = [read_wav(p, cfg.frontend.sample_rate)[1] for p in args.wavs]
    if args.stream:
        if getattr(args, "calibrate_threshold", False):
            raise SystemExit("--calibrate-threshold is not wired into "
                             "--stream; enroll with calibration (the "
                             "bank stores it) or pass --threshold")
        if getattr(args, "hmm", None) and args.bank:
            # the streaming cascade: online HMM landmarks, a rerank on
            # confirmation, bounded-lag events
            from dsp_tpu_torch.models.spotter import StreamingCascadeSpotter
            hrec = _load_hmm(args, cfg)
            brec = _load_bank(args, cfg)
            hthr = getattr(args, "hmm_threshold", None)
            rec = brec
            mk = lambda thr: StreamingCascadeSpotter(  # noqa: E731
                hrec, brec, threshold=thr,
                **({} if hthr is None else {"hmm_threshold": hthr}))
            thr = args.threshold     # None -> bank-calibrated or default
        elif getattr(args, "hmm", None):
            from dsp_tpu_torch.models.spotter import StreamingHmmSpotter
            rec = _load_hmm(args, cfg)
            mk = lambda thr: StreamingHmmSpotter(rec, threshold=thr)  # noqa: E731
            thr = args.threshold if args.threshold is not None else 0.0
        else:
            from dsp_tpu_torch.models.spotter import StreamingSpotter
            rec = _load_bank(args, cfg)
            mk = lambda thr: StreamingSpotter(rec, threshold=thr)  # noqa: E731
            thr = args.threshold     # None -> bank-calibrated or default
        # online path: feed fixed chunks, emit events as confirmed; the
        # final short chunk goes through flush(tail) so results match the
        # offline spotter on the unpadded signal
        for path, sig in zip(args.wavs, sigs):
            ss = mk(thr)
            n_full = len(sig) // ss.chunk_len * ss.chunk_len
            events = []
            for lo in range(0, n_full, ss.chunk_len):
                events += ss.feed(sig[lo:lo + ss.chunk_len])
            events += ss.flush(sig[n_full:])
            _print_spot_events(path, events, rec.cfg)
        return
    spotter, _ = _load_spotter(args, cfg)
    for path, events in zip(args.wavs, spotter.spot(sigs)):
        _print_spot_events(path, events, cfg)


def _print_spot_events(path, events, cfg):
    f = cfg.frontend
    for lab, s, e, sc in events:
        print(f"{path}\t{lab}\t{s * f.hop_len / f.sample_rate:.2f}"
              f"\t{e * f.hop_len / f.sample_rate:.2f}\t{sc:.3f}")
    if not events:
        print(f"{path}\t-")


def cmd_evaluate_spot(args):
    """Precision/recall/F1 of keyword spotting on a spotting corpus
    (make-corpus --spotting).  One match per ground-truth event;
    everything else a spotter emits is a false alarm (hit rules per
    family — see the inline comment)."""
    from dsp_tpu_torch.io.wav import read_wav
    cfg = _pipeline_cfg(args)
    spotter, rec = _load_spotter(args, cfg)
    hop = cfg.frontend.hop_len
    names, sigs, truths = [], [], []
    with open(os.path.join(args.corpus, "events.tsv")) as f:
        for line in f:
            if not line.strip():
                continue
            name, _, cellstr = line.rstrip("\n").partition("\t")
            names.append(name)
            sigs.append(read_wav(os.path.join(args.corpus, name),
                                 cfg.frontend.sample_rate)[1])
            evs = []
            for cell in cellstr.split():
                lab, s, e = cell.rsplit(":", 2)
                evs.append((lab, int(s) // hop, int(e) // hop))
            truths.append(evs)
    got = spotter.spot(sigs)
    # hit rule: 50%-span-overlap for the DTW spotter (tight spans);
    # span-midpoint-inside-truth for the HMM spotter (its LLR peaks on a
    # word's high-contrast CORE — landmark spans, the standard KWS
    # midpoint criterion)
    midpoint = bool(getattr(args, "hmm", None)) and not bool(args.bank)
    tp = fa = 0
    n_truth = sum(len(t) for t in truths)
    for evs, truth in zip(got, truths):
        unmatched = list(truth)
        for lab, s, e, _ in evs:
            best = None
            for i, (tl, ts, te) in enumerate(unmatched):
                if midpoint:
                    good = ts <= (s + e) / 2.0 <= te
                else:
                    ov = min(e, te) - max(s, ts) + 1
                    # inclusive span length on both sides: a 1-frame truth
                    # (ts==te) needs real overlap, not adjacency
                    good = ov >= 0.5 * (te - ts + 1)
                if tl == lab and good:
                    best = i
                    break
            if best is None:
                fa += 1
            else:
                tp += 1
                unmatched.pop(best)
    prec = tp / max(tp + fa, 1)
    rec_ = tp / max(n_truth, 1)
    f1 = 2 * prec * rec_ / max(prec + rec_, 1e-9)
    print(f"precision: {prec:.4f} ({tp}/{tp + fa} events)")
    print(f"recall: {rec_:.4f} ({tp}/{n_truth} keywords)")
    print(f"f1: {f1:.4f}  threshold: {spotter.threshold}")
    if args.metrics_out:
        m = RunMetrics("evaluate-spot")
        m.record(precision=prec, recall=rec_, f1=f1, tp=tp,
                 false_alarms=fa, n_truth=n_truth,
                 threshold=spotter.threshold, config=cfg)
        m.dump(args.metrics_out)


def cmd_serve(args):
    """Long-lived recognition loop: one WAV path per stdin line -> one
    tab-separated result line (path, label(s), milliseconds).

    A minimal deployment surface for scripted/piped serving: the process
    stays resident (the kernels loaded, the bank on the card), so after
    the first request every call costs only the classify.  Prefix a line
    with ``connected `` to decode a multi-word recording via the segment
    splitter, with ``level `` to decode it with the level-building DP
    (gapless speech — ops/level_building.py; ``--grammar`` constrains
    these), or with ``nbest `` to get the top ``--nbest`` isolated-word
    hypotheses as label:distance:weight triplets (rejection thresholds
    ride the weight), or with ``spot `` to keyword-search an unsegmented
    stream (events as label:start_s:end_s:score cells,
    ``--spot-threshold``).  EOF ends the loop.
    """
    import time as _time

    from dsp_tpu_torch.io.wav import read_wav

    cfg = _pipeline_cfg(args)
    rec = _load_bank(args, cfg)
    _apply_matcher_flags(rec, args)
    spotter = None                 # built lazily on the first `spot ` line
    grammar = getattr(args, "grammar", None)
    if grammar:
        # validate once at startup (fail fast, not on the first `level `
        # request); applies to level-mode lines only
        from dsp_tpu_torch.ops.grammar import Grammar
        g = Grammar.load(grammar, rec.labels)
        log.info("serve: %s", g.describe())
    print("ready", flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        mode = "single"
        path = line
        for prefix, m in (("connected ", "vad"), ("level ", "level"),
                          ("nbest ", "nbest"), ("spot ", "spot")):
            if line.startswith(prefix):
                mode, path = m, line[len(prefix):]
                break
        t0 = _time.perf_counter()
        try:
            x = read_wav(path, cfg.frontend.sample_rate)[1]
            if mode == "spot":
                from dsp_tpu_torch.models.spotter import KeywordSpotter
                if spotter is None:
                    spotter = KeywordSpotter(
                        rec, threshold=args.spot_threshold)
                fr = cfg.frontend
                label = " ".join(
                    f"{lab}:{s0 * fr.hop_len / fr.sample_rate:.2f}"
                    f":{e0 * fr.hop_len / fr.sample_rate:.2f}:{sc:.2f}"
                    for lab, s0, e0, sc in spotter.spot([x])[0]) or "-"
            elif mode == "nbest":
                label = " ".join(
                    f"{lab}:{d:.3f}:{w:.3f}" for lab, d, w in
                    rec.classify_nbest([x], n=args.nbest)[0])
            elif mode != "single":
                label = " ".join(rec.classify_connected(
                    [x], max_segments=args.max_segments, method=mode
                    if mode == "level" else "vad",
                    grammar=grammar if mode == "level" else None)[0])
            else:
                label = rec.recognize(x)
            ms = (_time.perf_counter() - t0) * 1e3
            print(f"{path}\t{label}\t{ms:.1f}", flush=True)
        except Exception as e:
            print(f"{path}\tERROR {type(e).__name__}: {e}", flush=True)


def cmd_train_hmm(args):
    from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
    cfg = _pipeline_cfg(args)
    hmm = HmmConfig(n_states=args.states, n_mix=args.mix, n_iter=args.iters,
                    train_mode=args.train_mode, map_tau=args.map_tau)
    rec = GmmHmmRecognizer(cfg, hmm, device=args.device)
    corpus = _load_corpus(args.corpus, args.sr)
    rec.fit(corpus)
    if not getattr(args, "no_reject_calibration", False):
        # OOV-verification LLR threshold from the training corpus,
        # stored in the checkpoint (evaluate-hmm --reject uses it)
        try:
            rec.calibrate_rejection(corpus)
            log.info("rejection LLR threshold calibrated: %.3f "
                     "(stored in model)", rec.reject_threshold)
        except ValueError as e:
            log.info("rejection threshold not calibrated (%s)", e)
    rec.save(args.model)
    log.info("trained %d word HMMs -> %s", len(rec.labels), args.model)


def cmd_evaluate_hmm(args):
    from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
    cfg = _pipeline_cfg(args)
    hmm = HmmConfig(n_states=args.states, n_mix=args.mix, n_iter=args.iters)
    rec = GmmHmmRecognizer.load(args.model, cfg, hmm, device=args.device)
    rec.mesh = _maybe_mesh(args)
    rec.noise_adapt = getattr(args, "noise_adapt", False)
    result = rec.evaluate(_load_corpus(args.corpus, args.sr),
                          reject=_reject_arg(args))
    print(json.dumps(result["confusion"], indent=2, sort_keys=True))
    print(f"accuracy: {result['accuracy']:.4f} ({result['n']} utterances)")
    if args.metrics_out:
        m = RunMetrics("evaluate-hmm")
        m.record(**result)
        m.dump(args.metrics_out)


def cmd_train_vq(args):
    from dsp_tpu_torch.models.vq import VqRecognizer
    cfg = _pipeline_cfg(args)
    rec = VqRecognizer(cfg, VqConfig(n_codes=args.codes, n_iter=args.iters),
                       device=args.device)
    rec.fit(_load_corpus(args.corpus, args.sr))
    rec.save(args.model)
    log.info("trained %d word codebooks -> %s", len(rec.labels), args.model)


def cmd_evaluate_vq(args):
    from dsp_tpu_torch.models.vq import VqRecognizer
    cfg = _pipeline_cfg(args)
    rec = VqRecognizer.load(args.model, cfg, device=args.device)
    rec.mesh = _maybe_mesh(args)
    result = rec.evaluate(_load_corpus(args.corpus, args.sr))
    print(json.dumps(result["confusion"], indent=2, sort_keys=True))
    print(f"accuracy: {result['accuracy']:.4f} ({result['n']} utterances)")
    if args.metrics_out:
        m = RunMetrics("evaluate-vq")
        m.record(**result)
        m.dump(args.metrics_out)


def cmd_bench(args):
    """The headline benchmark (``dsp_tpu_torch.bench``) on ``--device``."""
    from dsp_tpu_torch import bench
    bench.main(device=args.device)


def cmd_warm(args):
    """Build the kernels into the port's compilation cache, then check that
    the serving programs run on ``--device``:

        python -m dsp_tpu_torch warm --bank bank.npz --batches 1,256

    The cache is ``build/``: ``kernels/_build.py`` compiles every kernel
    with nvcc into ``libdsp_tpu_torch_<hash>.so`` there at first use, and
    a later process of the same sources loads it without building.  That
    library is all ``warm`` leaves for later processes: a first ``serve``
    request then pays no nvcc, but still its process's start and first
    launches.  ``warm`` then drives the REAL ``classify_batch`` path on
    synthetic utterances at each batch size, the connected decoders and
    the spotter at each ``--connected`` length, and ``fe_profile``'s
    stages at each ``--stages`` shape.  These runs warm only this process
    and persist nothing (the port has no cache of launched programs, as
    the JAX CLI's XLA cache is one): they check, before traffic comes,
    that each serving program launches at the deployment's shapes, and
    their lines give each one's seconds in this process.  Without
    ``--bank`` a bank of ``--bank-size`` synthetic templates is enrolled.
    On the CPU nothing is built: CPU tensors take the kernels' plain
    versions.
    """
    import time as _time

    import torch

    from dsp_tpu_torch.io.dataset import DIGITS, synth_word
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.scripts import fe_profile

    if args.timeout is not None or args.retries is not None:
        print("# warm: --timeout and --retries bound the JAX package's relay child; "
              "the port warms in this process and does not read them", file=sys.stderr)
    cfg = _pipeline_cfg(args)
    device = torch.device(args.device)
    batches = sorted({int(b) for b in args.batches.split(",") if b.strip()})
    t0 = _time.perf_counter()
    lib_path = None
    if device.type == "cuda":
        lib_path = _build.build()
        _build.lib()
        secs = _build.build_seconds
        how = "loaded, no build" if secs is None else f"built in {secs:.1f}s"
        print(f"warm: kernels {lib_path} ({how})", flush=True)
    for b in batches:
        sigs = [synth_word(DIGITS[i % len(DIGITS)], 7000 + i,
                           max_samples=cfg.max_samples) for i in range(b)]
        t1 = _time.perf_counter()
        n_templates, matcher, k = _warm_batch(args.bank, cfg, args.bank_size, args.k,
                                              args.matcher, args.shortlist, sigs, device)
        print(f"warm: batch={b} bank={n_templates} matcher={matcher} "
              f"k={k} ({_time.perf_counter() - t1:.1f}s)", flush=True)
    for mult in sorted({int(m) for m in args.connected.split(",") if m.strip()}):
        t1 = _time.perf_counter()
        _warm_connected(args.bank, cfg, args.bank_size, args.k, args.max_segments, mult,
                        args.grammar, device)
        print(f"warm: connected+spot len={mult}x max_samples "
              f"({_time.perf_counter() - t1:.1f}s)", flush=True)
    for spec in (args.stages.split(",") if args.stages else []):
        chunk, _, k_t = spec.partition("x")
        t1 = _time.perf_counter()
        for _, fn, fn_args in fe_profile.stages(int(chunk), int(k_t or 100), device):
            fn(*fn_args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"warm: fe-profile stages chunk={chunk} templates="
              f"{k_t or 100} ({_time.perf_counter() - t1:.1f}s)", flush=True)
    done = (f"later processes load {lib_path} without building" if lib_path is not None
            else f"no kernel library is built for {device}")
    print(f"warm: done in {_time.perf_counter() - t0:.1f}s — {done}")


def _warm_recognizer(bank_path, cfg, bank_size, k, device, **matcher):
    """The bank ``warm`` drives: the one at ``bank_path``, else the ten
    digits with ``ceil(bank_size / 10)`` synthetic templates each."""
    from dsp_tpu_torch.io.dataset import DIGITS, synth_word
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer

    if bank_path:
        return KnnDtwRecognizer.load(bank_path, cfg, device=device)
    rec = KnnDtwRecognizer(cfg, k=k or 1, device=device, **matcher)
    per = max(1, -(-bank_size // len(DIGITS)))
    for lab in DIGITS:
        rec.enroll(lab, [synth_word(lab, i, max_samples=cfg.max_samples)
                         for i in range(per)])
    return rec


def _warm_connected(bank_path, cfg, bank_size, k, max_segments, mult, grammar, device):
    """``warm``'s connected step: the VAD split and the level-building
    decode (with the grammar's DP when one is given) of one recording
    ``mult`` x ``max_samples`` long, and the spotter's scores on it: what
    ``serve``'s ``connected ``, ``level `` and ``spot `` lines run."""
    import numpy as np

    from dsp_tpu_torch.io.dataset import synth_connected
    from dsp_tpu_torch.models.spotter import KeywordSpotter

    rec = _warm_recognizer(bank_path, cfg, bank_size, k, device)
    sig = synth_connected(rec.labels[:3] or ["zero"], seed=1)
    n = mult * cfg.max_samples
    sig = np.pad(sig[:n], (0, max(0, n - sig.shape[0])))
    rec.classify_connected([sig], max_segments=max_segments)
    rec.classify_connected([sig], max_segments=max_segments, method="level")
    if grammar:
        rec.classify_connected([sig], max_segments=max_segments, method="level",
                               grammar=grammar)
    KeywordSpotter(rec).scores([sig])


def _warm_batch(bank_path, cfg, bank_size, k, matcher, shortlist, sigs, device):
    """``warm``'s batch step: the bank, then the real ``classify_batch``
    on ``sigs``.  Returns ``(n_templates, matcher, k)``, as the JAX CLI's
    ``_warm_batch`` does."""
    rec = _warm_recognizer(bank_path, cfg, bank_size, k, device,
                           matcher=matcher or "dtw", shortlist=shortlist or 8)
    rec.classify_batch(sigs)
    return rec.n_templates, rec.matcher, rec.k


def cmd_evaluate_sc2(args):
    """Speech Commands v2 35-class kNN-DTW over a local checkout (config
    4): the bank sharded over the ranks of a torchrun world (one process a
    card), else the single-device recognize on this process's device."""
    import time

    import numpy as np
    import torch

    from dsp_tpu_torch import parallel as par
    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.io.speech_commands import load_split

    args.max_samples = min(args.max_samples, 16000)   # SC2 clips are <= 1 s
    cfg = _pipeline_cfg(args)
    k = args.k or 1
    if args.matcher not in (None, "dtw"):
        raise SystemExit("evaluate-sc2 implements the full banded DTW "
                         "only; --matcher ltw/cascade is not supported "
                         "here (use `evaluate` on a corpus directory)")
    metrics = RunMetrics("evaluate-sc2")
    dev = torch.device(args.device)

    log.info("loading templates (train split, %d per word)", args.templates)
    tr_sigs, tr_lens, tr_ids, labels = load_split(
        args.root, "train", per_word=args.templates,
        max_samples=cfg.max_samples, seed=0)
    bank = pl.extract_features(torch.from_numpy(tr_sigs).to(dev),
                               torch.from_numpy(tr_lens).to(dev), cfg)
    ids = torch.from_numpy(tr_ids).to(dev)

    log.info("loading test split%s", f" (cap {args.limit})" if args.limit else "")
    te_sigs, te_lens, te_ids, te_labels = load_split(
        args.root, args.split, per_word=args.limit,
        max_samples=cfg.max_samples, seed=1)
    if te_labels != labels:
        raise SystemExit(f"evaluate-sc2: the {args.split} split's words "
                         f"{te_labels} differ from the train split's {labels}")

    mesh = None if args.no_mesh else _world_mesh(args.device)   # (1, world)
    n_dev = mesh.size() if mesh is not None else 1
    if mesh is not None:
        bank_f, k_orig = par.pad_axis_to_multiple(bank.feats.cpu().numpy(), n_dev)
        bank_l, _ = par.pad_axis_to_multiple(bank.length.cpu().numpy(), n_dev)
        bank_ids, _ = par.pad_axis_to_multiple(tr_ids, n_dev)
        bank_l = np.maximum(bank_l, 1)
        valid = np.arange(len(bank_l)) < k_orig
        # global arrays on every rank: recognize_sharded takes each rank's
        # bank shard and query shard itself
        bf, bl, idsd, bv = par.replicate(mesh, bank_f, bank_l, bank_ids, valid)
        log.info("bank sharded over %d ranks (%d templates)", n_dev, k_orig)

    correct = total = 0
    t0 = time.perf_counter()
    bs = args.batch
    for lo in range(0, len(te_sigs), bs):
        sl = slice(lo, min(lo + bs, len(te_sigs)))
        sigs = np.zeros((bs, cfg.max_samples), np.float32)
        lens = np.ones(bs, np.int32)
        n_real = sl.stop - sl.start
        sigs[:n_real] = te_sigs[sl]
        lens[:n_real] = te_lens[sl]
        if mesh is not None:
            got, _ = par.recognize_sharded(mesh, sigs, lens, bf, bl, idsd, bv,
                                           cfg=cfg, k=k, n_labels=len(labels))
        else:
            x, n = torch.from_numpy(sigs).to(dev), torch.from_numpy(lens).to(dev)
            if k > 1:
                got, _ = pl.classify_features(pl.extract_features(x, n, cfg), bank, ids,
                                              n_labels=len(labels), k=k, cfg=cfg)
            else:
                got, _ = pl.recognize_batch(x, n, bank, ids, cfg)
        got = got.cpu().numpy()[:n_real]
        correct += int((got == te_ids[sl]).sum())
        total += n_real
        log.info("  %d/%d acc=%.4f", total, len(te_sigs), correct / total)
    dt = time.perf_counter() - t0
    acc = correct / max(total, 1)
    aligns = total * bank.feats.shape[0]
    print(f"accuracy: {acc:.4f} ({total} clips, {len(labels)} classes)")
    print(f"throughput: {aligns / dt:,.0f} alignments/s")
    metrics.record(accuracy=acc, n=total, classes=len(labels),
                   templates=int(bank.feats.shape[0]),
                   alignments_per_sec=aligns / dt, devices=n_dev)
    if args.metrics_out:
        metrics.dump(args.metrics_out)


def cmd_plot(args):
    """Render the pipeline view of one WAV (or synthetic word) to PNG."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        raise SystemExit("plot needs matplotlib, which is not installed in this "
                         "environment")
    from dsp_tpu_torch.viz import plot_pipeline
    cfg = _pipeline_cfg(args)
    if args.wav:
        from dsp_tpu_torch.io.wav import read_wav
        _, x = read_wav(args.wav, cfg.frontend.sample_rate)
        title = args.wav
    else:
        from dsp_tpu_torch.io.dataset import synth_word
        x = synth_word(args.word, 0, max_samples=cfg.max_samples)
        title = f"synthetic '{args.word}'"
    rec = _load_bank(args, cfg) if args.bank else None
    plot_pipeline(x, args.out, cfg, rec, title)
    log.info("wrote %s", args.out)


def cmd_demo(args):
    """Streaming demo: a WAV (or synthetic stream) fed chunk by chunk."""
    from dsp_tpu_torch.models.streaming import StreamingRecognizer
    cfg = _pipeline_cfg(args)
    period = cfg.frontend.hop_len / cfg.frontend.sample_rate
    rec = _load_bank(args, cfg)
    stream = StreamingRecognizer(rec, chunk_len=args.chunk)

    if args.wav:
        from dsp_tpu_torch.io.wav import read_wav
        _, sig = read_wav(args.wav, cfg.frontend.sample_rate)
    elif args.mic:
        _demo_mic(stream, args)
        return
    else:
        sig = _synth_stream(rec.labels)
    n = len(sig) // args.chunk
    for c in range(n):
        for lab, s, e in stream.feed(sig[c * args.chunk:(c + 1) * args.chunk]):
            t0, t1 = s * period, e * period
            print(f"[{t0:7.2f}s - {t1:7.2f}s] {lab}")
    for lab, s, e in stream.flush():
        print(f"[{s * period:7.2f}s - {e * period:7.2f}s] {lab} (flush)")


def _synth_stream(labels, n_words: int = 5, seed: int = 7):
    """The JAX CLI's synthetic demo stream, sample for sample: ``n_words``
    random words of ``labels`` over low noise, 0.75-1.25 s apart."""
    import numpy as np

    from dsp_tpu_torch.io.dataset import synth_word
    rng = np.random.default_rng(seed)
    sig = 0.002 * rng.standard_normal(16000 * (3 * n_words + 1))
    pos = 8000
    spoken = []
    for i in range(n_words):
        lab = labels[rng.integers(len(labels))]
        w = synth_word(lab, 500 + i, max_samples=24000)
        end = min(pos + len(w), len(sig))
        sig[pos:end] += w[: end - pos]
        spoken.append(lab)
        pos = end + int(rng.integers(12000, 20000))
        if pos + 8000 >= len(sig):
            break
    log.info("synthetic stream says: %s", " ".join(spoken))
    return sig.astype(np.float32)


def _demo_mic(stream, args):
    import numpy as np
    period = (stream.cfg.frontend.hop_len
              / stream.cfg.frontend.sample_rate)
    try:
        import pyaudio
    except ImportError:
        raise SystemExit(
            "PyAudio is not installed in this environment; microphone "
            "capture is gated. Use --wav FILE or the synthetic stream.")
    pa = pyaudio.PyAudio()
    sr = stream.cfg.frontend.sample_rate
    h = pa.open(format=pyaudio.paInt16, channels=1, rate=sr, input=True,
                frames_per_buffer=args.chunk)
    print("listening (ctrl-c to stop)...")
    try:
        while True:
            raw = h.read(args.chunk)
            x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
            for lab, s, e in stream.feed(x):
                print(f"[{s * period:7.2f}s - {e * period:7.2f}s] {lab}")
    except KeyboardInterrupt:
        pass
    finally:
        h.close()
        pa.terminate()


def _add_noise_adapt(p):
    p.add_argument("--noise-adapt", action="store_true", dest="noise_adapt",
                   help="GMM-HMM only: estimate the test noise floor from "
                        "VAD-rejected frames and log-add-PMC the Gaussian "
                        "means before scoring (ops/noise_adapt.py)")


def _add_connected_method(p):
    p.add_argument("--connected-method", choices=("vad", "level"),
                   default="vad", dest="connected_method",
                   help="connected decoder: 'vad' = silence-gap splitter "
                        "(default); 'level' = joint frame-synchronous DP "
                        "— handles GAPLESS/coarticulated speech (template "
                        "level building for --bank, connected Viterbi "
                        "for --hmm)")
    p.add_argument("--grammar", metavar="JSON",
                   help="finite-state word-grammar spec file constraining "
                        "the connected decode (method 'level' only): "
                        "allowed start/end words and word pairs — "
                        "ops/grammar.py docstring for the format")
    p.add_argument("--word-penalty", type=float, default=0.0,
                   help="level-building per-word cost bias (0 = pure "
                        "distance; raise to discourage over-segmentation)")


def _add_reject(p):
    p.add_argument("--reject", action="store_true",
                   help="utterance verification: queries whose best bank "
                        "distance fails the rejection threshold come "
                        "back '<reject>' instead of the nearest enrolled "
                        "word (OOV/garbage input).  Uses the per-bank "
                        "threshold enroll calibrated and stored; "
                        "override with --reject-threshold")
    p.add_argument("--reject-threshold", type=float, default=None,
                   metavar="D",
                   help="explicit rejection threshold in the matcher's "
                        "score units (implies --reject)")


def _reject_arg(args):
    """argparse flags -> classify_batch's reject parameter."""
    thr = getattr(args, "reject_threshold", None)
    if thr is not None:
        return thr
    return True if getattr(args, "reject", False) else None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dsp_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device every command computes on (default "
                         "cuda: the card; without one the command raises). "
                         "'cpu' runs it on the CPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("make-corpus", help="write a synthetic WAV corpus")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=5, help="utterances per word/split")
    p.add_argument("--words", type=int, default=None,
                   help="vocabulary size (default: 10 digits; the full "
                        "35-class confusable vocabulary with --hostile)")
    p.add_argument("--connected", type=int, default=0, metavar="N",
                   help="also write N connected multi-word recordings + "
                        "labels.tsv manifest (for evaluate-connected)")
    p.add_argument("--gapless", action="store_true",
                   help="butt the connected words together with NO "
                        "silence gaps (decode with --connected-method "
                        "level; the VAD splitter cannot segment these)")
    p.add_argument("--spotting", type=int, default=0, metavar="N",
                   help="also write N continuous keyword-spotting "
                        "streams (keywords + out-of-vocabulary "
                        "distractor words, short gaps) + events.tsv "
                        "ground truth (for evaluate-spot)")
    p.add_argument("--hostile", action="store_true",
                   help="adversarial corpus: 35 confusable classes, "
                        "held-out test speakers (io/hostile.py)")
    p.add_argument("--condition", default="clean",
                   help="test-split degradation (hostile only): clean | "
                        "snr20|snr10|snr5|snr0 | tilt | reverb | 'a+b'")
    p.set_defaults(fn=cmd_make_corpus)

    p = sub.add_parser("enroll", help="build a template bank from a corpus")
    p.add_argument("--corpus", required=True)
    p.add_argument("--bank", required=True)
    p.add_argument("--no-spot-calibration", action="store_true",
                   help="skip the per-bank spotting-threshold "
                        "calibration normally stored in the bank "
                        "(a K x K subsequence-DTW scan at enroll time)")
    p.add_argument("--no-reject-calibration", action="store_true",
                   help="skip the per-bank OOV-rejection-threshold "
                        "calibration normally stored in the bank "
                        "(a K x K classification DTW at enroll time; "
                        "recognize --reject uses the stored value)")
    _add_common(p)
    p.set_defaults(fn=cmd_enroll)

    p = sub.add_parser("recognize", help="classify WAV files")
    p.add_argument("--bank", required=True)
    p.add_argument("--connected", action="store_true",
                   help="treat each WAV as a recording of SEVERAL words: "
                        "the multi-segment VAD splits it and every "
                        "segment is classified (prints space-joined "
                        "labels per file)")
    p.add_argument("--max-segments", type=int, default=8,
                   help="segment capacity per recording (--connected)")
    p.add_argument("--nbest", type=int, default=1, metavar="N",
                   help="> 1: print the top-N hypotheses per file as "
                        "label:distance:weight triplets (weight = "
                        "relative confidence, pipeline.nbest_from_scores)")
    _add_reject(p)
    _add_connected_method(p)
    _add_trace(p)
    p.add_argument("wavs", nargs="+")
    _add_common(p)
    p.set_defaults(fn=cmd_recognize)

    p = sub.add_parser("evaluate", help="accuracy of a bank on a corpus")
    p.add_argument("--corpus", required=True)
    p.add_argument("--bank", required=True)
    _add_reject(p)
    _add_trace(p)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("evaluate-connected",
                       help="WER of any family on connected recordings")
    p.add_argument("--corpus", required=True,
                   help="dir with labels.tsv + WAVs (make-corpus --connected)")
    p.add_argument("--bank", help="kNN-DTW template bank checkpoint")
    p.add_argument("--hmm", help="GMM-HMM model checkpoint")
    p.add_argument("--vq", help="VQ codebook checkpoint")
    p.add_argument("--max-segments", type=int, default=8)
    _add_connected_method(p)
    _add_noise_adapt(p)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_connected)

    p = sub.add_parser("spot", help="keyword search in unsegmented WAVs")
    p.add_argument("--bank",
                   help="template bank of the KEYWORDS to spot "
                        "(subsequence-DTW spotter)")
    p.add_argument("--hmm",
                   help="GMM-HMM checkpoint: open-endpoint Viterbi vs "
                        "the stored UBM filler (per-frame LLR scores, "
                        "default threshold 0).  With --bank AS WELL this "
                        "becomes the CASCADE spotter: HMM landmarks "
                        "propose candidate windows, exact subsequence DTW "
                        "against the bank relabels/re-spans them "
                        "(full-word spans, DTW score units)")
    p.add_argument("--hmm-threshold", type=float, default=None,
                   help="cascade only: stage-1 candidate LLR floor "
                        "(default -45, permissive — stage 2 restores "
                        "precision)")
    p.add_argument("--threshold", type=float, default=None,
                   help="span-normalised DTW score below which a match "
                        "is an event (same units as classify "
                        "distances); default: the bank's stored "
                        "calibration, else 40; calibrate per deployment "
                        "with evaluate-spot")
    p.add_argument("--stream", action="store_true",
                   help="online decode (events confirmed chunk-by-"
                        "chunk) instead of the offline batch: SPRING "
                        "DP with --bank, the keyword/filler column "
                        "update with --hmm, the bounded-lag streaming "
                        "cascade with both")
    p.add_argument("--calibrate-threshold", action="store_true",
                   help="DTW spotter only: derive the threshold from "
                        "the bank itself (genuine/impostor score "
                        "midpoint)")
    p.add_argument("wavs", nargs="+")
    _add_common(p)
    p.set_defaults(fn=cmd_spot)

    p = sub.add_parser("evaluate-spot",
                       help="precision/recall/F1 of keyword spotting")
    p.add_argument("--corpus", required=True,
                   help="dir with events.tsv + WAVs (make-corpus "
                        "--spotting)")
    p.add_argument("--bank", help="DTW spotter (50%%-overlap hit rule)")
    p.add_argument("--hmm", help="HMM spotter (midpoint hit rule); "
                                 "with --bank as well: cascade spotter "
                                 "(50%%-overlap rule — full-word spans)")
    p.add_argument("--hmm-threshold", type=float, default=None,
                   help="cascade stage-1 candidate LLR floor")
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--calibrate-threshold", action="store_true",
                   help="DTW spotter only: per-bank threshold (see "
                        "`spot --calibrate-threshold`)")
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_spot)

    p = sub.add_parser("serve",
                       help="resident recognition loop (stdin WAV paths "
                            "-> stdout label lines)")
    p.add_argument("--bank", required=True)
    p.add_argument("--max-segments", type=int, default=8,
                   help="segment capacity for 'connected <path>' lines")
    p.add_argument("--grammar", metavar="JSON",
                   help="word-grammar spec applied to 'level <path>' "
                        "requests (ops/grammar.py docstring format)")
    p.add_argument("--nbest", type=int, default=3,
                   help="hypothesis count for 'nbest <path>' lines")
    p.add_argument("--spot-threshold", type=float, default=None,
                   help="detection threshold for 'spot <path>' lines; "
                        "default = the bank's stored calibration, else "
                        "40 (see `spot --threshold`)")
    _add_common(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("train-hmm", help="train per-word GMM-HMMs")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--states", type=int, default=5)
    p.add_argument("--mix", type=int, default=3)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--map-tau", type=float, default=0.0,
                   help="> 0: MAP-adapt word HMMs from a universal "
                        "background GMM (few-shot regulariser)")
    p.add_argument("--train-mode", choices=["viterbi", "baum_welch"],
                   default="viterbi")
    p.add_argument("--no-reject-calibration", action="store_true",
                   help="skip the OOV-rejection LLR calibration on the "
                        "training corpus normally stored in the model")
    _add_common(p)
    p.set_defaults(fn=cmd_train_hmm)

    p = sub.add_parser("evaluate-hmm", help="accuracy of a GMM-HMM model")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--states", type=int, default=5)
    p.add_argument("--mix", type=int, default=3)
    p.add_argument("--iters", type=int, default=10)
    _add_noise_adapt(p)
    _add_reject(p)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_hmm)

    p = sub.add_parser("train-vq", help="train per-word VQ codebooks")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--codes", type=int, default=64, help="codebook size")
    p.add_argument("--iters", type=int, default=10, help="k-means iters")
    _add_common(p)
    p.set_defaults(fn=cmd_train_vq)

    p = sub.add_parser("evaluate-vq", help="accuracy of a VQ model")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_vq)

    p = sub.add_parser("bench", help="run the headline throughput benchmark")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "warm", help="build the kernels into build/, which later processes "
                     "load, and check that the serving programs run (that "
                     "check warms only this process)")
    p.add_argument("--bank", default=None,
                   help="existing bank .npz (its size/matcher/k define the "
                        "programs); omit to use a synthetic bank")
    p.add_argument("--bank-size", type=int, default=100,
                   help="synthetic bank templates when no --bank")
    p.add_argument("--batches", default="1,256",
                   help="comma-separated query batch sizes to run "
                        "(classify_batch chunks at 256)")
    p.add_argument("--timeout", type=float, default=None,
                   help="the JAX CLI's per-batch deadline of its relay "
                        "child: accepted, not read (the port warms in "
                        "process)")
    p.add_argument("--retries", type=int, default=None,
                   help="the JAX CLI's relay retries: accepted, not read")
    p.add_argument("--connected", default="", metavar="M1,M2",
                   help="also run the connected decoders (VAD split + "
                        "level building; + the grammar DP with --grammar) "
                        "and the spotter at these recording-length "
                        "multiples of max_samples: what serve's "
                        "'connected '/'level '/'spot ' prefixes run")
    p.add_argument("--max-segments", type=int, default=8,
                   help="segment/level capacity for --connected warming "
                        "(must match serving)")
    p.add_argument("--grammar", metavar="JSON",
                   help="grammar spec to warm the constrained DP with "
                        "(--connected only)")
    p.add_argument("--stages", nargs="?", const="256x100", default="",
                   metavar="CHUNKxK[,..]",
                   help="also run the fe-profile stages "
                        "(dsp_tpu_torch/scripts/fe_profile.py: noop/mfcc/"
                        "vad/fe/dtw/full) at these chunk-x-templates shapes "
                        "(bare flag = the 256x100 bench shape)")
    _add_common(p)
    p.set_defaults(fn=cmd_warm)

    p = sub.add_parser("evaluate-sc2",
                       help="Speech Commands v2 kNN-DTW eval (local dataset)")
    p.add_argument("--root", required=True,
                   help="extracted speech_commands_v2 directory")
    p.add_argument("--split", choices=["test", "validation"], default="test")
    p.add_argument("--templates", type=int, default=10,
                   help="templates enrolled per word")
    p.add_argument("--limit", type=int, default=None,
                   help="cap test clips per word")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--no-mesh", action="store_true",
                   help="under torchrun, run the whole bank on each rank "
                        "instead of sharding it over the ranks")
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_sc2)

    p = sub.add_parser("plot", help="render pipeline internals to PNG")
    p.add_argument("--wav", default=None)
    p.add_argument("--word", default="three", help="synthetic word if no --wav")
    p.add_argument("--bank", default=None, help="optional bank for distances")
    p.add_argument("--out", default="pipeline.png")
    _add_common(p)
    p.set_defaults(fn=cmd_plot)

    p = sub.add_parser("demo", help="streaming recognition demo")
    p.add_argument("--bank", required=True)
    p.add_argument("--wav", default=None)
    p.add_argument("--mic", action="store_true")
    p.add_argument("--chunk", type=int, default=1600)
    _add_common(p)
    p.set_defaults(fn=cmd_demo)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
