"""Command-line interface of the port: ``python -m dsp_tpu_torch``.

The template and spotting subcommands of the JAX package's CLI
(``dsp_tpu/cli.py``), with its flags, defaults, stdout lines and metrics
JSON keys, over the port's recognizers:

    python -m dsp_tpu_torch make-corpus --out data/ --n 5
    python -m dsp_tpu_torch enroll      --corpus data/train --bank bank.npz
    python -m dsp_tpu_torch recognize   --bank bank.npz one.wav two.wav
    python -m dsp_tpu_torch evaluate    --corpus data/test --bank bank.npz
    python -m dsp_tpu_torch evaluate-connected --corpus data/connected --bank bank.npz
    python -m dsp_tpu_torch spot        --bank bank.npz stream.wav
    python -m dsp_tpu_torch evaluate-spot --corpus data/spotting --bank bank.npz
    python -m dsp_tpu_torch serve       --bank bank.npz < paths.txt

Every command runs on the card; ``--device cpu`` (before the subcommand)
runs it on the CPU instead.  Without a card the default raises, as every
entry point of the port does.  Banks and models are the JAX package's
``.npz`` files, so either CLI reads what the other wrote.  Every flag maps
1:1 onto a config dataclass field; defaults are the classical values
(16 kHz, 25 ms/10 ms, 13 MFCC, lifter 22).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from dsp_tpu_torch.config import DtwConfig, FrontendConfig, PipelineConfig, VadConfig
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


def _maybe_mesh(args):
    """--mesh -> a ('data', 'bank') mesh when this process is one rank of
    a world of more than one (torchrun's environment), else None."""
    if not getattr(args, "mesh", False):
        return None
    import torch.distributed as dist

    from dsp_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize(device=args.device)
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    mesh = make_mesh(device=args.device)
    log.info("using a %s mesh", dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    return mesh


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


def cmd_recognize(args):
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
    p.add_argument("wavs", nargs="+")
    _add_common(p)
    p.set_defaults(fn=cmd_recognize)

    p = sub.add_parser("evaluate", help="accuracy of a bank on a corpus")
    p.add_argument("--corpus", required=True)
    p.add_argument("--bank", required=True)
    _add_reject(p)
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
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
