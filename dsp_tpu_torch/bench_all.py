"""Every BASELINE.json config of the port and the bonus rows, one JSON line each.

    python -m dsp_tpu_torch.bench_all          # on the card

Port of ``bench_all.py``.  Each row is timed with CUDA events
(``utils/timing.chained_timeit_spread``) over ``BENCH_ALL_PASSES``
(default 3) passes of back-to-back calls after one warm-up call; its line
carries value = the MEDIAN rate plus min and max.  The rows, in the JAX
script's order (kernels on the card in brackets):

  0. single WAV -> MFCC -> DTW against a 10-digit bank (latency, ms) [1]
  1. 256 utterances x 100 templates (the headline throughput, as
     ``dsp_tpu_torch.bench``) [1]
  2. the streaming front end on 100 ms chunks (real-time factor)
  3. GMM-HMM log-space Viterbi decode of 256 utterances x 10 words
  4. 35-class kNN-DTW, 35 synthetic words x 3 templates (a stand-in for
     Speech Commands; ``python -m dsp_tpu_torch evaluate-sc2`` runs a
     local checkout) [1]
  connected        64 clips of 3 digits: the VAD split, then one flat
                   classify of every segment [1]
  connected-level  the gapless level-building DP on the same clips
  spot             subsequence DTW of the clips against the 100-template
                   bank, the production route (``impl="auto"``) [3]
  spot-scan        the same on the plain route, the kernel's comparison
  spot-hmm         the 10-word keyword/filler scan (cascade stage 1)
  ltw              the linear-time-warp matcher (one GEMM)

``rows(device, **sizes)`` builds the rows (the step, its arguments,
calls a pass, units a call and the line's names); ``timed(row, passes)``
times one and prints its line.  Each step takes its arguments as they
are: one stream orders the launches, so no token links the calls.

Only a card is timed: ``DSP_TPU_PLATFORM`` names the device (default the
card) and any other raises, as the port's other CUDA-event scripts do.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from dsp_tpu_torch import pipeline, scripts
from dsp_tpu_torch.config import PipelineConfig
from dsp_tpu_torch.io.dataset import DIGITS, synth_connected, synth_word
from dsp_tpu_torch.models import gmm_hmm as gh
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops import streaming
from dsp_tpu_torch.ops.level_building import level_build
from dsp_tpu_torch.ops.spot import subseq_dtw_batch
from dsp_tpu_torch.ops.spot_hmm import spot_hmm_batch
from dsp_tpu_torch.utils import timing

W, S, M = 10, 5, 3          # config 3's words, states a word, mixtures a state
CHUNK_LEN = 1600            # config 2: 100 ms of audio at 16 kHz
CONN_WORDS = 3              # words a connected clip
MAX_SEGMENTS = 4
MAX_LEVELS = 4
LTW_FRAMES = 64
SC2_NOTE = ("real SC2 data detected: run `python -m dsp_tpu_torch evaluate-sc2 --root ...` "
            "for the real-data accuracy/throughput; the line below is the synthetic stand-in")


class Row(NamedTuple):
    step: Callable
    args: tuple
    n_iters: int            # calls a timed pass
    scale: float | None     # units a call (None: the latency row, in ms)
    meta: dict              # the line's config, metric and unit


def emit(**kv):
    print(json.dumps(kv), flush=True)


def _bank_signals(words, per_word: int, max_samples: int):
    sigs = np.stack([synth_word(w, i, max_samples=max_samples)
                     for w in words for i in range(per_word)])
    ns = np.full(len(sigs), max_samples, dtype=np.int32)
    ids = np.repeat(np.arange(len(words), dtype=np.int32), per_word)
    return sigs, ns, ids


def inputs(cfg, batch: int = 256, templates_per_word: int = 10, clips: int = 64,
           sc2_words: int = 35, sc2_per_word: int = 3) -> dict:
    """The rows' host inputs, drawn as the JAX script draws them: banks
    ``bank10`` / ``bank100`` / ``bank35`` as (signals, n_samples, ids),
    ``x1`` [1, N] and ``xb`` [batch, N] queries, config 2's ``chunk``,
    config 3's ``params`` (``default_rng(0)``), the connected ``conn``
    [clips, 3 N] with ``clens``, and the UBM ``ubm`` (the same generator,
    next draw).  Params and UBM are CPU tensors, the rest numpy."""
    n = cfg.max_samples
    f = cfg.frontend.n_feats
    rng = np.random.default_rng(0)
    params = gh.HmmParams(
        log_pi=torch.tensor([0.0] + [gh.NEG_INF] * (S - 1), dtype=torch.float32).tile(W, 1),
        log_a=gh._lr_log_a(torch.full((S,), 0.6), S)[None].tile(W, 1, 1),
        means=torch.from_numpy(rng.standard_normal((W, S, M, f)).astype(np.float32)),
        log_var=torch.zeros((W, S, M, f)),
        log_mix=torch.full((W, S, M), -np.log(M), dtype=torch.float32),
    )
    clen = CONN_WORDS * n
    conn = np.zeros((clips, clen), np.float32)
    clens = np.zeros(clips, np.int32)
    for i in range(clips):
        x = synth_connected([DIGITS[(i + j) % 10] for j in range(CONN_WORDS)], 300 + i)
        m = min(len(x), clen)
        conn[i, :m] = x[:m]
        clens[i] = m
    ubm = (torch.from_numpy(rng.standard_normal((M, f)).astype(np.float32)),
           torch.zeros((M, f)), torch.full((M,), -np.log(M), dtype=torch.float32))
    return dict(
        bank10=_bank_signals(DIGITS, 1, n),
        x1=synth_word("three", 123)[None],
        bank100=_bank_signals(DIGITS, templates_per_word, n),
        xb=np.stack([synth_word(DIGITS[i % 10], 1000 + i, max_samples=n)
                     for i in range(batch)]),
        chunk=synth_word("five", 7)[:CHUNK_LEN],
        params=params,
        bank35=_bank_signals([f"w{i:02d}" for i in range(sc2_words)], sc2_per_word, n),
        conn=conn, clens=clens, ubm=ubm)


# -------------------------------------------------------------- the steps
def _labels(signals, n_samples, bank, ids, cfg):
    return pipeline.recognize_batch(signals, n_samples, bank, ids, cfg)[0]


def _stream(chunk, state, mats, cfg):
    return streaming.process_chunk(state, chunk, mats, cfg.frontend, cfg.vad,
                                   CHUNK_LEN)[1].mfcc


def _connected(signals, n_samples, bank, ids, cfg):
    return pipeline.recognize_connected_batch(signals, n_samples, bank, ids, n_labels=10,
                                              cfg=cfg, max_segments=MAX_SEGMENTS)[0]


def _level(feats, lengths, bank_feats, bank_lens):
    return level_build(feats, lengths, bank_feats, bank_lens, max_levels=MAX_LEVELS,
                       word_penalty=0.0)[0]


def _spot(streams, lengths, bank_feats, bank_lens, impl):
    return subseq_dtw_batch(streams, lengths, bank_feats, bank_lens, impl=impl)


def _ltw(signals, n_samples, bank, ids, cfg):
    feats = pipeline.extract_features(signals, n_samples, cfg)
    return pipeline.classify_features_ltw(feats, bank, ids, LTW_FRAMES)[0]


def rows(device, **sizes) -> list:
    """The eleven rows on ``device``, in the JAX script's order; ``sizes``
    (:func:`inputs`' keywords) default to the JAX script's.  The spotting
    steps return (scores, start witnesses), as the ops do."""
    dev = torch.device(device)
    cfg = PipelineConfig()
    inp = inputs(cfg, **sizes)

    def on(a):
        return torch.as_tensor(a).to(dev)

    def bank(name):
        sigs, ns, ids = inp[name]
        return pipeline.extract_features(on(sigs), on(ns), cfg), on(ids)

    bank10, ids10 = bank("bank10")
    bank100, ids100 = bank("bank100")
    bank35, ids35 = bank("bank35")
    x1, xb = on(inp["x1"]), on(inp["xb"])
    n1 = torch.full((1,), cfg.max_samples, dtype=torch.int32, device=dev)
    b = xb.shape[0]
    nb = torch.full((b,), cfg.max_samples, dtype=torch.int32, device=dev)
    k100, k35 = bank100.feats.shape[0], bank35.feats.shape[0]
    params = gh.HmmParams(*(on(p) for p in inp["params"]))
    feats = pipeline.extract_features(xb, nb, cfg)

    conn, clens = on(inp["conn"]), on(inp["clens"])
    f = cfg.frontend
    t_rec = max(1, 1 + (conn.shape[1] - f.frame_len) // f.hop_len)
    conn_feats = pipeline.extract_recording_features(conn, clens, cfg, t_rec)
    n_words = conn.shape[0] * CONN_WORDS
    audio_s = float(np.sum(inp["clens"])) / f.sample_rate
    spot_args = (conn_feats.feats, conn_feats.length, bank100.feats, bank100.length)
    ubm = tuple(on(u) for u in inp["ubm"])

    def meta(config, metric, unit):
        return dict(config=config, metric=metric, unit=unit)

    return [
        Row(_labels, (x1, n1, bank10, ids10, cfg), 16, None,
            meta(0, "single_wav_recognize_latency_ms", "ms")),
        Row(_labels, (xb, nb, bank100, ids100, cfg), 8, b * k100,
            meta(1, "mfcc_dtw_alignments_per_sec_per_chip", "alignments/s/chip")),
        Row(_stream, (on(inp["chunk"]), streaming.init_state(f, CHUNK_LEN, dev),
                      fe.make_matrices(f, dev), cfg), 32, 0.1,
            meta(2, "streaming_realtime_factor", "x realtime (100ms chunks)")),
        Row(gh.score_words, (feats.feats, feats.length, params), 48, b * W,
            meta(3, "viterbi_decodes_per_sec", "utterance-word decodes/s/chip")),
        Row(_labels, (xb, nb, bank35, ids35, cfg), 8, b * k35,
            meta(4, "sc2_style_35class_alignments_per_sec",
                 "alignments/s/chip (synthetic 35-class)")),
        Row(_connected, (conn, clens, bank100, ids100, cfg), 8, n_words,
            meta("connected", "connected_words_per_sec_per_chip",
                 "words/s/chip (multi-segment split + classify, 3-word clips)")),
        Row(_level, (conn_feats.feats, conn_feats.length, bank100.feats, bank100.length),
            4, n_words,
            meta("connected-level", "level_building_words_per_sec_per_chip",
                 "words/s/chip (gapless level-building DP, 3-word clips, "
                 "100-template bank)")),
        Row(_spot, (*spot_args, "auto"), 4, audio_s,
            meta("spot", "spotting_audio_seconds_per_sec_per_chip",
                 "audio-s/s/chip (100-template subsequence match, witnesses, "
                 "production routing)")),
        Row(_spot, (*spot_args, "scan"), 4, audio_s,
            meta("spot-scan", "spotting_scan_audio_seconds_per_sec_per_chip",
                 "audio-s/s/chip (100-template subsequence plain row scan)")),
        Row(spot_hmm_batch, (conn_feats.feats, conn_feats.length, params, ubm), 8, audio_s,
            meta("spot-hmm", "hmm_spotting_audio_seconds_per_sec_per_chip",
                 "audio-s/s/chip (10-word keyword/filler scan, cascade stage 1)")),
        Row(_ltw, (xb, nb, bank100, ids100, cfg), 16, b * k100,
            meta("ltw", "ltw_comparisons_per_sec_per_chip",
                 "comparisons/s/chip (fast matcher)")),
    ]


def timed(row: Row, passes: int) -> dict:
    """Time one row and print its line (the JAX script's keys and order)."""
    med, lo, hi = timing.chained_timeit_spread(row.step, row.args, n_iters=row.n_iters,
                                               passes=passes)
    if row.scale is None:
        line = dict(config=row.meta["config"], metric=row.meta["metric"],
                    value=round(med * 1e3, 3), passes=passes, min=round(lo * 1e3, 3),
                    max=round(hi * 1e3, 3), unit=row.meta["unit"])
    else:
        # rates invert the time order: the fastest pass gives the max rate
        line = dict(value=round(row.scale / med, 1), passes=passes,
                    min=round(row.scale / hi, 1), max=round(row.scale / lo, 1), **row.meta)
    emit(**line)
    return line


def main() -> list:
    """Every row on the card, one line each; returns the lines."""
    dev = scripts.require_card(os.environ.get("DSP_TPU_PLATFORM", "") or "cuda", "bench_all")
    passes = int(os.environ.get("BENCH_ALL_PASSES", 3))
    print(f"# bench_all: device {scripts.describe_device(dev)}", file=sys.stderr)
    lines = []
    for row in rows(dev):
        if row.meta["config"] == 4 and os.environ.get("SC2_ROOT"):
            emit(config="4-note", note=SC2_NOTE)
        lines.append(timed(row, passes))
    return lines


if __name__ == "__main__":
    main()
