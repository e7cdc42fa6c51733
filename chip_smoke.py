#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dsp_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--out report.json]

Run from the repository root on a machine with one CUDA card.  Phases,
each of which raises on failure (non-zero exit):

1. build   — compile the CUDA kernels from ``dsp_tpu_torch/csrc`` (nvcc).
2. dtw     — the banded DTW kernel against its plain PyTorch version at the
             main-path shape (B=256 queries x K=100 templates, T=U=198,
             F=39, seeded lengths in [20, 198]) under four configs, plus a
             sliding-window shape (T=120, U=300, band 0.1) and B=16, K=8
             at U=1,357 (the longest template staged whole), 1,358 and
             3,000 (the kernel's window mode).  The
             BIG/finite pattern must be identical and finite distances
             allclose at rtol 1e-4 (other summation order; the kernel sums
             (a-b)^2 directly where the plain version expands
             |a|^2+|b|^2-2ab).  Then 65,537 queries x 4 templates
             (T=U=24): two launches, the same check.
3. mfcc    — the fused MFCC kernel against its plain version on the
             50,688 frames of 256 synthetic 2 s utterances: the FFT mode
             (n_fft = 512) with use_energy off and on, and the GEMM mode at
             n_fft = 480; allclose at rtol/atol 1e-3, and the kernel's max
             error to a float64 evaluation of the chain (on the card) at
             most twice the plain version's.  Then n_fft = 64 (samples
             folded six times: the float64 folded path of kernel and plain
             version), by the same two rules.  Then, at n_fft 16, 32, 64,
             128 and 256 (all folded), both modes on the same frames and on
             the card test's (3 utterances of "eight"): no value past
             rtol/atol 1e-3 of the plain version, and kernel and plain
             within 1e-3 of float64.  Prints the plan (mode, warps,
             frames a warp, shared bytes), both forms' bounds (the GEMM
             form's operations, the FFT mode's bytes) and, as a yardstick
             of the spectrum part only, ``torch.fft.rfft(frames * window,
             n=512)`` with the power.
4. small   — ``pipeline.dtw_pairs`` with ``impl="auto"`` on small batches
             (one query against 1, 10 and 100 templates; 8 against 10):
             one kernel launch per call, distances as the plain scan's
             (rtol 1e-4), both timed.
5. main    — ``KnnDtwRecognizer(device="cuda")``: enroll 10 digits x 10
             synthetic templates, classify 1024 queries (chunks of 256)
             with the default config and with the fused front-end
             (``FrontendConfig(impl="pallas")``); kernel launch counts are
             reset just before and read just after, and the labels must
             equal those of the plain paths on the card (a mismatch is
             allowed only where the plain top-2 distances are within 1e-4
             relative); one ``recognize`` call per config must launch the
             DTW kernel once (none on the plain paths) and give the label
             the batch gave.  Beside the host-clock stages of one chunk,
             the features stage's device time: its kernels' sum under
             ``torch.profiler`` over one call, with the three largest.
6. spot    — the subsequence-DTW kernel against its plain version at the
             bench_all.py spotting shape (64 recordings of 3 connected
             digits, 598 frames, against 10 digits x 10 templates of 198
             frames) and at two long-stream shapes against the same bank,
             4 streams of 60 s (5,998 frames) each: synthetic recordings
             of random digits, and standard-normal features; squared off
             and on.  The BIG/finite pattern must be identical; where the
             start witnesses agree, norms allclose at rtol 2e-4; where
             they differ (near-ties rounded apart), the raw costs
             norm * (tl + span) must agree to 1e-4 relative and such sites
             stay under 0.1% (tests/test_tpu_device.py:333).  Prints the
             costs the kernel computes and its lane-steps against the cells
             needed, and at ``bench`` its time, warps an SM and registers
             with at most 8 and 4 warps a block.  Then, from a generator of their own, 8
             streams of 1,200 standard-normal frames against 4 templates of
             1,100 frames at F = 39 and of 600 frames at F = 128 (the first
             design refused both), the same comparison.
7. spotter — ``KeywordSpotter(KnnDtwRecognizer(device="cuda"))`` with
             keywords zero..four x 20 templates: ``calibrate_threshold``
             once, then ``spot`` over 64 synthetic 8-word streams of the
             ten digits; the kernel count is reset just before and read
             just after and must be > 0.  The score fields must match the
             plain route's (``impl="scan"``) as in phase 6, and the events
             must be equal except in streams with a witness near-tie.
             Prints the keyword hit rate, the false alarms and
             spotting_audio_seconds_per_sec (audio seconds over the median
             of 3 synchronized ``scores`` passes), and one ``spot`` pass
             broken into stages (pad + copy, features, kernel, copy back,
             event extraction).
8. fused   — the unbanded DTW kernel from features against its plain
             version (the closed form) at the main-path shape (B=256,
             K=100, T=U=198, F=39, seeded lengths in [20, 198]), squared off
             and on, and against the banded kernel's unbanded mode on the
             same inputs: identical BIG/finite pattern, allclose at rtol
             1e-4 / atol 1e-5 (tests/test_pallas_dtw.py:103).  Prints the
             costs computed and lane-steps against the cells needed, and
             the time, warps an SM and registers with at most 8 and 4 warps
             a block.
             Then, from a generator of their own, 16 x 8 pairs at U = 4,000
             (window mode) and 8 x 8 at a query of T = 2,000 frames against
             the plain version.
9. wavefront — the wavefront DP kernel against its plain version on the
             masked cost of the same shape (25,600 pairs, 4.0 GB) under the
             default config, ``band_frac=None`` and the pure band
             (``max_warp_scale=None``): identical BIG pattern, rtol 1e-5
             (each cell is one exact min and one add, so the bits should
             agree); the masked-cost build is timed beside the kernel, and
             the kernel's read rate over the cells it reads, its warps an SM
             (CUDA's occupancy calculator) and, at the default case, its
             time at 4 and 8 warps a block with the share of warp time a
             block's longest pair keeps idle.  Then
             ``dtw_pairs_pallas`` on a cascade-shaped batch (256 queries x 8
             candidates) against the plain DP and the paired scan.
10. matchers — the recognizer's matcher, rejection and evaluation path at
             full width: a bank of 10 digits x 10 templates, then per route
             (default: kernel 1; ``band_frac=None``: kernel 1 unbanded;
             ``impl="fused"``: kernel 4; ``impl="pallas"``: kernel 5;
             ``matcher="cascade"``: kernel 5 in the rerank; ``matcher="ltw"``:
             one GEMM; ``bucketed=True``: kernel 1) ``calibrate_rejection``
             -> ``evaluate`` of 1,024 digit queries plus 3 out-of-vocabulary
             words x 32 with ``reject=True`` -> ``classify_nbest`` of one
             256-query chunk.  Launch counts are reset just before each
             route and read just after; each kernel route must launch its
             kernel.  Labels of ``fused`` must equal the unbanded route's and
             labels of ``pallas`` the default route's except at near-ties
             (plain top-2 within 1e-4 relative), bucketed distances must
             equal the default route's, the cascade's rerank and the LTW
             distances must match their plain versions on one chunk, and the
             n-best top-1 must equal the label.  Prints per route the
             accuracy, the OOV reject rate, the threshold, queries/s (median
             of 3 synchronized ``classify_batch(reject=True)`` passes) and
             the launches per pass.
11. mb_wavefront — kernels 6-10: ``dsp_tpu_torch.scripts.mb_wavefront``'s
             experiments E0-E4 at the JAX script's shapes (launch counts
             reset just before and read just after; each of the six
             kernels must launch), then each kernel against its plain
             version on seeded inputs at those shapes: ``dp_diet`` on
             standard-normal costs with 5 % BIG cells, ktarget in [-1, D]
             and la in [0, T+1], bit-equal; the fetch at rtol 1e-6;
             anatomy bit-equal at 64 steps for 0-2 rolls (timed at 4000);
             trivial, transpose and skew bit-equal.  The library calls
             ``x * 2.0`` and ``x.transpose(1, 2).contiguous()`` are timed
             beside the trivial and transpose kernels (the trivial kernel
             and ``x * 2.0`` over 1,001 single calls: they are host-bound).
             E4's fp32 einsum is held to float64 on two queries x three
             templates.  Then where a launch's host time goes: each piece of
             the wrapper path (stream getters, the ctypes call, the output
             allocation, the checks, ``_build.launch``) over 10,000 calls,
             and host µs a call of ``trivial(x)`` against ``x * 2.0`` and of
             the banded DTW kernel at B = K = 1, over 1,000 back-to-back
             calls ended by one synchronize.

12. streaming — the online path (BASELINE config 2) at full width, the
             default configs, 100 ms chunks: one stream's ``process_chunk``
             on ``bench_all.py``'s chunk (median of 50 synchronized calls,
             the real-time factor, device ops and device time of one call
             under ``torch.profiler``); ``process_chunk_batch`` over 256
             concurrent streams of 2 s digit utterances (time a step, audio
             s/s), its first 10 chunks held against 256 single-stream runs
             and against the CPU (MFCC rtol/atol 1e-3, energies rtol 1e-4,
             flags and indices equal); ``StreamingRecognizer`` over 4
             connected-digit recordings against a 10 x 10 bank, on the card
             and the CPU (events equal; kernel 1's launches, counted from 0,
             equal to the closed utterances; a chunk's time with and without
             a classify); ``StreamingSpotter`` over 4 of the spotter phase's
             streams (keywords zero-four x 20) against ``KeywordSpotter.spot``
             (kernel 3) by JAX's rule (tests/test_spotter.py:128-144: each
             stream at the midpoint of its best keyword score and its best
             other score; labels equal, spans within 2 frames, scores rtol
             1e-3 / atol 1e-5) and against the CPU (labels and spans equal,
             scores rtol 1e-4), with its time a chunk and audio s/s, and at
             the bank's calibrated threshold the streams whose events part
             from the offline spotter's (counted, not held); ``process_chunk``,
             ``process_chunk_batch`` and ``spot_chunk`` run once under
             ``torch.cuda.set_sync_debug_mode("error")``: no call waits for
             the card.
13. hmm    — the GMM-HMM recognizer (BASELINE config 3) at full width,
             plain PyTorch on the card: the default ``HmmConfig`` (5
             states, 3 mixtures, 10 EM iterations, F = 39, T = 198) fitted
             on 10 digits x 10 utterances, segmental (fitted twice, both
             timed) and Baum-Welch, each against the CPU's EM on the same
             features from the same ``torch.Generator`` draws: one
             segmental E-step from the same parameters (statistics within
             1e-2 as max |a - b| / (1 + |b|), transition counts equal), and
             each whole fit's labels on the queries equal to the CPU fit's
             except at near-ties (the parameters part by a few 1e-2 in
             float32 over ten iterations: printed, and held under 0.5 as a
             bound on gross breaks); ``classify_batch`` of
             ``bench_all.py``'s 256 queries and 3 OOV words x 32 against
             the CPU on the same parameters (labels
             equal except where the top-2 log-liks lie within 1e-4
             relative); ``calibrate_rejection`` -> ``evaluate(reject=True)``
             with the reject decisions held to the CPU's at the card's
             threshold (except within 1e-3 of it or at near-ties) and the
             n-best top-1 to the label; a ``noise_adapt=True`` classify of
             the queries under sigma 0.05 noise against the CPU's; a
             save/load round trip (parameters, threshold and labels
             equal); and one classify through ``FrontendConfig(impl=
             "pallas")`` with launch counts reset just before and read just
             after (kernel 2 must launch, no other kernel).  Prints fit
             seconds, accuracy, viterbi_decodes_per_sec (bench_all.py:144:
             256 x 10 utterance-word decodes over the CUDA-event time of one
             ``score_words``) and the device ops and device time of one
             ``score_words`` and one ``fit_words_batched`` under
             ``torch.profiler``.
14. cascade — the HMM and cascade keyword spotters (ROADMAP item 12b) on
             a default ``HmmConfig`` model fitted on the card (10 digits x
             10), carried to a CPU recognizer through ``params_to_numpy``.
             ``HmmSpotter.scores`` at bench_all.py's spot-hmm cell (64
             streams of 3 connected digits zero-padded to 96,000 samples,
             598 frames) against the CPU: where the entry witnesses agree,
             LLRs within HMM_SPOT_LLR_TOL; where they differ, the best-path
             log-liks within 1e-4 relative (near-ties) at under 0.1 % of the
             sites; ``spot`` events at the LLR floor -30 equal except in
             streams with such a tie.  Prints
             hmm_spotting_audio_seconds_per_sec (the clips' unpadded audio s,
             as bench_all.py's ``clens``, over the median of 3 synchronized
             ``scores`` passes) and one pass's device ops and device time
             under ``torch.profiler``.  ``StreamingHmmSpotter`` over 4 of
             phase spotter's streams against the card's offline spotter by
             JAX's rule (tests/test_spot_hmm.py:238-246: labels in order,
             spans within 2 frames, scores rtol 1e-3 / atol 2e-3), ms a
             chunk.  ``CascadeSpotter`` with phase spotter's bank (zero to
             four x 20, calibrated threshold) over its 64 streams: kernel
             3's count reset just before ``spot`` and read just after (> 0,
             no other kernel); the window batches that pass hands to
             ``rerank_windows`` are kept, and kernel 3 on each whole batch is
             held against the plain scan (in slices under
             ``_COST_BUDGET_ELEMS``) by ``compare_spot`` at rtol 1e-4
             (identical BIG pattern, witnesses equal except at near-ties);
             ``rescored`` on 8 streams against the CPU cascade (the plain
             scan on the CPU's own features): equal labels and spans,
             scores rtol 2e-4, except in streams whose stage-1 events differ
             between the devices or with a rerank near-tie (picks within
             1e-4); keyword hit rate, false alarms,
             cascade_audio_seconds_per_sec (median of 3 ``spot`` passes) and
             one pass by stage, timed around the calls ``rescored`` makes
             (``_candidates``: features, stage-1 scan, events, window cut;
             ``_rescore``: the rerank through kernel 3; suppression), with
             ``HmmSpotter.scores`` on the same streams timed alone beside
             it.  ``StreamingCascadeSpotter`` over 4 streams, with that bank
             and with one enrolled at ``add_deltas=False`` (where the JAX
             package's clamped readiness check reranks windows cut short):
             on every stream against the same spotter on the CPU (labels
             and spans equal, scores rtol 2e-4) unless the two devices'
             streaming stage-1 landmarks part, and against the card's
             offline cascade (labels in order, spans within 3 frames) where
             the streaming stage-1 landmarks meet the offline ones.  Kernel
             3's launches here join phase spotter's in the kernel table, and
             its error there is the larger of phase spot's and the rerank
             windows'.
15. connected — connected-word decoding (ROADMAP item 13) at
             bench_all.py:167-214's cells: 64 recordings of 3 connected
             digits (``synth_connected([DIGITS[(i + j) % 10] ...], 300 + i)``)
             cut to 96,000 samples, the main phase's bank (10 digits x 10),
             default ``PipelineConfig``.  (a) ``classify_connected(method=
             "vad", max_segments=4)``: launch counts reset just before and
             read just after (kernel 1 only, at least once); labels equal to
             the ``DtwConfig(impl="scan")`` route's except where the plain
             top-2 distances lie within 1e-4 relative; starts, ends and
             segment counts integer-equal to a CPU run of the port; accuracy
             against the truth; connected_words_per_sec_per_chip
             (bench_all.py's: ``recognize_connected_batch`` on the padded
             recordings on the card, median of 3 synchronized calls), with
             its device ops and device time under ``torch.profiler``, and a
             whole ``classify_connected`` pass.  (b) ``method="level"``,
             ``max_levels=4``, ``word_penalty=0`` (no kernel may launch):
             ``level_build``'s planes on the card's features against the
             CPU's DP on 8 of the recordings (costs rtol 1e-4 with the BIG
             pattern equal; words and starts may differ only at sites whose
             costs agree, counted as near-ties; decoded sequences equal
             except where their costs lie within 1e-4), accuracy,
             level_building_words_per_sec_per_chip (``level_build`` on the
             recordings' features, median of 3), its device ops, device
             time and peak memory, and a whole pass.  (c) ``grammar=
             Grammar.no_repeat(DIGITS)``: labels of 8 recordings equal to the
             CPU's.  (d) a ``GmmHmmRecognizer`` fitted at the default
             ``HmmConfig`` (10 digits x 10): ``vad`` and ``level`` labels of
             8 recordings equal to a CPU run on the same parameters, pass
             seconds and accuracy.  (e) ``StreamingConnectedRecognizer`` over
             4 gapless 3-digit recordings in 100 ms chunks: events equal to
             the card's offline ``method="level"`` decode, no kernel
             launched, ms a chunk with and without the DP fed, and one
             speech chunk's device ops and device time.  Kernel 1's launches
             here join phase main's in the kernel table.
16. remainder — the rest of one device (ROADMAP item 14) at config 1's
             shapes (10 digits x 10 templates, 1024 queries, chunks of
             256).  (a) An LPCC ``KnnDtwRecognizer``: launch counts reset
             just before and read just after a classify of the queries
             (kernel 1 x 4, nothing else), again at ``impl="pallas"``
             (still no kernel 2: LPCC has none); labels equal to the plain
             route's except at near-ties; one chunk's features against the
             CPU's at rtol/atol 1e-3 (the measured error printed) with
             the VAD endpoints equal; accuracy, alignments/s and one
             chunk by stage.  (b) ``condense("medoid")`` and
             ``condense("dba", n_iter=3)`` on the main bank, counted
             (kernel 1 once a word, unbanded): each word's medoid equal
             to the CPU's except at near-ties (summed distances within
             1e-4), the medoid bank the medoid templates, DBA centers at
             rtol/atol 1e-4 of the CPU's, two DBA runs bit-equal; the
             10-template bank's labels equal to the plain route's
             (counted: kernel 1 x 4), accuracy beside the full bank's,
             alignments/s, the condense seconds and one word's device
             ops and busy share under ``torch.profiler``.  (c)
             ``VqRecognizer`` at the default ``VqConfig``: one Lloyd step
             from the same init against the CPU (assignments equal except
             at near-ties, centroids within 1e-5 as max |a - b| / (1 +
             |b|)), the fit's labels equal to a CPU fit's except at
             near-ties (the codebooks' distance printed), no kernel
             launched, ``classify_connected`` on phase connected's 64
             recordings equal to the CPU's; fit seconds, queries/s and
             accuracy.  (d) ``dtw_batch_windowed`` and ``dtw_batch_bidi``
             at 256 x 100, T = U = 198 against ``dtw_batch``: the BIG
             pattern identical, rtol 1e-5, each timed beside the scan.
             (e) ``extract_mfcc`` and ``mfcc(use_fft=True)`` against the
             DFT path at rtol/atol 1e-3.  Kernel 1's launches here join
             the kernel table's.
17. mesh   — multi-GPU execution (ROADMAP item 15, BASELINE config 4) on a
             one-rank NCCL mesh (``parallel.make_mesh(1, 1)`` in this plain
             process: a one-rank group on a local store; the backend must
             be NCCL and the mesh's device the card).  Each check runs the
             same call with and without the mesh on the card.  (a) Config
             4 at full width: 35 synthetic words w00..w34 x 3 templates =
             105, 1,024 two-second queries of those words, the default
             config; launch counts reset just before and read just after
             each pass: labels equal, distances within 1e-6 relative (the
             gap printed), kernel 1's launches equal (4 chunks), k = 3
             labels equal, and sc2_style_35class_alignments_per_sec with
             and without the mesh (medians of 6 synchronized passes each,
             timed in turns: plain, mesh, mesh, plain); a
             256-query chunk under ``FrontendConfig(impl="pallas")`` must
             launch kernel 2 under the mesh, with the same labels.  (b)
             ``KeywordSpotter`` over a meshed recognizer (phase spotter's
             bank) on 8 of its streams: kernel 3 launches, the score fields
             equal by phase spot's tie-aware rule, the events equal as
             phase spotter holds them (the mesh path sub-batches streams by
             the plain route's cost budget, as the JAX package does).  (c)
             ``classify_connected`` by the VAD split, by level building
             and under ``Grammar.no_repeat`` on 8 of phase connected's
             recordings: labels equal.  (d) ``GmmHmmRecognizer.fit(mesh=)``
             and ``fit_word(mesh=)`` at phase hmm's configuration: one
             sharded E-step and M-step within ``HMM_STEP_TOL`` of the
             unsharded one, the fits' labels on 256 queries equal, and the
             meshed decode's labels and scores equal.  (e) ``VqRecognizer``
             over the mesh: labels equal; ``shard_streams`` with
             ``process_chunk_batch`` on 64 streams x 10 chunks: flags,
             indices and features equal to the unsharded run's;
             ``multihost.is_primary()`` and ``all_hosts_agree(accuracy)``.
             Kernels 1, 2 and 3's counted launches here join the kernel
             table's.
18. cli    — the command line (ROADMAP items 16a and 20): every subcommand
             through ``dsp_tpu_torch.cli.main`` in this process, in a
             temporary directory, at the default device (the card), with
             launch counts reset just before each card run and read just
             after, and each held against the same arguments under
             ``--device cpu``.  ``make-corpus`` at its defaults (10 digits
             x 5 a split) with ``--spotting 4 --connected 8``; ``enroll``;
             ``evaluate`` (accuracy equal to the CPU's, or apart only by
             near-ties); ``recognize`` on every test file (labels equal
             to the CPU's under phase main's tie-aware rule) and on three;
             ``--dtw-impl fused --band 0`` (kernel 4) against ``--band 0``
             and ``--dtw-impl pallas`` (kernel 5) against the default, by
             the same rule, each launching its kernel under ``evaluate``;
             ``evaluate-connected`` equal to the CPU's; ``spot`` and
             ``evaluate-spot`` with events as the CPU's (labels and spans
             equal, scores 2e-4 relative plus the printed decimals) except
             in streams whose witnesses differ between the devices
             (near-ties); ``serve`` fed a plain, a ``connected``, a
             ``level``, an ``nbest`` and a ``spot`` line, each answer as
             the CPU's (labels equal, numbers within the printed
             decimals); the native batch reader equal to ``read_wav`` on
             every file of the corpus (or, without g++, the Python reader
             alone); and ``utils.profiling.trace`` around one ``evaluate``,
             whose Chrome trace must name the ``dtw_banded`` kernel.
             Prints each subcommand's wall seconds (``StageTimer``: card
             runs, synchronized) with the card's name and power limit;
             kernels 1, 3, 4 and 5's launches here join the kernel table's.

Kernel timings are CUDA-event medians of 5 runs after a warm-up (the
plain versions' first timed run follows their checked one); the main
path's alignments/s is the median of 3 synchronized host-clock passes
after the checked one, and one 256-query chunk is broken into stages
(pad + copy, features, DTW + argmin, copy back).  Each kernel's bound is
the larger of its fp32 operations over 67 TFLOP/s and its bytes (inputs
read once, outputs written once) over 3.35 TB/s, counted from this run's
inputs and only the cells inside their lengths (and band).  The last two
lines of stdout are the kernel table and the run's result, each one JSON
object; the lines before them are ``nvidia-smi``'s
name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS = 5
# (name, DtwConfig overrides, (B, K, T, U)); F = 39 throughout
DTW_CASES = [
    ("default", {}, (256, 100, 198, 198)),
    ("squared", {"squared": True}, (256, 100, 198, 198)),
    ("itakura", {"slope": "itakura"}, (256, 100, 198, 198)),
    ("unbanded", {"band_frac": None}, (256, 100, 198, 198)),
    ("sliding", {"band_frac": 0.1}, (64, 32, 120, 300)),
]
# inputs from a generator of their own, so that every later phase draws
# the inputs it drew before these cases existed: the longest template
# staged whole (one warp a block), the next one frame up in window mode,
# and a long template in window mode
DTW_LONG_CASES = [
    ("staged_edge", {}, (16, 8, 198, 1357)),
    ("window_edge", {}, (16, 8, 198, 1358)),
    ("long", {}, (16, 8, 198, 3000)),
]
GRID_ROWS_CASE = (65_537, 4, 24, 24)     # (B, K, T, U): one query past two launches' rows
# (B, K) of the small-batch phase: single-utterance recognize() against
# command-vocabulary banks, and a few queries at once
SMALL_CASES = [(1, 1), (1, 10), (1, 100), (8, 10)]
MFCC_UTTERANCES = 256      # 256 x 198 = 50,688 frames, one main-path chunk
MFCC_GEMM_N_FFT = 480      # a non-power-of-two n_fft: the kernel's GEMM mode
MFCC_SMALL_N_FFT = (16, 32, 64, 128, 256)   # folded n_fft: both modes against the plain
N_QUERIES = 1024
TEMPLATES_PER_WORD = 10
MAIN_PASSES = 3            # timed classify passes after the checked one
# spotting, against the 10 x 10 digit bank: (name, B, samples per stream,
# streams).  "bench" is bench_all.py's spotting cell (3 connected digits,
# one global VAD window, 598 frames); "long" is 60 s (5,998 frames) of
# random digit sequences, whole-recording features as the spotter takes
# them; "random" is 60 s of standard-normal features
SPOT_CASES = [("bench", 64, 96_000, "connected"), ("long", 4, 960_000, "words"),
              ("random", 4, 960_000, "normal")]
# kernel 3 past the first design's limits, from a generator of their own:
# (name, (B, K, U, T, F))
SPOT_LONG_CASES = [("long_t", (8, 4, 1200, 1100, 39)), ("wide", (8, 4, 1200, 600, 128))]
SPOT_KEYWORDS = ["zero", "one", "two", "three", "four"]
SPOT_TEMPLATES_PER_WORD = 20
SPOT_STREAMS = 64
SPOT_PASSES = 3
MAIN_SHAPE = (256, 100, 198, 198)     # (B, K, T, U) of one main-path chunk
FUSED_CASES = [("default", {}), ("squared", {"squared": True})]   # band_frac=None
# kernel 4 past the first design's limits, from a generator of their own so
# that later phases keep their inputs: (name, (B, K, T, U)), F = 39
FUSED_LONG_CASES = [("long_u", (16, 8, 198, 4000)), ("long_t", (8, 8, 2000, 198))]
BLOCK_WARPS_TIMED = (8, 4)   # kernels 4 and 3: caps on warps a block timed against each other
WAVEFRONT_CASES = [("default", {}), ("unbanded", {"band_frac": None}),
                   ("pure_band", {"max_warp_scale": None})]
WAVEFRONT_BLOCK_WARPS = (4, 8)   # warps a block timed against each other (default case)
CASCADE_SHORTLIST = 8
# (name, DtwConfig overrides, recognizer keywords, the kernel it must launch)
MATCHER_ROUTES = [
    ("default", {}, {}, "dtw_banded"),
    ("unbanded", {"band_frac": None}, {}, "dtw_banded"),
    ("fused", {"impl": "fused", "band_frac": None}, {}, "dtw_fused"),
    ("pallas", {"impl": "pallas"}, {}, "dtw_wavefront"),
    ("cascade", {}, {"matcher": "cascade"}, "dtw_wavefront"),
    ("ltw", {}, {"matcher": "ltw"}, None),
    ("bucketed", {}, {"bucketed": True}, "dtw_banded"),
]
OOV_WORDS = ["papa", "quebec", "victor"]    # tests/test_reject.py:23
OOV_PER_WORD = 32
MATCHER_PASSES = 3
MB_KERNELS = ("dp_diet", "dma_fetch", "anatomy", "trivial", "transpose", "skew")
LAUNCH_PIECE_CALLS = 10_000   # host breakdown of a launch, per piece
LAUNCH_CALLS = 1_000          # back-to-back wrapper calls, then one synchronize
LAUNCH_REPS = 1_001           # timed single calls of the trivial kernel and x * 2.0:
                              # a ~20 µs call is host-bound, so its median needs many
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# phase streaming: 100 ms chunks at 16 kHz, 256 concurrent streams
STREAM_CHUNK = 1600
STREAM_BATCH = 256
STREAM_CHUNKS = 20          # 2 s of each batched stream
STREAM_CHECK_CHUNKS = 10    # of them held against single streams and the CPU
STREAM_REPS = 50            # synchronized single-chunk calls timed
STREAM_RECOGNIZER_WORDS = [["one", "seven", "three"], ["four", "zero", "nine", "two"],
                           ["eight", "five", "six"], ["two", "one", "nine", "four"]]
STREAM_SPOTTER_STREAMS = 4
# phase hmm (BASELINE config 3): default HmmConfig (S = 5, M = 3, 10 EM
# iterations), 10 digits x 10 training utterances, bench_all.py:96's 256
# queries (synth_word(DIGITS[i % 10], 1000 + i)) and OOV_WORDS x 32
HMM_TRAIN_PER_WORD = 10
HMM_QUERIES = 256
HMM_NOISE_SIGMA = 0.05      # tests/test_noise_adapt.py:59's mismatch
# card against CPU on the same features, as max |a - b| / (1 + |b|).  The
# expanded emission's terms are large and cancel for frames far from a
# narrow component, so the two devices' float32 sums part there, and the
# M-step's E[x^2] - mean^2 amplifies it.  Measured by this phase on an
# H100 (700 W): one segmental E-step's statistics 6.8e-4 with equal
# transition counts, whole fits 2.6e-2 (segmental) and 1.5e-1 (Baum-Welch)
HMM_STEP_TOL = 1e-2         # one segmental E-step from the same parameters
HMM_FIT_SPREAD = 0.5        # whole fits: a bound on gross breaks; labels are the check
# phase cascade (ROADMAP item 12b) on phase hmm's model (default HmmConfig,
# 10 digits x HMM_TRAIN_PER_WORD).  HmmSpotter at bench_all.py:244-264's
# spot-hmm cell: 64 streams of 3 connected digits (bench_all.py:170-180),
# zero-padded to 96,000 samples, 598 frames
HMM_SPOT_STREAMS = 64
HMM_SPOT_SAMPLES = 96_000
# card against CPU where the entry witnesses agree: per-frame LLRs, whose
# readout subtracts two float32 UBM prefix sums after features that part by
# ~1e-4.  Measured by this phase on an H100 (700 W): max abs err 2.9e-3
# (8.1e-4 relative at the worst site), no witness flip in 382,720 sites
HMM_SPOT_LLR_TOL = dict(rtol=1e-3, atol=1e-2)
# the LLR floor of the event comparisons (tests/test_spot_hmm.py:223's): at
# the default 0.0 this model's LLRs, which a 3-mixture UBM beats on most
# frames, give one event in 16 streams
HMM_SPOT_THRESHOLD = -30.0
CASCADE_CPU_STREAMS = 8     # of phase spotter's 64 streams, against the CPU cascade:
                            # its plain scan of the rerank windows takes seconds a stream
CASCADE_PASSES = 3
# phase connected (ROADMAP item 13) at bench_all.py:167-214's cells: 64
# recordings of 3 connected digits (synth_connected([DIGITS[(i + j) % 10]
# for j in range(3)], 300 + i)) cut to 96,000 samples (598 frames), the
# main phase's bank (10 digits x 10), max_segments = max_levels = 4
CONN_RECORDINGS = 64
CONN_WORDS = 3
CONN_SAMPLES = 96_000
CONN_MAX_SEGMENTS = 4
CONN_CPU_RECORDINGS = 8     # of them against CPU runs of the port: its DP
                            # loops take seconds a level there
CONN_PASSES = 3
CONN_STREAMS = 4            # gapless recordings through StreamingConnectedRecognizer
CONN_PROFILED_CHUNK = 5     # the chunk of stream 0 run under the profiler (speech)
# level-building planes, card against CPU on the same features: the cost
# GEMM sums in another order on each device
CONN_PLANE_RTOL = 1e-4
REM_PASSES = 3              # phase remainder: timed passes after the checked one
# LPCC features, card against CPU: the MFCC rule; the Levinson-Durbin and
# cepstral recursions amplify rounding (the JAX package holds its LPCC to
# the float64 oracle at 2e-2, tests/test_lpc.py:52), so the value is printed
REM_LPCC_TOL = 1e-3
REM_DBA_TOL = 1e-4          # DBA centers, card against CPU (rtol and atol)
# one Lloyd step's centroids, card against CPU, as max |a - b| / (1 + |b|):
# a centroid sums ~1,000 frames whose c0 reaches tens, so its float32 GEMM
# rounds to ~1e-5 absolute
REM_VQ_STEP_TOL = 1e-5
REM_SCAN_RTOL = 1e-5        # windowed and bidirectional DTW against the scan
MESH_WORDS = [f"w{i:02d}" for i in range(35)]   # config 4: bench_all.py:149-165
MESH_TEMPLATES_PER_WORD = 3
MESH_PASSES = 3             # rounds of timed classify passes: plain, mesh, mesh, plain
MESH_DIST_RTOL = 1e-6       # mesh against no mesh: the same kernels on one rank
MESH_SPOT_STREAMS = 8       # of phase spotter's 64
MESH_CONN_RECORDINGS = 8    # of phase connected's 64
MESH_HMM_QUERIES = 256
MESH_STREAMS = 64
MESH_STREAM_CHUNKS = 10
CLI_SPOTTING = 4            # phase cli: make-corpus --spotting / --connected
CLI_CONNECTED = 8


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int = REPS, warmup: bool = True) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up
    (``warmup=False`` when the caller has just run ``fn``)."""
    from dsp_tpu_torch.utils import timing

    return timing.time_ms(fn, reps, warmup)


def bound(ops: float, n_bytes: float) -> tuple[float, str]:
    """(least ms the card could take, which of the two binds)."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def compare_dtw(got, want, rtol: float, atol: float = 0.0):
    """BIG/finite pattern must match; finite entries allclose at rtol (and
    atol).  Returns (max relative error, max absolute error, finite share)."""
    import numpy as np

    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.shape != want.shape:
        fail(f"dtw shape {got.shape} != {want.shape}")
    if np.isnan(got).any():
        fail("dtw kernel produced NaN")
    dead_g, dead_w = got >= 1e20, want >= 1e20
    if (dead_g != dead_w).any():
        fail(f"dtw BIG/finite pattern differs in {(dead_g != dead_w).sum()} pairs")
    fin = ~dead_w
    if not fin.any():
        return 0.0, 0.0, 0.0
    abs_err = np.abs(got[fin] - want[fin])
    rel = abs_err / np.abs(want[fin])
    if (abs_err > atol + rtol * np.abs(want[fin])).any():
        fail(f"dtw distances differ: max rel err {rel.max():.3e} > {rtol} "
             f"(max abs err {abs_err.max():.3e}, atol {atol})")
    return float(rel.max()), float(abs_err.max()), float(fin.mean())


def dtw_inputs(rng, dev, b: int, k: int, t: int, u: int, f: int = 39):
    """Standard-normal queries [B,T,F] and bank [K,U,F] with seeded lengths
    in [20, T] and [20, U], on the card."""
    import numpy as np
    import torch

    q = torch.from_numpy(rng.standard_normal((b, t, f), np.float32)).to(dev)
    bk = torch.from_numpy(rng.standard_normal((k, u, f), np.float32)).to(dev)
    ql = torch.from_numpy(rng.integers(20, t + 1, b).astype(np.int32)).to(dev)
    bl = torch.from_numpy(rng.integers(20, u + 1, k).astype(np.int32)).to(dev)
    return q, ql, bk, bl


def dtw_phase(rng, long_rng, dev, report):
    import numpy as np
    import torch

    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
    from dsp_tpu_torch.ops import dtw as tdtw

    f = 39
    cases = [(rng, *case) for case in DTW_CASES] + [(long_rng, *c) for c in DTW_LONG_CASES]
    for gen, name, overrides, (b, k, t, u) in cases:
        cfg = DtwConfig(**overrides)
        q, ql, bk, bl = dtw_inputs(gen, dev, b, k, t, u, f)
        got = kdtw.dtw_batch_fused_banded(q, ql, bk, bl, cfg)
        torch.cuda.synchronize()
        want = kdtw.dtw_batch_plain(q, ql, bk, bl, cfg)
        rel, abs_err, fin = compare_dtw(got, want, 1e-4)
        ms = time_ms(lambda: kdtw.dtw_batch_fused_banded(q, ql, bk, bl, cfg))
        plain_ms = time_ms(lambda: kdtw.dtw_batch_plain(q, ql, bk, bl, cfg),
                           warmup=False)
        # cells the DP must visit for these inputs: in length, band, window
        # (masked_cost leaves rows past la valid where there is no band)
        rows = torch.arange(t, device=dev)[None, None, :, None]
        cells = sum(int(((tdtw.masked_cost(q[lo:lo + 32, :, :1] * 0, ql[lo:lo + 32],
                                           bk[:, :, :1] * 0, bl, cfg) < 1e20)
                         & (rows < ql[lo:lo + 32, None, None, None])).sum())
                    for lo in range(0, b, 32))
        # per cell: F squared differences (2F) and the DP's add and two mins
        b_ms, b_by = bound(cells * (2 * f + 3), 4 * ((b * t + k * u) * f + b + k + b * k))
        walked = walked_cells(ql, bl, cfg, t, u) if name == "default" else None
        window, warps, _ = kdtw.launch_plan(b, t, u, f, kdtw._window(cfg, t, u)[2],
                                            cfg.slope == "itakura")
        mode = f"{'window' if window else 'staged'} x{warps}"
        print(f"dtw {name:9s} B={b} K={k} T={t} U={u} ({mode}): finite {fin:.4f}  "
              f"max rel err {rel:.3e}  max abs err {abs_err:.3e}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
              f"bound {b_ms:.4f} ms ({b_by}, {cells} cells)"
              + ("" if walked is None else
                 f"; the kernel computes {walked} costs, {walked / cells:.3f}x those"),
              flush=True)
        report["dtw"][name] = dict(shape=[b, k, t, u, f], mode=mode, finite_share=fin,
                                   max_rel_err=rel, max_abs_err=abs_err,
                                   ms=ms, plain_ms=plain_ms, cells=cells,
                                   walked_cells=walked, bound_ms=b_ms, bound_by=b_by)
    # more queries than one launch's grid rows: sliced launches
    b, k, t, u = GRID_ROWS_CASE
    q = torch.from_numpy(long_rng.standard_normal((b, t, f), np.float32)).to(dev)
    bk = torch.from_numpy(long_rng.standard_normal((k, u, f), np.float32)).to(dev)
    ql = torch.from_numpy(long_rng.integers(1, t + 1, b).astype(np.int32)).to(dev)
    bl = torch.from_numpy(long_rng.integers(1, u + 1, k).astype(np.int32)).to(dev)
    cfg = DtwConfig()
    before = _build.LAUNCHES["dtw_banded"]
    got = kdtw.dtw_batch_fused_banded(q, ql, bk, bl, cfg)
    torch.cuda.synchronize()
    n_launch = _build.LAUNCHES["dtw_banded"] - before
    if n_launch != len(_build.row_slices(b)):
        fail(f"dtw at B={b}: {n_launch} launches, want {len(_build.row_slices(b))}")
    rel, abs_err, fin = compare_dtw(got, kdtw.dtw_batch_plain(q, ql, bk, bl, cfg), 1e-4)
    print(f"dtw grid_rows B={b} K={k} T={t} U={u}: {n_launch} launches  finite {fin:.4f}  "
          f"max rel err {rel:.3e}", flush=True)
    report["dtw"]["grid_rows"] = dict(shape=[b, k, t, u, f], launches=n_launch,
                                      finite_share=fin, max_rel_err=rel, max_abs_err=abs_err)


def walked_cells(q_lens, bank_lens, cfg, t: int, u: int) -> int:
    """Costs the banded DTW kernel computes for these lengths: per strip of
    ``strip_columns``, chunks of 32 steps x 32 lanes, a chunk's last steps
    in whole groups of 8 (``csrc/dtw_banded.cu``)."""
    from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw

    total = 0
    for la in q_lens.tolist():
        for lb in bank_lens.tolist():
            for r0, r1, jlo, jhi in kdtw.strip_columns(la, lb, cfg, t, u):
                steps = (jhi - jlo + 1) + (r1 - r0)
                total += kdtw.STRIP * (steps // 32 * 32 + -(-(steps % 32) // 8) * 8)
    return total


def small_phase(rng, dev, report):
    import numpy as np
    import torch

    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels import _build

    auto, scan = DtwConfig(), DtwConfig(impl="scan")
    t, f = 198, 39
    for b, k in SMALL_CASES:
        q = torch.from_numpy(rng.standard_normal((b, t, f), np.float32)).to(dev)
        bk = torch.from_numpy(rng.standard_normal((k, t, f), np.float32)).to(dev)
        ql = torch.from_numpy(rng.integers(20, t + 1, b).astype(np.int32)).to(dev)
        bl = torch.from_numpy(rng.integers(20, t + 1, k).astype(np.int32)).to(dev)
        before = _build.LAUNCHES["dtw_banded"]
        got = pl.dtw_pairs(q, ql, bk, bl, auto)
        torch.cuda.synchronize()
        if _build.LAUNCHES["dtw_banded"] != before + 1:
            fail(f"dtw_pairs(impl='auto') on B={b}, K={k} launched "
                 f"{_build.LAUNCHES['dtw_banded'] - before} kernels, want 1")
        rel, abs_err, _ = compare_dtw(got, pl.dtw_pairs(q, ql, bk, bl, scan), 1e-4)
        ms = time_ms(lambda: pl.dtw_pairs(q, ql, bk, bl, auto))
        plain_ms = time_ms(lambda: pl.dtw_pairs(q, ql, bk, bl, scan))
        print(f"small B={b:<2d} K={k:<3d}: max rel err {rel:.3e}  auto (kernel) "
              f"{ms:.3f} ms  scan {plain_ms:.3f} ms", flush=True)
        report["small"][f"{b}x{k}"] = dict(max_rel_err=rel, max_abs_err=abs_err,
                                           ms=ms, plain_ms=plain_ms)


def synth_batch(n: int, seed0: int):
    """n synthetic utterances cycling over the digits, with their labels."""
    from dsp_tpu_torch.io import DIGITS, synth_word

    labels = [DIGITS[i % len(DIGITS)] for i in range(n)]
    return [synth_word(lab, seed0 + i) for i, lab in enumerate(labels)], labels


def mfcc_chain_f64(frames, cfg):
    """The kernel's function in float64 on the card: the plain version on
    float64 frames and the float64 constants of ``ops/frontend.py:matrices_np``
    (the DFT as two GEMMs, or at n_fft below the frame length the fold and one
    period's DFT, aliasing samples past n_fft as the TPU kernel does)."""
    import torch

    from dsp_tpu_torch.ops import frontend as fe

    mats = fe.FrontendMatrices(*(torch.from_numpy(m).to(frames.device)
                                 for m in fe.matrices_np(cfg)))
    return fe.mfcc_from_frames(frames.double(), mats, cfg)


def mfcc_ops(cfg, n: int, mode: str) -> float:
    """fp32 operations of the chain on n frames: the DFT as two GEMMs
    (``gemm``), or the FFT mode's window, fold, half-length radix-2 FFT (10
    a butterfly), real split (~20 a bin), power, ranged mel, log, DCT and
    lifter (``fft``)."""
    from dsp_tpu_torch.kernels import mfcc_fused as kmf

    length, bins, m, c = cfg.frame_len, cfg.n_bins, cfg.n_mels, cfg.n_mfcc
    tail = 3 * bins + m + 2 * m * c + c
    if mode == "gemm":
        return n * (length + 4 * length * bins + 2 * bins * m + tail)
    half = cfg.n_fft // 2
    fft = 10 * (half // 2) * (half.bit_length() - 1) + 20 * bins
    return n * (2 * length + fft + 2 * kmf.mel_nnz(cfg) + tail)


def mfcc_phase(dev, report):
    import numpy as np
    import torch

    from dsp_tpu_torch.config import FrontendConfig
    from dsp_tpu_torch.io import synth_word
    from dsp_tpu_torch.kernels import mfcc_fused as kmf
    from dsp_tpu_torch.ops import frontend as fe

    sigs, _ = synth_batch(MFCC_UTTERANCES, 5000)
    x = torch.from_numpy(np.stack(sigs)).to(dev)
    cases = [("default", FrontendConfig()),
             ("use_energy", FrontendConfig(use_energy=True)),
             (f"gemm_n_fft_{MFCC_GEMM_N_FFT}", FrontendConfig(n_fft=MFCC_GEMM_N_FFT)),
             ("fold_n_fft_64", FrontendConfig(n_fft=64))]
    for key, cfg in cases:
        plan = kmf.launch_plan(cfg)
        frames = fe.frame(fe.preemphasis(x, cfg.preemphasis), cfg.frame_len,
                          cfg.hop_len).reshape(-1, cfg.frame_len).contiguous()
        got = kmf.mfcc_frames_fused(frames, cfg)
        torch.cuda.synchronize()
        want = kmf.mfcc_frames_plain(frames, cfg)
        if got.shape != want.shape or got.shape != (len(sigs) * 198, cfg.n_mfcc):
            fail(f"mfcc shape {tuple(got.shape)} vs {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail("mfcc kernel produced non-finite values")
        err = (got - want).abs().max().item()
        exact = mfcc_chain_f64(frames, cfg)
        err64 = (got.double() - exact).abs().max().item()
        plain_err64 = (want.double() - exact).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-3, atol=1e-3):
            fail(f"mfcc {key} ({plan.mode} mode) differs: max abs err {err:.3e}")
        if err64 > 2 * plain_err64:
            fail(f"mfcc {key} ({plan.mode} mode): max error to float64 {err64:.3e} "
                 f"over twice the plain version's {plain_err64:.3e}")
        ms = time_ms(lambda: kmf.mfcc_frames_fused(frames, cfg))
        plain_ms = time_ms(lambda: kmf.mfcc_frames_plain(frames, cfg), warmup=False)
        n = frames.shape[0]
        n_bytes = 4 * n * (cfg.frame_len + cfg.n_mfcc)
        gemm_ms, gemm_by = bound(mfcc_ops(cfg, n, "gemm"), n_bytes)
        fft_ms, fft_by = bound(mfcc_ops(cfg, n, "fft"), n_bytes)
        b_ms, b_by = (fft_ms, fft_by) if plan.mode == "fft" else (gemm_ms, gemm_by)
        entry = dict(n_frames=n, n_fft=cfg.n_fft, mode=plan.mode, warps=plan.warps,
                     frames_per_warp=plan.frames_per_warp, smem_bytes=plan.smem_bytes,
                     max_abs_err=err, max_abs_err_f64=err64,
                     plain_max_abs_err_f64=plain_err64, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, gemm_form_bound_ms=gemm_ms,
                     gemm_form_bound_by=gemm_by, fft_bound_ms=fft_ms, fft_bound_by=fft_by)
        line = (f"mfcc {key:16s} N={n} n_fft={cfg.n_fft} ({plan.mode} mode, {plan.warps} "
                f"warps x {plan.frames_per_warp} frames, {plan.smem_bytes} B): max abs err "
                f"{err:.3e} (to float64: kernel {err64:.3e}, plain {plain_err64:.3e})  "
                f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by}; "
                f"FFT form {fft_ms:.4f} {fft_by}, GEMM form {gemm_ms:.4f} {gemm_by})")
        if plan.mode == "fft" and not cfg.use_energy:
            # a yardstick of the spectrum part only, never called by the port
            win = fe.make_matrices(cfg, dev).window
            spec = lambda: torch.fft.rfft(frames * win, n=cfg.n_fft).abs().square() / cfg.n_fft
            ref = fe.power_spectrum_dft(frames * win, fe.make_matrices(cfg, dev), cfg.n_fft)
            spec_err = ((spec() - ref).abs().max() / ref.abs().max()).item()
            entry["spectrum_yardstick_ms"] = time_ms(spec)
            entry["spectrum_yardstick_rel_err"] = spec_err
            line += (f"; yardstick of the spectrum part only, torch.fft.rfft(frames * "
                     f"window, n={cfg.n_fft}) with the power: "
                     f"{entry['spectrum_yardstick_ms']:.3f} ms")
        print(line, flush=True)
        report["mfcc"][key] = entry
    if report["mfcc"]["default"]["mode"] != "fft" or report["mfcc"][cases[2][0]]["mode"] != "gemm":
        fail("mfcc: the plan did not take the FFT mode at n_fft=512 and the GEMM "
             f"mode at n_fft={MFCC_GEMM_N_FFT}")
    # both modes against the plain version at n_fft below the frame length,
    # where each point sums frame_len / n_fft folded samples (the float64
    # folded path): on this chunk's frames and on the card test's
    # (tests/test_torch_cuda.py:_speech_frames)
    eight = torch.from_numpy(np.stack([synth_word("eight", s, max_samples=9000)
                                       for s in range(3)])).to(dev)
    report["mfcc"]["small_n_fft"] = sweep = {}
    for n_fft in MFCC_SMALL_N_FFT:
        cfg = FrontendConfig(n_fft=n_fft)
        for inputs, sigs_x in (("chunk", x), ("eight", eight)):
            frames = fe.frame(fe.preemphasis(sigs_x, cfg.preemphasis), cfg.frame_len,
                              cfg.hop_len).reshape(-1, cfg.frame_len).contiguous()
            want = kmf.mfcc_frames_plain(frames, cfg)
            exact = mfcc_chain_f64(frames, cfg)
            plain_err64 = (want.double() - exact).abs().max().item()
            for mode, plan in (("fft", kmf.fft_plan(cfg)), ("gemm", kmf.gemm_plan(cfg))):
                got = kmf.mfcc_frames_fused(frames, cfg, plan=plan)
                torch.cuda.synchronize()
                off = int((~torch.isclose(got, want, rtol=1e-3, atol=1e-3)).sum())
                err = (got - want).abs().max().item()
                err64 = (got.double() - exact).abs().max().item()
                sweep[f"{n_fft}_{inputs}_{mode}"] = dict(
                    n_fft=n_fft, inputs=inputs, mode=mode, past_1e3=off,
                    n_values=got.numel(), max_abs_err=err, max_abs_err_f64=err64,
                    plain_max_abs_err_f64=plain_err64)
                print(f"mfcc n_fft={n_fft:<4d} {inputs:5s} {mode:4s} mode: {off} of "
                      f"{got.numel()} values past rtol/atol 1e-3 of the plain version "
                      f"(max abs err {err:.3e}); to float64: kernel {err64:.3e}, plain "
                      f"{plain_err64:.3e}", flush=True)
                if off or max(err64, plain_err64) > 1e-3:
                    fail(f"mfcc n_fft={n_fft} {inputs} {mode} mode: {off} values past "
                         f"1e-3 of the plain version; to float64 {err64:.3e} (plain "
                         f"{plain_err64:.3e})")


def stage_ms(rec, signals, reps: int = 3) -> dict:
    """Host-clock ms of each stage of one classify chunk, each stage ended by
    a synchronize (median of ``reps``): pad + copy to the card, features
    (VAD + MFCC + deltas), DTW + argmin, labels back to the host."""
    import torch

    from dsp_tpu_torch import pipeline as pl

    bank, ids = rec.device_bank()
    times = {"pad_h2d": [], "features": [], "dtw_argmin": [], "d2h": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        x, n = pl.pad_signals(signals, rec.cfg.max_samples, rec.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        feats = pl.extract_features(x, n, rec.cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        label_ids, _ = pl.classify_features(feats, bank, ids, cfg=rec.cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        label_ids.cpu()
        t4 = time.perf_counter()
        for key, a, b in (("pad_h2d", t0, t1), ("features", t1, t2),
                          ("dtw_argmin", t2, t3), ("d2h", t3, t4)):
            times[key].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def device_events(fn):
    """The device-side rows (kernels and copies) of ``torch.profiler``'s
    ``key_averages()`` over one call of ``fn``, with each row's device µs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    # the kernels themselves: an aten op's row repeats its kernels' time
    return [(e, dev_us(e)) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]


def features_device_ms(rec, signals, top: int = 3):
    """Device time of one ``extract_features`` call on a chunk already on
    the card: the sum of its kernels' self times under ``torch.profiler``
    (None where the profiler records no device time), and the ``top``
    kernels by time."""
    from dsp_tpu_torch import pipeline as pl

    x, n = pl.pad_signals(signals, rec.cfg.max_samples, rec.device)
    pl.extract_features(x, n, rec.cfg)
    events = device_events(lambda: pl.extract_features(x, n, rec.cfg))
    total = sum(us for _, us in events)
    ranked = sorted(events, key=lambda ev: ev[1], reverse=True)[:top]
    return (total / 1e3 if total > 0 else None,
            [(e.key[:60], us / 1e3, e.count) for e, us in ranked])


def main_phase(dev, report):
    import numpy as np
    import torch

    from dsp_tpu_torch import KnnDtwRecognizer
    from dsp_tpu_torch.config import DtwConfig, FrontendConfig, PipelineConfig
    from dsp_tpu_torch.io import DIGITS, synth_word
    from dsp_tpu_torch.kernels import _build

    base = PipelineConfig()
    configs = {
        "plain": dataclasses.replace(base, dtw=DtwConfig(impl="scan")),
        "default": base,
        "fused": dataclasses.replace(base, frontend=FrontendConfig(impl="pallas")),
    }
    bank_sigs = {lab: [synth_word(lab, i) for i in range(TEMPLATES_PER_WORD)]
                 for lab in DIGITS}
    queries, truth = synth_batch(N_QUERIES, 1000)
    out = {}
    for name, cfg in configs.items():
        rec = KnnDtwRecognizer(cfg, device=dev)
        for lab in DIGITS:
            rec.enroll(lab, bank_sigs[lab])
        torch.cuda.synchronize()
        _build.reset_launches()
        labels, dists = rec.classify_batch(queries, return_distances=True, chunk=256)
        torch.cuda.synchronize()
        launches = {k: _build.LAUNCHES[k] for k in ("dtw_banded", "mfcc_fused")}
        passes = []
        for _ in range(MAIN_PASSES):
            t0 = time.perf_counter()
            rec.classify_batch(queries, chunk=256)
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
        seconds = statistics.median(passes)
        _build.reset_launches()
        single = rec.recognize(queries[0])
        n_dtw = _build.LAUNCHES["dtw_banded"]
        if single != labels[0] or n_dtw != int(name != "plain"):
            fail(f"main path {name!r}: recognize() gave {single!r} with "
                 f"{n_dtw} DTW launches; the batch gave {labels[0]!r}")
        acc = float(np.mean([a == b for a, b in zip(labels, truth)]))
        rate = len(queries) * rec.n_templates / seconds
        stages = stage_ms(rec, queries[:256])
        feat_dev, feat_top = features_device_ms(rec, queries[:256])
        print(f"main {name:7s}: launches {launches}  accuracy {acc:.4f}  "
              f"{rate:.1f} alignments/s (median {seconds:.4f} s of {MAIN_PASSES} "
              f"passes for {len(queries)} x {rec.n_templates}); one 256-chunk, ms: "
              + "  ".join(f"{k} {v:.2f}" for k, v in stages.items())
              + "; features on the device (profiler, kernels' sum): "
              + ("not measured (no device time recorded)" if feat_dev is None else
                 f"{feat_dev:.3f} ms, most in "
                 + ", ".join(f"{k} {t:.3f} ms x{c}" for k, t, c in feat_top)),
              flush=True)
        out[name] = dict(labels=labels, dists=dists, launches=launches)
        report["main"][name] = dict(launches=launches, accuracy=acc,
                                    seconds=seconds, pass_seconds=passes,
                                    alignments_per_s=rate, chunk_stage_ms=stages,
                                    features_device_ms=feat_dev,
                                    features_top_kernels=feat_top)

    want = {"plain": (0, 0), "default": (1, 0), "fused": (1, 1)}
    for name, (need_dtw, need_mfcc) in want.items():
        got = out[name]["launches"]
        if bool(got["dtw_banded"]) != bool(need_dtw) or bool(got["mfcc_fused"]) != bool(need_mfcc):
            fail(f"main path {name!r} launched {got}; expected dtw>0={bool(need_dtw)}, "
                 f"mfcc>0={bool(need_mfcc)}")
    plain_d = out["plain"]["dists"]
    top2 = np.sort(plain_d, axis=1)[:, :2]
    near_tie = np.abs(top2[:, 1] - top2[:, 0]) <= 1e-4 * np.abs(top2[:, 0])
    for name in ("default", "fused"):
        diff = np.array([a != b for a, b in zip(out[name]["labels"], out["plain"]["labels"])])
        if (diff & ~near_tie).any():
            fail(f"main path {name!r}: {int((diff & ~near_tie).sum())} labels differ "
                 "from the plain path outside near-ties")
        report["main"][name]["label_mismatches_at_near_ties"] = int(diff.sum())
        if report["main"][name]["accuracy"] < 0.9:
            fail(f"main path {name!r}: accuracy {report['main'][name]['accuracy']}")
    # same features (both use the plain front-end): the kernel's distances
    # must match the plain DTW's
    rel, abs_err, _ = compare_dtw(torch.from_numpy(out["default"]["dists"]),
                                  torch.from_numpy(plain_d), 1e-4)
    report["main"]["default_vs_plain_dists"] = dict(max_rel_err=rel,
                                                    max_abs_err=abs_err)
    return out["fused"]["launches"]


def compare_spot(got, want, s_lens, b_lens, what: str, rtol: float = 2e-4) -> dict:
    """Tie-aware comparison of two (norm [B,K,U], start [B,K,U]) fields
    (numpy): identical BIG pattern; norms at ``rtol`` where the witnesses
    agree; raw costs at 1e-4 where they differ, at under 0.1% of the valid
    (stream, template, end column) sites."""
    import numpy as np

    (gn, gs), (wn, ws) = got, want
    if gn.shape != wn.shape or gs.shape != ws.shape:
        fail(f"{what}: shapes {gn.shape} vs {wn.shape}")
    if np.isnan(gn).any():
        fail(f"{what}: NaN in the kernel's norms")
    if ((gn >= 1e20) != (wn >= 1e20)).any():
        fail(f"{what}: BIG/finite pattern differs at {((gn >= 1e20) != (wn >= 1e20)).sum()} sites")
    j = np.arange(gn.shape[-1])[None, None, :]
    valid = np.broadcast_to(j < np.asarray(s_lens)[:, None, None], gn.shape)
    agree, flip = valid & (gs == ws), valid & (gs != ws)
    abs_err = np.abs(gn - wn)[agree]
    rel = abs_err / np.maximum(np.abs(wn[agree]), 1e-30)
    if ((abs_err > rtol * np.abs(wn[agree]) + 1e-5)).any():
        fail(f"{what}: norms differ where the witnesses agree: max rel err {rel.max():.3e}")
    tl = np.maximum(np.asarray(b_lens), 1).astype(np.float64)[None, :, None]
    raw_g, raw_w = gn * (tl + j - gs + 1), wn * (tl + j - ws + 1)
    raw_rel = np.abs(raw_g - raw_w)[flip] / np.abs(raw_w[flip])
    if (raw_rel > 1e-4).any():
        fail(f"{what}: witnesses differ at {int(flip.sum())} sites, raw costs "
             f"up to {raw_rel.max():.3e} apart (not near-ties)")
    share = float(flip.sum() / max(1, valid.sum()))
    if share >= 1e-3:
        fail(f"{what}: witnesses differ at {share:.2e} of valid sites (>= 0.1%)")
    return dict(n_sites=int(valid.sum()), max_abs_err=float(abs_err.max()) if abs_err.size else 0.0,
                max_rel_err=float(rel.max()) if rel.size else 0.0,
                witness_flips=int(flip.sum()), flip_share=share,
                max_raw_rel_at_flips=float(raw_rel.max()) if raw_rel.size else 0.0)


def spot_phase(rng, long_rng, dev, report):
    import numpy as np
    import torch

    from dsp_tpu_torch import KnnDtwRecognizer
    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.config import PipelineConfig
    from dsp_tpu_torch.io import DIGITS, synth_connected, synth_spotting_stream, synth_word
    from dsp_tpu_torch.kernels import spot_fused as ksp

    cfg = PipelineConfig()
    rec = KnnDtwRecognizer(cfg, device=dev)
    for lab in DIGITS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(TEMPLATES_PER_WORD)])
    bank, _ = rec.device_bank()
    k, t, f = bank.feats.shape
    tl = bank.length.cpu().numpy()
    for name, b, n_samples, kind in SPOT_CASES:
        u = 1 + (n_samples - cfg.frontend.frame_len) // cfg.frontend.hop_len
        if kind == "normal":
            streams = torch.from_numpy(rng.standard_normal((b, u, f), np.float32)).to(dev)
            s_lens = torch.full((b,), u, dtype=torch.int32, device=dev)
        else:
            if kind == "connected":
                sigs = [synth_connected([DIGITS[(i + w) % 10] for w in range(3)], 300 + i)
                        for i in range(b)]
            else:
                sigs = [synth_spotting_stream(DIGITS[:5], DIGITS, 7000 + i, n_words=100)[0]
                        for i in range(b)]
            x, n = pl.pad_signals(sigs, n_samples, dev)
            fcfg = dataclasses.replace(cfg, use_vad=kind == "connected")
            feats = pl.extract_recording_features(x, n, fcfg, u)
            streams, s_lens = feats.feats, feats.length
        sl = s_lens.cpu().numpy()
        cells = int(np.sum(np.minimum(np.maximum(sl, 1), u)[:, None]
                           * np.maximum(tl, 1)[None, :]))
        for squared in (False, True):
            args = (streams, s_lens, bank.feats, bank.length)
            got = ksp.subseq_dtw_fused(*args, squared=squared)
            torch.cuda.synchronize()
            want = ksp.subseq_dtw_batch_plain(*args, squared=squared)
            key = f"{name}{'_squared' if squared else ''}"
            cmp = compare_spot([x.cpu().numpy() for x in got],
                               [x.cpu().numpy() for x in want], sl, tl, f"spot {key}")
            plain_ms = time_ms(lambda: ksp.subseq_dtw_batch_plain(*args, squared=squared),
                               warmup=False)
            ms = time_ms(lambda: ksp.subseq_dtw_fused(*args, squared=squared))
            # per cell: a F-long dot product (2F) and the DP's adds and min
            b_ms, b_by = bound(cells * (2 * f + 3),
                               4 * ((b * u + k * t) * f + b + k) + 8 * b * k * u)
            computed, lane_steps = walk_counts(ksp.strips, ksp.cost_cells, s_lens.cpu(),
                                               bank.length.cpu(), u, t)
            window, warps, w_pair, _ = ksp.launch_plan(b, k, u, t, f)
            print(f"spot {key:14s} B={b} K={k} T={t} U={u} ({warps} warps a block, {w_pair} "
                  f"a stream): flips "
                  f"{cmp['witness_flips']} ({cmp['flip_share']:.2e})  max abs err "
                  f"{cmp['max_abs_err']:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
                  f"bound {b_ms:.4f} ms ({b_by}, {cells} cells); the kernel computes "
                  f"{computed} costs ({computed / cells:.3f}x) over {lane_steps} "
                  f"lane-steps ({lane_steps / cells:.3f}x)", flush=True)
            report["spot"][key] = dict(shape=[b, k, t, u, f], cells=cells, ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms,
                                       bound_by=b_by, computed_costs=computed,
                                       lane_steps=lane_steps, **cmp)
            if key == "bench":
                report["spot"]["block_warps"] = block_warps(
                    ksp, lambda: ksp.subseq_dtw_fused(*args),
                    lambda: ksp.launch_plan(b, k, u, t, f)[1], t, f)
    # long templates at F = 39 (staged) and F = 128 (window mode), each
    # refused by the first design, on standard-normal features
    for name, (b, k, u, t, f) in SPOT_LONG_CASES:
        streams = torch.from_numpy(long_rng.standard_normal((b, u, f), np.float32)).to(dev)
        lbank = torch.from_numpy(long_rng.standard_normal((k, t, f), np.float32)).to(dev)
        s_lens = torch.from_numpy(long_rng.integers(u // 2, u + 1, b).astype(np.int32)).to(dev)
        b_lens = torch.from_numpy(long_rng.integers(t // 2, t + 1, k).astype(np.int32)).to(dev)
        args = (streams, s_lens, lbank, b_lens)
        got = ksp.subseq_dtw_fused(*args)
        torch.cuda.synchronize()
        sl, bl = s_lens.cpu().numpy(), b_lens.cpu().numpy()
        cmp = compare_spot([x.cpu().numpy() for x in got],
                           [x.cpu().numpy() for x in ksp.subseq_dtw_batch_plain(*args)],
                           sl, bl, f"spot {name}")
        ms = time_ms(lambda: ksp.subseq_dtw_fused(*args))
        plain_ms = time_ms(lambda: ksp.subseq_dtw_batch_plain(*args))
        cells = int(np.sum(sl.astype(np.int64)[:, None] * bl[None, :]))
        b_ms, b_by = bound(cells * (2 * f + 3),
                           4 * ((b * u + k * t) * f + b + k) + 8 * b * k * u)
        window, warps, w_pair, _ = ksp.launch_plan(b, k, u, t, f)
        mode = f"{'window' if window else 'staged'} x{warps}, {w_pair} a stream"
        print(f"spot {name:14s} B={b} K={k} T={t} U={u} F={f} ({mode}): flips "
              f"{cmp['witness_flips']} ({cmp['flip_share']:.2e})  max abs err "
              f"{cmp['max_abs_err']:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
              f"bound {b_ms:.4f} ms ({b_by}, {cells} cells)", flush=True)
        report["spot"][name] = dict(shape=[b, k, t, u, f], mode=mode, cells=cells, ms=ms,
                                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **cmp)


def spot_stage_ms(spotter, signals, reps: int = 3) -> dict:
    """Host-clock ms of the stages of one ``spot`` pass over ``signals``,
    summed over the padded-length groups, each stage ended by a synchronize
    (median of ``reps``): pad + copy to the card, whole-recording features,
    the spotting kernel, the score fields back to the host, and event
    extraction on the host.  Each group is one kernel call, as ``scores``
    makes it while the group's [B, K, U] outputs fit its budget."""
    import torch

    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.ops import spot as sp

    rec, cfg = spotter.rec, spotter.cfg
    f = cfg.frontend
    bank, ids = rec.device_bank()
    ids = ids.cpu().numpy()
    times = {k: [] for k in ("pad_h2d", "features", "spot", "d2h", "events")}
    for _ in range(reps):
        acc = dict.fromkeys(times, 0.0)
        for pad_len, idxs in pl.group_by_padded_len(signals, cfg.max_samples).items():
            t_max = max(1, 1 + (pad_len - f.frame_len) // f.hop_len)
            t0 = time.perf_counter()
            x, n = pl.pad_signals([signals[i] for i in idxs], pad_len, rec.device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            feats = pl.extract_recording_features(x, n, cfg, t_max)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            norm, start = sp.subseq_dtw_batch(feats.feats, feats.length, bank.feats,
                                              bank.length, squared=cfg.dtw.squared)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            norm, start = norm.cpu().numpy(), start.cpu().numpy()
            lens = feats.length.cpu().numpy()
            t4 = time.perf_counter()
            for row, t_i in enumerate(lens):
                sp.extract_events(norm[row, :, :t_i], start[row, :, :t_i],
                                  spotter.threshold, labels=ids)
            t5 = time.perf_counter()
            for key, a, b in (("pad_h2d", t0, t1), ("features", t1, t2), ("spot", t2, t3),
                              ("d2h", t3, t4), ("events", t4, t5)):
                acc[key] += (b - a) * 1e3
        for key, v in acc.items():
            times[key].append(v)
    return {k: statistics.median(v) for k, v in times.items()}


def spotter_phase(seed: int, dev, report) -> int:
    """The spotting main path; returns the kernel's launch count."""
    import numpy as np
    import torch

    from dsp_tpu_torch import KeywordSpotter, KnnDtwRecognizer
    from dsp_tpu_torch.io import DIGITS, synth_spotting_stream, synth_word
    from dsp_tpu_torch.kernels import _build

    rec = KnnDtwRecognizer(device=dev)
    for lab in SPOT_KEYWORDS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(SPOT_TEMPLATES_PER_WORD)])
    streams = [synth_spotting_stream(SPOT_KEYWORDS, DIGITS, seed * 1000 + i, n_words=8)
               for i in range(SPOT_STREAMS)]
    sigs = [sig for sig, _ in streams]
    rec.device_bank()
    torch.cuda.synchronize()

    _build.reset_launches()
    rec.spot_threshold = KeywordSpotter(rec).calibrate_threshold()
    spotter = KeywordSpotter(rec)
    events = spotter.spot(sigs)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["spot_subseq"]
    if launches == 0:
        fail("the spotting path never launched the subsequence-DTW kernel")

    plain = KeywordSpotter(rec, impl="scan")
    thr_plain = plain.calibrate_threshold()
    if abs(thr_plain - spotter.threshold) > 1e-4 * abs(thr_plain):
        fail(f"calibrate_threshold {spotter.threshold} vs plain {thr_plain}")
    fields, plain_fields = spotter.scores(sigs), plain.scores(sigs)
    _, tl = rec.device_bank()[0]
    tl = tl.cpu().numpy()
    flips = sites = 0
    for i, (got, want) in enumerate(zip(fields, plain_fields)):
        cmp = compare_spot([x[None] for x in got], [x[None] for x in want],
                           [got[0].shape[1]], tl, f"spotter stream {i}")
        flips += cmp["witness_flips"]
        sites += cmp["n_sites"]
    plain_events = plain.spot(sigs, threshold=spotter.threshold)
    def same_events(a, b):
        return ([ev[:3] for ev in a] == [ev[:3] for ev in b]
                and all(abs(x[3] - y[3]) <= 2e-4 * abs(y[3]) + 1e-5 for x, y in zip(a, b)))

    differ = [i for i, (a, b) in enumerate(zip(events, plain_events))
              if not same_events(a, b)]
    unexplained = [i for i in differ
                   if (fields[i][1] == plain_fields[i][1]).all()]
    if unexplained:
        fail(f"spotter events differ from the plain route's in streams "
             f"{unexplained} with no witness near-tie")

    hop = rec.cfg.frontend.hop_len
    n_truth = hits = false_alarms = 0
    for evs, (_, truth) in zip(events, streams):
        spans = [(lab, s // hop, e // hop) for lab, s, e in truth]
        n_truth += len(spans)
        hits += sum(any(ev[0] == lab and s <= (ev[1] + ev[2]) / 2 <= e for ev in evs)
                    for lab, s, e in spans)
        false_alarms += sum(not any(ev[0] == lab and s <= (ev[1] + ev[2]) / 2 <= e
                                    for lab, s, e in spans) for ev in evs)
    if n_truth == 0 or hits == 0:
        fail(f"the spotter found {hits} of {n_truth} keywords")

    passes = []
    for _ in range(SPOT_PASSES):
        t0 = time.perf_counter()
        spotter.scores(sigs)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    seconds = statistics.median(passes)
    audio_s = sum(len(s) for s in sigs) / rec.cfg.frontend.sample_rate
    rate = audio_s / seconds
    stages = spot_stage_ms(spotter, sigs)
    print(f"spotter: K={rec.n_templates} streams={len(sigs)} ({audio_s:.1f} s audio) "
          f"threshold {spotter.threshold:.4f}  launches {launches}  keyword hits "
          f"{hits}/{n_truth} ({hits / n_truth:.4f})  false alarms {false_alarms}  "
          f"witness flips vs plain {flips} of {sites}  streams with other events "
          f"{len(differ)}", flush=True)
    print(f"spotting_audio_seconds_per_sec {rate:.1f} on {'; '.join(report['nvidia_smi'])} "
          f"(median {seconds:.4f} s of {SPOT_PASSES} scores passes); one spot pass, ms: "
          + "  ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    report["spotter"] = dict(
        n_templates=rec.n_templates, n_streams=len(sigs), audio_seconds=audio_s,
        threshold=spotter.threshold, launches=launches, keyword_hits=hits,
        keywords=n_truth, hit_rate=hits / n_truth, false_alarms=false_alarms,
        witness_flips_vs_plain=flips, witness_sites=sites,
        streams_with_other_events=len(differ),
        pass_seconds=passes, spotting_audio_seconds_per_sec=rate, stage_ms=stages,
        events=[[list(ev) for ev in evs] for evs in events])
    return launches


def device_ops(fn):
    """(device ops, device ms) of one call of ``fn``: the count of its
    kernels and copies on the card and the sum of their times (None, None
    where the profiler records no device time)."""
    events = device_events(fn)
    if not events:
        return None, None
    return sum(e.count for e, _ in events), sum(us for _, us in events) / 1e3


def ms_text(ms) -> str:
    return "not measured (no device time recorded)" if ms is None else f"{ms:.3f} ms"


def synced_ms(fn, reps: int) -> list:
    """Host-clock ms of ``reps`` calls of ``fn``, each ended by a synchronize."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def no_host_sync(what: str, fn):
    """Run ``fn`` with PyTorch's sync debug mode set to raise on any call
    that waits for the card (a read-back, a blocking copy)."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        fail(f"{what} synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def compare_chunks(got, want, what: str) -> float:
    """ChunkOutputs [S, ...] of two runs: MFCC rtol/atol 1e-3 (the DFT
    GEMMs of two devices or two batch shapes sum in other orders, and the
    quietest log-mel bands amplify it: 2.9e-4 abs measured card against
    CPU; JAX's own bound for GEMM-shape differences,
    tests/test_streaming.py:48), energy rtol 1e-4, every other field
    equal; returns the MFCC's max abs error."""
    import torch

    from dsp_tpu_torch.ops import streaming as st

    for name, g, w in zip(st.ChunkOutput._fields, got, want):
        g = g.to(w.device)
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{what}: {name} {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if name == "mfcc":
            if not torch.allclose(g, w, rtol=1e-3, atol=1e-3):
                fail(f"{what}: MFCC differ past rtol/atol 1e-3: max abs err "
                     f"{(g - w).abs().max().item():.3e}")
        elif name == "energy":
            if not torch.allclose(g, w, rtol=1e-4, atol=0.0):
                fail(f"{what}: energies differ past rtol 1e-4")
        elif not torch.equal(g, w):
            fail(f"{what}: {name} differ at {int((g != w).sum())} of {g.numel()}")
    return (got.mfcc.to(want.mfcc.device) - want.mfcc).abs().max().item()


def feed_stream(stream, sig, chunk: int, tail: bool = False):
    """Feed ``sig`` 100 ms at a time; (events, ms of each feed call, whether
    each call returned an event).  ``tail``: the spotter's short last chunk
    goes to ``flush``; else the signal's last partial chunk is dropped."""
    import torch

    n_full = len(sig) // chunk * chunk
    events, ms, hit = [], [], []
    for lo in range(0, n_full, chunk):
        t0 = time.perf_counter()
        got = stream.feed(sig[lo:lo + chunk])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        hit.append(bool(got))
        events += got
    events += stream.flush(sig[n_full:]) if tail else stream.flush()
    return events, ms, hit


def separation_threshold(norm, start, row_labels, truth) -> float:
    """Midpoint of a stream's best score inside a keyword and its best score
    elsewhere (tests/test_spotter.py:_separation): a candidate (template,
    end frame) hits when its span covers half of a planted keyword of its
    label.  ``truth``: (label, start frame, end frame)."""
    import numpy as np

    k, t = norm.shape
    cols = np.arange(t)
    hit = np.zeros((k, t), bool)
    for lab, s, e in truth:
        cover = (np.minimum(cols[None, :], e) - np.maximum(start, s) + 1) >= 0.5 * (e - s)
        hit |= cover & (row_labels == lab)[:, None]
    if not hit.any() or hit.all():
        fail(f"separation threshold: {int(hit.sum())} of {hit.size} candidates hit a keyword")
    return float((norm[hit].min() + norm[~hit].min()) / 2.0)


def same_spots(got, want) -> bool:
    """JAX's streaming-against-offline rule (tests/test_spotter.py:128-144):
    labels equal, spans within 2 frames, scores rtol 1e-3 / atol 1e-5."""
    return [ev[0] for ev in got] == [ev[0] for ev in want] and all(
        abs(g[1] - w[1]) <= 2 and abs(g[2] - w[2]) <= 2
        and abs(g[3] - w[3]) <= 1e-3 * abs(w[3]) + 1e-5 for g, w in zip(got, want))


def streaming_phase(seed: int, dev, report) -> dict:
    """The online path (BASELINE config 2) at full width; returns the
    launch counts of its recognizer and spotter runs."""
    import numpy as np
    import torch

    from dsp_tpu_torch import KeywordSpotter, KnnDtwRecognizer, StreamingRecognizer
    from dsp_tpu_torch.config import PipelineConfig
    from dsp_tpu_torch.io import DIGITS, synth_connected, synth_spotting_stream, synth_word
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.models import StreamingSpotter
    from dsp_tpu_torch.ops import frontend as fe
    from dsp_tpu_torch.ops import spot as sp
    from dsp_tpu_torch.ops import streaming as st

    cpu = torch.device("cpu")
    cfg = PipelineConfig()
    fcfg, vcfg = cfg.frontend, cfg.vad
    mats, mats_cpu = fe.make_matrices(fcfg, dev), fe.make_matrices(fcfg, cpu)
    smi = "; ".join(report["nvidia_smi"])
    out = report["streaming"]

    # 1. one stream: bench_all.py's input, one chunk from the initial state
    state0 = st.init_state(fcfg, STREAM_CHUNK, dev)
    chunk = torch.from_numpy(synth_word("five", 7)[:STREAM_CHUNK]).to(dev)
    step = lambda: st.process_chunk(state0, chunk, mats, fcfg, vcfg, STREAM_CHUNK)  # noqa: E731
    no_host_sync("process_chunk", step)
    ms = statistics.median(synced_ms(step, STREAM_REPS))
    ops, dev_ms = device_ops(step)
    print(f"streaming one stream: process_chunk {ms:.3f} ms a 100 ms chunk (median of "
          f"{STREAM_REPS} synchronized calls), streaming_realtime_factor {100.0 / ms:.1f}; "
          f"{ops} device ops a chunk, device time {ms_text(dev_ms)}, on {smi}", flush=True)
    out["one_stream"] = dict(ms=ms, realtime_factor=100.0 / ms, device_ops=ops,
                             device_ms=dev_ms)

    # 2. 256 concurrent streams, one per digit utterance of 2 s
    sigs = np.stack([synth_word(DIGITS[i % 10], 3000 + i)[: STREAM_CHUNK * STREAM_CHUNKS]
                     for i in range(STREAM_BATCH)])
    chunks = torch.from_numpy(sigs).to(dev)
    bstate = st.init_state_batch(STREAM_BATCH, fcfg, STREAM_CHUNK, dev)
    no_host_sync("process_chunk_batch", lambda: st.process_chunk_batch(
        bstate, chunks[:, :STREAM_CHUNK].contiguous(), mats, fcfg, vcfg, STREAM_CHUNK))
    bouts, step_ms = [], []
    for c in range(STREAM_CHUNKS):
        part = chunks[:, c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK].contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bstate, bout = st.process_chunk_batch(bstate, part, mats, fcfg, vcfg, STREAM_CHUNK)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bouts.append(bout)
    b_ms = statistics.median(step_ms[1:])
    b_ops, b_dev_ms = device_ops(lambda: st.process_chunk_batch(
        bstate, part, mats, fcfg, vcfg, STREAM_CHUNK))
    rate = STREAM_BATCH * STREAM_CHUNK / fcfg.sample_rate / (b_ms / 1e3)
    n_ends = int(sum(int(o.utt_end.sum()) for o in bouts))
    if n_ends == 0:
        fail("streaming batch: no stream closed an utterance")
    # held against single streams and against the CPU on the first chunks
    err_single = err_cpu = 0.0
    cpu_state = st.init_state_batch(STREAM_BATCH, fcfg, STREAM_CHUNK, cpu)
    for c in range(STREAM_CHECK_CHUNKS):
        part = torch.from_numpy(sigs[:, c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK].copy())
        cpu_state, cpu_out = st.process_chunk_batch(cpu_state, part, mats_cpu, fcfg,
                                                    vcfg, STREAM_CHUNK)
        err_cpu = max(err_cpu, compare_chunks(bouts[c], cpu_out,
                                              f"streaming batch chunk {c} card vs CPU"))
    for i in range(STREAM_BATCH):
        state = st.init_state(fcfg, STREAM_CHUNK, dev)
        for c in range(STREAM_CHECK_CHUNKS):
            state, o = st.process_chunk(state, chunks[i, c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK],
                                        mats, fcfg, vcfg, STREAM_CHUNK)
            err_single = max(err_single, compare_chunks(
                st.ChunkOutput(*(a[None] for a in o)),
                st.ChunkOutput(*(a[i:i + 1] for a in bouts[c])),
                f"streaming batch stream {i} chunk {c} vs its single stream"))
    print(f"streaming {STREAM_BATCH} streams: process_chunk_batch {b_ms:.3f} ms a step "
          f"(median of {STREAM_CHUNKS - 1} synchronized steps), "
          f"streaming_batch_audio_seconds_per_sec {rate:.1f}; {b_ops} device ops a step, "
          f"device time {ms_text(b_dev_ms)}; {n_ends} utterances closed; first "
          f"{STREAM_CHECK_CHUNKS} chunks: MFCC max abs err vs single streams {err_single:.3e}, "
          f"vs the CPU {err_cpu:.3e}, flags and indices equal", flush=True)
    out["batch"] = dict(streams=STREAM_BATCH, step_ms=b_ms, steps_ms=step_ms,
                        audio_seconds_per_sec=rate, device_ops=b_ops, device_ms=b_dev_ms,
                        utterances_closed=n_ends, mfcc_max_abs_err_vs_single=err_single,
                        mfcc_max_abs_err_vs_cpu=err_cpu)

    # 4. StreamingRecognizer over connected digits, on the card and the CPU
    rec = KnnDtwRecognizer(cfg, device=dev)
    for lab in DIGITS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(TEMPLATES_PER_WORD)])
    arrays = (np.stack(rec._bank_feats), rec._bank_lens, rec._bank_label_ids, rec.labels)
    rec_cpu = KnnDtwRecognizer.from_arrays(*arrays, cfg, device=cpu)
    pad = np.zeros(STREAM_CHUNK * 5, np.float32)   # trailing silence closes the last word
    conn = [np.concatenate([synth_connected(words, seed * 100 + i), pad])
            for i, words in enumerate(STREAM_RECOGNIZER_WORDS)]
    rec.device_bank()
    torch.cuda.synchronize()
    _build.reset_launches()
    card_events, feed_ms, feed_hit = [], [], []
    for sig in conn:
        evs, ms_i, hit_i = feed_stream(StreamingRecognizer(rec, STREAM_CHUNK), sig, STREAM_CHUNK)
        card_events.append(evs)
        feed_ms += ms_i
        feed_hit += hit_i
    torch.cuda.synchronize()
    rec_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    n_utts = sum(len(e) for e in card_events)
    cpu_events = [feed_stream(StreamingRecognizer(rec_cpu, STREAM_CHUNK), sig, STREAM_CHUNK)[0]
                  for sig in conn]
    if card_events != cpu_events:
        fail(f"StreamingRecognizer events on the card {card_events} differ from the "
             f"CPU's {cpu_events}")
    if rec_launches.get("dtw_banded", 0) != n_utts or n_utts == 0:
        fail(f"StreamingRecognizer: {rec_launches} launches for {n_utts} closed utterances")
    words = [w for ws in STREAM_RECOGNIZER_WORDS for w in ws]
    got_words = [ev[0] for evs in card_events for ev in evs]
    with_cls = [m for m, h in zip(feed_ms, feed_hit) if h]
    without = [m for m, h in zip(feed_ms, feed_hit) if not h]
    print(f"streaming recognizer: {n_utts} utterances of {len(words)} words spoken, "
          f"{sum(a == b for a, b in zip(got_words, words))} in order right "
          f"(labels {got_words}); launches {rec_launches}; feed "
          f"{statistics.median(without):.3f} ms a chunk without a classify, "
          f"{statistics.median(with_cls) if with_cls else float('nan'):.3f} ms with one "
          f"(medians of {len(without)} and {len(with_cls)} chunks); events equal to the CPU's",
          flush=True)
    out["recognizer"] = dict(events=card_events, launches=rec_launches, utterances=n_utts,
                             words=words, feed_ms_without_classify=statistics.median(without),
                             feed_ms_with_classify=(statistics.median(with_cls)
                                                    if with_cls else None))

    # 5. StreamingSpotter against the offline spotter (kernel 3) and the CPU
    srec = KnnDtwRecognizer(cfg, device=dev)
    for lab in SPOT_KEYWORDS:
        srec.enroll(lab, [synth_word(lab, i) for i in range(SPOT_TEMPLATES_PER_WORD)])
    calibrated = KeywordSpotter(srec).calibrate_threshold()
    sarrays = (np.stack(srec._bank_feats), srec._bank_lens, srec._bank_label_ids, srec.labels)
    srec_cpu = KnnDtwRecognizer.from_arrays(*sarrays, cfg, device=cpu)
    pairs = [synth_spotting_stream(SPOT_KEYWORDS, DIGITS, seed * 1000 + i, n_words=8)
             for i in range(STREAM_SPOTTER_STREAMS)]
    streams = [sig for sig, _ in pairs]
    row_labels = np.asarray([srec.labels[i] for i in srec.device_bank()[1].cpu().numpy()])
    hop = fcfg.hop_len
    # JAX's rule (tests/test_spotter.py:128-144): each stream at the midpoint
    # of its best score inside a keyword and its best score elsewhere
    thrs = [separation_threshold(norm, start, row_labels,
                                 [(lab, s // hop, e // hop) for lab, s, e in truth])
            for (norm, start), (_, truth) in zip(KeywordSpotter(srec).scores(streams), pairs)]

    def offline(thr_of):
        return [KeywordSpotter(srec).spot([sig], threshold=thr)[0]
                for sig, thr in zip(streams, thr_of)]

    def online(rec_, thr_of):
        return [feed_stream(StreamingSpotter(rec_, STREAM_CHUNK, threshold=thr), sig,
                            STREAM_CHUNK, tail=True)[0] for sig, thr in zip(streams, thr_of)]

    bank = srec.device_bank()[0]
    k, t, f = bank.feats.shape
    probe = StreamingSpotter(srec, STREAM_CHUNK, threshold=calibrated)
    buf = torch.zeros((probe._buf, f), device=dev)
    no_host_sync("spot_chunk", lambda: sp.spot_chunk(probe.dp, buf, probe._buf - 2, bank.feats,
                                                     bank.length))
    dp_ops, dp_dev_ms = device_ops(lambda: sp.spot_chunk(probe.dp, buf, probe._buf - 2,
                                                         bank.feats, bank.length))
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    s_events = online(srec, thrs)
    s_seconds = time.perf_counter() - t0
    spot_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if spot_launches:
        fail(f"StreamingSpotter launched kernels {spot_launches}: its path has none")
    steady = StreamingSpotter(srec, STREAM_CHUNK, threshold=calibrated)
    steady.feed(streams[0][:STREAM_CHUNK])
    feed_ops, _ = device_ops(lambda: steady.feed(streams[0][STREAM_CHUNK:2 * STREAM_CHUNK]))
    for i, (got, want) in enumerate(zip(s_events, offline(thrs))):
        if not same_spots(got, want):
            fail(f"StreamingSpotter stream {i} at threshold {thrs[i]:.4f}: events {got} vs "
                 f"the offline spotter's {want}")
    cpu_s = online(srec_cpu, thrs)
    score_err = max([abs(g[3] - w[3]) / abs(w[3]) for a, b in zip(s_events, cpu_s)
                     for g, w in zip(a, b)] or [0.0])
    if [[ev[:3] for ev in a] for a in s_events] != [[ev[:3] for ev in b] for b in cpu_s] \
            or score_err > 1e-4:
        fail(f"StreamingSpotter events on the card {s_events} differ from the CPU's {cpu_s}")
    # at the bank's calibrated threshold false alarms abut true matches, and
    # the hangover (a match that starts on an emitted one's end frame is
    # dropped) and the offline greedy order can part: counted, not held
    at_cal = list(zip(online(srec, [calibrated] * len(streams)),
                      offline([calibrated] * len(streams))))
    parted = [i for i, (a, b) in enumerate(at_cal) if not same_spots(a, b)]
    audio = sum(len(x) for x in streams) / fcfg.sample_rate
    n_chunks = sum(-(-len(x) // STREAM_CHUNK) for x in streams)
    s_rate = audio / s_seconds
    print(f"streaming spotter: K={k}, thresholds {[round(v, 4) for v in thrs]} (JAX's "
          f"separation rule), {sum(map(len, s_events))} events in {len(streams)} streams "
          f"({audio:.1f} s audio), equal to the offline spotter's (spans within 2 frames, "
          f"scores 1e-3) and to the CPU's (scores within {score_err:.2e} relative); "
          f"{s_seconds * 1e3 / n_chunks:.3f} ms a chunk, "
          f"streaming_spotter_audio_seconds_per_sec {s_rate:.1f}; {feed_ops} device ops a "
          f"steady feed, spot_chunk of {probe._buf} frames {dp_ops} device ops, device time "
          f"{ms_text(dp_dev_ms)}; no kernel launched; at the calibrated threshold "
          f"{calibrated:.4f} the events part from the offline spotter's in streams {parted}"
          + "".join(f"\n  stream {i}: online {at_cal[i][0]}\n  stream {i}: offline "
                    f"{at_cal[i][1]}" for i in parted), flush=True)
    out["spotter"] = dict(thresholds=thrs, calibrated_threshold=calibrated, n_templates=k,
                          audio_seconds=audio, events=s_events,
                          ms_per_chunk=s_seconds * 1e3 / n_chunks,
                          audio_seconds_per_sec=s_rate, feed_device_ops=feed_ops,
                          spot_chunk_device_ops=dp_ops, spot_chunk_device_ms=dp_dev_ms,
                          score_max_rel_err_vs_cpu=score_err,
                          streams_parted_at_calibrated=parted)
    return {"recognizer": rec_launches, "spotter": spot_launches}


def params_err(got, want) -> float:
    """max |got - want| / (1 + |want|) over the tensors of two parameter
    sets (HmmParams or a UBM tuple); the NEG_INF entries agree exactly."""
    return max(float(((g.cpu().double() - w.cpu().double()).abs()
                      / (1.0 + w.cpu().double().abs())).max())
               for g, w in zip(got, want))


def hmm_phase(seed: int, dev, report) -> int:
    """Phase hmm: BASELINE config 3 on the card against the CPU; returns
    kernel 2's launches in the fused front-end's classify."""
    import numpy as np
    import torch

    from dsp_tpu_torch import GmmHmmRecognizer
    from dsp_tpu_torch.config import FrontendConfig, HmmConfig, PipelineConfig
    from dsp_tpu_torch.io import DIGITS, synth_word
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.models.knn_dtw import REJECT

    out = report["hmm"]
    hmm = HmmConfig()
    train = {lab: [synth_word(lab, i) for i in range(HMM_TRAIN_PER_WORD)] for lab in DIGITS}
    queries, truth = synth_batch(HMM_QUERIES, 1000)
    oov = [synth_word(w, 7000 + i) for w in OOV_WORDS for i in range(OOV_PER_WORD)]
    sigs = queries + oov

    def same_labels(got, want, scores, what):
        """Labels equal except where the reference's top-2 log-liks lie
        within 1e-4 relative; returns the mismatches at such near-ties."""
        diff = np.array([a != b for a, b in zip(got, want)])
        ties = near_ties(-np.asarray(scores))
        if (diff & ~ties).any():
            fail(f"hmm {what}: {int((diff & ~ties).sum())} labels differ outside near-ties")
        return int(diff.sum())

    # -- fits on the card (segmental timed twice, Baum-Welch once), each
    # against the CPU's EM on the card's features from the same draws
    fits = {}
    for mode in ("viterbi", "baum_welch"):
        cfg = dataclasses.replace(hmm, train_mode=mode)
        rec = GmmHmmRecognizer(PipelineConfig(), cfg, device=dev)
        seconds = []
        for _ in range(2 if mode == "viterbi" else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec.fit(train)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        feats_w, lens_w = pg.stack_words([rec.extract(train[lab]) for lab in rec.labels], dev)
        w, n, t, f = feats_w.shape
        host = GmmHmmRecognizer(PipelineConfig(), cfg, device="cpu")
        host.labels = rec.labels
        host.ubm = pg.fit_ubm(feats_w.reshape(w * n, t, f).cpu(), lens_w.reshape(-1).cpu(),
                              cfg, pg.normal_draw((cfg.n_mix, f), cfg.seed, "cpu"))
        host.params = pg.fit_words_batched(feats_w.cpu(), lens_w.cpu(),
                                           pg.word_jitter(cfg, w, f, "cpu"), cfg)
        spread = max(params_err(rec.ubm, host.ubm), params_err(rec.params, host.params))
        labels, scores = rec.classify_batch(queries, return_scores=True)
        h_labels, h_scores = host.classify_batch(queries, return_scores=True)
        fit_ties = same_labels(labels, h_labels, h_scores, f"{mode} fit against the CPU's fit")
        acc = float(np.mean([a == b for a, b in zip(labels, truth)]))
        h_acc = float(np.mean([a == b for a, b in zip(h_labels, truth)]))
        step = ""
        if mode == "viterbi":
            # one E-step from the same parameters (the card's init) on both
            p0 = pg.init_params(feats_w, lens_w, cfg, pg.word_jitter(cfg, w, f, dev))
            s_card = pg.em_suff_stats(feats_w, lens_w, p0, cfg)
            s_host = pg.em_suff_stats(feats_w.cpu(), lens_w.cpu(),
                                      pg.HmmParams(*(a.cpu() for a in p0)), cfg)
            step_err = params_err(s_card, s_host)
            same_counts = all(torch.equal(getattr(s_card, k).cpu(), getattr(s_host, k))
                              for k in ("stay_cnt", "trans_cnt"))
            if step_err > HMM_STEP_TOL or not same_counts:
                fail(f"hmm: one E-step parts from the CPU's by {step_err:.3e} "
                     f"(transition counts equal: {same_counts})")
            step = (f"one E-step from the same parameters {step_err:.3e} (held at "
                    f"{HMM_STEP_TOL}), transition counts equal; ")
            out["e_step_err_vs_cpu"] = step_err
        print(f"hmm fit {mode:10s}: {'  '.join(f'{v:.3f}' for v in seconds)} s "
              f"(features + UBM + {cfg.n_iter} EM iterations of {w} words x {n}); against "
              f"the CPU on the same features and draws: {step}whole fit {spread:.3e}, "
              f"labels equal ({fit_ties} at near-ties), accuracy {acc:.4f} (CPU "
              f"{h_acc:.4f})", flush=True)
        if spread > HMM_FIT_SPREAD or acc < 0.9:
            fail(f"hmm fit {mode}: parts from the CPU's by {spread:.3e}, accuracy {acc}")
        fits[mode] = rec
        out[f"fit_{mode}"] = dict(seconds=seconds, fit_err_vs_cpu=spread, accuracy=acc,
                                  cpu_accuracy=h_acc, labels_at_near_ties=fit_ties)
    rec = fits["viterbi"]

    # -- classify: card against the CPU on the same parameters
    host = GmmHmmRecognizer(PipelineConfig(), hmm, device="cpu")
    host.labels = rec.labels
    host.params = pg.HmmParams(*(a.cpu() for a in rec.params))
    host.ubm = tuple(a.cpu() for a in rec.ubm)
    labels, scores = rec.classify_batch(sigs, return_scores=True)
    h_labels, h_scores = host.classify_batch(sigs, return_scores=True)
    ties = same_labels(labels, h_labels, h_scores, "labels against the CPU")
    score_err = float(np.max(np.abs(scores - h_scores) / np.abs(h_scores)))
    acc = float(np.mean([a == b for a, b in zip(labels[:HMM_QUERIES], truth)]))

    # rejection: calibrate on the training corpus, evaluate with the OOV words
    thr, h_thr = rec.calibrate_rejection(train), host.calibrate_rejection(train)
    corpus = {lab: [x for x, y in zip(queries, truth) if y == lab] for lab in DIGITS}
    corpus.update({wd: oov[i * OOV_PER_WORD:(i + 1) * OOV_PER_WORD]
                   for i, wd in enumerate(OOV_WORDS)})
    result = rec.evaluate(corpus, reject=True)
    r_labels = rec.classify_batch(sigs, reject=thr)
    feats = rec.extract(sigs)
    llr = rec._utterance_llr(feats, scores, rec.ubm)
    h_llr = host._utterance_llr(host.extract(sigs), h_scores, host.ubm)
    h_r = host.classify_batch(sigs, reject=thr)
    edge = np.abs(h_llr - thr) <= 1e-3 * (1.0 + abs(thr))
    bad = np.array([a != b for a, b in zip(r_labels, h_r)]) & ~edge & ~near_ties(-h_scores)
    if bad.any():
        fail(f"hmm: {int(bad.sum())} reject decisions differ from the CPU's")
    oov_rate = float(np.mean([lab == REJECT for lab in r_labels[HMM_QUERIES:]]))
    in_rej = float(np.mean([lab == REJECT for lab in r_labels[:HMM_QUERIES]]))
    nbest = rec.classify_nbest(sigs[:HMM_QUERIES], n=3)
    if [row[0][0] for row in nbest] != labels[:HMM_QUERIES]:
        fail("hmm: the n-best top-1 differs from the label")

    # the decode: utterance-word decodes a second (bench_all.py:144) and its
    # device ops; one fit's device ops
    qf = rec.extract(queries)
    decode = lambda: pg.score_words(qf.feats, qf.length, rec.params)   # noqa: E731
    ms = time_ms(decode)
    rate = HMM_QUERIES * len(rec.labels) / (ms / 1e3)
    ops, dev_ms = device_ops(decode)
    feats_w, lens_w = pg.stack_words([rec.extract(train[lab]) for lab in rec.labels], dev)
    jitter = pg.word_jitter(hmm, feats_w.shape[0], feats_w.shape[-1], dev)
    fit_ops, fit_dev_ms = device_ops(
        lambda: pg.fit_words_batched(feats_w, lens_w, jitter, hmm))
    print(f"hmm classify: accuracy {acc:.4f}; labels as the CPU's on the same parameters "
          f"({ties} at near-ties), scores to {score_err:.3e} relative; rejection threshold "
          f"{thr:.6f} (CPU {h_thr:.6f}), evaluate(reject=True) accuracy "
          f"{result['accuracy']:.4f} of {result['n']}, OOV rejected {oov_rate:.4f}, "
          f"in-vocabulary rejected {in_rej:.4f}; viterbi_decodes_per_sec {rate:.1f} "
          f"(score_words {ms:.3f} ms for {HMM_QUERIES} x {len(rec.labels)}) on "
          f"{'; '.join(report['nvidia_smi'])}; one score_words: {ops} device ops, "
          f"{ms_text(dev_ms)} device time; one fit_words_batched: {fit_ops} device ops, "
          f"{ms_text(fit_dev_ms)} device time", flush=True)
    if acc < 0.9:
        fail(f"hmm: accuracy {acc}")

    # noise adaptation: a noisy batch, the word models and UBM PMC-adapted
    rng = np.random.default_rng([seed, 11])
    noisy = [(x + HMM_NOISE_SIGMA * rng.standard_normal(len(x))).astype(np.float32)
             for x in queries]
    plain_noisy = rec.classify_batch(noisy)
    rec.noise_adapt = host.noise_adapt = True
    n_labels = rec.classify_batch(noisy)
    hn_labels, hn_scores = host.classify_batch(noisy, return_scores=True)
    rec.noise_adapt = host.noise_adapt = False
    n_ties = same_labels(n_labels, hn_labels, hn_scores, "noise_adapt labels against the CPU")
    n_acc = float(np.mean([a == b for a, b in zip(n_labels, truth)]))
    p_acc = float(np.mean([a == b for a, b in zip(plain_noisy, truth)]))

    # save / load round trip
    path = ROOT / "build" / "hmm_smoke.npz"
    path.parent.mkdir(exist_ok=True)
    rec.save(str(path))
    back = GmmHmmRecognizer.load(str(path), device=dev)
    path.unlink()
    if (params_err(back.params, rec.params) != 0.0 or params_err(back.ubm, rec.ubm) != 0.0
            or back.reject_threshold != thr or back.classify_batch(sigs) != labels):
        fail("hmm: the save/load round trip changed the model")

    # the fused front-end: kernel 2 on this path, counted from 0
    fused = GmmHmmRecognizer(PipelineConfig(frontend=FrontendConfig(impl="pallas")), hmm,
                             device=dev)
    fused.labels, fused.params, fused.ubm = rec.labels, rec.params, rec.ubm
    torch.cuda.synchronize()
    _build.reset_launches()
    f_labels = fused.classify_batch(queries)
    torch.cuda.synchronize()
    n_mfcc = _build.LAUNCHES["mfcc_fused"]
    others = {k: v for k, v in _build.LAUNCHES.items() if v and k != "mfcc_fused"}
    if n_mfcc == 0 or others:
        fail(f"hmm: the fused front-end's classify launched mfcc_fused {n_mfcc} times "
             f"and {others}")
    f_ties = same_labels(f_labels, labels[:HMM_QUERIES], scores[:HMM_QUERIES],
                         "fused front-end labels against the default front-end's")
    print(f"hmm noise_adapt at sigma {HMM_NOISE_SIGMA}: accuracy {n_acc:.4f} (without "
          f"{p_acc:.4f}), labels as the CPU's ({n_ties} at near-ties); save/load round "
          f"trip equal; FrontendConfig(impl='pallas'): mfcc_fused launched {n_mfcc} "
          f"times, labels as the default front-end's ({f_ties} at near-ties)", flush=True)
    out.update(accuracy=acc, labels_at_near_ties=ties, score_max_rel_err_vs_cpu=score_err,
               reject_threshold=thr, reject_threshold_cpu=h_thr,
               evaluate_reject_accuracy=result["accuracy"], evaluate_n=result["n"],
               oov_reject_rate=oov_rate, in_vocab_reject_rate=in_rej,
               score_words_ms=ms, viterbi_decodes_per_sec=rate,
               score_words_device_ops=ops, score_words_device_ms=dev_ms,
               fit_device_ops=fit_ops, fit_device_ms=fit_dev_ms,
               noise_adapt_accuracy=n_acc, noisy_accuracy_without=p_acc,
               noise_adapt_labels_at_near_ties=n_ties, fused_mfcc_launches=n_mfcc,
               fused_labels_at_near_ties=f_ties)
    return n_mfcc


def hmm_raw_scores(llr, start, ubm_ll):
    """The best-path log-liks behind LLR fields [B, W, U] (numpy): llr x span
    plus the UBM log-lik over the span, in float64."""
    import numpy as np

    b, w, u = llr.shape
    p = np.concatenate([np.zeros((b, 1)), np.cumsum(ubm_ll.astype(np.float64), axis=1)], axis=1)
    p_w = np.broadcast_to(p[:, None, :], (b, w, u + 1))
    ubm_span = p_w[..., 1:] - np.take_along_axis(p_w, start.astype(np.int64), axis=2)
    return llr.astype(np.float64) * (np.arange(u) - start + 1) + ubm_span


def compare_hmm_fields(spotter, host, sigs, what: str):
    """Card against CPU ``HmmSpotter.scores`` on the same signals: where the
    entry witnesses agree, LLRs within HMM_SPOT_LLR_TOL; where they differ,
    the best-path log-liks within 1e-4 relative (near-ties) at under 0.1 %
    of the sites.  Returns (card fields, stats, streams with a flip)."""
    import numpy as np

    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.ops import spot_hmm as tsh

    fields = []
    for sp_ in (spotter, host):
        llr, start = (np.stack(a) for a in zip(*sp_.scores(sigs)))
        f = sp_.cfg.frontend
        x, n = pl.pad_signals(sigs, HMM_SPOT_SAMPLES, sp_.rec.device)
        feats = pl.extract_recording_features(
            x, n, sp_.cfg, 1 + (HMM_SPOT_SAMPLES - f.frame_len) // f.hop_len)
        ubm_ll = tsh._ubm_loglik(feats.feats, sp_.rec.ubm).cpu().numpy()
        fields.append((llr, start, hmm_raw_scores(llr, start, ubm_ll)))
    (gl, gs, gv), (wl, ws, wv) = fields
    if gl.shape != wl.shape or not np.isfinite(gl).all():
        fail(f"{what}: LLR fields {gl.shape} vs {wl.shape}, finite {np.isfinite(gl).all()}")
    agree, flip = gs == ws, gs != ws
    err = np.abs(gl - wl)[agree]
    tol = HMM_SPOT_LLR_TOL["atol"] + HMM_SPOT_LLR_TOL["rtol"] * np.abs(wl[agree])
    if (err > tol).any():
        fail(f"{what}: LLRs differ where the witnesses agree: max abs err {err.max():.3e}")
    raw_rel = np.abs(gv - wv)[flip] / np.abs(wv[flip])
    if (raw_rel > 1e-4).any():
        fail(f"{what}: witnesses differ at {int(flip.sum())} sites, best paths up to "
             f"{raw_rel.max():.3e} apart (not near-ties)")
    share = float(flip.sum() / flip.size)
    if share >= 1e-3:
        fail(f"{what}: witnesses differ at {share:.2e} of the sites (>= 0.1%)")
    rel = err / np.maximum(np.abs(wl[agree]), 1e-30)
    stats = dict(n_sites=int(flip.size), max_abs_err=float(err.max()),
                 max_rel_err=float(rel.max()), witness_flips=int(flip.sum()),
                 flip_share=share,
                 max_raw_rel_at_flips=float(raw_rel.max()) if raw_rel.size else 0.0)
    return (gl, gs), stats, set(np.nonzero(flip.any(axis=(1, 2)))[0].tolist())


def same_hmm_events(got, want) -> bool:
    """Labels and spans equal, LLR scores within HMM_SPOT_LLR_TOL."""
    return [ev[:3] for ev in got] == [ev[:3] for ev in want] and all(
        abs(g[3] - w[3]) <= HMM_SPOT_LLR_TOL["atol"] + HMM_SPOT_LLR_TOL["rtol"] * abs(w[3])
        for g, w in zip(got, want))


def near_spots(got, want, frames: int, score_tol=None) -> bool:
    """JAX's streaming-against-offline rules (tests/test_spot_hmm.py:238-246,
    tests/test_cascade_spot.py): labels equal in order, spans within
    ``frames``, scores within ``score_tol`` = (rtol, atol) where given."""
    return [ev[0] for ev in got] == [ev[0] for ev in want] and all(
        abs(g[1] - w[1]) <= frames and abs(g[2] - w[2]) <= frames
        and (score_tol is None or abs(g[3] - w[3]) <= score_tol[1] + score_tol[0] * abs(w[3]))
        for g, w in zip(got, want))


def cascade_stage_ms(cas, signals, reps: int = 3) -> dict:
    """Host-clock ms of the stages of one ``CascadeSpotter.spot`` pass, each
    ended by a synchronize (median of ``reps``), timed around the calls that
    ``rescored`` makes: candidates (``_candidates``: the scoring models,
    whole-recording features, the stage-1 scan and its fields back to the
    host, event extraction, the window cut), rerank (``_rescore``: windows
    padded into one batch and copied, kernel 3 with the argmin on the card,
    four numbers a window back) and the threshold filter with suppression
    (host), as ``spot`` runs it."""
    import torch

    keys = ("candidates", "rerank", "suppress")
    times = {k: [] for k in keys}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wins, owners = cas._candidates(signals)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pairs = cas._rescore(wins, owners)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = [[] for _ in signals]
        for i, ev in pairs:
            out[i].append(ev)
        for evs in out:
            cas.suppress([ev for ev in evs if ev[3] < cas.threshold])
        t3 = time.perf_counter()
        for key, lo, hi in zip(keys, (t0, t1, t2), (t1, t2, t3)):
            times[key].append((hi - lo) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def rerank_batches_vs_plain(batches) -> dict:
    """Kernel 3 against its plain version on the window batches a cascade
    handed to ``rerank_windows``: the kernel on each whole batch, as the
    rerank launched it; the plain scan in slices of at most
    ``_COST_BUDGET_ELEMS`` cost cells; ``compare_spot`` at rtol 1e-4 over
    every row (the padding rows too)."""
    import numpy as np
    import torch

    from dsp_tpu_torch.models.spotter import _COST_BUDGET_ELEMS
    from dsp_tpu_torch.ops.spot import subseq_dtw_batch

    got, want, lens = [], [], []
    for wins, win_lens, bank, bank_lens, squared in batches:
        n, w, _ = wins.shape
        k, t, _ = bank.shape
        fused = subseq_dtw_batch(wins, win_lens, bank, bank_lens, squared=squared,
                                 impl="fused")
        torch.cuda.synchronize()
        got.append([a.cpu().numpy() for a in fused])
        step = max(1, _COST_BUDGET_ELEMS // (k * t * w))
        plain = [subseq_dtw_batch(wins[lo:lo + step], win_lens[lo:lo + step], bank,
                                  bank_lens, squared=squared, impl="scan")
                 for lo in range(0, n, step)]
        want.append([torch.cat(a).cpu().numpy() for a in zip(*plain)])
        lens.append(win_lens.cpu().numpy())
    b_lens = batches[0][3].cpu().numpy()
    cmp = compare_spot([np.concatenate(a) for a in zip(*got)],
                       [np.concatenate(a) for a in zip(*want)], np.concatenate(lens),
                       b_lens, "cascade rerank windows", rtol=1e-4)
    return dict(shape=[sum(len(x) for x in lens), *batches[0][2].shape[:2],
                       batches[0][0].shape[1]], batches=len(batches), **cmp)


def cascade_phase(seed: int, dev, report) -> int:
    """Phase cascade (ROADMAP item 12b): the HMM and cascade spotters at full
    width on the card against the CPU; returns kernel 3's launches in the
    cascade's spot pass."""
    import numpy as np
    import torch

    from dsp_tpu_torch import GmmHmmRecognizer, KeywordSpotter, KnnDtwRecognizer
    from dsp_tpu_torch.config import FrontendConfig, HmmConfig, PipelineConfig
    from dsp_tpu_torch.io import DIGITS, synth_connected, synth_spotting_stream, synth_word
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.models import (CascadeSpotter, HmmSpotter, StreamingCascadeSpotter,
                                      StreamingHmmSpotter)
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.ops import spot as sp_ops

    out = report["cascade"]
    smi = "; ".join(report["nvidia_smi"])
    hmm = HmmConfig()
    rec = GmmHmmRecognizer(PipelineConfig(), hmm, device=dev)
    rec.fit({lab: [synth_word(lab, i) for i in range(HMM_TRAIN_PER_WORD)] for lab in DIGITS})
    host = GmmHmmRecognizer(PipelineConfig(), hmm, device="cpu")
    host.labels = rec.labels
    host.params = pg.params_from_numpy(pg.params_to_numpy(rec.params), "cpu")
    host.ubm = pg.ubm_from_numpy([a.cpu().numpy() for a in rec.ubm], "cpu")

    # 1. HmmSpotter at the spot-hmm cell, card against CPU
    sigs, clens = [], []
    for i in range(HMM_SPOT_STREAMS):
        x = synth_connected([DIGITS[(i + w) % 10] for w in range(3)], 300 + i)
        pad = np.zeros(HMM_SPOT_SAMPLES, np.float32)
        clens.append(min(len(x), HMM_SPOT_SAMPLES))
        pad[:clens[-1]] = x[:clens[-1]]
        sigs.append(pad)
    spotter = HmmSpotter(rec, threshold=HMM_SPOT_THRESHOLD)
    h_spotter = HmmSpotter(host, threshold=HMM_SPOT_THRESHOLD)
    (llr, _), cmp, flip_streams = compare_hmm_fields(spotter, h_spotter, sigs,
                                                     "HmmSpotter.scores")
    events, h_events = spotter.spot(sigs), h_spotter.spot(sigs)
    differ = [i for i, (a, b) in enumerate(zip(events, h_events)) if not same_hmm_events(a, b)]
    if set(differ) - flip_streams:
        fail(f"HmmSpotter events differ from the CPU's in streams "
             f"{sorted(set(differ) - flip_streams)} with no witness near-tie")
    passes = synced_ms(lambda: spotter.scores(sigs), CASCADE_PASSES)
    # the clips' own lengths, as bench_all.py's clens: the zero padding
    # gives every stream the same 598 frames of work but is not audio
    audio_s = sum(clens) / rec.cfg.frontend.sample_rate
    rate = audio_s / (statistics.median(passes) / 1e3)
    ops, dev_ms = device_ops(lambda: spotter.scores(sigs))
    n_events = sum(map(len, events))
    print(f"cascade hmm spotter: {len(sigs)} streams x {llr.shape[-1]} frames x "
          f"{llr.shape[1]} words (S={hmm.n_states}, M={hmm.n_mix}); against the CPU: "
          f"witness flips {cmp['witness_flips']} of {cmp['n_sites']} (best paths within "
          f"{cmp['max_raw_rel_at_flips']:.2e}), LLR max abs err {cmp['max_abs_err']:.3e} "
          f"(rel {cmp['max_rel_err']:.3e}) where they agree; {n_events} events at threshold "
          f"{spotter.threshold}, streams with other events {len(differ)}; "
          f"hmm_spotting_audio_seconds_per_sec {rate:.1f} ({audio_s:.2f} s of audio, median "
          f"{statistics.median(passes):.3f} ms of {CASCADE_PASSES} scores passes) on {smi}; "
          f"one scores pass: {ops} device "
          f"ops, {ms_text(dev_ms)} device time", flush=True)
    out["hmm_spotter"] = dict(n_streams=len(sigs), frames=int(llr.shape[-1]), **cmp,
                              n_events=n_events, streams_with_other_events=len(differ),
                              audio_seconds=audio_s, pass_ms=passes,
                              hmm_spotting_audio_seconds_per_sec=rate,
                              device_ops=ops, device_ms=dev_ms)

    # 2. StreamingHmmSpotter against the card's offline HmmSpotter
    streams = [synth_spotting_stream(SPOT_KEYWORDS, DIGITS, seed * 1000 + i, n_words=8)
               for i in range(SPOT_STREAMS)]
    sp_sigs = [sig for sig, _ in streams]
    few = sp_sigs[:STREAM_SPOTTER_STREAMS]
    offline = spotter.spot(few)
    chunk_ms, n_ev = [], 0
    for i, sig in enumerate(few):
        got, ms, _ = feed_stream(StreamingHmmSpotter(rec, chunk_len=STREAM_CHUNK,
                                                     threshold=HMM_SPOT_THRESHOLD),
                                 sig, STREAM_CHUNK, tail=True)
        if not near_spots(got, offline[i], 2, (1e-3, 2e-3)):
            fail(f"StreamingHmmSpotter stream {i}: {got} against offline {offline[i]}")
        chunk_ms += ms
        n_ev += len(got)
    if n_ev == 0:
        fail("StreamingHmmSpotter found no event to compare")
    ms = statistics.median(chunk_ms)
    print(f"cascade streaming hmm spotter: {len(few)} streams, {n_ev} events as the "
          f"offline spotter's (labels, spans within 2 frames, scores rtol 1e-3 / atol 2e-3); "
          f"{ms:.3f} ms a 100 ms chunk (median of {len(chunk_ms)} feeds)", flush=True)
    out["streaming_hmm_spotter"] = dict(n_streams=len(few), events=n_ev, chunk_ms=ms)

    # 3. CascadeSpotter with phase spotter's bank and streams; kernel 3 counted
    bank = KnnDtwRecognizer(device=dev)
    for lab in SPOT_KEYWORDS:
        bank.enroll(lab, [synth_word(lab, i) for i in range(SPOT_TEMPLATES_PER_WORD)])
    bank.spot_threshold = KeywordSpotter(bank).calibrate_threshold()
    cas = CascadeSpotter(rec, bank)
    cas.spot(sp_sigs[:2])
    torch.cuda.synchronize()
    # the counted pass also keeps the window batches the rerank hands to
    # rerank_windows, to hold kernel 3 against its plain version on them
    batches, rerank = [], sp_ops.rerank_windows

    def recorded(wins, win_lens, mids, bank_feats, bank_lens, squared=False):
        batches.append((wins, win_lens, bank_feats, bank_lens, squared))
        return rerank(wins, win_lens, mids, bank_feats, bank_lens, squared=squared)

    sp_ops.rerank_windows = recorded
    try:
        _build.reset_launches()
        c_events = cas.spot(sp_sigs)
        torch.cuda.synchronize()
        launches = _build.LAUNCHES["spot_subseq"]
    finally:
        sp_ops.rerank_windows = rerank
    others = {k: v for k, v in _build.LAUNCHES.items() if v and k != "spot_subseq"}
    if launches == 0 or others or not batches:
        fail(f"the cascade launched kernel 3 {launches} times and {others}, "
             f"{len(batches)} rerank batches")
    win_cmp = rerank_batches_vs_plain(batches)
    del batches
    print(f"cascade rerank windows: kernel 3 against its plain version on the "
          f"{win_cmp['batches']} batches of the counted pass, [N, K, T, W] = "
          f"{win_cmp['shape']}: flips {win_cmp['witness_flips']} ({win_cmp['flip_share']:.2e}), "
          f"max abs err {win_cmp['max_abs_err']:.3e} (rel {win_cmp['max_rel_err']:.3e}) where "
          f"the witnesses agree, identical BIG pattern", flush=True)
    out["rerank_windows"] = win_cmp
    h_bank = KnnDtwRecognizer.from_arrays(np.stack(bank._bank_feats), bank._bank_lens,
                                          bank._bank_label_ids, bank.labels,
                                          PipelineConfig(), device="cpu")
    h_bank.spot_threshold = bank.spot_threshold
    h_cas = CascadeSpotter(host, h_bank)
    few = sp_sigs[:CASCADE_CPU_STREAMS]
    resc, h_resc = cas.rescored(few), h_cas.rescored(few)
    # stage 1's candidates on both devices: a stream whose events part
    # (a witness near-tie moved a landmark) reranks other windows
    s1_differ = {i for i, (a, b) in enumerate(zip(cas.stage1.spot(few), h_cas.stage1.spot(few)))
                 if [ev[:3] for ev in a] != [ev[:3] for ev in b]}
    rerank_ties = 0
    for i, (a, b) in enumerate(zip(resc, h_resc)):
        if [ev[:3] for ev in a] == [ev[:3] for ev in b] and all(
                abs(x[3] - y[3]) <= 2e-4 * abs(y[3]) for x, y in zip(a, b)):
            continue
        # a rerank near-tie: two picks whose scores round apart
        ties = len(a) == len(b) and all(abs(x[3] - y[3]) <= 1e-4 * abs(y[3])
                                        for x, y in zip(a, b))
        if not (ties or i in s1_differ):
            fail(f"cascade stream {i}: rescored {a} against the CPU's {b}, with equal "
                 "stage-1 events and no rerank near-tie")
        rerank_ties += 1
    hop = bank.cfg.frontend.hop_len
    n_truth = hits = false_alarms = 0
    for evs, (_, truth) in zip(c_events, streams):
        spans = [(lab, s // hop, e // hop) for lab, s, e in truth]
        n_truth += len(spans)
        hits += sum(any(ev[0] == lab and s <= (ev[1] + ev[2]) / 2 <= e for ev in evs)
                    for lab, s, e in spans)
        false_alarms += sum(not any(ev[0] == lab and s <= (ev[1] + ev[2]) / 2 <= e
                                    for lab, s, e in spans) for ev in evs)
    if n_truth == 0 or hits == 0:
        fail(f"the cascade found {hits} of {n_truth} keywords")
    passes = synced_ms(lambda: cas.spot(sp_sigs), CASCADE_PASSES)
    c_audio = sum(len(s) for s in sp_sigs) / bank.cfg.frontend.sample_rate
    c_rate = c_audio / (statistics.median(passes) / 1e3)
    stages = cascade_stage_ms(cas, sp_sigs)
    # stage 1's own entry point on the same streams (not a part of the pass):
    # the scoring models, features and the scan, fields back to the host
    stages["hmm_scores_alone"] = statistics.median(
        synced_ms(lambda: cas.stage1.scores(sp_sigs), CASCADE_PASSES))
    n_wins = sum(map(len, cas.rescored(sp_sigs)))
    print(f"cascade: K={bank.n_templates} streams={len(sp_sigs)} ({c_audio:.1f} s audio) "
          f"threshold {cas.threshold:.4f}  kernel 3 launches {launches} for {n_wins} "
          f"windows  keyword hits {hits}/{n_truth} ({hits / n_truth:.4f})  false alarms "
          f"{false_alarms}; against the CPU cascade on {len(few)} streams: rescored equal "
          f"except {rerank_ties} streams (stage-1 events differ in "
          f"{len(s1_differ)}); cascade_audio_seconds_per_sec {c_rate:.1f} (median "
          f"{statistics.median(passes):.3f} ms of {CASCADE_PASSES} spot passes) on {smi}; "
          "one spot pass, ms: " + "  ".join(f"{k} {v:.2f}" for k, v in stages.items()),
          flush=True)
    out["cascade"] = dict(n_templates=bank.n_templates, n_streams=len(sp_sigs),
                          audio_seconds=c_audio, threshold=cas.threshold, launches=launches,
                          windows=n_wins, keyword_hits=hits, keywords=n_truth,
                          hit_rate=hits / n_truth, false_alarms=false_alarms,
                          cpu_streams=len(few), streams_at_near_ties=rerank_ties,
                          stage1_differ_streams=len(s1_differ), pass_ms=passes,
                          cascade_audio_seconds_per_sec=c_rate, stage_ms=stages)

    # 4. StreamingCascadeSpotter on the card against the same spotter on the
    # CPU (same parameters and bank) on every stream, and against the card's
    # offline cascade; with the default bank and one enrolled at
    # add_deltas=False (where the JAX package's clamped readiness check
    # reranks windows cut short, ROADMAP.md section 3).  A stream whose
    # streaming stage-1 landmarks part from the offline ones (the streaming
    # spotter's abutting-match rule, the reference's design: a landmark
    # within min_gap of a better later one is replaced online, kept offline)
    # is held to the CPU only; one whose stage-1 landmarks part between the
    # card and the CPU (a witness near-tie) is held to the offline cascade
    # only
    flat_cfg = PipelineConfig(frontend=FrontendConfig(add_deltas=False))
    flat = KnnDtwRecognizer(flat_cfg, device=dev)
    for lab in SPOT_KEYWORDS:
        flat.enroll(lab, [synth_word(lab, i) for i in range(SPOT_TEMPLATES_PER_WORD)])
    h_flat = KnnDtwRecognizer.from_arrays(np.stack(flat._bank_feats), flat._bank_lens,
                                          flat._bank_label_ids, flat.labels, flat_cfg,
                                          device="cpu")
    few = sp_sigs[:STREAM_SPOTTER_STREAMS]
    s1_off = cas.stage1.spot(few)
    s1_parts, s1_cpu_parts = [], []
    for i, sig in enumerate(few):
        got, h_got = (feed_stream(StreamingHmmSpotter(r, STREAM_CHUNK, cas.hmm_threshold,
                                                      min_gap=cas.stage1.min_gap),
                                  sig, STREAM_CHUNK, tail=True)[0] for r in (rec, host))
        if not near_spots(got, s1_off[i], 2):
            s1_parts.append(i)
        if [ev[:3] for ev in got] != [ev[:3] for ev in h_got]:
            s1_cpu_parts.append(i)
    for name, b, hb in (("default", bank, h_bank), ("add_deltas_false", flat, h_flat)):
        offline = CascadeSpotter(rec, b)
        want = offline.spot(few)
        chunk_ms, n_ev, held, held_cpu = [], 0, 0, 0
        for i, sig in enumerate(few):
            got, ms, _ = feed_stream(StreamingCascadeSpotter(rec, b, chunk_len=STREAM_CHUNK),
                                     sig, STREAM_CHUNK, tail=True)
            h_got, _, _ = feed_stream(StreamingCascadeSpotter(host, hb, chunk_len=STREAM_CHUNK),
                                      sig, STREAM_CHUNK, tail=True)
            chunk_ms += ms
            n_ev += len(got)
            if i not in s1_cpu_parts:
                if len(got) != len(h_got) or not near_spots(got, h_got, 0, (2e-4, 0.0)):
                    fail(f"StreamingCascadeSpotter ({name} bank) stream {i}: card {got} "
                         f"against the CPU's {h_got}")
                held_cpu += 1
            if i not in s1_parts:
                if not near_spots(got, want[i], 3):
                    fail(f"StreamingCascadeSpotter ({name} bank) stream {i}: {got} against "
                         f"offline {want[i]}")
                held += 1
        if n_ev == 0:
            fail(f"StreamingCascadeSpotter ({name} bank) gave no event to compare")
        ms = statistics.median(chunk_ms)
        print(f"cascade streaming ({name} bank, threshold {offline.threshold:.4f}): {n_ev} events "
              f"in {len(few)} streams; equal to the CPU's streaming cascade in {held_cpu} "
              f"(labels and spans, scores rtol 2e-4; streams {s1_cpu_parts} not held: their "
              f"stage-1 landmarks part between the devices); as the offline cascade's in "
              f"{held} (labels, spans within 3 frames; streams {s1_parts} not held: their "
              f"stage-1 landmarks part online by the abutting-match rule); {ms:.3f} ms a 100 "
              f"ms chunk (median of {len(chunk_ms)} feeds)", flush=True)
        out[f"streaming_{name}"] = dict(n_streams=len(few), held_cpu=held_cpu, held=held,
                                        events=n_ev, stage1_parting_streams=s1_parts,
                                        stage1_cpu_parting_streams=s1_cpu_parts, chunk_ms=ms)
    return launches


def connected_stage_ms(rec, clips, reps: int = 3) -> dict:
    """Host-clock ms of each stage of one connected pass over ``clips``
    padded to CONN_SAMPLES, each stage ended by a synchronize (median of
    ``reps``).  VAD split: pad + copy, segment features (plain MFCC, the
    splitter, the window gather), classify (kernel 1 + argmin), labels and
    segments back with the host's label lists.  Level building: pad + copy,
    whole-recording features, the DP, its planes back, the host backtrace."""
    import numpy as np
    import torch

    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.ops import level_building as lb

    cfg, s_max = rec.cfg, CONN_MAX_SEGMENTS
    f = cfg.frontend
    t_max = 1 + (CONN_SAMPLES - f.frame_len) // f.hop_len
    bank, ids = rec.device_bank()
    times: dict = {}

    def lap(key, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times.setdefault(key, []).append((t1 - t0) * 1e3)
        return t1

    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        x, n = pl.pad_signals(clips, CONN_SAMPLES, rec.device)
        t = lap("vad_pad_h2d", t)
        segs, starts, ends, n_segs = pl.extract_segments_features(x, n, cfg, s_max)
        t = lap("vad_segments", t)
        label_ids = pl.classify_features(pl._flat(segs), bank, ids, cfg=cfg)[0]
        t = lap("vad_classify", t)
        got = label_ids.cpu().reshape(len(clips), s_max)
        n_host = n_segs.cpu().numpy()
        starts.cpu(), ends.cpu()
        [rec._ids_to_labels(got[b, :int(n_host[b])]) for b in range(len(clips))]
        t = lap("vad_d2h_labels", t)
        x, n = pl.pad_signals(clips, CONN_SAMPLES, rec.device)
        t = lap("level_pad_h2d", t)
        feats = pl.extract_recording_features(x, n, cfg, t_max)
        t = lap("level_features", t)
        planes = lb.level_build(feats.feats, feats.length, bank.feats, bank.length,
                                s_max, 0.0, cfg.dtw.squared)
        t = lap("level_dp", t)
        planes = [p.cpu().numpy() for p in planes]
        lens = feats.length.cpu().numpy()
        t = lap("level_d2h", t)
        [lb.backtrack(*(p[b] for p in planes), lens[b]) for b in range(len(clips))]
        lap("level_backtrack", t)
    return {k: float(np.median(v)) for k, v in times.items()}


def connected_phase(seed: int, dev, report) -> int:
    """Phase connected: connected-word decoding (ROADMAP item 13) at full
    width; returns kernel 1's launches in the counted VAD-split pass."""
    import numpy as np
    import torch

    from dsp_tpu_torch import GmmHmmRecognizer, KnnDtwRecognizer
    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.config import DtwConfig, HmmConfig, PipelineConfig
    from dsp_tpu_torch.io import DIGITS, synth_connected, synth_word
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.models.streaming import StreamingConnectedRecognizer
    from dsp_tpu_torch.ops import level_building as lb
    from dsp_tpu_torch.ops.grammar import Grammar

    out = report["connected"]
    smi = "; ".join(report["nvidia_smi"])
    cpu = torch.device("cpu")
    cfg = PipelineConfig()
    f = cfg.frontend
    few, s_max = CONN_CPU_RECORDINGS, CONN_MAX_SEGMENTS
    rec = KnnDtwRecognizer(cfg, device=dev)
    for lab in DIGITS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(TEMPLATES_PER_WORD)])
    arrays = (np.stack(rec._bank_feats), rec._bank_lens, rec._bank_label_ids, rec.labels)
    plain = KnnDtwRecognizer.from_arrays(
        *arrays, dataclasses.replace(cfg, dtw=DtwConfig(impl="scan")), device=dev)
    host = KnnDtwRecognizer.from_arrays(*arrays, cfg, device=cpu)
    bank, ids = rec.device_bank()
    truth = [[DIGITS[(i + j) % 10] for j in range(CONN_WORDS)]
             for i in range(CONN_RECORDINGS)]
    clips = [synth_connected(w, 300 + i)[:CONN_SAMPLES] for i, w in enumerate(truth)]
    n_words = CONN_RECORDINGS * CONN_WORDS

    def accuracy(got, want=truth):
        """(share of recordings decoded exactly, word accuracy 1 - edits / words)"""
        edits = sum(pl.edit_distance(g, w) for g, w in zip(got, want))
        return (float(np.mean([g == w for g, w in zip(got, want)])),
                1.0 - edits / sum(len(w) for w in want))

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    # (a) the VAD split: one flat classify through kernel 1
    _build.reset_launches()
    (labels, starts, ends, n_segs), first_s = sync_s(
        lambda: rec.classify_connected(clips, s_max, return_segments=True))
    launches = dict(_build.LAUNCHES)
    if launches["dtw_banded"] < 1 or sum(launches.values()) != launches["dtw_banded"]:
        fail(f"connected vad: launches {launches}; expected kernel 1 only")
    p_labels = plain.classify_connected(clips, s_max)
    flat, _, _, _ = pl.segments_flat(clips, cfg, s_max, dev)
    _, p_dists = pl.classify_features(flat, *plain.device_bank(), cfg=plain.cfg)
    ties = near_ties(p_dists.cpu().numpy()).reshape(CONN_RECORDINGS, s_max)
    vad_ties = 0
    for b, (g, w) in enumerate(zip(labels, p_labels)):
        if len(g) != len(w):
            fail(f"connected vad: recording {b} has {len(g)} labels, plain {len(w)}")
        for s_i, (x, y) in enumerate(zip(g, w)):
            if x != y and not ties[b, s_i]:
                fail(f"connected vad: recording {b} segment {s_i}: {x!r} against "
                     f"the plain route's {y!r} outside a near-tie")
            vad_ties += x != y
    _, h_n, h_starts, h_ends = pl.segments_flat(clips, cfg, s_max, cpu)
    for name, g, w in (("starts", starts, h_starts), ("ends", ends, h_ends),
                       ("n_segs", n_segs, h_n)):
        if not np.array_equal(g, w):
            fail(f"connected vad: {name} differ from the CPU's")
    x, n = pl.pad_signals(clips, CONN_SAMPLES, dev)

    def vad_step():
        return pl.recognize_connected_batch(x, n, bank, ids, n_labels=len(DIGITS),
                                            cfg=cfg, max_segments=s_max)

    vad_step()
    vad_ms = statistics.median(synced_ms(vad_step, CONN_PASSES))
    vad_ops, vad_dev_ms = device_ops(vad_step)
    vad_pass = statistics.median(synced_ms(
        lambda: rec.classify_connected(clips, s_max), CONN_PASSES))
    exact, word_acc = accuracy(labels)
    out["vad"] = dict(
        launches=launches, first_pass_s=first_s, label_mismatches_at_near_ties=vad_ties,
        segments=int(n_segs.sum()), recordings_exact=exact, word_accuracy=word_acc,
        recognize_connected_batch_ms=vad_ms,
        connected_words_per_sec_per_chip=n_words / (vad_ms / 1e3),
        classify_connected_ms=vad_pass,
        classify_connected_words_per_s=n_words / (vad_pass / 1e3),
        device_ops=vad_ops, device_ms=vad_dev_ms,
        busy_share=None if vad_dev_ms is None else vad_dev_ms / vad_ms)
    print(f"connected vad: kernel 1 launches {launches['dtw_banded']}, "
          f"{int(n_segs.sum())} segments, recordings exact {exact:.4f}, word accuracy "
          f"{word_acc:.4f}, {vad_ties} labels apart from the plain route at near-ties, "
          f"segments equal to the CPU's; recognize_connected_batch {vad_ms:.3f} ms "
          f"(connected_words_per_sec_per_chip {n_words / (vad_ms / 1e3):.1f}), "
          f"{vad_ops} device ops, device time {ms_text(vad_dev_ms)}; classify_connected "
          f"{vad_pass:.3f} ms a pass ({n_words / (vad_pass / 1e3):.1f} words/s), on {smi}",
          flush=True)

    # (b) level building: plain PyTorch on the card, no kernel
    _build.reset_launches()
    (lv_labels, lv_costs), lv_first = sync_s(lambda: rec.classify_connected(
        clips, s_max, method="level", return_segments=True))
    if any(_build.LAUNCHES.values()):
        fail(f"connected level: launched {dict(_build.LAUNCHES)}; level building has no kernel")
    t_max = 1 + (CONN_SAMPLES - f.frame_len) // f.hop_len
    feats = pl.extract_recording_features(x, n, cfg, t_max)

    def dp():
        return lb.level_build(feats.feats, feats.length, bank.feats, bank.length,
                              s_max, 0.0, cfg.dtw.squared)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    planes = dp()
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    lv_ms = statistics.median(synced_ms(dp, CONN_PASSES))
    lv_ops, lv_dev_ms = device_ops(dp)
    lv_pass = statistics.median(synced_ms(
        lambda: rec.classify_connected(clips, s_max, method="level"), CONN_PASSES))
    h_planes = lb.level_build(feats.feats[:few].cpu(), feats.length[:few].cpu(),
                              bank.feats.cpu(), bank.length.cpu(), s_max, 0.0,
                              cfg.dtw.squared)
    g_costs, g_words, g_starts = (p[:few].cpu().numpy() for p in planes)
    w_costs, w_words, w_starts = (p.numpy() for p in h_planes)
    live = w_costs < lb.BIG / 2
    if not np.array_equal(g_costs < lb.BIG / 2, live):
        fail("connected level: the planes' BIG pattern differs from the CPU's")
    cost_err = float(np.max(np.abs(g_costs[live] - w_costs[live]) / np.abs(w_costs[live])))
    if cost_err > CONN_PLANE_RTOL:
        fail(f"connected level: costs {cost_err:.3e} relative from the CPU's")
    # a site whose word or start differs while its cost agrees is a near-tie
    plane_ties = int(((g_words != w_words) | (g_starts != w_starts))[live].sum())
    lens = feats.length.cpu().numpy()
    seq_ties = 0
    for b in range(few):
        g_seq, g_cost = lb.backtrack(g_costs[b], g_words[b], g_starts[b], lens[b])
        w_seq, w_cost = lb.backtrack(w_costs[b], w_words[b], w_starts[b], lens[b])
        if g_seq != w_seq:
            if abs(g_cost - w_cost) > 1e-4 * abs(w_cost):
                fail(f"connected level: recording {b} decodes to {g_seq}, the CPU to {w_seq}")
            seq_ties += 1
    exact_lv, word_acc_lv = accuracy(lv_labels)
    out["level"] = dict(
        first_pass_s=lv_first, recordings_exact=exact_lv, word_accuracy=word_acc_lv,
        level_build_ms=lv_ms, level_building_words_per_sec_per_chip=n_words / (lv_ms / 1e3),
        classify_connected_ms=lv_pass,
        classify_connected_words_per_s=n_words / (lv_pass / 1e3),
        device_ops=lv_ops, device_ms=lv_dev_ms,
        busy_share=None if lv_dev_ms is None else lv_dev_ms / lv_ms,
        peak_gb=peak_gb, cost_max_rel_err=cost_err, plane_sites=int(live.sum()),
        plane_ties=plane_ties, sequence_ties=seq_ties)
    print(f"connected level: recordings exact {exact_lv:.4f}, word accuracy "
          f"{word_acc_lv:.4f}; planes of {few} recordings against the CPU: costs "
          f"{cost_err:.3e} relative, {plane_ties} of {int(live.sum())} live sites apart "
          f"at near-ties, {seq_ties} sequences apart at near-ties; level_build "
          f"{lv_ms:.3f} ms (level_building_words_per_sec_per_chip "
          f"{n_words / (lv_ms / 1e3):.1f}), {lv_ops} device ops, device time "
          f"{ms_text(lv_dev_ms)}, peak {peak_gb:.3f} GB above the resident; "
          f"classify_connected {lv_pass:.3f} ms a pass "
          f"({n_words / (lv_pass / 1e3):.1f} words/s), on {smi}", flush=True)

    stages = connected_stage_ms(rec, clips)
    out["stage_ms"] = stages
    print("connected one pass by stage, ms (median of 3): "
          + "  ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)

    # (c) a word-pair grammar (no immediate repeats) in the DP
    grammar = Grammar.no_repeat(DIGITS)
    gr_labels, gr_s = sync_s(lambda: rec.classify_connected(
        clips, s_max, method="level", grammar=grammar))
    h_gr = host.classify_connected(clips[:few], s_max, method="level", grammar=grammar)
    if gr_labels[:few] != h_gr:
        fail(f"connected grammar: {gr_labels[:few]} against the CPU's {h_gr}")
    out["grammar"] = dict(seconds=gr_s, recordings_exact=accuracy(gr_labels)[0],
                          word_accuracy=accuracy(gr_labels)[1])
    print(f"connected grammar (no_repeat): {gr_s:.3f} s a pass, recordings exact "
          f"{accuracy(gr_labels)[0]:.4f}, the first {few} equal to the CPU's", flush=True)

    # (d) the GMM-HMM family at the default HmmConfig, on the same parameters
    hmm = GmmHmmRecognizer(cfg, HmmConfig(), device=dev)
    hmm.fit({lab: [synth_word(lab, i) for i in range(HMM_TRAIN_PER_WORD)] for lab in DIGITS})
    hmm_host = GmmHmmRecognizer(cfg, HmmConfig(), device=cpu)
    hmm_host.labels = hmm.labels
    hmm_host.params = pg.params_from_numpy(pg.params_to_numpy(hmm.params), cpu)
    hmm_host.ubm = pg.ubm_from_numpy([a.cpu().numpy() for a in hmm.ubm], cpu)
    out["hmm"] = {}
    for method in ("vad", "level"):
        got, secs = sync_s(lambda: hmm.classify_connected(clips, s_max, method=method))
        want = hmm_host.classify_connected(clips[:few], s_max, method=method)
        if got[:few] != want:
            fail(f"connected hmm {method}: {got[:few]} against the CPU's {want}")
        exact_h, word_acc_h = accuracy(got)
        out["hmm"][method] = dict(seconds=secs, recordings_exact=exact_h,
                                  word_accuracy=word_acc_h)
        print(f"connected hmm {method}: {secs:.3f} s a pass "
              f"({n_words / secs:.1f} words/s), recordings exact {exact_h:.4f}, word "
              f"accuracy {word_acc_h:.4f}, the first {few} equal to the CPU's", flush=True)

    # (e) online gapless decoding, one [1, F] row a DP call
    streams = [synth_connected([DIGITS[(i + j) % 10] for j in range(CONN_WORDS)], 400 + i,
                               gap_ms=(0.0, 1.0), lead_ms=(120.0, 130.0))
               for i in range(CONN_STREAMS)]
    offline = rec.classify_connected(streams, s_max, method="level")
    _build.reset_launches()
    speech_ms, silence_ms, ops_chunk, dev_chunk = [], [], None, None
    for i, sig in enumerate(streams):
        sig = np.concatenate([sig, np.zeros((-len(sig)) % STREAM_CHUNK + 3 * STREAM_CHUNK,
                                            np.float32)])
        sc = StreamingConnectedRecognizer(rec, STREAM_CHUNK, max_levels=s_max)
        events = []
        for c, lo in enumerate(range(0, len(sig), STREAM_CHUNK)):
            part = sig[lo:lo + STREAM_CHUNK]
            fed = sc._utt["fed"] if sc._utt is not None else 0
            if i == 0 and c == CONN_PROFILED_CHUNK:
                ops_chunk, dev_chunk = device_ops(lambda: events.extend(sc.feed(part)))
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sc.feed(part)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            # the DP ran in this chunk: the open utterance took frames, or closed
            dp_ran = bool(got) or (sc._utt is not None and sc._utt["fed"] > fed)
            (speech_ms if dp_ran else silence_ms).append(ms)
            events += got
        events += sc.flush()
        words = [w for ev in events for w in ev[0]]
        if words != offline[i]:
            fail(f"connected streaming: stream {i} gave {events}; offline level {offline[i]}")
    if any(_build.LAUNCHES.values()):
        fail(f"connected streaming: launched {dict(_build.LAUNCHES)}")
    s_ms = statistics.median(speech_ms)
    out["streaming"] = dict(
        speech_chunk_ms=s_ms, silence_chunk_ms=statistics.median(silence_ms),
        speech_chunks=len(speech_ms), device_ops_a_speech_chunk=ops_chunk,
        device_ms_a_speech_chunk=dev_chunk, offline_equal=CONN_STREAMS)
    print(f"connected streaming: {CONN_STREAMS} of {CONN_STREAMS} gapless streams "
          f"equal to the offline level decode; {s_ms:.3f} ms a 100 ms chunk with the DP "
          f"fed ({len(speech_ms)} chunks; real-time factor {100.0 / s_ms:.1f}), "
          f"{statistics.median(silence_ms):.3f} ms without; a speech chunk "
          f"{ops_chunk} device ops, device time {ms_text(dev_chunk)}", flush=True)
    return launches["dtw_banded"]


def remainder_phase(seed: int, dev, report) -> int:
    """Phase remainder: LPCC features, template condensing, the VQ
    recognizer, the windowed and bidirectional DTW, ``extract_mfcc`` and
    the exact-rFFT path (ROADMAP item 14) at config 1's shapes; returns
    kernel 1's launches in its counted runs."""
    import numpy as np
    import torch

    import dsp_tpu_torch
    from dsp_tpu_torch import KnnDtwRecognizer, VqRecognizer
    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.config import DtwConfig, FrontendConfig, PipelineConfig, VqConfig
    from dsp_tpu_torch.io import DIGITS, synth_connected, synth_word
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.models import vq as tvq
    from dsp_tpu_torch.ops import align as talign
    from dsp_tpu_torch.ops import dtw as tdtw
    from dsp_tpu_torch.ops import dtw_banded as tbanded
    from dsp_tpu_torch.ops import frontend as fe

    out = report["remainder"]
    smi = "; ".join(report["nvidia_smi"])
    cpu = torch.device("cpu")
    bank_sigs = {lab: [synth_word(lab, i) for i in range(TEMPLATES_PER_WORD)]
                 for lab in DIGITS}
    queries, truth = synth_batch(N_QUERIES, 1000)
    chunks = -(-N_QUERIES // 256)
    total = 0
    t_phase = time.perf_counter()
    laps = {}

    def lap(name):
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())

    def accuracy(labels):
        return float(np.mean([a == b for a, b in zip(labels, truth)]))

    def counted(fn):
        """fn's result and the launches it made, counted from 0."""
        torch.cuda.synchronize()
        _build.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        return got, {k: v for k, v in _build.LAUNCHES.items() if v}

    def pass_s(fn):
        return statistics.median(synced_ms(fn, REM_PASSES)) / 1e3

    def labels_vs_plain(what, got, plain):
        """Labels against the plain route's (near-ties excepted); returns
        the count apart at near-ties."""
        p_labels, p_dists = plain.classify_batch(queries, return_distances=True)
        diff = np.array([a != b for a, b in zip(got, p_labels)])
        if (diff & ~near_ties(p_dists)).any():
            fail(f"remainder {what}: {int((diff & ~near_ties(p_dists)).sum())} labels "
                 "differ from the plain route's outside near-ties")
        return int(diff.sum())

    def bank_arrays(rec):
        return (np.stack(rec._bank_feats), rec._bank_lens, rec._bank_label_ids, rec.labels)

    def scan_cfg(cfg):
        return dataclasses.replace(cfg, dtw=DtwConfig(impl="scan"))

    # (1) LPCC features: plain PyTorch on the card, kernel 1 for the DTW
    lpcc = PipelineConfig(frontend=FrontendConfig(feature_type="lpcc"))
    rec = KnnDtwRecognizer(lpcc, device=dev)
    for lab in DIGITS:
        rec.enroll(lab, bank_sigs[lab])
    arrays = bank_arrays(rec)
    labels, launches = counted(lambda: rec.classify_batch(queries))
    if launches != {"dtw_banded": chunks}:
        fail(f"remainder lpcc: launches {launches}; expected kernel 1 x {chunks} only")
    total += launches["dtw_banded"]
    fused_cfg = PipelineConfig(frontend=FrontendConfig(feature_type="lpcc", impl="pallas"))
    rec_p = KnnDtwRecognizer.from_arrays(*arrays, fused_cfg, device=dev)
    labels_p, launches_p = counted(lambda: rec_p.classify_batch(queries))
    if launches_p != {"dtw_banded": chunks}:
        fail(f"remainder lpcc impl='pallas': launches {launches_p}; LPCC takes no kernel 2")
    total += launches_p["dtw_banded"]
    if labels_p != labels:
        fail("remainder lpcc: impl='pallas' labels differ from impl='xla' (same features)")
    lpcc_ties = labels_vs_plain(
        "lpcc", labels, KnnDtwRecognizer.from_arrays(*arrays, scan_cfg(lpcc), device=dev))
    x, n = pl.pad_signals(queries[:256], lpcc.max_samples, dev)
    got = pl.extract_features(x, n, lpcc)
    want = pl.extract_features(x.cpu(), n.cpu(), lpcc)
    for g, w in zip(pl._endpoints(x, n, lpcc), pl._endpoints(x.cpu(), n.cpu(), lpcc)):
        if not torch.equal(g.cpu(), w):
            fail("remainder lpcc: VAD endpoints differ from the CPU's")
    g, w = got.feats.cpu().numpy(), want.feats.numpy()
    lpcc_abs = float(np.abs(g - w).max())
    lpcc_ratio = float((np.abs(g - w) / (REM_LPCC_TOL * (1.0 + np.abs(w)))).max())
    if lpcc_ratio > 1.0:
        fail(f"remainder lpcc: features {lpcc_abs:.3e} from the CPU's, past rtol/atol "
             f"{REM_LPCC_TOL}")
    seconds = pass_s(lambda: rec.classify_batch(queries))
    stages = stage_ms(rec, queries[:256])
    n_align = N_QUERIES * rec.n_templates
    out["lpcc"] = dict(launches=launches, launches_pallas=launches_p,
                       accuracy=accuracy(labels), label_mismatches_at_near_ties=lpcc_ties,
                       features_max_abs_err_vs_cpu=lpcc_abs, seconds=seconds,
                       alignments_per_s=n_align / seconds, chunk_stage_ms=stages)
    print(f"remainder lpcc: kernel 1 launches {launches['dtw_banded']} (impl='pallas': "
          f"{launches_p}), accuracy {accuracy(labels):.4f}, {lpcc_ties} labels apart from "
          f"the plain route at near-ties; features {lpcc_abs:.3e} from the CPU's (rtol/atol "
          f"{REM_LPCC_TOL}), endpoints equal; {n_align / seconds:.1f} alignments/s (median "
          f"{seconds:.4f} s of {REM_PASSES} passes); one 256-chunk, ms: "
          + "  ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f"; on {smi}", flush=True)

    lap("lpcc")

    # (2) condensing the main bank: medoids through kernel 1, DBA plain
    cfg = PipelineConfig()
    main = KnnDtwRecognizer(cfg, device=dev)
    for lab in DIGITS:
        main.enroll(lab, bank_sigs[lab])
    arrays = bank_arrays(main)
    full_labels = main.classify_batch(queries)
    align_cfg = DtwConfig(band_frac=None)
    bank, ids = main.device_bank()
    medoids, tied = [], np.zeros(len(DIGITS), bool)
    for lab_id in range(len(DIGITS)):
        rows = torch.nonzero(ids == lab_id)[:, 0]
        feats, lens = bank.feats[rows], bank.length[rows]
        mi = talign.medoid(feats, lens, align_cfg, pl.dtw_pairs)
        sums = tdtw.dtw_batch(feats.cpu(), lens.cpu(), feats.cpu(), lens.cpu(),
                              align_cfg).sum(dim=-1)
        mh = int(torch.argmin(sums))
        if mi != mh:
            if abs(float(sums[mi] - sums[mh])) > 1e-4 * abs(float(sums[mh])):
                fail(f"remainder condense: label {lab_id} medoid {mi}, the CPU's {mh}")
            tied[lab_id] = True
        medoids.append(int(rows[mi]))
    out["condense"] = {"medoid_ties": int(tied.sum())}
    for method in ("medoid", "dba"):
        rec = KnnDtwRecognizer.from_arrays(*arrays, cfg, device=dev)
        host = KnnDtwRecognizer.from_arrays(*arrays, cfg, device=cpu)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, launches = counted(lambda: rec.condense(method, n_iter=3))
        secs = time.perf_counter() - t0
        if launches != {"dtw_banded": len(DIGITS)}:
            fail(f"remainder condense {method}: launches {launches}; expected kernel 1 "
                 f"once a label ({len(DIGITS)})")
        total += launches["dtw_banded"]
        # one word's condense under the profiler (~26,000 device ops for dba):
        # its host-clock time unprofiled, then its device ops and time
        word = [KnnDtwRecognizer.from_arrays(*(a[:TEMPLATES_PER_WORD] for a in arrays[:3]),
                                             arrays[3], cfg, device=dev) for _ in range(2)]
        word_ms = synced_ms(lambda: word[0].condense(method, 3), 1)[0]
        ops, dev_ms = device_ops(lambda: word[1].condense(method, 3))
        host.condense(method, n_iter=3)
        if method == "medoid" and not np.array_equal(np.stack(rec._bank_feats),
                                                      arrays[0][medoids]):
            fail("remainder condense medoid: the bank is not the medoid templates")
        # a label whose medoid is a near-tie apart starts DBA elsewhere
        g, w = np.stack(rec._bank_feats)[~tied], np.stack(host._bank_feats)[~tied]
        center_abs = float(np.abs(g - w).max())
        center_rel = float((np.abs(g - w) / (1.0 + np.abs(w))).max())
        if (np.asarray(rec._bank_lens)[~tied] != np.asarray(host._bank_lens)[~tied]).any() \
                or not np.allclose(g, w, rtol=REM_DBA_TOL, atol=REM_DBA_TOL):
            fail(f"remainder condense {method}: centers {center_abs:.3e} from the CPU's, "
                 f"past rtol/atol {REM_DBA_TOL}")
        c_labels, c_launches = counted(lambda: rec.classify_batch(queries))
        if c_launches != {"dtw_banded": chunks}:
            fail(f"remainder condense {method}: classify launches {c_launches}")
        total += c_launches["dtw_banded"]
        c_ties = labels_vs_plain(f"condense {method}", c_labels, KnnDtwRecognizer.from_arrays(
            *bank_arrays(rec), scan_cfg(cfg), device=dev))
        c_s = pass_s(lambda: rec.classify_batch(queries))
        rate = N_QUERIES * rec.n_templates / c_s
        out["condense"][method] = dict(
            seconds=secs, launches=launches, word_ms=word_ms, word_device_ops=ops,
            word_device_ms=dev_ms, busy_share=None if dev_ms is None else dev_ms / word_ms,
            center_max_abs_err_vs_cpu=center_abs, center_max_rel_err_vs_cpu=center_rel,
            accuracy=accuracy(c_labels), full_bank_accuracy=accuracy(full_labels),
            label_mismatches_at_near_ties=c_ties, classify_launches=c_launches,
            alignments_per_s=rate, pass_seconds=c_s)
        print(f"remainder condense {method}: {secs:.3f} s (kernel 1 launches "
              f"{launches['dtw_banded']}); one word {word_ms:.3f} ms, {ops} device ops, "
              f"device time {ms_text(dev_ms)}"
              + ("" if dev_ms is None else f" (busy {dev_ms / word_ms:.3f})")
              + f"; centers {center_abs:.3e} from the CPU's (max |a-b|/(1+|b|) "
              f"{center_rel:.3e}, {int(tied.sum())} medoid near-ties); 10-template bank "
              f"accuracy {accuracy(c_labels):.4f} against the full bank's "
              f"{accuracy(full_labels):.4f}, {c_ties} labels apart from the plain route at "
              f"near-ties, {rate:.1f} alignments/s (median {c_s:.4f} s a pass); on {smi}",
              flush=True)
    feats, lens = bank.feats[:TEMPLATES_PER_WORD], bank.length[:TEMPLATES_PER_WORD]
    runs = [talign.dba_average(feats, lens, feats[0], int(lens[0]), 3, align_cfg)
            for _ in range(2)]
    if not torch.equal(runs[0], runs[1]):
        fail("remainder condense: two DBA runs on the card differ")

    lap("condense")

    # (3) the VQ recognizer at the default VqConfig
    vq_cfg = VqConfig()
    vq = VqRecognizer(cfg, vq_cfg, device=dev)
    host = VqRecognizer(cfg, vq_cfg, device=cpu)
    for lab in DIGITS:
        vq.enroll(lab, bank_sigs[lab])
        host.enroll(lab, bank_sigs[lab])
    frames, mask = vq.pooled_frames()
    init = tvq.kmeans_init(frames, mask, vq_cfg.n_codes)
    fc, mc, ic = frames.cpu(), mask.cpu(), init.cpu()
    d_host = tvq._sq_dists(fc, ic)
    a_dev = torch.argmin(tvq._sq_dists(frames, init), dim=-1).cpu()
    a_host = torch.argmin(d_host, dim=-1)
    top2 = torch.topk(d_host, 2, dim=-1, largest=False).values
    tie = (top2[..., 1] - top2[..., 0]) <= 1e-5 * top2[..., 0]
    apart = (a_dev != a_host) & (mc > 0)
    if (apart & ~tie).any():
        fail(f"remainder vq: {int((apart & ~tie).sum())} assignments of one Lloyd step "
             "differ from the CPU's outside near-ties")
    step_d, step_h = tvq.lloyd_step(frames, mask, init).cpu(), tvq.lloyd_step(fc, mc, ic)
    # codes whose members differ at a near-tie are not held to the centroid bound
    moved = torch.zeros(step_h.shape[:2], dtype=torch.bool)
    for w_i, n_i in zip(*torch.nonzero(apart, as_tuple=True)):
        moved[w_i, a_dev[w_i, n_i]] = moved[w_i, a_host[w_i, n_i]] = True
    step_abs = float((step_d - step_h).abs()[~moved].max())
    step_err = float(((step_d - step_h).abs() / (1.0 + step_h.abs()))[~moved].max())
    if step_err > REM_VQ_STEP_TOL:
        fail(f"remainder vq: one Lloyd step's centroids {step_err:.3e} (max |a-b|/(1+|b|); "
             f"{step_abs:.3e} absolute) from the CPU's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_, launches) = counted(vq.fit)
    fit_s = time.perf_counter() - t0
    host.fit()
    cb_err = float(np.abs(vq.codebooks - host.codebooks).max())
    (vq_labels, vq_d), v_launches = counted(
        lambda: vq.classify_batch(queries, return_distances=True))
    if launches or v_launches:
        fail(f"remainder vq: launched {launches or v_launches}; VQ has no kernel")
    cross = VqRecognizer(cfg, vq_cfg, device=dev)
    cross.labels, cross.codebooks = host.labels, host.codebooks
    h_labels, h_d = cross.classify_batch(queries, return_distances=True)
    fit_apart = np.array([a != b for a, b in zip(vq_labels, h_labels)])
    if (fit_apart & ~near_ties(h_d)).any():
        fail(f"remainder vq: the card's fit labels {int(fit_apart.sum())} queries apart "
             f"from a CPU fit's (codebooks {cb_err:.3e} apart)")
    clips = [synth_connected([DIGITS[(i + j) % 10] for j in range(CONN_WORDS)],
                             300 + i)[:CONN_SAMPLES] for i in range(CONN_RECORDINGS)]
    same = VqRecognizer(cfg, vq_cfg, device=cpu)
    same.labels, same.codebooks = vq.labels, vq.codebooks
    conn = vq.classify_connected(clips, CONN_MAX_SEGMENTS)
    if conn != same.classify_connected(clips, CONN_MAX_SEGMENTS):
        fail("remainder vq: classify_connected differs from the CPU's")
    conn_exact = float(np.mean([c == [DIGITS[(i + j) % 10] for j in range(CONN_WORDS)]
                                for i, c in enumerate(conn)]))
    vq_s = pass_s(lambda: vq.classify_batch(queries))
    out["vq"] = dict(fit_seconds=fit_s, accuracy=accuracy(vq_labels),
                     queries_per_s=N_QUERIES / vq_s, pass_seconds=vq_s,
                     step_assignments_apart_at_near_ties=int(apart.sum()),
                     step_centroid_max_abs_err=step_abs, step_centroid_max_rel_err=step_err,
                     codebook_max_abs_err_vs_cpu_fit=cb_err,
                     labels_apart_from_cpu_fit_at_near_ties=int(fit_apart.sum()),
                     connected_recordings_exact=conn_exact)
    print(f"remainder vq: fit {fit_s:.3f} s ({vq_cfg.n_codes} codes, {vq_cfg.n_iter} "
          f"iterations), accuracy {accuracy(vq_labels):.4f}, {N_QUERIES / vq_s:.1f} "
          f"queries/s (median {vq_s:.4f} s a pass); one Lloyd step: {int(apart.sum())} "
          f"assignments apart at near-ties, centroids {step_abs:.3e} from the CPU's "
          f"(max |a-b|/(1+|b|) {step_err:.3e}); "
          f"whole fits' codebooks {cb_err:.3e} apart, {int(fit_apart.sum())} labels apart "
          f"at near-ties; classify_connected equal to the CPU's ({conn_exact:.4f} of "
          f"{CONN_RECORDINGS} recordings exact); on {smi}", flush=True)

    lap("vq")

    # (4) the windowed and bidirectional scans against the full-width scan
    b, k, t, u = MAIN_SHAPE
    q, ql, bk, bl = dtw_inputs(np.random.default_rng([seed, 4]), dev, b, k, t, u)
    dcfg = DtwConfig()
    window = tbanded.window_for_band(dcfg.band_frac, t, u)
    runs = {"scan": lambda: tdtw.dtw_batch(q, ql, bk, bl, dcfg),
            "windowed": lambda: tbanded.dtw_batch_windowed(q, ql, bk, bl, window, dcfg),
            "bidi": lambda: tdtw.dtw_batch_bidi(q, ql, bk, bl, dcfg)}
    ref = runs["scan"]()
    out["scans"] = {"window": window}
    for name, fn in runs.items():
        if name != "scan":
            rel, abs_err, fin = compare_dtw(fn(), ref, REM_SCAN_RTOL)
            out["scans"][name] = dict(max_rel_err=rel, max_abs_err=abs_err)
        out["scans"].setdefault(name, {})["ms"] = time_ms(fn, reps=3, warmup=False)
    print(f"remainder scans at {b} x {k}, T = U = {t}: "
          + ", ".join(f"{name} {out['scans'][name]['ms']:.3f} ms" for name in runs)
          + f" (window {window}); windowed and bidi rel err "
          f"{out['scans']['windowed']['max_rel_err']:.3e} / "
          f"{out['scans']['bidi']['max_rel_err']:.3e} against the scan (rtol "
          f"{REM_SCAN_RTOL}, BIG pattern equal); on {smi}", flush=True)

    lap("scans")

    # (5) extract_mfcc and the exact-rFFT path against the DFT path
    one = dsp_tpu_torch.extract_mfcc(queries[0], cfg, device=dev)
    ref = main.extract(queries[:1])
    ref = ref.feats[0, : int(ref.length[0])].cpu().numpy()
    if one.shape != ref.shape or not np.allclose(one, ref, rtol=1e-3, atol=1e-3):
        fail("remainder: extract_mfcc differs from the recognizer's features")
    x, _ = pl.pad_signals(queries[:256], cfg.max_samples, dev)
    fft = fe.mfcc(x, cfg.frontend, use_fft=True)
    dft = fe.mfcc(x, cfg.frontend)
    fft_err = float((fft - dft).abs().max())
    if not torch.allclose(fft, dft, rtol=1e-3, atol=1e-3):
        fail(f"remainder: mfcc(use_fft=True) {fft_err:.3e} from the DFT path")
    out["mfcc_fft_max_abs_err"] = fft_err
    lap("mfcc")
    out["section_seconds"] = laps
    print(f"remainder: extract_mfcc equal to the recognizer's features ({one.shape}); "
          f"mfcc(use_fft=True) {fft_err:.3e} from the DFT path on {x.shape[0]} "
          f"utterances; the phase {sum(laps.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + ")", flush=True)
    return total


def walk_counts(strips, cost_cells, lens_a, lens_b, pad_a: int, pad_b: int):
    """(costs computed, lane-steps) of kernel 4 or 3 for these lengths, from
    the walk its wrapper module states (``strips``, ``cost_cells``)."""
    computed = lane_steps = 0
    for a in lens_a.tolist():
        for c in lens_b.tolist():
            computed += cost_cells(a, c, pad_a, pad_b)
            lane_steps += 32 * sum(n for _, _, n in strips(a, c, pad_a, pad_b))
    return computed, lane_steps


def block_warps(module, run, plan, pad: int, f: int) -> dict:
    """Kernel 4 or 3 (``module``, its wrapper) with its launch plan capped at
    each of BLOCK_WARPS_TIMED warps a block: the warps a block the plan
    takes (``plan()``), the time (``run()``), warps resident an SM and
    registers a thread (CUDA's occupancy calculator)."""
    out, chosen = {}, module.BLOCK_WARPS
    try:
        for cap in BLOCK_WARPS_TIMED:
            module.BLOCK_WARPS = cap
            warps = plan()
            ms = time_ms(run)
            resident, regs = module.occupancy(pad, f, warps)
            print(f"{module.__name__.rsplit('.', 1)[1]} at most {cap} warps a block ({warps} "
                  f"taken): kernel {ms:.3f} ms  {resident} warps an SM ({regs} registers a "
                  f"thread)", flush=True)
            out[cap] = dict(warps=warps, ms=ms, warps_per_sm=resident, registers=regs)
    finally:
        module.BLOCK_WARPS = chosen
    return out


def mesh_phase(seed: int, dev, report) -> dict:
    """Phase mesh: the ('data', 'bank') mesh on a one-rank NCCL group
    (ROADMAP item 15); returns the counted launches of its kernels."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dsp_tpu_torch import (GmmHmmRecognizer, KeywordSpotter, KnnDtwRecognizer,
                               VqRecognizer)
    from dsp_tpu_torch.config import FrontendConfig, HmmConfig, PipelineConfig
    from dsp_tpu_torch.io import DIGITS, synth_connected, synth_spotting_stream, synth_word
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.ops import frontend as fe
    from dsp_tpu_torch.ops import streaming as st
    from dsp_tpu_torch.ops.grammar import Grammar
    from dsp_tpu_torch.parallel import em_step_sharded, make_mesh, multihost

    out = report["mesh"]
    smi = "; ".join(report["nvidia_smi"])
    t_phase = time.perf_counter()
    multihost.initialize()                     # no torchrun environment: a no-op
    mesh = make_mesh(1, 1)
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        fail(f"mesh: backend {dist.get_backend()} on {mesh.device_type}; "
             "expected nccl on cuda")
    counted = {"dtw_banded": 0, "mfcc_fused": 0, "spot_subseq": 0}

    def run(fn):
        """fn() with the launch counts reset just before and read just after."""
        torch.cuda.synchronize()
        _build.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        return got, dict(_build.LAUNCHES)

    def from_bank(rec, cfg=None, k=None, mesh=None):
        return KnnDtwRecognizer.from_arrays(
            np.stack(rec._bank_feats), rec._bank_lens, rec._bank_label_ids,
            rec.labels, cfg or rec.cfg, k=k or rec.k, device=dev, mesh=mesh)

    # (a) config 4 at full width
    cfg = PipelineConfig()
    plain = KnnDtwRecognizer(cfg, device=dev)
    for w in MESH_WORDS:
        plain.enroll(w, [synth_word(w, i) for i in range(MESH_TEMPLATES_PER_WORD)])
    meshed = from_bank(plain, mesh=mesh)
    truth = [MESH_WORDS[i % len(MESH_WORDS)] for i in range(N_QUERIES)]
    queries = [synth_word(w, 1000 + i) for i, w in enumerate(truth)]
    (labels_u, d_u), l_u = run(lambda: plain.classify_batch(queries, return_distances=True))
    (labels_m, d_m), l_m = run(lambda: meshed.classify_batch(queries, return_distances=True))
    l_m = {k: v for k, v in l_m.items() if v}
    if labels_m != labels_u:
        fail(f"mesh config 4: {sum(a != b for a, b in zip(labels_m, labels_u))} "
             "labels differ from the unsharded pass")
    gap = float(np.max(np.abs(d_m - d_u) / np.maximum(np.abs(d_u), 1e-30)))
    if gap > MESH_DIST_RTOL:
        fail(f"mesh config 4: distances {gap:.3e} apart (> {MESH_DIST_RTOL})")
    if l_m.get("dtw_banded", 0) != l_u["dtw_banded"] or l_u["dtw_banded"] < 1:
        fail(f"mesh config 4: kernel 1 launched {l_m.get('dtw_banded', 0)} times under the "
             f"mesh, {l_u['dtw_banded']} without")
    counted["dtw_banded"] += l_m["dtw_banded"]
    lab3 = [r.classify_batch(queries) for r in (from_bank(plain, k=3),
                                                from_bank(plain, k=3, mesh=mesh))]
    if lab3[0] != lab3[1]:
        fail("mesh config 4: k = 3 labels differ from the unsharded vote")
    # timed in turns (plain, mesh, mesh, plain) x MESH_PASSES: host stages
    # drift within a call
    passes = {"plain": [], "mesh": []}
    for _ in range(MESH_PASSES):
        for name in ("plain", "mesh", "mesh", "plain"):
            rec = meshed if name == "mesh" else plain
            passes[name] += [v / 1e3 for v in synced_ms(lambda: rec.classify_batch(queries), 1)]
    rates = {name: dict(seconds=statistics.median(secs), pass_seconds=secs,
                        alignments_per_s=len(queries) * plain.n_templates
                        / statistics.median(secs))
             for name, secs in passes.items()}
    acc = float(np.mean([a == b for a, b in zip(labels_m, truth)]))
    fused_cfg = dataclasses.replace(cfg, frontend=FrontendConfig(impl="pallas"))
    fl_u = from_bank(plain, fused_cfg).classify_batch(queries[:256])
    fused = from_bank(plain, fused_cfg, mesh=mesh)
    fl_m, l_f = run(lambda: fused.classify_batch(queries[:256]))
    l_f = {k: v for k, v in l_f.items() if v}
    if fl_m != fl_u or l_f.get("mfcc_fused", 0) < 1 or l_f.get("dtw_banded", 0) < 1:
        fail(f"mesh fused front-end: launches {l_f}, labels equal {fl_m == fl_u}")
    counted["dtw_banded"] += l_f["dtw_banded"]
    counted["mfcc_fused"] += l_f["mfcc_fused"]
    print(f"mesh config 4 ({smi}): {len(queries)} queries x {plain.n_templates} "
          f"templates, labels equal, distances {gap:.3e} apart, kernel 1 x "
          f"{l_m['dtw_banded']} with and without the mesh, k = 3 equal, accuracy "
          f"{acc:.4f}; sc2_style_35class_alignments_per_sec "
          f"{rates['mesh']['alignments_per_s']:.1f} on the mesh, "
          f"{rates['plain']['alignments_per_s']:.1f} without (medians of "
          f"{2 * MESH_PASSES} passes in turns); fused front-end under the mesh: {l_f}",
          flush=True)
    out["config4"] = dict(dist_rel_gap=gap, launches=l_m, accuracy=acc, rates=rates,
                          fused_launches=l_f)

    # (b) spotting over the meshed recognizer
    srec = KnnDtwRecognizer(cfg, device=dev)
    for lab in SPOT_KEYWORDS:
        srec.enroll(lab, [synth_word(lab, i) for i in range(SPOT_TEMPLATES_PER_WORD)])
    streams = [synth_spotting_stream(SPOT_KEYWORDS, DIGITS, seed * 1000 + i, n_words=8)[0]
               for i in range(MESH_SPOT_STREAMS)]
    sp_u, sp_m = KeywordSpotter(srec), KeywordSpotter(from_bank(srec, mesh=mesh))
    want = sp_u.scores(streams)
    got, l_s = run(lambda: sp_m.scores(streams))
    l_s = {k: v for k, v in l_s.items() if v}
    if l_s.get("spot_subseq", 0) < 1:
        fail(f"mesh spotting: launches {l_s}; kernel 3 did not launch")
    counted["spot_subseq"] += l_s["spot_subseq"]
    b_lens = np.asarray(srec._bank_lens)
    flips, norm_err = 0, 0.0
    for i, ((gn, gs), (wn, ws)) in enumerate(zip(got, want)):
        res = compare_spot((gn[None], gs[None]), (wn[None], ws[None]), [gn.shape[-1]],
                           b_lens, f"mesh spotting stream {i}")
        flips += res["witness_flips"]
        norm_err = max(norm_err, res["max_rel_err"])
    # the mesh path sub-batches the streams by the plain route's cost
    # budget, as the JAX package does, so the features' GEMMs run at other
    # batch shapes: events equal by (label, start, end), scores as phase
    # spotter holds them
    ev_u, ev_m = sp_u.spot(streams), sp_m.spot(streams)
    same = all([e[:3] for e in a] == [e[:3] for e in b]
               and all(abs(x[3] - y[3]) <= 2e-4 * abs(y[3]) + 1e-5 for x, y in zip(a, b))
               for a, b in zip(ev_m, ev_u))
    if not same and flips == 0:
        fail("mesh spotting: events differ from the unsharded spotter's")
    print(f"mesh spotting: {len(streams)} streams x {srec.n_templates} templates, "
          f"kernel 3 x {l_s['spot_subseq']}, norms {norm_err:.3e} apart ({flips} witness "
          f"flips at near-ties), {sum(map(len, ev_m))} events equal: {same}", flush=True)
    out["spot"] = dict(launches=l_s, witness_flips=flips, norm_rel_err=norm_err,
                       events_equal=same)

    # (c) connected words
    crec = KnnDtwRecognizer(cfg, device=dev)
    for lab in DIGITS:
        crec.enroll(lab, [synth_word(lab, i) for i in range(TEMPLATES_PER_WORD)])
    cmesh = from_bank(crec, mesh=mesh)
    words = [[DIGITS[(i + j) % 10] for j in range(CONN_WORDS)]
             for i in range(MESH_CONN_RECORDINGS)]
    clips = [synth_connected(w, 300 + i)[:CONN_SAMPLES] for i, w in enumerate(words)]
    conn = {}
    for name, kw in (("vad", {}), ("level", {"method": "level"}),
                     ("grammar", {"method": "level", "grammar": Grammar.no_repeat(DIGITS)})):
        t0 = time.perf_counter()
        a = crec.classify_connected(clips, CONN_MAX_SEGMENTS, **kw)
        t1 = time.perf_counter()
        b = cmesh.classify_connected(clips, CONN_MAX_SEGMENTS, **kw)
        t2 = time.perf_counter()
        if a != b:
            fail(f"mesh connected {name}: labels differ from the unsharded decode")
        conn[name] = dict(seconds=t1 - t0, mesh_seconds=t2 - t1,
                          exact=float(np.mean([g == w for g, w in zip(b, words)])))
    print("mesh connected: labels equal; " + "; ".join(
        f"{k} {v['mesh_seconds']:.3f} s on the mesh, {v['seconds']:.3f} s without, "
        f"{v['exact']:.3f} exact" for k, v in conn.items()), flush=True)
    out["connected"] = conn

    # (d) training and decode at phase hmm's configuration
    hmm = HmmConfig()
    train = {lab: [synth_word(lab, i) for i in range(HMM_TRAIN_PER_WORD)] for lab in DIGITS}
    hq, htruth = synth_batch(MESH_HMM_QUERIES, 1000)
    h_u = GmmHmmRecognizer(cfg, hmm, device=dev)
    h_m = GmmHmmRecognizer(cfg, hmm, device=dev, mesh=mesh)
    secs = {}
    for name, rec, kw in (("plain", h_u, {}), ("mesh", h_m, {"mesh": mesh})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.fit(train, **kw)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    feats_w, lens_w = pg.stack_words([h_u.extract(train[lab]) for lab in h_u.labels], dev)
    w, n, t, f = feats_w.shape
    p0 = pg.init_params(feats_w, lens_w, hmm, pg.word_jitter(hmm, w, f, dev))
    p0w = pg.HmmParams(*(a[0] for a in p0))
    s_m, ll_m = em_step_sharded(mesh, feats_w[0], lens_w[0], p0w, hmm)
    s_u, ll_u = pg._em_iteration(feats_w[0], lens_w[0], p0w, hmm)
    step_err = max(params_err(s_m, s_u),
                   abs(float(ll_m) - float(ll_u)) / (1 + abs(float(ll_u))))
    if step_err > HMM_STEP_TOL:
        fail(f"mesh EM: one sharded step parts from the unsharded one by {step_err:.3e}")
    fw_err = params_err(pg.fit_word(feats_w[0], lens_w[0], hmm, mesh=mesh),
                        pg.fit_word(feats_w[0], lens_w[0], hmm))
    if fw_err > HMM_STEP_TOL:
        fail(f"mesh fit_word: parts from the unsharded fit by {fw_err:.3e}")
    fit_err = params_err(h_m.params, h_u.params)
    lab_u = h_u.classify_batch(hq)
    h_fit = GmmHmmRecognizer(cfg, hmm, device=dev)
    h_fit.labels, h_fit.params = h_m.labels, h_m.params
    lab_fit, s_fit = h_fit.classify_batch(hq, return_scores=True)
    lab_dec, s_dec = h_m.classify_batch(hq, return_scores=True)
    if lab_fit != lab_u:
        fail("mesh fit: labels of the mesh-fitted models differ from the unsharded fit's")
    dec_gap = float(np.max(np.abs(s_dec - s_fit) / np.abs(s_fit)))
    if lab_dec != lab_fit or dec_gap > MESH_DIST_RTOL:
        fail(f"mesh decode: labels equal {lab_dec == lab_fit}, scores {dec_gap:.3e} apart")
    h_acc = float(np.mean([a == b for a, b in zip(lab_dec, htruth)]))
    print(f"mesh hmm: one E-step + M-step {step_err:.3e} from the unsharded (held at "
          f"{HMM_STEP_TOL}), fit_word {fw_err:.3e}, fit {fit_err:.3e} ({secs['mesh']:.3f} s "
          f"on the mesh, {secs['plain']:.3f} s without), labels equal, decode scores "
          f"{dec_gap:.3e} apart, accuracy {h_acc:.4f}", flush=True)
    out["hmm"] = dict(e_step_err=step_err, fit_word_err=fw_err, fit_err=fit_err,
                      fit_seconds=secs, decode_gap=dec_gap, accuracy=h_acc)

    # (e) VQ, streams and the cross-process helpers
    vq = VqRecognizer(cfg, device=dev)
    vq.fit({lab: train[lab][:4] for lab in DIGITS})
    v_u, vd_u = vq.classify_batch(hq, return_distances=True)
    vq.mesh = mesh
    v_m, vd_m = vq.classify_batch(hq, return_distances=True)
    vq_gap = float(np.max(np.abs(vd_m - vd_u) / np.abs(vd_u)))
    if v_m != v_u or vq_gap > MESH_DIST_RTOL:
        fail(f"mesh vq: labels equal {v_m == v_u}, distortions {vq_gap:.3e} apart")
    fcfg = cfg.frontend
    mats = fe.make_matrices(fcfg, dev)
    sig = np.stack([synth_word(DIGITS[i % 10], 5000 + i)[: STREAM_CHUNK * MESH_STREAM_CHUNKS]
                    for i in range(MESH_STREAMS)])
    chunks = torch.from_numpy(sig.reshape(MESH_STREAMS, MESH_STREAM_CHUNKS, STREAM_CHUNK))
    state_u = st.init_state_batch(MESH_STREAMS, fcfg, STREAM_CHUNK, dev)
    state_m, chunks_m = st.shard_streams(mesh, state_u, chunks)
    chunks_u = chunks.to(dev)
    ends = 0
    for c in range(MESH_STREAM_CHUNKS):
        state_u, o_u = st.process_chunk_batch(state_u, chunks_u[:, c].contiguous(), mats,
                                              fcfg, chunk_len=STREAM_CHUNK)
        state_m, o_m = st.process_chunk_batch(state_m, chunks_m[:, c].contiguous(), mats,
                                              fcfg, chunk_len=STREAM_CHUNK)
        for name, a, b in zip(o_u._fields, o_u, o_m):
            if not torch.equal(a, b):
                fail(f"mesh streams: chunk {c} {name} differs from the unsharded run")
        ends += int(o_m.utt_end.sum())
    if not multihost.is_primary() or not multihost.all_hosts_agree(acc):
        fail("mesh: is_primary() or all_hosts_agree(accuracy) is false on one rank")
    print(f"mesh vq: labels equal, distortions {vq_gap:.3e} apart; streams: "
          f"{MESH_STREAMS} x {MESH_STREAM_CHUNKS} chunks equal ({ends} utterance ends); "
          f"is_primary and all_hosts_agree hold; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    out["vq_gap"], out["stream_utterance_ends"] = vq_gap, ends
    out["launches"] = counted
    out["seconds"] = time.perf_counter() - t_phase
    dist.destroy_process_group()
    return counted


def cli_phase(dev, report) -> dict:
    """Phase cli: ``python -m dsp_tpu_torch``'s subcommands (ROADMAP items
    16a and 20) run in-process at the default device (the card), each held
    against ``--device cpu``; returns the counted launches of its kernels."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from dsp_tpu_torch import cli
    from dsp_tpu_torch.io import native
    from dsp_tpu_torch.io.dataset import load_corpus_dir
    from dsp_tpu_torch.io.wav import read_wav
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.models import KeywordSpotter, KnnDtwRecognizer
    from dsp_tpu_torch.utils.profiling import StageTimer, trace

    out = report["cli"]
    smi = "; ".join(report["nvidia_smi"])
    t_phase = time.perf_counter()
    counted = dict.fromkeys(("dtw_banded", "spot_subseq", "dtw_fused", "dtw_wavefront"), 0)
    timer = StageTimer()
    launches = {}

    def run(name, argv, stdin=None, cpu=False):
        """stdout of ``cli.main(argv)`` on the card (counted, timed as
        ``name``) or, with ``cpu``, under ``--device cpu``."""
        buf = io.StringIO()
        old_stdin = sys.stdin
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            if cpu:
                with contextlib.redirect_stdout(buf):
                    cli.main(["--device", "cpu", *argv])
                return buf.getvalue()
            torch.cuda.synchronize()
            _build.reset_launches()
            with timer.time(name), contextlib.redirect_stdout(buf):
                cli.main(argv)
            torch.cuda.synchronize()
        finally:
            sys.stdin = old_stdin
        got = {k: _build.LAUNCHES[k] for k in counted if _build.LAUNCHES[k]}
        for k, n in got.items():
            counted[k] += n
        launches[name] = got
        return buf.getvalue()

    def cells(text):
        return [ln.split("\t") for ln in text.strip().splitlines()]

    def near_tie_rows(bank, cfg_args, sigs):
        """Rows whose two best CPU distances lie within 1e-4 relative
        (phase main's rule)."""
        args = cli.build_parser().parse_args(["evaluate", "--corpus", "-", "--bank", bank,
                                              *cfg_args])
        rec = KnnDtwRecognizer.load(bank, cli._pipeline_cfg(args), device="cpu")
        _, d = rec.classify_batch(sigs, return_distances=True)
        top2 = np.sort(d, axis=1)[:, :2]
        return np.abs(top2[:, 1] - top2[:, 0]) <= 1e-4 * np.abs(top2[:, 0])

    def same_labels(got, want, ties, what):
        diff = np.array([a != b for a, b in zip(got, want)])
        if len(got) != len(want) or (diff & ~ties).any():
            fail(f"cli {what}: {int((diff & ~ties).sum())} labels differ outside near-ties")
        return int(diff.sum())

    def accuracy(text):
        return float(text.rsplit("accuracy:", 1)[1].split("(")[0])

    def same_spot_lines(got, want, sigs, bank, what, atol=2e-3):
        """spot's lines per stream: labels and spans equal, scores within
        2e-4 relative (+ ``atol`` for the printed decimals), except in
        streams whose witnesses differ between the card and the CPU
        (near-ties)."""
        by = [{}, {}]
        for side, text in enumerate((got, want)):
            for c in cells(text):
                by[side].setdefault(c[0], []).append(c[1:])
        recs = [KnnDtwRecognizer.load(bank, device=d) for d in (dev, "cpu")]
        differ = 0
        for path, sig in sigs.items():
            a, b = by[0].get(path, []), by[1].get(path, [])
            same = len(a) == len(b) and all(
                x[:3] == y[:3] and (x[3] == y[3] == "" or
                                    abs(float(x[3]) - float(y[3]))
                                    <= 2e-4 * abs(float(y[3])) + atol)
                for x, y in zip((r + [""] * (4 - len(r)) for r in a),
                                (r + [""] * (4 - len(r)) for r in b)))
            if same:
                continue
            differ += 1
            w = [KeywordSpotter(r).scores([sig])[0][1] for r in recs]
            if np.array_equal(w[0], w[1]):
                fail(f"cli {what}: {path} events differ from the CPU's with no witness "
                     f"near-tie: {a} vs {b}")
        return differ

    with tempfile.TemporaryDirectory(prefix="cli_phase_") as tmp:
        d = os.path.join(tmp, "corpus")
        bank = os.path.join(tmp, "bank.npz")
        test = os.path.join(d, "test")
        run("make-corpus", ["make-corpus", "--out", d, "--spotting", str(CLI_SPOTTING),
                            "--connected", str(CLI_CONNECTED)])
        test_wavs = sorted(os.path.join(test, lab, f) for lab in os.listdir(test)
                           for f in os.listdir(os.path.join(test, lab)))
        truth = [os.path.basename(os.path.dirname(w)) for w in test_wavs]
        sigs = [read_wav(w)[1] for w in test_wavs]
        if len(test_wavs) != 10 * 5:
            fail(f"cli make-corpus: {len(test_wavs)} test files, expected 10 words x 5")
        run("enroll", ["enroll", "--corpus", os.path.join(d, "train"), "--bank", bank])

        # evaluate on the card and on the CPU; per-utterance labels through
        # recognize on every test file, under phase main's tie-aware rule
        ev_card = run("evaluate", ["evaluate", "--corpus", test, "--bank", bank])
        ev_cpu = run("evaluate", ["evaluate", "--corpus", test, "--bank", bank], cpu=True)
        rec_card = [c[1] for c in cells(run("recognize_all", ["recognize", "--bank", bank,
                                                              *test_wavs]))]
        rec_cpu = [c[1] for c in cells(run("recognize", ["recognize", "--bank", bank,
                                                         *test_wavs], cpu=True))]
        ties = near_tie_rows(bank, [], sigs)
        flips = same_labels(rec_card, rec_cpu, ties, "recognize (card vs cpu)")
        acc_card, acc_cpu = accuracy(ev_card), accuracy(ev_cpu)
        if abs(acc_card - acc_cpu) * len(sigs) > int(ties.sum()) + 1e-9 or \
                (not ties.any() and ev_card != ev_cpu):
            fail(f"cli evaluate: accuracy {acc_card} on the card, {acc_cpu} on the CPU")
        acc_rec = float(np.mean([a == b for a, b in zip(rec_card, truth)]))
        if abs(acc_rec - acc_card) > 1e-9 or acc_card < 0.9:
            fail(f"cli evaluate: accuracy {acc_card}; recognize's labels give {acc_rec}")
        three = run("recognize", ["recognize", "--bank", bank, *test_wavs[::20][:3]])
        if [c[1] for c in cells(three)] != rec_card[::20][:3]:
            fail(f"cli recognize on three files: {three!r}")

        # the unbanded and wavefront routes: labels as the default route's
        routes = {}
        for name, flags, ref in (("fused", ["--dtw-impl", "fused", "--band", "0"],
                                  ["--band", "0"]),
                                 ("pallas", ["--dtw-impl", "pallas"], [])):
            want = rec_card if not ref else [c[1] for c in cells(run(
                f"recognize_{name}_ref", ["recognize", "--bank", bank, *test_wavs, *ref]))]
            got = [c[1] for c in cells(run(f"recognize_{name}", ["recognize", "--bank", bank,
                                                                 *test_wavs, *flags]))]
            ties_r = near_tie_rows(bank, ref, sigs)
            routes[name] = dict(flips=same_labels(got, want, ties_r, f"--dtw-impl {name}"),
                                accuracy=accuracy(run(f"evaluate_{name}", [
                                    "evaluate", "--corpus", test, "--bank", bank, *flags])))
            kernel = {"fused": "dtw_fused", "pallas": "dtw_wavefront"}[name]
            if not launches[f"evaluate_{name}"].get(kernel):
                fail(f"cli evaluate --dtw-impl {name} launched {launches[f'evaluate_{name}']}")

        # connected words, spotting, the serve loop
        conn = os.path.join(d, "connected")
        ec = [run("evaluate-connected", ["evaluate-connected", "--corpus", conn, "--bank", bank],
                  cpu=cpu) for cpu in (False, True)]
        if ec[0] != ec[1]:
            fail(f"cli evaluate-connected: {ec[0]!r} on the card, {ec[1]!r} on the CPU")
        spotting = os.path.join(d, "spotting")
        spot_wavs = sorted(os.path.join(spotting, f) for f in os.listdir(spotting)
                           if f.endswith(".wav"))
        spot_sigs = {w: read_wav(w)[1] for w in spot_wavs}
        sp = [run("spot", ["spot", "--bank", bank, *spot_wavs], cpu=cpu) for cpu in (False, True)]
        spot_differ = same_spot_lines(sp[0], sp[1], spot_sigs, bank, "spot")
        es = [run("evaluate-spot", ["evaluate-spot", "--corpus", spotting, "--bank", bank],
                  cpu=cpu) for cpu in (False, True)]
        if es[0] != es[1] and not spot_differ:
            fail(f"cli evaluate-spot: {es[0]!r} on the card, {es[1]!r} on the CPU")
        f1 = float(es[0].rsplit("f1:", 1)[1].split()[0])
        lines = (f"{test_wavs[0]}\nconnected {os.path.join(conn, 'clip_000.wav')}\n"
                 f"level {os.path.join(conn, 'clip_001.wav')}\nnbest {test_wavs[1]}\n"
                 f"spot {spot_wavs[0]}\n")
        sv = [cells(run("serve", ["serve", "--bank", bank], stdin=lines, cpu=cpu))
              for cpu in (False, True)]
        if sv[0][0] != ["ready"] or len(sv[0]) != 6 or len(sv[1]) != 6:
            fail(f"cli serve: {sv[0]!r}")
        for a, b in zip(sv[0][1:4], sv[1][1:4]):
            if a[:2] != b[:2]:
                fail(f"cli serve: {a[:2]} on the card, {b[:2]} on the CPU")
        nb = [[x.split(":") for x in r[4][1].split(" ")] for r in sv]
        if [[x[0] for x in h] for h in nb] != [[x[0] for x in nb[0]]] * 2 or any(
                abs(float(x) - float(y)) > 1e-4 * abs(float(y)) + 2e-3
                for u, v in zip(*nb) for x, y in zip(u[1:], v[1:])):
            fail(f"cli serve nbest: {sv[0][4]} on the card, {sv[1][4]} on the CPU")
        spot_serve = ["\n".join("\t".join([spot_wavs[0], *ev.split(":")])
                                for ev in r[5][1].split(" ") if ev != "-") for r in sv]
        serve_differ = same_spot_lines(spot_serve[0], spot_serve[1],
                                       {spot_wavs[0]: spot_sigs[spot_wavs[0]]}, bank,
                                       "serve spot", atol=1.1e-2)

        # the native batch reader against the Python reader on the corpus
        all_wavs = sorted(os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
                          if f.endswith(".wav"))
        if native.available():
            xs = [read_wav(w, 16000)[1] for w in all_wavs]
            batch, lens, failures = native.read_wav_batch(all_wavs, 16000,
                                                          max(len(x) for x in xs))
            for i, (w, x) in enumerate(zip(all_wavs, xs)):
                if failures or lens[i] != len(x) or not np.array_equal(batch[i, : lens[i]], x):
                    fail(f"cli native reader: {w} differs from read_wav")
            reader = f"native ({native.library_path().name}) equal to read_wav on " \
                     f"{len(all_wavs)} files"
        else:
            corpus = load_corpus_dir(test)
            if sum(len(v) for v in corpus.values()) != len(test_wavs):
                fail("cli: the Python reader lost files")
            reader = "g++ missing on this host: the Python reader alone"
        print(f"cli reader: {reader}", flush=True)

        # a profiler trace of one evaluate must name kernel 1
        logdir = os.path.join(tmp, "trace")
        with trace(logdir):
            run("evaluate_traced", ["evaluate", "--corpus", test, "--bank", bank])
        with open(os.path.join(logdir, os.listdir(logdir)[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
        if not any("dtw_banded" in k for k in kernels):
            fail(f"cli trace: no dtw_banded kernel among {kernels[:20]}")

    times = timer.report()
    for k, n in counted.items():
        if n == 0:
            fail(f"cli: kernel {k} never launched in the phase's card runs")
    print(f"cli: accuracy {acc_card:.4f} (card) {acc_cpu:.4f} (cpu), label flips at near-ties "
          f"{flips}; fused {routes['fused']}, pallas {routes['pallas']}; "
          f"{ec[0].splitlines()[0]}; spot streams apart at near-ties {spot_differ} "
          f"(serve {serve_differ}); f1 {f1:.4f}; trace names "
          f"{[k for k in kernels if 'dtw_banded' in k][:1]}", flush=True)
    print(f"cli subcommand wall s on {smi} (StageTimer; card runs, synchronized): "
          + "  ".join(f"{k} {v:.3f}" for k, v in times.items()), flush=True)
    print(f"cli launches: {launches}; total {counted}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    out.update(stage_seconds=times, launches_by_subcommand=launches, launches=counted,
               accuracy=acc_card, accuracy_cpu=acc_cpu, label_flips_at_near_ties=flips,
               routes=routes, spot_streams_apart=spot_differ, f1=f1, reader=reader,
               seconds=time.perf_counter() - t_phase)
    return counted


def fused_phase(rng, long_rng, dev, report):
    """Kernel 4 (unbanded DTW from features) against its plain version and
    the banded kernel's unbanded mode at the main-path shape, and against
    its plain version at a long template and a long query."""
    import torch

    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels import dtw_fused as kfu
    from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw

    b, k, t, u = MAIN_SHAPE
    f = 39
    args = dtw_inputs(rng, dev, b, k, t, u, f)
    # unbanded: the DP visits every cell inside the lengths
    cells = int((args[1].long()[:, None] * args[3].long()[None, :]).sum())
    computed, lane_steps = walk_counts(kfu.strips, kfu.cost_cells, args[1].cpu(),
                                       args[3].cpu(), t, u)
    for name, overrides in FUSED_CASES:
        cfg = DtwConfig(band_frac=None, **overrides)
        got = kfu.dtw_batch_fused(*args, cfg)
        torch.cuda.synchronize()
        want = kfu.dtw_batch_fused_plain(*args, cfg)
        rel, abs_err, fin = compare_dtw(got, want, 1e-4, atol=1e-5)
        rel1, abs1, _ = compare_dtw(got, kdtw.dtw_batch_fused_banded(*args, cfg),
                                    1e-4, atol=1e-5)
        ms = time_ms(lambda: kfu.dtw_batch_fused(*args, cfg))
        plain_ms = time_ms(lambda: kfu.dtw_batch_fused_plain(*args, cfg), warmup=False)
        # per cell: an F-long dot product (2F) and the DP's add and two mins
        b_ms, b_by = bound(cells * (2 * f + 3), 4 * ((b * t + k * u) * f + b + k + b * k))
        print(f"fused {name:8s} B={b} K={k} T={t} U={u}: finite {fin:.4f}  max rel err "
              f"{rel:.3e}  max abs err {abs_err:.3e} (vs kernel 1 unbanded {rel1:.3e} / "
              f"{abs1:.3e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
              f"{b_ms:.4f} ms ({b_by}, {cells} cells); the kernel computes {computed} "
              f"costs ({computed / cells:.3f}x) over {lane_steps} lane-steps "
              f"({lane_steps / cells:.3f}x)", flush=True)
        report["fused"][name] = dict(shape=[b, k, t, u, f], finite_share=fin,
                                     max_rel_err=rel, max_abs_err=abs_err,
                                     vs_banded_unbanded=dict(max_rel_err=rel1,
                                                             max_abs_err=abs1),
                                     ms=ms, plain_ms=plain_ms, cells=cells,
                                     computed_costs=computed, lane_steps=lane_steps,
                                     bound_ms=b_ms, bound_by=b_by)
        if name == "default":
            report["fused"]["block_warps"] = block_warps(
                kfu, lambda: kfu.dtw_batch_fused(*args, cfg),
                lambda: kfu.launch_plan(b, u, f)[1], u, f)
    # a long template (window mode) and a long query, each refused by the
    # first design: the plain version is the reference
    for name, (b, k, t, u) in FUSED_LONG_CASES:
        cfg = DtwConfig(band_frac=None)
        largs = dtw_inputs(long_rng, dev, b, k, t, u, f)
        got = kfu.dtw_batch_fused(*largs, cfg)
        torch.cuda.synchronize()
        rel, abs_err, fin = compare_dtw(got, kfu.dtw_batch_fused_plain(*largs, cfg), 1e-4,
                                        atol=1e-5)
        ms = time_ms(lambda: kfu.dtw_batch_fused(*largs, cfg))
        plain_ms = time_ms(lambda: kfu.dtw_batch_fused_plain(*largs, cfg))
        lcells = int((largs[1].long()[:, None] * largs[3].long()[None, :]).sum())
        b_ms, b_by = bound(lcells * (2 * f + 3), 4 * ((b * t + k * u) * f + b + k + b * k))
        window, warps, _ = kfu.launch_plan(b, u, f)
        mode = f"{'window' if window else 'staged'} x{warps}"
        print(f"fused {name:8s} B={b} K={k} T={t} U={u} ({mode}): finite {fin:.4f}  max "
              f"rel err {rel:.3e}  max abs err {abs_err:.3e}  kernel {ms:.3f} ms  plain "
              f"{plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by}, {lcells} cells)", flush=True)
        report["fused"][name] = dict(shape=[b, k, t, u, f], mode=mode, finite_share=fin,
                                     max_rel_err=rel, max_abs_err=abs_err, ms=ms,
                                     plain_ms=plain_ms, cells=lcells, bound_ms=b_ms,
                                     bound_by=b_by)


def wavefront_phase(rng, dev, report):
    """Kernel 5 (wavefront DP over a masked cost) against its plain version
    at the main-path shape, and its paired entry on a cascade-shaped batch."""
    import torch

    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels import dtw_pallas as kwf
    from dsp_tpu_torch.ops import dtw as tdtw

    b, k, t, u = MAIN_SHAPE
    q, ql, bk, bl = dtw_inputs(rng, dev, b, k, t, u)
    p = b * k
    la = ql[:, None].expand(b, k).reshape(-1).contiguous()
    lb = bl[None, :].expand(b, k).reshape(-1).contiguous()
    # the kernel reads the cells i < la, j < lb of each pair, once
    cells = int((la.long() * lb.long()).sum())
    for name, overrides in WAVEFRONT_CASES:
        cfg = DtwConfig(**overrides)

        def build():
            return tdtw.masked_cost(q, ql, bk, bl, cfg).reshape(p, t, u)

        cost = build()
        torch.cuda.synchronize()
        build_ms = time_ms(build, warmup=False)
        got = kwf.dtw_from_cost_pallas(cost, la, lb)
        torch.cuda.synchronize()
        want = kwf.dtw_from_cost_plain(cost, la, lb)
        rel, abs_err, fin = compare_dtw(got, want, 1e-5)
        bit_equal = bool(torch.equal(got, want))
        if not bit_equal:
            fail(f"wavefront {name}: the kernel's bits differ from its plain version's")
        ms = time_ms(lambda: kwf.dtw_from_cost_pallas(cost, la, lb))
        plain_ms = time_ms(lambda: kwf.dtw_from_cost_plain(cost, la, lb), warmup=False)
        # per cell an add and two mins; bytes: those cells, lengths in, distances out
        b_ms, b_by = bound(3 * cells, 4 * cells + 12 * p)
        gb_s = 4 * cells / ms / 1e6
        print(f"wavefront {name:9s} P={p} T={t} U={u}: finite {fin:.4f}  bit-equal "
              f"{bit_equal}  max rel err {rel:.3e}  kernel {ms:.3f} ms ({gb_s:.1f} GB/s "
              f"over the cells read)  plain {plain_ms:.3f} ms  masked-cost build "
              f"{build_ms:.3f} ms ({cost.numel() * 4 / 1e9:.2f} GB)  bound {b_ms:.4f} ms "
              f"({b_by}, {cells} cells read of {p * t * u})", flush=True)
        report["wavefront"][name] = dict(
            shape=[p, t, u], finite_share=fin, bit_equal=bit_equal, max_rel_err=rel,
            max_abs_err=abs_err, ms=ms, read_gb_per_s=gb_s, plain_ms=plain_ms,
            cost_build_ms=build_ms, cost_bytes=cost.numel() * 4, cells_read=cells,
            bound_ms=b_ms, bound_by=b_by)
        if name == "default":
            report["wavefront"]["block_warps"] = wavefront_block_warps(cost, la, lb)
        del cost
    cfg = DtwConfig()
    m = CASCADE_SHORTLIST
    cand = torch.from_numpy(rng.integers(0, k, b * m)).to(dev)
    a, la2 = q.repeat_interleave(m, dim=0), ql.repeat_interleave(m)
    tb, lb2 = bk[cand], bl[cand]
    got = kwf.dtw_pairs_pallas(a, tb, la2, lb2, cfg)
    torch.cuda.synchronize()
    cost = tdtw.masked_cost_pairs(a, la2, tb, lb2, cfg)
    rel, abs_err, _ = compare_dtw(got, kwf.dtw_from_cost_plain(cost, la2, lb2), 1e-5)
    rel_s, abs_s, _ = compare_dtw(got, tdtw.dtw_pairs_scan(a, la2, tb, lb2, cfg), 1e-5)
    ms = time_ms(lambda: kwf.dtw_pairs_pallas(a, tb, la2, lb2, cfg))
    print(f"wavefront pairs {b}x{m}: max rel err {rel:.3e} (vs paired scan "
          f"{rel_s:.3e})  dtw_pairs_pallas (cost build + kernel) {ms:.3f} ms", flush=True)
    report["wavefront"]["cascade_pairs"] = dict(
        pairs=[b, m], max_rel_err=rel, max_abs_err=abs_err,
        vs_paired_scan=dict(max_rel_err=rel_s, max_abs_err=abs_s), ms=ms)


def wavefront_block_warps(cost, la, lb) -> dict:
    """Kernel 5 at each of WAVEFRONT_BLOCK_WARPS warps a block: its time,
    warps resident an SM and registers a thread (CUDA's occupancy
    calculator), and the share of warp time idle in a block while its
    longest pair walks on (from the lengths: a pair's chunks of 32 steps)."""
    import numpy as np

    from dsp_tpu_torch.kernels import dtw_pallas as kwf

    p, t, u = cost.shape
    a = np.clip(la.cpu().numpy().astype(np.int64), 1, t)
    b = np.clip(lb.cpu().numpy().astype(np.int64), 1, u)
    # chunks a pair walks: strips of 32 rows, each lb + (its rows - 1) steps
    chunks = np.zeros(p, np.int64)
    for r0 in range(0, t, 32):
        rows = np.clip(a - r0, 0, 32)
        chunks += np.where(rows > 0, -(-(b + rows - 1) // 32), 0)
    out, chosen = {}, kwf.BLOCK_WARPS
    try:
        for warps in WAVEFRONT_BLOCK_WARPS:
            kwf.BLOCK_WARPS = warps
            ms = time_ms(lambda: kwf.dtw_from_cost_pallas(cost, la, lb))
            resident, regs = kwf.occupancy(u, warps)
            pad = -p % warps
            blocks = np.concatenate([chunks, np.zeros(pad, np.int64)]).reshape(-1, warps)
            idle = 1.0 - chunks.sum() / (blocks.max(axis=1).sum() * warps)
            print(f"wavefront block of {warps} warps: kernel {ms:.3f} ms  {resident} warps "
                  f"an SM ({regs} registers a thread)  warp time idle behind a block's "
                  f"longest pair {idle:.3f}", flush=True)
            out[warps] = dict(ms=ms, warps_per_sm=resident, registers=regs,
                              idle_share=float(idle))
    finally:
        kwf.BLOCK_WARPS = chosen
    return out


def near_ties(dists):
    """Rows whose two smallest distances lie within 1e-4 relative."""
    import numpy as np

    top2 = np.sort(dists, axis=1)[:, :2]
    return np.abs(top2[:, 1] - top2[:, 0]) <= 1e-4 * np.abs(top2[:, 0])


def matchers_phase(dev, report) -> dict:
    """The matcher, rejection and evaluation path per route; returns each
    route's launch counts from its checked run."""
    import numpy as np
    import torch

    from dsp_tpu_torch import KnnDtwRecognizer
    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.config import DtwConfig, PipelineConfig
    from dsp_tpu_torch.io import DIGITS, synth_word
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.models.knn_dtw import NO_MATCH, REJECT
    from dsp_tpu_torch.ops import dtw as tdtw

    names = ("dtw_banded", "mfcc_fused", "spot_subseq", "dtw_fused", "dtw_wavefront")
    reset = _build.reset_launches

    def counts():
        return {name: _build.LAUNCHES[name] for name in names}

    base = KnnDtwRecognizer(device=dev)
    for lab in DIGITS:
        base.enroll(lab, [synth_word(lab, i) for i in range(TEMPLATES_PER_WORD)])
    arrays = (np.stack(base._bank_feats), base._bank_lens, base._bank_label_ids,
              base.labels)
    queries, truth = synth_batch(N_QUERIES, 1000)
    corpus = {lab: [x for x, y in zip(queries, truth) if y == lab] for lab in DIGITS}
    for w in OOV_WORDS:
        corpus[w] = [synth_word(w, 7000 + i) for i in range(OOV_PER_WORD)]
    sigs = [x for xs in corpus.values() for x in xs]
    n_oov = OOV_PER_WORD * len(OOV_WORDS)
    out, launches_of = {}, {}
    for name, dtw_kw, rec_kw, kernel in MATCHER_ROUTES:
        cfg = dataclasses.replace(PipelineConfig(), dtw=DtwConfig(**dtw_kw))
        rec = KnnDtwRecognizer.from_arrays(*arrays, cfg, device=dev, **rec_kw)
        rec.device_bank()
        torch.cuda.synchronize()
        reset()
        thr = rec.calibrate_rejection()
        result = rec.evaluate(corpus, reject=True)
        nbest = rec.classify_nbest(sigs[:256], n=3)
        torch.cuda.synchronize()
        launches = counts()
        if kernel is not None and launches[kernel] == 0:
            fail(f"matchers route {name!r} never launched {kernel}: {launches}")
        if kernel is None and any(launches.values()):
            fail(f"matchers route {name!r} launched a kernel: {launches}")
        launches_of[name] = launches
        labels, dists = rec.classify_batch(sigs, return_distances=True)
        top1 = [row[0][0] if row else NO_MATCH for row in nbest]
        if top1 != labels[:256]:
            fail(f"matchers route {name!r}: n-best top-1 differs from the label in "
                 f"{sum(a != b for a, b in zip(top1, labels))} of 256 queries")
        if not np.isfinite(dists).all() or dists.shape[0] != len(sigs):
            fail(f"matchers route {name!r}: distances {dists.shape}, non-finite")
        passes = []
        for _ in range(MATCHER_PASSES):
            reset()
            t0 = time.perf_counter()
            rec.classify_batch(sigs, reject=True)
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
        per_pass = {key: v for key, v in counts().items() if v}
        seconds = statistics.median(passes)
        conf = result["confusion"]
        in_vocab = sum(conf.get(lab, {}).get(lab, 0) for lab in DIGITS) / (len(sigs) - n_oov)
        oov_reject = conf.get(REJECT, {}).get(REJECT, 0) / n_oov
        print(f"matchers {name:8s}: threshold {thr:.4f}  accuracy {result['accuracy']:.4f} "
              f"(in-vocabulary {in_vocab:.4f}, OOV rejected {oov_reject:.4f})  "
              f"{len(sigs) / seconds:.1f} queries/s (median {seconds:.4f} s of "
              f"{MATCHER_PASSES} passes over {len(sigs)})  launches per pass {per_pass}  "
              f"checked run {({k: v for k, v in launches.items() if v})}", flush=True)
        out[name] = dict(labels=labels, dists=dists, rec=rec)
        report["matchers"][name] = dict(
            threshold=thr, accuracy=result["accuracy"], in_vocab_accuracy=in_vocab,
            oov_reject_rate=oov_reject, n_queries=len(sigs), pass_seconds=passes,
            queries_per_s=len(sigs) / seconds, launches=launches,
            launches_per_pass=per_pass)
    if report["matchers"]["default"]["in_vocab_accuracy"] < 0.9:
        fail(f"matchers: default route accuracy {report['matchers']['default']}")
    for name, ref in (("fused", "unbanded"), ("pallas", "default")):
        diff = np.array([a != b for a, b in zip(out[name]["labels"], out[ref]["labels"])])
        if (diff & ~near_ties(out[ref]["dists"])).any():
            fail(f"matchers route {name!r}: {int(diff.sum())} labels differ from route "
                 f"{ref!r} outside near-ties")
        rel, abs_err, _ = compare_dtw(torch.from_numpy(out[name]["dists"]),
                                      torch.from_numpy(out[ref]["dists"]), 1e-4, atol=1e-5)
        report["matchers"][name].update(reference=ref, label_mismatches=int(diff.sum()),
                                        max_rel_err_vs_reference=rel)
    rel, abs_err, _ = compare_dtw(torch.from_numpy(out["bucketed"]["dists"]),
                                  torch.from_numpy(out["default"]["dists"]), 1e-6)
    bit_equal = bool(np.array_equal(out["bucketed"]["dists"], out["default"]["dists"]))
    if out["bucketed"]["labels"] != out["default"]["labels"]:
        fail("matchers route 'bucketed': labels differ from the default route's")
    report["matchers"]["bucketed"].update(max_rel_err_vs_default=rel, bit_equal=bit_equal)
    # one chunk: the cascade's rerank and the LTW distances against their plain versions
    chunk = sigs[:256]
    x, n = pl.pad_signals(chunk, PipelineConfig().max_samples, dev)
    feats = pl.extract_features(x, n, PipelineConfig())
    rec = out["cascade"]["rec"]
    bank, ids = rec.device_bank()
    got_ids, d, cand = pl.classify_features_cascade(feats, bank, ids, rec.shortlist)
    flat = cand.reshape(-1)
    want_d = tdtw.dtw_pairs_scan(feats.feats.repeat_interleave(cand.shape[1], 0),
                                 feats.length.repeat_interleave(cand.shape[1]),
                                 bank.feats[flat], bank.length[flat],
                                 DtwConfig()).reshape(d.shape)
    rel_c, _, _ = compare_dtw(d, want_d, 1e-5)
    want_ids = ids[torch.take_along_dim(cand, want_d.argmin(1, keepdim=True), 1)[:, 0]]
    ties = near_ties(want_d.cpu().numpy())
    if ((got_ids != want_ids).cpu().numpy() & ~ties).any():
        fail("matchers route 'cascade': labels differ from the plain rerank's")
    ltw_ids, ltw_d = pl.classify_features_ltw(feats, bank, ids)
    cpu = lambda f: pl.Features(f.feats.cpu(), f.length.cpu())   # noqa: E731
    cpu_ids, cpu_d = pl.classify_features_ltw(cpu(feats), cpu(bank), ids.cpu())
    q = torch.cat([feats.feats.cpu(), bank.feats.cpu()])
    mag = float((q * q).sum((1, 2)).max()) / (64 * q.shape[-1])
    ltw_err = float((ltw_d.cpu() - cpu_d).abs().max())
    if ltw_err > 1e-5 * float(cpu_d.abs().max()) + 8 * float(np.finfo(np.float32).eps) * mag:
        fail(f"matchers route 'ltw': distances differ from the CPU's by {ltw_err:.3e}")
    ltw_diff = (ltw_ids.cpu() != cpu_ids).numpy() & ~near_ties(cpu_d.numpy())
    if ltw_diff.any():
        fail(f"matchers route 'ltw': {int(ltw_diff.sum())} labels differ from the CPU's")
    print(f"matchers checks: bucketed vs default distances bit-equal {bit_equal} "
          f"(max rel err {rel:.3e}); cascade rerank vs paired scan max rel err "
          f"{rel_c:.3e}; ltw vs CPU max abs err {ltw_err:.3e}", flush=True)
    report["matchers"]["cascade"]["rerank_max_rel_err_vs_scan"] = rel_c
    report["matchers"]["ltw"]["max_abs_err_vs_cpu"] = ltw_err
    return launches_of


def mb_wavefront_phase(seed: int, dev, report) -> dict:
    """Kernels 6-10: the microbenchmark entry point at its full shapes, then
    each kernel against its plain version on seeded inputs; returns the
    launch counts of the entry point's run."""
    import torch

    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.kernels import mb_wavefront as kmb
    from dsp_tpu_torch.scripts import mb_wavefront as mbw

    torch.cuda.synchronize()
    _build.reset_launches()
    runs = mbw.run("all", dev)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES["mb_" + k] for k in MB_KERNELS}
    if not all(launches.values()):
        fail(f"the mb_wavefront entry point left a kernel unlaunched: {launches}")
    rep = report["mb_wavefront"]
    rep["entry_point"] = runs

    g = torch.Generator(device=dev).manual_seed(seed)
    p, d, t, u = mbw.P, mbw.D_PAD, mbw.T_PAD, mbw.U_PAD

    def check(name, got, want, *, fn, plain, ops, n_bytes, rtol=0.0, library=None,
              reps=REPS, **extra):
        """got vs want (equal bits, or rtol), then the kernel's time (median of
        ``reps``), the plain version's (once), the library call's and the bound."""
        if got.shape != want.shape:
            fail(f"mb_wavefront {name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        same = bool(torch.equal(got, want))
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        if not same and (rtol == 0.0 or not torch.allclose(got, want, rtol=rtol, atol=0.0)):
            fail(f"mb_wavefront {name}: kernel differs from its plain version "
                 f"(max abs err {err:.3e}, rtol {rtol})")
        ms = time_ms(fn, reps)
        plain_ms = time_ms(plain, reps=1, warmup=False)
        library_ms = None if library is None else time_ms(library, reps)
        b_ms, b_by = bound(ops, n_bytes)
        lib = ("none (no single PyTorch call computes it)" if library_ms is None
               else f"{library_ms:.3f} ms")
        print(f"mb_wavefront {name:9s}: bit-equal {same}  max abs err {err:.3e}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  library {lib}  "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        rep[name] = dict(bit_equal=same, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, **extra)

    # 6, 7: one seeded array, standard normal with 5 % BIG cells; ktarget in
    # [-1, D], la in [0, T+1], so some pairs never match and some read no lane
    skew = torch.randn((p, d, t), generator=g, device=dev)
    skew.masked_fill_(torch.rand((p, d, t), generator=g, device=dev) < 0.05, mbw.BIG)
    ktarget = torch.randint(-1, d + 1, (p, 1), generator=g, device=dev, dtype=torch.int32)
    la = torch.randint(0, t + 2, (p, 1), generator=g, device=dev, dtype=torch.int32)
    read = 4 * skew.numel()
    # no single PyTorch call computes the DP, the fetch's strided sum, the
    # anatomy loop or the skew, so they have no library time
    check("dp_diet", kmb.dp_diet(skew, ktarget, la), kmb.dp_diet_plain(skew, ktarget, la),
          fn=lambda: kmb.dp_diet(skew, ktarget, la),
          plain=lambda: kmb.dp_diet_plain(skew, ktarget, la),
          ops=6 * skew.numel(), n_bytes=read + 12 * p,
          pairs_answered=int(((ktarget >= 0) & (ktarget < d) & (la >= 1) & (la <= t)).sum()))
    check("dma_fetch", kmb.dma_fetch(skew, ktarget), kmb.dma_fetch_plain(skew, ktarget),
          fn=lambda: kmb.dma_fetch(skew, ktarget),
          plain=lambda: kmb.dma_fetch_plain(skew, ktarget), rtol=1e-6,
          ops=2 * p * (d // 8), n_bytes=read + 8 * p)
    del skew, ktarget, la

    # 8: anatomy bit-equal at 64 steps for 0-2 rolls; timed at the entry
    # point's largest shape; and the trivial kernel with its library call
    pt, width = max(mbw.ANATOMY_SHAPES)
    x = torch.randn((pt, width), generator=g, device=dev)
    for n_rolls in mbw.ROLLS[:-1]:
        got = kmb.anatomy(x, n_rolls, 64)
        if not torch.equal(got, kmb.anatomy_plain(x, n_rolls, 64)):
            fail(f"mb_wavefront anatomy: rolls={n_rolls} differs from its plain version")
    steps = mbw.ANATOMY_STEPS
    cyc = runs["anatomy"]["rows"][f"{pt}x{width}_rolls2"]["cycles_per_step"]
    check("anatomy", kmb.anatomy(x, 2, 64), kmb.anatomy_plain(x, 2, 64),
          fn=lambda: kmb.anatomy(x, 2, steps), plain=lambda: kmb.anatomy_plain(x, 2, steps),
          ops=3 * steps * x.numel(), n_bytes=8 * x.numel(), shape=[pt, width, 2, steps],
          cycles_per_step=cyc)
    print(f"mb_wavefront anatomy  : {cyc:.1f} SM cycles a step at [{pt},{width}], 2 rolls "
          f"(clock64, the entry point's run)", flush=True)
    # 8's chain-latency bound: at [64, 32] a lane holds one cell, so a step
    # of 1 roll is one dependent shuffle, min and add and nothing else (the
    # one-instruction chain); at 2 rolls and more cells a lane the two
    # shuffles read other cells, so a step's dependent chain is the same
    # shuffle, min and add.  4,000 steps of it at the card's top SM clock.
    rows = runs["anatomy"]["rows"]
    chain = rows["64x32_rolls1"]["cycles_per_step"]
    shuffle = rows["64x32_rolls2"]["cycles_per_step"] - chain
    max_mhz = runs["anatomy"]["max_sm_mhz"]
    chain_ms = steps * chain / (max_mhz * 1e3)
    an = report["mb_wavefront"]["anatomy"]
    an.update(chain_cycles_per_step=chain, shuffle_cycles=shuffle, max_sm_mhz=max_mhz,
              chain_bound_ms=chain_ms)
    print(f"mb_wavefront anatomy  : chain-latency bound {chain_ms:.4f} ms ({steps} steps x "
          f"{chain:.2f} cycles of one dependent shuffle + min + add at [64,32], 1 roll; "
          f"one shuffle alone {shuffle:.2f} cycles; {max_mhz:.0f} MHz) against "
          f"{an['ms']:.4f} ms ({chain_ms / an['ms']:.1%} of it) and {cyc:.2f} cycles a step "
          f"({chain / cyc:.1%}); operations bound {an['bound_ms']:.4f} ms", flush=True)
    x0 = torch.randn((8, 128), generator=g, device=dev)
    check("trivial", kmb.trivial(x0), kmb.trivial_plain(x0), fn=lambda: kmb.trivial(x0),
          plain=lambda: kmb.trivial_plain(x0), library=lambda: x0 * 2.0,
          ops=x0.numel(), n_bytes=8 * x0.numel(), reps=LAUNCH_REPS)
    del x, x0

    # 9: transpose at E2's shape; its plain version is the library call
    x = torch.randn((p, t, d), generator=g, device=dev)
    check("transpose", kmb.transpose(x), kmb.transpose_plain(x),
          fn=lambda: kmb.transpose(x), plain=lambda: kmb.transpose_plain(x),
          library=lambda: x.transpose(1, 2).contiguous(), ops=0, n_bytes=8 * x.numel())
    del x

    # 10: skew at E3's shape
    cost = torch.randn((p, t, u), generator=g, device=dev)
    check("skew", kmb.skew(cost, d), kmb.skew_plain(cost, d),
          fn=lambda: kmb.skew(cost, d), plain=lambda: kmb.skew_plain(cost, d),
          ops=0, n_bytes=4 * (cost.numel() + p * d * t))
    del cost

    # E4 (no kernel): finite, and two queries x three templates against float64
    q = torch.randn((mbw.COST_B, t, mbw.COST_F), generator=g, device=dev)
    b = torch.randn((mbw.COST_K, u, mbw.COST_F), generator=g, device=dev)
    got = kmb.cost(q, b)
    if got.shape != (p, t, u) or not torch.isfinite(got).all():
        fail(f"mb_wavefront cost: shape {tuple(got.shape)} or non-finite values")
    want = kmb.cost(q[:2].double(), b[:3].double())
    part = got.reshape(mbw.COST_B, mbw.COST_K, t, u)[:2, :3].reshape(6, t, u).double()
    cost_err = float((part - want).abs().max())
    if not torch.allclose(part, want, rtol=1e-5, atol=1e-4):
        fail(f"mb_wavefront cost: fp32 differs from float64 by {cost_err:.3e}")
    del got
    ms = time_ms(lambda: kmb.cost(q, b))
    b_ms, b_by = bound(2 * p * t * u * mbw.COST_F,
                       4 * (q.numel() + b.numel() + p * t * u))
    print(f"mb_wavefront cost (E4, fp32 einsum, no kernel): max abs err vs float64 "
          f"{cost_err:.3e}  {ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)
    rep["cost"] = dict(max_abs_err_vs_float64=cost_err, ms=ms, bound_ms=b_ms, bound_by=b_by)
    launch_host(seed, dev, report)
    return launches


def host_us(fn, n: int) -> float:
    """Host-clock µs a call of ``fn`` over ``n`` back-to-back calls ended by
    one synchronize (time.perf_counter_ns)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / n / 1e3


def launch_host(seed: int, dev, report):
    """Where a launch's host time goes: each piece of the wrapper path over
    LAUNCH_PIECE_CALLS calls, then trivial(x) against x * 2.0 and kernel 1
    at B = K = 1 over LAUNCH_CALLS calls each."""
    import numpy as np
    import torch

    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels import _build
    from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
    from dsp_tpu_torch.kernels import mb_wavefront as kmb

    x = torch.randn((8, 128), device=dev)
    out = torch.empty_like(x)
    lib = _build.lib()
    idx = dev.index
    ptr, optr, n = x.data_ptr(), out.data_ptr(), x.numel()
    raw = torch._C._cuda_getCurrentRawStream(idx)

    def checks():   # trivial's checks, as the wrapper makes them
        return (x.dtype != torch.float32 or not kmb._on_card("trivial", x)
                or x.numel() >= 2**31)

    pieces = {
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(idx),
        # 19 arguments converted by argtypes; rb = 0 returns before any CUDA call
        "ctypes call, 19 args, no launch (dtw_banded, rb=0)":
            lambda: lib.dtw_banded(ptr, ptr, ptr, ptr, optr, 1, 1, 1, 1, 1, 1, 0, 0,
                                   0, 0, 0.0, 0, 0, raw),
        "ctypes call + launch (mb_trivial)": lambda: lib.mb_trivial(ptr, optr, n, raw),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "trivial's checks": checks,
        "_build.launch('mb_trivial')":
            lambda: _build.launch("mb_trivial", dev, ptr, optr, n),
        "kmb.trivial(x)": lambda: kmb.trivial(x),
        "x * 2.0": lambda: x * 2.0,
    }
    breakdown = {name: host_us(fn, LAUNCH_PIECE_CALLS) for name, fn in pieces.items()}
    for name, us in breakdown.items():
        print(f"launch host {name:52s}: {us:.3f} us a call "
              f"({LAUNCH_PIECE_CALLS} calls)", flush=True)
    trivial_us = host_us(lambda: kmb.trivial(x), LAUNCH_CALLS)
    library_us = host_us(lambda: x * 2.0, LAUNCH_CALLS)
    q, ql, bk, bl = dtw_inputs(np.random.default_rng(seed), dev, 1, 1, 198, 198)
    cfg = DtwConfig()
    dtw_us = host_us(lambda: kdtw.dtw_batch_fused_banded(q, ql, bk, bl, cfg), LAUNCH_CALLS)
    print(f"launch host: trivial(x) {trivial_us:.3f} us a call against x * 2.0 "
          f"{library_us:.3f} us ({trivial_us / library_us:.3f}x); "
          f"dtw_batch_fused_banded at B=K=1 (T=U=198) {dtw_us:.3f} us a call "
          f"({LAUNCH_CALLS} back-to-back calls, one synchronize)", flush=True)
    report["launch_host"] = dict(pieces_us=breakdown, piece_calls=LAUNCH_PIECE_CALLS,
                                 trivial_us=trivial_us, x_times_2_us=library_us,
                                 dtw_banded_1x1_us=dtw_us, calls=LAUNCH_CALLS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args()

    if not (ROOT / "dsp_tpu_torch" / "__init__.py").is_file():
        fail(f"dsp_tpu_torch/ not found beside {Path(__file__).name}; run it "
             "from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import dsp_tpu_torch  # noqa: F401  (sets the fp32 matmul policy)
    from dsp_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'ran' if _build.build_seconds is not None else 'skipped: cached'})",
          flush=True)

    report = {"dtw": {}, "mfcc": {}, "small": {}, "main": {}, "spot": {},
              "fused": {}, "wavefront": {}, "matchers": {}, "mb_wavefront": {},
              "streaming": {}, "hmm": {}, "cascade": {}, "connected": {},
              "remainder": {}, "mesh": {}, "cli": {}, "nvidia_smi": smi}
    rng = np.random.default_rng(args.seed)
    dtw_phase(rng, np.random.default_rng([args.seed, 1]), dev, report)
    mfcc_phase(dev, report)
    small_phase(rng, dev, report)
    launches = main_phase(dev, report)
    spot_phase(rng, np.random.default_rng([args.seed, 3]), dev, report)
    launches["spot_subseq"] = spotter_phase(args.seed, dev, report)
    fused_phase(rng, np.random.default_rng([args.seed, 2]), dev, report)
    wavefront_phase(rng, dev, report)
    routes = matchers_phase(dev, report)
    launches["dtw_fused"] = routes["fused"]["dtw_fused"]
    launches["dtw_wavefront"] = routes["pallas"]["dtw_wavefront"]
    launches.update(mb_wavefront_phase(args.seed, dev, report))
    report["streaming"]["launches"] = streaming_phase(args.seed, dev, report)
    report["hmm"]["launches"] = {"mfcc_fused": hmm_phase(args.seed, dev, report)}
    report["cascade"]["launches"] = {"spot_subseq": cascade_phase(args.seed, dev, report)}
    launches["spot_subseq"] += report["cascade"]["launches"]["spot_subseq"]
    report["connected"]["launches"] = {"dtw_banded": connected_phase(args.seed, dev, report)}
    launches["dtw_banded"] += report["connected"]["launches"]["dtw_banded"]
    report["remainder"]["launches"] = {"dtw_banded": remainder_phase(args.seed, dev, report)}
    launches["dtw_banded"] += report["remainder"]["launches"]["dtw_banded"]
    for name, n in mesh_phase(args.seed, dev, report).items():
        launches[name] += n
    for name, n in cli_phase(dev, report).items():
        launches[name] += n
    if {m.split(".")[0] for m in sys.modules} & {"jax", "dsp_tpu"}:
        fail("the port imported jax or dsp_tpu")

    def entry(name, source, replaces, measured):
        # no single PyTorch call computes banded, unbanded or wavefront DTW,
        # the MFCC chain, subsequence DTW or kernels 6-8 and 10: library_ms
        # is null for them
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": measured["max_abs_err"], "ms": measured["ms"],
                "plain_ms": measured["plain_ms"], "bound_ms": measured["bound_ms"],
                "bound_by": measured["bound_by"],
                "library_ms": measured.get("library_ms")}

    mb = report["mb_wavefront"]
    mb_src = "dsp_tpu_torch/csrc/mb_wavefront.cu"

    kernels = [
        entry("dtw_banded", "dsp_tpu_torch/csrc/dtw_banded.cu",
              "dsp_tpu/kernels/dtw_fused_banded.py:415", report["dtw"]["default"]),
        entry("mfcc_fused", "dsp_tpu_torch/csrc/mfcc_fused.cu",
              "dsp_tpu/kernels/mfcc_pallas.py:123", report["mfcc"]["default"]),
        # kernel 3 launches in phases spotter and cascade: its error is the
        # larger of phase spot's bench shape and the cascade's rerank windows
        entry("spot_subseq", "dsp_tpu_torch/csrc/spot_subseq.cu",
              "dsp_tpu/kernels/spot_fused.py:231", dict(
                  report["spot"]["bench"], max_abs_err=max(
                      report["spot"]["bench"]["max_abs_err"],
                      report["cascade"]["rerank_windows"]["max_abs_err"]))),
        entry("dtw_fused", "dsp_tpu_torch/csrc/dtw_fused.cu",
              "dsp_tpu/kernels/dtw_fused.py:191", report["fused"]["default"]),
        entry("dtw_wavefront", "dsp_tpu_torch/csrc/dtw_wavefront.cu",
              "dsp_tpu/kernels/dtw_pallas.py:126", report["wavefront"]["default"]),
        entry("dp_diet", mb_src, "scripts/mb_wavefront.py:78", mb["dp_diet"]),
        entry("dma_fetch", mb_src, "scripts/mb_wavefront.py:125", mb["dma_fetch"]),
        entry("anatomy", mb_src, "scripts/mb_wavefront.py:194", mb["anatomy"]),
        entry("trivial", mb_src, "scripts/mb_wavefront.py:179", mb["trivial"]),
        entry("transpose", mb_src, "scripts/mb_wavefront.py:216", mb["transpose"]),
        entry("skew", mb_src, "scripts/mb_wavefront.py:256", mb["skew"]),
    ]
    report["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    for line in smi:
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
