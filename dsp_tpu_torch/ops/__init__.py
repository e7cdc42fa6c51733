"""Plain PyTorch ops of the port: front-end, VAD, DTW, alignment and DBA,
LPC, spotting, HMM Viterbi, connected-word level building and grammars.
The names below are the JAX package's ``dsp_tpu.ops`` exports."""

from dsp_tpu_torch.ops.frontend import (
    FrontendMatrices,
    add_deltas,
    deltas,
    frame,
    make_matrices,
    masked_deltas,
    mfcc,
    mfcc_from_frames,
    preemphasis,
    time_normalize,
)
from dsp_tpu_torch.ops.vad import detect_endpoints, detect_endpoints_frames
from dsp_tpu_torch.ops.dtw import (dtw_batch, dtw_batch_bidi, dtw_distance,
                                   dtw_distance_bidi, dtw_from_cost, masked_cost)
from dsp_tpu_torch.ops.viterbi import forward_score, viterbi_decode, viterbi_score
from dsp_tpu_torch.ops.align import dba_average, dtw_alignment, medoid
from dsp_tpu_torch.ops.dtw_banded import dtw_batch_windowed, window_for_band
from dsp_tpu_torch.ops.lpc import lpcc
from dsp_tpu_torch.ops.grammar import Grammar

__all__ = [
    "FrontendMatrices", "make_matrices", "preemphasis", "frame", "mfcc",
    "mfcc_from_frames", "deltas", "masked_deltas", "add_deltas",
    "detect_endpoints", "detect_endpoints_frames",
    "dtw_distance", "dtw_batch", "masked_cost", "dtw_from_cost",
    "viterbi_score", "viterbi_decode", "forward_score",
    "dtw_alignment", "dba_average", "medoid",
    "dtw_batch_bidi", "dtw_distance_bidi", "dtw_batch_windowed",
    "window_for_band", "time_normalize", "lpcc",
    "Grammar",
]
