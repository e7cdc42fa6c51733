"""dsp_tpu_torch — the isolated-word recognizer of ``dsp_tpu`` in PyTorch/CUDA.

A port of the JAX package's main path (VAD -> MFCC + delta/delta-delta ->
all-pairs windowed Sakoe-Chiba DTW -> argmin / kNN vote), its matchers
(DTW, linear time warp, cascade), out-of-vocabulary rejection and
evaluation, its offline keyword spotter (subsequence DTW), its online
path (the chunked streaming front-end with a causal VAD,
``StreamingRecognizer`` and the SPRING ``StreamingSpotter``), and the
GMM-HMM recognizer (``GmmHmmRecognizer``: log-space Viterbi decode,
segmental and Baum-Welch EM with a UBM and MAP adaptation, UBM-LLR
rejection, PMC noise adaptation) with its keyword spotters
(``HmmSpotter``, ``CascadeSpotter`` and their streaming forms, in
``dsp_tpu_torch.models``), and connected-word decoding (both recognizers'
``classify_connected``: the multi-segment VAD split, or level building
and the connected Viterbi with word-pair grammars; online through
``models.streaming.StreamingConnectedRecognizer``), with five
hand-written CUDA kernels for NVIDIA Hopper: banded DTW
(``csrc/dtw_banded.cu``), the fused MFCC front-end (``csrc/mfcc_fused.cu``),
subsequence DTW (``csrc/spot_subseq.cu``), unbanded closed-form DTW
(``csrc/dtw_fused.cu``) and the wavefront DP over a masked cost
(``csrc/dtw_wavefront.cu``), plus the six kernels of the wavefront
microbenchmarks (``csrc/mb_wavefront.cu``, run by
``python -m dsp_tpu_torch.scripts.mb_wavefront``).  Each kernel has a
plain PyTorch version beside it, which CPU tensors take.  Entry points run on the card (their ``device``
defaults to ``"cuda"``) unless the caller asks for the CPU.  This package
imports neither jax nor ``dsp_tpu``.

Quick start::

    from dsp_tpu_torch import KeywordSpotter, KnnDtwRecognizer
    rec = KnnDtwRecognizer()                 # on the card
    rec.enroll("yes", [signal1, signal2])
    label = rec.recognize(test_signal)
    rec.calibrate_rejection()
    label = rec.recognize(other_signal, reject=True)   # "<reject>" if OOV
    events = KeywordSpotter(rec).spot([long_recording])
    stream = StreamingRecognizer(rec)        # 100 ms chunks at 16 kHz
    events = stream.feed(chunk_of_1600_samples)
    hmm = GmmHmmRecognizer()                 # on the card
    hmm.fit({"yes": [signal1, signal2], "no": [signal3, signal4]})
    label = hmm.recognize(test_signal)
    words = rec.classify_connected([recording])              # VAD split
    words = rec.classify_connected([recording], method="level",
                                   grammar={"no_repeat": True})
"""

import torch

# Full fp32 in every matrix product.  The records of the JAX package show
# that reduced precision breaks both kernels' arithmetic: a bf16/TF32 cost
# GEMM gave 5% DTW distance error and 50% argmin flips
# (dsp_tpu/kernels/dtw_fused_banded.py:119-122, docs/PERF.md round 2
# item 4), and reduced-precision DFT GEMMs visibly corrupt the log-mel
# cepstra (dsp_tpu/kernels/mfcc_pallas.py:72-73).  PyTorch's cuDNN
# default allows TF32, so both switches are set.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from dsp_tpu_torch.config import (  # noqa: E402
    DtwConfig,
    FrontendConfig,
    HmmConfig,
    PipelineConfig,
    VadConfig,
    VqConfig,
)
from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer  # noqa: E402
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer  # noqa: E402
from dsp_tpu_torch.models.spotter import KeywordSpotter  # noqa: E402
from dsp_tpu_torch.models.streaming import StreamingRecognizer  # noqa: E402
from dsp_tpu_torch.pipeline import (  # noqa: E402
    Features,
    classify_features,
    extract_features,
    recognize_batch,
)

__all__ = [
    "FrontendConfig", "VadConfig", "DtwConfig", "HmmConfig", "VqConfig",
    "PipelineConfig", "KnnDtwRecognizer", "GmmHmmRecognizer", "KeywordSpotter",
    "StreamingRecognizer", "Features",
    "extract_features", "classify_features", "recognize_batch",
]
