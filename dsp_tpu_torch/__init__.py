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
``models.streaming.StreamingConnectedRecognizer``), the VQ-codebook
recognizer (``VqRecognizer``), template condensing
(``KnnDtwRecognizer.condense``: medoid or DTW barycenter averaging) and
LPCC features (``FrontendConfig(feature_type="lpcc")``), multi-GPU
execution (``dsp_tpu_torch.parallel``: a ('data', 'bank') mesh on
``torch.distributed``, one process a GPU, that every ``mesh=`` argument
takes), with five
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
    rec.condense("dba")                      # one averaged template a word
    vq = VqRecognizer()                      # on the card
    vq.fit({"yes": [signal1, signal2], "no": [signal3, signal4]})
    label = vq.recognize(test_signal)

    # every process of ``torchrun --nproc-per-node=N``, the same calls:
    from dsp_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize()
    rec = KnnDtwRecognizer(mesh=make_mesh())  # the bank split over the cards
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
from dsp_tpu_torch.models.vq import VqRecognizer  # noqa: E402
from dsp_tpu_torch.pipeline import (  # noqa: E402
    Features,
    classify_features,
    extract_features,
    extract_signals,
    recognize_batch,
    recognize_connected_batch,
)

__version__ = "0.1.0"     # the JAX package's (dsp_tpu/__init__.py)


def extract_mfcc(x, cfg: PipelineConfig = PipelineConfig(),
                 device: str | torch.device = "cuda"):
    """One host signal -> numpy features [T, n_feats], VAD-trimmed (the
    reference's ``mfcc(x, sr) -> [T, C]`` surface; LPCC where
    ``cfg.frontend.feature_type`` says so)."""
    feats = extract_signals([x], cfg, device)
    return feats.feats[0, : int(feats.length[0])].cpu().numpy()


__all__ = [
    "FrontendConfig", "VadConfig", "DtwConfig", "HmmConfig", "VqConfig",
    "PipelineConfig", "KnnDtwRecognizer", "GmmHmmRecognizer", "KeywordSpotter",
    "StreamingRecognizer", "VqRecognizer", "Features",
    "extract_features", "classify_features", "recognize_batch",
    "recognize_connected_batch", "extract_mfcc", "__version__",
]
