"""Wrappers of the port's CUDA kernels, each beside its plain version.

Nothing here builds or loads a kernel at import; ``_build.lib()`` does so
at the first launch on a CUDA tensor.  The names below are the wrappers of
the JAX package's ``dsp_tpu.kernels`` functions under the port's names
(``mfcc_frames_pallas`` -> ``mfcc_frames_fused``, ...), with the banded
DTW and subsequence DTW wrappers beside them.  The signal-level
``mfcc_fused`` (the JAX package's ``mfcc_pallas``) stays in its module,
``kernels.mfcc_fused``, whose name an export would shadow; the
microbenchmark kernels' wrappers stay in ``kernels.mb_wavefront``.
"""

from dsp_tpu_torch.kernels.dtw_fused import dtw_batch_fused
from dsp_tpu_torch.kernels.dtw_fused_banded import dtw_batch_fused_banded
from dsp_tpu_torch.kernels.dtw_pallas import (dtw_batch_pallas, dtw_from_cost_pallas,
                                              dtw_pairs_pallas, skew_cost)
from dsp_tpu_torch.kernels.mfcc_fused import mfcc_frames_fused
from dsp_tpu_torch.kernels.spot_fused import subseq_dtw_fused

__all__ = [
    "mfcc_frames_fused",
    "dtw_batch_pallas", "dtw_from_cost_pallas", "dtw_pairs_pallas", "skew_cost",
    "dtw_batch_fused", "dtw_batch_fused_banded", "subseq_dtw_fused",
]
