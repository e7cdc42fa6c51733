"""Recognizer models of the port."""

from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
from dsp_tpu_torch.models.spotter import (CascadeSpotter, HmmSpotter, KeywordSpotter,
                                          StreamingCascadeSpotter, StreamingHmmSpotter,
                                          StreamingSpotter)
from dsp_tpu_torch.models.streaming import StreamingRecognizer

__all__ = ["KnnDtwRecognizer", "GmmHmmRecognizer", "KeywordSpotter", "StreamingRecognizer",
           "StreamingSpotter", "HmmSpotter", "StreamingHmmSpotter", "CascadeSpotter",
           "StreamingCascadeSpotter"]
