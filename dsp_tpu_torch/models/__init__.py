"""Recognizer models of the port."""

from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer

__all__ = ["KnnDtwRecognizer"]
