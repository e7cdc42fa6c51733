"""Synthetic isolated-word corpora and on-disk corpus loading.

``make_corpus`` and ``load_corpus_dir`` are copies of
``dsp_tpu/io/dataset.py``'s, built over the ``synth_*`` copies in
``io/synth.py`` (re-exported here, as the JAX module defines them), so
that the same seed gives the same corpus byte for byte.
``load_corpus_dir`` reads the reference's directory convention,
``root/<label>/*.wav``.
"""

from __future__ import annotations

import os

from dsp_tpu_torch.io.synth import (DIGITS, synth_connected,  # noqa: F401
                                    synth_spotting_stream, synth_word)
from dsp_tpu_torch.io.wav import read_wav


def make_corpus(labels=None, n_per_word: int = 3, seed: int = 0,
                sr: int = 16000, max_samples: int = 32000,
                noise: float = 0.005):
    """Build {label: [utterance, ...]} with deterministic content."""
    labels = list(labels) if labels is not None else DIGITS
    return {
        lab: [synth_word(lab, seed * 1000 + i, sr, max_samples, noise)
              for i in range(n_per_word)]
        for lab in labels
    }


def load_corpus_dir(root: str, target_sr: int = 16000):
    """Load ``root/<label>/*.wav`` -> {label: [float32 samples, ...]}."""
    corpus = {}
    for label in sorted(os.listdir(root)):
        word_dir = os.path.join(root, label)
        if not os.path.isdir(word_dir):
            continue
        wavs = []
        for name in sorted(os.listdir(word_dir)):
            if name.lower().endswith(".wav"):
                _, x = read_wav(os.path.join(word_dir, name), target_sr)
                wavs.append(x)
        if wavs:
            corpus[label] = wavs
    return corpus
