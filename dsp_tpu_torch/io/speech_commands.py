"""Google Speech Commands v2 split reader, a copy of
``dsp_tpu/io/speech_commands.py``.

It works over a local extracted checkout (the dataset is not downloaded):

    <root>/<word>/<speaker>_nohash_<n>.wav   (16 kHz, <= 1 s)
    <root>/validation_list.txt, <root>/testing_list.txt

Splits follow the dataset's own convention: files named in
validation_list/testing_list are held out; everything else is training.
"""

from __future__ import annotations

import os

import numpy as np

SC2_WORDS = [
    "backward", "bed", "bird", "cat", "dog", "down", "eight", "five",
    "follow", "forward", "four", "go", "happy", "house", "learn", "left",
    "marvin", "nine", "no", "off", "on", "one", "right", "seven", "sheila",
    "six", "stop", "three", "tree", "two", "up", "visual", "wow", "yes",
    "zero",
]


def _read_list(root: str, name: str) -> set:
    path = os.path.join(root, name)
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def discover_words(root: str):
    """Word classes actually present under root (ignores _background_noise_)."""
    return sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)) and not d.startswith("_"))


def list_split(root: str, split: str = "test",
               words=None, per_word: int | None = None, seed: int = 0):
    """Return [(label, wav_path)] for a dataset split.

    ``words=None`` evaluates every word directory present (the full SC2
    checkout has the standard 35 classes, SC2_WORDS).
    """
    words = list(words) if words is not None else discover_words(root)
    val = _read_list(root, "validation_list.txt")
    test = _read_list(root, "testing_list.txt")
    rng = np.random.default_rng(seed)
    out = []
    for word in words:
        d = os.path.join(root, word)
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"{d} missing — is {root} an extracted Speech Commands v2?")
        rels = [f"{word}/{f}" for f in sorted(os.listdir(d))
                if f.endswith(".wav")]
        if split == "test":
            keep = [r for r in rels if r in test]
        elif split == "validation":
            keep = [r for r in rels if r in val]
        else:
            keep = [r for r in rels if r not in val and r not in test]
        if per_word is not None and len(keep) > per_word:
            idx = rng.permutation(len(keep))[:per_word]
            keep = [keep[i] for i in sorted(idx)]
        out.extend((word, os.path.join(root, r)) for r in keep)
    return out


def load_split(root: str, split: str, words=None, per_word: int | None = None,
               max_samples: int = 16000, seed: int = 0):
    """Load a split into (signals [n, max_samples], lengths, label_ids, labels)."""
    from dsp_tpu_torch.io import native

    pairs = list_split(root, split, words, per_word, seed)
    labels = sorted({lab for lab, _ in pairs})
    lab_to_id = {lab: i for i, lab in enumerate(labels)}
    paths = [p for _, p in pairs]
    if native.available():
        sigs, lens, failures = native.read_wav_batch(
            paths, target_sr=16000, max_samples=max_samples)
        if failures:
            raise IOError(f"{failures} WAVs failed to decode")
    else:
        from dsp_tpu_torch.io.wav import read_wav
        sigs = np.zeros((len(paths), max_samples), dtype=np.float32)
        lens = np.zeros(len(paths), dtype=np.int64)
        for i, p in enumerate(paths):
            _, x = read_wav(p, 16000)
            x = x[:max_samples]
            sigs[i, : len(x)] = x
            lens[i] = len(x)
    ids = np.asarray([lab_to_id[lab] for lab, _ in pairs], dtype=np.int32)
    return sigs, lens.astype(np.int32), ids, labels
