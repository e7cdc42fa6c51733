"""Seeded synthetic isolated-word clips: the benchmark's own generator.

A frozen copy of ``_fnv``, ``_word_params`` and ``synth_word`` of the
port's ``io/synth.py``, equal in output for every (label, seed), kept
here so that a change to the program cannot change the benchmark's
inputs.  Each word is a fixed pattern of 2-4 tone segments drawn from
its label; each utterance draws its tempo (0.8-1.25x), pitch jitter,
leading silence (50-500 ms) and white noise from (label, seed).

:func:`cell_inputs` draws a cell's template bank and request pool from
the run's ``--seed``: the same seed gives the same clips.
"""

from __future__ import annotations

import numpy as np

# utterance seeds: seed * SEED_STRIDE + index; templates take indices
# from 0 and the pool from POOL_BASE, so no template is also a query
SEED_STRIDE = 100_000
POOL_BASE = 50_000


def _fnv(data: bytes) -> int:
    """FNV-1a, stable across processes (``hash`` of a str is salted)."""
    h = 1469598103934665603
    for ch in data:
        h = ((h ^ ch) * 1099511628211) % (1 << 64)
    return h


def _word_params(label: str):
    """The word's tone pattern, from its label alone."""
    rng = np.random.default_rng(_fnv(label.encode()) % (2**32))
    n_seg = int(rng.integers(2, 5))
    segs = []
    for _ in range(n_seg):
        f0 = float(rng.uniform(200.0, 1200.0))
        f1 = float(rng.uniform(1200.0, 3500.0))
        dur = float(rng.uniform(0.08, 0.2))
        segs.append((f0, f1, dur))
    return segs


def synth_word(label: str, seed: int, sr: int = 16000,
               max_samples: int = 32000, noise: float = 0.005) -> np.ndarray:
    """One utterance of ``label`` -> float32 [max_samples]."""
    rng = np.random.default_rng(_fnv(f"{label}|{int(seed)}".encode()) % (2**32))
    segs = _word_params(label)
    speed = rng.uniform(0.8, 1.25)
    pieces = []
    for f0, f1, dur in segs:
        n = max(1, int(dur * speed * sr))
        t = np.arange(n) / sr
        jitter0 = f0 * rng.uniform(0.95, 1.05)
        jitter1 = f1 * rng.uniform(0.95, 1.05)
        seg = (0.6 * np.sin(2 * np.pi * jitter0 * t)
               + 0.3 * np.sin(2 * np.pi * jitter1 * t))
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.01 * sr))
        pieces.append(seg * env)
    speech = np.concatenate(pieces) * 0.5
    n_speech = len(speech)
    lead_max = max(1, max_samples - n_speech - int(0.05 * sr))
    lead = int(rng.integers(int(0.05 * sr), max(int(0.05 * sr) + 1, min(lead_max, int(0.5 * sr)))))
    x = np.zeros(max_samples, dtype=np.float64)
    end = min(max_samples, lead + n_speech)
    x[lead:end] = speech[: end - lead]
    x += noise * rng.standard_normal(max_samples)
    return x.astype(np.float32)


def clips(labels, seeds, sr: int, max_samples: int) -> np.ndarray:
    """[N, max_samples] float32: one :func:`synth_word` a (label, seed)."""
    out = np.empty((len(labels), max_samples), dtype=np.float32)
    for i, (lab, s) in enumerate(zip(labels, seeds)):
        out[i] = synth_word(lab, s, sr, max_samples)
    return out


def cell_inputs(words, templates_per_word: int, pool: int, seed: int,
                sr: int, max_samples: int):
    """The bank and the request pool of one run, from ``seed``.

    Returns ``(bank [K, N], bank_ids [K], pool [P, N], pool_ids [P])``:
    ``templates_per_word`` templates of each word in word order, and a pool
    whose labels are every word in turn (the same multiset of words for
    every seed, so every seed asks for the same work up to each
    utterance's own tempo and silence), shuffled by the seed."""
    n_words = len(words)
    bank_ids = np.repeat(np.arange(n_words), templates_per_word)
    base = int(seed) * SEED_STRIDE
    bank = clips([words[i] for i in bank_ids],
                 [base + j for j in range(len(bank_ids))], sr, max_samples)
    pool_ids = np.random.default_rng(int(seed)).permutation(np.arange(pool) % n_words)
    pool_clips = clips([words[i] for i in pool_ids],
                       [base + POOL_BASE + j for j in range(pool)], sr, max_samples)
    return bank, bank_ids.astype(np.int64), pool_clips, pool_ids.astype(np.int64)
