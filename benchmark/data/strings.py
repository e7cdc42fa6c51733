"""Seeded synthetic digit strings: the connected-digit cell's traffic.

After the TIDIGITS test strings that Aurora 2 decodes: each string is 1,
2, 3, 4, 5 or 7 digits (a speaker reads 22 single digits and 11 strings
of each other length, so the lengths come in the ratio 2:1:1:1:1:1), its
digits uniform.  Each digit is the frozen word generator's
(``synth.py:synth_word``, imported, not copied) utterance of that digit,
its speech cut out of the generator's clip; 0-100 ms of silence lie
between digits and 100-500 ms before and after the string, and white
noise of 0.005 runs over the whole string.  A string is padded with zeros
to the cell's length and keeps its true length; a string longer than
that is drawn again from the next seed.

:func:`silence` gives the silence model's training clips: the same white
noise alone.
"""

from __future__ import annotations

import numpy as np

from benchmark.data import synth

LENGTHS = (1, 2, 3, 4, 5, 7)
WEIGHTS = np.array([2, 1, 1, 1, 1, 1], dtype=np.float64) / 7.0
NOISE = 0.005
GAP_S = (0.0, 0.1)          # between digits
EDGE_S = (0.1, 0.5)         # before and after the string
STRING_BASE = 60_000        # string seeds: seed * synth.SEED_STRIDE + STRING_BASE + k
SILENCE_BASE = 90_000       # silence clips: seed * synth.SEED_STRIDE + SILENCE_BASE + k
WORDS_A_STRING = 8          # word seeds: string seed * 8 + position


def _speech(label: str, seed: int, sr: int) -> np.ndarray:
    """The speech of one noiseless :func:`synth.synth_word` utterance."""
    x = synth.synth_word(label, seed, sr, 2 * sr, noise=0.0)
    nz = np.flatnonzero(x)
    return x[nz[0]:nz[-1] + 1]


def draw(words, seed: int, sr: int):
    """One string from ``seed``: (samples float32 [n], digit labels)."""
    rng = np.random.default_rng([int(seed), 29])
    k = int(rng.choice(LENGTHS, p=WEIGHTS))
    digits = rng.integers(0, len(words), k)
    lead, tail = rng.uniform(*EDGE_S, 2)
    gaps = rng.uniform(*GAP_S, k)
    pieces = [np.zeros(int(lead * sr))]
    for j, d in enumerate(digits):
        if j:
            pieces.append(np.zeros(int(gaps[j] * sr)))
        pieces.append(_speech(words[d], int(seed) * WORDS_A_STRING + j, sr))
    pieces.append(np.zeros(int(tail * sr)))
    x = np.concatenate(pieces)
    x = x + NOISE * rng.standard_normal(len(x))
    return x.astype(np.float32), [words[d] for d in digits]


def pool(words, n: int, seed: int, sr: int, max_samples: int):
    """``n`` strings of run ``seed``: (clips [n, max_samples] float32, true
    lengths [n] int32, labels, strings drawn again for being too long)."""
    clips = np.zeros((n, max_samples), dtype=np.float32)
    lens = np.zeros(n, dtype=np.int32)
    labels = []
    k = 0
    base = int(seed) * synth.SEED_STRIDE + STRING_BASE
    for i in range(n):
        while True:
            x, lab = draw(words, base + k, sr)
            k += 1
            if len(x) <= max_samples:
                break
        clips[i, :len(x)] = x
        lens[i] = len(x)
        labels.append(lab)
    return clips, lens, labels, k - n


def silence(n: int, seed: int, sr: int, seconds: float) -> np.ndarray:
    """``n`` clips [n, seconds * sr] of the strings' white noise alone."""
    base = int(seed) * synth.SEED_STRIDE + SILENCE_BASE
    return np.stack([NOISE * np.random.default_rng([base + k, 31]).standard_normal(
        int(seconds * sr)) for k in range(n)]).astype(np.float32)
