"""Deterministic synthetic isolated-word utterances.

A copy of ``DIGITS``, ``_fnv``, ``_word_params``, ``synth_word``,
``synth_connected`` and ``synth_spotting_stream`` from
``dsp_tpu/io/dataset.py``, byte-equal in output
(``tests/test_torch_config.py``), so the port can make its test and smoke
signals on a host without jax.  Each "word" is a fixed pattern of tone
segments with an amplitude envelope, per-utterance tempo and pitch
jitter, noise, and random leading silence; connected recordings and
spotting streams butt such words together with silence gaps.
"""

from __future__ import annotations

import numpy as np

DIGITS = ["zero", "one", "two", "three", "four",
          "five", "six", "seven", "eight", "nine"]


def _fnv(data: bytes) -> int:
    """FNV-1a — deterministic across processes (unlike builtin str hash,
    which is salted by PYTHONHASHSEED)."""
    h = 1469598103934665603
    for ch in data:
        h = ((h ^ ch) * 1099511628211) % (1 << 64)
    return h


def _word_params(label: str):
    """Deterministic per-word tone pattern derived from the label string."""
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
    """Synthesize one utterance of ``label`` -> float32 [max_samples]."""
    rng = np.random.default_rng(_fnv(f"{label}|{int(seed)}".encode()) % (2**32))
    segs = _word_params(label)
    speed = rng.uniform(0.8, 1.25)          # per-utterance tempo
    pieces = []
    for f0, f1, dur in segs:
        n = max(1, int(dur * speed * sr))
        t = np.arange(n) / sr
        jitter0 = f0 * rng.uniform(0.95, 1.05)
        jitter1 = f1 * rng.uniform(0.95, 1.05)
        seg = (0.6 * np.sin(2 * np.pi * jitter0 * t)
               + 0.3 * np.sin(2 * np.pi * jitter1 * t))
        # attack/decay envelope per segment
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


def synth_connected(labels, seed: int, sr: int = 16000,
                    gap_ms=(250.0, 600.0), lead_ms=(150.0, 400.0),
                    noise: float = 0.005) -> np.ndarray:
    """Synthesize one CONNECTED recording of several words -> float32 [N].

    Words from :func:`synth_word` separated by silence gaps drawn from
    ``gap_ms`` (defaults comfortably above the splitter's
    ``VadConfig.max_silence_frames`` 150 ms merge threshold, so each word
    is a separate segment).  Deterministic in (labels, seed).
    """
    rng = np.random.default_rng(
        _fnv(("|".join(labels) + f"|{int(seed)}").encode()) % (2**32))
    pieces = [np.zeros(int(rng.uniform(*lead_ms) / 1000.0 * sr))]
    for i, lab in enumerate(labels):
        w = synth_word(lab, seed * 101 + i, sr,
                       max_samples=int(2.0 * sr), noise=0.0)
        nz = np.nonzero(np.abs(w) > 0)[0]
        w = w[nz[0]: nz[-1] + 1] if len(nz) else w   # strip synth padding
        pieces.append(w)
        pieces.append(np.zeros(int(rng.uniform(*gap_ms) / 1000.0 * sr)))
    x = np.concatenate(pieces)
    x = x + noise * rng.standard_normal(len(x))
    return x.astype(np.float32)


def synth_spotting_stream(keywords, vocab, seed: int, n_words: int = 8,
                          sr: int = 16000, gap_ms=(120.0, 300.0),
                          lead_ms=(150.0, 400.0), noise: float = 0.003):
    """One continuous stream of random words; keyword spans annotated.

    Draws ``n_words`` words uniformly from ``vocab`` (which should
    contain the ``keywords`` plus distractors), butts them together
    with short gaps (well below any VAD merge threshold — the stream is
    NOT meant to be segmentable), and returns ``(signal float32 [N],
    events)`` where events are ``(label, start_sample, end_sample)``
    for each KEYWORD occurrence.  Deterministic in (keywords, vocab,
    seed).
    """
    kw = set(keywords)
    rng = np.random.default_rng(
        _fnv(("|".join(sorted(kw)) + "|" + "|".join(vocab)
              + f"|{int(seed)}").encode()) % (2**32))
    pieces = [np.zeros(int(rng.uniform(*lead_ms) / 1000.0 * sr))]
    pos = len(pieces[0])
    events = []
    for i in range(n_words):
        lab = vocab[int(rng.integers(len(vocab)))]
        w = synth_word(lab, seed * 977 + i, sr,
                       max_samples=int(2.0 * sr), noise=0.0)
        nz = np.nonzero(np.abs(w) > 0)[0]
        w = w[nz[0]: nz[-1] + 1] if len(nz) else w
        if lab in kw:
            events.append((lab, pos, pos + len(w)))
        pieces.append(w)
        pos += len(w)
        g = np.zeros(int(rng.uniform(*gap_ms) / 1000.0 * sr))
        pieces.append(g)
        pos += len(g)
    x = np.concatenate(pieces)
    x = x + noise * rng.standard_normal(len(x))
    return x.astype(np.float32), events
