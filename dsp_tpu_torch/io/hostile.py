"""Hostile synthetic benchmark corpus, a copy of ``dsp_tpu/io/hostile.py``.

Byte-equal in output to the JAX package's (``tests/test_torch_io.py``):

* **35-class confusable vocabulary** — 7 base tone patterns x 5
  minimal-pair variants.  A variant differs from its base in exactly ONE
  segment's frequency (x1.12) or duration (x1.5); classification must
  resolve fine spectral/temporal contrasts, not gross pattern shape.
* **Held-out speakers** — a "speaker" is a deterministic
  (formant_scale, tempo, gain) triple; enrollment and test speaker sets
  are disjoint, so matching sees systematic formant + tempo shift.
* **Channel / noise conditions** applied to the clean waveform:
    - ``snr20/snr10/snr5/snr0`` — additive white noise at the target SNR
      (power measured over the speech span only)
    - ``tilt`` — convolutive one-pole lowpass channel (~-6 dB/octave)
    - ``reverb`` — synthetic exponentially-decaying impulse response
      (~60 ms decay, 120 ms support)
    - combinations: ``"tilt+snr10"`` etc. ('+'-joined, applied in order)

Everything is deterministic (FNV-seeded) across processes.
"""

from __future__ import annotations

import numpy as np

from dsp_tpu_torch.io.synth import _fnv

N_BASES = 7
N_VARIANTS = 5
SR = 16000

CONDITIONS = ("clean", "snr20", "snr10", "snr5", "snr0",
              "tilt", "reverb", "tilt+snr10")


def hostile_vocab() -> list[str]:
    """35 labels: w<base><variant>, minimal pairs share the base digit."""
    return [f"w{b}{v}" for b in range(N_BASES) for v in range(N_VARIANTS)]


def _base_params(b: int):
    """Deterministic 4-segment tone pattern for base ``b``."""
    rng = np.random.default_rng(_fnv(f"hostile-base{b}".encode()) % (2**32))
    segs = []
    for _ in range(4):
        f0 = float(rng.uniform(300.0, 1000.0))
        f1 = float(rng.uniform(1300.0, 3000.0))
        dur = float(rng.uniform(0.09, 0.16))
        segs.append([f0, f1, dur])
    return segs


def _word_params(label: str):
    """Variant v modifies ONE segment of its base: odd v -> frequency
    (x1.12 on both partials), even v -> duration (x1.5).

    The contrast sits ~2x the speaker formant spread (+/-6%), so the
    task is hard-but-resolvable."""
    b, v = int(label[1]), int(label[2])
    segs = _base_params(b)
    if v > 0:
        k = (v - 1) % 4
        if v % 2 == 1:
            segs[k][0] *= 1.12
            segs[k][1] *= 1.12
        else:
            segs[k][2] *= 1.5
    return segs


def speaker_params(speaker: int):
    """(formant_scale, tempo, gain) for a deterministic synthetic speaker."""
    rng = np.random.default_rng(_fnv(f"hostile-spk{speaker}".encode()) % (2**32))
    # formant spread is deliberately comparable to the minimal-pair
    # contrast (x1.12 on one segment): wide enough to hurt, narrow
    # enough that the contrast stays resolvable
    return (float(rng.uniform(0.94, 1.06)),   # vocal-tract length analog
            float(rng.uniform(0.88, 1.16)),   # speaking rate
            float(rng.uniform(0.5, 1.0)))     # level


def _apply_condition(x: np.ndarray, condition: str, rng, speech_power: float,
                     sr: int) -> np.ndarray:
    for part in condition.split("+"):
        if part == "clean":
            continue
        if part.startswith("snr"):
            snr_db = float(part[3:])
            noise_p = speech_power / (10.0 ** (snr_db / 10.0))
            x = x + np.sqrt(noise_p) * rng.standard_normal(len(x))
        elif part == "tilt":
            # one-pole lowpass y[n] = (1-c) x[n] + c y[n-1]: convolutive
            # spectral tilt (~-6 dB/oct above ~760 Hz at c=0.7), realised
            # as its truncated impulse response (1-c) c^k (50 taps: tail
            # < 2e-8, numerically exact).  RMS is restored so the VAD
            # sees the same energy scale — the SHAPE change is the test.
            c = 0.7
            h = (1.0 - c) * c ** np.arange(50)
            rms0 = np.sqrt(np.mean(x * x)) + 1e-12
            x = np.convolve(x, h)[: len(x)]
            x *= rms0 / (np.sqrt(np.mean(x * x)) + 1e-12)
        elif part == "reverb":
            decay, support = 0.060, 0.120
            rr = np.random.default_rng(12345)      # fixed room
            t = np.arange(int(support * sr)) / sr
            h = np.exp(-t / decay) * rr.standard_normal(len(t))
            h[0] = 1.0
            h /= np.sqrt(np.sum(h * h))
            x = np.convolve(x, h)[: len(x)]
        else:
            raise ValueError(f"unknown condition part {part!r}")
    return x


def synth_hostile(label: str, speaker: int, seed: int,
                  condition: str = "clean", sr: int = SR,
                  max_samples: int = 32000,
                  noise_floor: float = 0.003) -> np.ndarray:
    """One hostile utterance -> float32 [max_samples]."""
    # the clean waveform's rng EXCLUDES the condition, so every condition
    # degrades the IDENTICAL underlying utterance (controlled comparison);
    # the condition's own randomness (added noise) is keyed separately
    rng = np.random.default_rng(
        _fnv(f"hostile|{label}|{speaker}|{int(seed)}".encode()) % (2**32))
    cond_rng = np.random.default_rng(
        _fnv(f"hostile-cond|{label}|{speaker}|{int(seed)}|{condition}".encode())
        % (2**32))
    formant, tempo, gain = speaker_params(speaker)
    segs = _word_params(label)
    tempo_u = tempo * rng.uniform(0.95, 1.05)      # utterance-level tempo
    pieces = []
    for f0, f1, dur in segs:
        n = max(1, int(dur * tempo_u * sr))
        t = np.arange(n) / sr
        j0 = f0 * formant * rng.uniform(0.99, 1.01)
        j1 = f1 * formant * rng.uniform(0.99, 1.01)
        seg = 0.6 * np.sin(2 * np.pi * j0 * t) + 0.3 * np.sin(2 * np.pi * j1 * t)
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n))
                         / (0.01 * sr))
        pieces.append(seg * env)
    speech = np.concatenate(pieces) * (0.5 * gain)
    n_speech = len(speech)
    lead_lo = int(0.05 * sr)
    lead_hi = max(lead_lo + 1, min(max_samples - n_speech - lead_lo,
                                   int(0.5 * sr)))
    lead = int(rng.integers(lead_lo, lead_hi))
    x = np.zeros(max_samples, dtype=np.float64)
    end = min(max_samples, lead + n_speech)
    x[lead:end] = speech[: end - lead]
    speech_power = float(np.mean(speech[: end - lead] ** 2)) if end > lead else 1e-8

    x = _apply_condition(x, condition, cond_rng, speech_power, sr)
    x += noise_floor * rng.standard_normal(max_samples)
    return x.astype(np.float32)


def make_hostile_corpus(labels=None, speakers=(0, 1, 2), n_per: int = 2,
                        condition: str = "clean", seed: int = 0,
                        max_samples: int = 32000) -> dict:
    """{label: [utterances]} over the given speakers x repetitions."""
    labels = list(labels) if labels is not None else hostile_vocab()
    return {
        lab: [synth_hostile(lab, s, seed * 1000 + r, condition,
                            max_samples=max_samples)
              for s in speakers for r in range(n_per)]
        for lab in labels
    }
