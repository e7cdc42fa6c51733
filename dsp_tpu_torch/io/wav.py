"""WAV file I/O (host side, standard library and numpy only).

A copy of ``dsp_tpu/io/wav.py``: ``read_wav(path) -> (sr, samples)``
normalised to float32 in [-1, 1], ``write_wav`` as 16-bit PCM mono, and
the linear resampler, bit-equal in output to the JAX package's
(``tests/test_torch_io.py``).  Pure host code: the port moves a batch to
the card once, in ``pipeline.pad_signals``, never in file I/O.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str, target_sr: int | None = None):
    """Read a WAV file -> (sample_rate, float32 samples in [-1, 1], mono).

    Multi-channel audio is averaged to mono.  If ``target_sr`` is given and
    differs from the file rate, the signal is linearly resampled.
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    if target_sr is not None and target_sr != sr:
        x = resample_linear(x, sr, target_sr)
        sr = target_sr
    return sr, x


def write_wav(path: str, sr: int, x: np.ndarray) -> None:
    """Write float samples in [-1, 1] as 16-bit PCM mono WAV."""
    x = np.asarray(x, dtype=np.float32)
    pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Cheap linear resampler (adequate for speech template matching)."""
    n_out = int(round(len(x) * sr_out / sr_in))
    t_out = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    return np.interp(t_out, np.arange(len(x), dtype=np.float64), x).astype(np.float32)
