"""Microphone capture (the reference's ``record()``), a copy of
``dsp_tpu/io/record.py``.

PyAudio is optional: the module imports everywhere, and :func:`record`
raises a clear error where no audio stack exists.  :func:`record_fake`
gives a synthetic utterance with the same contract.
"""

from __future__ import annotations

import numpy as np


def available() -> bool:
    try:
        import pyaudio  # noqa: F401
        return True
    except ImportError:
        return False


def record(seconds: float = 2.0, sample_rate: int = 16000,
           chunk: int = 1600) -> np.ndarray:
    """Record from the default microphone -> float32 samples in [-1, 1]."""
    try:
        import pyaudio
    except ImportError as e:
        raise RuntimeError(
            "PyAudio is not installed; microphone capture is unavailable "
            "in this environment. Use dsp_tpu_torch.io.record.record_fake or "
            "load WAV files instead.") from e
    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=1, rate=sample_rate,
                     input=True, frames_per_buffer=chunk)
    frames = []
    try:
        for _ in range(int(seconds * sample_rate / chunk)):
            frames.append(stream.read(chunk))
    finally:
        stream.close()
        pa.terminate()
    pcm = np.frombuffer(b"".join(frames), dtype=np.int16)
    return pcm.astype(np.float32) / 32768.0


def record_fake(word: str = "zero", seed: int = 0, seconds: float = 2.0,
                sample_rate: int = 16000) -> np.ndarray:
    """Deterministic synthetic 'recording' with the record() contract."""
    from dsp_tpu_torch.io.synth import synth_word

    return synth_word(word, seed, sr=sample_rate,
                      max_samples=int(seconds * sample_rate))
