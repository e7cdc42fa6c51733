"""ctypes bindings for the native batch WAV reader (``native/wavio.cpp``).

The port's copy of ``dsp_tpu/io/native.py``.  The shared library is
built with g++ at first use, never at import, into ``build/`` at the
repository root (as the CUDA kernels are), under a name that carries a
hash of the source and the flags, so an edited source builds anew and the
JAX package's own ``dsp_tpu/io/_libwavio.so`` is never touched:

    g++ -O3 -shared -fPIC -std=c++17 -pthread native/wavio.cpp \\
        -o build/libwavio_<hash>.so

Where no compiler is available :func:`available` is False and callers
take the pure-Python reader in ``io/wav.py``; the native path is never a
hard dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_REPO = Path(__file__).resolve().parents[2]
SRC = _REPO / "native" / "wavio.cpp"
BUILD_DIR = _REPO / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libwavio_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    if not SRC.is_file():
        raise NativeUnavailable(f"{SRC} not found")
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)     # atomic: a concurrent build never sees a partial file
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeUnavailable(f"building libwavio failed: {detail}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def get_lib():
    """Load (building if needed) the native library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build()))
        lib.dsp_decode_wav.restype = ctypes.c_int
        lib.dsp_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.dsp_decode_wav_batch.restype = ctypes.c_int
        lib.dsp_decode_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the native reader builds and loads here (building it if
    needed); False sends callers to the Python reader."""
    try:
        get_lib()
        return True
    except (NativeUnavailable, OSError):
        # OSError: ctypes.CDLL on a library this host cannot load
        return False


def read_wav_batch(paths, target_sr: int = 16000, max_samples: int = 32000,
                   n_threads: int = 0):
    """Decode many WAVs at once -> (float32 [n, max_samples], lengths [n],
    failures).

    Failed files yield a zero row with length 0 (callers may assert
    ``(lengths > 0).all()``).
    """
    lib = get_lib()
    n = len(paths)
    out = np.zeros((n, max_samples), dtype=np.float32)
    lens = np.zeros(n, dtype=np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.dsp_decode_wav_batch(
        arr, n, target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads,
    )
    return out, lens, failures


def read_wav_native(path: str, target_sr: int = 16000,
                    max_samples: int = 32000):
    """Single-file native decode -> (float32 [max_samples], length)."""
    lib = get_lib()
    out = np.zeros(max_samples, dtype=np.float32)
    length = ctypes.c_int64(0)
    rc = lib.dsp_decode_wav(
        path.encode(), target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples, ctypes.byref(length))
    if rc:
        raise IOError(f"native WAV decode failed ({rc}): {path}")
    return out, int(length.value)


def load_corpus_dir_native(root: str, target_sr: int = 16000,
                           max_samples: int = 32000, n_threads: int = 0):
    """Threaded corpus load: root/<label>/*.wav -> {label: [signals]}."""
    labels, paths, spans = [], [], []
    for label in sorted(os.listdir(root)):
        d = os.path.join(root, label)
        if not os.path.isdir(d):
            continue
        files = [os.path.join(d, f) for f in sorted(os.listdir(d))
                 if f.lower().endswith(".wav")]
        if files:
            spans.append((label, len(paths), len(paths) + len(files)))
            paths.extend(files)
    out, lens, failures = read_wav_batch(paths, target_sr, max_samples,
                                         n_threads)
    if failures:
        bad = [paths[i] for i in range(len(paths)) if lens[i] == 0]
        raise IOError(f"{failures} WAV files failed to decode: {bad[:5]}")
    corpus = {}
    for label, lo, hi in spans:
        corpus[label] = [out[i, : lens[i]] for i in range(lo, hi)]
    return corpus
