"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``dsp_tpu_torch/csrc/`` is compiled by ``nvcc`` into
one shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/libdsp_tpu_torch_<hash>.so csrc/*.cu

No ``-use_fast_math``: it would change ``sqrtf`` and the f32 band rule of
the DTW kernel.  The library goes into ``build/`` at the repository root
and its name carries a hash of the sources and flags, so a second run
loads it without rebuilding and an edited source builds anew.  The build
happens at first use, never at import.  Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: (argtypes, restype).  Pointers and the stream are c_void_p.
_SIGNATURES = {
    "dtw_banded": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _I, _F, _I, _I, _P), _I),
    "mfcc_fused": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                    _F, _I, _P), _I),
    "spot_subseq": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), _I),
}

_lib = None
build_seconds: float | None = None   # wall time of the last nvcc run (None: cached)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from dsp_tpu_torch/csrc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdsp_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cus = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)     # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
