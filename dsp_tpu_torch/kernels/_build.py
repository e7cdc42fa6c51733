"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``dsp_tpu_torch/csrc/`` is compiled by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o build/<hash>/<name>.o csrc/<name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/libdsp_tpu_torch_<hash>.so build/<hash>/*.o

No ``-use_fast_math``: it would change ``sqrtf`` and the f32 band rule of
the DTW kernel.  The library goes into ``build/`` at the repository root
and its name carries a hash of the sources and flags, so a second run
loads it without rebuilding and an edited source builds anew.  The build
happens at first use, never at import.

Every wrapper launches through :func:`launch`, which binds each C entry
point once, passes PyTorch's current stream of the tensors' device, raises
on the error code every entry point returns (``cudaGetLastError()`` after
its launch) and counts the launch in :data:`LAUNCHES`.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
# C signatures: (argtypes, restype).  Pointers (host arrays too) and the stream
# are c_void_p.
_SIGNATURES = {
    "dtw_banded": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _I, _F, _I, _I, _I, _I, _I, _P), _I),
    "mfcc_fused": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                    _I, _I, _I, _F, _I, _I, _I, _I, _I, _P), _I),
    "spot_subseq": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
                    _I),
    "dtw_fused": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P), _I),
    "dtw_wavefront": ((_P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "viterbi_score": ((_P, _P, _P, _P, _I, _P, _L, _L, _I, _I, _P, _P), _I),
    "gmm_emissions": ((_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P), _I),
    "mb_dp_diet": ((_P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "mb_dma_fetch": ((_P, _P, _P, _P, _U, _I, _I, _I, _I, _P), _I),
    "mb_anatomy": ((_P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "mb_trivial": ((_P, _P, _I, _P), _I),
    "mb_transpose": ((_P, _P, _I, _I, _I, _I, _P), _I),
    "mb_skew": ((_P, _P, _I, _I, _I, _I, _I, _P), _I),
}

# C entry points that launch nothing (no stream, not counted)
_QUERIES = {
    "dtw_wavefront_occupancy": ((_I, _I, _P, _P), _I),
    "dtw_fused_occupancy": ((_I, _I, _I, _P, _P), _I),
    "spot_subseq_occupancy": ((_I, _I, _I, _P, _P), _I),
}
# the most rows (queries or streams) one launch takes: gridDim.y's limit
MAX_GRID_ROWS = 65535

_lib = None
_fns: dict = {}              # bound C entry points, filled on first launch
_raw_stream = None           # PyTorch's current-stream getter, bound on first launch
# kernel launches since the last reset, per C entry point (main-path proof)
LAUNCHES = dict.fromkeys(_SIGNATURES, 0)
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
    objs = Path(tempfile.mkdtemp(prefix=out.stem + "_", dir=BUILD_DIR))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    nvcc = _nvcc()
    t0 = time.perf_counter()

    def run(cmds):
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in cmds]
        outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
        bad = [f"{' '.join(cmd)}\n{text}" for cmd, text, rc in outs if rc != 0]
        if bad:
            raise RuntimeError("nvcc failed:\n" + "\n".join(bad))

    try:
        cus = [p for p in _sources() if p.suffix == ".cu"]
        run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{p.stem}.o"), str(p)]
             for p in cus])
        run([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
              *(str(objs / f"{p.stem}.o") for p in cus)]])
        os.replace(tmp, out)     # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
        shutil.rmtree(objs, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in {**_SIGNATURES, **_QUERIES}.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
    return _lib


def _bind(name: str):
    global _raw_stream
    if _raw_stream is None:
        import torch

        # the raw ``cudaStream_t`` of the current stream as an int: the
        # getter PyTorch's own Triton launcher uses, with no Stream object
        _raw_stream = torch._C._cuda_getCurrentRawStream
    fn = _fns[name] = getattr(lib(), name)
    return fn


def launch(name: str, device, *args) -> None:
    """Call C entry point ``name`` with ``args`` and the current stream of
    CUDA ``device`` (a ``torch.device`` with an index, as a tensor's is);
    raise if it returns an error, else count the launch."""
    fn = _fns.get(name) or _bind(name)
    err = fn(*args, _raw_stream(device.index))
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


def row_slices(n: int, limit: int = MAX_GRID_ROWS) -> list[tuple[int, int]]:
    """[lo, hi) slices of ``n`` rows, in order, each at most ``limit`` rows:
    one launch a slice where a kernel's grid has a row a block (or a few)
    along ``gridDim.y``."""
    return [(lo, min(lo + limit, n)) for lo in range(0, n, limit)]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
