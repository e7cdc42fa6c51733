"""All-pairs subsequence DTW (keyword spotting): CUDA kernel wrapper.

Port of ``dsp_tpu/kernels/spot_fused.py:subseq_dtw_fused``.  The kernel
(``csrc/spot_subseq.cu``) runs one thread block per (stream, template)
pair over an anti-diagonal walk whose state is O(T), so any stream length
runs; its header says what it computes and what bounds it.

:func:`subseq_dtw_fused` takes CUDA tensors to the kernel and CPU tensors
to :func:`subseq_dtw_batch_plain` (``ops/spot.py``, the reference's scan
route); it never falls back from one to the other.  Columns at or beyond
a stream's length hold norm 1e30 in both; their start witness is
unspecified (the kernel writes the column index).
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.ops.spot import subseq_dtw_batch_plain

MAX_TEMPLATE_FRAMES = 1024   # one thread per template row
MAX_FEATURES = 128           # the widest instantiation of the kernel


def subseq_dtw_fused(streams: torch.Tensor, stream_lens: torch.Tensor,
                     bank: torch.Tensor, bank_lens: torch.Tensor,
                     squared: bool = False):
    """All-pairs subsequence DTW: streams [B,U,F] x bank [K,T,F] ->
    (norm [B,K,U] float32, start [B,K,U] int32).

    Lengths are int32 [B] and [K], clamped to >= 1.  A block keeps a ring
    of T + 32 stream frames in shared memory (at most 227 KB): at F = 39,
    T up to 1,024 frames fits.  Above 1,024 frames or 128 features this
    raises ValueError; where the ring does not fit (F = 128 from about
    400 frames) the launch fails and this raises RuntimeError.  Any number
    of streams runs, in launches of at most 65,535."""
    if streams.device.type == "cpu":
        return subseq_dtw_batch_plain(streams, stream_lens, bank, bank_lens,
                                      squared)
    if streams.device.type != "cuda":
        raise ValueError(f"unsupported device {streams.device}")
    dev = streams.device
    for name, x, dtype, ndim in (("streams", streams, torch.float32, 3),
                                 ("bank", bank, torch.float32, 3),
                                 ("stream_lens", stream_lens, torch.int32, 1),
                                 ("bank_lens", bank_lens, torch.int32, 1)):
        if x.device != dev or x.dtype != dtype or x.dim() != ndim:
            raise ValueError(f"{name}: want {dtype} with {ndim} dims on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, u, f = streams.shape
    k, t, f2 = bank.shape
    if f2 != f or stream_lens.shape[0] != b or bank_lens.shape[0] != k:
        raise ValueError(f"shape mismatch: streams {tuple(streams.shape)}, "
                         f"bank {tuple(bank.shape)}, stream_lens "
                         f"{tuple(stream_lens.shape)}, bank_lens "
                         f"{tuple(bank_lens.shape)}")
    norm = torch.empty((b, k, u), dtype=torch.float32, device=dev)
    start = torch.empty((b, k, u), dtype=torch.int32, device=dev)
    if not 1 <= t <= MAX_TEMPLATE_FRAMES or not 1 <= f <= MAX_FEATURES:
        raise ValueError(
            f"templates of {t} frames x {f} features do not fit one block "
            f"(at most {MAX_TEMPLATE_FRAMES} frames and {MAX_FEATURES} features)")
    if k == 0 or u == 0:
        return norm, start
    for lo, hi in _build.row_slices(b):    # one block a pair: streams along gridDim.y
        _build.launch("spot_subseq", dev, streams[lo].data_ptr(), stream_lens[lo].data_ptr(),
                      bank.data_ptr(), bank_lens.data_ptr(), norm[lo].data_ptr(),
                      start[lo].data_ptr(), hi - lo, k, u, t, f, int(squared))
    return norm, start
