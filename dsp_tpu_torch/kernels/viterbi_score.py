"""Viterbi best-path scores of a batch of HMM lattices: CUDA kernel wrapper.

The kernel (``csrc/viterbi_score.cu``) replaces no TPU kernel: the JAX
package's ``lax.scan`` (``dsp_tpu/ops/viterbi.py:viterbi_score``) went to
XLA.  It runs the whole max-product recursion of ``ops/viterbi.py``'s
plain version, ``_viterbi_loop``, in one launch: G lanes a lattice (G the
next power of two at or above the S states), each lane a state's log-delta
and its column of ``log_a`` in registers, ``log_b`` streamed through its
strides.  Its scores equal the loop's bit for bit (one fp32 add a sum,
exact maxes, NaN propagated as ``torch.amax`` does).

:func:`viterbi_score_fused` launches the kernel on CUDA tensors, or raises
where they are not on the card or :func:`refusal` names what the kernel
does not take; it never falls back to the loop.  ``ops/viterbi.py``'s
``viterbi_score``, which asks :func:`refusal` itself to pick its route,
launches through :func:`launch`, which checks nothing again; the inputs
it refuses run that loop.  ``_build.LAUNCHES["viterbi_score"]`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from dsp_tpu_torch.kernels import _build

MAX_STATES = 32          # states a lattice: one lane each, one warp at most
_LENGTH_KINDS = {torch.int32: 1, torch.int64: 2}


def refusal(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
            length: torch.Tensor | None) -> str | None:
    """Why the kernel does not take these inputs, or None where it does.

    It takes float32 ``log_pi`` [..., S], ``log_a`` [..., S, S] and
    ``log_b`` [T, ..., S] (3-D or 4-D, T >= 1, 1 <= S <= 32) and ``length``
    None or int32 / int64 [...], all on ``log_b``'s device, whose leading
    dims broadcast to ``log_b``'s own (``score_words`` passes [1, W, S],
    [1, W, S, S], [T, B, W, S] and [B, 1]).  Any strides."""
    for name, x in (("log_pi", log_pi), ("log_a", log_a), ("log_b", log_b)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
            return f"{name} is not a float32 tensor"
    if log_b.dim() not in (3, 4):
        return f"log_b has {log_b.dim()} dims, not 3 or 4"
    t, s = log_b.shape[0], log_b.shape[-1]
    if t < 1 or not 1 <= s <= MAX_STATES:
        return f"log_b {tuple(log_b.shape)}: want T >= 1 and 1 <= S <= {MAX_STATES}"
    if log_pi.dim() < 1 or log_pi.shape[-1] != s or log_a.dim() < 2 \
            or tuple(log_a.shape[-2:]) != (s, s):
        return (f"log_pi {tuple(log_pi.shape)} and log_a {tuple(log_a.shape)} do not "
                f"end in S = {s}")
    if length is not None and (not isinstance(length, torch.Tensor)
                               or length.dtype not in _LENGTH_KINDS):
        return "length is not an int32 or int64 tensor"
    if any(x is not None and x.device != log_b.device for x in (log_pi, log_a, length)):
        return "the inputs are not all on log_b's device"
    lead = log_b.shape[1:-1]
    # by hand: torch.broadcast_shapes imports sympy at its first call (4.5 s)
    for shape in (log_pi.shape[:-1], log_a.shape[:-2], () if length is None else length.shape):
        if len(shape) > len(lead) or any(d not in (1, n) for d, n in zip(shape[::-1], lead[::-1])):
            return f"leading dims {tuple(shape)} do not broadcast to log_b's {tuple(lead)}"
    return None


def pair_views(log_pi, log_a, log_b, length):
    """Inputs the kernel takes (:func:`refusal`) as views over [n0, n1]
    lattices, stride 0 where an input broadcasts, nothing copied:
    ``log_pi`` [n0, n1, S], ``log_a`` [n0, n1, S, S], ``log_b``
    [T, n0, n1, S] and ``length`` [n0, n1] or None (n0 = 1 for a 3-D
    ``log_b``).  The kernel reads them through these views' strides."""
    lead, s = log_b.shape[1:-1], log_b.shape[-1]
    pi, a, b = log_pi.expand(*lead, s), log_a.expand(*lead, s, s), log_b
    n = None if length is None else length.expand(lead)
    if len(lead) == 1:
        pi, a, b = pi[None], a[None], b[:, None]
        n = None if n is None else n[None]
    return pi, a, b, n


def viterbi_score_fused(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
                        length: torch.Tensor | None = None) -> torch.Tensor:
    """Best-path log-likelihood [...] of lattices ``log_pi`` [..., S],
    ``log_a`` [..., S, S] (from -> to), ``log_b`` [T, ..., S] and valid
    frame counts ``length`` [...] (None: T), as ``ops/viterbi.py``'s
    ``viterbi_score``.  Any number of lattices and frames runs in one
    launch; inputs off the card, or that :func:`refusal` names, raise."""
    if log_b.device.type != "cuda":
        raise ValueError(f"viterbi_score kernel: unsupported device {log_b.device}")
    why = refusal(log_pi, log_a, log_b, length)
    if why is not None:
        raise ValueError(f"viterbi_score kernel: {why}")
    return launch(log_pi, log_a, log_b, length)


def launch(log_pi, log_a, log_b, length):
    """:func:`viterbi_score_fused` on CUDA inputs that :func:`refusal`
    has taken, checked no further."""
    out = torch.empty(log_b.shape[1:-1], dtype=torch.float32, device=log_b.device)
    if out.numel() == 0:
        return out
    pi, a, b, n = pair_views(log_pi, log_a, log_b, length)
    if n is None:
        kind, ptr, n_strides = 0, None, (0, 0)
    else:
        kind, ptr, n_strides = _LENGTH_KINDS[n.dtype], n.data_ptr(), n.stride()
    strides = (ctypes.c_longlong * 13)(*pi.stride(), *a.stride(), *b.stride(), *n_strides)
    t, n0, n1, s = b.shape
    _build.launch("viterbi_score", log_b.device, pi.data_ptr(), a.data_ptr(), b.data_ptr(),
                  ptr, kind, out.data_ptr(), n0 * n1, n1, t, s, strides)
    return out
