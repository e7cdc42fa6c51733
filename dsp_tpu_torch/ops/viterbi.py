"""Batched log-space HMM lattice ops (port of ``dsp_tpu/ops/viterbi.py``).

Viterbi max-product and forward sum-product over log-probabilities.  The
time recursion is a Python loop over T on device tensors (the JAX
package's ``lax.scan``); states, words and utterances are batched into
the leading dimensions, so one loop decodes the whole vocabulary for a
whole batch at once ([B, W, S] log-deltas).

Variable-length sequences: frames at ``t >= length`` carry the previous
state through unchanged, as the JAX scan's masked step does.  No loop
reads a tensor back to the host.

On the card :func:`viterbi_score` runs the whole recursion as one launch
of a CUDA kernel (``kernels/viterbi_score.py``, ``csrc/viterbi_score.cu``)
wherever it takes the inputs (``kernels/viterbi_score.py:refusal``:
float32, up to 32 states, ``log_b`` 3-D or 4-D, as ``score_words`` passes
them), with the loop's bits; every other input, on the card or the CPU,
runs the loop op by op on its own device.  Under a profiler the launch or
the loop is the span ``dsp.viterbi`` (``utils/profiling.stage``), and every
call counts its T - 1 time steps in ``viterbi_steps``; the kernel's
launches are counted in ``kernels/_build.LAUNCHES``.

Deviation the tests pin: :func:`viterbi_decode` takes leading batch dims
(``log_b`` [..., T, S]) in place of the JAX package's ``vmap`` over a
single-sequence decode; with ``log_b`` [T, S] it is that decode.
``NEG_INF`` stays -1e30 (not -inf), so sums stay finite in fp32 and
``max`` / ``logsumexp`` see the values the JAX package sees.  Exact-parity
oracle: ``dsp_tpu/golden/hmm.py``.
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.utils import profiling

NEG_INF = -1e30


def _length(length, t: int, like: torch.Tensor) -> torch.Tensor:
    if length is None:
        return torch.tensor(t, device=like.device)
    return torch.as_tensor(length, device=like.device)


def viterbi_score(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
                  length: torch.Tensor | None = None) -> torch.Tensor:
    """Best-path log-likelihood.

    Args:
      log_pi: [..., S] initial log-probs.
      log_a:  [..., S, S] transition log-probs (from -> to).
      log_b:  [T, ..., S] emission log-likelihoods, time-major.
      length: optional [...] valid frame counts.

    Leading ``...`` dims broadcast (batch utterances and/or word models).
    Returns [...] best log-likelihood.
    """
    t = log_b.shape[0]
    profiling.count("viterbi_steps", t - 1)
    with profiling.stage("dsp.viterbi"):
        if log_b.is_cuda:
            from dsp_tpu_torch.kernels import viterbi_score as kernel

            if kernel.refusal(log_pi, log_a, log_b, length) is None:
                return kernel.launch(log_pi, log_a, log_b, length)
        return _viterbi_loop(log_pi, log_a, log_b, _length(length, t, log_b))


def _viterbi_loop(log_pi, log_a, log_b, length):
    delta = log_pi + log_b[0]
    for ti in range(1, log_b.shape[0]):
        scores = torch.amax(delta[..., :, None] + log_a, dim=-2) + log_b[ti]
        delta = torch.where((ti < length)[..., None], scores, delta)
    return torch.amax(delta, dim=-1)


def viterbi_decode(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
                   length: torch.Tensor | None = None):
    """Best path + score: ``log_b`` [..., T, S] (batch-major) ->
    (score [...], path [..., T] int64).

    ``log_pi`` [..., S], ``log_a`` [..., S, S] and ``length`` [...]
    broadcast against the leading dims.  Backtrace through argmax
    pointers (the first maximum, as ``jnp.argmax``); used for state-level
    alignment in GMM-HMM training.  Frames at ``t >= length`` carry delta
    through unchanged with identity backpointers, so the returned path is
    valid on [0, length) and constant after.
    """
    t, s = log_b.shape[-2:]
    length = _length(length, t, log_b)
    identity = torch.arange(s, device=log_b.device)
    delta = log_pi + log_b[..., 0, :]
    psis = []
    for ti in range(1, t):
        scores = delta[..., :, None] + log_a                     # [..., from, to]
        psi = torch.argmax(scores, dim=-2)                        # [..., S]
        new = torch.gather(scores, -2, psi[..., None, :]).squeeze(-2) + log_b[..., ti, :]
        keep = (ti < length)[..., None]
        delta = torch.where(keep, new, delta)
        psis.append(torch.where(keep, psi, identity))
    state = torch.argmax(delta, dim=-1)
    path = [state]
    # psis[i] holds the i -> i+1 transition: from path[i+1] it gives path[i]
    for psi in reversed(psis):
        state = torch.gather(psi, -1, state[..., None]).squeeze(-1)
        path.append(state)
    return torch.amax(delta, dim=-1), torch.stack(path[::-1], dim=-1)


def forward_score(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
                  length: torch.Tensor | None = None) -> torch.Tensor:
    """Total log-likelihood (sum-product), same batching as viterbi_score."""
    t = log_b.shape[0]
    length = _length(length, t, log_b)
    alpha = log_pi + log_b[0]
    for ti in range(1, t):
        scores = torch.logsumexp(alpha[..., :, None] + log_a, dim=-2) + log_b[ti]
        alpha = torch.where((ti < length)[..., None], scores, alpha)
    return torch.logsumexp(alpha, dim=-1)
