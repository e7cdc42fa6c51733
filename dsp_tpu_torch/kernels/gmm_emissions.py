"""Emission log-likelihoods of GMM-HMM states: CUDA kernel wrapper.

The kernel (``csrc/gmm_emissions.cu``) replaces no TPU kernel: the JAX
package's emissions (``dsp_tpu/models/gmm_hmm.py``) are matrix products
and a logsumexp that XLA fused.  It computes ``models/gmm_hmm.py``'s
``emission_logb`` in one launch: for every feature row and every state,
the M diagonal-Gaussian log-likelihoods in the direct form
(``(x - mu)^2 / var`` summed over the features), plus ``log_mix``, and
their log-sum-exp, with nothing but ``log_b`` written to device memory.
Its plain version is ``gmm_hmm.gmm_loglik_flat`` and ``torch.logsumexp``
(the expanded form as two GEMMs), which the CPU and the CUDA inputs
:func:`refusal` names run.

:func:`gmm_emissions_fused` launches the kernel on CUDA tensors, or raises
where they are not on the card or :func:`refusal` names what the kernel
does not take; it never falls back to the plain chain.
``gmm_hmm.emission_logb``, which asks :func:`refusal` itself to pick its
route, launches through :func:`launch`, which checks nothing again.
``_build.LAUNCHES["gmm_emissions"]`` counts the launches.
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.kernels import _build

MAX_MIX = 8              # mixtures a state: a thread's 2 rows x 4 (or 2) states x M sums
MAX_FEATURES = 64        # features a row: the block's shared row tile is F x 257 floats
ROWS = 256               # rows a block (csrc/gmm_emissions.cu ROWS)
STATE_STAGE_BYTES = 16_384   # a stage's means, inverse variances and constants at most


def stage_states(n_states: int, n_mix: int, n_feat: int) -> int:
    """States whose parameters a block stages at a time: a multiple of 4,
    at least 4, at most S rounded up to 4, and as many as fit
    ``STATE_STAGE_BYTES`` (all 16 of the Aurora 2 word at M = 3, F = 39)."""
    per_state = 4 * n_mix * (2 * n_feat + 1)
    fit = STATE_STAGE_BYTES // per_state // 4 * 4
    return max(4, min(fit, (n_states + 3) // 4 * 4))


def smem_bytes(n_mix: int, n_feat: int, stage: int) -> int:
    """Shared bytes of a block (``csrc/gmm_emissions.cu:smem_bytes``): the
    row tile [F][257] rounded up to a float4, then a stage's means and
    inverse variances (2 M F a state) and constants (M a state)."""
    x_floats = (n_feat * (ROWS + 1) + 3) & ~3
    return 4 * (x_floats + stage * n_mix * (2 * n_feat + 1))


def refusal(x: torch.Tensor, means: torch.Tensor, log_var: torch.Tensor,
            log_mix: torch.Tensor) -> str | None:
    """Why the kernel does not take these inputs, or None where it does.

    It takes float32 contiguous ``x`` [..., F] and parameters ``means`` /
    ``log_var`` [*lead, S, M, F] and ``log_mix`` [*lead, S, M], all on
    ``x``'s device, with 1 <= M <= 8, 1 <= F <= 64 and at least one state
    (``score_words`` passes [B, T, F] and [W, S, M, F]; the HMM spotters
    [B, U, F] and [C, F])."""
    named = (("x", x), ("means", means), ("log_var", log_var), ("log_mix", log_mix))
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            return f"{name} is not a float32 tensor"
    if means.dim() < 3 or log_var.shape != means.shape \
            or log_mix.shape != means.shape[:-1]:
        return (f"means {tuple(means.shape)}, log_var {tuple(log_var.shape)} and log_mix "
                f"{tuple(log_mix.shape)} are not [*lead, S, M, F] and [*lead, S, M]")
    m, f = means.shape[-2:]
    if x.dim() < 1 or x.shape[-1] != f:
        return f"x {tuple(x.shape)} does not end in the parameters' F = {f}"
    if not (1 <= m <= MAX_MIX and 1 <= f <= MAX_FEATURES):
        return f"M = {m}, F = {f}: want 1 <= M <= {MAX_MIX} and 1 <= F <= {MAX_FEATURES}"
    if means.numel() == 0:
        return f"means {tuple(means.shape)} holds no state"
    if any(t.device != x.device for _, t in named[1:]):
        return "the parameters are not on x's device"
    for name, t in named:
        if not t.is_contiguous():
            return f"{name} is not contiguous"
    return None


def gmm_emissions_fused(x: torch.Tensor, means: torch.Tensor, log_var: torch.Tensor,
                        log_mix: torch.Tensor) -> torch.Tensor:
    """``log_b`` [..., *lead, S] of rows ``x`` [..., F] against the states'
    Gaussian mixtures ``means`` / ``log_var`` [*lead, S, M, F] and
    ``log_mix`` [*lead, S, M], as ``gmm_hmm.emission_logb``, in one launch;
    inputs off the card, or that :func:`refusal` names, raise."""
    if x.device.type != "cuda":
        raise ValueError(f"gmm_emissions kernel: unsupported device {x.device}")
    why = refusal(x, means, log_var, log_mix)
    if why is not None:
        raise ValueError(f"gmm_emissions kernel: {why}")
    return launch(x, means, log_var, log_mix)


def launch(x, means, log_var, log_mix):
    """:func:`gmm_emissions_fused` on CUDA inputs that :func:`refusal` has
    taken, checked no further."""
    lead, (s, m, f) = means.shape[:-3], means.shape[-3:]
    out = torch.empty((*x.shape[:-1], *lead, s), dtype=torch.float32, device=x.device)
    rows = x.numel() // f
    if rows == 0:
        return out
    _build.launch("gmm_emissions", x.device, x.data_ptr(), means.data_ptr(),
                  log_var.data_ptr(), log_mix.data_ptr(), out.data_ptr(), rows,
                  means.numel() // (s * m * f), s, m, f, stage_states(s, m, f))
    return out
