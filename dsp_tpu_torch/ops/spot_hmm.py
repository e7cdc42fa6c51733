"""HMM keyword spotting: open-endpoint Viterbi against a UBM filler (port of
``dsp_tpu/ops/spot_hmm.py``).

The GMM-HMM family's counterpart of ``ops/spot.py``, the classical
keyword/filler network (Rose & Paul 1990): each word HMM may enter at any
stream frame and exit at any later frame, and a span scores by the
per-frame Viterbi log-likelihood ratio against the universal background
GMM (``models/gmm_hmm.py:fit_ubm``), so a fitted recognizer spots its
words with no extra training.

* Emissions for every (frame, word, state) are
  ``models/gmm_hmm.py:emission_logb``'s, the ones scoring uses: one
  launch of the kernel ``gmm_emissions`` on the card, float32 GEMMs on
  the CPU.
* The DP is frame-synchronous over the stream with a [..., W, S] carry
  and no dependency inside a frame (left-right, no skips: every
  predecessor lies at frame j-1), so a frame is a few elementwise
  max-plus ops over the whole carry.  A Python loop over the frames (the
  JAX package's ``lax.scan``), with no read-back to the host inside it.
* Entry-frame witnesses ride the max; the filler term is a prefix sum of
  per-frame UBM log-liks, subtracted per span at readout.

Scores are per-frame LLRs: > 0 means the word HMM explains the span
better than the background model.  Event extraction is
``ops/spot.py:extract_events`` on the negated field (it minimises).

Tie order: fresh start > stay > advance, as the golden oracle
(``dsp_tpu/golden/spot_hmm.py``) and the JAX package break ties.  JAX's
``vmap`` over streams is a leading batch dimension here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsp_tpu_torch.models.gmm_hmm import (NEG_INF, HmmParams, emission_logb,
                                          gmm_loglik_flat)


def _lr_diagonals(log_a: torch.Tensor):
    """log_a [W, S, S] -> (stay [W, S], advance [W, S-1])."""
    return (torch.diagonal(log_a, dim1=-2, dim2=-1),
            torch.diagonal(log_a, offset=1, dim1=-2, dim2=-1))


def _shift(x: torch.Tensor) -> torch.Tensor:
    """[..., S] -> state k takes state k-1's entry (state 0 keeps its own)."""
    return torch.cat([x[..., :1], x[..., :-1]], dim=-1)


def spot_viterbi(logb: torch.Tensor, log_a: torch.Tensor):
    """Open-begin Viterbi over streams for stacked word HMMs.

    logb [..., U, W, S] emission log-liks, log_a [W, S, S] left-right
    transitions.  Returns (v_last [..., W, U], start [..., W, U] int32):
    the best path log-lik ending at (frame j, last state) and its
    entry-frame witness."""
    *lead, u, w, s = logb.shape
    stay, adv = _lr_diagonals(log_a)
    carry_shape = (*lead, w, s)
    ninf_col = torch.full((*lead, w, 1), NEG_INF, dtype=logb.dtype, device=logb.device)
    is0 = torch.arange(s, device=logb.device) == 0
    v = torch.full(carry_shape, NEG_INF, dtype=logb.dtype, device=logb.device)
    st = torch.zeros(carry_shape, dtype=torch.int32, device=logb.device)
    zero = torch.zeros((), dtype=logb.dtype, device=logb.device)
    v_out, st_out = [], []
    for j in range(u):
        stay_v = v + stay
        adv_v = torch.cat([ninf_col, v[..., :-1] + adv], dim=-1)
        # tie order stay > advance...
        m = torch.maximum(stay_v, adv_v)
        sm = torch.where(stay_v >= adv_v, st, _shift(st))
        # ...and a fresh start (state 0) beats both on ties
        fresh = is0 & (m <= 0.0)
        m = torch.where(fresh, zero, m)
        sm = torch.where(fresh, j, sm)
        v = logb[..., j, :, :] + m
        st = sm
        v_out.append(v[..., -1])
        st_out.append(st[..., -1])
    return torch.stack(v_out, dim=-1), torch.stack(st_out, dim=-1)


def _llr_readout(v_last: torch.Tensor, starts: torch.Tensor, ubm_ll: torch.Tensor,
                 stream_len) -> torch.Tensor:
    """(v_last [..., W, U], starts [..., W, U], ubm_ll [..., U]) -> per-frame
    LLR [..., W, U], NEG_INF at frames >= ``stream_len`` ([...] or a number)."""
    u = v_last.shape[-1]
    p = torch.cat([torch.zeros_like(ubm_ll[..., :1]),
                   torch.cumsum(ubm_ll, dim=-1)], dim=-1)            # [..., U+1]
    j = torch.arange(u, device=v_last.device)
    span = (j - starts + 1).to(v_last.dtype)
    p_w = p[..., None, :].expand(*starts.shape[:-1], u + 1)
    ubm_span = p[..., None, 1:] - torch.take_along_dim(p_w, starts.long(), dim=-1)
    llr = (v_last - ubm_span) / span
    keep = j < torch.as_tensor(stream_len, device=v_last.device)[..., None, None]
    return torch.where(keep, llr, torch.full_like(llr, NEG_INF))


def _ubm_loglik(x: torch.Tensor, ubm) -> torch.Tensor:
    """x [..., F] -> per-frame UBM log-lik [...]."""
    means, log_var, log_mix = ubm
    return torch.logsumexp(gmm_loglik_flat(x, means, log_var) + log_mix, dim=-1)


def spot_hmm_batch(streams: torch.Tensor, stream_lens: torch.Tensor,
                   params: HmmParams, ubm):
    """Spot every word HMM in every stream.

    streams [B, U, F], stream_lens [B], params stacked [W, ...], ubm =
    (means [M, F], log_var [M, F], log_mix [M]).  Returns (llr [B, W, U],
    start [B, W, U] int32).  Frames past a stream's length get NEG_INF
    emissions, which keeps any path through them unusable (the readout
    masks them as well)."""
    logb = emission_logb(streams, params)                         # [B, U, W, S]
    valid = (torch.arange(streams.shape[1], device=streams.device)
             < stream_lens[:, None])[..., None, None]
    logb = torch.where(valid, logb, torch.full_like(logb, NEG_INF))
    v_last, starts = spot_viterbi(logb, params.log_a)
    return _llr_readout(v_last, starts, _ubm_loglik(streams, ubm), stream_lens), starts


# ---------------------------------------------------------------- streaming

class SpotHmmState(NamedTuple):
    """Frame-synchronous keyword/filler DP state (the streaming form).

    The offline readout looks the UBM prefix up at every path's entry
    frame; a stream cannot keep that prefix array unbounded, so each
    (word, state) path carries the prefix at its own entry beside the
    witness, and both ride the same max selections.

    v [W, S]      best path log-lik ending at each state, last frame.
    st [W, S]     entry-frame witness of that path (int32).
    p_st [W, S]   UBM log-lik prefix at that path's entry frame.
    p []          running UBM prefix (sum over all fed frames).
    n_fed [] i32  stream frames consumed so far."""

    v: torch.Tensor
    st: torch.Tensor
    p_st: torch.Tensor
    p: torch.Tensor
    n_fed: torch.Tensor


def spot_hmm_init(n_words: int, n_states: int, device: str | torch.device = "cuda",
                  dtype=torch.float32) -> SpotHmmState:
    shape = (n_words, n_states)
    return SpotHmmState(torch.full(shape, NEG_INF, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=torch.int32, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros((), dtype=dtype, device=device),
                        torch.zeros((), dtype=torch.int32, device=device))


def spot_hmm_chunk(state: SpotHmmState, chunk: torch.Tensor, n_valid,
                   params: HmmParams, ubm):
    """Advance the keyword/filler DP by a chunk of feature frames.

    chunk [C, F] (the first ``n_valid`` rows real; an int or an int
    tensor).  Returns (state', llr [W, C], start [W, C]): per-frame LLR
    fields matching the offline :func:`spot_hmm_batch` columns, NEG_INF
    at invalid frames.

    The DP is invariant to where chunks begin and end (the same
    sequential recurrence either way), so feeding one chunk shape is
    bit-exact under any tiling.  Across other chunk shapes the CPU's
    emission GEMMs may round apart (~1e-4 nats in the JAX package; the
    card's kernel scores each row alone), and against
    the offline readout the running UBM sum associates otherwise than
    its cumsum: witnesses stay equal, LLRs agree to the tolerances
    ``tests/test_torch_spot_hmm.py`` states."""
    w, s = params.log_pi.shape
    dev = chunk.device
    logb = emission_logb(chunk, params)                           # [C, W, S]
    ubm_ll = _ubm_loglik(chunk, ubm)                              # [C]
    stay, adv = _lr_diagonals(params.log_a)
    ninf_col = torch.full((w, 1), NEG_INF, dtype=logb.dtype, device=dev)
    is0 = torch.arange(s, device=dev) == 0
    zero = torch.zeros((), dtype=logb.dtype, device=dev)
    ninf = torch.full((), NEG_INF, dtype=logb.dtype, device=dev)
    valid = torch.arange(chunk.shape[0], device=dev) < n_valid
    v, st, p_st, p, j = state
    llrs, starts = [], []
    for col in range(chunk.shape[0]):
        ok = valid[col]
        stay_v = v + stay
        adv_v = torch.cat([ninf_col, v[:, :-1] + adv], dim=1)
        # tie order as spot_viterbi: stay > advance...
        take_stay = stay_v >= adv_v
        m = torch.maximum(stay_v, adv_v)
        sm = torch.where(take_stay, st, _shift(st))
        pm = torch.where(take_stay, p_st, _shift(p_st))
        # ...and a fresh start (state 0) beats both on ties; its entry
        # prefix is the running sum before this frame
        fresh = is0 & (m <= 0.0)
        m = torch.where(fresh, zero, m)
        sm = torch.where(fresh, j, sm)
        pm = torch.where(fresh, p, pm)
        v_new = logb[col] + m
        p_new = p + ubm_ll[col]
        span = (j - sm[:, -1] + 1).to(v_new.dtype)
        llr = (v_new[:, -1] - (p_new - pm[:, -1])) / span
        llrs.append(torch.where(ok, llr, ninf))
        starts.append(sm[:, -1])
        v = torch.where(ok, v_new, v)
        st = torch.where(ok, sm, st)
        p_st = torch.where(ok, pm, p_st)
        p = torch.where(ok, p_new, p)
        j = j + ok.to(torch.int32)
    return (SpotHmmState(v, st, p_st, p, j),
            torch.stack(llrs, dim=1), torch.stack(starts, dim=1))
