"""Level-synchronous connected-word Viterbi for the GMM-HMM family (port
of ``dsp_tpu/ops/connected_viterbi.py``).

The statistical twin of ``ops/level_building.py``: the joint DP threads
the query frames through the word HMM network instead of aligning them
against templates, so word count, identities and boundaries come out of
one dynamic program and gapless recordings decode without the VAD
splitter.

Semantics:

* entering word ``w`` at query frame ``t`` scores ``prev[t] -
  word_penalty + log_pi[w] + log_b[t, w, :]``;
* within a word, the usual Viterbi recursion through ``log_a[w]``; entry
  beats the within-word path only when strictly better (a tie stays
  within), and ``torch.max`` picks the first best predecessor state, as
  ``jnp.argmax``;
* a word exits only from its last state;
* ``scores[l, t]`` = best joint log-lik of exactly ``l+1`` words
  consuming query frames ``0..t``.

Emissions ``log_b [T, B, W, S]`` come from the family's float32 GEMM
scorer (``models/gmm_hmm.py:emission_logb``); each level is a Python loop
over frames carrying the ``[B, W, S]`` Viterbi front and an int32 token
plane (~12 small device ops a frame and level), the levels an outer
loop.  Values are floored at ``NEG_INF`` every step.  Callers negate the
scores and read them back with ``ops/level_building.backtrack`` (or
``backtrack_grammar``): ``NEG_INF`` (-1e30) maps onto BIG (1e30).

:func:`level_dp` is the grammar DP on emissions already computed (the
GMM-HMM's device batch path, ``gmm_hmm.recognize_level_batch``, replays
it whole from one CUDA graph), and :func:`backtrace_batch` the host
backtrace ``level_building.backtrack_grammar`` for every recording at
once on the planes' device, with the same choices bit for bit and no
read-back.
"""

from __future__ import annotations

import torch

from dsp_tpu_torch.models.gmm_hmm import NEG_INF, HmmParams, emission_logb
from dsp_tpu_torch.utils import profiling


def _scan(logb: torch.Tensor, entry: torch.Tensor, log_pi: torch.Tensor,
          log_a: torch.Tensor, per_word: bool):
    """The frame loop of one level.  ``logb [T, B, W, S]``; ``entry [B, T,
    1]`` (one value a frame) or ``[B, T, W]`` (a value a word, under a
    grammar).  Returns the word-exit scores and tokens ``[B, T, W]`` with
    ``per_word``, else the best word's ``(score [B, T], word [B, T] int32,
    start [B, T] int32)``."""
    t_frames, b, w, s = logb.shape
    dev = logb.device
    delta = torch.full((b, w, s), NEG_INF, dtype=torch.float32, device=dev)
    tok = torch.zeros((b, w, s), dtype=torch.int32, device=dev)
    outs = []
    for t in range(t_frames):
        # within-word transition: max-plus through log_a
        within, s_prev = torch.max(delta[..., :, None] + log_a, dim=2)
        tok_within = torch.take_along_dim(tok, s_prev, dim=2)
        enter = entry[:, t, :, None] + log_pi                 # [B, W, S]
        take_enter = enter > within
        delta = torch.clamp(torch.where(take_enter, enter, within) + logb[t],
                            min=NEG_INF)
        tok = torch.where(take_enter, t, tok_within)
        ends, tends = delta[:, :, s - 1], tok[:, :, s - 1]   # exit = last state
        if per_word:
            outs.append((ends, tends))
            continue
        score, word = torch.max(ends, dim=-1)
        outs.append((score, word,
                     torch.take_along_dim(tends, word[:, None], dim=1)[:, 0]))
    planes = [torch.stack(p, dim=1) for p in zip(*outs)]
    if not per_word:
        planes[1] = planes[1].to(torch.int32)
    return tuple(planes)


def _emissions(q_feats: torch.Tensor, params: HmmParams) -> torch.Tensor:
    """[B, T, F] -> frame-major log_b [T, B, W, S]."""
    return torch.movedim(emission_logb(q_feats, params), 1, 0).contiguous()


def connected_viterbi(q_feats: torch.Tensor, q_lens: torch.Tensor,
                      params: HmmParams, max_levels: int = 8,
                      word_penalty: float = 0.0):
    """Batched level-synchronous connected Viterbi.

    ``q_feats [B, T, F]`` whole-recording features (padding zeroed);
    ``q_lens [B]`` is read only by the backtrace; ``params`` the stacked
    word ``HmmParams`` ([W, S] log_pi, [W, S, S] log_a, GMM emissions);
    ``word_penalty`` is subtracted once a word.

    Returns ``(scores [B, L, T], words [B, L, T] int32, starts [B, L, T]
    int32)``: entry ``[l, t]`` is the best log-lik of ``l+1`` words
    consuming frames ``0..t``, its last word, and the frames consumed
    before that word began.
    """
    logb = _emissions(q_feats, params)
    t_frames, b = logb.shape[:2]
    dev = logb.device
    prev = torch.full((b, t_frames + 1), NEG_INF, dtype=torch.float32, device=dev)
    prev[:, 0] = 0.0
    floor = torch.full((b, 1), NEG_INF, dtype=torch.float32, device=dev)
    levels = []
    for _ in range(max_levels):
        entry = (prev[:, :t_frames] - word_penalty)[..., None]
        score, word, start = _scan(logb, entry, params.log_pi, params.log_a,
                                   per_word=False)
        prev = torch.cat([floor, score], dim=1)
        levels.append((score, word, start))
    return tuple(torch.stack(p, dim=1) for p in zip(*levels))


def connected_viterbi_grammar(q_feats: torch.Tensor, q_lens: torch.Tensor,
                              params: HmmParams, start_mask: torch.Tensor,
                              pair_mask: torch.Tensor, max_levels: int = 8,
                              word_penalty: float = 0.0):
    """Connected Viterbi under a finite-state word grammar.

    Entry into word ``w`` is gated by the word that ended the previous
    level (``pair_mask [W, W]``; ``start_mask [W]`` at level 0): a unit is
    a word here, so the label-level masks apply directly.  The best last
    word depends on its successor, so the planes keep the word axis:
    ``(scores [B, L, T, W], starts [B, L, T, W])``; callers negate the
    scores for ``level_building.backtrack_grammar``, where the end mask
    applies.
    """
    return level_dp(_emissions(q_feats, params), params.log_pi, params.log_a, start_mask,
                    pair_mask, max_levels, word_penalty)


def level_dp(logb: torch.Tensor, log_pi: torch.Tensor, log_a: torch.Tensor,
             start_mask: torch.Tensor, pair_mask: torch.Tensor, max_levels: int = 8,
             word_penalty: float = 0.0):
    """:func:`connected_viterbi_grammar` on frame-major emissions ``logb
    [T, B, U, S]`` of U units with ``log_pi [U, S]`` and dense ``log_a [U,
    S, S]`` (the max over predecessors runs over every state, so a unit
    may skip): ``(scores [B, L, T, U], starts [B, L, T, U])``.  Copies
    nothing from the host and reads nothing back, so a CUDA graph can
    hold it.  Spans ``dsp.connected``."""
    with profiling.stage("dsp.connected"):
        t_frames, b, u, _ = logb.shape
        dev = logb.device
        first = start_mask.to(torch.bool)[None, :].expand(u, u)
        prev = torch.full((b, t_frames + 1, u), NEG_INF, dtype=torch.float32, device=dev)
        prev[:, 0] = 0.0
        floor = torch.full((b, 1, u), NEG_INF, dtype=torch.float32, device=dev)
        levels = []
        for lvl in range(max_levels):
            mask = first if lvl == 0 else pair_mask.to(torch.bool)
            # the best ALLOWED predecessor's score (max-plus masked reduction)
            entry = torch.where(mask, prev[:, :t_frames, :, None], NEG_INF).amax(dim=2)
            entry = torch.clamp(entry - word_penalty, min=NEG_INF)   # [B, T, U]
            score, start = _scan(logb, entry, log_pi, log_a, per_word=True)
            prev = torch.cat([floor, score], dim=1)
            levels.append((score, start))
        return tuple(torch.stack(p, dim=1) for p in zip(*levels))


def backtrace_batch(scores: torch.Tensor, starts: torch.Tensor, t_valid: torch.Tensor,
                    pair_mask: torch.Tensor, end_mask: torch.Tensor):
    """``level_building.backtrack_grammar`` of every recording at once, on
    the planes' device, in the log-likelihood (max) convention.

    ``scores / starts [B, L, T, U]`` are :func:`level_dp`'s planes,
    ``t_valid [B]`` the recordings' frame counts, ``pair_mask [U, U]`` and
    ``end_mask [U]`` the grammar's.  Each choice is the host's on the
    negated planes: the terminal pick is the first maximum over (level,
    end unit) at the last valid frame, each step back the first allowed
    unit of highest score at the frame before the entry, and a recording
    whose best is below ``NEG_INF / 2`` (or has no frame) decodes to
    nothing.  Returns ``(unit ids [B, L] int32, -1 past each recording's
    count, counts [B] int32, final [B, L])``, ``final[b, l]`` the best end
    unit's score of ``l + 1`` units at the last valid frame (``NEG_INF``
    where there is none).  Spans ``dsp.backtrace``; no read-back."""
    with profiling.stage("dsp.backtrace"):
        b, levels, t_frames, u = scores.shape
        dev = scores.device
        rows = torch.arange(b, device=dev)
        tv = t_valid.to(torch.int64)
        t = torch.clamp(tv - 1, 0, t_frames - 1)
        ends = torch.where(end_mask.to(torch.bool), scores[rows, :, t], NEG_INF)  # [B, L, U]
        final = torch.where((tv > 0)[:, None], ends.amax(-1), NEG_INF)
        best, flat = ends.reshape(b, levels * u).max(-1)
        ok = (tv > 0) & (best > NEG_INF / 2)
        top = torch.div(flat, u, rounding_mode="floor")
        v = flat - top * u
        allowed_to = pair_mask.to(torch.bool).T                   # [v, u]: u may precede v
        ids = torch.full((b, levels), -1, dtype=torch.int32, device=dev)
        for lvl in range(levels - 1, -1, -1):
            active = ok & (top >= lvl)
            ids[:, lvl] = torch.where(active, v, -1).to(torch.int32)
            if lvl == 0:
                break
            back = torch.clamp(starts[rows, lvl, t, v].to(torch.int64) - 1, min=0)
            row = torch.where(allowed_to[v], scores[rows, lvl - 1, back], NEG_INF)
            v = torch.where(active, row.argmax(-1), v)
            t = torch.where(active, back, t)
        counts = torch.where(ok, top + 1, 0).to(torch.int32)
        return ids, counts, final
