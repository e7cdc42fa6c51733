"""Level-building connected-word decoding over a template bank (port of
``dsp_tpu/ops/level_building.py``).

The VAD splitter (``ops/vad.py:detect_segments`` -> ``pipeline.
decode_connected``) needs silence between words; level building (Myers &
Rabiner 1981, equivalently Ney's one-stage DP run a word level at a time)
chooses the word count, the words and their boundaries jointly, by
dynamic programming over (level, query frame, template, template frame),
so gapless recordings decode too.

Layout on the device:

* The local costs ``C[T, B, K, U]`` (query frame x recording x template x
  template frame) come from the squared-Euclidean expansion; the cross
  term is one batched fp32 product, a ``[B, F] @ [F, K*U]`` a frame
  (:func:`local_costs`).
* Each level is a Python loop over query frames carrying the live DP front
  ``[B, K, U]`` and an int32 token plane (the start frame of the word each
  cell lies in: token passing), batched over recordings; the levels are an
  outer loop.  About 15 small device ops a frame and level; no read-back
  inside a pass.
* The step set is query-synchronous, {(1,0),(1,1),(1,2)}: every query
  frame is consumed exactly once, so every decode of a T-frame recording
  sums exactly T local distances, costs compare across word counts, and
  the only cross-count bias is the explicit ``word_penalty``.

Semantics (the JAX package's, and ``dsp_tpu/golden/level_building.py``'s):

* entering template v at query frame t starts at template frame 0 and
  costs ``prev_level[t] + word_penalty + C[t, v, 0]``;
* within a word, ``dp[t, v, j] = C[t, v, j] + min(dp[t-1, v, j],
  dp[t-1, v, j-1], dp[t-1, v, j-2])``; the first minimum wins a tie, in
  that candidate order with the entry last (``torch.min`` returns the
  first index, as ``jnp.argmin``);
* a word ends only at its true last frame ``lens[v] - 1``;
* ``costs[l, t]`` = best cost of exactly ``l+1`` words consuming query
  frames ``0..t``; the host backtrace picks the level at the recording's
  last valid frame and follows the recorded (template, start) pairs.

Masked template frames carry the finite sentinel BIG, and the front is
clamped at BIG every step, so stacked masked costs never drift toward
float32 overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsp_tpu_torch.ops.dtw import BIG


def local_costs(q: torch.Tensor, bank: torch.Tensor, bank_lens: torch.Tensor,
                squared: bool = False) -> torch.Tensor:
    """Queries [B, T, F] x bank [K, U, F] -> local distances [T, B, K, U].

    Frame-major, so the DP reads one frame's plane as one block.  The
    cross term is ``torch.bmm`` over frames, one ``[B, F] @ [F, K*U]``
    product a frame: a frame's costs are then the same bits whether it is
    computed alone, in a chunk or in a whole recording, which
    :func:`level_build_chunk`'s bit-equality with :func:`level_build`
    needs (one ``[B*T, F]`` product rounds a row differently at other row
    counts on the CPU's BLAS).  Frames past a template's length are BIG.
    """
    b, t, f = q.shape
    k, u, _ = bank.shape
    bf = bank.reshape(k * u, f)
    qt = q.transpose(0, 1).contiguous()                       # [T, B, F]
    cross = torch.bmm(qt, bf.T.expand(t, f, k * u))           # [T, B, K*U]
    d = (qt * qt).sum(dim=-1, keepdim=True) + (bf * bf).sum(dim=-1)
    d.sub_(cross.mul_(2.0)).clamp_(min=0.0)
    d = d.reshape(t, b, k, u)
    if not squared:
        d.sqrt_()
    dead = torch.arange(u, device=bank.device)[None, :] >= bank_lens[:, None]
    return d.masked_fill_(dead, BIG)


def _end_index(bank_lens: torch.Tensor) -> torch.Tensor:
    """Each template's last frame [K] (int64): where a word may end."""
    return torch.clamp(bank_lens.to(torch.int64), min=1) - 1


def _scan(c: torch.Tensor, entry_costs: torch.Tensor, lens_idx: torch.Tensor,
          init=None, frame_offset: int = 0, per_template: bool = False):
    """The frame loop shared by both level passes.

    ``c [T, B, K, U]``; ``entry_costs [B, T, 1]`` (one entry value a frame)
    or ``[B, T, K]`` (a value a template, under a grammar).  Returns the
    per-frame outputs and the final front ``(dp, tok)`` [B, K, U]: with
    ``per_template`` the word-end costs and tokens ``[B, T, K]``, else the
    best word's ``(cost [B, T], word [B, T] int32, start [B, T] int32)``.
    """
    t_frames, b, k, u = c.shape
    dev = c.device
    # two BIG / zero columns in front: the j-1 and j-2 candidates are views
    dpp = torch.full((b, k, u + 2), BIG, dtype=torch.float32, device=dev)
    tokp = torch.zeros((b, k, u + 2), dtype=torch.int32, device=dev)
    if init is not None:
        dpp[..., 2:] = init[0]
        tokp[..., 2:] = init[1]
    dp, tok = dpp[..., 2:], tokp[..., 2:]
    entry = torch.full((b, k, u), BIG, dtype=torch.float32, device=dev)
    entry_tok = torch.empty((b, k, u), dtype=torch.int32, device=dev)
    rows = torch.arange(k, device=dev)
    cols = lens_idx + 2
    outs = []
    for t in range(t_frames):
        entry[:, :, 0] = entry_costs[:, t]
        entry_tok.fill_(frame_offset + t)
        best, sel = torch.min(torch.stack(
            [dp, dpp[..., 1:-1], dpp[..., :-2], entry]), dim=0)
        toks = torch.stack([tok, tokp[..., 1:-1], tokp[..., :-2], entry_tok])
        dp.copy_(best.add_(c[t]).clamp_(max=BIG))
        tok.copy_(torch.take_along_dim(toks, sel[None], dim=0)[0])
        ends, tends = dpp[:, rows, cols], tokp[:, rows, cols]      # [B, K]
        if per_template:
            outs.append((ends, tends))
            continue
        cost, word = torch.min(ends, dim=-1)
        outs.append((cost, word,
                     torch.take_along_dim(tends, word[:, None], dim=1)[:, 0]))
    planes = [torch.stack(p, dim=1) for p in zip(*outs)]
    if not per_template:
        planes[1] = planes[1].to(torch.int32)
    return tuple(planes), (dp, tok)


def level_pass(c: torch.Tensor, prev: torch.Tensor, lens_idx: torch.Tensor,
               word_penalty: float, init=None, frame_offset: int = 0,
               return_carry: bool = False):
    """ONE level of the DP over a batch of recordings.

    ``c [T, B, K, U]`` local costs, ``prev [B, T+1]`` (``prev[b, s]`` = best
    cost of the earlier levels consuming exactly ``s`` frames), ``lens_idx
    [K]`` template end frames.  Returns per query frame ``(cost [B, T],
    word [B, T] int32, start [B, T] int32)``.

    ``init`` / ``frame_offset`` / ``return_carry`` serve the streaming
    variant (:func:`level_build_chunk`): resume from a carried ``(dp,
    tok)`` front [B, K, U], number frames globally (tokens are absolute
    frame indices), and hand the final front back.
    """
    entry_costs = (prev[:, :c.shape[0]] + word_penalty)[..., None]
    planes, carry = _scan(c, entry_costs, lens_idx, init, frame_offset)
    return (planes, carry) if return_carry else planes


def level_build(q_feats: torch.Tensor, q_lens: torch.Tensor,
                bank_feats: torch.Tensor, bank_lens: torch.Tensor,
                max_levels: int = 8, word_penalty: float = 0.0,
                squared: bool = False):
    """Batched level-building DP.

    ``q_feats [B, T, F]`` whole-recording features (padding zeroed);
    ``q_lens [B]`` is read only by the backtrace (the DP runs the full T);
    bank ``[K, U, F]`` with lengths [K]; ``max_levels`` the most words;
    ``word_penalty`` is added once a word.

    Returns ``(costs [B, L, T], words [B, L, T] int32 template ids, starts
    [B, L, T] int32)``: entry ``[l, t]`` is the best decode of ``l+1``
    words consuming query frames ``0..t``, its last word's template, and
    how many frames the first ``l`` words consumed.
    """
    b, t, _ = q_feats.shape
    dev = q_feats.device
    c = local_costs(q_feats, bank_feats, bank_lens, squared)
    lens_idx = _end_index(bank_lens)
    prev = torch.full((b, t + 1), BIG, dtype=torch.float32, device=dev)
    prev[:, 0] = 0.0
    big = torch.full((b, 1), BIG, dtype=torch.float32, device=dev)
    levels = []
    for _ in range(max_levels):
        cost, word, start = level_pass(c, prev, lens_idx, word_penalty)
        # consuming 0 frames is impossible once a word has been decoded
        prev = torch.cat([big, cost], dim=1)
        levels.append((cost, word, start))
    return tuple(torch.stack(p, dim=1) for p in zip(*levels))


class LevelStreamState(NamedTuple):
    """Carried DP state of one stream's streaming level building.

    ``dp / tok [L, K, U]``: each level's live front (tokens are absolute
    frame indices); ``last_cost [L]``: each level's output at the last
    frame processed, the next chunk's first entry value for the level
    above; ``offset``: frames processed so far (host int)."""

    dp: torch.Tensor
    tok: torch.Tensor
    last_cost: torch.Tensor
    offset: int


def level_stream_init(max_levels: int, n_templates: int, u_max: int,
                      device: str | torch.device = "cuda") -> LevelStreamState:
    """Fresh stream state: every front dead, no frame seen."""
    shape = (max_levels, n_templates, u_max)
    return LevelStreamState(
        dp=torch.full(shape, BIG, dtype=torch.float32, device=device),
        tok=torch.zeros(shape, dtype=torch.int32, device=device),
        last_cost=torch.full((max_levels,), BIG, dtype=torch.float32,
                             device=device),
        offset=0)


def level_build_chunk(state: LevelStreamState, q_chunk: torch.Tensor,
                      bank_feats: torch.Tensor, bank_lens: torch.Tensor,
                      word_penalty: float = 0.0, squared: bool = False):
    """One chunk of streaming level building, bit-equal to the batch DP.

    The DP is frame-synchronous: level ``l`` at frame ``t`` needs only
    (l, t-1) and (l-1, t-1).  The levels run in order over the chunk's
    frames through the same :func:`level_pass`, and the only memory across
    chunks is the state.  A recording fed in any chunking reproduces
    :func:`level_build`'s planes bit for bit (tests/test_torch_level_building.py).

    ``q_chunk [T_c, F]``.  Returns ``(new_state, (costs, words, starts)
    [L, T_c])``: this chunk's columns of the planes; the caller
    concatenates them for :func:`backtrack` (tokens are already global).
    """
    dev = q_chunk.device
    c = local_costs(q_chunk[None], bank_feats, bank_lens, squared)
    t_c = c.shape[0]
    lens_idx = _end_index(bank_lens)
    # the virtual start: level 0 may be entered at the stream's first frame
    prev = torch.full((1, t_c + 1), BIG, dtype=torch.float32, device=dev)
    if state.offset == 0:
        prev[:, 0] = 0.0
    big = torch.full((1, 1), BIG, dtype=torch.float32, device=dev)
    fronts, levels = [], []
    for lvl in range(state.dp.shape[0]):
        (cost, word, start), (dp, tok) = level_pass(
            c, prev, lens_idx, word_penalty,
            init=(state.dp[lvl][None], state.tok[lvl][None]),
            frame_offset=state.offset, return_carry=True)
        # the level above enters at [c0, c1) from this level's outputs at
        # [c0 - 1, c1 - 1): the carried last one, then all but this last
        prev = torch.cat([state.last_cost[lvl].reshape(1, 1), cost[:, :-1], big],
                         dim=1)
        fronts.append((dp[0], tok[0], cost[0, -1]))
        levels.append((cost[0], word[0], start[0]))
    dp, tok, last = (torch.stack(p) for p in zip(*fronts))
    new_state = LevelStreamState(dp, tok, last, state.offset + t_c)
    return new_state, tuple(torch.stack(p) for p in zip(*levels))


def level_pass_grammar(c: torch.Tensor, prev: torch.Tensor, mask: torch.Tensor,
                       lens_idx: torch.Tensor, word_penalty: float):
    """ONE grammar-constrained level over a batch of recordings.

    As :func:`level_pass`, but the per-frame output keeps the template
    axis: under a word-pair grammar the best word ending at frame t
    depends on what follows it.  ``prev [B, T+1, K]`` is the previous
    level's plane and ``mask [K, K]`` the allowed (previous unit u -> unit
    v) transitions; a template's entry cost is the masked minimum over u,
    computed for every frame before the loop (it depends on ``prev``
    only).  Returns ``(cost [B, T, K], start [B, T, K])``.
    """
    p = prev[:, :c.shape[0], :, None]                         # [B, T, K(u), 1]
    entry = torch.where(mask, p, BIG).amin(dim=2)             # [B, T, K(v)]
    entry = torch.clamp(entry + word_penalty, max=BIG)
    planes, _ = _scan(c, entry, lens_idx, per_template=True)
    return planes


def level_build_grammar(q_feats: torch.Tensor, q_lens: torch.Tensor,
                        bank_feats: torch.Tensor, bank_lens: torch.Tensor,
                        start_mask: torch.Tensor, pair_mask: torch.Tensor,
                        max_levels: int = 8, word_penalty: float = 0.0,
                        squared: bool = False):
    """Batched level building under a word-pair grammar.

    The DP of :func:`level_build` with the inter-level entry constrained
    by unit-level masks (``ops/grammar.py:Grammar.unit_masks``):
    ``start_mask [K]`` gates which templates may begin the utterance,
    ``pair_mask [K, K]`` which template may follow which.  The end mask
    applies in :func:`backtrack_grammar`.  Returns ``(costs [B, L, T, K],
    starts [B, L, T, K])``, K times the unconstrained planes.
    """
    b, t, _ = q_feats.shape
    dev = q_feats.device
    k = bank_feats.shape[0]
    c = local_costs(q_feats, bank_feats, bank_lens, squared)
    lens_idx = _end_index(bank_lens)
    # level 0: the virtual start allows v iff start[v], whatever u is
    first = start_mask.to(torch.bool)[None, :].expand(k, k)
    prev = torch.full((b, t + 1, k), BIG, dtype=torch.float32, device=dev)
    prev[:, 0] = 0.0
    big = torch.full((b, 1, k), BIG, dtype=torch.float32, device=dev)
    levels = []
    for lvl in range(max_levels):
        mask = first if lvl == 0 else pair_mask.to(torch.bool)
        cost, start = level_pass_grammar(c, prev, mask, lens_idx, word_penalty)
        prev = torch.cat([big, cost], dim=1)
        levels.append((cost, start))
    return tuple(torch.stack(p, dim=1) for p in zip(*levels))


# ------------------------------------------------------------ host readouts
def backtrack_grammar(costs: np.ndarray, starts: np.ndarray,
                      pair_mask: np.ndarray, end_mask: np.ndarray,
                      t_valid: int, max_levels: int | None = None):
    """Host backtrace of ONE recording under a grammar.

    ``costs / starts`` are the [L, T, K] planes of
    :func:`level_build_grammar`.  The terminal pick applies ``end_mask``;
    each step back recomputes the DP's own entry choice: the
    ``pair_mask``-allowed template minimising the previous level's cost at
    the boundary (the same rule and tie order, lowest index).  Returns
    ``(template ids, cost)``; ``([], BIG)`` when the grammar admits no
    decode of the recording.
    """
    t_valid = int(t_valid)
    if t_valid <= 0:
        return [], float(BIG)
    levels = costs.shape[0] if max_levels is None else min(
        max_levels, costs.shape[0])
    final = np.where(end_mask[None, :], costs[:levels, t_valid - 1], BIG)
    l_star, v = np.unravel_index(np.argmin(final), final.shape)
    best = float(final[l_star, v])
    if best >= BIG / 2:
        return [], float(BIG)
    seq = []
    t = t_valid - 1
    v = int(v)
    for lvl in range(int(l_star), -1, -1):
        seq.append(v)
        entered = int(starts[lvl, t, v])
        if lvl > 0:
            prev_row = np.where(pair_mask[:, v],
                                costs[lvl - 1, entered - 1], BIG)
            v = int(np.argmin(prev_row))
            t = entered - 1
        elif entered != 0:   # pragma: no cover - DP invariant
            raise AssertionError(
                f"grammar backtrack did not land at frame 0 ({entered})")
    return seq[::-1], best


def backtrack(costs: np.ndarray, words: np.ndarray, starts: np.ndarray,
              t_valid: int, max_levels: int | None = None):
    """Host backtrace of ONE recording -> (template ids, level cost).

    ``costs / words / starts`` are the [L, T] planes of
    :func:`level_build`; ``t_valid`` the recording's true frame count.
    Returns ``([], BIG)`` when no level reaches the last frame.
    """
    t_valid = int(t_valid)
    if t_valid <= 0:
        return [], float(BIG)
    levels = costs.shape[0] if max_levels is None else min(
        max_levels, costs.shape[0])
    final = costs[:levels, t_valid - 1]
    l_star = int(np.argmin(final))
    best = float(final[l_star])
    if best >= BIG / 2:
        return [], float(BIG)
    seq = []
    t = t_valid - 1
    for lvl in range(l_star, -1, -1):
        seq.append(int(words[lvl, t]))
        t = int(starts[lvl, t]) - 1
    if t != -1:   # pragma: no cover - DP invariant (level 0 starts at 0)
        raise AssertionError(f"backtrack did not land at frame 0 (t={t})")
    return seq[::-1], best
