"""Plain reference of the connected-digit decode that the benchmark judges.

Written from the recognizer's stated equations, in plain PyTorch and
float64 by default, importing nothing of the program.  The units are
models of one or more topologies, given as groups: each group a mapping
of ``gmm_hmm.FIELDS`` arrays stacked over its units (``log_pi`` [W, S],
dense ``log_a`` [W, S, S], ``means`` / ``log_var`` [W, S, M, F],
``log_mix`` [W, S, M]), the groups in unit order.  Log-probabilities at
or below -1e29 (the program's stand-in for log 0) are log 0 here.
``log b_us(x_t)`` is ``gmm_hmm.log_emissions``'s direct form.  For level
l = 0 .. L-1, frame t and unit u:

* entry_l(t, u) = max over units v with pairs[v, u] of score_{l-1}(t-1,
  v), less the word penalty; at l = 0 it is minus the penalty at t = 0
  for the start units, log 0 elsewhere;
* delta_t(u, s) = max(entry_l(t, u) + log pi_u(s), max over every s' of
  delta_{t-1}(u, s') + log a_u(s', s)) + log b_us(x_t): the dense max,
  so a unit may skip states;
* score_l(t, u) = delta_t(u, last state of u);
* final[l] = max over end units u of score_l(len - 1, u); the decode is
  the best of them, traced back through each unit's entry frame (where
  entry and a path within tie, the path within is kept) and, at each
  boundary, the first allowed unit of highest score.

:func:`forced_score` is the plain Viterbi score of a given unit sequence
through the concatenated models (the last state of one unit to the
entry states of the next, between frames).  ``dtype`` sets the precision
of every sum; TF32 is off inside.  Recordings run in blocks of
:data:`BLOCK`, so that a request fits on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gmm_hmm, plain

BLOCK = 256           # recordings a block
LOG0 = -1e29          # log-probabilities at or below this are log 0


def group_tensors(groups, device, dtype=torch.float64) -> list[dict]:
    """The groups' arrays as tensors, log 0 as -inf."""
    out = []
    for g in groups:
        p = gmm_hmm.as_tensors(g, device, dtype)
        for k in ("log_pi", "log_a"):
            p[k] = torch.where(p[k] <= LOG0, -torch.inf, p[k])
        out.append(p)
    return out


def features(fe: plain.Frontend, clips, n_samples, t_max: int):
    """Whole-recording features (no endpoint detector) of ``clips`` [B, N]
    with true lengths ``n_samples`` [B]: (features [B, t_max, 39],
    lengths [B])."""
    x = torch.as_tensor(np.asarray(clips), device=fe.device)
    n = torch.as_tensor(np.asarray(n_samples), dtype=torch.int64, device=fe.device)
    end = torch.clamp(1 + torch.div(n - fe.frame_len, fe.hop, rounding_mode="floor"), min=0)
    return plain.features(fe.cepstra(x), torch.zeros_like(end), end, t_max)


def _emissions(feats: torch.Tensor, p: list[dict]) -> list[torch.Tensor]:
    return [gmm_hmm.log_emissions(feats, g) for g in p]       # [B, T, W_g, S_g] each


def _step(delta, tok, entry, t, g, logb_t):
    """One frame of one group: delta / tok [B, W, S] (tok the frame its
    unit was entered), entry [B, W]."""
    within, arg = (delta[..., :, None] + g["log_a"]).max(dim=-2)
    enter = entry[..., None] + g["log_pi"]
    take = enter > within
    return (torch.where(take, enter, within) + logb_t,
            torch.where(take, t, torch.take_along_dim(tok, arg, dim=-1)))


def _level_planes(feats, lens, p, start, pairs, end, max_levels, word_penalty):
    """(final [B, L], scores [L, B, T, U], entry frames [L, B, T, U]) of one
    block."""
    b, _, _ = feats.shape
    dev, dtype = feats.device, feats.dtype
    t_eff = int(lens.max())
    logb = _emissions(feats, p)
    sizes = [g["log_pi"].shape[0] for g in p]
    u = sum(sizes)
    ninf = torch.tensor(-torch.inf, dtype=dtype, device=dev)
    rows = torch.arange(b, device=dev)
    last = torch.clamp(lens - 1, min=0)
    finals, planes = [], []
    prev = None
    for lvl in range(max_levels):
        entry = torch.full((b, t_eff, u), -torch.inf, dtype=dtype, device=dev)
        if lvl == 0:
            entry[:, 0] = torch.where(start, 0.0, ninf)
        else:      # entry at t from exits at t - 1
            entry[:, 1:] = torch.where(pairs, prev[:, :-1, :, None], ninf).amax(dim=2)
        entry = entry - word_penalty
        deltas = [torch.full((b, *g["log_pi"].shape), -torch.inf, dtype=dtype, device=dev)
                  for g in p]
        toks = [torch.zeros((b, *g["log_pi"].shape), dtype=torch.int64, device=dev)
                for g in p]
        score = torch.empty((b, t_eff, u), dtype=dtype, device=dev)
        entered = torch.empty((b, t_eff, u), dtype=torch.int64, device=dev)
        for t in range(t_eff):
            u0 = 0
            for i, g in enumerate(p):
                w = sizes[i]
                deltas[i], toks[i] = _step(deltas[i], toks[i], entry[:, t, u0:u0 + w], t, g,
                                           logb[i][:, t])
                score[:, t, u0:u0 + w] = deltas[i][..., -1]
                entered[:, t, u0:u0 + w] = toks[i][..., -1]
                u0 += w
        prev = score
        planes.append((score, entered))
        finals.append(torch.where(end, score[rows, last], ninf).amax(-1))
    out = torch.stack(finals, dim=1)
    return torch.where((lens > 0)[:, None], out, ninf), planes


def _backtrace(planes, lens, pairs, end):
    """The unit sequence of each recording of a block (host loops)."""
    scores = [s.cpu().numpy() for s, _ in planes]
    entered = [e.cpu().numpy() for _, e in planes]
    pairs, end = pairs.cpu().numpy(), end.cpu().numpy()
    seqs = []
    for r, n in enumerate(lens.cpu().numpy()):
        fin = np.stack([np.where(end, s[r, n - 1], -np.inf) for s in scores]) if n > 0 \
            else np.full((1, 1), -np.inf)
        lvl, v = np.unravel_index(np.argmax(fin), fin.shape)
        if not np.isfinite(fin[lvl, v]):
            seqs.append([])
            continue
        seq, t = [], n - 1
        for level in range(int(lvl), -1, -1):
            seq.append(int(v))
            t0 = int(entered[level][r, t, v])
            if level:
                v = int(np.argmax(np.where(pairs[:, v], scores[level - 1][r, t0 - 1], -np.inf)))
                t = t0 - 1
        seqs.append(seq[::-1])
    return seqs


def level_decode(feats: torch.Tensor, lens: torch.Tensor, groups, start, pairs, end,
                 max_levels: int, word_penalty: float = 0.0, dtype=torch.float64):
    """Features [B, T, F] and lengths [B] -> (final [B, L] in ``dtype``, the
    best score of l + 1 units ending in an end unit at the last valid
    frame, -inf where the grammar admits none; the best decode's unit
    sequence of each recording, [] where there is none).  ``start`` /
    ``end`` [U] and ``pairs`` [U, U] are the grammar's boolean masks."""
    dev = feats.device
    with gmm_hmm.no_tf32():
        p = group_tensors(groups, dev, dtype)
        m = [torch.as_tensor(np.asarray(x), dtype=torch.bool, device=dev)
             for x in (start, pairs, end)]
        lens = torch.as_tensor(lens, device=dev).to(torch.int64)
        finals, seqs = [], []
        for lo in range(0, feats.shape[0], BLOCK):
            fin, planes = _level_planes(feats[lo:lo + BLOCK].to(dtype), lens[lo:lo + BLOCK],
                                        p, *m, max_levels, word_penalty)
            finals.append(fin)
            seqs += _backtrace(planes, lens[lo:lo + BLOCK], m[1], m[2])
        return torch.cat(finals), seqs


def forced_score(feats: torch.Tensor, lens: torch.Tensor, groups, seqs,
                 word_penalty: float = 0.0, dtype=torch.float64) -> torch.Tensor:
    """The Viterbi score [B] of each recording through the concatenation
    of its unit sequence ``seqs[b]`` (unit ids in the groups' order): the
    sequence's first unit enters at frame 0, each next one at the frame
    after its predecessor's last state, the last ends in its last state
    at the last valid frame; each unit pays ``word_penalty``.  An empty
    sequence scores -inf."""
    dev = feats.device
    with gmm_hmm.no_tf32():
        p = group_tensors(groups, dev, dtype)
        lens = torch.as_tensor(lens, device=dev).to(torch.int64)
        units = [(g, i) for g in p for i in range(g["log_pi"].shape[0])]
        s_max = max(g["log_pi"].shape[1] for g in p)
        out = []
        for lo in range(0, feats.shape[0], BLOCK):
            out.append(_forced(feats[lo:lo + BLOCK].to(dtype), lens[lo:lo + BLOCK], p, units,
                               s_max, seqs[lo:lo + BLOCK], word_penalty))
        return torch.cat(out)


def _forced(feats, lens, p, units, s_max, seqs, word_penalty):
    b = feats.shape[0]
    dev, dtype = feats.device, feats.dtype
    k_max = max(1, max(len(s) for s in seqs))
    t_eff = int(lens.max())
    # every unit's emissions, its states first and log 0 after: [B, T, U, S_max]
    lb = torch.cat([torch.nn.functional.pad(e, (0, s_max - e.shape[-1]), value=-torch.inf)
                    for e in _emissions(feats, p)], dim=2)
    pi = torch.full((len(units), s_max), -torch.inf, dtype=dtype, device=dev)
    a = torch.full((len(units), s_max, s_max), -torch.inf, dtype=dtype, device=dev)
    n_states = []
    for j, (g, i) in enumerate(units):
        s = g["log_pi"].shape[1]
        pi[j, :s], a[j, :s, :s] = g["log_pi"][i], g["log_a"][i]
        n_states.append(s)
    seq = torch.zeros((b, k_max), dtype=torch.int64, device=dev)
    used = torch.zeros((b, k_max), dtype=torch.bool, device=dev)
    for r, s in enumerate(seqs):
        seq[r, :len(s)] = torch.as_tensor(list(s), dtype=torch.int64)
        used[r, :len(s)] = True
    last = torch.as_tensor(n_states, device=dev)[seq] - 1                # [B, K]
    pi_k = torch.where(used[..., None], pi[seq], -torch.inf)             # [B, K, S]
    a_k = a[seq]                                                         # [B, K, S, S]
    rows = torch.arange(b, device=dev)[:, None]
    ks = torch.arange(k_max, device=dev)[None, :]
    ninf = torch.full((b, 1), -torch.inf, dtype=dtype, device=dev)
    delta = torch.full((b, k_max, s_max), -torch.inf, dtype=dtype, device=dev)
    for t in range(t_eff):
        logb_t = lb[:, t][rows, seq]                                     # [B, K, S]
        if t == 0:
            exits = torch.cat([torch.zeros_like(ninf), ninf.expand(b, k_max - 1)], dim=1)
        else:
            ends = delta[rows, ks, last]                                 # [B, K]
            exits = torch.cat([ninf, ends[:, :-1]], dim=1)
        within = (delta[..., :, None] + a_k).amax(dim=-2)
        new = torch.maximum(within, (exits - word_penalty)[..., None] + pi_k) + logb_t
        delta = torch.where((t < lens)[:, None, None], new, delta)
    n = used.sum(1)
    k_last = torch.clamp(n - 1, min=0)
    score = delta[rows[:, 0], k_last, last[rows[:, 0], k_last]]
    return torch.where(n > 0, score, torch.full_like(score, -torch.inf))
