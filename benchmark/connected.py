"""What the connected-digit cell (``aurora2-connected``) needs: its set-up
from the configuration and the seed (the digit models fitted as the
isolated cell fits them, the silence model on the seed's noise, the
strings of the pool), the comparison with the plain reference
(``reference/connected.py``) after the window, and the fields the
per-layer metrics read.

``call`` gives, for every string of a request, the program's unit ids
[B, L] (-1 past each count), counts [B] and final scores [B, L] on the
host.  Two numbers are compared, each with a limit from the
configuration's file (``limits``):

* ``score_gap``: the widest relative gap |f - f_ref| / |f_ref| over every
  (string, level) of the final scores: the best score of l + 1 units
  ending in an end unit at the string's last frame.  Where exactly one
  side is finite (the program's NEG_INF, -1e30, reads as not finite) it
  reads ``inf``; where neither is, 0.  The reference takes the program's
  fitted models, read back at set-up, and the same strings through its
  own front end; so both sides share the fit, and set-up holds the
  models to the configuration's shapes and topology
  (:func:`topology_faults`).
* ``label_errors``: strings whose program unit sequence the grammar does
  not allow, or whose score by forced alignment through the reference
  lies further below the reference's best decode than the ``score_gap``
  limit (relative).  Where the fitted models are not the configuration's,
  every compared string counts as one.

:func:`control` is the reference in the program's place one precision
down: its front end in float32 with TF32 products, its emissions and
decode in float32.  The comparison has to fail it.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from benchmark import check, hmm, knn
from benchmark.reference import connected as ref

LOG0 = -1e29        # program scores at or below this are not finite


def _relgap(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """|p - r| / |r|; inf where exactly one side is finite, 0 where neither."""
    pf, rf = p > LOG0, torch.isfinite(r)
    g = (p - r).abs() / r.abs()
    g = torch.where(pf & rf, g, torch.full_like(g, torch.inf))
    return torch.where(~pf & ~rf, torch.zeros_like(g), g)


def _allowed(seq, masks) -> bool:
    start, pairs, end = masks
    return bool(len(seq) and start[seq[0]] and end[seq[-1]]
                and all(pairs[a, b] for a, b in zip(seq, seq[1:])))


def topology_faults(groups, config: dict) -> list[str]:
    """How the fitted models ``groups`` (the digits', then ``sil``'s, as
    numpy dicts of ``HmmParams``) depart from the configuration: the
    shapes [W, n_states, n_mix, n_feats] and [1, sil_states, sil_mix,
    n_feats]; each model entered at its first state only; the digits
    left-to-right with no skips; ``sil`` left-to-right with HTK's skips
    from its first state to its third and back, each of probability
    ``sil_skip / (1 + sil_skip)`` after the rows were renormalised."""
    f = config["n_feats"]
    want = [((len(config["words"]), config["n_states"], config["n_mix"], f), 0.0),
            ((1, config["sil_states"], config["sil_mix"], f), config["sil_skip"])]
    faults = []
    for name, g, (shape, skip) in zip(("digits", "sil"), groups, want):
        if g["means"].shape != shape:
            faults.append(f"{name}: means {g['means'].shape}, the configuration {shape}")
            continue
        s = shape[1]
        lr = np.eye(s, dtype=bool) | np.eye(s, k=1, dtype=bool)
        if skip:
            lr[0, 2] = lr[2, 0] = True
        first = np.arange(s) == 0
        if not ((g["log_a"] > LOG0) == lr).all() or not ((g["log_pi"] > LOG0) == first).all():
            faults.append(f"{name}: transitions or entries other than the configuration's")
        elif skip:
            got = np.exp(g["log_a"][:, [0, 2], [2, 0]].astype(np.float64))
            if not np.allclose(got, skip / (1.0 + skip), rtol=1e-5, atol=0.0):
                faults.append(f"{name}: skips of {got.ravel()}, not {skip / (1.0 + skip)}")
    return faults


def compare(ids, counts, final, feats, lens, groups, masks, max_levels: int,
            word_penalty: float, limit: float) -> dict:
    """The compared numbers of one request: the program's ``ids`` [B, L],
    ``counts`` [B] and ``final`` [B, L] against the reference's decode of
    the features ``feats`` [B, T, F] with lengths ``lens`` [B]."""
    r_final, _ = ref.level_decode(feats, lens, groups, *masks, max_levels, word_penalty)
    p = torch.as_tensor(np.asarray(final, dtype=np.float64), device=r_final.device)
    gap = float(_relgap(p, r_final).max())
    seqs = [[int(v) for v in ids[b, :int(counts[b])]] for b in range(len(counts))]
    forced = ref.forced_score(feats, lens, groups, seqs, word_penalty).cpu().numpy()
    best = r_final.amax(-1).cpu().numpy()
    errors = 0
    for b, seq in enumerate(seqs):
        if not np.isfinite(best[b]):
            errors += int(bool(seq))
        elif not _allowed(seq, masks) or not forced[b] >= best[b] - limit * abs(best[b]):
            errors += 1
    return {"score_gap": gap, "label_errors": errors}


def control(fe32, clips, lens, t_max: int, groups, masks, max_levels: int,
            word_penalty: float):
    """The reference in the program's place, its front end ``fe32`` in
    float32 with TF32 products and its decode in float32: (ids [B, L],
    counts [B], final [B, L]) as the program gives them."""
    with check.tf32():
        feats, n = ref.features(fe32, clips, lens, t_max)
    final, seqs = ref.level_decode(feats, n, groups, *masks, max_levels, word_penalty,
                                   dtype=torch.float32)
    ids = np.full((len(seqs), max_levels), -1, dtype=np.int64)
    for b, s in enumerate(seqs):
        ids[b, :len(s)] = s
    return ids, np.asarray([len(s) for s in seqs]), final.cpu().numpy()


class ConnectedCell:
    """A ``GmmHmmRecognizer`` holding the seed's digit models and silence
    model, and the pool of strings."""

    guard_kernel = "gmm_emissions"     # the trace must hold every launch of it

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from benchmark.data import strings, synth
        from dsp_tpu_torch.config import HmmConfig
        from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer, params_to_numpy

        self.config, self.device = config, device
        self.batch = mix["request"]
        if mix["pool"] % self.batch:
            raise SystemExit(f"a pool of {mix['pool']} strings is no whole number of requests "
                             f"of {self.batch}")
        self.work = {"utterances": self.batch}
        self.max_levels, self.word_penalty = config["max_levels"], config["word_penalty"]
        words, sr = config["words"], config["sample_rate"]
        t0 = time.perf_counter()
        ids = np.repeat(np.arange(len(words)), config["train_per_word"])
        base = int(seed) * synth.SEED_STRIDE
        train = synth.clips([words[i] for i in ids], [base + j for j in range(len(ids))], sr,
                            config["train_max_samples"])
        quiet = strings.silence(config["sil_train"], seed, sr, config["sil_seconds"])
        self.pool, self.pool_lens, self.truth, redrawn = strings.pool(
            words, mix["pool"], seed, sr, config["max_samples"])
        t1 = time.perf_counter()
        train_cfg = hmm.pipeline_config(dict(config, max_samples=config["train_max_samples"]))
        self.cfg = dataclasses.replace(hmm.pipeline_config(config), use_vad=config["use_vad"])
        self.rec = GmmHmmRecognizer(train_cfg, hmm.hmm_config(config, seed), device=device)
        self.rec.fit({w: list(train[ids == i]) for i, w in enumerate(words)})
        self.rec.fit_silence(list(quiet), HmmConfig(
            n_states=config["sil_states"], n_mix=config["sil_mix"],
            var_floor=config["var_floor"], n_iter=config["n_iter"],
            train_mode=config["train_mode"], seed=int(seed) + len(words)),
            skip=config["sil_skip"])
        self.units = self.rec.unit_labels()
        self.masks = tuple(np.asarray(m, bool) for m in self.rec.resolve_grammar(
            config["grammar"]))
        # the reference's copy of the fitted models, read back while the program holds them
        self.groups = [params_to_numpy(self.rec.device_params())._asdict(),
                       params_to_numpy(self.rec.sil)._asdict()]
        self.faults = topology_faults(self.groups, config)
        print(f"benchmark: set-up synthesis {t1 - t0} s ({redrawn} strings drawn again for "
              f"being longer than {config['max_samples']} samples), fit "
              f"{time.perf_counter() - t1} s", file=sys.stderr, flush=True)

    def stages(self):
        """(module, function name) of the program's stages that a traced
        run spans."""
        from dsp_tpu_torch.models import gmm_hmm

        return [(gmm_hmm, "recognize_level_batch"), (gmm_hmm, "network_logb")]

    def release(self) -> None:
        """Drop the program's state, so that the reference has the card."""
        self.rec = None

    def _truth_ids(self, idx):
        index = {w: i for i, w in enumerate(self.units)}
        return [[index[w] for w in self.truth[i]] for i in idx]

    def compare(self, items) -> tuple[dict, str]:
        """The compared numbers over the sampled ``items`` (pool indices,
        (ids, counts, final)), and a note for standard error: how many
        strings the program decoded to their true digits."""
        t = knn.t_max(self.config)
        fe = knn.frontend(self.config, self.device)
        limit = self.config["limits"]["score_gap"]
        sil = self.units.index("sil")
        worst = {"score_gap": 0.0, "label_errors": 0}
        right = total = 0
        for idx, (ids, counts, final) in items:
            feats, lens = ref.features(fe, self.pool[idx], self.pool_lens[idx], t)
            got = compare(ids, counts, final, feats, lens, self.groups, self.masks,
                          self.max_levels, self.word_penalty, limit)
            worst = {"score_gap": max(worst["score_gap"], got["score_gap"]),
                     "label_errors": worst["label_errors"] + got["label_errors"]}
            for b, want in enumerate(self._truth_ids(idx)):
                said = [int(v) for v in ids[b, :int(counts[b])] if v != sil]
                right += int(said == want)
                total += 1
        note = f"{right} of {total} strings decoded to their true digits"
        if self.faults:      # models other than the configuration's: no string is right
            worst["label_errors"] = max(worst["label_errors"], total)
            note += "; the fitted models are not the configuration's: " + "; ".join(self.faults)
        return worst, note

    def record(self, n_req: int) -> dict:
        """The fields the per-layer metrics read, beside the trace's."""
        t = knn.t_max(self.config)
        w = knn.widths(self.config)
        frames = np.minimum(1 + np.maximum(self.pool_lens - w["frame_len"], 0) // w["hop"], t)
        n_pool = self.pool.shape[0]
        return {"batch": self.batch, "n_samples": self.config["max_samples"], "t_max": t,
                "n_feats": int(self.config["n_feats"]), **w,
                "groups": [(g["means"].shape[0], g["means"].shape[1], g["means"].shape[2])
                           for g in self.groups],
                "transitions": int(sum((g["log_a"] > LOG0).sum() for g in self.groups)),
                "max_levels": self.max_levels,
                "request_lens": [frames[knn.entry_idx(r, self.batch, n_pool)]
                                 for r in range(n_req)]}
