"""What the entries of the GMM-HMM recognizer share: the set-up of a cell
from its configuration and the seed (the word models fitted on the
seed's training clips), the comparison with the plain reference
(``reference/gmm_hmm.py``) after the window, and the fields the
per-layer metrics read.

Two numbers are compared, each with a limit from the configuration's
file (``limits``):

* ``score_gap``: the widest relative gap |s - s_ref| / |s_ref| over every
  (utterance, word) Viterbi log-likelihood of the sampled requests; a
  score that is not finite on either side reads ``inf``.  The reference
  takes the program's fitted word models, read back at set-up, and the
  same clips through its own front end.  Where a frame of a clip lies
  within the rounding margin of an endpoint threshold (``check.side``),
  the reference scores each window the detector may find there, and the
  window whose scores lie nearest counts.
* ``label_errors``: utterances whose label is not a word whose reference
  score lies within the ``score_gap`` limit (relative) of the
  reference's best.

:func:`control` is the reference in the program's place one precision
down: its front end in float32 with TF32 products, its emissions and
decode in float32.  The comparison has to fail it.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import check, knn
from benchmark.reference import gmm_hmm as ref


def pipeline_config(config: dict):
    from dsp_tpu_torch.config import FrontendConfig, PipelineConfig

    w = knn.widths(config)
    fe = FrontendConfig(sample_rate=config["sample_rate"], frame_len=w["frame_len"],
                        hop_len=w["hop"], n_fft=w["n_fft"], n_mels=w["n_mels"],
                        n_mfcc=w["n_mfcc"], lifter=w["lifter"])
    return PipelineConfig(frontend=fe, max_samples=config["max_samples"])


def hmm_config(config: dict, seed: int):
    """The word models' shape and training; the initial draws from ``seed``."""
    from dsp_tpu_torch.config import HmmConfig

    return HmmConfig(n_states=config["n_states"], n_mix=config["n_mix"],
                     var_floor=config["var_floor"], n_iter=config["n_iter"],
                     train_mode=config["train_mode"], seed=int(seed))


def _relgap(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """|p - r| / |r| elementwise; inf where either is not finite."""
    g = (p - r).abs() / r.abs()
    return torch.where(torch.isfinite(p) & torch.isfinite(r), g, torch.full_like(g, torch.inf))


def compare(prog_ids, prog_scores, q: check.Side, params: dict, limit: float) -> dict:
    """The compared numbers of one request: ``prog_ids`` [B] and
    ``prog_scores`` [B, W] as the program returned them for the clips of
    ``q``, against the reference's scores of ``q`` under ``params``."""
    dev = q.feats.device
    r = ref.word_scores(q.feats, q.lens, params)
    p = torch.as_tensor(np.asarray(prog_scores, dtype=np.float64), device=dev)
    gap = _relgap(p, r).amax(-1)
    for i, alts in q.alts.items():
        for f, ln in alts:
            r_i = ref.word_scores(f, ln, params)[0]
            g = _relgap(p[i], r_i).amax()
            if g < gap[i]:
                gap[i], r[i] = g, r_i
    best = r.amax(-1, keepdim=True)
    near = (r >= best - limit * best.abs()).cpu().numpy()
    ids = np.asarray(prog_ids).astype(np.int64)
    errors = sum(int(not (0 <= k < near.shape[1] and near[i, k])) for i, k in enumerate(ids))
    return {"score_gap": float(gap.max()), "label_errors": errors,
            "marginal_clips": len(q.alts)}


def control(fe32, queries: np.ndarray, params: dict, t_max: int):
    """The reference in the program's place, its front end ``fe`` in
    float32 with TF32 products and its scores in float32: (label ids [B],
    scores [B, W])."""
    with check.tf32():
        q = check.side(fe32, queries, t_max)
    s = ref.word_scores(q.feats, q.lens, params, dtype=torch.float32)
    return s.argmax(-1).cpu().numpy(), s.cpu().numpy()


class HmmCell:
    """A ``GmmHmmRecognizer`` fitted on the seed's training clips, and the
    request pool.  ``call`` returns (word ids [B], scores [B, W]) on the
    host, in the recognizer's ``labels`` order."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from benchmark.data import synth
        from dsp_tpu_torch.models.gmm_hmm import GmmHmmRecognizer, params_to_numpy

        self.config, self.device = config, device
        self.batch = mix["request"]
        if mix["pool"] % self.batch:
            raise SystemExit(f"a pool of {mix['pool']} clips is no whole number of requests "
                             f"of {self.batch}")
        self.work = {"utterances": self.batch}
        words = config["words"]
        t0 = time.perf_counter()
        self.train, self.train_ids, self.pool, _ = synth.cell_inputs(
            words, config["train_per_word"], mix["pool"], seed, config["sample_rate"],
            config["max_samples"])
        t1 = time.perf_counter()
        self.rec = GmmHmmRecognizer(pipeline_config(config), hmm_config(config, seed),
                                    device=device)
        self.rec.fit({w: list(self.train[self.train_ids == i]) for i, w in enumerate(words)})
        # the reference's copy of the fitted models, read back while the program holds them
        self.params = params_to_numpy(self.rec.device_params())._asdict()
        print(f"benchmark: set-up synthesis {t1 - t0} s, fit {time.perf_counter() - t1} s",
              file=sys.stderr, flush=True)

    def stages(self):
        """(module, function name) of the program's stages that a traced
        run spans."""
        from dsp_tpu_torch import pipeline
        from dsp_tpu_torch.models import gmm_hmm

        return [(gmm_hmm, "recognize_batch"), (pipeline, "extract_features"),
                (gmm_hmm, "score_words")]

    def release(self) -> None:
        """Drop the program's state, so that the reference has the card."""
        self.rec = None

    def compare(self, items) -> tuple[dict, str]:
        """The compared numbers over the sampled ``items`` (pool indices,
        (word ids, scores)), and a note for standard error."""
        t = knn.t_max(self.config)
        fe = knn.frontend(self.config, self.device)
        limit = self.config["limits"]["score_gap"]
        worst = {"score_gap": 0.0, "label_errors": 0}
        marginal = 0
        for idx, (ids, scores) in items:
            got = compare(ids, scores, check.side(fe, self.pool[idx], t), self.params, limit)
            worst = {"score_gap": max(worst["score_gap"], got["score_gap"]),
                     "label_errors": worst["label_errors"] + got["label_errors"]}
            marginal += got["marginal_clips"]
        return worst, f"{marginal} clips within the endpoint margin"

    def record(self, n_req: int) -> dict:
        """The fields the per-layer metrics read, beside the trace's."""
        t = knn.t_max(self.config)
        pool_lens = check.lengths(knn.frontend(self.config, self.device), self.pool, t)
        return {"batch": self.batch, "n_samples": self.config["max_samples"], "t_max": t,
                "n_feats": int(self.config["n_feats"]), **knn.widths(self.config),
                "n_words": len(self.config["words"]), "n_states": self.config["n_states"],
                "n_mix": self.config["n_mix"],
                "request_lens": [pool_lens[knn.entry_idx(r, self.batch, self.pool.shape[0])]
                                 for r in range(n_req)]}
