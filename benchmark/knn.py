"""What the entries of the kNN-DTW recognizer share: the set-up of a
cell from its configuration and the seed, the comparison with the plain
reference after the window, and the fields the per-layer metrics read.

An entry file (``entries/<entry>.py``) subclasses :class:`KnnCell` with
its own ``request`` and ``call``.  Every width the configuration states
(framing, spectrum, mel bands, cepstra, features) goes to the program
and to the reference alike; a configuration that asks for a front end
the reference does not implement is refused before any run.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark import check
from benchmark.reference import plain

# the front end's widths every configuration states
WIDTHS = ("frame_len", "hop", "n_fft", "n_mels", "n_mfcc", "lifter")


def widths(config: dict) -> dict:
    """The front end's widths of ``config``; refuses a feature width that
    is not the cepstra with their deltas and delta-deltas."""
    w = {k: int(config[k]) for k in WIDTHS}
    if int(config["n_feats"]) != 3 * w["n_mfcc"]:
        raise SystemExit(f"n_feats {config['n_feats']} is not 3 x n_mfcc {w['n_mfcc']}: the "
                         "reference stacks the cepstra with deltas and delta-deltas")
    return w


def t_max(config: dict) -> int:
    """Feature frames of a padded clip of ``max_samples``."""
    w = widths(config)
    return 1 + max(0, config["max_samples"] - w["frame_len"]) // w["hop"]


def pipeline_config(config: dict):
    from dsp_tpu_torch.config import DtwConfig, FrontendConfig, PipelineConfig

    w = widths(config)
    fe = FrontendConfig(sample_rate=config["sample_rate"], frame_len=w["frame_len"],
                        hop_len=w["hop"], n_fft=w["n_fft"], n_mels=w["n_mels"],
                        n_mfcc=w["n_mfcc"], lifter=w["lifter"])
    return PipelineConfig(frontend=fe,
                          dtw=DtwConfig(band_frac=config["band_frac"],
                                        max_warp_scale=config["max_warp_scale"]),
                          max_samples=config["max_samples"])


def frontend(config: dict, device, dtype=None) -> plain.Frontend:
    """The reference's front end at the configuration's widths."""
    w = widths(config)
    kw = {} if dtype is None else {"dtype": dtype}
    return plain.Frontend(config["sample_rate"], device, frame_len=w["frame_len"], hop=w["hop"],
                          n_fft=w["n_fft"], n_mels=w["n_mels"], n_mfcc=w["n_mfcc"],
                          lifter=w["lifter"], **kw)


def entry_idx(r: int, batch: int, pool: int) -> np.ndarray:
    """Pool indices of request ``r``: requests cycle through the pool
    (whole requests: the pool is a multiple of the request)."""
    return (r * batch + np.arange(batch)) % pool


class KnnCell:
    """A ``KnnDtwRecognizer`` with its bank enrolled from the seed's
    clips, and the request pool.  ``call`` returns (label ids [B],
    distances [B, K]) on the host."""

    guard_kernel = "dtw_banded"     # the trace must hold every launch of it

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from benchmark.data import synth
        from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer

        self.config, self.device = config, device
        self.batch = mix["request"]
        if mix["pool"] % self.batch:
            raise SystemExit(f"a pool of {mix['pool']} clips is no whole number of requests "
                             f"of {self.batch}")
        self.work = {"utterances": self.batch}
        words = config["words"]
        t0 = time.perf_counter()
        self.bank, self.bank_ids, self.pool, _ = synth.cell_inputs(
            words, config["templates_per_word"], mix["pool"], seed,
            config["sample_rate"], config["max_samples"])
        t1 = time.perf_counter()
        self.rec = KnnDtwRecognizer(pipeline_config(config), k=config["k"], device=device)
        for w, word in enumerate(words):
            self.rec.enroll(word, list(self.bank[self.bank_ids == w]))
        self.rec.device_bank()
        print(f"benchmark: set-up synthesis {t1 - t0} s, enrolment {time.perf_counter() - t1} s",
              file=sys.stderr, flush=True)

    def stages(self):
        """(module, function name) of the program's stages that a traced
        run spans."""
        from dsp_tpu_torch import pipeline

        return [(pipeline, n) for n in ("pad_signals", "extract_features", "classify_features")]

    def release(self) -> None:
        """Drop the program's state, so that the reference has the card."""
        self.rec = None

    def compare(self, items) -> tuple[dict, str]:
        """The compared numbers over the sampled ``items`` (pool indices,
        (label ids, distances)), and a note for standard error."""
        t = t_max(self.config)
        band, scale = self.config["band_frac"], self.config["max_warp_scale"]
        fe = frontend(self.config, self.device)
        b_side = check.side(fe, self.bank, t)
        worst = {"dist_gap": 0.0, "label_errors": 0}
        marginal = 0
        for idx, (ids, dists) in items:
            got = check.compare(ids, dists, self.bank_ids, check.side(fe, self.pool[idx], t),
                                b_side, band, scale)
            worst = {"dist_gap": max(worst["dist_gap"], got["dist_gap"]),
                     "label_errors": worst["label_errors"] + got["label_errors"]}
            marginal += got["marginal_clips"]
        return worst, f"{marginal} clips within the endpoint margin"

    def record(self, n_req: int) -> dict:
        """The fields the per-layer metrics read, beside the trace's."""
        t = t_max(self.config)
        fe = frontend(self.config, self.device)
        pool_lens = check.lengths(fe, self.pool, t)
        return {"batch": self.batch, "n_samples": self.config["max_samples"],
                "t_max": t, "n_feats": int(self.config["n_feats"]), **widths(self.config),
                "band_frac": self.config["band_frac"],
                "max_warp_scale": self.config["max_warp_scale"],
                "bank_lens": check.lengths(fe, self.bank, t),
                "request_lens": [pool_lens[entry_idx(r, self.batch, self.pool.shape[0])]
                                 for r in range(n_req)]}
