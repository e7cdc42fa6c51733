"""kNN-DTW isolated-word recognizer (port of ``dsp_tpu/models/knn_dtw.py``).

The template bank is one padded tensor ``[K, U_max, F]`` with a length
vector on the recognizer's device, so classifying against the whole
vocabulary is one all-pairs DTW (the banded DTW kernel on CUDA).

Checkpoints are the JAX package's ``.npz`` format, key for key: a bank
enrolled by either package loads in the other (:meth:`KnnDtwRecognizer.load`,
:meth:`KnnDtwRecognizer.from_arrays`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import PipelineConfig

NO_MATCH = "<no-match>"     # vote row with no live candidate (sentinel -1)


def _not_ported(what: str, where: str):
    return NotImplementedError(f"{what} is not ported yet ({where} in ROADMAP.md)")


class KnnDtwRecognizer:
    """Template-bank recognizer: enroll utterances, classify by DTW.

    ``device`` is where features, the bank and all matching live: the
    card (``"cuda"``) unless the caller passes ``"cpu"``, with no probe
    and no fallback, so without a card the first tensor moved there
    raises.  ``mesh``, ``matcher`` other than
    ``"dtw"`` and ``bucketed`` belong to later slices of the port.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), k: int = 1,
                 device: str | torch.device = "cuda", mesh=None,
                 matcher: str = "dtw", bucketed: bool = False):
        if mesh is not None:
            raise _not_ported("mesh (bank-sharded classify)",
                              "queue 1, item 15")
        if matcher in ("ltw", "cascade"):
            raise _not_ported(f"matcher={matcher!r}",
                              "queue 1, item 9")
        if matcher != "dtw":
            raise ValueError(f"unknown matcher: {matcher}")
        if bucketed:
            raise _not_ported("bucketed=True", "queue 1, item 9")
        self.cfg = cfg
        self.k = k
        self.device = torch.device(device)
        self.labels: list[str] = []               # label id -> string
        self._bank_feats: list[np.ndarray] = []   # [U_max, F] each
        self._bank_lens: list[int] = []
        self._bank_label_ids: list[int] = []
        self._device_bank = None                  # cached (Features, label_ids)
        # carried through save/load for the JAX package's later readers
        self.spot_threshold: float | None = None
        self.reject_threshold: float | None = None
        self.reject_scale: str | None = None

    # ------------------------------------------------------------- enroll
    def extract(self, signals) -> pl.Features:
        """Host list of signals -> Features on the recognizer's device."""
        return pl.extract_signals(signals, self.cfg, self.device)

    def enroll(self, label: str, signals) -> None:
        """Add template utterances for ``label`` to the bank."""
        if label not in self.labels:
            self.labels.append(label)
        label_id = self.labels.index(label)
        feats = self.extract(signals)
        f = feats.feats.cpu().numpy()
        lens = feats.length.cpu().numpy()
        for i in range(f.shape[0]):
            self._bank_feats.append(f[i])
            self._bank_lens.append(int(lens[i]))
            self._bank_label_ids.append(label_id)
        self._device_bank = None

    @property
    def n_templates(self) -> int:
        return len(self._bank_feats)

    def device_bank(self):
        """(Features [K], label_ids [K]) on the recognizer's device."""
        if self._device_bank is None:
            if not self._bank_feats:
                raise ValueError("empty template bank — enroll first")
            bank = pl.Features(
                torch.as_tensor(np.stack(self._bank_feats), dtype=torch.float32,
                                device=self.device).contiguous(),
                torch.as_tensor(np.asarray(self._bank_lens, np.int32),
                                device=self.device))
            ids = torch.as_tensor(np.asarray(self._bank_label_ids, np.int32),
                                  device=self.device)
            self._device_bank = (bank, ids)
        return self._device_bank

    # ------------------------------------------------------------ classify
    def classify_batch(self, signals, return_distances: bool = False,
                       chunk: int = 256, reject=None):
        """List of signals -> list of labels (and distances [B, K]).

        Large batches run in chunks of ``chunk`` signals; the last chunk is
        padded with repeats of its last signal, so every chunk has one
        shape, as in the JAX package."""
        if reject is not None and reject is not False:
            raise _not_ported("rejection (calibrate_rejection / reject=)",
                              "queue 1, item 9")
        if len(signals) > chunk:
            labels, dists = [], []
            for lo in range(0, len(signals), chunk):
                part = list(signals[lo:lo + chunk])
                n_real = len(part)
                part += [part[-1]] * (chunk - n_real)     # pad, same shapes
                got = self.classify_batch(part, return_distances=True)
                labels.extend(got[0][:n_real])
                dists.append(got[1][:n_real])
            if return_distances:
                return labels, np.concatenate(dists)
            return labels
        x, n = pl.pad_signals(signals, self.cfg.max_samples, self.device)
        bank, ids = self.device_bank()
        if self.k <= 1:
            label_ids, dists = pl.recognize_batch(x, n, bank, ids, self.cfg)
        else:
            feats = pl.extract_features(x, n, self.cfg)
            label_ids, dists = pl.classify_features(
                feats, bank, ids, n_labels=len(self.labels), k=self.k,
                cfg=self.cfg)
        labels = self._ids_to_labels(label_ids)
        if return_distances:
            return labels, dists.cpu().numpy()
        return labels

    def _ids_to_labels(self, label_ids) -> list:
        """Map vote ids to strings; the -1 all-dead sentinel becomes NO_MATCH."""
        return [self.labels[i] if i >= 0 else NO_MATCH
                for i in label_ids.cpu().tolist()]

    def recognize(self, signal, reject=None) -> str:
        """Single utterance -> label (the reference's main entry point)."""
        return self.classify_batch([signal], reject=reject)[0]

    def calibrate_rejection(self, *args, **kwargs):
        raise _not_ported("calibrate_rejection", "queue 1, item 9")

    def classify_connected(self, *args, **kwargs):
        raise _not_ported("classify_connected", "queue 1, item 13")

    def condense(self, *args, **kwargs):
        raise _not_ported("condense", "queue 1, item 14")

    # ---------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        """Write the bank in the JAX package's ``.npz`` format."""
        bank = (np.stack(self._bank_feats) if self._bank_feats else
                np.zeros((0, self.cfg.max_frames, self.cfg.frontend.n_feats),
                         np.float32))
        np.savez(
            path,
            bank=bank,
            lens=np.asarray(self._bank_lens, dtype=np.int32),
            label_ids=np.asarray(self._bank_label_ids, dtype=np.int32),
            labels=json.dumps(self.labels),
            k=self.k,
            matcher="dtw",
            ltw_len=64,
            shortlist=8,
            bucketed=False,
            spot_threshold=(np.nan if self.spot_threshold is None
                            else float(self.spot_threshold)),
            reject_threshold=(np.nan if self.reject_threshold is None
                              else float(self.reject_threshold)),
            reject_scale=self.reject_scale or "",
            frontend=json.dumps(frontend_signature(self.cfg)),
        )

    @classmethod
    def from_arrays(cls, bank, lens, label_ids, labels,
                    cfg: PipelineConfig = PipelineConfig(), k: int = 1,
                    device: str | torch.device = "cuda") -> "KnnDtwRecognizer":
        """A recognizer over an existing bank: numpy ``bank`` [K, U, F],
        ``lens`` [K], ``label_ids`` [K] and the label strings.  The shared
        core of :meth:`load`; takes the JAX package's arrays as they are."""
        bank = np.asarray(bank, np.float32)
        want = (cfg.max_frames, cfg.frontend.n_feats)
        if bank.ndim != 3 or bank.shape[1:] != want:
            raise ValueError(f"bank shape {bank.shape} does not match the "
                             f"config's [K, {want[0]}, {want[1]}]")
        rec = cls(cfg, k=k, device=device)
        rec.labels = list(labels)
        rec._bank_feats = list(bank)
        rec._bank_lens = [int(v) for v in np.asarray(lens)]
        rec._bank_label_ids = [int(v) for v in np.asarray(label_ids)]
        return rec

    @classmethod
    def load(cls, path: str, cfg: PipelineConfig = PipelineConfig(),
             device: str | torch.device = "cuda") -> "KnnDtwRecognizer":
        """Read a bank saved by either package."""
        data = np.load(path, allow_pickle=False)
        check_frontend_signature(data, cfg, path)
        matcher = str(data["matcher"]) if "matcher" in data.files else "dtw"
        if matcher != "dtw":
            raise _not_ported(f"checkpoint matcher={matcher!r}",
                              "queue 1, item 9")
        rec = cls.from_arrays(data["bank"], data["lens"], data["label_ids"],
                              json.loads(str(data["labels"])), cfg,
                              k=int(data["k"]), device=device)
        if "spot_threshold" in data.files:
            st = float(data["spot_threshold"])
            rec.spot_threshold = st if np.isfinite(st) else None
        if "reject_threshold" in data.files:
            rt = float(data["reject_threshold"])
            rec.reject_threshold = rt if np.isfinite(rt) else None
            rec.reject_scale = str(data["reject_scale"]) or None
        return rec


def frontend_signature(cfg: PipelineConfig) -> dict:
    """The config fields that define the checkpoint's feature space."""
    f = cfg.frontend
    return {
        "sample_rate": f.sample_rate,
        "n_mfcc": f.n_mfcc,
        "add_deltas": f.add_deltas,
        # mode+alpha only when they matter, so utterance-mode checkpoints
        # keep the legacy boolean
        "cmn": (f"causal:a{f.cmn_alpha}"
                if f.cmn and f.cmn_mode == "causal" else f.cmn),
        "denoise": (f"{f.denoise}:a{f.ss_alpha}:b{f.ss_beta}:f{f.ss_frac}"
                    if f.denoise else "none"),
        "feature_type": f.feature_type,
        "n_feats": f.n_feats,
        "max_frames": cfg.max_frames,
    }


def check_frontend_signature(data, cfg: PipelineConfig, path: str) -> None:
    """Refuse a bank whose features were extracted under a different
    front-end; checkpoints without a signature load unchecked."""
    if "frontend" not in data.files:
        return
    saved = json.loads(str(data["frontend"]))
    now = frontend_signature(cfg)
    bad = {key: (saved[key], now[key])
           for key in saved if key in now and saved[key] != now[key]}
    if bad:
        detail = ", ".join(f"{key}: checkpoint={a!r} vs cfg={b!r}"
                           for key, (a, b) in bad.items())
        raise ValueError(
            f"checkpoint {path} was created with a different front-end "
            f"config ({detail}); pass the matching PipelineConfig")
