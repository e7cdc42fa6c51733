"""VQ-codebook isolated-word recognizer (port of ``dsp_tpu/models/vq.py``).

Each word gets a k-means codebook over its enrollment frames; a query is
scored by its mean quantisation distortion against every codebook and
classified to the argmin word.  Time structure is ignored.

* **Training** runs the Lloyd iterations of all words at once: frames are
  pooled per word into a padded ``[W, N_max, F]`` tensor with a validity
  mask, the assignment distances are one batched fp32 GEMM an iteration,
  and the centroid sums a one-hot fp32 GEMM (no scatter-add, so a fit is
  the same from run to run on the card).  The init is deterministic:
  codewords from evenly strided valid frames.  An empty cluster keeps its
  previous centroid.
* **Scoring** is one GEMM ``[B,T,F] x [W,C,F] -> [B,W,T,C]``, the min over
  codes, and a masked mean over the valid frames -> ``[B, W]``.

There is no kernel here: the work is GEMMs and reductions.  Codebooks
are saved in the JAX package's ``.npz`` format, key for key.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import PipelineConfig, VqConfig
from dsp_tpu_torch.models.knn_dtw import (_check_mesh, check_frontend_signature,
                                          frontend_signature)


def _sq_dists(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """[..., N, F] x [..., C, F] -> [..., N, C] squared distances."""
    cross = torch.matmul(x, cb.transpose(-1, -2))
    xsq = (x * x).sum(dim=-1)[..., :, None]
    csq = (cb * cb).sum(dim=-1)[..., None, :]
    return torch.clamp(xsq + csq - 2.0 * cross, min=0.0)


def kmeans_init(frames: torch.Tensor, mask: torch.Tensor, n_codes: int) -> torch.Tensor:
    """Deterministic init [W, C, F]: word w's code i is its valid frame
    ``i * (n_valid - 1) // (C - 1)``."""
    valid_counts = mask.sum(dim=1).to(torch.int64)                   # [W]
    idx = (torch.arange(n_codes, device=frames.device)[None, :]
           * torch.clamp(valid_counts - 1, min=0)[:, None]
           // max(n_codes - 1, 1))                                   # [W, C]
    return torch.take_along_dim(frames, idx[:, :, None], dim=1)


def lloyd_step(frames: torch.Tensor, mask: torch.Tensor,
               cb: torch.Tensor) -> torch.Tensor:
    """One masked Lloyd update of codebooks cb [W, C, F] over frames
    [W, N, F]: nearest code (the first of equal distances), centroid as
    an fp32 one-hot GEMM, an empty cluster keeping its centroid."""
    n_codes = cb.shape[1]
    assign = torch.argmin(_sq_dists(frames, cb), dim=-1)             # [W, N]
    onehot = (torch.nn.functional.one_hot(assign, n_codes).to(frames.dtype)
              * mask.to(frames.dtype)[:, :, None])                   # [W, N, C]
    counts = onehot.sum(dim=1)                                       # [W, C]
    sums = torch.matmul(onehot.transpose(1, 2), frames)              # [W, C, F]
    new = sums / torch.clamp(counts, min=1.0)[:, :, None]
    return torch.where(counts[:, :, None] > 0, new, cb)


def kmeans_fit(frames: torch.Tensor, mask: torch.Tensor, n_codes: int,
               n_iter: int) -> torch.Tensor:
    """Batched masked k-means: [W, N, F] + [W, N] -> codebooks [W, C, F]
    after ``n_iter`` Lloyd steps from :func:`kmeans_init`."""
    cb = kmeans_init(frames, mask, n_codes)
    for _ in range(n_iter):
        cb = lloyd_step(frames, mask, cb)
    return cb


def vq_distortion(feats: torch.Tensor, lengths: torch.Tensor,
                  codebooks: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """[B,T,F] queries vs [W,C,F] codebooks -> [B,W] mean distortions."""
    t = feats.shape[1]
    dmin = _sq_dists(feats[:, None], codebooks[None]).amin(dim=-1)  # [B, W, T]
    if not squared:
        dmin = torch.sqrt(dmin)
    tmask = (torch.arange(t, device=feats.device)[None, :]
             < lengths[:, None]).to(feats.dtype)                      # [B, T]
    num = torch.matmul(dmin, tmask[:, :, None])[..., 0]              # [B, W]
    return num / torch.clamp(lengths, min=1).to(feats.dtype)[:, None]


class VqRecognizer:
    """Per-word VQ codebooks; classify by minimum mean distortion.

    ``device`` is where features, fitting and scoring run: the card
    (``"cuda"``) unless the caller passes ``"cpu"``, with no probe and no
    fallback.  With a ``mesh`` (``dsp_tpu_torch.parallel.make_mesh``)
    :meth:`classify_batch` scores data-parallel over every rank of it."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 vq: VqConfig = VqConfig(), mesh=None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.vq = vq
        self.device = torch.device(device)
        self.mesh = _check_mesh(mesh)           # data-parallel scoring mesh
        self.labels: list[str] = []
        self._train_feats: dict[int, list[np.ndarray]] = {}  # id -> [Ti, F]
        self.codebooks: np.ndarray | None = None             # [W, C, F]

    # ------------------------------------------------------------- enroll
    def extract(self, signals) -> pl.Features:
        """Host list of signals -> Features on the recognizer's device."""
        return pl.extract_signals(signals, self.cfg, self.device)

    def enroll(self, label: str, signals) -> None:
        if label not in self.labels:
            self.labels.append(label)
        store = self._train_feats.setdefault(self.labels.index(label), [])
        feats = self.extract(signals)
        f = feats.feats.cpu().numpy()
        lens = feats.length.cpu().numpy()
        for i in range(f.shape[0]):
            store.append(f[i, : max(int(lens[i]), 1)])
        self.codebooks = None

    def pooled_frames(self):
        """Every word's enrollment frames pooled and padded: (frames
        [W, N_max, F], mask [W, N_max]) on the recognizer's device."""
        if not self._train_feats:
            raise ValueError("no enrollment data")
        pooled = [np.concatenate(self._train_feats[i], axis=0)
                  for i in range(len(self.labels))]
        n_max = max(p.shape[0] for p in pooled)
        frames = np.zeros((len(pooled), n_max, pooled[0].shape[1]), np.float32)
        mask = np.zeros((len(pooled), n_max), np.float32)
        for i, p in enumerate(pooled):
            frames[i, : p.shape[0]] = p
            mask[i, : p.shape[0]] = 1.0
        return (torch.from_numpy(frames).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def fit(self, corpus: dict | None = None) -> None:
        """Fit all codebooks at once.  ``corpus`` ({label: [signals]}) is
        optional sugar for enroll-all; call with no argument after manual
        :meth:`enroll` calls."""
        if corpus is not None:
            for lab, sigs in corpus.items():
                self.enroll(lab, sigs)
        frames, mask = self.pooled_frames()
        self.codebooks = kmeans_fit(frames, mask, self.vq.n_codes,
                                    self.vq.n_iter).cpu().numpy()

    # ------------------------------------------------------------ classify
    def _distortions(self, feats: pl.Features) -> torch.Tensor:
        cb = torch.as_tensor(self.codebooks, device=self.device)
        return vq_distortion(feats.feats, feats.length, cb, self.vq.squared)

    def classify_batch(self, signals, return_distances: bool = False,
                       chunk: int = 256):
        """List of signals -> labels (and distortions [B, W]).  Batches
        past ``chunk`` run in chunks of ``chunk`` signals, the last padded
        with repeats of its last signal, as in the JAX package: the
        [B, W, T, C] intermediate scales with the batch."""
        if self.codebooks is None:
            self.fit()
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
        if _check_mesh(self.mesh) is not None:
            d = self._distortion_sharded(signals)
        else:
            d = self._distortions(self.extract(signals)).cpu().numpy()
        got = [self.labels[int(i)] for i in d.argmin(axis=1)]
        return (got, d) if return_distances else got

    def _distortion_sharded(self, signals) -> np.ndarray:
        """Data-parallel scoring: the utterances split over every rank of
        the mesh (padded with silent rows, every length clamped to at least
        1 after padding, as in the JAX package), the codebooks whole on
        each; the [B, W] distortions are gathered back."""
        from dsp_tpu_torch import parallel as par
        from dsp_tpu_torch.parallel.mesh import gather_flat, mesh_shape, shard_flat

        x, n = pl.pad_signals(signals, self.cfg.max_samples, "cpu")
        nd, nb = mesh_shape(self.mesh)
        x, b_orig = par.pad_axis_to_multiple(x.numpy(), nd * nb)
        n, _ = par.pad_axis_to_multiple(n.numpy(), nd * nb)
        x, n = shard_flat(self.mesh, x, np.maximum(n, 1))
        cb = par.replicate(self.mesh, self.codebooks)
        d = vq_distortion(*pl.extract_features(x, n, self.cfg), cb, self.vq.squared)
        return gather_flat(d, self.mesh)[:b_orig].cpu().numpy()

    def classify_nbest(self, signals, n: int = 3):
        """Top-n label hypotheses per utterance: ``[[(label, distortion,
        weight)]]`` best-first (``pipeline.nbest_from_scores`` over the
        per-codebook mean distortions)."""
        if not len(signals):
            return []
        _, d = self.classify_batch(signals, return_distances=True)
        return pl.nbest_from_scores(d, self.labels, n)

    def classify_connected(self, signals, max_segments: int = 8):
        """Recordings of several words -> one label list a recording: the
        multi-segment VAD split (``pipeline.decode_connected``) feeds every
        segment through the distortion matcher of :meth:`classify_batch`."""
        if self.codebooks is None:
            self.fit()
        return pl.decode_connected(
            signals, self.cfg, max_segments,
            lambda flat: self._distortions(flat).argmin(dim=-1),
            lambda ids: [self.labels[int(i)] for i in ids], self.device)[0]

    def recognize(self, signal) -> str:
        return self.classify_batch([signal])[0]

    def evaluate(self, corpus: dict) -> dict:
        return pl.evaluate_corpus(self.classify_batch, corpus)

    # -------------------------------------------------------- checkpointing
    def save(self, path: str) -> None:
        """Write the codebooks in the JAX package's ``.npz`` format."""
        if self.codebooks is None:
            self.fit()
        np.savez(path, codebooks=self.codebooks,
                 labels=np.array(self.labels),
                 n_codes=self.vq.n_codes, n_iter=self.vq.n_iter,
                 squared=self.vq.squared,
                 frontend=json.dumps(frontend_signature(self.cfg)))

    @classmethod
    def load(cls, path: str, cfg: PipelineConfig = PipelineConfig(),
             device: str | torch.device = "cuda") -> "VqRecognizer":
        """Read codebooks saved by either package."""
        data = np.load(path, allow_pickle=False)
        check_frontend_signature(data, cfg, path)
        vq = VqConfig(n_codes=int(data["n_codes"]), n_iter=int(data["n_iter"]),
                      squared=bool(data["squared"]))
        rec = cls(cfg, vq, device=device)
        rec.labels = [str(x) for x in data["labels"]]
        rec.codebooks = np.asarray(data["codebooks"], np.float32)
        return rec
