"""kNN-DTW isolated-word recognizer (port of ``dsp_tpu/models/knn_dtw.py``).

The template bank is one padded tensor ``[K, U_max, F]`` with a length
vector on the recognizer's device, so classifying against the whole
vocabulary is one all-pairs DTW (on CUDA, the kernel ``DtwConfig.impl``
routes to: pipeline.dtw_pairs).  The other matchers are the linear time
warp (``matcher="ltw"``, one GEMM) and the LTW-shortlist cascade with a
DTW rerank (``matcher="cascade"``); ``bucketed=True`` runs the DTW in
query-length buckets.  Rejection of out-of-vocabulary queries is
calibrated from the bank itself (:meth:`KnnDtwRecognizer.calibrate_rejection`).

Checkpoints are the JAX package's ``.npz`` format, key for key: a bank
enrolled by either package loads in the other (:meth:`KnnDtwRecognizer.load`,
:meth:`KnnDtwRecognizer.from_arrays`).

With a ``mesh`` (``dsp_tpu_torch.parallel.make_mesh``) classification runs
bank-sharded across the mesh's ranks (``parallel/sharding.py``), kNN
voting and the connected-word decoders included; every rank calls the
same method with the same inputs and gets the same result.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import PipelineConfig
from dsp_tpu_torch.ops import align as talign
from dsp_tpu_torch.ops.grammar import Grammar
from dsp_tpu_torch.utils import profiling

NO_MATCH = "<no-match>"     # vote row with no live candidate (sentinel -1)
REJECT = "<reject>"         # best bank distance fails the rejection threshold


def _check_mesh(mesh):
    """``parallel.mesh.as_mesh``: None or a ('data', 'bank') DeviceMesh,
    else ``TypeError`` (imported late: ``parallel`` imports the models)."""
    if mesh is None:
        return None
    from dsp_tpu_torch.parallel.mesh import as_mesh
    return as_mesh(mesh)


class KnnDtwRecognizer:
    """Template-bank recognizer: enroll utterances, classify by DTW.

    ``device`` is where features, the bank and all matching live: the
    card (``"cuda"``) unless the caller passes ``"cpu"``, with no probe
    and no fallback, so without a card the first tensor moved there
    raises.  ``matcher`` is ``"dtw"``, ``"ltw"`` (resample to ``ltw_len``
    frames, one GEMM) or ``"cascade"`` (LTW shortlist of ``shortlist``
    templates, DTW rerank); ``bucketed=True`` runs DTW in query-length
    buckets.  ``mesh`` (a ('data', 'bank') ``DeviceMesh`` from
    ``dsp_tpu_torch.parallel.make_mesh``) runs classification bank-sharded
    across its ranks, kNN voting included; the query batch and the bank
    are padded to the mesh axes transparently.  The mesh implements the
    full DTW matcher only.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), k: int = 1,
                 device: str | torch.device = "cuda", mesh=None,
                 matcher: str = "dtw", ltw_len: int = 64, shortlist: int = 8,
                 bucketed: bool = False):
        if matcher not in ("dtw", "ltw", "cascade"):
            raise ValueError(f"unknown matcher: {matcher}")
        self.cfg = cfg
        self.k = k
        self.device = torch.device(device)
        self.mesh = _check_mesh(mesh)
        self.matcher = matcher
        self.ltw_len = ltw_len
        self.shortlist = shortlist
        self.bucketed = bucketed
        self.labels: list[str] = []               # label id -> string
        self._bank_feats: list[np.ndarray] = []   # [U_max, F] each
        self._bank_lens: list[int] = []
        self._bank_label_ids: list[int] = []
        self._device_bank = None                  # cached (Features, label_ids)
        self._sharded_bank = None                 # cached mesh-padded bank
        self.spot_threshold: float | None = None  # models/spotter.py
        self.reject_threshold: float | None = None   # calibrate_rejection
        self.reject_scale: str | None = None      # its score scale: "dtw" | "ltw"

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
        self._sharded_bank = None

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

    def sharded_bank(self):
        """The bank padded to a multiple of the mesh's bank axis: (feats
        [Kp, U, F], lens [Kp], label_ids [Kp], valid [Kp]) on the mesh's
        device, pad rows of length 1 marked invalid.  The arrays are global
        (every rank holds them): the sharded functions take each rank's
        shard."""
        from dsp_tpu_torch import parallel as par
        from dsp_tpu_torch.parallel.mesh import mesh_shape

        if self._sharded_bank is None:
            if not self._bank_feats:
                raise ValueError("empty template bank — enroll first")
            nb = mesh_shape(self.mesh)[1]
            feats, k_orig = par.pad_axis_to_multiple(
                np.stack(self._bank_feats).astype(np.float32), nb)
            lens, _ = par.pad_axis_to_multiple(
                np.asarray(self._bank_lens, dtype=np.int32), nb)
            ids, _ = par.pad_axis_to_multiple(
                np.asarray(self._bank_label_ids, dtype=np.int32), nb)
            lens = np.maximum(lens, 1)
            valid = np.arange(len(lens)) < k_orig
            self._sharded_bank = par.replicate(self.mesh, feats, lens, ids, valid)
        return self._sharded_bank

    # ----------------------------------------------------------- rejection
    def _bank_self_distances(self) -> np.ndarray:
        """[K, K] distance of every template against the bank, in the
        matcher's score scale: ltw in linear-warp units; dtw, cascade and
        bucketed in DTW units (the cascade's rerank distances are DTW)."""
        bank, ids = self.device_bank()
        if self.matcher == "ltw":
            _, d = pl.classify_features_ltw(bank, bank, ids, self.ltw_len)
        else:
            _, d = pl.classify_features(bank, bank, ids,
                                        n_labels=len(self.labels), k=1,
                                        cfg=self.cfg)
        return d.cpu().numpy()

    def calibrate_rejection(self, genuine_q: float = 0.9,
                            impostor_q: float = 0.02) -> float:
        """Per-bank out-of-vocabulary threshold from enrollment data alone.

        A query is accepted iff its best bank distance is below the
        threshold.  GENUINE: each template's best distance to another
        template of its label; IMPOSTOR: its best distance to a template of
        another label (what a query scores when its word is not enrolled).
        Returns the midpoint of the genuine ``genuine_q`` and impostor
        ``impostor_q`` quantiles and stores it (saved with the bank).
        Needs two templates of some label and two labels."""
        d = self._bank_self_distances()
        ids = np.asarray(self._bank_label_ids)
        same = ids[:, None] == ids[None, :]
        eye = np.eye(len(ids), dtype=bool)
        dd = np.where(d < pl.DEAD, d, np.inf)   # dead pairs carry no information
        genuine = np.min(np.where(same & ~eye, dd, np.inf), axis=1)
        impostor = np.min(np.where(~same, dd, np.inf), axis=1)
        genuine = genuine[np.isfinite(genuine)]
        impostor = impostor[np.isfinite(impostor)]
        if not len(genuine):
            raise ValueError("calibrate_rejection needs >= 2 templates "
                             "of some label (no genuine pairs in bank)")
        if not len(impostor):
            raise ValueError("calibrate_rejection needs >= 2 labels "
                             "(no impostor pairs in bank)")
        self.reject_threshold = float(
            (np.quantile(genuine, genuine_q)
             + np.quantile(impostor, impostor_q)) / 2.0)
        self.reject_scale = self._score_scale()
        return self.reject_threshold

    def _score_scale(self) -> str:
        return "ltw" if self.matcher == "ltw" else "dtw"

    def _resolve_reject(self, reject) -> float | None:
        """None/False: off; True: the calibrated threshold (an error if none
        is stored or it was calibrated in another score scale); a number:
        that threshold."""
        if reject is None or reject is False:
            return None
        if reject is True:
            if self.reject_threshold is None:
                raise ValueError(
                    "reject=True but no rejection threshold is stored — "
                    "calibrate_rejection() first or pass an explicit number")
            if (self.reject_scale is not None
                    and self.reject_scale != self._score_scale()):
                raise ValueError(
                    f"stored rejection threshold was calibrated in "
                    f"{self.reject_scale!r} score units but the current "
                    f"matcher scores in {self._score_scale()!r} — "
                    f"recalibrate (calibrate_rejection) under this "
                    f"matcher or pass an explicit threshold")
            return float(self.reject_threshold)
        return float(reject)

    # ------------------------------------------------------------ classify
    def classify_batch(self, signals, return_distances: bool = False,
                       chunk: int = 256, reject=None):
        """List of signals -> list of labels (and distances [B, K]; the
        cascade's are the shortlist's [B, M]).

        Large batches run in chunks of ``chunk`` signals; the last chunk is
        padded with repeats of its last signal, so every chunk has one
        shape, as in the JAX package.  ``reject`` (True: the calibrated
        threshold, or a number) returns ``REJECT`` for queries whose best
        distance is not below the threshold."""
        thr = self._resolve_reject(reject)
        if thr is not None:
            labels, dists = self.classify_batch(signals, chunk=chunk,
                                                return_distances=True)
            dd = np.where(dists < pl.DEAD, dists, np.inf)
            best = dd.min(axis=1) if dd.size else np.zeros(len(labels))
            labels = [REJECT if (lab != NO_MATCH and not (b < thr)) else lab
                      for lab, b in zip(labels, best)]
            return (labels, dists) if return_distances else labels
        self._check_mesh_matcher()
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
        if self.mesh is not None:
            return self._classify_sharded(signals, return_distances)
        with profiling.stage("dsp.classify_chunk"):
            label_ids, dists, _ = self._match(signals)
            with profiling.stage("dsp.readback"):
                labels = self._ids_to_labels(label_ids)
                if return_distances:
                    return labels, _to_host(dists).numpy()
        return labels

    def _check_mesh_matcher(self) -> None:
        if self.mesh is not None and self.matcher != "dtw":
            raise ValueError(
                f"matcher={self.matcher!r} is not supported with a "
                "mesh — bank-sharded classification implements the "
                "full banded DTW only (clear the mesh or use "
                "matcher='dtw')")

    def _classify_sharded(self, signals, return_distances: bool):
        """One chunk over the mesh: the batch padded to the data axis with
        silent rows, and EVERY row's length clamped to at least a frame,
        as the JAX package does; returns labels (and the full [B, K]
        distances, bank padding trimmed)."""
        from dsp_tpu_torch import parallel as par
        from dsp_tpu_torch.parallel.mesh import mesh_device, mesh_shape, pad_rows_to_multiple

        x, n = pl.pad_signals(signals, self.cfg.max_samples, mesh_device(self.mesh))
        nd = mesh_shape(self.mesh)[0]
        x, b_orig = pad_rows_to_multiple(x, nd)
        n, _ = pad_rows_to_multiple(n, nd)
        bf, bl, ids, valid = self.sharded_bank()
        label_ids, dist = par.recognize_sharded(
            self.mesh, x, torch.clamp(n, min=self.cfg.frontend.frame_len), bf, bl,
            ids, valid, cfg=self.cfg, k=self.k, n_labels=len(self.labels),
            return_full=return_distances)
        labels = self._ids_to_labels(label_ids[:b_orig])
        if return_distances:
            return labels, _to_host(dist[:b_orig, :self.n_templates]).numpy()
        return labels

    def _match(self, signals):
        """One chunk of signals -> (label ids [B], distances, the cascade's
        candidate indices [B, M] or None) on the recognizer's device."""
        x, n = pl.pad_signals(signals, self.cfg.max_samples, self.device)
        bank, ids = self.device_bank()
        if self.matcher == "dtw" and not self.bucketed and self.k <= 1:
            return (*pl.recognize_batch(x, n, bank, ids, self.cfg), None)
        feats = pl.extract_features(x, n, self.cfg)
        if self.matcher == "ltw":
            return (*pl.classify_features_ltw(feats, bank, ids, self.ltw_len), None)
        if self.matcher == "cascade":
            return pl.classify_features_cascade(
                feats, bank, ids, self.shortlist, self.k,
                n_labels=len(self.labels), target_len=self.ltw_len, cfg=self.cfg)
        if self.bucketed and len(signals) > 32:
            label_ids, dists = pl.classify_features_bucketed(
                feats, bank, ids, n_labels=len(self.labels), k=self.k,
                cfg=self.cfg)
            return torch.from_numpy(label_ids), torch.from_numpy(dists), None
        return (*pl.classify_features(feats, bank, ids, n_labels=len(self.labels),
                                      k=self.k, cfg=self.cfg), None)

    def classify_nbest(self, signals, n: int = 3):
        """Top-n label hypotheses per utterance: ``[[(label, distance,
        weight)]]`` sorted best-first.  A label's score is the minimum
        distance over its templates (over its shortlisted templates under
        the cascade); ``weight`` is ``pipeline.nbest_from_scores``'s
        relative confidence; labels whose every template is dead are
        dropped."""
        ids = np.asarray(self._bank_label_ids)
        self._check_mesh_matcher()
        out = []
        for lo in range(0, len(signals), 256):    # classify_batch's chunk
            part = list(signals[lo:lo + 256])
            if self.mesh is not None:             # the full [B, K] over the mesh
                d, cand = self._classify_sharded(part, True)[1], None
            else:
                _, d, cand = self._match(part)
                d = d.cpu().numpy()
            cols = ids if cand is None else ids[cand.cpu().numpy()]
            label_d = np.full((d.shape[0], len(self.labels)), 1e30)
            np.minimum.at(label_d, (np.arange(d.shape[0])[:, None],
                                    np.broadcast_to(cols, d.shape)), d)
            out.extend(pl.nbest_from_scores(label_d, self.labels, n))
        return out

    def _ids_to_labels(self, label_ids) -> list:
        """Map vote ids to strings; the -1 all-dead sentinel becomes NO_MATCH."""
        return [self.labels[i] if i >= 0 else NO_MATCH
                for i in _to_host(label_ids).tolist()]

    def recognize(self, signal, reject=None) -> str:
        """Single utterance -> label (the reference's main entry point);
        ``reject`` as in :meth:`classify_batch`."""
        return self.classify_batch([signal], reject=reject)[0]

    def evaluate(self, corpus: dict, reject=None) -> dict:
        """{label: [signals]} -> accuracy + per-label confusion counts.

        With ``reject`` set, corpus labels not in the bank are
        out-of-vocabulary truth: such a query counts correct iff rejected
        (its confusion row is keyed ``REJECT``), and an in-vocabulary
        query that is rejected counts wrong."""
        thr = self._resolve_reject(reject)
        if thr is None:
            return pl.evaluate_corpus(self.classify_batch, corpus)
        mapped: dict = {}
        for lab, xs in corpus.items():
            mapped.setdefault(lab if lab in self.labels else REJECT, []).extend(xs)
        return pl.evaluate_corpus(
            lambda s: self.classify_batch(s, reject=thr), mapped)

    def resolve_grammar(self, grammar):
        """A grammar argument -> UNIT-level masks over the bank's templates.

        ``grammar`` is an ``ops/grammar.py:Grammar``, a spec dict or the
        path of a JSON spec (the last two compiled over this recognizer's
        labels).  A ready Grammar is matched to the bank by label string
        and must cover every enrolled label.  Returns ``(start [K], pairs
        [K, K], end [K])`` numpy bools over the bank's rows."""
        return grammar_masks(grammar, self.labels,
                             [self.labels[i] for i in self._bank_label_ids],
                             "enrolled")

    def classify_connected(self, signals, max_segments: int = 8,
                           return_segments: bool = False, method: str = "vad",
                           word_penalty: float = 0.0, grammar=None):
        """Recordings of SEVERAL words -> one label list a recording.

        ``method="vad"``: the multi-segment VAD splits each recording into
        at most ``max_segments`` utterances, and every segment is
        classified in one flat batch by the matcher and vote of
        :meth:`classify_batch` (kernel 1 on the card for ``matcher="dtw"``,
        kernel 5's paired entry in the cascade's rerank).  Needs silence
        between words.

        ``method="level"``: the level-building DP against the whole bank
        (``ops/level_building.py``; plain PyTorch, no kernel of its own)
        chooses word count, words and boundaries jointly, so gapless
        recordings decode; ``max_segments`` caps the word count and
        ``word_penalty`` biases it.  The matcher does not apply.
        ``grammar`` (``"level"`` only; see :meth:`resolve_grammar`)
        constrains the DP to the grammar's sentences; a recording the
        grammar cannot explain gives ``[]``.

        With ``mesh`` set, ``"level"`` runs the bank-sharded DP
        (``parallel/sharding.py:level_build_sharded`` /
        ``level_build_grammar_sharded``) and ``"vad"`` classifies the
        segments bank-sharded, as :meth:`classify_batch` does.

        With ``return_segments`` also returns (starts, ends, n_segs) in
        frames for ``"vad"`` and the DP costs for ``"level"``.
        """
        if grammar is not None and method != "level":
            raise ValueError(
                "grammar constraints require method='level' (the VAD "
                "splitter classifies segments independently — there is "
                "no joint sequence to constrain)")
        if method == "level":
            masks = None if grammar is None else self.resolve_grammar(grammar)
            if self.mesh is not None:
                # the bank-sharded DP; the pipeline pads the grammar masks
                # to the mesh's padded bank
                bf, bl, ids, valid = self.sharded_bank()
                bank, extra = pl.Features(bf, bl), {"mesh": self.mesh,
                                                    "bank_valid": valid}
            else:
                (bank, ids), extra = self.device_bank(), {}
            id_lists, costs = pl.decode_connected_level(
                signals, self.cfg, bank, ids, max_levels=max_segments,
                word_penalty=word_penalty, grammar_masks=masks,
                device=self.device, **extra)
            out = [[self.labels[i] for i in ids_i] for ids_i in id_lists]
            return (out, costs) if return_segments else out
        if method != "vad":
            raise ValueError(f"unknown connected method {method!r} (vad | level)")
        self._check_mesh_matcher()
        bank, ids = self.device_bank()

        def score(flat):
            if self.mesh is not None:
                return self._score_flat_sharded(flat)
            # the matcher routing of classify_batch
            if self.matcher == "ltw":
                return pl.classify_features_ltw(flat, bank, ids, self.ltw_len)[0]
            if self.matcher == "cascade":
                return pl.classify_features_cascade(
                    flat, bank, ids, self.shortlist, self.k,
                    n_labels=len(self.labels), target_len=self.ltw_len,
                    cfg=self.cfg)[0]
            return pl.classify_features(flat, bank, ids, n_labels=len(self.labels),
                                        k=self.k, cfg=self.cfg)[0]

        out, starts, ends, n_segs = pl.decode_connected(
            signals, self.cfg, max_segments, score, self._ids_to_labels,
            self.device)
        return (out, starts, ends, n_segs) if return_segments else out

    def _score_flat_sharded(self, flat: pl.Features) -> torch.Tensor:
        """Flat per-segment Features -> label ids over the mesh (the batch
        padded to the data axis, every length clamped to at least 1)."""
        from dsp_tpu_torch import parallel as par
        from dsp_tpu_torch.parallel.mesh import mesh_shape, pad_rows_to_multiple

        bf, bl, ids, valid = self.sharded_bank()
        nd = mesh_shape(self.mesh)[0]
        q, b_orig = pad_rows_to_multiple(flat.feats, nd)
        ql, _ = pad_rows_to_multiple(flat.length, nd)
        label_ids, _ = par.classify_sharded(
            self.mesh, q, torch.clamp(ql, min=1), bf, bl, ids, valid,
            cfg=self.cfg.dtw, k=self.k, n_labels=len(self.labels))
        return label_ids[:b_orig]

    def condense(self, method: str = "dba", n_iter: int = 3) -> None:
        """Collapse each label's templates into one: the medoid, or with
        ``method="dba"`` the DTW barycenter average started from it.

        Shrinks the bank K-fold at a little accuracy.  Alignments run
        unbanded with the config's slope (condensing is offline, and the
        averages are better with exact alignments); on the card each
        label's all-pairs medoid distances are one launch of the banded
        DTW kernel in its unbanded mode (``pipeline.dtw_pairs``), and the
        averaging is ``ops/align.py:dba_average``."""
        if method not in ("dba", "medoid"):
            raise ValueError(f"unknown condense method {method!r} (dba | medoid)")
        align_cfg = dataclasses.replace(self.cfg.dtw, band_frac=None)
        new_feats, new_lens, new_ids = [], [], []
        for label_id in range(len(self.labels)):
            idx = [i for i, lab in enumerate(self._bank_label_ids) if lab == label_id]
            if not idx:
                continue
            feats = torch.as_tensor(np.stack([self._bank_feats[i] for i in idx]),
                                    dtype=torch.float32, device=self.device)
            lens = torch.as_tensor(np.asarray([self._bank_lens[i] for i in idx],
                                              np.int32), device=self.device)
            mi = talign.medoid(feats, lens, align_cfg, pl.dtw_pairs)
            center, len_c = feats[mi], int(self._bank_lens[idx[mi]])
            if method == "dba" and len(idx) > 1:
                center = talign.dba_average(feats, lens, center, len_c, n_iter,
                                            align_cfg)
            new_feats.append(center.cpu().numpy())
            new_lens.append(len_c)
            new_ids.append(label_id)
        self._bank_feats, self._bank_lens = new_feats, new_lens
        self._bank_label_ids = new_ids
        self._device_bank = None
        self._sharded_bank = None

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
            matcher=self.matcher,
            ltw_len=self.ltw_len,
            shortlist=self.shortlist,
            bucketed=self.bucketed,
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
                    device: str | torch.device = "cuda",
                    **kwargs) -> "KnnDtwRecognizer":
        """A recognizer over an existing bank: numpy ``bank`` [K, U, F],
        ``lens`` [K], ``label_ids`` [K] and the label strings; ``kwargs``
        are the constructor's (``matcher``, ``ltw_len``, ``shortlist``,
        ``bucketed``).  The shared core of :meth:`load`; takes the JAX
        package's arrays as they are."""
        bank = np.asarray(bank, np.float32)
        want = (cfg.max_frames, cfg.frontend.n_feats)
        if bank.ndim != 3 or bank.shape[1:] != want:
            raise ValueError(f"bank shape {bank.shape} does not match the "
                             f"config's [K, {want[0]}, {want[1]}]")
        rec = cls(cfg, k=k, device=device, **kwargs)
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
        opts = {"matcher": str, "ltw_len": int, "shortlist": int, "bucketed": bool}
        rec = cls.from_arrays(data["bank"], data["lens"], data["label_ids"],
                              json.loads(str(data["labels"])), cfg,
                              k=int(data["k"]), device=device,
                              **{key: kind(data[key]) for key, kind in opts.items()
                                 if key in data.files})
        if "spot_threshold" in data.files:
            st = float(data["spot_threshold"])
            rec.spot_threshold = st if np.isfinite(st) else None
        if "reject_threshold" in data.files:
            rt = float(data["reject_threshold"])
            rec.reject_threshold = rt if np.isfinite(rt) else None
            rec.reject_scale = str(data["reject_scale"]) or None
        return rec


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU; a copy from another device waits for it, and
    counts as one of ``host_syncs``."""
    if t.device.type != "cpu":
        profiling.count("host_syncs")
    return t.cpu()


def grammar_masks(grammar, labels, unit_labels, what: str):
    """A grammar argument -> unit-level masks ``(start [K], pairs [K, K],
    end [K])`` (numpy bools) over units labelled ``unit_labels``.

    ``grammar`` is an ``ops/grammar.py:Grammar``, a spec dict or the path
    of a JSON spec; the last two are compiled over ``labels``.  A ready
    Grammar is matched by label string (its word order need not be the
    recognizer's) and must cover every one of ``labels``."""
    if isinstance(grammar, str):
        grammar = Grammar.load(grammar, labels)
    elif isinstance(grammar, dict):
        grammar = Grammar.from_spec(grammar, labels)
    gidx = {w: i for i, w in enumerate(grammar.labels)}
    missing = [w for w in labels if w not in gidx]
    if missing:
        raise ValueError(f"grammar does not cover {what} labels: "
                         + ", ".join(missing))
    return grammar.unit_masks([gidx[w] for w in unit_labels])


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
