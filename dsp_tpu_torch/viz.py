"""Pictures of the pipeline's internals (the reference's plot view).

The port of ``dsp_tpu/viz.py``: a 3- or 4-panel figure for one utterance
— the waveform with the detected VAD region, per-frame energy and ZCR,
the MFCC(+deltas) heatmap after the VAD trim, and, given a recognizer, its
DTW distance to every template — written to a PNG with matplotlib's
headless Agg backend.  Energy, ZCR, endpoints and features come from the
port's own ``ops/vad.py``, ``ops/frontend.py`` and ``pipeline.py``, run on
the CPU; a recognizer classifies on its own device.  ``pipeline_view``
computes what the panels show and needs no matplotlib; ``plot_pipeline``
imports matplotlib when it draws, so this module imports without it.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import PipelineConfig
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops import vad


def pipeline_view(x: np.ndarray, cfg: PipelineConfig = PipelineConfig(),
                  recognizer=None) -> dict:
    """What :func:`plot_pipeline`'s panels show for signal ``x``: ``energy``
    and ``zcr`` a frame, the VAD's ``start`` and exclusive ``end`` frames
    and ``found``, ``features`` [T, n_feats] and, given a recognizer, its
    ``label`` and ``distances`` [K] to each template in bank order."""
    f = cfg.frontend
    x = np.asarray(x, dtype=np.float32)
    xt = torch.from_numpy(x)[None]
    frames = fe.frame(xt, f.frame_len, f.hop_len)
    s_t, e_t, found_t = vad.detect_endpoints(xt, f, cfg.vad)
    got = pl.extract_signals([x], cfg, "cpu")
    view = dict(energy=vad.short_time_energy(frames)[0].numpy(),
                zcr=vad.zero_crossing_rate(frames)[0].numpy(),
                start=int(s_t[0]), end=int(e_t[0]), found=bool(found_t[0]),
                features=got.feats[0, : int(got.length[0])].numpy())
    if recognizer is not None:
        labels, dists = recognizer.classify_batch([x], return_distances=True)
        view.update(label=labels[0], distances=np.asarray(dists[0]))
    return view


def plot_pipeline(x: np.ndarray, out_path: str,
                  cfg: PipelineConfig = PipelineConfig(),
                  recognizer=None, title: str = "") -> dict:
    """Render the pipeline view of signal ``x`` to ``out_path`` (PNG);
    returns :func:`pipeline_view`'s dict."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    f = cfg.frontend
    x = np.asarray(x, dtype=np.float32)
    view = pipeline_view(x, cfg, recognizer)
    e, z, feats = view["energy"], view["zcr"], view["features"]
    start, end = view["start"], view["end"]

    n_rows = 4 if recognizer is not None else 3
    fig, axes = plt.subplots(n_rows, 1, figsize=(10, 2.2 * n_rows))

    t_sig = np.arange(len(x)) / f.sample_rate
    axes[0].plot(t_sig, x, lw=0.4)
    if view["found"]:
        axes[0].axvspan(start * f.hop_len / f.sample_rate,
                        end * f.hop_len / f.sample_rate,
                        color="tab:green", alpha=0.2, label="VAD region")
        axes[0].legend(loc="upper right", fontsize=8)
    axes[0].set_title(title or "waveform")
    axes[0].set_xlabel("s")

    t_frm = np.arange(len(e)) * f.hop_len / f.sample_rate
    axes[1].semilogy(t_frm, np.maximum(e, 1e-10), label="energy")
    ax2 = axes[1].twinx()
    ax2.plot(t_frm, z, color="tab:orange", lw=0.7, label="ZCR")
    axes[1].set_title("short-time energy (log) / ZCR")
    axes[1].set_xlabel("s")

    im = axes[2].imshow(feats.T, aspect="auto", origin="lower",
                        interpolation="nearest", cmap="magma")
    axes[2].set_title(f"features after VAD trim [{feats.shape[0]} x {feats.shape[1]}]")
    axes[2].set_xlabel("frame")
    fig.colorbar(im, ax=axes[2], fraction=0.025)

    if recognizer is not None:
        dists, label = view["distances"], view["label"]
        order = np.argsort(dists)
        names = [recognizer.labels[recognizer._bank_label_ids[i]] for i in order]
        axes[3].bar(range(len(order)), dists[order],
                    color=["tab:green" if n == label else "tab:blue"
                           for n in names])
        axes[3].set_xticks(range(len(order)))
        axes[3].set_xticklabels(names, rotation=45, fontsize=7)
        axes[3].set_title(f"DTW distance per template -> '{label}'")

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return view
