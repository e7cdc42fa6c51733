"""Roofline accounting for the port's headline configs.

    python -m dsp_tpu_torch.scripts.roofline --pairs-per-s N                 # kernel 1
    python -m dsp_tpu_torch.scripts.roofline --config spot --pairs-per-s N   # kernel 3
    python -m dsp_tpu_torch.scripts.roofline --config viterbi --frames-per-s N

Port of ``scripts/roofline.py``: it turns a measured rate into a share of
peak for each unit of the card, from work models of the port's kernels,
and names the unit that binds.  It needs no device.  The peaks are the
H100 SXM's (NVIDIA's data sheet, at its 700 W limit), the ones every
bound of ``chip_smoke.py`` uses:

  fp32   67e12 FLOP/s   float32 outside the tensor cores (the kernels'
                        sums, and the GMM's matmuls: TF32 is off)
  hbm    3.35e12 B/s    HBM3

The work models count as ``chip_smoke.py`` counts a kernel's bound:

- ``classify`` (kernel 1, ``csrc/dtw_banded.cu``): a full-length pair's
  cells inside its band and window (``kernels/dtw_fused_banded.py:
  valid_cells``), each 2F + 3 operations (F squared differences and the
  DP's add and two mins); bytes: queries, templates, lengths and
  distances once over one chunk's B x K pairs.
- ``spot`` (kernel 3, ``csrc/spot_subseq.cu``): a full-length pair's T x U
  subsequence cells, 2F + 3 operations each; bytes: streams, templates,
  lengths once and the norm and start planes written once, over B x K.
- ``viterbi`` (``ops/viterbi.py``, no kernel): a frame of a stream, the
  emission GEMM [W*S*mix, F] x frame and the [W, S] max-plus update, as
  the JAX script counts it; its frame read once.

The TPU units of the JAX script (MXU passes, VPU lanes) and its v5e peaks
have no counterpart here.  Prints one JSON line a unit with the work an
item, the achieved rate, the peak and the utilization, then the binding
(most utilized) unit.
"""

from __future__ import annotations

import argparse
import json

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAKS = {"fp32": PEAK_FP32_FLOPS, "hbm": PEAK_BYTES_PER_S}
UNITS = {"fp32": "FLOP", "hbm": "B"}
BAND = 0.17                  # DtwConfig's default band and warp scale
MAX_WARP_SCALE = 2.0


def bound(ops: float, n_bytes: float) -> tuple[float, str]:
    """(least ms the card could take, which of the two binds)."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def classify_cells(t: int = 198, u: int = 198, band: float | None = BAND,
                   scale: float | None = MAX_WARP_SCALE) -> int:
    """Cells kernel 1 must fill for one pair of full lengths t and u."""
    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels.dtw_fused_banded import valid_cells

    return valid_cells(t, u, DtwConfig(band_frac=band, max_warp_scale=scale), t, u)


def classify_model(t=198, u=None, f=39, b=256, k=100):
    """Kernel 1 a pair at one main-path chunk (B = 256 queries x K = 100
    templates, band 0.17)."""
    u = t if u is None else u
    return {"fp32": classify_cells(t, u) * (2.0 * f + 3.0),
            "hbm": 4.0 * ((b * t + k * u) * f + b + k + b * k) / (b * k)}


def spot_model(t=198, u=1598, f=39, b=64, k=100):
    """Kernel 3 a (stream, template) pair: streams of u frames against
    templates of t, B = 64 streams x K = 100 templates a launch."""
    return {"fp32": float(t * u) * (2.0 * f + 3.0),
            "hbm": (4.0 * ((b * u + k * t) * f + b + k) + 8.0 * b * k * u) / (b * k)}


def viterbi_model(s=4, w=35, f=39, mix=2):
    """The Viterbi a frame a stream: GEMM emissions [W*S*mix, F] x frame,
    then the [W, S] max-plus column update."""
    return {"fp32": 2.0 * w * s * mix * f + 12.0 * w * s, "hbm": f * 4.0}


MODELS = {"classify": classify_model, "spot": spot_model, "viterbi": viterbi_model}


def rows(config: str, rate: float, t: int = 198, u: int | None = None) -> list[dict]:
    """The per-unit lines, then the binding line, of ``rate`` items a
    second under ``config``'s work model."""
    if config == "viterbi":
        work = viterbi_model()
    else:
        work = MODELS[config](t=t, **({} if u is None else {"u": u}))
    out = []
    for unit, per_item in work.items():
        achieved = per_item * rate
        out.append({"unit": unit, f"{UNITS[unit]}_per_item": round(per_item),
                    "achieved_per_s": f"{achieved:.3e}",
                    "peak_per_s": f"{PEAKS[unit]:.3e}",
                    "utilization": round(achieved / PEAKS[unit], 4)})
    bind = max(out, key=lambda r: r["utilization"])
    out.append({"config": config, "binding_unit": bind["unit"],
                "binding_utilization": bind["utilization"]})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(MODELS), default="classify")
    ap.add_argument("--pairs-per-s", type=float, default=None,
                    help="measured pair rate (classify/spot)")
    ap.add_argument("--frames-per-s", type=float, default=None,
                    help="measured (stream frames x streams)/s (viterbi)")
    ap.add_argument("--t", type=int, default=198)
    ap.add_argument("--u", type=int, default=None)
    args = ap.parse_args(argv)

    rate = args.pairs_per_s if args.config != "viterbi" else args.frames_per_s
    if rate is None:
        raise SystemExit("give --pairs-per-s (or --frames-per-s)")
    out = rows(args.config, rate, args.t, args.u)
    for row in out:
        print(json.dumps(row))
    return out


if __name__ == "__main__":
    main()
