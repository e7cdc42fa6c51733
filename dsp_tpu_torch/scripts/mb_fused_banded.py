"""Microbenchmark: the banded DTW kernel (kernel 1) by variant and launch plan.

    python -m dsp_tpu_torch.scripts.mb_fused_banded [--b 128 --k 100 --t 198]

Port of ``scripts/mb_fused_banded.py``: kernel 1
(``kernels/dtw_fused_banded.py``) at the 12,800-pair reference shape
(128 queries x 100 templates, T = U = 198, F = 39, standard-normal inputs
from ``default_rng(0)``, full lengths) in three variants: banded at 0.15
with squared and with Euclidean costs, and unbanded squared.  Times are
CUDA events over back-to-back calls (``utils/timing.chained_timeit``),
printed in ms and k pairs/s.

The JAX script sweeps its kernel's QUERY_TILE.  This kernel's own knob is
the warps a block that ``launch_plan`` picks from the number of queries,
so in its place the rows sweep the batch: the first B queries, for each
warp count the largest B of the powers of two up to ``--b`` and ``--b``
itself that gives it (at the defaults B = 1, 2, 4, 8 and 128).  Each row
prints the plan it ran with (mode, warps a block, shared bytes), the
counterpart of the JAX script's effective tile, and its distances are held
to the plain version (``ops/dtw.py:dtw_batch``) at rtol 1e-4 with the BIG
pattern identical; a mismatch raises.  ``--qt`` (the tile), ``--ablate``
and ``--staged`` set internals of the TPU kernel and are left out.
Raises for a device that is not a CUDA card.
"""

from __future__ import annotations

import argparse

VARIANTS = [("banded sq", dict(band_frac=0.15, squared=True)),
            ("banded sqrt", dict(band_frac=0.15, squared=False)),
            ("unbanded sq", dict(band_frac=None, squared=True))]


def batch_sweep(b: int, t: int, f: int, cfg) -> list[int]:
    """For each warp count ``launch_plan`` picks, the largest B of the
    powers of two up to ``b`` and ``b`` itself that gives it."""
    from dsp_tpu_torch.kernels.dtw_fused_banded import config_plan

    by_warps = {}
    for bb in sorted({1 << i for i in range(b.bit_length())} | {b}):
        by_warps[config_plan(bb, t, t, f, cfg)[1]] = bb
    return sorted(by_warps.values())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--t", type=int, default=198)
    ap.add_argument("--f", type=int, default=39)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--variant", default="", help="only variants containing this")
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (default cuda: the card)")
    args = ap.parse_args(argv)

    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels.dtw_fused_banded import config_plan, dtw_batch_fused_banded
    from dsp_tpu_torch.ops.dtw import dtw_batch
    from dsp_tpu_torch.scripts import compare_dtw, describe_device, dtw_inputs, require_card
    from dsp_tpu_torch.utils.timing import chained_timeit

    dev = require_card(args.device, "mb_fused_banded")
    print(f"# device: {describe_device(dev)}")
    q, ql, bank, bl = dtw_inputs(args.b, args.k, args.t, args.f, dev)
    rows = []
    for name, over in VARIANTS:
        if args.variant and args.variant not in name:
            continue
        cfg = DtwConfig(**over)
        for bb in batch_sweep(args.b, args.t, args.f, cfg):
            window, warps, smem = config_plan(bb, args.t, args.t, args.f, cfg)
            qs, qls = q[:bb], ql[:bb]
            sec = chained_timeit(lambda *a, _c=cfg: dtw_batch_fused_banded(*a, _c),
                                 (qs, qls, bank, bl), n_iters=args.iters)
            rel, abs_err, _ = compare_dtw(dtw_batch_fused_banded(qs, qls, bank, bl, cfg),
                                          dtw_batch(qs, qls, bank, bl, cfg), 1e-4)
            pairs = bb * args.k
            mode = f"{'window' if window else 'staged'} x{warps}, {smem} B"
            print(f"B={bb:4d} ({mode}) {name:14s} {sec * 1e3:8.3f} ms "
                  f"({pairs / sec / 1e3:8.0f}k pairs/s)  max rel err {rel:.2e}", flush=True)
            rows.append(dict(variant=name, b=bb, pairs=pairs, window=window, warps=warps,
                             smem=smem, ms=sec * 1e3, pairs_per_s=pairs / sec,
                             max_rel_err=rel, max_abs_err=abs_err))
    return rows


if __name__ == "__main__":
    main()
