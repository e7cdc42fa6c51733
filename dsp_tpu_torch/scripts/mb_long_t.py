"""Long-utterance DTW scaling: the scan against the banded and unbanded kernels.

    python -m dsp_tpu_torch.scripts.mb_long_t                # T in (198, 512, 1024)
    python -m dsp_tpu_torch.scripts.mb_long_t --t 1024 --pairs 256

Port of ``scripts/mb_long_t.py``: the same shapes, pair counts and
standard-normal inputs (``default_rng(0)`` a shape, queries first, every
length full).  For each T = U it times, with CUDA events over back-to-back
calls (``utils/timing.chained_timeit``):

- ``scan``: ``ops/dtw.py:dtw_batch``, the plain banded DP (a row loop of
  PyTorch ops; O(T*U) work whatever the band);
- ``kernel``: kernel 1 (``kernels/dtw_fused_banded.py``, band 0.17; past
  1,357 template frames its window mode), O(T*W) cells;
- ``unbanded``: kernel 4 (``kernels/dtw_fused.py``), O(T*U) cells;

and prints ms a call with the kernel/scan ratio.  The ``W plan`` column is
``window_plan.plan_window``'s window, then the mode and warps a block that
kernel 1's ``launch_plan`` picks.  Each kernel's distances are held to
its plain version on the same inputs (kernel 1 to the scan at rtol 1e-4,
kernel 4 to ``dtw_batch_fused_plain`` at rtol 1e-4 / atol 1e-5, the BIG
pattern identical) and a mismatch raises.  A row that runs out of device
memory, in its timing or its check, prints ``nan`` with the reason; any
other error raises.  Raises
for a device that is not a CUDA card.
"""

from __future__ import annotations

import argparse

import torch

K = 16                    # templates a shape
IMPLS = ("scan", "kernel", "unbanded")


def shapes(t_arg: int = 0) -> list[int]:
    return [t_arg] if t_arg else [198, 512, 1024]


def pair_count(t: int, pairs_arg: int = 0) -> tuple[int, int]:
    """(queries B, pairs B*K) at T = U = t: the cost tensor's footprint kept
    about that of 256 pairs at 198 frames, at least 64 pairs."""
    pairs = pairs_arg or max(64, (256 * 198 * 198) // (t * t) // 16 * 16)
    b = max(1, pairs // K)
    return b, b * K


def timed_functions(band: float):
    """name -> (function(q, ql, bank, bl), its plain version, DtwConfig,
    rtol, atol): what each row times and what it is held to."""
    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels.dtw_fused import dtw_batch_fused, dtw_batch_fused_plain
    from dsp_tpu_torch.kernels.dtw_fused_banded import dtw_batch_fused_banded
    from dsp_tpu_torch.ops.dtw import dtw_batch

    cfgb = DtwConfig(band_frac=band, squared=False)
    cfgu = DtwConfig(band_frac=None, squared=False)
    return {"scan": (dtw_batch, None, cfgb, 0.0, 0.0),
            "kernel": (dtw_batch_fused_banded, dtw_batch, cfgb, 1e-4, 0.0),
            "unbanded": (dtw_batch_fused, dtw_batch_fused_plain, cfgu, 1e-4, 1e-5)}


def plan_text(b: int, t: int, f: int, band: float) -> str:
    """The W plan cell: the JAX script's window, then kernel 1's launch."""
    from dsp_tpu_torch.config import DtwConfig
    from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
    from dsp_tpu_torch.window_plan import plan_window

    w, _, _, rb, covered = plan_window(band, t, t, 2.0)
    window, warps, _ = kdtw.config_plan(b, t, t, f, DtwConfig(band_frac=band))
    return (f"W={w} rb={rb}{' covered' if covered else ''}"
            f" ({'window' if window else 'staged'} x{warps})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=0, help="only this T (=U)")
    ap.add_argument("--pairs", type=int, default=0,
                    help="override B*K (B=pairs/16, K=16)")
    ap.add_argument("--f", type=int, default=39)
    ap.add_argument("--band", type=float, default=0.17)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--impls", default=",".join(IMPLS),
                    help="comma-subset of scan,kernel,unbanded")
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (default cuda: the card)")
    args = ap.parse_args(argv)
    impls = {s.strip() for s in args.impls.split(",") if s.strip()}

    from dsp_tpu_torch.scripts import compare_dtw, describe_device, dtw_inputs, require_card
    from dsp_tpu_torch.utils.timing import chained_timeit

    dev = require_card(args.device, "mb_long_t")
    fns = timed_functions(args.band)
    print(f"device: {describe_device(dev)}; band={args.band}, F={args.f}")
    print("| T=U | pairs | W plan | scan banded | fused banded | fused unbanded | kernel/scan |")
    print("|---|---|---|---|---|---|---|")
    rows = []
    for t in shapes(args.t):
        b, pairs = pair_count(t, args.pairs)
        q, ql, bank, bl = dtw_inputs(b, K, t, args.f, dev)
        row = {"t": t, "pairs": pairs, "plan": plan_text(b, t, args.f, args.band)}
        for name in IMPLS:
            row[name] = float("nan")
            if name not in impls:
                continue
            fn, plain, cfg, rtol, atol = fns[name]
            try:
                row[name] = chained_timeit(lambda *a, _f=fn, _c=cfg: _f(*a, _c),
                                           (q, ql, bank, bl), n_iters=args.iters) * 1e3
                if plain is not None:
                    got = fn(q, ql, bank, bl, cfg)
                    rel, abs_err, _ = compare_dtw(got, plain(q, ql, bank, bl, cfg), rtol, atol)
                    row[f"{name}_max_rel_err"], row[f"{name}_max_abs_err"] = rel, abs_err
            except torch.cuda.OutOfMemoryError as e:     # out of memory at long T is data
                row[name] = float("nan")                 # a time never held to plain
                row[f"{name}_error"] = f"out of memory: {str(e).splitlines()[0]}"
                print(f"# T={t} {name}: {row[f'{name}_error']}")
            torch.cuda.empty_cache()
        ratio = row["kernel"] / row["scan"] if row["scan"] == row["scan"] else float("nan")
        row["ratio"] = ratio
        print(f"| {t} | {pairs} | {row['plan']} | {row['scan']:.3f} ms |"
              f" {row['kernel']:.3f} ms | {row['unbanded']:.3f} ms | {ratio:.4f}x |", flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
