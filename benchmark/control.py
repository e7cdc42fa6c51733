"""The readings the comparison's limits are set from, on the card.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed: the cell's set-up, a short window at the cell's own load
that samples as many requests as a run does, then the numbers that
``check.compare`` gives for the program's answers (the lower readings)
and for the control's (the upper readings): the reference in the
program's place in float32 with TF32 products, one precision below the
configuration's float32 with TF32 off.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(cell: dict, seed: int, seconds: float, device) -> dict:
    import torch

    from benchmark import check, harness, knn

    config, mix = cell["config"], cell["mix"]
    entry = cell["entry"].set_up(config, mix, seed, device)
    for r in range(mix["warmup_requests"]):
        entry.call(entry.request(r)[1])
    reservoir = harness.Reservoir(mix["check_requests"], seed)
    lat, _ = harness.run_window(entry, seconds, reservoir)
    entry.release()
    torch.cuda.empty_cache()
    t_max = knn.t_max(config)
    band, scale = config["band_frac"], config["max_warp_scale"]
    fe = knn.frontend(config, device)
    fe32 = knn.frontend(config, device, torch.float32)
    b_side = check.side(fe, entry.bank, t_max)
    out = {"seed": seed, "requests": len(lat), "program": [], "control": []}
    for idx, (ids, dists) in reservoir.items:
        q_side = check.side(fe, entry.pool[idx], t_max)
        out["program"].append(check.compare(ids, dists, entry.bank_ids, q_side, b_side, band,
                                            scale))
        c_ids, c_d = check.control(fe32, entry.bank, entry.pool[idx], entry.bank_ids, t_max,
                                   band, scale)
        out["control"].append(check.compare(c_ids, c_d, entry.bank_ids, q_side, b_side, band,
                                            scale))
    for side in ("program", "control"):
        got = out[side]
        out[side] = {"dist_gap": max(g["dist_gap"] for g in got),
                     "label_errors": sum(g["label_errors"] for g in got),
                     "marginal_clips": sum(g["marginal_clips"] for g in got)}
    return out


def main(argv=None):
    import torch

    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("control: no CUDA device")
    cell = harness.resolve(args.workload)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        res = readings(cell, int(s), args.seconds, torch.device("cuda", 0))
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
