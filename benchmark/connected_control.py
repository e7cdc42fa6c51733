"""The readings the connected-digit comparison's limits are set from, on
the card.

    python benchmark/connected_control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed: the cell's set-up, a short window at the cell's own load
that samples as many requests as a run does, then the numbers that
``connected.compare`` gives for the program's answers (the lower
readings) and for the control's (the upper readings): the reference in
the program's place one precision below the configuration's float32
with TF32 off (``connected.control``).  One JSON line a seed.
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

    from benchmark import connected, harness, knn
    from benchmark.reference import connected as ref

    config, mix = cell["config"], cell["mix"]
    entry = cell["entry"].set_up(config, mix, seed, device)
    for r in range(mix["warmup_requests"]):
        entry.call(entry.request(r)[1])
    reservoir = harness.Reservoir(mix["check_requests"], seed)
    lat, _ = harness.run_window(entry, seconds, reservoir)
    entry.release()
    torch.cuda.empty_cache()
    t_max = knn.t_max(config)
    limit = config["limits"]["score_gap"]
    fe = knn.frontend(config, device)
    fe32 = knn.frontend(config, device, torch.float32)
    lv, wp = entry.max_levels, entry.word_penalty
    out = {"seed": seed, "requests": len(lat), "program": [], "control": []}
    for idx, answer in reservoir.items:
        clips, lens = entry.pool[idx], entry.pool_lens[idx]
        feats, n = ref.features(fe, clips, lens, t_max)
        out["program"].append(connected.compare(*answer, feats, n, entry.groups, entry.masks,
                                                lv, wp, limit))
        c = connected.control(fe32, clips, lens, t_max, entry.groups, entry.masks, lv, wp)
        out["control"].append(connected.compare(*c, feats, n, entry.groups, entry.masks,
                                                lv, wp, limit))
    for side in ("program", "control"):
        got = out[side]
        out[side] = {"score_gap": max(g["score_gap"] for g in got),
                     "label_errors": sum(g["label_errors"] for g in got)}
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
        raise SystemExit("connected_control: no CUDA device")
    cell = harness.resolve(args.workload)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        res = readings(cell, int(s), args.seconds, torch.device("cuda", 0))
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
