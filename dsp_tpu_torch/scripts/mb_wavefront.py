"""Microbenchmarks of the wavefront DTW design, on the card.

    python -m dsp_tpu_torch.scripts.mb_wavefront [all|dma|dp|anatomy|tr|skew|cost]

Port of ``scripts/mb_wavefront.py``: the same experiments at the same
shapes and inputs, through the kernels of ``csrc/mb_wavefront.cu``.

- E0 ``dma``: read the 6.71 GB pre-skewed array [12800, 512, 256] in the
  order and launch geometry of E1, with no DP: E1's copy floor.
- E1 ``dp``: the op-diet wavefront DP over the same array.
- E1b ``anatomy``: SM cycles a step of a dependent chain of ``n_rolls``
  shuffle shifts, a min and an add, read by ``clock64()`` in the kernel,
  and the trivial kernel's launch time.
- E2 ``tr``: batched transpose [12800, 256, 512] -> [12800, 512, 256].
- E3 ``skew``: cost [12800, 256, 256] -> skewed [12800, 512, 256].
- E4 ``cost``: the batched cost [12800, 256, 256] of 128 queries x 100
  templates, one fp32 einsum.

In place of the TPU's PAIR_TILE and QB sweeps each experiment sweeps this
design's own knob (warps a block for E0/E1, thread rows of a tile block
for E2/E3) and prints the values swept.  Times are seconds per call over
back-to-back calls (``utils/timing.chained_timeit``), except E1b's, which
are single launches between CUDA events (``utils/timing.time_ms``) so
that the launch can be subtracted; printed in ms, GB/s and cycles a step,
under the card's name and power limit.  There is no CPU
run: every function raises without a card.  Each experiment's tensors are
freed before the next.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from dsp_tpu_torch.kernels import mb_wavefront as mbk
from dsp_tpu_torch.scripts import require_card
from dsp_tpu_torch.utils.timing import chained_timeit, time_ms

BIG = 1e30
P, T, U = 12800, 198, 198
T_PAD, U_PAD = 256, 256
D_PAD = 512                       # t+u-1 = 395 -> keep 512, as the JAX script
WARP_SWEEP = (2, 4, 8, 16)        # warps a block, E0 and E1
BLOCK_ROW_SWEEP = (2, 4, 8, 16)   # thread rows of a 32-wide tile block, E2 and E3
ANATOMY_STEPS = 4000
# the JAX script's shapes, then one cell a lane (width 32), where the rolls'
# shuffles form a latency chain; at 8 or 16 cells a lane they move boundary
# cells that no earlier shuffle wrote, and overlap the other cells' work
ANATOMY_SHAPES = [(pt, width) for pt in (64, 256) for width in (256, 512)] + [(64, 32)]
ROLLS = (0, 1, 2)
COST_B, COST_K, COST_F = 128, 100, 40
EXPERIMENTS = ("dma", "dp", "anatomy", "tr", "skew", "cost")


def nvidia_smi(query: str) -> list[str]:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader,nounits`` lines."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()


def skew_gb() -> float:
    return P * D_PAD * T_PAD * 4 / 1e9


def bench_dma(device="cuda") -> dict:
    dev = require_card(device, "mb_wavefront")
    print("=== E0: pure fetch of the same 6.71 GB skew array (dp's loads, no DP) ===")
    skew = torch.ones((P, D_PAD, T_PAD), dtype=torch.float32, device=dev)
    ktarget = torch.zeros((P, 1), dtype=torch.int32, device=dev)
    ms = {}
    for w in WARP_SWEEP:
        sec = chained_timeit(lambda s, kt, _w=w: mbk.dma_fetch(s, kt, warps=_w),
                             (skew, ktarget), n_iters=4)
        ms[w] = sec * 1e3
        print(f"  warps/block={w}: {sec * 1e3:.3f} ms ({skew_gb() / sec:.0f} GB/s read)")
    return {"ms": ms, "gb_per_s": {w: skew_gb() / v * 1e3 for w, v in ms.items()}}


def bench_dp(device="cuda") -> dict:
    dev = require_card(device, "mb_wavefront")
    print("=== E1: op-diet wavefront DP (pre-skewed dummy input) ===")
    skew = torch.ones((P, D_PAD, T_PAD), dtype=torch.float32, device=dev)
    ktarget = torch.full((P, 1), T + U - 2, dtype=torch.int32, device=dev)
    la = torch.full((P, 1), T, dtype=torch.int32, device=dev)
    ms = {}
    for w in WARP_SWEEP:
        sec = chained_timeit(lambda s, kt, a, _w=w: mbk.dp_diet(s, kt, a, warps=_w),
                             (skew, ktarget, la), n_iters=4)
        ms[w] = sec * 1e3
        print(f"  warps/block={w}: {sec * 1e3:.3f} ms ({skew_gb() / sec:.0f} GB/s read)")
    return {"ms": ms, "gb_per_s": {w: skew_gb() / v * 1e3 for w, v in ms.items()}}


def bench_anatomy(device="cuda") -> dict:
    dev = require_card(device, "mb_wavefront")
    print("=== E1b: per-op anatomy (loop of shuffle rolls + min + add, no device memory) ===")
    x0 = torch.ones((8, 128), dtype=torch.float32, device=dev)
    # back to back, a call takes as long as Python needs to issue it: the
    # JAX script's "launch" number.  One launch between CUDA events is the
    # baseline subtracted below, as each anatomy launch is timed that way
    chain = chained_timeit(mbk.trivial, (x0,), n_iters=16)
    base = time_ms(lambda: mbk.trivial(x0)) / 1e3
    print(f"  trivial kernel launch: {chain * 1e6:.1f} us a call back to back; "
          f"{base * 1e6:.1f} us one launch between CUDA events")
    cur_mhz, max_mhz = (float(v) for v in nvidia_smi("clocks.sm,clocks.max.sm")[0].split(","))
    print(f"  SM clock (nvidia-smi, between runs): {cur_mhz:.0f} MHz, max {max_mhz:.0f} MHz")
    steps = ANATOMY_STEPS
    rows = {}
    for pt, width in ANATOMY_SHAPES:
        for n_rolls in ROLLS:
            x = torch.ones((pt, width), dtype=torch.float32, device=dev)
            sec = time_ms(lambda _r=n_rolls: mbk.anatomy(x, _r, steps)) / 1e3
            cycles = torch.zeros((pt,), dtype=torch.int64, device=dev)
            mbk.anatomy(x, n_rolls, steps, cycles=cycles)
            cyc = statistics.median(cycles.tolist()) / steps
            lc_ns = (sec - base) * 1e9 / steps
            # clock64's cycles over the launch-corrected time: the SM clock it ran at
            mhz = cyc / lc_ns * 1e3 if lc_ns > 0 else float("nan")
            rows[f"{pt}x{width}_rolls{n_rolls}"] = dict(
                us=sec * 1e6, cycles_per_step=cyc, ns_per_step=lc_ns, implied_mhz=mhz)
            print(f"  [{pt},{width}] rolls={n_rolls}: {sec * 1e6:.1f} us -> "
                  f"{cyc:.1f} SM cycles/step (clock64); {lc_ns:.2f} ns/step "
                  f"launch-corrected, i.e. {mhz:.0f} MHz")
    return {"trivial_chained_us": chain * 1e6, "trivial_us": base * 1e6,
            "sm_mhz": cur_mhz, "max_sm_mhz": max_mhz, "steps": steps, "rows": rows}


def bench_transpose(device="cuda") -> dict:
    dev = require_card(device, "mb_wavefront")
    print("=== E2: batched transpose [12800, 256, 512] -> [12800, 512, 256] ===")
    x = torch.ones((P, T_PAD, D_PAD), dtype=torch.float32, device=dev)
    gb = x.numel() * 4 / 1e9
    ms = {}
    for br in BLOCK_ROW_SWEEP:
        sec = chained_timeit(lambda v, _b=br: mbk.transpose(v, block_rows=_b), (x,),
                             n_iters=4)
        ms[br] = sec * 1e3
        print(f"  block_rows={br}: {sec * 1e3:.3f} ms ({2 * gb / sec:.0f} GB/s r+w)")
    sec = chained_timeit(lambda v: v.transpose(1, 2).contiguous(), (x,), n_iters=4)
    print(f"  library x.transpose(1, 2).contiguous(): {sec * 1e3:.3f} ms "
          f"({2 * gb / sec:.0f} GB/s r+w)")
    return {"ms": ms, "library_ms": sec * 1e3,
            "gb_per_s": {b: 2 * gb / v * 1e3 for b, v in ms.items()}}


def bench_skew(device="cuda") -> dict:
    dev = require_card(device, "mb_wavefront")
    print("=== E3: skew-construct kernel cost[Q,T,U] -> skew[Q,D,T] ===")
    cost = torch.ones((P, T_PAD, U_PAD), dtype=torch.float32, device=dev)
    gb = (cost.numel() + P * D_PAD * T_PAD) * 4 / 1e9
    ms = {}
    for br in BLOCK_ROW_SWEEP:
        sec = chained_timeit(lambda v, _b=br: mbk.skew(v, D_PAD, block_rows=_b),
                             (cost,), n_iters=4)
        ms[br] = sec * 1e3
        print(f"  block_rows={br}: {sec * 1e3:.3f} ms ({gb / sec:.0f} GB/s, "
              f"3.36 GB in + 6.71 GB out)")
    return {"ms": ms, "gb_per_s": {b: gb / v * 1e3 for b, v in ms.items()}}


def bench_cost(device="cuda") -> dict:
    dev = require_card(device, "mb_wavefront")
    print("=== E4: batched cost, one fp32 einsum (128 q x 100 t) ===")
    q = torch.ones((COST_B, T_PAD, COST_F), dtype=torch.float32, device=dev)
    b = torch.ones((COST_K, U_PAD, COST_F), dtype=torch.float32, device=dev)
    sec = chained_timeit(mbk.cost, (q, b), n_iters=4)
    print(f"  cost tensor [12800,256,256]: {sec * 1e3:.3f} ms")
    return {"ms": sec * 1e3}


BENCHES = {"dma": bench_dma, "dp": bench_dp, "anatomy": bench_anatomy,
           "tr": bench_transpose, "skew": bench_skew, "cost": bench_cost}


def run(which: str = "all", device="cuda") -> dict:
    """Run one experiment, or all in the JAX script's order; returns each
    one's numbers by name."""
    if which != "all" and which not in BENCHES:
        raise ValueError(f"unknown experiment {which!r}; want all or one of "
                         f"{', '.join(EXPERIMENTS)}")
    dev = require_card(device, "mb_wavefront")
    print("; ".join(nvidia_smi("name,power.limit")) + " W", flush=True)
    out = {}
    for name in EXPERIMENTS:
        if which in ("all", name):
            out[name] = BENCHES[name](dev)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "all")
