"""The benchmark's harness: a cell resolved by name, its inputs drawn from
the seed, the program set up and warmed, the measured window, the traced
window, and the comparison with the reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json`` (named by the configuration's ``file``),
``traffic/<mix>.json`` and ``metrics/<metric>.py``.  A mix names its
entry, its request size, its pool of clips, its warm-up, the requests
the comparison samples and those the traced run traces.  The entry is
the file ``entries/<entry>.py``; its ``set_up(config, mix, seed,
device)`` returns an object with ``request``, ``call``, ``work``,
``stages``, ``guard_kernel``, ``release``, ``compare`` and ``record``
(``knn.py`` has the recognizer's).  An end-to-end metric's file
``end_to_end/<metric>.py`` defines ``read(window) -> float | None`` and a
per-layer metric's ``metrics/<metric>.py`` ``read(record) -> float | None``.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "dsp_tpu")
PROGRAM = "dsp_tpu_torch"


# -------------------------------------------------------------- resolving
def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(root: Path, folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark under ``root``."""
    path = root / HERE.name / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no file {path} for {folder} {name!r}")
    tag = "".join(c if c.isalnum() else "_" for c in f"{folder}_{name}")
    spec = importlib.util.spec_from_file_location(f"_bench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(root: Path, name: str):
    """The reader module of per-layer metric ``name``."""
    return load_module(root, "metrics", name)


def resolve(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload``: its configuration, mix and entry module, and
    the metrics it reports (``end_to_end`` and ``per_layer``, each with
    its reader module)."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(root / conf_entry["file"]) as f:
        config = json.load(f)
    with open(root / HERE.name / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "config": config, "mix": mix,
            "entry": load_module(root, "entries", mix["entry"]),
            "end_to_end": [dict(m, reader=load_module(root, "end_to_end", m["name"]))
                           for m in spec["end_to_end"] if mine(m)],
            "per_layer": [dict(m, reader=load_metric(root, m["name"]))
                          for m in spec["per_layer"] if mine(m)]}


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`BANNED`."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in BANNED})


# ----------------------------------------------------------------- inputs
def percentile_nearest_rank(values, q: float) -> float:
    """The smallest value with at least ``q`` percent of the values at or
    below it."""
    v = sorted(values)
    return v[max(0, int(np.ceil(q / 100.0 * len(v))) - 1)]


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from a seeded generator (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = np.random.default_rng([int(seed), 7])

    def offer(self, item) -> None:
        if self.n < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = item
        self.n += 1


# ----------------------------------------------------------------- window
def run_window(entry, seconds: float, reservoir: Reservoir, max_requests: int | None = None,
               span=lambda name: contextlib.nullcontext()):
    """Requests back to back, each timed from its call to its labels on
    the host, until ``seconds`` have passed (or ``max_requests`` are done),
    each inside ``span("request")``.  Returns (latencies s, window s)."""
    lat = []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    done = t_start
    r = 0
    while done < t_end and (max_requests is None or r < max_requests):
        idx, req = entry.request(r)
        with span("request"):
            t0 = time.perf_counter()
            out = entry.call(req)
            done = time.perf_counter()
        lat.append(done - t0)
        reservoir.offer((idx, out))
        r += 1
    return lat, done - t_start


def _spanned_program(stages):
    """Wrap each (module, function name) of ``stages`` in a
    ``record_function`` span (for the traced run only); returns the
    function that undoes it."""
    import torch

    saved = []
    for mod, name in stages:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(*a, _fn=fn, _name=name, **k):
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)
        setattr(mod, name, wrapped)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def traced_window(entry, seconds: float, max_requests: int, reservoir: Reservoir, device):
    """The window under ``torch.profiler`` with the entry's stages spanned
    and bracketed by CUDA events.  Returns (events, latencies, window s on
    the host clock, the window's CUDA-event ms, wrapper launches by name)."""
    import torch
    from benchmark import tracing
    from dsp_tpu_torch.kernels import _build

    undo = _spanned_program(entry.stages())
    before = dict(_build.LAUNCHES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("window"):
                start.record()
                lat, window = run_window(entry, seconds, reservoir, max_requests,
                                         torch.profiler.record_function)
                end.record()
            torch.cuda.synchronize(device)
    finally:
        undo()
    launches = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = tracing.load(path)
    finally:
        os.unlink(path)
    return events, lat, window, start.elapsed_time(end), launches


# ------------------------------------------------------------ main run
def fail(msg: str, code: int = 1):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def trace_problem(events, span, n_requests: int, launches: dict, event_ms: float,
                  kernel: str):
    """Why the trace of the window ``span`` cannot be read (lost device
    events: fewer ``kernel`` kernels traced than its wrapper launched, or
    requests without kernels; or a disagreement with the CUDA-event time
    of the same window), or None."""
    from benchmark import tracing

    dev = tracing.clip(tracing.device(events), span.ts, span.end)
    if not dev:
        return "the profiler recorded no device event in the traced window"
    busy_ms = tracing.busy_us(dev) / 1e3
    span_ms = (max(e.end for e in dev) - min(e.ts for e in dev)) / 1e3
    if busy_ms > event_ms * 1.01 + 0.05 or span_ms > event_ms * 1.02 + 0.5:
        return (f"trace disagrees with CUDA events: busy {busy_ms} ms, span {span_ms} ms, "
                f"events {event_ms} ms")
    n_k = tracing.count(tracing.device(events), kernel)
    if launches.get(kernel, 0) != n_k:
        return (f"trace lost device events: {n_k} {kernel} kernels traced, "
                f"{launches.get(kernel, 0)} launched")
    reqs = [e for e in events if e.cat == "user_annotation" and e.name == "request"]
    starts = sorted(e.ts for e in dev if e.cat == "kernel")
    per_req = [bisect.bisect_left(starts, r.end) - bisect.bisect_left(starts, r.ts)
               for r in reqs]
    if len(reqs) != n_requests or min(per_req) == 0 or min(per_req) < 0.5 * max(per_req):
        return (f"trace lost device events: kernels a request {min(per_req, default=0)}-"
                f"{max(per_req, default=0)} over {len(reqs)} spans of {n_requests} requests")
    return None


def main(args, t_process: float) -> None:
    """One run of one cell; prints the result line."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        fail("no CUDA device", 3)
    cell = resolve(args.workload)
    if torch.cuda.device_count() < cell["cell"]["chips"]:
        fail(f"{cell['cell']['chips']} devices needed, {torch.cuda.device_count()} present", 3)
    run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_process)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_process: float) -> dict:
    """The run itself, on ``device``; returns the result line's object
    after printing it."""
    import torch

    import dsp_tpu_torch
    from dsp_tpu_torch.kernels import _build

    if not Path(dsp_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        fail(f"{PROGRAM} loaded from outside the checkout: {dsp_tpu_torch.__file__}")
    config, mix = cell["config"], cell["mix"]
    t_imports = time.perf_counter() - t_process
    entry = cell["entry"].set_up(config, mix, seed, device)
    t_warm = time.perf_counter()
    for r in range(mix["warmup_requests"]):
        entry.call(entry.request(r)[1])
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process
    print(f"benchmark: setup_s {setup_s} (imports {t_imports} s, warm-up "
          f"{setup_s - (t_warm - t_process)} s, kernel build {_build.build_seconds} s)",
          file=sys.stderr, flush=True)

    if trace:
        from benchmark import tracing

        # the profiler may drop device events; a window whose trace did is
        # traced once more, and a second such window fails the run
        for attempt in (1, 2):
            reservoir = Reservoir(mix["check_requests"], seed)
            events, lat, window, event_ms, launches = traced_window(
                entry, seconds, mix["trace_requests"], reservoir, device)
            span = next(e for e in events if e.cat == "user_annotation" and e.name == "window")
            problem = trace_problem(events, span, len(lat), launches, event_ms,
                                    entry.guard_kernel)
            if problem is None:
                break
            print(f"benchmark: traced window {attempt}: {problem}", file=sys.stderr, flush=True)
        else:
            fail(problem)
        dev = tracing.clip(tracing.device(events), span.ts, span.end)
        busy_s = tracing.busy_us(dev) / 1e6
    else:
        reservoir = Reservoir(mix["check_requests"], seed)
        lat, window = run_window(entry, seconds, reservoir)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    n_req = len(lat)
    entry.release()
    if on_card:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program's state is freed
    t_ref = time.perf_counter()
    numbers, note = entry.compare(reservoir.items)
    limits = config["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    print(f"benchmark: reference {time.perf_counter() - t_ref} s over "
          f"{len(reservoir.items)} requests, {note}", file=sys.stderr)

    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": n_req, "failed": 0}
    if trace:
        record = {"events": dev, "requests": n_req, "window_s": span.dur / 1e6,
                  "busy_s": busy_s, "device": device, **entry.record(n_req)}
        metrics = {}
        for m in cell["per_layer"]:
            v = m["reader"].read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=busy_s, window_s=record["window_s"])
        out.update(metrics=metrics, device=dev_info, breakdown={
            "device_ops": tracing.top_device_ops(dev),
            "idle_gaps": tracing.idle_by_host(events, span.ts, span.end)})
        print(f"benchmark: traced {n_req} requests, {n_req / window} requests/s, "
              f"CUDA-event window {event_ms} ms, busy {busy_s} s", file=sys.stderr)
    else:
        win = {"latencies_s": lat, "window_s": window, "requests": n_req, "setup_s": setup_s,
               "work": {k: v * n_req for k, v in entry.work.items()}}
        metrics = {}
        for m in cell["end_to_end"]:
            v = m["reader"].read(win)
            if v is None:
                fail(f"end-to-end metric {m['name']} has nothing to read in this cell")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out.update(metrics=metrics, device=dev_info)
    out["compared"] = compared
    found = banned_modules()
    if found:
        fail(f"modules of JAX or the JAX package loaded: {found}")
    for k, v in compared.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return out
