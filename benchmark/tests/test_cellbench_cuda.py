"""On the card: the control fails the comparison and the program passes
it, a traced run reads every per-layer metric, and ``run.py`` prints its
line.  Marked ``cuda``; each test skips where no card is present.

    python -m pytest benchmark/tests -q          # on a machine with a card
"""

import copy
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _cell(workload, words=8, per_word=8, request=32, pool=256):
    cell = harness.resolve(workload)
    cell = dict(cell, config=copy.deepcopy(cell["config"]), mix=copy.deepcopy(cell["mix"]))
    cell["config"].update(words=cell["config"]["words"][:words], templates_per_word=per_word)
    cell["mix"].update(request=request, pool=pool, warmup_requests=1, check_requests=2)
    return cell


@pytest.mark.parametrize("workload", ["sc2-35w.host256", "digits-100.dev1024"])
def test_control_fails_and_program_passes(workload, dev):
    from benchmark import control

    cell = _cell(workload)
    limit = cell["config"]["limits"]["dist_gap"]
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = control.readings(cell, seed, 0.5, dev)
        assert got["program"]["dist_gap"] <= limit and got["program"]["label_errors"] == 0
        assert got["control"]["dist_gap"] > limit, got


@pytest.mark.parametrize("workload", ["sc2-35w.host256", "digits-100.dev1024"])
def test_traced_run_reads_every_per_layer_metric(workload, dev):
    cell = _cell(workload)
    cell["mix"]["trace_requests"] = 20
    out = harness.run(cell, 2**31 + 11, 5.0, True, dev, 0.0)
    assert out["correct"]
    assert set(out["metrics"]) == {m["name"] for m in cell["per_layer"]}
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name in ("dtw_roofline", "request_mfu"):
        assert 0 < out["metrics"][name]["value"] < 100
    assert len(out["breakdown"]["device_ops"]) <= 10


def test_run_py_prints_one_result_line(dev):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sc2-35w.host256",
                           "--seed", str(2**31 + 21), "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"utterances_per_s", "request_p95_ms", "setup_s"}
    assert proc.stderr.strip().splitlines()[-1].startswith("label_errors ")
