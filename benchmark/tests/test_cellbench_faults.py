"""A run on the CPU at a tiny cut, past the look for a card: sound, it
comes out correct; with its timed path broken underneath, not."""

import copy

import pytest
import torch

from benchmark import harness

CUT = {"words": ["yes", "no", "up"], "templates_per_word": 2}


def _cell(workload):
    cell = harness.resolve(workload)
    cell = dict(cell, config=copy.deepcopy(cell["config"]), mix=copy.deepcopy(cell["mix"]))
    cell["config"].update(CUT)
    cell["mix"].update(request=4, pool=8, warmup_requests=1, check_requests=2)
    return cell


def _run(workload, seconds=0.5):
    return harness.run(_cell(workload), 2**31 + 99, seconds, False, torch.device("cpu"), 0.0)


def _alter_a_distance(ids, d):
    d = d.clone()
    live = (d[0] < 1e20).nonzero()[0, 0]
    d[0, live] *= 1.001
    return ids, d


def _alter_a_label(ids, d):
    ids = ids.clone()
    ids[0] = (ids[0] + 1) % 3
    return ids, d


def _half_the_batch(ids, d):
    """The second half of the batch answered with the first half's rows."""
    h = d.shape[0] // 2
    return torch.cat([ids[:h], ids[:h]]), torch.cat([d[:h], d[:h]])


WORKLOADS = ["sc2-35w.host256", "digits-100.dev1024"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload, capsys):
    out = _run(workload)
    assert out["correct"] and out["attempted"] > 0
    assert list(out)[-1] == "compared"
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2].startswith("dist_gap ") and err[-1].startswith("label_errors ")


@pytest.mark.parametrize("fault", [_alter_a_distance, _alter_a_label, _half_the_batch],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    from dsp_tpu_torch import pipeline

    real = pipeline.recognize_batch

    def broken(*a, **k):
        return fault(*real(*a, **k))
    monkeypatch.setattr(pipeline, "recognize_batch", broken)
    out = _run(workload)
    assert out["correct"] is False


def test_a_loaded_jax_module_fails_the_run(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    with pytest.raises(SystemExit):
        _run("sc2-35w.host256", seconds=0.1)


def test_no_result_without_the_program(tmp_path):
    import json
    import shutil
    import subprocess
    import sys

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sc2-35w.host256",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
