"""BENCHMARK.json against the contract's shape, every piece found by
name, a new metric file taken without an edit, and the import guard."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "dsp_tpu"}, tops
    rel = path.relative_to(BENCH).parts
    if rel[0] in ("reference", "data"):
        assert "dsp_tpu_torch" not in tops, tops


def test_guard_compares_whole_top_level_names():
    import sys
    import types

    sys.modules["dsp_tpu_torch_lookalike"] = types.ModuleType("dsp_tpu_torch_lookalike")
    try:
        assert "dsp_tpu_torch_lookalike" not in harness.banned_modules()
        sys.modules["dsp_tpu.sub"] = types.ModuleType("dsp_tpu.sub")
        assert harness.banned_modules() == ["dsp_tpu.sub"]
    finally:
        sys.modules.pop("dsp_tpu_torch_lookalike", None)
        sys.modules.pop("dsp_tpu.sub", None)


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = harness.resolve(workload)
    assert callable(cell["entry"].set_up)
    assert cell["config"]["name"] == cell["cell"]["config"]
    assert cell["mix"]["name"] == cell["cell"]["traffic"]
    assert cell["mix"]["pool"] % cell["mix"]["request"] == 0
    assert {m["name"] for m in cell["end_to_end"]} == {
        "utterances_per_s", "request_p95_ms", "setup_s"}
    assert all(callable(m["reader"].read) for m in cell["per_layer"] + cell["end_to_end"])
    assert set(cell["config"]["limits"]) == {"dist_gap", "label_errors"}


def test_config_files_state_every_reduced_key():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert conf["source"] == c["source"]


def test_new_metric_file_is_taken_without_an_edit(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "kernels_per_ms", "unit": "1/ms", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "utterances_per_s",
                              "workloads": ["digits-100.dev1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "benchmark" / "metrics" / "kernels_per_ms.py").write_text(
        "def read(rec):\n    return len(rec['events']) / (rec['window_s'] * 1e3)\n")
    cell = harness.resolve("digits-100.dev1024", root=tmp_path)
    new = [m for m in cell["per_layer"] if m["name"] == "kernels_per_ms"]
    assert new and new[0]["reader"].read({"events": [1, 2, 3], "window_s": 0.001}) == 3.0
    other = harness.resolve("sc2-35w.host256", root=tmp_path)
    assert "kernels_per_ms" not in {m["name"] for m in other["per_layer"]}


ECHO_ENTRY = """
class Entry:
    guard_kernel = "none"

    def __init__(self, mix):
        self.work = {"items": mix["request"]}

    def request(self, r):
        return r, r

    def call(self, r):
        return r

    def stages(self):
        return []

    def release(self):
        pass

    def compare(self, items):
        return {"misses": sum(k != out for k, out in items)}, "echo"

    def record(self, n_req):
        return {}


def set_up(config, mix, seed, device):
    return Entry(mix)
"""


def test_new_entry_and_end_to_end_metric_are_taken_without_an_edit(tmp_path):
    """A cell on a new entry, reporting a new end-to-end metric, runs from
    data files alone: the harness is not edited."""
    import torch

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "benchmark"
    (new / "entries" / "echo.py").write_text(ECHO_ENTRY)
    (new / "end_to_end" / "items_per_s.py").write_text(
        "def read(win):\n    return win['work']['items'] / win['window_s']\n")
    (new / "traffic" / "echo4.json").write_text(json.dumps(
        {"name": "echo4", "entry": "echo", "request": 4, "pool": 8, "warmup_requests": 1,
         "check_requests": 2, "trace_requests": 10}))
    (new / "configs" / "echo.json").write_text(json.dumps(
        {"name": "echo", "source": "https://example.org/echo", "reduced": {},
         "limits": {"misses": 0}}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "echo", "source": "https://example.org/echo",
                            "file": "benchmark/configs/echo.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "echo.echo4", "config": "echo", "traffic": "echo4",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "items_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["echo.echo4"]})
    for m in spec["end_to_end"]:
        if m["name"] != "setup_s" and m["name"] != "items_per_s":
            assert "workloads" in m
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve("echo.echo4", root=tmp_path)
    out = harness.run(cell, 5, 0.05, False, torch.device("cpu"), 0.0)
    assert out["correct"] and set(out["metrics"]) == {"items_per_s", "setup_s"}
    assert out["metrics"]["items_per_s"]["value"] > 0
    assert out["compared"] == {"misses": {"value": 0, "limit": 0}}


def test_config_widths_reach_the_program_and_the_reference():
    from benchmark import knn

    conf = dict(json.loads((BENCH / "configs" / "digits-100.json").read_text()),
                frame_len=320, hop=80, n_fft=1024, n_mels=40, n_mfcc=20, n_feats=60, lifter=0)
    cfg = knn.pipeline_config(conf).frontend
    assert (cfg.frame_len, cfg.hop_len, cfg.n_fft, cfg.n_mels, cfg.n_mfcc, cfg.lifter) == (
        320, 80, 1024, 40, 20, 0)
    fe = knn.frontend(conf, "cpu")
    assert (fe.frame_len, fe.hop, fe.n_fft, tuple(fe.mel_t.shape), tuple(fe.dct_t.shape)) == (
        320, 80, 1024, (513, 40), (40, 20))
    assert bool((fe.lifter == 1.0).all())
    assert knn.t_max(conf) == 1 + (32000 - 320) // 80
    with pytest.raises(SystemExit):
        knn.widths(dict(conf, n_feats=39))
