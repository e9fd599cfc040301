"""``BENCHMARK.json`` against the benchmark's contract, the files a cell is
found by, and the imports: nothing the benchmark runs loads JAX or the JAX
package, and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from pbcases import HERE, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "volumerenderer_tpu"}


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word


def test_names_units_and_keys():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in SPEC[group]:
            assert NAME.match(item["name"]), item["name"]
            key = (group in ("end_to_end", "per_layer"), item["name"])
            assert key not in names
            names.add(key)
            if "unit" in item:
                assert UNIT.match(item["unit"])
                assert item["better"] in ("lower", "higher")
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        mine = [m for m in SPEC["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layer = [m for m in SPEC["per_layer"]
                 if w["name"] in m.get("workloads", [])]
        assert layer
        for m in layer:
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    import harness

    assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert (HERE / "limits" / f"{w['name']}.json").exists()
    _, config, traffic, limits = harness.cell_files(SPEC, w["name"])
    assert config["name"] == w["config"] and config["reduced"] == []
    assert callable(harness.drive.driver(traffic["kind"]).drive)
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    import harness

    assert callable(harness.load_metric(m["name"]).read)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax():
    for p in HERE.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(p)}
        assert tops <= {"__future__", "math", "numpy", "torch"}, (p, tops)


def test_a_run_loads_no_jax():
    """A whole CPU run of a cell, in a fresh process, leaves no JAX module
    and no module of the JAX package in ``sys.modules``."""
    code = (
        "import sys, pbcases, run\n"
        "pbcases.run_small('cloud96-point-converge', width=32, height=24)\n"
        "print(run.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": f"{HERE}:{HERE / 'tests'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cloud96-point-converge", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin"})


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "volumerenderer_tpu_torch" in out.stderr


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is there")
    out = _run(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
