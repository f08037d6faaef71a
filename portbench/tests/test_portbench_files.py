"""The benchmark's files: found by name, named within the contract's
characters, and free of the JAX package."""
from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(harness.__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set:
    """Top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = _imports(path) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "splatloc_tpu_torch" not in _imports(path), path


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config",
                                                          "traffic")]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_every_named_file_is_there():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.limits and cell.end_to_end and cell.per_layer
        harness.generator(cell)
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]).read)


def test_a_cell_added_only_as_files_is_found(tmp_path):
    """A new configuration, mix, metric and cell, added as files and
    entries beside a copy of the benchmark, are found by name."""
    root = tmp_path / "bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((HERE / "configs" / "replica_room0.json").read_text())
    cfg["Dataset"]["Calibration"]["fx"] = 400.0
    (root / "configs" / "wide.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "map.json").read_text())
    mix["keyframes"] = 12
    (root / "traffic" / "map_short.json").write_text(json.dumps(mix))
    (root / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return ctx.get('steps')\n")
    (root / "limits" / "map_short.wide.json").write_text(
        json.dumps({"loss_gap": 1e-3}))
    bench["configs"].append({"name": "wide", "source": "x",
                             "file": "bench/configs/wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "map_short.wide", "config": "wide",
                               "traffic": "map_short", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "map_step_ms":
            m["workloads"].append("map_short.wide")
    bench["per_layer"].append({"name": "steps_seen", "unit": "count",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "map_step_ms",
                               "workloads": ["map_short.wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell("map_short.wide", root)
    assert cell.config["Dataset"]["Calibration"]["fx"] == 400.0
    assert cell.traffic["keyframes"] == 12
    assert [m["name"] for m in cell.end_to_end] == ["map_step_ms",
                                                     "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["steps_seen"]
    assert harness.per_layer_values(cell, {"steps": 7}) == {
        "steps_seen": {"value": 7, "unit": "count"}}


@pytest.mark.parametrize("values,ok", [
    ({"a": 1.0, "b": 0.0}, True),
    ({"a": 2.5, "b": 0.0}, False),
    ({"a": float("nan"), "b": 0.0}, False),
    ({"a": float("inf"), "b": 0.0}, False),
    ({"b": 0.0}, False)])
def test_judge_holds_each_number_to_its_limit(values, ok):
    correct, checks = harness.judge(values, {"a": 2.0, "b": 0.0})
    assert correct is ok
    assert list(checks) == ["a", "b"]
