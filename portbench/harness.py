"""What every cell shares: the process settings made before torch loads,
finding a cell and its files by the names in ``BENCHMARK.json``, the
per-layer readers, the comparison against each limit and the result line.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<mix>.json`` (its ``generator`` names the module under
``generators/`` that generates and drives it), a per-layer metric
``metrics/<metric>.py`` (``read(ctx)`` returns a number or None) and a
cell's limits ``limits/<cell>.json``. Adding any of them is adding files.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "splatloc_tpu")
CPU_THREADS = 2


def set_process_env() -> None:
    """Before torch is imported: a small fixed CPU thread pool, and every
    kernel and compile cache at a fixed directory inside the checkout."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(CPU_THREADS)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def bind_kernel_cache() -> None:
    """Build the port's nvcc kernels into ``.cache/kernels`` of this
    directory (the port reads its build directory at build time)."""
    from splatloc_tpu_torch import build
    build.BUILD_DIR = CACHE / "kernels"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries
    limits: dict
    root: Path = HERE     # the benchmark's directory


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (beside ``root``) with its
    files under ``root``."""
    checkout = root.parent
    bench = load_json(checkout / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name=name, chips=w["chips"],
                config=load_json(checkout / conf["file"]),
                traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=layer,
                limits=load_json(root / "limits" / f"{name}.json"),
                root=root)


def generator(cell: Cell):
    return importlib.import_module(
        f"portbench.generators.{cell.traffic['generator']}")


def reader(metric: str, root: Path = HERE):
    """The module ``metrics/<metric>.py`` (a name may hold dots)."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_values(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell its reader finds something for."""
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"], cell.root).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_loaded() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): each compared number at or
    under its limit; a number missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
