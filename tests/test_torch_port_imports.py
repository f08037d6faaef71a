"""The PyTorch port stands alone: importing it (and chip_smoke.py,
kernel_ab.py) pulls in no JAX, Flax or splatloc_tpu module, at run time or
in its source."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "splatloc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "splatloc_tpu")

_PROBE = r"""
import importlib, json, pkgutil, sys
import splatloc_tpu_torch
names = ["splatloc_tpu_torch"]
for m in pkgutil.walk_packages(splatloc_tpu_torch.__path__,
                               "splatloc_tpu_torch."):
    names.append(m.name)
    importlib.import_module(m.name)
import chip_smoke, kernel_ab
names += ["chip_smoke", "kernel_ab"]
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in {FORBIDDEN})
print(json.dumps({"imported": names, "forbidden": bad}))
"""


def _forbidden_root(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_imports_pull_in_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    code = _PROBE.replace("{FORBIDDEN}", repr(set(FORBIDDEN)))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["forbidden"] == [], report["forbidden"]
    # every module of the slice was imported, not just the package root
    for mod in ("splatloc_tpu_torch.raster.hopper_raster",
                "splatloc_tpu_torch.raster.pairs",
                "splatloc_tpu_torch.scene.ply", "splatloc_tpu_torch.convert",
                "splatloc_tpu_torch.build", "splatloc_tpu_torch.knn.knn",
                "splatloc_tpu_torch.scene.densify",
                "splatloc_tpu_torch.scene.init_rgbd",
                "splatloc_tpu_torch.scene.optim",
                "splatloc_tpu_torch.train.losses",
                "splatloc_tpu_torch.train.mapping",
                "splatloc_tpu_torch.train.checkpoint",
                "splatloc_tpu_torch.cli.config", "chip_smoke", "kernel_ab"):
        assert mod in report["imported"], mod


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "kernel_ab.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _forbidden_root(name), (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")


def test_port_mirrors_reference_module_paths():
    """Each ported module has one counterpart at the same path in the JAX
    package (hopper_raster stands for pallas_raster)."""
    ref = ROOT / "splatloc_tpu"
    for p in PKG.rglob("*.py"):
        rel = p.relative_to(PKG)
        if rel.name == "hopper_raster.py":
            rel = rel.with_name("pallas_raster.py")
        if rel.name in ("convert.py", "build.py"):
            continue                     # port-only glue, no counterpart
        assert (ref / rel).exists(), rel


def test_walk_packages_sees_every_module():
    """The subprocess probe imports what walk_packages finds; make sure
    that is every module file of the package."""
    import splatloc_tpu_torch
    found = {m.name for m in pkgutil.walk_packages(
        splatloc_tpu_torch.__path__, "splatloc_tpu_torch.")}
    on_disk = {"splatloc_tpu_torch." + ".".join(
        p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"}
    assert on_disk <= found, on_disk - found
