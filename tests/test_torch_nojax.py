"""The port imports torch and never jax: the machine with the card has none.

A subprocess blocks jax and optax (sys.modules[...] = None makes any import
of them fail), imports every module of iqtree2_tpu_torch, and runs through
the CLI on the CPU a golden fixed-tree evaluation and a two-iteration tree
search with UFBoot; no module of the JAX package that pulls jax in may
have been imported on the way (the jax-free host modules the port reuses,
ops/pars.py and search/{bionj,candidate,perturb,stoprule,ufboot}.py, and
their empty package files, may).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "iqtree2_tpu_torch"

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile
sys.modules["jax"] = None
sys.modules["optax"] = None
import iqtree2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(iqtree2_tpu_torch.__path__,
                                               "iqtree2_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
from iqtree2_tpu_torch import cli
with tempfile.TemporaryDirectory() as d:
    assert cli.main(["-s", sys.argv[1], "-te", sys.argv[2], "-m", "JC",
                     "-blfix", "--f64", "--device", "cpu", "-pre", d + "/r",
                     "--quiet"]) == 0
    report = open(d + "/r.iqtree").read()
    assert cli.main(["-s", sys.argv[1], "-m", "JC", "-n", "2", "-ninit",
                     "3", "-ntop", "2", "-nbest", "2", "-bb", "20",
                     "--device", "cpu", "-pre", d + "/s", "--quiet"]) == 0
    assert len(open(d + "/s.ufboot").read().splitlines()) == 20
allowed = {"iqtree2_tpu.ops", "iqtree2_tpu.search", "iqtree2_tpu.ops.pars"} | {
    f"iqtree2_tpu.search.{m}"
    for m in ("bionj", "candidate", "perturb", "stoprule", "ufboot")}
forbidden = [m for m in sys.modules if m not in allowed and (
    m.split(".")[:2] in (
        ["iqtree2_tpu", "engine"], ["iqtree2_tpu", "analysis"],
        ["iqtree2_tpu", "ops"], ["iqtree2_tpu", "search"])
    or m in ("iqtree2_tpu.model.optimize", "iqtree2_tpu.model.jaxfit"))]
assert not forbidden, forbidden
print(len(names), "modules;", report.split("Log-likelihood of the tree:")[1]
      .split()[0])
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT,
         str(ROOT / "tests" / "golden" / "example.phy"),
         str(ROOT / "tests" / "golden" / "ref_tree.nwk")],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    n_mod, logl = res.stdout.split()[0], res.stdout.split()[-1]
    assert int(n_mod) >= 15
    assert abs(float(logl) - (-23648.5507)) < 2e-3


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the JAX package's jax-free modules only
    through iqtree2_tpu_torch, whose import set the test above checks."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert "iqtree2_tpu_torch" in mods
    assert not [m for m in mods if m.split(".")[0] == "iqtree2_tpu"], mods


def test_no_source_file_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 10
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "optax")), \
                f"{f}: {line}"
