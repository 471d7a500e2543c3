"""The port imports torch and never jax or yaml, and nothing of the JAX
package: the machine with the card has neither jax nor PyYAML, and the
port keeps its own copies of the host modules it needs.

A subprocess blocks jax, optax, yaml and iqtree2_tpu (sys.modules[...] = None
makes any import of them fail), imports every module of iqtree2_tpu_torch,
and runs through the CLI on the CPU a golden fixed-tree evaluation, a
two-iteration tree search with UFBoot, a small ModelFinder run
(-m TESTONLY), the command line of chip_smoke.py's phase 10 at -B 100
(every support, the site outputs, -asr, -mldist, -o), a partitioned fit
(-p example.nex -te) and, on a small simulated protein alignment, a
profile mixture's -te fit with -wspm and a --pmsf -te run, then a codon
-te fit, +E and a --mdef model, then the standalone tools (--alisim
under a mixture, -r, -pd) and a --date run with intervals. A source scan
fails on any import of iqtree2_tpu itself in the port (parallel/
included), in chip_smoke.py, tools/torch_phase17.py, the card-only
tests/test_torch_cuda.py and the distributed tests' ranks
(tests/torch_ranks.py).
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
sys.modules["iqtree2_tpu"] = None
sys.modules["yaml"] = None
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
    assert cli.main(["-s", sys.argv[1], "-m", "TESTONLY", "-mset", "JC,K2P",
                     "-mrate", "E,I", "--device", "cpu", "-pre", d + "/m",
                     "--quiet"]) == 0
    assert "Best-fit model according to BIC" in open(d + "/m.iqtree").read()
    assert cli.main(["-s", sys.argv[1], "-m", "GTR+G", "-B", "100", "-alrt",
                     "1000", "-abayes", "--tbe", "-bnni", "-wsl", "-wsr",
                     "-wspr", "-asr", "--mlrate", "-mldist", "-o",
                     "Frog,Turtle", "-n", "2", "-ninit", "3", "-ntop", "2",
                     "-nbest", "2", "--device", "cpu", "-pre", d + "/f",
                     "--quiet"]) == 0
    for ext in (".treefile", ".sitelh", ".rate", ".siteprob", ".state",
                ".mlrate", ".mldist", ".ufboot", ".contree"):
        assert open(d + "/f" + ext).read(), ext
    assert cli.main(["-s", sys.argv[1], "-p", sys.argv[3], "-m", "GTR+G",
                     "-te", sys.argv[2], "--device", "cpu", "-pre",
                     d + "/p", "--quiet"]) == 0
    assert "charpartition" in open(d + "/p.best_scheme.nex").read()
    assert "PARTITION TABLE" in open(d + "/p.iqtree").read()
    from iqtree2_tpu_torch import kernelcheck
    aln, tree, _, _ = kernelcheck.simulate("LG+C20+G4", 5, 40, seed=1)
    phy, nwk = kernelcheck.write_problem(aln, tree, d + "/aa")
    assert cli.main(["-s", phy, "-m", "LG+C10+G", "-te", nwk, "-wspm",
                     "--device", "cpu", "-pre", d + "/x", "--quiet"]) == 0
    assert open(d + "/x.siteprob").readline().count("\tp") == 10
    assert cli.main(["-s", phy, "-m", "LG+C10+G", "--pmsf", "-te", nwk,
                     "--device", "cpu", "-pre", d + "/y", "--quiet"]) == 0
    assert len(open(d + "/y.sitefreq").read().splitlines()) == 40
    aln, tree, _, _ = kernelcheck.simulate("GY+F3X4+G4", 5, 30, seed=1)
    phy, nwk = kernelcheck.write_problem(aln, tree, d + "/cds")
    assert cli.main(["-s", phy, "-st", "CODON", "-m", "GY+F3X4+G", "-te",
                     nwk, "--device", "cpu", "-pre", d + "/c",
                     "--quiet"]) == 0
    aln, tree, _, _ = kernelcheck.simulate("HKY+E+G4", 6, 100, seed=1)
    phy, nwk = kernelcheck.write_problem(aln, tree, d + "/dna")
    assert cli.main(["-s", phy, "-m", "HKY+E+G", "-te", nwk, "--device",
                     "cpu", "-pre", d + "/e", "--quiet"]) == 0
    open(d + "/defs.yml", "w").write(
        "- model: MYGTR\n  datatype: DNA\n"
        "  rates: [1.5, 4.0, 1.2, 0.8, 5.0, 1.0]\n"
        "  frequencies: [0.3, 0.2, 0.2, 0.3]\n")
    assert cli.main(["--mdef", d + "/defs.yml", "-s", sys.argv[1], "-m",
                     "MYGTR+G", "-te", sys.argv[2], "--device", "cpu",
                     "-pre", d + "/y", "--quiet"]) == 0
    for ext in ("c", "e", "y"):
        assert "Log-likelihood" in open(d + "/" + ext + ".iqtree").read()
    aln, tree, _, _ = kernelcheck.simulate("UNREST+G4", 6, 80, seed=1)
    phy, nwk = kernelcheck.write_problem(aln, tree, d + "/nr")
    assert cli.main(["-s", phy, "-m", "UNREST+G", "-te", nwk, "--root-test",
                     "--device", "cpu", "-pre", d + "/nr", "--quiet"]) == 0
    assert len(open(d + "/nr.roottest.csv").read().splitlines()) == 10
    other, _ = kernelcheck.perturbed(tree, seed=1, strength=0.3)
    open(d + "/two.nwk", "w").write(open(nwk).read() + other.to_newick())
    open(d + "/nr.yml", "w").write(
        "- model: MYNR\n  datatype: DNA\n  reversible: false\n"
        "  matrix: [[0, 1, 2, 1], [1, 0, 1, 2], [2, 1, 0, 1], [1, 2, 1, 0]]\n")
    for argv in (["-m", "GTR+H2", "-te", nwk], ["-m", "GTR+G+T", "-te",
                                                 d + "/two.nwk"],
                 ["-m", "MYNR+G", "--mdef", d + "/nr.yml", "-te", nwk]):
        assert cli.main(["-s", phy, "--device", "cpu", "-pre", d + "/n",
                         "--quiet"] + argv) == 0
        assert "Log-likelihood" in open(d + "/n.iqtree").read()
    import contextlib, io
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--alisim", d + "/sim", "-t", sys.argv[2], "-m",
                         "LG+C10+G", "--length", "40", "--device",
                         "cpu"]) == 0
        assert cli.main(["-r", "8", "-pre", d + "/rt"]) == 0
        assert cli.main(["-pd", "4", "-t", sys.argv[2], "-pre",
                         d + "/pd"]) == 0
    assert open(d + "/sim.phy").readline() == "17 40\n"
    assert open(d + "/rt.treefile").read().count(",") == 7
    assert "PD = " in open(d + "/pd.pda").read()
    names = [ln.split()[0] for ln in open(sys.argv[1]).read().splitlines()[1:]
             if ln.strip()]
    open(d + "/dates.txt", "w").write(
        "".join(f"{n} {2000 + i}\n" for i, n in enumerate(names)))
    assert cli.main(["-s", sys.argv[1], "-te", sys.argv[2], "-m", "JC",
                     "-blfix", "--date", d + "/dates.txt", "--date-ci", "5",
                     "--device", "cpu", "-pre", d + "/dt", "--quiet"]) == 0
    assert "failed replicates: " in open(d + "/dt.timetree.lsd").read()
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "optax", "iqtree2_tpu", "yaml")
            and sys.modules[m] is not None]
print(len(names), "modules;", report.split("Log-likelihood of the tree:")[1]
      .split()[0])
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT,
         str(ROOT / "tests" / "golden" / "example.phy"),
         str(ROOT / "tests" / "golden" / "ref_tree.nwk"),
         str(ROOT / "tests" / "golden" / "example.nex")],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    n_mod, logl = res.stdout.split()[0], res.stdout.split()[-1]
    assert int(n_mod) >= 15
    assert abs(float(logl) - (-23648.5507)) < 2e-3


def _imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports (ast)."""
    tree = ast.parse(path.read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    return {m.split(".")[0] for m in mods}


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the host modules only through
    iqtree2_tpu_torch, whose import set the test above checks."""
    mods = _imported(ROOT / "chip_smoke.py")
    assert "iqtree2_tpu_torch" in mods
    assert "iqtree2_tpu" not in mods, mods


def test_no_source_file_imports_the_jax_package():
    """No import whose top-level name is exactly iqtree2_tpu, at any depth
    (functions included), in the port, chip_smoke.py or the card tests."""
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
        ROOT / "tests" / "torch_ranks.py", ROOT / "tools" / "torch_phase17.py"]
    assert len(files) >= 40
    assert {PKG / "parallel" / f"{m}.py"
            for m in ("multihost", "shard", "dryrun")} <= set(files)
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if "iqtree2_tpu" in _imported(f)]
    assert not offenders, offenders


def test_no_source_file_imports_jax():
    """Nor jax, optax or yaml (PyYAML: the machine with the card has none;
    io/yamlmodels.py reads --mdef files itself)."""
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_ranks.py",
        ROOT / "tools" / "torch_phase17.py"]
    assert len(files) >= 10
    for f in files:
        assert not {"jax", "optax", "yaml"} & _imported(f), f
        for line in f.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "optax",
                                                       "yaml")), \
                f"{f}: {line}"
