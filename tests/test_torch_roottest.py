"""The root position test (--root-test, roottest.py) on the port against
the JAX package, float64 on the CPU: one rooting's logL (1e-9) with the
all-unknown __ROOT__ pseudo-taxon on a zero-length edge, run_root_test on
5 x 120 under UNREST+G4 (logLs within 1e-6, the same best root and the
same rootstrap from the same seed), and the command line: .roottest.csv
with 2L - 3 rows whose rootstrap sums to 1, .rooted.nwk, and the refusal
with -q.
"""

import csv
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu import roottest as jroottest
from iqtree2_tpu_torch import cli, kernelcheck, roottest
from iqtree2_tpu_torch.engine import LikelihoodEngine
from tests.torch_parity import simulate_both

ALN = "tests/golden/example.phy"
TREE = "tests/golden/ref_tree.nwk"
NEX = "tests/golden/example.nex"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rooted_logl_matches_jax():
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        "UNREST+G4", 6, 150, 2)
    a, b = sorted(tree.edges())[2]
    raln = roottest.root_alignment(aln)
    rt = roottest.rooted_tree_on_branch(tree, a, b)
    jrt = jroottest.rooted_tree_on_branch(jtree, a, b)
    eng = LikelihoodEngine(raln, model, rates, dtype=torch.float64,
                           device="cpu")
    jeng = jengine.LikelihoodEngine(jroottest.root_alignment(jaln), jmodel,
                                    jrates, dtype=jnp.float64)
    got, want = eng.loglik_tree(rt), jeng.loglik_tree(jrt)
    assert abs(got - want) <= 1e-9 * abs(want)
    # __ROOT__ holds no data and hangs on a zero-length edge (P_0 = I)
    assert rt.get_blen(0, rt.adj[0][0]) == 0.0
    assert abs(got - LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                                      device="cpu").loglik_tree(tree)) > 0


def test_run_root_test_matches_jax():
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        "UNREST+G4", 5, 120, 1)
    got = roottest.run_root_test(aln, tree, model, rates,
                                 dtype=torch.float64, device="cpu",
                                 log=lambda s: None)
    want = jroottest.run_root_test(jaln, jtree, jmodel, jrates,
                                   dtype=jnp.float64, log=lambda s: None)
    assert got.branches == want.branches and got.labels == want.labels
    assert np.abs(got.logL - want.logL).max() < 1e-6
    assert got.best == want.best
    np.testing.assert_array_equal(got.rootstrap, want.rootstrap)
    assert len(got.branches) == 2 * 5 - 3


def test_command_line(tmp_path):
    aln, tree, _, _ = kernelcheck.simulate("UNREST+G4", 7, 200, seed=3)
    phy, nwk = kernelcheck.write_problem(aln, tree, tmp_path / "p")
    pre = str(tmp_path / "r")
    assert cli.main(["-s", phy, "-m", "UNREST+G", "-te", nwk, "--root-test",
                     "--device", "cpu", "-pre", pre, "--quiet"]) == 0
    with open(pre + ".roottest.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 * 7 - 3
    assert abs(sum(float(r["rootstrap"]) for r in rows) - 1.0) < 1e-9
    best = max(rows, key=lambda r: float(r["logL"]))
    assert "Best root branch: " + best["Branch"] in \
        Path(pre + ".iqtree").read_text()
    rooted = Path(pre + ".rooted.nwk").read_text()
    assert "__ROOT__" not in rooted and rooted.count("(") == 7 - 1


def test_refused_with_partitions(tmp_path):
    with pytest.raises(SystemExit, match="--root-test with -p/-q/-Q"):
        cli.main(["-s", ALN, "-q", NEX, "-m", "GTR+G", "-te", TREE,
                  "--root-test", "--device", "cpu", "--quiet", "-pre",
                  str(tmp_path / "x")])
