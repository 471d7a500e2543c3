"""Tree mixtures (+T, model/treemix.py) on the port against the JAX
package, float64 on the CPU: TreeMixture.fit on 8 x 96 (weights and logL
within 1e-6, the same branch lengths), the -m GTR+G+T command line with
two -te trees (both trees in .treefile, the weights in .iqtree, EM's logL
never falling) and the refusals: +T without two -te trees, with a flag
the JAX package's +T flow ignores, with -q (ROADMAP C19).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.model.treemix import TreeMixture as JTreeMixture
from iqtree2_tpu.search.perturb import random_nnis as jrandom_nnis
from iqtree2_tpu_torch import cli, kernelcheck
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model.treemix import TreeMixture
from iqtree2_tpu_torch.search.perturb import random_nnis
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


def test_fit_matches_jax():
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        "GTR+G4", 8, 96, 3)
    other, jother = tree.copy(), jtree.copy()
    assert random_nnis(other, np.random.default_rng(1), 0.3) == \
        jrandom_nnis(jother, np.random.default_rng(1), 0.3)
    tm = TreeMixture(LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                                      device="cpu"), [tree, other])
    jtm = JTreeMixture(jengine.LikelihoodEngine(jaln, jmodel, jrates,
                                                dtype=jnp.float64),
                       [jtree, jother])
    got = tm.fit(n_iter=4)
    want = jtm.fit(n_iter=4)
    assert abs(got - want) < 1e-6
    assert np.abs(tm.weights - jtm.weights).max() < 1e-6
    for t, jt in zip(tm.trees, jtm.trees):
        assert t.to_newick(digits=6) == jt.to_newick(digits=6)
    assert all(b >= a - 1e-9 for a, b in zip(tm.history, tm.history[1:]))


def test_command_line(tmp_path):
    aln, tree, _, _ = kernelcheck.simulate("GTR+G4", 8, 200, seed=2)
    phy, nwk = kernelcheck.write_problem(aln, tree, tmp_path / "p")
    other, _ = kernelcheck.perturbed(tree, seed=1, strength=0.3)
    two = tmp_path / "two.nwk"
    two.write_text(tree.to_newick() + "\n" + other.to_newick() + "\n")
    pre = str(tmp_path / "t")
    assert cli.main(["-s", phy, "-m", "GTR+G+T", "-te", str(two),
                     "--device", "cpu", "-pre", pre]) == 0
    assert len(Path(pre + ".treefile").read_text().splitlines()) == 2
    report = Path(pre + ".iqtree").read_text()
    w = [float(x) for x in re.search(r"Tree mixture weights: (.*)",
                                     report).group(1).split(",")]
    assert abs(sum(w) - 1.0) < 1e-3
    em = [float(x) for x in re.findall(r"EM iter \d+: logL (-?[\d.]+)",
                                       Path(pre + ".log").read_text())]
    assert len(em) >= 2 and all(b >= a - 1e-3 for a, b in zip(em, em[1:]))


@pytest.mark.parametrize("argv,message", [
    (["-m", "GTR+G+T"], "requires -te FILE"),
    (["-m", "GTR+G+T", "-te", TREE], "two or more trees"),
    (["-m", "GTR+G+T", "-te", TREE, "-wsl"], "-wsl with -m GTR"),
])
def test_refusals(tmp_path, argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["-s", ALN, "--device", "cpu", "--quiet", "-n", "1",
                  "-pre", str(tmp_path / "x")] + argv)


@pytest.mark.parametrize("model,message", [
    ("UNREST+G", "nonreversible"), ("12.12", "nonreversible"),
    ("GTR+P", "PoMo"), ("GTR+H2", "per-class branch lengths"),
    ("GTR+G+T", "tree mixtures")])
def test_new_families_refused_on_partitions(tmp_path, model, message):
    """C19: a -q file naming a nonreversible, PoMo, +H or +T model stops
    (the JAX package's partition path runs such a model through its
    eigenbasis Newton, or drops the term)."""
    nex = tmp_path / "p.nex"
    nex.write_text(Path(NEX).read_text().replace("HKY:part1",
                                                 f"{model}:part1"))
    with pytest.raises(SystemExit, match=message):
        cli.main(["-s", ALN, "-q", str(nex), "-m", "GTR+G", "-te", TREE,
                  "--device", "cpu", "--quiet", "-pre", str(tmp_path / "x")])
