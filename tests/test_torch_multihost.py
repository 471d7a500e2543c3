"""The port's distributed search (parallel/multihost.py) on the CPU in
float64: one rank against the JAX package's DistributedSearch, two ranks
(spawned, over FileGossip and over TorchGossip on a gloo group) against
one, the UFBoot replicate slices, and a resume of dist_search.finished.

The size is tests/test_multihost.py's: 8 taxa, 64 sites (seed 2),
n_init_trees=6, n_rounds=2, round_size=4, with a 40-replicate UFBoot.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.parallel import multihost as jmultihost
from iqtree2_tpu.search.ufboot import UFBoot as JUFBoot
from iqtree2_tpu_torch import analysis, cli, kernelcheck
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.parallel.multihost import DistributedSearch, FileGossip
from iqtree2_tpu_torch.search.ufboot import UFBoot
from iqtree2_tpu_torch.tree.topology import Tree
from iqtree2_tpu_torch.utils.checkpoint import Checkpoint
from tests.torch_parity import simulate_both
from tests.torch_ranks import (BOOT_REPLICATES, RANK_TIMEOUT, SEARCH_KW,
                               run_ranks, search_problem, search_rank,
                               search_result, several)

TRANSPORTS = ("file", "torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The port's search on one rank (this process)."""
    aln, eng = search_problem()
    gossip = FileGossip(tmp_path_factory.mktemp("one"), 0, 1,
                        timeout=RANK_TIMEOUT)
    return search_result(eng, aln, gossip, 0, 1)


def test_one_rank_matches_jax(tmp_path, one_rank):
    """The same problem in both packages (tests/torch_parity.py): the same
    tree (topology id), logL within 1e-6 (ROADMAP's search tolerance) and
    the same UFBoot champions."""
    _, (jaln, _, jmodel, jrates) = simulate_both("GTR+G4", 8, 64, 2)
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    juf = JUFBoot(jaln, n_replicates=BOOT_REPLICATES, seed=3)
    jtree, jlogL = jmultihost.DistributedSearch(
        jeng, jaln, jmultihost.FileGossip(tmp_path, 0, 1, timeout=60), 0, 1,
        ufboot=juf, **SEARCH_KW).run()
    assert one_rank["tid"] == jtree.topology_id()
    assert one_rank["logL"] == pytest.approx(jlogL, abs=1e-6)
    np.testing.assert_allclose(one_rank["boot_logl"], juf.boot_logl,
                               rtol=0, atol=1e-4)
    assert one_rank["boot_trees"] == juf.boot_trees


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each transport's search on two ranks, in turn in one spawn:
    {transport: [rank 0's result, rank 1's]}."""
    root = tmp_path_factory.mktemp("two")
    ranks = run_ranks(several, 2, [(search_rank, (t, str(root / t)))
                                   for t in TRANSPORTS])
    return {t: [r["jobs"][k] for r in ranks]
            for k, t in enumerate(TRANSPORTS)}


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_two_ranks_equal_one_rank(transport, one_rank, two_ranks):
    """Two spawned ranks give one rank's tree and logL (within 1e-9) and,
    every rank scoring every round's trees in iteration order, one rank's
    UFBoot champions."""
    for r in two_ranks[transport]:
        assert r["tid"] == one_rank["tid"]
        assert abs(r["logL"] - one_rank["logL"]) < 1e-9
        np.testing.assert_array_equal(r["boot_logl"], one_rank["boot_logl"])
        assert r["boot_trees"] == one_rank["boot_trees"]


def test_ufboot_replicate_slicing():
    """tests/test_multihost.py's test_ufboot_replicate_slicing on the port:
    each collector RELL-scores its slice alone, and the champion merge of
    the two slices is the full collector."""
    aln, eng = search_problem()
    R = BOOT_REPLICATES
    full = UFBoot(aln, n_replicates=R, seed=3)
    s0 = UFBoot(aln, n_replicates=R, seed=3)
    s1 = UFBoot(aln, n_replicates=R, seed=3)
    s0.set_replicate_slice(0, R // 2)
    s1.set_replicate_slice(R // 2, R)
    rng = np.random.default_rng(0)
    for _ in range(6):
        t = Tree.random_topology(aln.names, rng)
        logL, lp = eng.site_lp(t)
        for uf in (full, s0, s1):
            uf.add_tree(t, lp, tree_logL=logL)
    assert not np.isfinite(s0.boot_logl[R // 2:]).any()
    assert not np.isfinite(s1.boot_logl[: R // 2]).any()
    merged = np.maximum(s0.boot_logl, s1.boot_logl)
    np.testing.assert_allclose(merged, full.boot_logl, rtol=0, atol=1e-6)
    for r in range(R):
        owner = s0 if r < R // 2 else s1
        assert owner.boot_trees[r] == full.boot_trees[r]


def test_resume_runs_neither_fit_nor_search(tmp_path, monkeypatch):
    """A rank whose checkpoint holds dist_search.finished takes its tree
    and UFBoot state: no quick fit, no search; the final fit and the
    outputs follow."""
    aln, tree, model, rates = kernelcheck.simulate("GTR+G4", 8, 64, seed=2)
    phy, _ = kernelcheck.write_problem(aln, tree, tmp_path / "p")
    prefix = tmp_path / "r"
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")
    uf = UFBoot(aln, n_replicates=20, seed=1)
    uf.add_tree(tree, eng.site_lp(tree)[1])
    ckp = Checkpoint(f"{prefix}.ckp.gz")
    ckp.put("dist_search.finished", {"tree": tree.to_newick(digits=17),
                                     "logL": -1.0})
    ckp.put("search.ufboot", uf.state_dict())
    ckp.dump(force=True)

    def refuse(*a, **kw):
        raise AssertionError("the resume ran a fit or a search")
    monkeypatch.setattr(analysis, "_quick_fit", refuse)
    monkeypatch.setattr(DistributedSearch, "run", refuse)
    assert cli.main(["-s", phy, "-m", "GTR+G", "-bb", "20", "-seed", "1",
                     "--dist-nranks", "2", "--dist-rank", "0", "--dist-dir",
                     str(tmp_path / "gossip"), "--device", "cpu", "-pre",
                     str(prefix), "--quiet"]) == 0
    assert "Distributed search already finished per checkpoint" in \
        (tmp_path / "r.log").read_text()
    got = Tree.from_newick((tmp_path / "r.treefile").read_text(), aln.names)
    assert set(got.splits()) == set(tree.splits())
    assert (tmp_path / "r.ufboot").read_text().splitlines() == \
        [tree.to_newick()] * 20
    assert "Distributed ranks" in (tmp_path / "r.iqtree").read_text()
    assert not (tmp_path / "gossip").exists() or \
        not list((tmp_path / "gossip").iterdir())
