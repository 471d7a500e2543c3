"""The port's partitioned search path against the JAX package's, float64
on the CPU: the NNI climb on a PartitionEngine (the JAX package's unfused
climb step for step), the partition model fit (partition/optimize.py) and
TreeSearch on a PartitionEngine. The engines come from
tests/test_torch_partition.py's set-up (each package reads example.nex with
its own read_partition_spec).
"""

import numpy as np
import pytest
import torch

from iqtree2_tpu.partition.optimize import \
    optimize_partition_parameters as joptimize
from iqtree2_tpu.search import nni as jnni
from iqtree2_tpu.search.search import SearchParams as JSearchParams
from iqtree2_tpu.search.search import TreeSearch as JTreeSearch
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch.partition.optimize import \
    optimize_partition_parameters
from iqtree2_tpu_torch.search import nni
from iqtree2_tpu_torch.search.perturb import random_nnis
from iqtree2_tpu_torch.search.search import SearchParams, TreeSearch
from iqtree2_tpu_torch.tree.topology import Tree
from tests.test_torch_partition import example_engines, ref_trees


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["edge-proportional", "unlinked"])
def test_nni_climb_matches_jax(mode, capsys):
    """search/nni.nni_optimize on a PartitionEngine takes the JAX package's
    unfused climb step for step (NNI5, NNI1 with a NOTE when unlinked):
    the same tree and logL from a tree three random NNIs away."""
    peng, jpeng = example_engines(mode)
    tree, _ = ref_trees(peng.aln.names)
    random_nnis(tree, np.random.default_rng(4), 0.25)
    nwk = tree.to_newick(digits=17)
    t, jt = Tree.from_newick(nwk, tree.taxon_names), JTree.from_newick(
        nwk, tree.taxon_names)
    res, lp = nni.nni_optimize(peng, t, want_lp=True)
    note = capsys.readouterr().out
    jres, jlp = jnni.nni_optimize(jpeng, jt, want_lp=True)
    assert ("NOTE: PartitionEngine scores NNIs on the central branch only"
            in note) == (mode == "unlinked")
    assert t.topology_id() == jt.topology_id()
    assert res.logL == pytest.approx(jres.logL, abs=1e-6)
    assert (res.n_rounds, res.n_applied_total) == (jres.n_rounds,
                                                   jres.n_applied_total)
    np.testing.assert_allclose(lp, jlp, rtol=1e-9)


def test_optimize_partition_parameters_matches_jax():
    """The alternation of per-partition model fits, partition rates and
    branch lengths on the reference tree: logL within 1e-3 (the unlinked
    mode's through the -Q command line, tests/test_torch_partition_cli.py).
    """
    peng, jpeng = example_engines()
    peng.part_rates[:] = jpeng.part_rates[:] = 1.0
    tree, jtree = ref_trees(peng.aln.names)
    logl = optimize_partition_parameters(peng, tree)
    jlogl = joptimize(jpeng, jtree)
    assert logl == pytest.approx(jlogl, abs=1e-3)
    np.testing.assert_allclose(peng.part_rates, jpeng.part_rates, rtol=1e-3)


def test_partitioned_search_matches_jax():
    """TreeSearch on a PartitionEngine (example.nex, the charpartition's
    models at their start values) at -n 1 -ninit 5 -ntop 2 -nbest 2: the
    same best topology and logL within 1e-6, serially as in the JAX
    package."""
    peng, jpeng = example_engines()
    peng.part_rates[:] = jpeng.part_rates[:] = 1.0
    kw = dict(n_init_trees=5, n_nni_trees=2, pop_size=2, fixed_iterations=1,
              seed=1)
    search = TreeSearch(peng, peng.aln, SearchParams(**kw))
    assert search.batch_iterations == 1
    res = search.run()
    jres = JTreeSearch(jpeng, jpeng.aln, JSearchParams(**kw)).run()
    assert res.n_iterations == jres.n_iterations == 1
    assert res.best_tree.topology_id() == jres.best_tree.topology_id()
    assert res.best_logL == pytest.approx(jres.best_logL, abs=1e-6)
