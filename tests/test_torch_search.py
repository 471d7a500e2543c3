"""The port's stochastic tree search (search/search.py) vs the JAX package's,
and its checkpoint resume, float64 on the CPU.

The model's parameters are all fixed (kernelcheck.MODELS), so both
searches optimise branch lengths and topology only and must visit the same
trees from the same seed. Each side's problem is built by its own package
(tests/torch_parity.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.search import search as jsearch
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.search import search as tsearch
from iqtree2_tpu_torch.search.ufboot import UFBoot
from iqtree2_tpu_torch.utils.checkpoint import Checkpoint
from tests.torch_parity import simulate_both


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(ntaxa=10, nsites=200, seed=4, name="GTR+G4"):
    """((aln, model, rates) of the port, the same three of the JAX
    package)."""
    (aln, _, model, rates), (jaln, _, jmodel, jrates) = simulate_both(
        name, ntaxa, nsites, seed)
    return (aln, model, rates), (jaln, jmodel, jrates)


def test_tree_search_matches_jax(monkeypatch):
    (aln, model, rates), (jaln, jmodel, jrates) = _problem()
    kw = dict(n_init_trees=10, n_nni_trees=3, pop_size=2,
              fixed_iterations=4, seed=3)
    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    tres = tsearch.TreeSearch(teng, aln, tsearch.SearchParams(**kw),
                              batch_iterations=2).run()
    monkeypatch.setenv("IQTREE2_TPU_SEARCH_BATCH", "2")
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    jres = jsearch.TreeSearch(jeng, jaln, jsearch.SearchParams(**kw)).run()
    assert tres.n_iterations == jres.n_iterations == 4
    assert tres.best_tree.topology_id() == jres.best_tree.topology_id()
    assert tres.best_logL == pytest.approx(jres.best_logL, abs=1e-6)


@pytest.mark.parametrize("k", [0, -3])
def test_batch_iterations_is_validated(k):
    (aln, model, rates), _ = _problem(ntaxa=5, nsites=50)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")
    with pytest.raises(ValueError, match="batch_iterations"):
        tsearch.TreeSearch(eng, aln, batch_iterations=k)


def _search(eng, aln, ckp, ufboot=None, fixed_iterations=8):
    sp = tsearch.SearchParams(n_init_trees=6, n_nni_trees=4, pop_size=2,
                              seed=7, fixed_iterations=fixed_iterations,
                              min_iterations=1)
    return tsearch.TreeSearch(eng, aln, sp, ckp=ckp, ufboot=ufboot)


@pytest.mark.parametrize("with_ufboot", [False, True])
def test_resume_gives_the_uninterrupted_run(tmp_path, with_ufboot):
    """tests/test_checkpoint_search.py on the port: a search stopped after
    one block of 8 iterations and resumed from its checkpoint ends with the
    tree, logL, candidate set and UFBoot state of an uninterrupted run."""
    (aln, model, rates), _ = _problem(ntaxa=8, nsites=100, seed=9)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")

    def boot():
        return UFBoot(aln, n_replicates=50, seed=7) if with_ufboot else None

    uf_full = boot()
    full = _search(eng, aln, None, uf_full, fixed_iterations=16).run()

    path = tmp_path / "s.ckp.gz"
    _search(eng, aln, Checkpoint(path, dump_interval=0.0), boot(),
            fixed_iterations=8).run()
    ckp = Checkpoint(path, dump_interval=0.0)
    ckp.load()
    assert ckp.get("search.iteration") == 8
    uf_res = boot()
    resumed = _search(eng, aln, ckp, uf_res, fixed_iterations=16).run()

    assert resumed.best_tree.topology_id() == full.best_tree.topology_id()
    assert abs(resumed.best_logL - full.best_logL) < 1e-6
    got = [(it.topo_id, round(it.logL, 8)) for it in resumed.candidates.items]
    want = [(it.topo_id, round(it.logL, 8)) for it in full.candidates.items]
    assert got == want
    if with_ufboot:
        np.testing.assert_allclose(uf_res.boot_logl, uf_full.boot_logl,
                                   atol=1e-4)
        assert uf_res.boot_trees == uf_full.boot_trees
