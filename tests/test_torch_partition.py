"""The port's PartitionEngine (partition/engine.py) against the JAX
package's, float64 on the CPU: logLs, site logLs, the joint branch-length
Newton of each linkage, the partition rates, NNI1/NNI5 scores and the
branch tests (the search path is in tests/test_torch_partition_search.py).

Each side reads the same partition file with its own read_partition_spec
(tests/golden/example.nex over example.phy, or kernelcheck.PARTITIONS
supermatrices written as one PHYLIP file per partition, the taxa a
partition lacks left out of its file) and builds its own models from the
same strings. The JAX package's branch tests raise on their candidate
tuple (ROADMAP C1); they are handed the four-row candidate array through a
monkeypatch, as tests/test_torch_supports.py does.
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import tests_branch as jtests_branch
from iqtree2_tpu.data.alignment import Alignment as JAlignment
from iqtree2_tpu.data.superalignment import build_superalignment as jbuild_sa
from iqtree2_tpu.data.superalignment import read_partition_spec as jread_spec
from iqtree2_tpu.engine import LikelihoodEngine as JEngine
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.ops.nni import build_nni_candidates as jbuild_cands
from iqtree2_tpu.partition.engine import PartitionEngine as JPartitionEngine
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import kernelcheck, tests_branch
from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.data.superalignment import (build_superalignment,
                                                   read_partition_spec)
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.ops.nni import build_nni_candidates
from iqtree2_tpu_torch.partition.engine import PartitionEngine
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree

GOLDEN = Path(__file__).parent / "golden"
MODES = ("edge-proportional", "edge-equal", "unlinked")
RATES = (0.5, 2.0, 1.1)      # r_k of the edge-proportional cases


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_partitioned(name: str, ntaxa: int, seed: int, tmp_path) -> str:
    """kernelcheck.PARTITIONS[name] as a partition file of one PHYLIP file
    per partition, each under its simulating model's family (the fixed
    parameters dropped)."""
    sa, _, _, _ = kernelcheck.simulate_partitioned(name, ntaxa, seed)
    return kernelcheck.write_partitioned(
        sa, [re.sub(r"[{][^}]*[}]", "", m) for m in sa.part_models],
        tmp_path)


def engines(nex: str, aln: str = "", mode="edge-proportional",
            model="GTR+G"):
    """(port PartitionEngine, JAX PartitionEngine) of one partition file,
    each partition under its charpartition model or ``model``."""
    out = []
    for read, build, engine, dtype in (
            (read_partition_spec, build_model, PartitionEngine,
             dict(dtype=torch.float64, device="cpu")),
            (jread_spec, jbuild_model, JPartitionEngine,
             dict(dtype=jnp.float64))):
        sa = read(nex, aln)
        built = [build(m or model, p)
                 for m, p in zip(sa.part_models, sa.partitions)]
        eng = engine(sa, [b[0] for b in built], [b[1] for b in built], mode,
                     **dtype)
        if mode == "edge-proportional":
            eng.part_rates[:] = RATES[: eng.K]
        out.append(eng)
    return out


def example_engines(mode="edge-proportional"):
    return engines(str(GOLDEN / "example.nex"), str(GOLDEN / "example.phy"),
                   mode)


def ref_trees(names):
    nwk = (GOLDEN / "ref_tree.nwk").read_text()
    return Tree.from_newick(nwk, names), JTree.from_newick(nwk, names)


def _toy(cls, ntaxa=8, nsites=120, seed=3):
    """tests/test_partition.py's toy alignment, built by ``cls``."""
    rng = np.random.default_rng(seed)
    chars = np.array(list("ACGT"))
    mat = rng.integers(0, 4, size=(ntaxa, nsites))
    return cls.from_sequences([f"t{i}" for i in range(ntaxa)],
                              ["".join(chars[r]) for r in mat],
                              seqtype="DNA")


def test_loglik_matches_jax_and_unpartitioned():
    """tests/test_partition.py:35 on both packages: two halves of one
    alignment under one fixed model, edge-equal, give the unpartitioned
    logL, and the port's equals the JAX package's (1e-9 relative)."""
    model = "HKY{2.0}+F{0.3,0.2,0.2,0.3}"
    out = []
    for A, T, build_sa, build, engine, eng1, dt in (
            (Alignment, Tree, build_superalignment, build_model,
             PartitionEngine, LikelihoodEngine,
             dict(dtype=torch.float64, device="cpu")),
            (JAlignment, JTree, jbuild_sa, jbuild_model, JPartitionEngine,
             JEngine, dict(dtype=jnp.float64))):
        aln = _toy(A)
        tree = T.random_topology(aln.names, np.random.default_rng(0))
        m, r, _ = build(model, aln)
        full = eng1(aln, m, r, **dt).loglik_tree(tree)
        half = aln.nsites // 2
        p1 = aln.subset_sites(np.arange(half))
        p2 = aln.subset_sites(np.arange(half, aln.nsites))
        p1.name, p2.name = "first", "second"
        sa = build_sa([p1, p2])
        built = [build(model, p) for p in sa.partitions]
        peng = engine(sa, [b[0] for b in built], [b[1] for b in built],
                      "edge-equal", **dt)
        out.append((full, peng.loglik_tree(tree), tree.to_newick(digits=17)))
    (full, part, nwk), (jfull, jpart, jnwk) = out
    assert nwk == jnwk
    assert part == pytest.approx(full, rel=1e-9)
    assert part == pytest.approx(jpart, rel=1e-9)
    assert full == pytest.approx(jfull, rel=1e-9)


@pytest.mark.parametrize("name", list(kernelcheck.PARTITIONS))
@pytest.mark.parametrize("mode", MODES)
def test_loglik_and_site_lp_match_jax(name, mode, tmp_path):
    """Short partitions, a partition lacking taxa, protein beside DNA: the
    total logL and the concatenated site logLs (1e-9 relative)."""
    peng, jpeng = engines(write_partitioned(name, 14, 5, tmp_path),
                          mode=mode)
    names = peng.aln.names
    nwk = Tree.random_topology(names, np.random.default_rng(2)).to_newick(
        digits=17)
    logl, lp = peng.site_lp(Tree.from_newick(nwk, names))
    jlogl, jlp = jpeng.site_lp(JTree.from_newick(nwk, names))
    assert logl == pytest.approx(jlogl, rel=1e-9)
    np.testing.assert_allclose(lp, jlp, rtol=1e-9)
    assert lp.shape == (peng.aln.num_patterns,)


@pytest.mark.parametrize("mode", MODES)
def test_optimize_branches_matches_jax(mode):
    peng, jpeng = example_engines(mode)
    tree, jtree = ref_trees(peng.aln.names)
    logl = peng.optimize_branches(tree)
    jlogl = jpeng.optimize_branches(jtree)
    assert logl == pytest.approx(jlogl, abs=1e-6)
    for key, t in tree.blen.items():
        assert t == pytest.approx(jtree.blen[key], abs=1e-6)


def test_optimize_part_rates_matches_jax():
    """The Brent search of each r_k, in log r here and in r in the JAX
    package: the same rates within Brent's tolerance (1e-6), logL within
    1e-6."""
    peng, jpeng = example_engines()
    tree, jtree = ref_trees(peng.aln.names)
    logl = peng.optimize_part_rates(tree)
    jlogl = jpeng.optimize_part_rates(jtree)
    assert logl == pytest.approx(jlogl, abs=1e-6)
    np.testing.assert_allclose(peng.part_rates, jpeng.part_rates, rtol=1e-5)
    assert np.dot(peng._site_w, peng.part_rates) == pytest.approx(1.0)
    for key, t in tree.blen.items():
        assert t == pytest.approx(jtree.blen[key], rel=1e-5)


@pytest.mark.parametrize("mode,nni5", [(m, f) for m in MODES
                                       for f in (False, True)])
def test_nni_scores_match_jax(mode, nni5):
    """Both variants and the baseline of every internal edge, scored jointly
    over the partitions: logLs and lengths within 1e-8 relative; NNI1 also
    the concatenated site logLs."""
    peng, jpeng = example_engines(mode)
    tree, jtree = ref_trees(peng.aln.names)
    sched, jsched = build_schedule(tree), jbuild_schedule(jtree)
    c, jc = build_nni_candidates(tree, sched), jbuild_cands(jtree, jsched)
    ca = np.stack([c.iu, c.iv, c.slot_c, c.edge_id])
    np.testing.assert_array_equal(
        ca, np.stack([jc.iu, jc.iv, jc.slot_c, jc.edge_id]))
    kw = dict(nni5=True) if nni5 else dict(return_site_lp=True)
    out = peng.evaluate_nni_batch(sched, ca, **kw)
    jout = jpeng.evaluate_nni_batch(jsched, jnp.asarray(ca), **kw)
    assert len(out) == len(jout) == 3
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-10)


def test_branch_tests_on_partitions_match_jax(monkeypatch):
    """-alrt/-abayes on a PartitionEngine: the same SH-aLRT counts and
    aBayes within 1e-9 from the same RELL draws."""
    peng, jpeng = example_engines()
    tree, jtree = ref_trees(peng.aln.names)
    br = tests_branch.test_all_branches(peng, tree, n_rell=1000,
                                        rng=np.random.default_rng(5),
                                        do_abayes=True)
    real = jtests_branch.build_nni_candidates

    def cands(t, s):
        c = real(t, s)
        return types.SimpleNamespace(**c._asdict(), slot_a=c.iu,
                                     slot_b=c.iu, has_c2=c.iu, slot_c2=c.iu)

    evaluate = jpeng.evaluate_nni_batch

    def four_rows(sched, arrays, **kw):
        iu, iv, _, _, slot_c, _, _, edge_id = arrays
        return evaluate(sched, jnp.stack([iu, iv, slot_c, edge_id]), **kw)

    monkeypatch.setattr(jtests_branch, "build_nni_candidates", cands)
    monkeypatch.setattr(jpeng, "evaluate_nni_batch", four_rows)
    jbr = jtests_branch.test_all_branches(jpeng, jtree, n_rell=1000,
                                          rng=np.random.default_rng(5),
                                          do_abayes=True)
    assert br.keys() == jbr.keys() and len(br) == 14
    for k, (sh, ab) in br.items():
        assert sh == jbr[k][0] and abs(ab - jbr[k][1]) <= 1e-9
