"""The port's own copies of the JAX package's host modules against the
originals, on the same inputs (files of tests/golden, numpy seeds).

iqtree2_tpu_torch keeps copies of the alignment, model (mixtures, codon
models, the +E error model and their data files included), --mdef YAML
definition, tree-schedule,
parsimony, BIONJ, UFBoot (its replicate slices too), simulation,
optimizer, WH-test, transfer-support, tree-test, constraint-tree,
supermatrix, terrace and symmetry-test modules,
of the partition analysis' host helpers and of the standalone tools'
modules (AliSim's simulator, treeutils, pd, timetree, Sankoff) so that
it imports nothing of iqtree2_tpu; each case builds its inputs twice, once
per package, and the outputs must be equal, bit for bit.
"""

import dataclasses
import types

from pathlib import Path

import numpy as np
import pytest

from iqtree2_tpu.data.alignment import Alignment as JAlignment
from iqtree2_tpu.io.alignment_io import read_alignment as jread_alignment
from iqtree2_tpu.model import mixture as jmixture
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.model.pack import build_model_pack as jbuild_model_pack
from iqtree2_tpu.ops import pars as jpars
from iqtree2_tpu.search.bionj import bionj_tree as jbionj_tree
from iqtree2_tpu.search.ufboot import UFBoot as JUFBoot
from iqtree2_tpu.simulator import simulate_alignment as jsimulate_alignment
from iqtree2_tpu import partition_analysis as jpartition_analysis
from iqtree2_tpu import symtest as jsymtest
from iqtree2_tpu import tbe as jtbe
from iqtree2_tpu import terrace as jterrace
from iqtree2_tpu.data import superalignment as jsuperalignment
from iqtree2_tpu.tree import constraint as jconstraint
from iqtree2_tpu import treetesting as jtreetesting
from iqtree2_tpu import whtest as jwhtest
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu.utils.optimize import brent_minimize as jbrent
from iqtree2_tpu.utils.optimize import lbfgsb_minimize as jlbfgsb
from iqtree2_tpu_torch import (kernelcheck, native, partition_analysis,
                               symtest, tbe, terrace, treetesting, whtest)
from iqtree2_tpu_torch.data import superalignment
from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.io.alignment_io import (read_alignment, write_fasta,
                                               write_phylip)
from iqtree2_tpu_torch.model import mixture
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.pack import build_model_pack
from iqtree2_tpu_torch.ops import pars
from iqtree2_tpu_torch.search.bionj import bionj_tree
from iqtree2_tpu_torch.search.ufboot import UFBoot
from iqtree2_tpu_torch.simulator import simulate_alignment
from iqtree2_tpu_torch.tree import constraint
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree
from iqtree2_tpu_torch.utils.optimize import brent_minimize, lbfgsb_minimize
from tests.torch_parity import both_trees, jax_alignment

GOLDEN = Path(__file__).parent / "golden"


def _both_alignments(name: str, tmp_path):
    """One alignment file read by both packages: the golden PHYLIP file,
    the same written as FASTA, or a simulated protein alignment."""
    if name == "example.phy":
        path = str(GOLDEN / name)
    elif name == "example.fasta":
        path = str(tmp_path / name)
        write_fasta(read_alignment(str(GOLDEN / "example.phy")), path)
    else:
        aln, _, _, _ = kernelcheck.simulate("LG+G4", 9, 150, seed=2)
        path = str(tmp_path / "protein.phy")
        write_phylip(aln, path)
    return read_alignment(path), jread_alignment(path)


@pytest.mark.parametrize("name", ["example.phy", "example.fasta", "protein"])
def test_read_alignment_matches_jax(name, tmp_path):
    aln, jaln = _both_alignments(name, tmp_path)
    assert aln.names == jaln.names
    assert aln.seqtype.name == jaln.seqtype.name
    np.testing.assert_array_equal(aln.patterns, jaln.patterns)
    np.testing.assert_array_equal(aln.pattern_weights, jaln.pattern_weights)
    np.testing.assert_array_equal(aln.site_to_pattern, jaln.site_to_pattern)
    np.testing.assert_array_equal(aln.tip_codes(), jaln.tip_codes())


@pytest.mark.parametrize("model_str", ["JC", "HKY+G4", "GTR+I+G4", "LG+G4"])
def test_model_pack_matches_jax(model_str, tmp_path):
    name = "protein" if model_str.startswith("LG") else "example.phy"
    aln, jaln = _both_alignments(name, tmp_path)
    model, rates, extras = build_model(model_str, aln)
    jmodel, jrates, jextras = jbuild_model(model_str, jaln)
    assert (type(model).__name__, type(rates).__name__, extras) == \
        (type(jmodel).__name__, type(jrates).__name__, jextras)
    pk = build_model_pack(aln, model, rates)
    jpk = jbuild_model_pack(jaln, jmodel, jrates)
    for field in ("eigvals", "U", "V", "W", "sqrt_freqs", "Q", "cat_rate",
                  "cat_weight", "cat_mix", "root_freqs", "tip_table",
                  "log_ptn_invar", "p_invar", "mean_freqs"):
        a, b = getattr(pk, field), getattr(jpk, field)
        if b is None:
            assert a is None, field
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("ntaxa", [8, 33, 80])
def test_schedule_matches_jax(ntaxa):
    names = [f"t{i}" for i in range(ntaxa)]
    tree = Tree.random_topology(names, np.random.default_rng(ntaxa))
    jtree = JTree.random_topology(names, np.random.default_rng(ntaxa))
    assert tree.to_newick(digits=17) == jtree.to_newick(digits=17)
    sched, jsched = build_schedule(tree), jbuild_schedule(jtree)
    for k in ("child_src", "child_edge", "step_node", "edge_src", "blens"):
        np.testing.assert_array_equal(getattr(sched, k), getattr(jsched, k))
    assert sched.edge_nodes == jsched.edge_nodes
    assert sched.postorder_nodes == jsched.postorder_nodes
    assert (sched.n_int, sched.n_edges, sched.root) == \
        (jsched.n_int, jsched.n_edges, jsched.root)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_parsimony_matches_jax(seed):
    """random_stepwise_addition trees from one seed, and their Fitch
    scores."""
    aln = read_alignment(str(GOLDEN / "example.phy"))
    jaln = jread_alignment(str(GOLDEN / "example.phy"))
    t = pars.random_stepwise_addition(aln, np.random.default_rng(seed))
    jt = jpars.random_stepwise_addition(jaln, np.random.default_rng(seed))
    assert t.to_newick(digits=17) == jt.to_newick(digits=17)
    score = pars.fitch_score(t, pars.state_bitmasks(aln),
                             aln.pattern_weights)
    jscore = jpars.fitch_score(jt, jpars.state_bitmasks(jaln),
                               jaln.pattern_weights)
    assert score == jscore


@pytest.mark.parametrize("model_name,ntaxa,nsites", [
    ("GTR+G4", 60, 500), ("LG+G4", 25, 200), ("HKY+I", 9, 100)])
def test_native_stepwise_matches_numpy(model_name, ntaxa, nsites,
                                       monkeypatch):
    """The start tree with the stepwise costs of the host library (uint8
    masks for DNA, uint32 for protein) and of the numpy loop, the JAX
    package's too: the same Newick text."""
    aln = kernelcheck.simulate(model_name, ntaxa, nsites, seed=5)[0]
    assert native.stepwise_costs(pars.state_bitmasks(aln),
                                 aln.pattern_weights, 2 * ntaxa) is not None
    fast = pars.random_stepwise_addition(aln, np.random.default_rng(3))
    monkeypatch.setattr(native, "stepwise_costs", lambda *a: None)
    loop = pars.random_stepwise_addition(aln, np.random.default_rng(3))
    jt = jpars.random_stepwise_addition(jax_alignment(aln),
                                        np.random.default_rng(3))
    assert fast.to_newick(digits=17) == loop.to_newick(digits=17) == \
        jt.to_newick(digits=17)


def test_bionj_matches_jax():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(12, 6))
    D = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    names = [f"t{i}" for i in range(12)]
    assert bionj_tree(D, names).to_newick(digits=17) == \
        jbionj_tree(D, names).to_newick(digits=17)


def test_ufboot_matches_jax():
    """The same trees and site log-likelihoods into both collectors: the
    same replicate champions, supports and consensus."""
    aln = read_alignment(str(GOLDEN / "example.phy"))
    jaln = jread_alignment(str(GOLDEN / "example.phy"))
    uf, juf = UFBoot(aln, n_replicates=50, seed=3), \
        JUFBoot(jaln, n_replicates=50, seed=3)
    rng = np.random.default_rng(6)
    trees = []
    for i in range(6):
        t = pars.random_stepwise_addition(aln, rng)
        t, jt = both_trees(t, aln.names)
        lp = -rng.uniform(5.0, 15.0, aln.num_patterns)
        logL = float(aln.pattern_weights @ lp)
        uf.add_tree(t, lp, tree_logL=logL)
        juf.add_tree(jt, lp, tree_logL=logL)
        trees.append((t, jt))
    np.testing.assert_array_equal(uf.boot_logl, juf.boot_logl)
    assert uf.boot_trees == juf.boot_trees
    assert uf.check_convergence() == juf.check_convergence()
    t, jt = trees[0]
    assert uf.supports_for(t) == juf.supports_for(jt)
    assert uf.consensus_tree().to_newick() == \
        juf.consensus_tree().to_newick()


def test_ufboot_replicate_slices_match_jax():
    """Two replicate slices per package (set_replicate_slice), the same
    trees and site log-likelihoods into each: the same champions per
    slice, -inf outside it."""
    aln = read_alignment(str(GOLDEN / "example.phy"))
    jaln = jread_alignment(str(GOLDEN / "example.phy"))
    R = 50
    ports, jaxes = [], []
    for a, b in ((0, 20), (20, R)):
        uf, juf = UFBoot(aln, n_replicates=R, seed=3), \
            JUFBoot(jaln, n_replicates=R, seed=3)
        uf.set_replicate_slice(a, b)
        juf.set_replicate_slice(a, b)
        ports.append(uf)
        jaxes.append(juf)
    rng = np.random.default_rng(6)
    for i in range(6):
        t, jt = both_trees(pars.random_stepwise_addition(aln, rng),
                           aln.names)
        lp = -rng.uniform(5.0, 15.0, aln.num_patterns)
        logL = float(aln.pattern_weights @ lp)
        for uf, juf in zip(ports, jaxes):
            uf.add_tree(t, lp, tree_logL=logL)
            with np.errstate(invalid="ignore"):
                juf.add_tree(jt, lp, tree_logL=logL)
    for uf, juf in zip(ports, jaxes):
        np.testing.assert_array_equal(uf.boot_logl, juf.boot_logl)
        assert uf.boot_trees == juf.boot_trees
        assert uf.logl_cutoff == juf.logl_cutoff
    assert np.isfinite(ports[0].boot_logl[:20]).all()
    assert not np.isfinite(ports[0].boot_logl[20:]).any()


@pytest.mark.parametrize("model_name", ["GTR+G4", "HKY+I", "LG+G4",
                                        "UNREST+G4"])
def test_simulate_alignment_matches_jax(model_name):
    """kernelcheck's problems come from the port's simulator copy. Under a
    nonreversible model its default P keeps the JAX form, the real parts
    of a complex eigensystem (ROADMAP C18), for parity; kernelcheck
    simulates such a model through expm (simulate_nonrev)."""
    seqtype, alphabet, model_str = kernelcheck.MODELS[model_name]
    names = [f"t{i}" for i in range(7)]
    out = []
    for T, A, bm, sim in ((Tree, Alignment, build_model, simulate_alignment),
                          (JTree, JAlignment, jbuild_model,
                           jsimulate_alignment)):
        rng = np.random.default_rng(4)
        tree = T.random_topology(names, rng)
        dummy = A.from_sequences(names, [alphabet] * 7, seqtype=seqtype)
        model, rates, _ = bm(model_str, dummy)
        out.append(sim(tree, model, rates, 120, rng))
    assert out[0] == out[1]


@pytest.mark.parametrize("name", ["example.phy", "protein"])
def test_divergence_matrix_matches_jax(name, tmp_path):
    aln, jaln = _both_alignments(name, tmp_path)
    for i, j in ((0, 1), (2, 5), (3, 8)):
        np.testing.assert_array_equal(symtest.divergence_matrix(aln, i, j),
                                      jsymtest.divergence_matrix(jaln, i, j))


def test_whtest_matches_jax():
    """Pair estimates, the statistic, and the parametric p-value (the same
    tree, model and seed: the same simulations)."""
    aln, tree, model, rates = kernelcheck.simulate("GTR+G4", 9, 400, seed=6)
    jaln = jax_alignment(aln)
    for i, j in ((0, 1), (4, 7)):
        N = symtest.divergence_matrix(aln, i, j)
        np.testing.assert_array_equal(whtest.pair_q_estimate(N),
                                      jwhtest.pair_q_estimate(N))
    assert whtest.wh_statistic(aln) == jwhtest.wh_statistic(jaln)
    tree, jtree = both_trees(tree, aln.names)
    jmodel, jrates, _ = jbuild_model(kernelcheck.MODELS["GTR+G4"][2], jaln)
    res = whtest.run_whtest(aln, tree, model, rates, n_sim=6, seed=2)
    jres = jwhtest.run_whtest(jaln, jtree, types.SimpleNamespace(
        model=jmodel, rates=jrates), n_sim=6, seed=2)
    assert res == jres


def test_host_optimizers_match_jax():
    def f(x):
        return float(((x - np.array([0.3, 2.0])) ** 2).sum()
                     + 0.1 * np.sin(3 * x).sum())

    lo, hi = np.array([0.0, 0.5]), np.array([1.0, 3.0])
    x, fx = lbfgsb_minimize(f, np.array([0.9, 0.6]), lo, hi)
    jx, jfx = jlbfgsb(f, np.array([0.9, 0.6]), lo, hi)
    np.testing.assert_array_equal(x, jx)
    assert fx == jfx

    def g(v):
        return (v - 0.7) ** 2 + 0.05 * np.cos(9 * v)

    assert brent_minimize(g, 0.0, 2.0, guess=1.0) == \
        jbrent(g, 0.0, 2.0, guess=1.0)


def test_tbe_matches_jax():
    """Transfer distances and supports of random trees against replicates
    drawn the same way (bit for bit: integer products, the same means)."""
    names = [f"t{i}" for i in range(14)]
    rng = np.random.default_rng(8)
    ref, jref = both_trees(Tree.random_topology(names, rng), names)
    reps = [Tree.random_topology(names, rng).to_newick() for _ in range(7)]
    rows, _ = tbe._split_matrix(ref)
    jrows, _ = jtbe._split_matrix(jref)
    np.testing.assert_array_equal(rows, jrows)
    boot, _ = tbe._split_matrix(Tree.from_newick(reps[0], names),
                                include_trivial=True)
    np.testing.assert_array_equal(tbe.transfer_distances(rows, boot),
                                  jtbe.transfer_distances(jrows, boot))
    sup = tbe.tbe_supports(ref, reps, names)
    assert sup == jtbe.tbe_supports(jref, reps, names) and len(sup) == 11


@pytest.mark.parametrize("do_au", [True, False])
def test_evaluate_trees_matches_jax(do_au):
    """The RELL, KH, SH, weighted, ELW and AU statistics of the same site
    log-likelihoods and seed, and the report table they print."""
    rng = np.random.default_rng(11)
    w = rng.integers(1, 6, 60).astype(np.float64)
    lp = -rng.uniform(2.0, 9.0, (4, 60))
    lp[1] = lp[0] + rng.normal(0.0, 0.05, 60)
    res = treetesting.evaluate_trees(lp, w, nboot=2000, do_au=do_au,
                                     rng=np.random.default_rng(3))
    jres = jtreetesting.evaluate_trees(lp, w, nboot=2000, do_au=do_au,
                                       rng=np.random.default_rng(3))
    for f in ("logL", "deltaL", "bp_rell", "p_kh", "p_sh", "p_wkh", "p_wsh",
              "c_elw"):
        np.testing.assert_array_equal(getattr(res, f), getattr(jres, f))
    if do_au:
        np.testing.assert_array_equal(res.p_au, jres.p_au)
    else:
        assert res.p_au is None and jres.p_au is None
    assert treetesting.format_treetest_table(res, alpha=0.05) == \
        jtreetesting.format_treetest_table(jres, alpha=0.05)


CONSTRAINT = "((Frog,Turtle),(Human,Seal),Cow);"


def test_constraint_matches_jax():
    """TopologyConstraint's mask and splits, and its verdict on random
    trees, partial ones (taxa still to be added) included."""
    names = read_alignment(str(GOLDEN / "example.phy")).names
    c = constraint.TopologyConstraint(CONSTRAINT, names)
    jc = jconstraint.TopologyConstraint(CONSTRAINT, names)
    assert c.mask == jc.mask and c.splits == jc.splits and len(c.splits) == 2
    verdicts = []
    for seed in range(30):
        tree = Tree.random_topology(names, np.random.default_rng(seed))
        tree, jtree = both_trees(tree, names)
        verdicts.append(c.compatible(tree))
        assert verdicts[-1] == jc.compatible(jtree)
    assert any(verdicts) and not all(verdicts)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_constrained_stepwise_addition_matches_jax(seed):
    """random_stepwise_addition under -g (the native edge costs, rejected
    edges' node ids past the 2L its scratch was sized for): the JAX
    package's tree, holding the constraint."""
    aln = read_alignment(str(GOLDEN / "example.phy"))
    jaln = jread_alignment(str(GOLDEN / "example.phy"))
    c = constraint.TopologyConstraint(CONSTRAINT, aln.names)
    t = pars.random_stepwise_addition(aln, np.random.default_rng(seed),
                                      constraint=c)
    jt = jpars.random_stepwise_addition(
        jaln, np.random.default_rng(seed),
        constraint=jconstraint.TopologyConstraint(CONSTRAINT, aln.names))
    assert t.to_newick(digits=17) == jt.to_newick(digits=17)
    assert c.compatible(t)


def test_superalignment_matches_jax():
    """read_partition_spec of example.nex, the bootstrap weights of every
    -bsam unit from one generator, expand_to_taxa and a merged
    partition."""
    nex, phy = str(GOLDEN / "example.nex"), str(GOLDEN / "example.phy")
    sa = superalignment.read_partition_spec(nex, phy)
    jsa = jsuperalignment.read_partition_spec(nex, phy)
    assert (sa.names, sa.part_names, sa.part_models) == \
        (jsa.names, jsa.part_names, jsa.part_models)
    assert sa.part_models == ["HKY", "GTR+G", "GTR+G"]
    for p, jp in zip(sa.partitions, jsa.partitions):
        for f in ("patterns", "pattern_weights", "site_to_pattern"):
            np.testing.assert_array_equal(getattr(p, f), getattr(jp, f))
    np.testing.assert_array_equal(sa.site_to_pattern, jsa.site_to_pattern)
    np.testing.assert_array_equal(sa.pattern_offsets(),
                                  jsa.pattern_offsets())
    for spec in ("", "GENE", "GENESITE"):
        np.testing.assert_array_equal(
            sa.bootstrap_pattern_weights(np.random.default_rng(4), 5,
                                         spec=spec),
            jsa.bootstrap_pattern_weights(np.random.default_rng(4), 5,
                                          spec=spec))
    sub = sa.partitions[0].subset_taxa([3, 0, 7])
    jsub = jsa.partitions[0].subset_taxa([3, 0, 7])
    (e, pres), (je, jpres) = (superalignment.expand_to_taxa(sub, sa.names),
                              jsuperalignment.expand_to_taxa(jsub, sa.names))
    np.testing.assert_array_equal(e.patterns, je.patterns)
    np.testing.assert_array_equal(pres, jpres)
    assert pres.sum() == 3
    m = sa.merged_partition([0, 2], "part1+part3")
    jm = jsa.merged_partition([0, 2], "part1+part3")
    np.testing.assert_array_equal(m.patterns, jm.patterns)
    np.testing.assert_array_equal(m.pattern_weights, jm.pattern_weights)


def test_bootstrap_alignment_site_map_repaired():
    """Alignment.bootstrap_alignment draws the JAX package's patterns and
    weights; its site map indexes the kept patterns, where the JAX copy's
    runs past them (ROADMAP C9)."""
    aln = read_alignment(str(GOLDEN / "example.phy"))
    jaln = jread_alignment(str(GOLDEN / "example.phy"))
    b = aln.bootstrap_alignment(np.random.default_rng(5))
    jb = jaln.bootstrap_alignment(np.random.default_rng(5))
    np.testing.assert_array_equal(b.patterns, jb.patterns)
    np.testing.assert_array_equal(b.pattern_weights, jb.pattern_weights)
    assert b.expand_to_sites().shape == (aln.nsites, aln.ntaxa)
    np.testing.assert_array_equal(np.bincount(b.site_to_pattern),
                                  b.pattern_weights)
    with pytest.raises(IndexError):
        jb.expand_to_sites()


def test_terrace_matches_jax():
    """Induced fingerprints, the NNI terrace check, the capped enumeration
    and the exact count over partitions that lack taxa."""
    names = [f"t{i}" for i in range(10)]
    sets = [set(range(10)), {0, 1, 2, 3, 4, 5}, {0, 4, 5, 6, 7, 8, 9}]
    for seed in range(4):
        tree, jtree = both_trees(
            Tree.random_topology(names, np.random.default_rng(seed)), names)
        assert terrace.induced_fingerprint(tree, sets[1:]) == \
            jterrace.induced_fingerprint(jtree, sets[1:])
        assert terrace.check_terrace(tree, sets[1:]) == \
            jterrace.check_terrace(jtree, sets[1:])
        assert terrace.enumerate_terrace(tree, sets[1:], cap=50) == \
            jterrace.enumerate_terrace(jtree, sets[1:], cap=50)
        count = terrace.count_terrace_exact(tree, sets[1:])
        assert count == jterrace.count_terrace_exact(jtree, sets[1:])
        assert count > 1
        assert terrace.count_terrace_exact(tree, sets) == 1
    sa = superalignment.build_superalignment(
        [read_alignment(str(GOLDEN / "example.phy")).subset_taxa(ix)
         for ix in ([0, 1, 2, 3, 4], [0, 5, 6, 7, 8])])
    assert terrace.coverage_taxa_sets(sa) == [{0, 1, 2, 3, 4},
                                              {0, 5, 6, 7, 8}]


@pytest.mark.parametrize("name", ["example.phy", "protein"])
def test_symtest_matches_jax(name, tmp_path):
    """pair_symtest on every pair, run_symtest's maximum-divergence pair and
    the .symtest.csv they write."""
    aln, jaln = _both_alignments(name, tmp_path)
    for i, j in ((0, 1), (2, 5), (3, 4)):
        N = symtest.divergence_matrix(aln, i, j)
        np.testing.assert_equal(
            dataclasses.astuple(symtest.pair_symtest(N, (i, j))),
            dataclasses.astuple(jsymtest.pair_symtest(N, (i, j))))
    res, jres = symtest.run_symtest(aln), jsymtest.run_symtest(jaln)
    np.testing.assert_equal(dataclasses.astuple(res),
                            dataclasses.astuple(jres))
    symtest.write_symtest_csv(str(tmp_path / "a.csv"), [("aln", res)])
    jsymtest.write_symtest_csv(str(tmp_path / "b.csv"), [("aln", jres)])
    assert (tmp_path / "a.csv").read_text() == \
        (tmp_path / "b.csv").read_text()


def test_partition_analysis_helpers_match_jax(tmp_path):
    """The merges' one-dimensional k-means and pooled scores, and
    .best_scheme.nex."""
    rng = np.random.default_rng(8)
    x, w = rng.uniform(0.1, 3.0, 9), rng.integers(100, 900, 9).astype(float)
    for k in (1, 2, 3, 5, 9):
        assert partition_analysis._kmeans_1d(x, w, k) == \
            jpartition_analysis._kmeans_1d(x, w, k)
    rows = [{"logL": -rng.uniform(1e3, 5e3), "df": int(rng.integers(1, 40))}
            for _ in range(4)]
    for crit in ("AIC", "AICc", "BIC"):
        assert partition_analysis._pooled_score(rows, 2000, crit) == \
            jpartition_analysis._pooled_score(rows, 2000, crit)
    nex, phy = str(GOLDEN / "example.nex"), str(GOLDEN / "example.phy")
    models = ["TIM2+G", "HKY+I", "GTR+F+R2"]
    partition_analysis.write_best_scheme(
        tmp_path / "a.nex", superalignment.read_partition_spec(nex, phy),
        models)
    jpartition_analysis.write_best_scheme(
        tmp_path / "b.nex", jsuperalignment.read_partition_spec(nex, phy),
        models)
    assert (tmp_path / "a.nex").read_text() == \
        (tmp_path / "b.nex").read_text()


def test_mixture_data_files_are_copies():
    """model/data's mixture definitions, byte for byte."""
    for name in ("mixture_models.npz", "mixture_defs.json"):
        port = Path(mixture.__file__).parent / "data" / name
        ref = Path(jmixture.__file__).parent / "data" / name
        assert port.read_bytes() == ref.read_bytes(), name


@pytest.mark.parametrize("name", ["C60", "LG4X", "EX_EHO", "CF4", "UL2"])
def test_make_mixture_matches_jax(name, tmp_path):
    """model/mixture.py's constructors: the same components, weights and
    flags (CF4's empirical class from the alignment)."""
    aln, jaln = _both_alignments("protein", tmp_path)
    m, jm = mixture.make_mixture(name, aln), jmixture.make_mixture(name, jaln)
    assert (m.name, m.optimize_weights, m.fused_rates) == \
        (jm.name, jm.optimize_weights, jm.fused_rates)
    np.testing.assert_array_equal(m.weights, jm.weights)
    assert len(m.components) == len(jm.components)
    for a, b in zip(m.components, jm.components):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(m.get_params(), jm.get_params())


def test_opt_profile_names_repaired():
    """C10OPT and C20OPT: the JAX package looks up name.upper() in a file
    that spells C10Opt and refuses them (ROADMAP C14); the port finds them,
    with free weights and the C10/C20 profiles."""
    with pytest.raises(ValueError, match="unknown mixture"):
        jmixture.make_mixture("C10OPT")
    for name, fixed in (("C10OPT", "C10"), ("C20OPT", "C20")):
        m = mixture.make_mixture(name)
        assert m.optimize_weights and len(m.get_params()) == \
            len(m.components) - 1
        ref = mixture.make_mixture(fixed)
        for a, b in zip(m.components, ref.components):
            np.testing.assert_array_equal(a[1], b[1])


def _codon_alignments(gid: int):
    """A small codon alignment of genetic code ``gid`` (random sense
    codons, a gap), on both sides."""
    from iqtree2_tpu_torch.model.codon import sense_codons
    rng = np.random.default_rng(gid)
    codons = sense_codons(gid)
    names = [f"t{i}" for i in range(5)]
    seqs = ["".join(rng.choice(codons, 30)) + "---" for _ in names]
    aln = Alignment.from_sequences(names, seqs, seqtype=f"CODON{gid}")
    return aln, jax_alignment(aln)


@pytest.mark.parametrize("gid", [1, 2])
def test_codon_models_match_jax(gid):
    """model/codon.py: the single-step pairs, the counted frequencies of
    every mode, and per model name and frequency mode the
    exchangeabilities, frequencies and eigensystem, numpy to numpy, on the
    standard code and the vertebrate mitochondrial one (60 sense codons);
    the empirical models (standard code only) with their published or
    counted frequencies."""
    from iqtree2_tpu.model import codon as jcodon
    from iqtree2_tpu_torch.model import codon
    aln, jaln = _codon_alignments(gid)
    assert aln.num_states == (61 if gid == 1 else 60)
    np.testing.assert_array_equal(codon.codon_pair_info(gid),
                                  jcodon.codon_pair_info(gid))
    for mode in ("F", "F1X4", "F3X4", "FQ"):
        np.testing.assert_array_equal(codon.count_codon_freqs(aln, mode),
                                      jcodon.count_codon_freqs(jaln, mode))
    built = [(f"{n}{{2.0,0.3}}{f}", True)
             for n in ("GY", "MG", "MGK", "GY1KTS", "GY1KTV", "GY2K")
             for f in ("", "+F", "+F1X4", "+F3X4", "+FQ")]
    built += [(f"{n}{f}", gid == 1) for n in ("KOSI07", "ECM", "ECMREST",
                                              "SCHN05", "ECMS05")
              for f in ("", "+F", "+FQ")]
    for spec, ok in built:
        if not ok:
            for build, a in ((build_model, aln), (jbuild_model, jaln)):
                with pytest.raises(ValueError, match="standard genetic"):
                    build(spec, a)
            continue
        m, _, _ = build_model(spec, aln)
        jm, _, _ = jbuild_model(spec, jaln)
        assert (type(m).__name__, m.name, m.freq_type) == \
            (type(jm).__name__, jm.name, jm.freq_type), spec
        exch = m._exch() if hasattr(m, "_exch") else m._exch_full
        jexch = jm._exch() if hasattr(jm, "_exch") else jm._exch_full
        np.testing.assert_array_equal(exch, jexch)
        np.testing.assert_array_equal(m.freqs, jm.freqs)
        e, je = m.get_eigensystem(), jm.get_eigensystem()
        for f in ("eigvals", "U", "V", "W", "freqs", "mix_weights"):
            np.testing.assert_array_equal(getattr(e, f), getattr(je, f),
                                          err_msg=f"{spec} {f}")
        np.testing.assert_array_equal(m.get_params(), jm.get_params())
        for a, b in zip(m.param_bounds(), jm.param_bounds()):
            np.testing.assert_array_equal(a, b)


def test_codon_data_file_is_a_copy():
    """model/data/codon_ecm.npz (KOSI07, ECMREST, SCHN05), byte for
    byte."""
    from iqtree2_tpu.model import codon as jcodon
    from iqtree2_tpu_torch.model import codon
    port = Path(codon.__file__).parent / "data" / "codon_ecm.npz"
    ref = Path(jcodon.__file__).parent / "data" / "codon_ecm.npz"
    assert port.read_bytes() == ref.read_bytes()


def test_codon_writers_and_simulator():
    """The port writes codon alignments as triplets (the JAX package's
    writers give each codon one '?') and its simulator spells codon
    states as their triplets (the JAX package's fails on codon models):
    a simulated codon alignment written as PHYLIP and FASTA reads back
    the same."""
    import tempfile
    from iqtree2_tpu_torch.model.codon import sense_codons
    aln, _, _, _ = kernelcheck.simulate("GY+F3X4+G4", 5, 40, seed=1)
    assert sense_codons(1)[:4] == ["TTT", "TTC", "TTA", "TTG"]
    with tempfile.TemporaryDirectory() as d:
        for write in (write_phylip, write_fasta):
            path = f"{d}/c.{write.__name__}"
            write(aln, path)
            back = read_alignment(path, seqtype="CODON")
            np.testing.assert_array_equal(back.expand_to_sites(),
                                          aln.expand_to_sites())


@pytest.mark.parametrize("kind", ["E", "EA", "EC", "EG", "ET"])
def test_seqerror_model_matches_jax(kind):
    """model/seqerror.py: name, parameters, bounds, the clipped epsilon
    and the tip rows of every DNA code at three epsilons."""
    aln, jaln = _both_alignments("example.phy", None)
    for spec in (f"HKY+{kind}", f"GTR+{kind}{{0.02}}"):
        m, _, _ = build_model(spec, aln)
        jm, _, _ = jbuild_model(spec, jaln)
        assert (m.name, m.error_base, m.fix_epsilon) == \
            (jm.name, jm.error_base, jm.fix_epsilon)
        np.testing.assert_array_equal(m.get_params(), jm.get_params())
        for a, b in zip(m.param_bounds(), jm.param_bounds()):
            np.testing.assert_array_equal(a, b)
        for eps in (1e-5, 0.02, 0.7):
            x = np.concatenate([m.get_params()[:-1], [eps]]) \
                if not m.fix_epsilon else m.get_params()
            m.set_params(x)
            jm.set_params(x)
            assert m.epsilon == jm.epsilon
            table = aln.seqtype.tip_table
            np.testing.assert_array_equal(m.transform_tip_table(table),
                                          jm.transform_tip_table(table))


def test_yaml_datatypes_and_models_match_jax(tmp_path):
    """io/yamlmodels.py: the datatype built from a definition with
    ambiguity codes and missing characters, found by get_seqtype, and the
    reversible models built from definitions (rates, frequencies,
    fix_rates), as the JAX package builds them."""
    from iqtree2_tpu.data import seqtypes as jseqtypes
    from iqtree2_tpu.io import yamlmodels as jyaml
    from iqtree2_tpu_torch.data import seqtypes
    from iqtree2_tpu_torch.io import yamlmodels
    doc = ("- datatype: HOSTABC\n  state: [A, B, C, D]\n  missing: '?'\n"
           "  equate: {X: [A, B], Z: [B, C, D]}\n"
           "- model: HOSTM1\n  datatype: HOSTABC\n"
           "  rates: [1, 2, 3, 4, 5, 6]\n"
           "- model: HOSTM2\n  datatype: HOSTABC\n"
           "  frequencies: [1, 2, 3, 4]\n  fix_rates: false\n")
    path = tmp_path / "d.yml"
    path.write_text(doc)
    assert yamlmodels.load_definitions(str(path)) == \
        jyaml.load_definitions(str(path))
    st, jst = seqtypes.get_seqtype("hostabc"), jseqtypes.get_seqtype(
        "hostabc")
    np.testing.assert_array_equal(st.tip_table, jst.tip_table)
    np.testing.assert_array_equal(st.char_to_code, jst.char_to_code)
    assert (st.unknown_code, st.state_chars) == \
        (jst.unknown_code, jst.state_chars)
    aln = Alignment.from_sequences(["a", "b", "c"],
                                   ["ABXZ?", "DCBA?", "ZZAB?"],
                                   seqtype="HOSTABC")
    jaln = jax_alignment(aln)
    for name in ("HOSTM1+G4", "HOSTM2"):
        m, r, _ = build_model(name, aln)
        jm, jr, _ = jbuild_model(name, jaln)
        assert (m.name, m.freq_type, m.fixed_rates) == \
            (jm.name, jm.freq_type, jm.fixed_rates)
        np.testing.assert_array_equal(m.exch_rates, jm.exch_rates)
        np.testing.assert_array_equal(m.freqs, jm.freqs)
        np.testing.assert_array_equal(r.category_rates(),
                                      jr.category_rates())


@pytest.mark.parametrize("spec", ["UNREST", "UNREST{" + ",".join(
    str(r) for r in kernelcheck._UNREST_RATES) + "}", "12.12", "RY3.3b",
    "WS6.7a{0.1,-0.2,0.3,0.4,-0.5}", "STRSYM", "GTR+P", "HKY+P5{0.02}"])
def test_nonreversible_models_match_jax(spec):
    """model/nonrev.py, model/liemarkov.py and model/pomo.py: names,
    parameters, bounds, the rate matrix, the stationary frequencies and
    the eigensystem (real parts of a complex one, ROADMAP C18, kept as
    the JAX package has them: the simulator's default P reads them), and
    PoMo's sampled-read tips, after setting moved parameters."""
    aln, jaln = _both_alignments("example.phy", None)
    m, _, ex = build_model(spec, aln)
    jm, _, jex = jbuild_model(spec, jaln)
    assert (type(m).__name__, m.name, ex) == (type(jm).__name__, jm.name,
                                              jex)
    x = m.get_params()
    np.testing.assert_array_equal(x, jm.get_params())
    for a, b in zip(m.param_bounds(), jm.param_bounds()):
        np.testing.assert_array_equal(a, b)
    lo, hi = m.param_bounds()
    x = lo + (hi - lo) * np.linspace(0.2, 0.7, len(x))
    m.set_params(x)
    jm.set_params(x)
    e, je = m.get_eigensystem(), jm.get_eigensystem()
    for f in ("eigvals", "U", "V", "freqs", "Q"):
        np.testing.assert_array_equal(getattr(e, f), getattr(je, f))
    assert m.num_free_params() == jm.num_free_params()
    assert m.is_reversible() is jm.is_reversible() is False
    if hasattr(m, "transform_tip_table"):
        table = aln.seqtype.tip_table
        np.testing.assert_array_equal(m.transform_tip_table(table),
                                      jm.transform_tip_table(table))


def test_roottest_helpers_match_jax(tmp_path):
    """roottest.py: the rooted alignment, every rooting's tree and Newick,
    the clade labels, and the .roottest.csv of one result."""
    from iqtree2_tpu import roottest as jroottest
    from iqtree2_tpu_torch import roottest
    aln, jaln = _both_alignments("example.phy", None)
    nwk = (Path(__file__).parent / "golden" / "ref_tree.nwk").read_text()
    tree, jtree = Tree.from_newick(nwk, aln.names), JTree.from_newick(
        nwk, jaln.names)
    ra, jra = roottest.root_alignment(aln), jroottest.root_alignment(jaln)
    assert ra.names == jra.names and ra.names[0] == "__ROOT__"
    np.testing.assert_array_equal(ra.patterns, jra.patterns)
    for a, b in sorted(tree.edges())[:6]:
        assert roottest.rooted_tree_on_branch(tree, a, b, 0.3).to_newick() \
            == jroottest.rooted_tree_on_branch(jtree, a, b, 0.3).to_newick()
        assert roottest.rooted_newick(tree, a, b) == \
            jroottest.rooted_newick(jtree, a, b)
        assert roottest._branch_label(tree, a, b) == \
            jroottest._branch_label(jtree, a, b)
    rng = np.random.default_rng(1)
    L = rng.normal(-3.0, 0.5, (5, 40))
    w = rng.integers(1, 4, 40).astype(float)
    res = [mod.RootTestResult(
        branches=[(0, 1)] * 5, labels=[f"{{t{i}}}" for i in range(5)],
        logL=L @ w, site_lp=L, rootstrap=np.full(5, 0.2),
        tests=ev(L, w, nboot=1000, rng=np.random.default_rng(2)), best=0)
        for mod, ev in ((roottest, treetesting.evaluate_trees),
                        (jroottest, jtreetesting.evaluate_trees))]
    roottest.write_roottest_csv(tmp_path / "a.csv", res[0])
    jroottest.write_roottest_csv(tmp_path / "b.csv", res[1])
    assert (tmp_path / "a.csv").read_text() == \
        (tmp_path / "b.csv").read_text()


def _standalone_case(module: str, tmp_path) -> tuple:
    """(port's output, JAX package's output) of one copied standalone-tool
    module on the same plain inputs."""
    import iqtree2_tpu.pd as jpd
    import iqtree2_tpu.simulator as jsim
    import iqtree2_tpu.timetree as jtimetree
    import iqtree2_tpu.treeutils as jtreeutils
    from iqtree2_tpu_torch import pd, simulator, timetree, treeutils
    nwk = (GOLDEN / "ref_tree.nwk").read_text()
    t, jt = Tree.from_newick(nwk), JTree.from_newick(nwk)
    if module == "simulator":
        out = []
        for T, A, bm, sim in ((Tree, Alignment, build_model, simulator),
                              (JTree, JAlignment, jbuild_model, jsim)):
            tree = T.from_newick(nwk)
            dummy = A.from_sequences(tree.taxon_names,
                                     ["ACGT"] * tree.ntaxa, seqtype="DNA")
            model, rates, _ = bm("HKY+G", dummy)
            seqs = sim.simulate_alignment_indel(
                tree, model, rates, 80, np.random.default_rng(3), 0.1, 0.1)
            path = tmp_path / f"{len(out)}.fa"
            sim.write_fasta(path, seqs)
            out.append(path.read_text())
        return tuple(out)
    if module == "treeutils":
        return tuple((m.random_tree(9, "uniform", np.random.default_rng(2))
                      .to_newick(), m.rf_distance(x, x), m.max_rf(x))
                     for m, x in ((treeutils, t), (jtreeutils, jt)))
    if module == "pd":
        return tuple((m.greedy_pd(x, 4), m.budget_pd(x, 3.0, {}))
                     for m, x in ((pd, t), (jpd, jt)))
    if module == "timetree":
        tips = {i: 2000.0 + 3 * i for i in range(t.ntaxa)}
        return tuple((m.date_tree(x, tips)[:2], m.midpoint_root(x))
                     for m, x in ((timetree, t), (jtimetree, jt)))
    aln = read_alignment(str(GOLDEN / "example.phy"))
    jaln = jread_alignment(str(GOLDEN / "example.phy"))
    cost = 1.0 - np.eye(4)
    return (pars.sankoff_score(Tree.from_newick(nwk, aln.names),
                               aln.tip_codes(), aln.pattern_weights, cost,
                               aln.seqtype.tip_table),
            jpars.sankoff_score(JTree.from_newick(nwk, jaln.names),
                                jaln.tip_codes(), jaln.pattern_weights, cost,
                                jaln.seqtype.tip_table))


@pytest.mark.parametrize("module", ["simulator", "treeutils", "pd",
                                    "timetree", "pars"])
def test_standalone_tool_modules_match_jax(module, tmp_path):
    """The copies the standalone tools run (tests/test_torch_alisim.py,
    test_torch_treetools.py, test_torch_pd.py, test_torch_timetree.py and
    test_torch_quartet.py hold them through the command lines)."""
    port, jax = _standalone_case(module, tmp_path)
    assert port == jax
