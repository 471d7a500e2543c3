"""The port's branch supports, user-tree tests and per-site outputs against
the JAX package's, float64 on the CPU with one torch thread.

Each side is built by its own package from the same site matrix, model
string and Newick text (tests/torch_parity.py). Pure evaluations
(ancestral and rate-category posteriors, the NNI scores and their site
log-likelihoods) are held to 1e-9 relative; the RELL tests draw the same
multinomials from the same seed, so their counts are equal. The JAX
package's test_all_branches builds candidate arrays from fields its
NNICandidates lacks and raises (ROADMAP C1); here it is handed the
port's four-row array through a monkeypatch, its file unchanged.
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import analysis as janalysis
from iqtree2_tpu import cli as jcli
from iqtree2_tpu import engine as jengine
from iqtree2_tpu import siterates as jsiterates
from iqtree2_tpu import tbe as jtbe
from iqtree2_tpu import tests_branch as jtests_branch
from iqtree2_tpu import treetesting as jtreetesting
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.model.optimize import optimize_model_parameters as jopt
from iqtree2_tpu.params import Params as JParams
from iqtree2_tpu.search.ufboot import UFBoot as JUFBoot
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu_torch import (cli, kernelcheck, siterates, tbe, tests_branch,
                               treetesting)
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io.alignment_io import write_phylip
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.optimize import optimize_model_parameters
from iqtree2_tpu_torch.ops.nni import build_nni_candidates
from iqtree2_tpu_torch.params import Params
from iqtree2_tpu_torch.search.nni import _cand_array
from iqtree2_tpu_torch.search.ufboot import UFBoot
from iqtree2_tpu_torch.tree.schedule import build_schedule
from tests.torch_parity import both_trees, jax_alignment, simulate_both

_BASE = "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}"
RATES = {"GTR+G4": _BASE + "+G{0.6}", "GTR+I+G4": _BASE + "+I{0.2}+G{0.6}",
         "GTR+R3": _BASE + "+R3{0.2,0.3,0.5,1.0,0.3,2.2}"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.fixture(scope="module")
def sim():
    """((aln, tree), (jaln, jtree)): 12 taxa x 400 sites under GTR+G4."""
    (aln, tree, _, _), (jaln, jtree, _, _) = simulate_both("GTR+G4", 12, 400,
                                                           seed=6)
    return (aln, tree), (jaln, jtree)


def _engines(sim, model_str: str, asc: bool = False):
    """(port engine, JAX engine), float64, under one model string."""
    (aln, _), (jaln, _) = sim
    model, rates, _ = build_model(model_str, aln)
    jmodel, jrates, _ = jbuild_model(model_str, jaln)
    return (LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                             device="cpu", asc=asc),
            jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64,
                                     asc=asc))


@pytest.mark.parametrize("name", sorted(RATES))
def test_posteriors_match_jax(sim, name):
    """ancestral_posteriors and site_rate_posterior (engine._asr_jit)."""
    eng, jeng = _engines(sim, RATES[name])
    (_, tree), (_, jtree) = sim
    post, nodes, _ = eng.ancestral_posteriors(tree)
    jpost, jnodes, _ = jeng.ancestral_posteriors(jtree)
    assert nodes == jnodes
    assert post.shape == jpost.shape == (12 - 2, 4, eng.aln.num_patterns)
    assert _rel(post, jpost) < 1e-9
    assert np.allclose(post.sum(1), 1.0, atol=1e-12)
    rate, cat = eng.site_rate_posterior(tree)
    jrate, jcat = jeng.site_rate_posterior(jtree)
    assert _rel(cat, jcat) < 1e-9 and _rel(rate, jrate) < 1e-9


def test_nni_site_lp_matches_jax(sim):
    """evaluate_nni_batch(return_site_lp=True) on the same four-row
    candidates: (logl, t_opt, site logLs [n, 3, P])."""
    eng, jeng = _engines(sim, RATES["GTR+G4"])
    (_, tree), (_, jtree) = sim
    sched = build_schedule(tree)
    cand = _cand_array(build_nni_candidates(tree, sched))
    out = eng.evaluate_nni_batch(sched, cand, return_site_lp=True)
    jout = jeng.evaluate_nni_batch(jbuild_schedule(jtree), jnp.asarray(cand),
                                   return_site_lp=True)
    assert out[2].shape == (len(cand[0]), 3, eng.aln.num_patterns)
    for a, b in zip(out, jout):
        assert _rel(a, b) < 1e-9


def _jax_branch_tests(monkeypatch, jeng, jtree, **kw):
    """The JAX package's test_all_branches, handed the four-row candidate
    array its NNICandidates supports (C1 is in the tuple it builds)."""
    real = jtests_branch.build_nni_candidates

    def cands(tree, sched):
        c = real(tree, sched)
        return types.SimpleNamespace(**c._asdict(), slot_a=c.iu,
                                     slot_b=c.iu, has_c2=c.iu, slot_c2=c.iu)

    evaluate = jeng.evaluate_nni_batch

    def four_rows(sched, arrays, **kw2):
        iu, iv, _, _, slot_c, _, _, edge_id = arrays
        return evaluate(sched, jnp.stack([iu, iv, slot_c, edge_id]), **kw2)

    monkeypatch.setattr(jtests_branch, "build_nni_candidates", cands)
    monkeypatch.setattr(jeng, "evaluate_nni_batch", four_rows)
    return jtests_branch.test_all_branches(jeng, jtree, **kw)


def test_branch_tests_match_jax(sim, monkeypatch):
    """SH-aLRT counts equal (the same RELL draws from the same seed) and
    aBayes within 1e-9 (rounded to 3 decimals, as written), as the JAX
    analysis asks for them: without the local bootstrap or the parametric
    aLRT."""
    eng, jeng = _engines(sim, RATES["GTR+I+G4"])
    (_, tree), (_, jtree) = sim
    kw = dict(n_rell=1000, do_abayes=True)
    br = tests_branch.test_all_branches(eng, tree,
                                        rng=np.random.default_rng(5), **kw)
    jbr = _jax_branch_tests(monkeypatch, jeng, jtree,
                            rng=np.random.default_rng(5), **kw)
    assert br.keys() == jbr.keys() and len(br) == 12 - 3
    for k, (sh, ab) in br.items():
        jsh, jab = jbr[k]
        assert sh == jsh and abs(ab - jab) <= 1e-9


def _boot_sets(sim, n_trees=5):
    """(port UFBoot, JAX UFBoot, port engine, JAX engine) at -bb 100 with
    the same replicate trees: the simulating tree and random NNI moves of
    it, each scored by its own package."""
    eng, jeng = _engines(sim, RATES["GTR+G4"])
    (aln, tree), (jaln, _) = sim
    boot = UFBoot(aln, n_replicates=100, seed=3)
    jboot = JUFBoot(jaln, n_replicates=100, seed=3)
    for i in range(n_trees):
        t = kernelcheck.perturbed(tree, seed=i, strength=0.5)[0] if i \
            else tree.copy()
        t, jt = both_trees(t, aln.names)
        boot.add_tree(t, eng.site_lp(t)[1])
        jboot.add_tree(jt, np.asarray(jeng.site_lp(jt)[1]))
    return boot, jboot, eng, jeng


def test_refine_boot_trees_matches_jax(sim):
    """-bnni at -bb 100: one NNI1 round per replicate under its resampled
    weights; the same replicates improve to the same topologies."""
    boot, jboot, eng, jeng = _boot_sets(sim)
    assert boot.boot_trees == jboot.boot_trees
    n = boot.refine_boot_trees(eng)
    assert n == jboot.refine_boot_trees(jeng) and n > 0
    assert boot.boot_trees == jboot.boot_trees
    assert _rel(boot.boot_logl, jboot.boot_logl) < 1e-9


def test_tbe_supports_match_jax(sim):
    boot, _, _, _ = _boot_sets(sim)
    (aln, tree), (jaln, jtree) = sim
    reps = [boot.trees_newick[t] for t in boot.boot_trees if t is not None]
    sup = tbe.tbe_supports(tree, reps, aln.names)
    assert sup == jtbe.tbe_supports(jtree, reps, jaln.names)
    assert len(sup) == 12 - 3 and all(0 <= v <= 100 for v in sup.values())


def test_site_rates_ml_match_jax(sim):
    """--mlrate: 33 grid log-likelihoods and the parabolic step."""
    eng, jeng = _engines(sim, _BASE)
    (_, tree), (_, jtree) = sim
    rates, lp = siterates.site_rates_ml(eng, tree)
    jrates, jlp = jsiterates.site_rates_ml(jeng, jtree)
    assert _rel(rates, jrates) < 1e-6 and _rel(lp, jlp) < 1e-6


def test_tree_tests_match_jax(sim):
    """-z on three trees with -au: each tree's branch lengths optimised,
    the RELL, KH, SH, weighted and AU tests on the same draws."""
    eng, jeng = _engines(sim, RATES["GTR+G4"])
    (aln, tree), _ = sim
    trees = [tree] + [kernelcheck.perturbed(tree, seed=s, strength=0.5)[0]
                      for s in (1, 2)]
    pairs = [both_trees(t, aln.names) for t in trees]
    kw = dict(topo_test_replicates=1000, do_au_test=True)
    res, opt = treetesting.run_tree_tests(eng, [p[0] for p in pairs],
                                          Params(**kw), log=lambda s: None)
    jres, jopt_trees = jtreetesting.run_tree_tests(
        jeng, [p[1] for p in pairs], JParams(**kw), log=lambda s: None)
    assert _rel(res.logL, jres.logL) < 1e-9
    assert np.abs(res.deltaL - jres.deltaL).max() < 1e-6
    for f in ("bp_rell", "p_kh", "p_sh", "p_wkh", "p_wsh"):
        np.testing.assert_array_equal(getattr(res, f), getattr(jres, f), f)
    assert _rel(res.c_elw, jres.c_elw) < 1e-6
    assert np.abs(res.p_au - jres.p_au).max() < 1e-6
    assert treetesting.format_treetest_table(res) == \
        jtreetesting.format_treetest_table(jres)
    assert [t.to_newick(digits=6) for t in opt] == \
        [t.to_newick(digits=6) for t in jopt_trees]


def test_asc_fit_matches_jax(sim):
    """-m GTR+G+ASC -te on the variable columns: the Lewis correction in
    the engine, fitted by the host alternation (the joint fit declines
    +ASC in both packages)."""
    (aln, tree), _ = sim
    keep = ~aln.is_constant_pattern()[aln.site_to_pattern]
    var = aln.subset_sites(np.nonzero(keep)[0])
    jvar = jax_alignment(var)
    t, jt = both_trees(tree, var.names)
    model, rates, extras = build_model("GTR+G+ASC", var)
    jmodel, jrates, jextras = jbuild_model("GTR+G+ASC", jvar)
    assert extras["asc"] and jextras["asc"]
    lt = optimize_model_parameters(LikelihoodEngine(
        var, model, rates, dtype=torch.float64, device="cpu", asc=True), t)
    lj = jopt(jengine.LikelihoodEngine(jvar, jmodel, jrates,
                                       dtype=jnp.float64, asc=True), jt)
    assert lt == pytest.approx(lj, abs=1e-6)


# ------------------------------------------------------------------- CLI
SEARCH = ["-n", "2", "-ninit", "10", "-ntop", "3", "-nbest", "2", "--f64"]
OUTPUTS = ["-wsl", "-wsr", "-wspr", "--mlrate", "-asr", "-mldist"]


def _numbers(path) -> np.ndarray:
    return np.array([float(x) for x in re.findall(
        r"-?\d+\.\d+(?:e[-+]?\d+)?", Path(path).read_text())])


@pytest.fixture(scope="module")
def cli_runs(sim, tmp_path_factory):
    """The port's and the JAX package's command lines on the simulated
    alignment, with every new flag the JAX package runs."""
    (aln, _), _ = sim
    d = tmp_path_factory.mktemp("cli")
    path = str(d / "sim.phy")
    write_phylip(aln, path)
    argv = ["-s", path, "-m", "GTR+G", "-bb", "100", "-bnni", "--tbe",
            "-o", "t3,t5", "--quiet", "-redo"] + SEARCH + OUTPUTS
    assert cli.main(argv + ["--device", "cpu", "-pre", str(d / "port")]) == 0
    janalysis.run_analysis(jcli.params_from_args(
        jcli.build_parser().parse_args(argv + ["-pre", str(d / "jax")])))
    return d / "port", d / "jax"


@pytest.mark.parametrize("ext,tol", [
    (".treefile", 1e-4), (".contree", 1e-4), (".splits.nex", 1e-4),
    (".sitelh", 1e-4), (".rate", 1e-4), (".siteprob", 1e-4),
    (".mlrate", 1e-4), (".state", 1e-4), (".mldist", 1e-4),
    # the replicate trees keep the lengths the search gave them, under the
    # float32 quick fit's model, whose rounding differs (measured 2.3e-4)
    (".ufboot", 1e-3)])
def test_cli_outputs_match_jax(cli_runs, ext, tol):
    """Every file both command lines write: the same text up to the last
    digits of the printed numbers, within tol relative to max(1, |x|)
    (measured at most 1.3e-5 outside .ufboot, on .mlrate's rates)."""
    port, jax = cli_runs
    a, b = Path(f"{port}{ext}").read_text(), Path(f"{jax}{ext}").read_text()
    num = r"-?\d+\.\d+(?:e[-+]?\d+)?"
    assert re.sub(num, "#", a) == re.sub(num, "#", b)
    x, y = _numbers(f"{port}{ext}"), _numbers(f"{jax}{ext}")
    assert len(x) == len(y)
    assert np.all(np.abs(x - y) <= tol * np.maximum(1.0, np.abs(y)))


def test_cli_report_matches_jax(cli_runs):
    logl = [float(re.search(r"Log-likelihood of the tree: (\S+)",
                            Path(f"{p}.iqtree").read_text()).group(1))
            for p in cli_runs]
    assert logl[0] == pytest.approx(logl[1], abs=1e-3)


def test_cli_branch_tests(sim, tmp_path):
    """-alrt/-abayes beside UFBoot: labels aLRT/aBayes/UFBoot, in range. The
    JAX command line raises on -alrt (C1), so the values are held to the
    JAX functions above."""
    (aln, _), _ = sim
    path = str(tmp_path / "sim.phy")
    write_phylip(aln, path)
    prefix = tmp_path / "sup"
    assert cli.main(["-s", path, "-m", "GTR+G", "-bb", "100", "-alrt",
                     "1000", "-abayes", "--device", "cpu", "-pre",
                     str(prefix), "--quiet"] + SEARCH) == 0
    labels = re.findall(r"\)([^:,();]+)", Path(f"{prefix}.treefile")
                        .read_text())
    assert len(labels) == 12 - 3
    for lab in labels:
        sh, ab, uf = lab.split("/")
        assert 0 <= float(sh) <= 100 and 0 <= float(ab) <= 1
        assert uf.isdigit() and 0 <= int(uf) <= 100


@pytest.fixture(scope="module")
def z_runs(sim, tmp_path_factory):
    """Both command lines with -te (the simulating tree) -z (it and two
    trees moved by random NNIs) -zb 1000 -au, in float64."""
    (aln, tree), _ = sim
    d = tmp_path_factory.mktemp("z")
    path = str(d / "sim.phy")
    write_phylip(aln, path)
    (d / "ref.nwk").write_text(tree.to_newick() + "\n")
    (d / "trees.nwk").write_text("".join(t.to_newick() + "\n" for t in [
        tree] + [kernelcheck.perturbed(tree, seed=s, strength=0.5)[0]
                 for s in (1, 2)]))
    argv = ["-s", path, "-m", "GTR+G", "-te", str(d / "ref.nwk"), "-z",
            str(d / "trees.nwk"), "-zb", "1000", "-au", "--f64", "--quiet"]
    assert cli.main(argv + ["--device", "cpu", "-pre", str(d / "port")]) == 0
    janalysis.run_analysis(jcli.params_from_args(
        jcli.build_parser().parse_args(argv + ["-pre", str(d / "jax")])))
    return d / "port", d / "jax"


@pytest.mark.parametrize("ext", [".trees", ".treelh", ".iqtree"])
def test_cli_user_trees_match_jax(z_runs, ext):
    """-z/-zb/-au: the optimised trees, their logLs and the report's USER
    TREES table (which ranks the simulating tree first) against the JAX
    command line's, numbers within 1e-6 relative to max(1, |x|) and the
    p-values, printed to 3 decimals, equal."""
    port, jax = z_runs
    a, b = Path(f"{port}{ext}").read_text(), Path(f"{jax}{ext}").read_text()
    if ext == ".iqtree":
        a, b = (t.split("USER TREES")[1].split("Total wall-clock")[0]
                for t in (a, b))
        rows = re.findall(r"^(\d)\s+(-\d+\.\d+)\s+(\d+\.\d+)", a, re.M)
        assert len(rows) == 3 and rows[0][2] == "0.0000"
    num = r"-?\d+\.\d+(?:e[-+]?\d+)?"
    assert re.sub(num, "#", a) == re.sub(num, "#", b)
    x = np.array([float(v) for v in re.findall(num, a)])
    y = np.array([float(v) for v in re.findall(num, b)])
    assert len(x) == len(y) > 0
    assert np.all(np.abs(x - y) <= 1e-6 * np.maximum(1.0, np.abs(y)))
