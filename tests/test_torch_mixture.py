"""Mixture models on the port against the JAX package, float64 on the CPU.

Each side builds its own problem from the same plain inputs
(tests/torch_parity.py; mixtures are simulated class by class,
kernelcheck.simulate_mixture): the eigensystems and model packs of the
named, base+profile and MIX{...} mixtures; at M > 1 classes the passes,
theta (both passes' and the Newton round's theta_pass), the Newton
derivatives, the site log-likelihoods and NNI5 scoring (1e-9 relative);
the host alternation's fitted MIX weights; -wspm's class posteriors and
the report of a -te run through both analyses; and the tree search, the
JAX side handed the port's start-tree distances (ROADMAP C13).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import analysis as janalysis
from iqtree2_tpu import engine as jengine
from iqtree2_tpu.model import jaxfit
from iqtree2_tpu.model import optimize as jopt
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.model.pack import build_model_pack as jbuild_model_pack
from iqtree2_tpu.ops import pruning as jpr
from iqtree2_tpu.params import Params as JParams
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu_torch import analysis, kernelcheck
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model import optimize as topt
from iqtree2_tpu_torch.model import torchfit
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.pack import build_model_pack
from iqtree2_tpu_torch.ops import nni as tnni
from iqtree2_tpu_torch.ops import pruning as tpr
from iqtree2_tpu_torch.params import Params
from iqtree2_tpu_torch.tree.schedule import build_schedule
from tests.torch_parity import jax_alignment, simulate_both

RTOL = 1e-9
# M > 1 mixtures at about 6 taxa x 80 sites: a profile mixture (C = 80),
# LG4X (four classes fused with four FreeRate categories) and MIX{...}
LIKELIHOOD_MODELS = ("LG+C20+G4", "LG4X", "MIX{LG,WAG}+G4")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("model_str", [
    "C10", "C20", "LG+C60", "LG4M", "LG4X", "EX2", "EHO", "UL3",
    "MIX{LG,WAG}"])
def test_mixture_pack_matches_jax(model_str):
    """Eigensystems and model packs of the named, base+profile and MIX
    mixtures, equal to the bit (host numpy in both packages)."""
    aln, _, _, _ = kernelcheck.simulate("LG+G4", 6, 80, seed=3)
    jaln = jax_alignment(aln)
    model, rates, _ = build_model(model_str, aln)
    jmodel, jrates, _ = jbuild_model(model_str, jaln)
    assert type(rates).__name__ == type(jrates).__name__
    assert model.name == jmodel.name
    assert model.optimize_weights == jmodel.optimize_weights
    eig, jeig = model.get_eigensystem(), jmodel.get_eigensystem()
    for f in ("eigvals", "U", "V", "W", "freqs", "mix_weights"):
        np.testing.assert_array_equal(getattr(eig, f), getattr(jeig, f))
    pk = build_model_pack(aln, model, rates)
    jpk = jbuild_model_pack(jaln, jmodel, jrates)
    for f in ("eigvals", "U", "V", "cat_rate", "cat_weight", "cat_mix",
              "root_freqs", "log_ptn_invar", "mean_freqs"):
        np.testing.assert_array_equal(getattr(pk, f), getattr(jpk, f))


def _both(model_name, ntaxa=6, nsites=80, seed=4):
    """(jax dict, torch dict) of one simulated mixture problem, each from
    its own engine; the torch side takes the JAX side's transition
    tensors."""
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        model_name, ntaxa, nsites, seed)
    eng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    jsched = jbuild_schedule(jtree)
    blens = np.maximum(jsched.blens, 1e-6)
    j = dict(eng=eng, tree=jtree, pack=eng._dev_pack,
             sched=eng.schedule_arrays(jsched), tipP=eng._dev_tipP,
             pw=eng._dev_pw, blens=jnp.asarray(blens))
    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    sched = build_schedule(tree)
    t = dict(eng=teng, tree=tree, pack=teng._pack,
             sched=teng.schedule_arrays(sched), tipP=teng._tipP, pw=teng._pw,
             blens=torch.as_tensor(np.maximum(sched.blens, 1e-6)))
    np.testing.assert_array_equal(t["tipP"].numpy(), np.asarray(j["tipP"]))
    j["P"] = jpr.transition_tensors(j["blens"], j["pack"])
    t["P"] = torch.as_tensor(np.array(j["P"]))
    return j, t


def _theta_close(got, want):
    """theta within RTOL of the largest |theta| of each (edge, pattern)
    column (theta mixes signs), scale counts equal."""
    scale = np.abs(np.asarray(want.theta)).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got.theta.numpy() - np.asarray(want.theta))
            <= RTOL * scale).all()
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("model_name", LIKELIHOOD_MODELS)
def test_mixture_likelihood_matches_jax(model_name):
    """At M > 1 classes, each category with its class's eigensystem
    (cat_mix): transition tensors, both passes, theta of both passes and
    of the Newton round's theta_pass, the branch derivatives and Newton
    step, the site log-likelihoods and logL, to 1e-9 relative."""
    j, t = _both(model_name)
    assert int(t["pack"]["cat_mix"].max()) > 0
    _close(tpr.transition_tensors(t["blens"], t["pack"]), j["P"],
           atol=1e-15)
    jdp = jpr._down_pass_xla(j["P"], j["tipP"], j["sched"])
    tdp = tpr.down_pass(t["P"], t["tipP"], t["sched"])
    _close(tdp.all, jdp.all)
    np.testing.assert_array_equal(tdp.scale.numpy(), np.asarray(jdp.scale))
    jup = jpr._up_pass_xla(j["P"], jdp, j["tipP"], j["sched"],
                           j["pack"]["root_freqs"])
    tup = tpr.up_pass(t["P"], tdp, t["tipP"], t["sched"],
                      t["pack"]["root_freqs"])
    for a, b in zip(tup, jup):
        _close(a, b)
    jth = jpr.edge_thetas(jup, jdp, j["sched"]["edge_src"], j["pack"])
    tth = tpr.edge_thetas(tup, tdp, t["sched"]["edge_src"], t["pack"])
    _theta_close(tth, jth)
    slim = tpr.down_pass(t["P"], t["tipP"], t["sched"], tips=False)
    _theta_close(tpr.theta_pass(t["P"], slim, t["tipP"], t["sched"],
                                t["pack"]), jth)

    li = j["pack"]["log_ptn_invar"]
    jd = jax.vmap(lambda th, sc, tt: jpr.branch_lh_derivs(
        th, sc, tt, j["pack"], li, j["pw"]))(jth.theta, jth.scale,
                                              j["blens"])
    td = tpr.branch_lh_derivs(tth.theta, tth.scale, t["blens"], t["pack"],
                              t["pack"]["log_ptn_invar"], t["pw"])
    for a, b in zip(td, jd):
        _close(a, b)
    jnew = jax.vmap(lambda th, sc, tt: jpr.newton_branch_step(
        th, sc, tt, j["pack"], li, j["pw"], 1e-6, 10.0))(
        jth.theta, jth.scale, j["blens"])
    tnew = tpr.newton_branch_step(tth.theta, tth.scale, t["blens"],
                                  t["pack"], t["pack"]["log_ptn_invar"],
                                  t["pw"], 1e-6, 10.0)
    _close(tnew, jnew)

    jl, jlp = jpr.tree_loglik(j["blens"], j["tipP"], j["sched"], j["pack"],
                              j["pw"], force_xla=True)
    tl, tlp = tpr.tree_loglik(t["blens"], t["tipP"], t["sched"], t["pack"],
                              t["pw"])
    _close(tl, jl)
    _close(tlp, jlp, atol=1e-12)   # padded patterns: lp ~ 1e-16


@pytest.mark.parametrize("model_name", LIKELIHOOD_MODELS)
def test_mixture_nni5_scores_match_jax(model_name):
    """NNI5 scoring (logL, central and five-branch lengths, site logLs)
    through both engines at M > 1, 1e-9 relative."""
    j, t = _both(model_name, seed=6)
    sched = build_schedule(t["tree"])
    cand = tnni.build_nni_candidates(t["tree"], sched)
    ca = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])
    got = t["eng"].evaluate_nni_batch(sched, ca, nni5=True,
                                      return_site_lp=True)
    want = j["eng"].evaluate_nni_batch(jbuild_schedule(j["tree"]),
                                       jnp.asarray(ca), nni5=True,
                                       return_site_lp=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-300)) < RTOL


def test_mix_weights_fit_matches_jax(monkeypatch):
    """MIX{LG,WAG}+G: the joint fit declines a mixture in both packages
    (build_spec), so the host alternation fits the class weights (through
    get_params/set_params) and the Gamma shape with the branch lengths.
    The same code on the same objective: the weights within 1e-4 and the
    logL within 1e-6 of the JAX package's (the alternation tests' +G
    bar, tests/test_torch_fit.py)."""
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        "MIX{LG,WAG}+G4", 6, 120, 8)
    model, rates, _ = build_model("MIX{LG,WAG}+G", aln)
    jmodel, jrates, _ = jbuild_model("MIX{LG,WAG}+G", jaln)
    assert torchfit.build_spec(model, rates) is None
    assert jaxfit.build_spec(jmodel, jrates) is None
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    lt = topt.optimize_model_parameters(eng, tree, epsilon=0.01)
    lj = jopt.optimize_model_parameters(jeng, jtree, epsilon=0.01)
    assert not np.allclose(model.weights, 0.5)     # the weights moved
    np.testing.assert_allclose(model.weights, jmodel.weights, atol=1e-4)
    assert rates.alpha == pytest.approx(jrates.alpha, rel=1e-4)
    assert lt == pytest.approx(lj, abs=1e-6)


def test_class_posteriors_sum_rate_categories():
    """-wspm sums each class's rate categories; one class keeps them."""
    post = np.arange(12.0).reshape(6, 2)
    cat_mix = np.repeat(np.arange(3), 2)
    np.testing.assert_array_equal(analysis.class_posteriors(post, cat_mix),
                                  post.reshape(3, 2, 2).sum(1))
    one = np.zeros(6, np.int32)
    assert analysis.class_posteriors(post, one) is post


def _table(path, skip):
    return np.array([ln.split("\t")[1:] for ln in
                     Path(path).read_text().splitlines()[skip:]], float)


def test_wspm_and_report_match_jax(tmp_path):
    """-m LG+C10+G -te T --f64 -wspm through both analyses: the .siteprob
    of the 10 classes (rows summing to 1), the report's model lines and
    the logL agree with the JAX package's."""
    aln, tree, _, _ = kernelcheck.simulate("LG+C20+G4", 6, 80, seed=2)
    phy, nwk = kernelcheck.write_problem(aln, tree, tmp_path / "p")
    common = dict(aln_file=phy, user_tree=nwk, model="LG+C10+G",
                  use_f64=True, write_site_prob="mixture", verbose=0,
                  no_checkpoint=True, redo=True)
    res = analysis.run_analysis(Params(out_prefix=str(tmp_path / "t"),
                                       **common), device="cpu")
    jres = janalysis.run_analysis(JParams(out_prefix=str(tmp_path / "j"),
                                          **common))
    assert res["logL"] == pytest.approx(jres["logL"], abs=1e-4)
    got, want = _table(tmp_path / "t.siteprob", 1), \
        _table(tmp_path / "j.siteprob", 1)
    assert got.shape == want.shape == (aln.nsites, 10)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-4)
    np.testing.assert_allclose(got, want, atol=2e-5)
    rep = (tmp_path / "t.iqtree").read_text().split("SUBSTITUTION PROCESS")
    jrep = (tmp_path / "j.iqtree").read_text().split("SUBSTITUTION PROCESS")
    model_lines = [ln for ln in rep[1].splitlines()
                   if ln.startswith(("Model of", "  pi("))]
    assert model_lines and model_lines == [
        ln for ln in jrep[1].splitlines()
        if ln.startswith(("Model of", "  pi("))]


def test_mixture_search_matches_jax_given_the_same_distances(monkeypatch):
    """TreeSearch under MIX{LG,WAG}+G4 (fixed parameters) in both
    packages. The JAX package's ML distances take class 0 of a mixture
    (ROADMAP C13), the port's fall back to Hamming-JC: the JAX search is
    handed the same JC distances through a monkeypatch (its module
    unchanged), and both must visit the same trees from the same seed."""
    from iqtree2_tpu.search import search as jsearch
    from iqtree2_tpu_torch.search import search as tsearch

    def refuse(*args, **kw):
        raise NotImplementedError("ML distances under a mixture (C13)")

    monkeypatch.setattr(jsearch, "ml_distances", refuse)
    (aln, _, model, rates), (jaln, _, jmodel, jrates) = simulate_both(
        "MIX{LG,WAG}+G4", 7, 80, 5)
    kw = dict(n_init_trees=6, n_nni_trees=3, pop_size=2, fixed_iterations=2,
              seed=3)
    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    tres = tsearch.TreeSearch(teng, aln, tsearch.SearchParams(**kw),
                              batch_iterations=2).run()
    monkeypatch.setenv("IQTREE2_TPU_SEARCH_BATCH", "2")
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    jres = jsearch.TreeSearch(jeng, jaln, jsearch.SearchParams(**kw)).run()
    assert tres.best_tree.topology_id() == jres.best_tree.topology_id()
    assert tres.best_logL == pytest.approx(jres.best_logL, abs=1e-6)
