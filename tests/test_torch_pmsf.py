"""PMSF on the port against the JAX package, float64 on the CPU.

The site-specific-frequency functions (ops/sitespecific.py, plain PyTorch
batched per level step) against the JAX module's scans: the per-pattern
eigensystems, both passes and theta (1e-9 of each column's largest value),
the branch derivatives and the Newton step, the site log-likelihoods and
NNI1 scoring (1e-9 relative); the
SSFEngine's fit and the two-pass run_pmsf (the JAX package's tolerances);
and the uniform-profile identity of tests/test_pmsf.py. Each side builds
its problem from the same plain inputs (tests/torch_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.model import pmsf as jpmsf
from iqtree2_tpu.model.rates import RateGamma as JRateGamma
from iqtree2_tpu.ops import sitespecific as jssf
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model import pmsf
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.rates import RateGamma
from iqtree2_tpu_torch.ops import nni as tnni
from iqtree2_tpu_torch.ops import sitespecific as ssf
from iqtree2_tpu_torch.tree.schedule import build_schedule
from tests.torch_parity import simulate_both

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _col_close(got, want):
    """Partials or theta [..., C, S, Pp] within RTOL of the largest |value|
    of each (row, pattern) column: the eigenbasis round trip leaves
    absolute noise of about 1e-16 of that value on its near-zero entries
    (and theta mixes signs)."""
    got, want = np.asarray(got), np.asarray(want)
    col = np.abs(want).max(axis=(-3, -2), keepdims=True)
    assert (np.abs(got - want) <= RTOL * col).all()


@pytest.fixture(scope="module")
def mixture():
    """A 7-taxon x 40-site protein problem (LG+C20+G4, class by class):
    the port's and the JAX package's LG+C10+G4 engines, float64."""
    (aln, tree, _, _), (jaln, jtree, _, _) = simulate_both(
        "LG+C20+G4", 7, 40, 9)
    model, rates, _ = build_model("LG+C10+G4", aln)
    from iqtree2_tpu.model.factory import build_model as jbuild_model
    jmodel, jrates, _ = jbuild_model("LG+C10+G4", jaln)
    return (LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                             device="cpu"), tree,
            jengine.LikelihoodEngine(jaln, jmodel, jrates,
                                     dtype=jnp.float64), jtree)


def _ssf_engines(mixture, alpha=0.7):
    """(port SSFEngine, JAX SSFEngine) on the mixture's posterior-mean
    profile, the LG exchangeabilities and a Gamma shape."""
    eng, tree, jeng, jtree = mixture
    prof = pmsf.site_frequency_profile(eng, tree)
    exch = pmsf._exch_full(eng.model.components[0][0], 20)
    return (pmsf.SSFEngine(eng.aln, exch, prof, RateGamma(4, alpha=alpha),
                           dtype=torch.float64, device="cpu"),
            jpmsf.SSFEngine(jeng.aln, exch, prof, JRateGamma(4, alpha=alpha),
                            dtype=jnp.float64))


def test_ssf_eigensystems_match_jax(mixture):
    eng, tree, _, _ = mixture
    prof = pmsf.site_frequency_profile(eng, tree)
    exch = pmsf._exch_full(eng.model.components[0][0], 20)
    for a, b in zip(ssf.build_ssf_eigensystems(exch, prof),
                    jssf.build_ssf_eigensystems(exch, prof)):
        np.testing.assert_array_equal(a, b)


def test_ssf_passes_and_derivatives_match_jax(mixture):
    """Both passes, theta, the branch derivatives and Newton step, the
    site logLs; 1e-9 relative."""
    s, js = _ssf_engines(mixture)
    _, tree, _, jtree = mixture
    sched, jsched = build_schedule(tree), jbuild_schedule(jtree)
    sa, jsa = s.schedule_arrays(sched), js.schedule_arrays(jsched)
    b = s._blens(sched)
    jb = jnp.asarray(jsched.blens)
    tipP, jtipP = s._tipP, js._dev_tipP
    np.testing.assert_array_equal(tipP.numpy(), np.asarray(jtipP))
    dp = ssf.down_pass(b, tipP, sa, s.pack)
    jdp = jssf.ssf_down_pass(jb, jtipP, jsa, js.pack)
    _col_close(dp.all, jdp.all)
    np.testing.assert_array_equal(dp.scale.numpy(), np.asarray(jdp.scale))
    up = ssf.up_pass(b, dp, tipP, sa, s.pack)
    jup = jssf.ssf_up_pass(jb, jdp, jtipP, jsa, js.pack)
    for a, c in zip(up, jup):
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        else:
            _col_close(a, c)
    th = ssf.edge_thetas(up, dp, sa["edge_src"], s.pack)
    jth = jssf.ssf_edge_thetas(jup, jdp, jsa["edge_src"], js.pack)
    _col_close(th.theta, jth.theta)
    np.testing.assert_array_equal(th.scale.numpy(), np.asarray(jth.scale))
    d = ssf.branch_lh_derivs(th.theta, th.scale, b, s.pack, s._pw)
    jd = jax.vmap(lambda t_, sc, tt: jssf.ssf_branch_lh_derivs(
        t_, sc, tt, js.pack, js._dev_pw))(jth.theta, jth.scale, jb)
    for a, c in zip(d, jd):
        _close(a, c)
    new = ssf.newton_branch_step(th.theta, th.scale, b, s.pack, s._pw,
                                 1e-6, 10.0)
    jnew = jax.vmap(lambda t_, sc, tt: jssf.ssf_newton_branch_step(
        t_, sc, tt, js.pack, js._dev_pw, 1e-6, 10.0))(jth.theta, jth.scale,
                                                      jb)
    _close(new, jnew)
    (l, lp), (jl, jlp) = s.site_lp(tree), js.site_lp(jtree)
    _close(l, jl)
    _close(lp, jlp)


def test_ssf_nni_scoring_and_fit_match_jax(mixture):
    """NNI1 scoring (both swaps and the current topology, the central
    branch optimised) to 1e-9 relative; the branch-length rounds and the
    Gamma shape's Brent take the same steps (1e-8)."""
    s, js = _ssf_engines(mixture)
    _, tree, _, jtree = mixture
    sched = build_schedule(tree)
    cand = tnni.build_nni_candidates(tree, sched)
    ca = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])
    got = s.evaluate_nni_batch(sched, ca)
    want = js.evaluate_nni_batch(jbuild_schedule(jtree), jnp.asarray(ca))
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        _close(g, w)
    t, jt = tree.copy(), jtree.copy()
    assert s.optimize_branches(t, n_rounds=4) == pytest.approx(
        js.optimize_branches(jt, n_rounds=4), rel=1e-10)
    assert s.optimize_alpha(t) == pytest.approx(js.optimize_alpha(jt),
                                                rel=1e-8)


def test_uniform_profile_matches_standard_engine(mixture):
    """tests/test_pmsf.py's identity on the port: every site sharing LG's
    frequencies gives the LG+G4 engine's logL (1e-6 relative)."""
    eng, tree, _, _ = mixture
    model, rates, _ = build_model("LG+G{0.8}", eng.aln)
    ref = LikelihoodEngine(eng.aln, model, rates, dtype=torch.float64,
                           device="cpu").loglik_tree(tree)
    eig = model.get_eigensystem()
    exch = pmsf._exch_full(model.exch_rates, 20)
    sf = np.tile(eig.freqs[0], (eng.aln.num_patterns, 1))
    got = pmsf.SSFEngine(eng.aln, exch, sf, RateGamma(4, alpha=0.8),
                         dtype=torch.float64, device="cpu",
                         min_freq=0.0).loglik_tree(tree)
    assert abs(got - ref) < 1e-6 * max(1.0, abs(ref))


def test_profile_and_run_pmsf_match_jax(mixture):
    """site_frequency_profile to 1e-12; run_pmsf's final logL within 1e-6
    of the JAX package's and, as tests/test_pmsf.py asserts, at least
    the guide mixture's - 1."""
    eng, tree, jeng, jtree = mixture
    t, jt = tree.copy(), jtree.copy()
    l_mix = eng.optimize_branches(t, n_rounds=4)
    jeng.optimize_branches(jt, n_rounds=4)
    prof = pmsf.site_frequency_profile(eng, t)
    assert prof.shape == (eng.aln.num_patterns, 20)
    np.testing.assert_allclose(prof.sum(1), 1.0, atol=1e-6)
    _close(prof, jpmsf.site_frequency_profile(jeng, jt), rtol=0, atol=1e-12)
    _, t2, l2, _ = pmsf.run_pmsf(eng.aln, eng, t, log=lambda m: None,
                                 blen_rounds=4)
    _, jt2, jl2, _ = jpmsf.run_pmsf(jeng.aln, jeng, jt, log=lambda m: None,
                                    blen_rounds=4, dtype=jnp.float64)
    assert l2 == pytest.approx(jl2, abs=1e-6)
    assert l2 >= l_mix - 1.0


def test_ssf_search_matches_jax(mixture, monkeypatch):
    """TreeSearch on the SSF engine in both packages: serial, NNI1 with
    the NOTE, Hamming-JC start distances (the engine has no model), the
    same trees from the same seed."""
    from iqtree2_tpu.search import search as jsearch
    from iqtree2_tpu_torch.search import search as tsearch
    s, js = _ssf_engines(mixture)
    kw = dict(n_init_trees=6, n_nni_trees=3, pop_size=2, fixed_iterations=2,
              seed=3)
    monkeypatch.setenv("IQTREE2_TPU_SEARCH_BATCH", "2")
    search = tsearch.TreeSearch(s, s.aln, tsearch.SearchParams(**kw))
    assert search.batch_iterations == 1
    tres = search.run()
    jres = jsearch.TreeSearch(js, js.aln, jsearch.SearchParams(**kw)).run()
    assert tres.best_tree.topology_id() == jres.best_tree.topology_id()
    assert tres.best_logL == pytest.approx(jres.best_logL, abs=1e-6)


def test_ssf_nni_chunking_changes_no_result(mixture, monkeypatch):
    """NNI1 scoring one candidate per chunk (a budget below one
    candidate's temporaries) gives the whole batch's results."""
    s, _ = _ssf_engines(mixture)
    tree = mixture[1]
    sched = build_schedule(tree)
    cand = tnni.build_nni_candidates(tree, sched)
    ca = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])
    whole = s.evaluate_nni_batch(sched, ca)
    monkeypatch.setattr(ssf, "CHUNK_BYTES", 1)
    for a, b in zip(s.evaluate_nni_batch(sched, ca), whole):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
