"""The nonreversible models (UNREST/NONREV, the 37 Lie-Markov models) on
the port against the JAX package, float64 on the CPU: transition tensors
(1e-12), the direct branch derivatives and Newton steps (1e-9), tree and
site logLs (1e-9), the all-branch Newton (logL 1e-6, the same lengths),
NNI1 and NNI5 scores with NNI5's per-pattern logLs (1e-9), one alternation
round, the Lie-Markov family, and C18: ML distances under expm(Q t), which
the JAX package takes from a real-part eigensystem, held to a Newton on
scipy.linalg.expm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.model import optimize as jopt
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.ops import nni as jnni
from iqtree2_tpu.ops import pruning as jpruning
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model import optimize as topt
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.liemarkov import LM_MODELS, LieMarkovModel
from iqtree2_tpu_torch.model.nonrev import UnrestModel
from iqtree2_tpu_torch.ops import distances as tdist
from iqtree2_tpu_torch.ops import nni as tops
from iqtree2_tpu_torch.ops import pruning
from iqtree2_tpu_torch.tree.schedule import build_schedule
from tests.torch_parity import jax_alignment, simulate_both


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _engines(model_name="UNREST+G4", ntaxa=6, nsites=150, seed=5):
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        model_name, ntaxa, nsites, seed)
    return (tree, LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                                   device="cpu"),
            jtree, jengine.LikelihoodEngine(jaln, jmodel, jrates,
                                            dtype=jnp.float64))


@pytest.mark.parametrize("model_name", ["UNREST+G4", "12.12+G4"])
def test_transition_tensors_match_jax(model_name):
    tree, teng, _, jeng = _engines(model_name)
    assert teng.nonrev
    blens = np.random.default_rng(1).uniform(1e-4, 2.0, 9)
    got = pruning.transition_tensors(torch.as_tensor(blens), teng._pack)
    want = np.asarray(jpruning.transition_tensors(jnp.asarray(blens),
                                                  jeng._dev_pack))
    assert float((got.numpy() - want).__abs__().max()) <= 1e-12 * want.max()


def _random_sides(C, S, P, E, seed):
    rng = np.random.default_rng(seed)
    down = rng.uniform(0.01, 1.0, (E, C, S, P))
    out = rng.uniform(0.01, 1.0, (E, C, S, P))
    scale = rng.integers(0, 2, (E, P)).astype(np.int32)
    t = rng.uniform(0.01, 1.5, E)
    return down, out, scale, t


def test_nonrev_derivatives_and_newton_match_jax():
    _, teng, _, jeng = _engines()
    C, S, Pp = 4, 4, teng.Pp
    down, out, scale, t = _random_sides(C, S, Pp, 5, seed=2)
    pw = teng.pattern_weights
    tp, jp = teng._pack, jeng._dev_pack
    got = pruning.branch_lh_derivs_nonrev(
        torch.as_tensor(down), torch.as_tensor(out), torch.as_tensor(scale),
        torch.as_tensor(t), tp, tp["log_ptn_invar"], torch.as_tensor(pw))
    step = pruning.newton_branch_step_nonrev(
        torch.as_tensor(down), torch.as_tensor(out), torch.as_tensor(scale),
        torch.as_tensor(t), tp, tp["log_ptn_invar"], torch.as_tensor(pw),
        1e-6, 10.0)
    lp = pruning.branch_site_lp_nonrev(
        torch.as_tensor(down), torch.as_tensor(out), torch.as_tensor(scale),
        torch.as_tensor(t), tp, tp["log_ptn_invar"])
    for e in range(len(t)):
        args = (jnp.asarray(down[e]), jnp.asarray(out[e]),
                jnp.asarray(scale[e]))
        want = jpruning.branch_lh_derivs_nonrev(
            *args, jnp.asarray(t[e]), jp, jp["log_ptn_invar"],
            jnp.asarray(pw))
        for g, w in zip(got, want):
            assert _rel(g[e], w) < 1e-9
        w_step = jpruning.newton_branch_step_nonrev(
            *args, jnp.asarray(t[e]), jp, jp["log_ptn_invar"],
            jnp.asarray(pw), 1e-6, 10.0)
        assert _rel(step[e], w_step) < 1e-9
        w_lp = jpruning.branch_site_lp_nonrev(
            *args, jnp.asarray(t[e]), jp, jp["log_ptn_invar"])
        assert _rel(lp[e][: teng.aln.num_patterns],
                    np.asarray(w_lp)[: teng.aln.num_patterns]) < 1e-9


@pytest.mark.parametrize("model_name", ["UNREST+G4", "12.12+G4"])
def test_tree_and_site_logl_match_jax(model_name):
    tree, teng, jtree, jeng = _engines(model_name)
    got, lp = teng.site_lp(tree)
    want, jlp = jeng.site_lp(jtree)
    assert abs(got - want) <= 1e-9 * abs(want)
    assert _rel(lp, jlp) < 1e-9


def test_optimize_branches_match_jax():
    tree, teng, jtree, jeng = _engines(ntaxa=6, nsites=150)
    got = teng.optimize_branches(tree)
    want = jeng.optimize_branches(jtree)
    assert abs(got - want) < 1e-6
    assert tree.to_newick(digits=6) == jtree.to_newick(digits=6)


def test_edge_chunks_change_no_result(monkeypatch):
    """The nonreversible Newton's edges in chunks of one edge give the
    whole round's lengths (each edge's sums are its own)."""
    from iqtree2_tpu_torch import engine as tengine
    tree, teng, _, _ = _engines(ntaxa=7, nsites=120)
    whole = tree.copy()
    l_whole = teng.optimize_branches(whole, n_rounds=2)
    monkeypatch.setattr(tengine, "NONREV_CHUNK_BYTES", 1)
    cut = tree.copy()
    l_cut = teng.optimize_branches(cut, n_rounds=2)
    assert abs(l_cut - l_whole) <= 1e-12 * abs(l_whole)
    for k, v in whole.blen.items():
        assert abs(cut.blen[k] - v) <= 1e-12 * max(v, 1e-300)


@pytest.mark.parametrize("nni5", [False, True])
def test_nni_scores_match_jax(nni5):
    tree, teng, jtree, jeng = _engines(ntaxa=7, nsites=150, seed=6)
    teng.optimize_branches(tree, n_rounds=2)
    jeng.optimize_branches(jtree, n_rounds=2)
    sched = build_schedule(tree)
    cand = tops.build_nni_candidates(tree, sched)
    ca = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])
    jsched = jbuild_schedule(jtree)
    jc = jnni.build_nni_candidates(jtree, jsched)
    jca = np.stack([jc.iu, jc.iv, jc.slot_c, jc.edge_id])
    got = teng.evaluate_nni_batch(sched, ca, nni5=nni5,
                                  return_site_lp=nni5)
    want = jeng.evaluate_nni_batch(jsched, jnp.asarray(jca), nni5=nni5,
                                   return_site_lp=nni5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-9


def test_nni1_site_logl_is_the_branch_logl():
    """NNI1 under a nonreversible model gives per-pattern logLs (the JAX
    package returns none there): their weighted sum is each score."""
    tree, teng, _, _ = _engines(ntaxa=7, nsites=150, seed=6)
    sched = build_schedule(tree)
    cand = tops.build_nni_candidates(tree, sched)
    ca = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])
    logl, _, lp = teng.evaluate_nni_batch(sched, ca, return_site_lp=True)
    w = teng.aln.pattern_weights
    assert _rel((lp * w).sum(-1), logl) < 1e-12


def test_one_alternation_round_matches_jax():
    tree, teng, jtree, jeng = _engines(ntaxa=6, nsites=150, seed=7)
    got = topt.optimize_model_parameters(teng, tree, max_rounds=1)
    want = jopt.optimize_model_parameters(jeng, jtree, max_rounds=1)
    # L-BFGS-B's finite differences over the 11 free rates part at
    # rounding (measured 1.9e-6 in logL), as the +R4 alternation's do in
    # tests/test_torch_fit.py
    assert abs(got - want) < 1e-4
    assert _rel(teng.model.get_params(), jeng.model.get_params()) < 1e-3


def test_lie_markov_family_builds_and_lm11_is_jc():
    (aln, tree, _, _), (jaln, jtree, _, _) = simulate_both("GTR+G4", 6, 100,
                                                           seed=3)
    names = set()
    for key in LM_MODELS:
        for sym in ("RY", "WS", "MK"):
            model, _, _ = build_model(sym + key + "+G", aln)
            assert isinstance(model, LieMarkovModel)
            names.add(model.name)
            Q = model.get_eigensystem().Q[0]
            assert np.allclose(Q.sum(1), 0.0, atol=1e-12)
    assert len(LM_MODELS) == 37
    # RY, WS and MK name one model where the pairings are isomorphic
    assert len(names) == 37 * 3 - 2 * 6
    # a DNA model's name is not read as Lie-Markov's
    assert not isinstance(build_model("K3P", aln)[0], LieMarkovModel)
    logl = [LikelihoodEngine(aln, *build_model(m, aln)[:2],
                             dtype=torch.float64, device="cpu")
            .loglik_tree(tree) for m in ("1.1", "JC")]
    assert abs(logl[0] - logl[1]) <= 1e-9 * abs(logl[1])
    jlogl = jengine.LikelihoodEngine(jaln, *jbuild_model("1.1", jaln)[:2],
                                     dtype=jnp.float64).loglik_tree(jtree)
    assert abs(logl[0] - jlogl) <= 1e-9 * abs(jlogl)


def _expm_newton(F, t0, Q, n_iter=20):
    """sum F log P(t) maximised pair by pair with P = scipy.linalg.expm."""
    out = []
    for f, t in zip(F, t0):
        for _ in range(n_iter):
            P = scipy.linalg.expm(Q * t)
            QP = Q @ P
            QQP = Q @ QP
            Pc = np.maximum(P, 1e-12)
            r = QP / Pc
            d1 = (f * r).sum()
            d2 = (f * (QQP / Pc - r * r)).sum()
            step = -d1 / d2 if d2 < 0 else np.sign(d1) * 0.5 * t
            t = float(np.clip(t + step, 1e-6, tdist.MAX_DIST))
        out.append(t)
    return np.asarray(out)


def test_ml_distances_under_q_follow_expm():
    """C18: the port's ML distances under a nonreversible model maximise
    sum F log expm(Q t); the real-part eigensystem's P, which the JAX
    package's distances use, is far from it."""
    (aln, _, model, _), _ = simulate_both("UNREST+G4", 6, 300, seed=1)
    assert isinstance(model, UnrestModel)
    got = tdist.ml_distances(aln, model, device="cpu")
    F, pairs = tdist.pair_frequency_tables(aln)
    D0 = tdist.hamming_jc_distances(aln)
    t0 = np.maximum(D0[pairs[:, 0], pairs[:, 1]], 1e-4)
    Q = model.get_eigensystem().Q[0]
    want = _expm_newton(F, t0, Q)
    assert _rel(got[pairs[:, 0], pairs[:, 1]], want) < 1e-8
    eig = model.get_eigensystem()
    real_part = (eig.U[0] * np.exp(eig.eigvals[0] * 0.1)) @ eig.V[0]
    assert np.abs(real_part - scipy.linalg.expm(Q * 0.1)).max() > 0.1


def test_unrest_in_an_alignment_of_other_states_builds():
    """UNREST takes the alignment's states (20 on protein: 380 rates)."""
    (aln, tree, _, _), _ = simulate_both("LG+G4", 5, 60, seed=1)
    model, rates, _ = build_model("UNREST", aln)
    assert len(model.rates) == 380
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")
    jaln = jax_alignment(aln)
    jm, jr, _ = jbuild_model("UNREST", jaln)
    from tests.torch_parity import both_trees
    _, jtree = both_trees(tree, aln.names)
    want = jengine.LikelihoodEngine(jaln, jm, jr,
                                    dtype=jnp.float64).loglik_tree(jtree)
    got = eng.loglik_tree(tree)
    assert abs(got - want) <= 1e-9 * abs(want)


def test_serial_search_matches_jax(monkeypatch):
    """C2: the JAX package's batched search climbs a nonreversible model
    with the reversible Newton; serially (IQTREE2_TPU_SEARCH_BATCH=1) it
    takes the nonreversible one, as every round of the port's does. The
    two serial searches visit the same trees."""
    from iqtree2_tpu.search import search as jsearch
    from iqtree2_tpu_torch.search import search as tsearch
    (aln, _, model, rates), (jaln, _, jmodel, jrates) = simulate_both(
        "UNREST+G4", 8, 150, 4)
    kw = dict(n_init_trees=6, n_nni_trees=3, pop_size=2, fixed_iterations=2,
              seed=3)
    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    tres = tsearch.TreeSearch(teng, aln, tsearch.SearchParams(**kw),
                              batch_iterations=1).run()
    monkeypatch.setenv("IQTREE2_TPU_SEARCH_BATCH", "1")
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    jres = jsearch.TreeSearch(jeng, jaln, jsearch.SearchParams(**kw)).run()
    assert tres.best_tree.topology_id() == jres.best_tree.topology_id()
    # measured 1.8e-6 apart: at the longest branches the port's expm_ss
    # takes more squarings than the JAX package's fixed eight, and the
    # rounding's differences add up over the search's Newton rounds
    assert tres.best_logL == pytest.approx(jres.best_logL, abs=1e-5)
