"""Heterotachy (+H, per-class branch lengths; model/heterotachy.py) on the
port against the JAX package, float64 on the CPU: transition tensors of
[E, C] lengths (1e-12), the per-class derivatives and Newton steps (1e-9),
theta_pass against edge_thetas at per-class lengths (1e-12, which lets the
port's Newton take the kernel), the all-branch per-class Newton (logL 1e-6,
the same lengths), NNI1 and NNI5 per-class scores (1e-9), the EM fit of
the class weights (1e-6), a -m GTR+H2 search (the JAX one serial,
IQTREE2_TPU_SEARCH_BATCH=1, as the port runs a MixlenEngine) and the
refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu.model import heterotachy as jhet
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.ops import nni as jnni
from iqtree2_tpu.ops import pruning as jpruning
from iqtree2_tpu.search import search as jsearch
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu_torch import cli
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.heterotachy import MixlenEngine
from iqtree2_tpu_torch.ops import nni as tops
from iqtree2_tpu_torch.ops import pruning
from iqtree2_tpu_torch.search import search as tsearch
from iqtree2_tpu_torch.tree.schedule import build_schedule
from tests.torch_parity import simulate_both

H2 = "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+H2"
ALN = "tests/golden/example.phy"
TREE = "tests/golden/ref_tree.nwk"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _engines(model_str=H2, ntaxa=6, nsites=150, seed=5):
    """(port tree, MixlenEngine, JAX tree, JAX MixlenEngine) of a GTR+H4
    simulation fitted under ``model_str``."""
    (aln, tree, _, _), (jaln, jtree, _, _) = simulate_both("GTR+H4", ntaxa,
                                                           nsites, seed)
    model, rates, ex = build_model(model_str, aln)
    jmodel, jrates, _ = jbuild_model(model_str, jaln)
    assert ex["mixlen"] == rates.ncat
    return (tree, MixlenEngine(aln, model, rates, dtype=torch.float64,
                               device="cpu"),
            jtree, jhet.MixlenEngine(jaln, jmodel, jrates,
                                     dtype=jnp.float64))


def test_transition_tensors_of_class_lengths_match_jax():
    _, teng, _, jeng = _engines("GTR{1.5,4.0,1.2,0.8,5.0}+F+H4")
    b2 = np.random.default_rng(1).uniform(1e-4, 2.0, (9, 4))
    got = pruning.transition_tensors(torch.as_tensor(b2), teng._pack)
    want = np.asarray(jpruning.transition_tensors(jnp.asarray(b2),
                                                  jeng._dev_pack))
    assert got.shape == (9, 4, 4, 4)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-12 * want.max()


def test_mixlen_derivatives_and_newton_match_jax():
    _, teng, _, jeng = _engines("GTR{1.5,4.0,1.2,0.8,5.0}+F+H3")
    rng = np.random.default_rng(2)
    C, P, E = 3, teng.Pp, 4
    theta = rng.uniform(0.01, 1.0, (E, C, 4, P))
    scale = rng.integers(0, 2, (E, P)).astype(np.int32)
    tv = rng.uniform(0.01, 1.0, (E, C))
    pw = teng.pattern_weights
    tp, jp = teng._pack, jeng._dev_pack
    args = (torch.as_tensor(theta), torch.as_tensor(scale))
    got = pruning.branch_lh_derivs_mixlen(*args, torch.as_tensor(tv), tp,
                                          tp["log_ptn_invar"],
                                          torch.as_tensor(pw))
    step = pruning.newton_branch_step_mixlen(
        *args, torch.as_tensor(tv), tp, tp["log_ptn_invar"],
        torch.as_tensor(pw), 1e-6, 10.0)
    for e in range(E):
        jargs = (jnp.asarray(theta[e]), jnp.asarray(scale[e]),
                 jnp.asarray(tv[e]), jp, jp["log_ptn_invar"],
                 jnp.asarray(pw))
        for g, w in zip(got, jpruning.branch_lh_derivs_mixlen(*jargs)):
            assert _rel(g[e], w) < 1e-9
        w_step = jpruning.newton_branch_step_mixlen(*jargs, 1e-6, 10.0)
        assert _rel(step[e], w_step) < 1e-9


def test_theta_pass_is_edge_thetas_at_class_lengths():
    """theta does not depend on the lengths, so theta_pass's contract holds
    for per-class P: the kernel's theta equals both passes' edge_thetas."""
    tree, teng, _, _ = _engines("GTR{1.5,4.0,1.2,0.8,5.0}+F+H4", ntaxa=8)
    sched = build_schedule(tree)
    sa = teng.schedule_arrays(sched)
    P = pruning.transition_tensors(teng._t(teng.init_blens2(sched)),
                                   teng._pack)
    dp, up = pruning.both_passes(P, teng._tipP, sa, teng._pack)
    want = pruning.edge_thetas(up, dp, sa["edge_src"], teng._pack)
    got = pruning.theta_pass(P, dp, teng._tipP, sa, teng._pack)
    assert torch.equal(got.scale, want.scale)
    den = want.theta.abs().amax(dim=(-3, -2)).clamp(min=1e-300)
    assert float(((got.theta - want.theta).abs().amax(dim=(-3, -2))
                  / den).max()) <= 1e-12


def test_optimize_branches_match_jax():
    tree, teng, jtree, jeng = _engines()
    got = teng.optimize_branches(tree)
    want = jeng.optimize_branches(jtree)
    assert abs(got - want) < 1e-6
    assert _rel(teng.blens2, jeng.blens2) < 1e-6
    assert tree.to_newick(digits=6) == jtree.to_newick(digits=6)


def test_optimize_mixlen_matches_jax():
    tree, teng, jtree, jeng = _engines()
    got = teng.optimize_mixlen(tree, n_outer=3)
    want = jeng.optimize_mixlen(jtree, n_outer=3)
    assert abs(got - want) < 1e-6
    assert np.abs(teng.rates.weights - jeng.rates.weights).max() < 1e-6
    assert abs(teng.loglik_mixlen(tree) - got) < 1e-9


@pytest.mark.parametrize("nni5", [False, True])
def test_nni_scores_match_jax(nni5):
    tree, teng, jtree, jeng = _engines(ntaxa=7, seed=6)
    teng.optimize_branches(tree, n_rounds=2)
    jeng.optimize_branches(jtree, n_rounds=2)
    teng._nni_tree, jeng._nni_tree = tree, jtree
    sched = build_schedule(tree)
    cand = tops.build_nni_candidates(tree, sched)
    ca = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])
    jsched = jbuild_schedule(jtree)
    jc = jnni.build_nni_candidates(jtree, jsched)
    jca = np.stack([jc.iu, jc.iv, jc.slot_c, jc.edge_id])
    got = teng.evaluate_nni_batch(sched, ca, nni5=nni5)
    if nni5:
        want = jeng.evaluate_nni_batch(jsched, jca, nni5=nni5)
    else:
        # the JAX MixlenEngine's NNI1 unpacks three values from
        # evaluate_nnis' two and fails (ROADMAP C21): its evaluate_nnis on
        # the same passes is the reference, t_opt averaged as the engine
        # would
        b2 = jnp.asarray(jeng._blens2_for(jtree, jsched))
        sa = jeng.schedule_arrays(jsched)
        dp, up = jpruning.both_passes(
            jpruning.transition_tensors(b2, jeng._dev_pack), jeng._dev_tipP,
            sa, jeng._dev_pack)
        logl, t_opt = jnni.evaluate_nnis(
            jnp.asarray(jca), b2, dp, up.up_in, up.up_scale, sa,
            jeng._dev_pack, jeng._dev_pw, 1e-6, 10.0, mixlen=True)
        want = (logl, (np.asarray(t_opt)
                       * jeng.rates.category_weights()).sum(-1))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-9
    if nni5:
        assert _rel(teng.last_t5_h, jeng.last_t5_h) < 1e-9


def test_search_matches_jax(monkeypatch):
    """-m GTR+H2 on 8 x 300: the port's search and the JAX package's run
    serially on their MixlenEngines and visit the same trees."""
    (aln, _, _, _), (jaln, _, _, _) = simulate_both("GTR+H4", 8, 300, 4)
    kw = dict(n_init_trees=6, n_nni_trees=3, pop_size=2, fixed_iterations=2,
              seed=3)
    teng = MixlenEngine(aln, *build_model(H2, aln)[:2], dtype=torch.float64,
                        device="cpu")
    tres = tsearch.TreeSearch(teng, aln, tsearch.SearchParams(**kw)).run()
    assert tres.n_iterations == 2
    monkeypatch.setenv("IQTREE2_TPU_SEARCH_BATCH", "1")
    jeng = jhet.MixlenEngine(jaln, *jbuild_model(H2, jaln)[:2],
                             dtype=jnp.float64)
    jres = jsearch.TreeSearch(jeng, jaln, jsearch.SearchParams(**kw)).run()
    assert tres.best_tree.topology_id() == jres.best_tree.topology_id()
    assert tres.best_logL == pytest.approx(jres.best_logL, abs=1e-6)


@pytest.mark.parametrize("argv,message", [
    (["-m", "GTR+G+H4"], "cannot be combined"),
    (["-m", "UNREST+H2"], "nonreversible"),
    (["-m", "LG+C10+H2", "-st", "AA"], "mixture"),
    (["-m", "GTR+H2", "-alrt", "100"], "-alrt with"),
])
def test_refusals(tmp_path, argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["-s", ALN, "-te", TREE, "--device", "cpu", "--quiet",
                  "-pre", str(tmp_path / "x")] + argv)
