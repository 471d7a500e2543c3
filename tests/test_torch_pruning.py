"""Port's plain pruning contracts vs the JAX package's XLA path, float64.

One simulated problem is built on each side from the same plain inputs
(tests/torch_parity.py): the port's engine gives the port's model pack,
schedule and tip partials, the JAX engine the JAX package's, and the tip
partials must be equal. The transition tensors of the JAX side then go
through iqtree2_tpu/ops/pruning.py (_down_pass_xla, _up_pass_xla,
edge_thetas, branch_lh_derivs, tree_loglik with force_xla) and through
iqtree2_tpu_torch/ops/pruning.py on the CPU (the passes, edge_thetas, the
Newton round's theta_pass and the down pass's site-logL epilogue without
tip rows, branch_lh_derivs, tree_loglik); every output must agree to 1e-9
relative. The golden fixed-parameter logLs (g1/g2/g3/g6) are checked
through the port's engine against the reference IQ-TREE values.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu.engine import LikelihoodEngine as JaxEngine
from iqtree2_tpu.ops import pruning as jpr
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io.alignment_io import read_alignment
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.ops import pruning as tpr
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree
from tests.torch_parity import simulate_both

GOLDEN = Path(__file__).parent / "golden"
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(model_name, ntaxa, seed, nsites=256):
    """The same problem in both packages: (jax dict, torch dict), each from
    its own engine; the torch side takes the JAX side's transition
    tensors."""
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        model_name, ntaxa, nsites, seed)
    eng = JaxEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    jsched = jbuild_schedule(jtree)
    blens = np.maximum(jsched.blens, 1e-6)
    j = dict(pack=eng._dev_pack, sched=eng.schedule_arrays(jsched),
             tipP=eng._dev_tipP, pw=eng._dev_pw, blens=jnp.asarray(blens))
    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    sched = build_schedule(tree)
    np.testing.assert_array_equal(sched.blens, jsched.blens)
    t = dict(pack=teng._pack, sched=teng.schedule_arrays(sched),
             tipP=teng._tipP, pw=teng._pw,
             blens=torch.as_tensor(np.maximum(sched.blens, 1e-6)))
    for k, v in j["sched"].items():
        np.testing.assert_array_equal(t["sched"][k].numpy(), np.asarray(v))
    j["P"] = jpr.transition_tensors(j["blens"], j["pack"])
    t["P"] = torch.as_tensor(np.array(j["P"]))
    return j, t


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


CASES = [(m, n) for m in ("GTR+G4", "HKY+I", "LG+G4") for n in (8, 33, 80)]


@pytest.mark.parametrize("model_name,ntaxa", CASES)
def test_passes_thetas_and_derivs_match_jax(model_name, ntaxa):
    j, t = _both(model_name, ntaxa, seed=ntaxa)
    np.testing.assert_array_equal(t["tipP"].numpy(), np.asarray(j["tipP"]))
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

    for a, b in zip(tpr.edge_down_partials(tdp, t["sched"]["edge_src"]),
                    jpr.edge_down_partials(jdp, j["sched"]["edge_src"])):
        _close(a, b)
    jth = jpr.edge_thetas(jup, jdp, j["sched"]["edge_src"], j["pack"])
    tth = tpr.edge_thetas(tup, tdp, t["sched"]["edge_src"], t["pack"])
    _theta_close(tth, jth)

    li = j["pack"]["log_ptn_invar"]
    jd = jax.vmap(lambda th, sc, tt: jpr.branch_lh_derivs(
        th, sc, tt, j["pack"], li, j["pw"]))(jth.theta, jth.scale,
                                              j["blens"])
    td = tpr.branch_lh_derivs(tth.theta, tth.scale, t["blens"], t["pack"],
                              t["pack"]["log_ptn_invar"], t["pw"])
    for a, b in zip(td, jd):
        _close(a, b)
    l0 = tpr.branch_lh_derivs(tth.theta, tth.scale, t["blens"], t["pack"],
                              t["pack"]["log_ptn_invar"], t["pw"], order=0)
    _close(l0[0], jd[0])

    jnew = jax.vmap(lambda th, sc, tt: jpr.newton_branch_step(
        th, sc, tt, j["pack"], li, j["pw"], 1e-6, 10.0))(
        jth.theta, jth.scale, j["blens"])
    tnew = tpr.newton_branch_step(tth.theta, tth.scale, t["blens"],
                                  t["pack"], t["pack"]["log_ptn_invar"],
                                  t["pw"], 1e-6, 10.0)
    _close(tnew, jnew)
    jsl = jax.vmap(lambda th, sc, tt: jpr.branch_site_lp(
        th, sc, tt, j["pack"], li))(jth.theta, jth.scale, j["blens"])
    tsl = tpr.branch_site_lp(tth.theta, tth.scale, t["blens"], t["pack"],
                             t["pack"]["log_ptn_invar"])
    _close(tsl, jsl, atol=1e-12)


@pytest.mark.parametrize("model_name,ntaxa", CASES)
def test_tree_loglik_matches_jax(model_name, ntaxa):
    j, t = _both(model_name, ntaxa, seed=100 + ntaxa)
    jl, jlp = jpr.tree_loglik(j["blens"], j["tipP"], j["sched"], j["pack"],
                              j["pw"], force_xla=True)
    tl, tlp = tpr.tree_loglik(t["blens"], t["tipP"], t["sched"], t["pack"],
                              t["pw"])
    _close(tl, jl)
    _close(tlp, jlp, atol=1e-12)   # padded patterns: lp ~ 1e-16
    # the root contracts the kernel's site_lp replaces
    n_int = t["sched"]["child_src"].shape[0]
    tdp = tpr.down_pass(t["P"], t["tipP"], t["sched"])
    jdp = jpr._down_pass_xla(j["P"], j["tipP"], j["sched"])
    tB, tS = tpr.root_partial(tdp, t["P"], t["tipP"], n_int)
    jB, jS = jpr.root_partial(jdp, j["P"], j["tipP"], n_int)
    _close(tB, jB)
    np.testing.assert_array_equal(tS.numpy(), np.asarray(jS))
    p = t["pack"]
    tl2, _ = tpr.root_loglik(tB, tS, p["root_freqs"], p["cat_weight"],
                             p["log_ptn_invar"], t["pw"])
    _close(tl2, jl)


def _theta_close(got, want):
    """theta within RTOL of the largest |theta| of each (edge, pattern)
    column, scale counts equal: theta mixes signs, and cancellation leaves
    absolute noise of the order of 1e-9 of that largest value."""
    scale = np.abs(np.asarray(want.theta)).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got.theta.numpy() - np.asarray(want.theta))
            <= RTOL * scale).all()
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("model_name,ntaxa", CASES)
def test_theta_pass_matches_jax(model_name, ntaxa):
    """The Newton round's theta: one theta_pass over a down pass without
    tip rows, against the JAX package's edge_thetas of both passes."""
    j, t = _both(model_name, ntaxa, seed=ntaxa)
    jdp, jup = jpr.both_passes(j["P"], j["tipP"], j["sched"], j["pack"],
                               force_xla=True)
    jth = jpr.edge_thetas(jup, jdp, j["sched"]["edge_src"], j["pack"])
    tdp = tpr.down_pass(t["P"], t["tipP"], t["sched"], tips=False)
    _theta_close(tpr.theta_pass(t["P"], tdp, t["tipP"], t["sched"],
                                t["pack"]), jth)


@pytest.mark.parametrize("model_name,ntaxa", CASES)
def test_sitelp_epilogue_matches_jax(model_name, ntaxa):
    """The down pass's site-logL epilogue without tip rows (tree_loglik's
    pass) against the JAX package's site log-likelihoods."""
    j, t = _both(model_name, ntaxa, seed=100 + ntaxa)
    _, jlp = jpr.tree_loglik(j["blens"], j["tipP"], j["sched"], j["pack"],
                             j["pw"], force_xla=True)
    tdp = tpr.down_pass(t["P"], t["tipP"], t["sched"], pack=t["pack"],
                        tips=False)
    _close(tpr.site_lp(tdp), jlp, atol=1e-12)   # padded patterns: ~1e-16
    jdp = jpr._down_pass_xla(j["P"], j["tipP"], j["sched"])
    L = t["tipP"].shape[0]
    _close(tdp.all[L:], jdp.all[L:])


def test_asc_terms_match_jax():
    """+ASC: the Lewis correction in finalize_loglik and branch_lh_derivs."""
    j, t = _both("GTR+G4", 12, seed=5)
    Pp = t["tipP"].shape[-1]
    mask = np.zeros(Pp)
    mask[-8:] = 1.0
    for d, conv in ((j, jnp.asarray), (t, torch.as_tensor)):
        d["pack"] = dict(d["pack"], asc_mask=conv(mask),
                         asc_nsites=conv(np.float64(200.0)))
    jl, _ = jpr.tree_loglik(j["blens"], j["tipP"], j["sched"], j["pack"],
                            j["pw"], force_xla=True)
    tl, _ = tpr.tree_loglik(t["blens"], t["tipP"], t["sched"], t["pack"],
                            t["pw"])
    _close(tl, jl)
    jdp, jup = jpr.both_passes(j["P"], j["tipP"], j["sched"], j["pack"],
                               force_xla=True)
    tdp, tup = tpr.both_passes(t["P"], t["tipP"], t["sched"], t["pack"])
    jth = jpr.edge_thetas(jup, jdp, j["sched"]["edge_src"], j["pack"])
    tth = tpr.edge_thetas(tup, tdp, t["sched"]["edge_src"], t["pack"])
    li = j["pack"]["log_ptn_invar"]
    for order in (0, 2):
        jd = jax.vmap(lambda th, sc, tt: jpr.branch_lh_derivs(
            th, sc, tt, j["pack"], li, j["pw"], order=order))(
            jth.theta, jth.scale, j["blens"])
        td = tpr.branch_lh_derivs(tth.theta, tth.scale, t["blens"],
                                  t["pack"], t["pack"]["log_ptn_invar"],
                                  t["pw"], order=order)
        for a, b in zip(td, jd):
            if b is not None:
                _close(a, b)


@pytest.fixture(scope="module")
def golden():
    return json.loads((GOLDEN / "golden.json").read_text())


@pytest.mark.parametrize("cfg", ["g1_jc_fix", "g2_gtrg_fix", "g3_hkyi_fix",
                                 "g6_r3_fix"])
def test_golden_fixed_logl(golden, cfg):
    aln = read_alignment(str(GOLDEN / "example.phy"))
    tree = Tree.from_newick((GOLDEN / "ref_tree.nwk").read_text(), aln.names)
    model, rates, _ = build_model(golden["configs"][cfg]["model"], aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")
    assert eng.loglik_tree(tree) == pytest.approx(golden["logL"][cfg],
                                                  abs=2e-3)
