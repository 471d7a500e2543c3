"""PoMo past 64 states (N = 13 and 19: 76 and 112 states, which the
kernels' wide instance runs on a card) on the port against the JAX
package, float64 on the CPU at 6 taxa x 32 sites and fixed parameters
(kernelcheck.MODELS' GTR+P13+G4 and GTR+P19+G4): the transition tensors
(1e-12) and the matrix exponential at long branches (held to
scipy.linalg.expm), tree and site logLs (1e-9), the down and up passes
with their scale counts and the edges' theta (1e-9; PoMo's eigenbasis is
empty, so theta is formed from a random U and V given to both sides), the
nonreversible branch derivatives and Newton steps (1e-9) and the NNI5
scores with their per-pattern logLs (1e-9). Fits and searches at these
widths are held to the port's own CPU path, not to the JAX package, whose
fixed eight squarings in expm_ss overflow at PoMo's rates on long
branches (ROADMAP C20).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.ops import nni as jnni
from iqtree2_tpu.ops import pruning as jpr
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.ops import nni as tnni
from iqtree2_tpu_torch.ops import pruning as tpr
from iqtree2_tpu_torch.tree.schedule import build_schedule
from tests.torch_parity import simulate_both

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _col_rel(a, b):
    """max |a - b| / max |b| over each (row, pattern) column's [C, S]:
    theta mixes signs, and its cancellations leave absolute noise of the
    order of the column's largest value."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    num = np.abs(a - b).max(axis=(-3, -2))
    return float((num / np.maximum(np.abs(b).max(axis=(-3, -2)),
                                   1e-300)).max())


@pytest.fixture(scope="module", params=[13, 19], ids=["P13", "P19"])
def both(request):
    """The same problem on both sides: (port dict, JAX dict); the port's
    passes take the JAX side's transition tensors."""
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        f"GTR+P{request.param}+G4", 6, 32, seed=5)
    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    sched, jsched = build_schedule(tree), jbuild_schedule(jtree)
    j = dict(eng=jeng, tree=jtree, sched=jsched, pack=jeng._dev_pack,
             sa=jeng.schedule_arrays(jsched), tipP=jeng._dev_tipP,
             blens=jnp.asarray(jsched.blens))
    t = dict(eng=teng, tree=tree, sched=sched, pack=teng._pack,
             sa=teng.schedule_arrays(sched), tipP=teng._tipP,
             blens=torch.as_tensor(sched.blens))
    j["P"] = jpr.transition_tensors(j["blens"], j["pack"])
    t["P"] = torch.as_tensor(np.array(j["P"]))
    j["dp"] = jpr._down_pass_xla(j["P"], j["tipP"], j["sa"])
    j["up"] = jpr._up_pass_xla(j["P"], j["dp"], j["tipP"], j["sa"],
                               j["pack"]["root_freqs"])
    t["dp"] = tpr.down_pass(t["P"], t["tipP"], t["sa"])
    t["up"] = tpr.up_pass(t["P"], t["dp"], t["tipP"], t["sa"],
                          t["pack"]["root_freqs"])
    assert teng.nonrev and t["tipP"].shape[1] == 4 + 6 * (request.param - 1)
    return t, j


def test_transition_tensors_and_tips_match_jax(both):
    t, j = both
    np.testing.assert_array_equal(t["tipP"].numpy(), np.asarray(j["tipP"]))
    got = tpr.transition_tensors(t["blens"], t["pack"]).numpy()
    want = np.asarray(j["P"])
    assert float(np.abs(got - want).max()) <= 1e-12 * want.max()


def test_expm_squares_enough_at_112_states(both):
    """expm_ss at PoMo's stiff rates and long branches (a fast Gamma
    category) equals scipy.linalg.expm: it squares until its scaled norm
    is at most EXPM_MAX_SCALED_NORM (C20)."""
    t, _ = both
    Q = t["eng"].model.get_eigensystem().Q[0]
    for length in (0.1, 2.0, 25.0):
        want = scipy.linalg.expm(Q * length)
        got = tpr.expm_ss(torch.as_tensor(Q * length)).numpy()
        assert np.abs(got - want).max() < 1e-10


def test_tree_and_site_logl_match_jax(both):
    t, j = both
    logl, lp = t["eng"].site_lp(t["tree"])
    jlogl, jlp = j["eng"].site_lp(j["tree"])
    assert abs(logl - jlogl) <= RTOL * abs(jlogl)
    assert _rel(lp, jlp) < RTOL


def test_passes_and_theta_match_jax(both):
    t, j = both
    assert _col_rel(t["dp"].all[t["tipP"].shape[0]:],
                    np.asarray(j["dp"].all)[t["tipP"].shape[0]:]) < RTOL
    np.testing.assert_array_equal(t["dp"].scale.numpy(),
                                  np.asarray(j["dp"].scale))
    for a, b in zip(t["up"], j["up"]):
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert _col_rel(a, b) < RTOL
    # the Newton round's theta_pass (a down pass without tip rows) against
    # the JAX package's edge_thetas of both passes, on a random eigenbasis
    S = t["tipP"].shape[1]
    rng = np.random.default_rng(3)
    U, V = rng.normal(size=(2, 1, S, S))
    tpack = {**t["pack"], "U": torch.as_tensor(U), "V": torch.as_tensor(V)}
    jpack = {**j["pack"], "U": jnp.asarray(U), "V": jnp.asarray(V)}
    jth = jpr.edge_thetas(j["up"], j["dp"], j["sa"]["edge_src"], jpack)
    tdp = tpr.down_pass(t["P"], t["tipP"], t["sa"], tips=False)
    tth = tpr.theta_pass(t["P"], tdp, t["tipP"], t["sa"], tpack)
    assert _col_rel(tth.theta, jth.theta) < RTOL
    np.testing.assert_array_equal(tth.scale.numpy(), np.asarray(jth.scale))


def test_newton_derivatives_match_jax(both):
    """The direct derivatives and Newton steps of every edge, from its down
    partial and its E."""
    t, j = both
    tp, jp = t["pack"], j["pack"]
    pw = t["eng"].pattern_weights
    down, dsc = tpr.edge_down_partials(t["dp"], t["sa"]["edge_src"])
    jdown, jdsc = jpr.edge_down_partials(j["dp"], j["sa"]["edge_src"])
    args = (down, t["up"].edge_E, t["up"].edge_E_scale + dsc, t["blens"], tp,
            tp["log_ptn_invar"], torch.as_tensor(pw))
    jargs = (jdown, j["up"].edge_E, j["up"].edge_E_scale + jdsc, j["blens"])

    def derivs(d, o, sc, tt):
        return jpr.branch_lh_derivs_nonrev(d, o, sc, tt, jp,
                                           jp["log_ptn_invar"],
                                           jnp.asarray(pw))

    def step(d, o, sc, tt):
        return jpr.newton_branch_step_nonrev(d, o, sc, tt, jp,
                                             jp["log_ptn_invar"],
                                             jnp.asarray(pw), 1e-6, 10.0)

    for g, w in zip(tpr.branch_lh_derivs_nonrev(*args),
                    jax.jit(jax.vmap(derivs))(*jargs)):
        assert _rel(g, w) < RTOL
    assert _rel(tpr.newton_branch_step_nonrev(*args, 1e-6, 10.0),
                jax.jit(jax.vmap(step))(*jargs)) < RTOL


def test_nni5_scores_match_jax(both):
    """NNI5's scores, lengths and per-pattern logLs of every candidate at
    the tree's lengths (no Newton round): fixed parameters, as C20 asks.
    Its Newton rounds reach lengths where the JAX package's expm_ss
    overflows (positive or NaN scores at this problem)."""
    t, j = both
    cand = tnni.build_nni_candidates(t["tree"], t["sched"])
    jc = jnni.build_nni_candidates(j["tree"], j["sched"])
    ca = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])
    jca = np.stack([jc.iu, jc.iv, jc.slot_c, jc.edge_id])
    teng = t["eng"]
    got = tnni.evaluate_nnis5(torch.as_tensor(ca), t["blens"], t["dp"],
                              t["up"], t["sa"], t["pack"], teng._pw, 1e-6,
                              10.0, n_rounds=0, return_site_lp=True,
                              nonrev=True)
    want = jnni.evaluate_nnis5(jnp.asarray(jca), j["blens"], j["dp"],
                               j["up"], j["sa"], j["pack"], j["eng"]._dev_pw,
                               1e-6, 10.0, n_rounds=0, return_site_lp=True,
                               nonrev=True)
    assert len(got) == len(want) == 4
    npat = teng.aln.num_patterns
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) < RTOL
    assert _rel(got[3][..., :npat], np.asarray(want[3])[..., :npat]) < RTOL
