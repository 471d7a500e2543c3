"""PoMo (+P, model/pomo.py: 4 + 6 (N - 1) states, 52 at N = 9) on the port
against the JAX package, float64 on the CPU: the sampled-read tip rows
(bit for bit), the transition tensors (1e-12) and tree and site logLs
(1e-9), the matrix exponential at PoMo's stiff rates held to
scipy.linalg.expm (the JAX package's fixed eight squarings overflow there,
ROADMAP C20; the port's expm_ss squares until EXPM_MAX_SCALED_NORM), and
one alternation round (exchangeabilities, theta and branch lengths).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.model.pack import build_model_pack as jbuild_model_pack
from iqtree2_tpu.ops import pruning as jpruning
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model import optimize as topt
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.pack import build_model_pack
from iqtree2_tpu_torch.model.pomo import PoMoModel
from iqtree2_tpu_torch.ops import pruning
from tests.torch_parity import simulate_both

POMO = "GTR+P+G4"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _engines(ntaxa=6, nsites=32, seed=5):
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        POMO, ntaxa, nsites, seed)
    return (tree, LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                                   device="cpu"),
            jtree, jengine.LikelihoodEngine(jaln, jmodel, jrates,
                                            dtype=jnp.float64))


def test_pomo_builds_and_tips_match_jax():
    (aln, _, model, rates), (jaln, _, jmodel, jrates) = simulate_both(
        POMO, 6, 32, 5)
    assert isinstance(model, PoMoModel) and model.num_states == 52
    assert build_model("GTR+P5", aln)[0].num_states == 4 + 6 * 4
    pk = build_model_pack(aln, model, rates)
    jpk = jbuild_model_pack(jaln, jmodel, jrates)
    np.testing.assert_array_equal(pk.tip_table, jpk.tip_table)
    np.testing.assert_array_equal(pk.Q, jpk.Q)
    np.testing.assert_array_equal(pk.root_freqs, jpk.root_freqs)
    # sampled reads: k/N weights, not indicator rows
    assert ((pk.tip_table > 0) & (pk.tip_table < 1)).any()


def test_transition_tensors_and_logl_match_jax():
    tree, teng, jtree, jeng = _engines()
    blens = np.random.default_rng(1).uniform(1e-4, 0.1, 9)
    got = pruning.transition_tensors(torch.as_tensor(blens), teng._pack)
    want = np.asarray(jpruning.transition_tensors(jnp.asarray(blens),
                                                  jeng._dev_pack))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-12 * want.max()
    logl, lp = teng.site_lp(tree)
    jlogl, jlp = jeng.site_lp(jtree)
    assert abs(logl - jlogl) <= 1e-9 * abs(jlogl)
    assert _rel(lp, jlp) < 1e-9


def test_expm_takes_the_squarings_pomo_needs():
    """At a stiff A (PoMo's Q at t = 25, a long branch in a fast Gamma
    category) expm_ss squares until its Taylor series is accurate, and
    equals scipy.linalg.expm; the JAX package's fixed eight squarings
    overflow there (C20)."""
    (aln, _, model, _), _ = simulate_both(POMO, 5, 20, 1)
    for t in (0.1, 2.0, 25.0):
        A = model.get_eigensystem().Q[0] * t
        want = scipy.linalg.expm(A)
        got = pruning.expm_ss(torch.as_tensor(A)).numpy()
        assert np.abs(got - want).max() < 1e-10
    fixed = np.asarray(jpruning.expm_ss(jnp.asarray(A)))
    assert np.abs(fixed).max() > 1e100


def test_one_alternation_round():
    """One round of the host alternation (L-BFGS-B over five
    exchangeabilities and theta, then the nonreversible Newton): the logL
    rises, theta stays in its bounds, and a fresh engine at the fitted
    parameters and lengths gives the returned logL. The JAX package's round
    is not the reference here: its Newton reaches lengths where its
    exponential overflows (C20)."""
    tree, teng, _, _ = _engines(ntaxa=5, nsites=40, seed=7)
    start = teng.loglik_tree(tree)
    got = topt.optimize_model_parameters(teng, tree, max_rounds=1)
    assert got > start
    lo, hi = teng.model.param_bounds()
    x = teng.model.get_params()
    assert (x >= lo).all() and (x <= hi).all()
    fresh = LikelihoodEngine(teng.aln, teng.model, teng.rates,
                             dtype=torch.float64, device="cpu")
    assert abs(fresh.loglik_tree(tree) - got) < 1e-9
