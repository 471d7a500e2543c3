"""The port's joint model fit (model/torchfit.py) vs the JAX package's
(model/jaxfit.py), float64 on the CPU.

The same inputs (golden files or kernelcheck.simulate seeds) are built on
each side by its own package (tests/torch_parity.py) and go through that
package's fit; the tolerance of each comparison is written at its assert.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.io.alignment_io import read_alignment as jread_alignment
from iqtree2_tpu.model import jaxfit
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import kernelcheck
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io.alignment_io import read_alignment
from iqtree2_tpu_torch.model import torchfit
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree
from tests.torch_parity import both_trees, jax_alignment

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("alpha", [0.05, 0.5, 2.0, 20.0])
@pytest.mark.parametrize("median", [False, True])
def test_gamma_cat_rates_and_derivative_match_jax(alpha, median):
    want = np.asarray(jaxfit.gamma_cat_rates(jnp.float64(alpha), 4, median))
    dwant = np.asarray(jax.jacfwd(
        lambda a: jaxfit.gamma_cat_rates(a, 4, median))(jnp.float64(alpha)))
    a = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    got = torchfit.gamma_cat_rates(a, 4, median)
    dgot = torch.stack([torch.autograd.grad(got[i], a, retain_graph=True)[0]
                        for i in range(4)])
    assert _rel(got.detach(), want) < 1e-9
    assert _rel(dgot, dwant) < 1e-7


def _jax_consts(jeng, sched, spec):
    """jaxfit._run_fit's constants for one (engine, schedule, spec)."""
    tip_table = jnp.asarray(jeng.pack_np.tip_table, jnp.float64)
    cm = np.zeros((jeng.Pp, spec.S))
    cm[: jeng.aln.num_patterns] = jeng.aln.const_state_mask()
    iu = np.triu_indices(spec.S, 1)
    return dict(
        Cmat=jnp.asarray(spec.Cmat), ref_mask=jnp.asarray(spec.ref_mask),
        iu=(jnp.asarray(iu[0]), jnp.asarray(iu[1])),
        tipP=jnp.swapaxes(tip_table[jnp.asarray(jeng.tip_codes)], 1, 2),
        sched={k: jnp.asarray(v) for k, v in sched.to_device_arrays().items()
               if k in ("child_src", "child_edge", "step_node", "edge_src")},
        pw=jnp.asarray(jeng.pattern_weights), cmf_raw=jnp.asarray(cm),
        is_const=jnp.asarray(cm.sum(1) > 0),
        pinv_flag=jnp.asarray(1.0 if spec.has_pinv else 0.0),
        n_steps=int(sched.step_node.shape[0]))


@pytest.mark.parametrize("sim,model_str", [
    ("GTR+G4", "GTR+G"), ("HKY+I", "HKY+I+G"), ("LG+G4", "LG+F+G"),
    ("GTR+G4", "TN+R3"), ("HKY+I", "K2P+I")])
def test_objective_and_gradient_match_jax(sim, model_str):
    aln, tree, _, _ = kernelcheck.simulate(sim, 12, 300, seed=7)
    tree, jtree = both_trees(tree, aln.names)
    jaln = jax_alignment(aln)
    model, rates, _ = build_model(model_str, aln)
    jmodel, jrates, _ = jbuild_model(model_str, jaln)
    jspec = jaxfit.build_spec(jmodel, jrates)
    spec = torchfit.build_spec(model, rates)
    for f in ("x0", "mask", "Cmat", "ref_mask"):
        np.testing.assert_array_equal(getattr(spec, f), getattr(jspec, f))
    assert spec.seg == jspec.seg
    rng = np.random.default_rng(3)
    x = spec.x0 + rng.normal(0.0, 0.3, spec.k)
    sched = build_schedule(tree)
    log_t = np.log(np.clip(sched.blens, 1e-6, 10.0)) \
        + rng.normal(0.0, 0.3, len(sched.blens))

    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    consts = _jax_consts(jeng, jbuild_schedule(jtree), jspec)
    jv, (jgx, jgt) = jax.value_and_grad(
        lambda a, b: jaxfit._loglik(a, b, jspec, consts), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(log_t))

    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(log_t, requires_grad=True)
    tv = torchfit.fit_loglik(xt, tt, spec, torchfit.fit_consts(
        teng, sched, spec, torch.float64))
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-9)
    # entries whose gradient is exactly 0 on one side (frozen or absent
    # parameters) must be exactly 0 on the other
    g_t = np.concatenate([xt.grad.numpy(), tt.grad.numpy()])
    g_j = np.concatenate([np.asarray(jgx), np.asarray(jgt)])
    assert ((g_t == 0) == (g_j == 0)).all()
    nz = g_j != 0
    assert _rel(g_t[nz], g_j[nz]) < 1e-7


@pytest.fixture(scope="module")
def golden():
    return json.loads((GOLDEN / "golden.json").read_text())["logL"]


def test_try_fit_on_golden_matches_jax(golden):
    nwk = (GOLDEN / "ref_tree.nwk").read_text()
    out = []
    for fit, read, bm, tree_of, eng_of in (
            (torchfit.try_fit, read_alignment, build_model, Tree.from_newick,
             lambda a, m, r: LikelihoodEngine(a, m, r, dtype=torch.float64,
                                              device="cpu")),
            (jaxfit.try_fit, jread_alignment, jbuild_model, JTree.from_newick,
             lambda a, m, r: jengine.LikelihoodEngine(a, m, r,
                                                      dtype=jnp.float64))):
        aln = read(str(GOLDEN / "example.phy"))
        model, rates, _ = bm("GTR+G", aln)
        tree = tree_of(nwk, aln.names)
        out.append((fit(eng_of(aln, model, rates), tree, epsilon=0.01),
                    rates.alpha))
    (lt, at), (lj, aj) = out
    assert lt == pytest.approx(lj, abs=0.05)
    assert lt >= golden["g4_gtrg_opt"] - 2e-3
    assert at == pytest.approx(aj, rel=1e-2)


def test_try_fit_declines_what_it_does_not_cover():
    aln, tree, _, _ = kernelcheck.simulate("GTR+G4", 8, 100, seed=2)
    model, rates, _ = build_model("GTR+G", aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu", asc=True)
    assert torchfit.try_fit(eng, tree) is None          # +ASC
    model, rates, _ = build_model("JC", aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")
    # nothing free once the branch lengths are fixed
    assert torchfit.try_fit(eng, tree, fix_blens=True) is None
    model, rates, _ = build_model("GTR+G", aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")
    sched = build_schedule(tree)
    limit = sched.n_int * 4 * 4 * eng.Pp
    old = torchfit.MAX_REVERSE_ELEMENTS
    try:
        torchfit.MAX_REVERSE_ELEMENTS = limit - 1
        assert torchfit.try_fit(eng, tree) is None
        torchfit.MAX_REVERSE_ELEMENTS = limit
        assert torchfit.try_fit(eng, tree) is not None
    finally:
        torchfit.MAX_REVERSE_ELEMENTS = old


@pytest.mark.parametrize("model_str", ["K3Pu+R3", "TIM2+G"])
@pytest.mark.parametrize("epsilon,tol", [
    # float32, as ModelFinder screens: the two objectives round apart, so
    # the 8 steps end apart (measured 0.047 and 0.021; torch.optim.LBFGS
    # ended 12.6 and 0.87 away)
    (0.1, 0.05),
    # float64: the same steps (measured 3.5e-9 and 7.2e-10)
    (0.01, 1e-6)])
def test_screen_takes_the_steps_of_jax(model_str, epsilon, tol):
    """An 8-iteration fit, ModelFinder's screen, from the same start on the
    reference tree: the port's transcription of optax.lbfgs() against
    jaxfit's optax.lbfgs()."""
    nwk = (GOLDEN / "ref_tree.nwk").read_text()
    out = []
    for fit, read, bm, tree_of, eng_of in (
            (torchfit.try_fit, read_alignment, build_model, Tree.from_newick,
             lambda a, m, r: LikelihoodEngine(a, m, r, dtype=torch.float64,
                                              device="cpu")),
            (jaxfit.try_fit, jread_alignment, jbuild_model, JTree.from_newick,
             lambda a, m, r: jengine.LikelihoodEngine(a, m, r,
                                                      dtype=jnp.float64))):
        aln = read(str(GOLDEN / "example.phy"))
        model, rates, _ = bm(model_str, aln)
        out.append(fit(eng_of(aln, model, rates), tree_of(nwk, aln.names),
                       epsilon=epsilon, max_iters=8))
    assert out[0] == pytest.approx(out[1], abs=tol)


def _alternation(monkeypatch, prec: str, model_str: str):
    """(port, JAX) logLs of the host alternation (both joint fits declined
    by a zero size guard) on a 24 x 1000 GTR+G4 simulation."""
    from iqtree2_tpu.model.optimize import optimize_model_parameters as jopt
    from iqtree2_tpu_torch.model.optimize import optimize_model_parameters
    from tests.torch_parity import simulate_both
    monkeypatch.setattr(torchfit, "MAX_REVERSE_ELEMENTS", 0)
    monkeypatch.setattr(jaxfit, "MAX_REVERSE_ELEMENTS", 0)
    (aln, tree, _, _), (jaln, jtree, _, _) = simulate_both("GTR+G4", 24,
                                                           1000, 5)
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "f64": (torch.float64, jnp.float64)}[prec]
    model, rates, _ = build_model(model_str, aln)
    lt = optimize_model_parameters(
        LikelihoodEngine(aln, model, rates, dtype=tdt, device="cpu"), tree)
    jmodel, jrates, _ = jbuild_model(model_str, jaln)
    lj = jopt(jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jdt),
              jtree)
    return lt, lj


@pytest.mark.parametrize("prec,model_str,tol", [
    # the same code on the same objective to rounding: +G takes the same
    # steps (measured 7e-11); +R4's finite differences part a little
    # (measured 0.0093), both about 0.9 short of the joint fit
    ("f64", "GTR+G", 1e-6), ("f64", "GTR+R4", 0.05)])
def test_alternation_matches_jax(monkeypatch, prec, model_str, tol):
    """The host alternation (L-BFGS-B on finite differences <-> Newton),
    which fits problems above the joint fit's size guard, in both
    packages."""
    lt, lj = _alternation(monkeypatch, prec, model_str)
    assert lt == pytest.approx(lj, abs=tol)


def test_float32_alternation_stops_no_shorter_than_jax(monkeypatch):
    """In float32 the JAX package's alternation stops short of the
    converged fit (finite differences of a float32 logL); the port's
    evaluates its objective on the engine's float64 view (measured: port
    0.0008, JAX 2.62 below the float64 joint fit, -8927.6877): the port
    must not stop shorter than the JAX package (tolerance 0.5 logL)."""
    lt, lj = _alternation(monkeypatch, "f32", "GTR+G")
    assert lt >= lj - 0.5
