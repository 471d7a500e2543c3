"""Port's LikelihoodEngine and model fit vs the JAX package's, float64, CPU.

The same problem (numpy seeds or the golden files) is built on each side by
its own package (tests/torch_parity.py) and goes through that package's
engine; the golden model fit compares the two host alternations (both
packages' joint fits patched to return None); the joint fits are compared
in tests/test_torch_fit.py.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.io.alignment_io import read_alignment as jread_alignment
from iqtree2_tpu.model import jaxfit
from iqtree2_tpu.model import optimize as jopt
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import kernelcheck
from iqtree2_tpu_torch.engine import LikelihoodEngine, optimize_blens
from iqtree2_tpu_torch.io.alignment_io import read_alignment
from iqtree2_tpu_torch.model import optimize as topt
from iqtree2_tpu_torch.model import torchfit
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.subst import GTRModel
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


def _problem(seed, ntaxa=16, nsites=300, model_name="GTR+G4"):
    """(port alignment, port tree, JAX alignment, JAX tree, model string)
    of one simulated problem."""
    aln, tree, _, _ = kernelcheck.simulate(model_name, ntaxa, nsites, seed)
    tree, jtree = both_trees(tree, aln.names)
    return aln, tree, jax_alignment(aln), jtree, \
        kernelcheck.MODELS[model_name][2]


def test_optimize_branches_matches_jax():
    aln, tree, jaln, jtree, model_str = _problem(seed=3)
    jmodel, jrates, _ = jbuild_model(model_str, jaln)
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    jsched = jbuild_schedule(jtree)
    # start far from the optimum so every round moves
    blens = np.maximum(jsched.blens * np.linspace(0.3, 3.0,
                                                  len(jsched.blens)), 1e-6)
    sa = jeng.schedule_arrays(jsched)
    jb, jl = jengine._optimize_blens_jit(
        jnp.asarray(blens), jeng._dev_tipP, sa, jeng._dev_pack, jeng._dev_pw,
        jnp.asarray(1e-6), jnp.asarray(10.0), n_rounds=10, n_newton=4,
        force_xla=True)
    model, rates, _ = build_model(model_str, aln)
    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    sched = build_schedule(tree)
    np.testing.assert_array_equal(sched.blens, jsched.blens)
    tb, tl = optimize_blens(
        torch.as_tensor(blens), teng._tipP, teng.schedule_arrays(sched),
        teng._pack, teng._pw, 1e-6, 10.0, 10, 4)
    assert tl == pytest.approx(float(jl), abs=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)
    assert tl > float(jengine.pruning.tree_loglik(
        jnp.asarray(blens), jeng._dev_tipP, sa, jeng._dev_pack,
        jeng._dev_pw, force_xla=True)[0]) + 1.0


@pytest.mark.parametrize("asc", [False, True])
def test_engine_api_matches_jax(asc):
    aln, tree, jaln, jtree, model_str = _problem(seed=11, ntaxa=12,
                                                 nsites=200)
    jmodel, jrates, _ = jbuild_model(model_str, jaln)
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64,
                                    asc=asc)
    model, rates, _ = build_model(model_str, aln)
    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu", asc=asc)
    assert teng.Pp == jeng.Pp
    np.testing.assert_array_equal(teng.tip_codes, jeng.tip_codes)
    assert teng.loglik_tree(tree) == pytest.approx(jeng.loglik_tree(jtree),
                                                   rel=1e-9)
    tl, tlp = teng.site_lp(tree)
    jl, jlp = jeng.site_lp(jtree)
    assert tl == pytest.approx(jl, rel=1e-9)
    np.testing.assert_allclose(tlp, jlp, rtol=1e-9)
    w = np.random.default_rng(0).integers(0, 3, aln.num_patterns)
    assert teng.with_pattern_weights(w).loglik_tree(tree) == pytest.approx(
        jeng.with_pattern_weights(w).loglik_tree(jtree), rel=1e-9)
    tdp, tup, tlg = teng.compute_passes(build_schedule(tree))
    jdp, jup, jlg = jeng.compute_passes(jbuild_schedule(jtree))
    assert float(tlg) == pytest.approx(float(jlg), rel=1e-9)
    np.testing.assert_allclose(tup.edge_E.numpy(), np.asarray(jup.edge_E),
                               rtol=1e-9)
    t2, j2 = tree.copy(), jtree.copy()
    lt = teng.optimize_branches(t2, n_rounds=4)
    lj = jeng.optimize_branches(j2, n_rounds=4)
    assert lt == pytest.approx(lj, abs=1e-6)
    assert t2.to_newick() == j2.to_newick()


class _Nonreversible(GTRModel):
    """A port model whose eigensystem carries a rate matrix Q, as the
    nonreversible models of the JAX package do."""

    Q = None

    def get_eigensystem(self):
        eig = super().get_eigensystem()
        eig.Q = (np.zeros((self.num_states, self.num_states))
                 if self.Q is None else self.Q)[None]
        return eig


def test_nonreversible_model_is_refused():
    """A pack with Q takes the nonreversible path (the direct Newton); what
    is still refused is +E beside UNREST, which the JAX package ignores
    (its UNREST branch returns before the +E wrapper, ROADMAP C16)."""
    aln, tree, _, _, _ = _problem(seed=1, ntaxa=6, nsites=50)
    with pytest.raises(SystemExit, match="sequencing-error"):
        build_model("UNREST+E", aln)
    model, rates, _ = build_model("GTR", aln)
    eig = model.get_eigensystem()
    # the GTR's own rate matrix as Q: the direct path's logL and Newton
    # give the eigenbasis path's
    Q = (eig.U[0] * eig.eigvals[0]) @ eig.V[0]
    nonrev = _Nonreversible(4, freqs=model.freqs)
    nonrev.Q = Q
    teng = LikelihoodEngine(aln, nonrev, rates, dtype=torch.float64,
                            device="cpu")
    reng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    assert teng.nonrev and not reng.nonrev
    assert teng.loglik_tree(tree) == pytest.approx(reng.loglik_tree(tree),
                                                   rel=1e-12)
    t1, t2 = tree.copy(), tree.copy()
    assert teng.optimize_branches(t1) == pytest.approx(
        reng.optimize_branches(t2), abs=1e-6)


def test_optimize_rate_scalar_matches_jax():
    aln, tree, jaln, jtree, _ = _problem(seed=21, ntaxa=10, nsites=200)
    out = []
    for mod, Eng, dt, bm, a, t in (
            (topt, LikelihoodEngine, torch.float64, build_model, aln, tree),
            (jopt, jengine.LikelihoodEngine, jnp.float64, jbuild_model, jaln,
             jtree)):
        model, rates, _ = bm("HKY+G", a)
        kw = dict(device="cpu") if Eng is LikelihoodEngine else {}
        eng = Eng(a, model, rates, dtype=dt, **kw)
        lo, hi = rates.param_bounds()
        out.append((mod.optimize_rate_scalar(
            eng, t, lambda: rates.alpha,
            lambda v: setattr(rates, "alpha", v), float(lo[0]),
            float(hi[0])), rates.alpha))
    assert out[0][0] == pytest.approx(out[1][0], abs=1e-6)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-6)


def test_model_fit_on_golden_matches_jax_host_loop(monkeypatch):
    golden = json.loads((GOLDEN / "golden.json").read_text())["logL"]
    nwk = (GOLDEN / "ref_tree.nwk").read_text()

    # both packages' host alternation: their joint fits declined
    monkeypatch.setattr(torchfit, "try_fit", lambda *a, **k: None)
    monkeypatch.setattr(jaxfit, "try_fit", lambda *a, **k: None)
    aln = read_alignment(str(GOLDEN / "example.phy"))
    model, rates, _ = build_model("GTR+G", aln)
    teng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                            device="cpu")
    lt = topt.optimize_model_parameters(teng, Tree.from_newick(nwk,
                                                               aln.names))

    jaln = jread_alignment(str(GOLDEN / "example.phy"))
    jmodel, jrates, _ = jbuild_model("GTR+G", jaln)
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    lj = jopt.optimize_model_parameters(jeng, JTree.from_newick(nwk,
                                                                jaln.names))
    assert lt == pytest.approx(golden["g4_gtrg_opt"], abs=0.5)
    assert lt == pytest.approx(lj, abs=0.05)


@pytest.mark.parametrize("change", ["parameters", "model objects"])
def test_float64_view_follows_the_engine(change):
    """LikelihoodEngine.precise(), the float64 view that the fits'
    objectives evaluate, gives the float32 engine's logL (to float32
    rounding) after a parameter change and after the engine is handed
    other model objects, as ModelFinder does when it reuses one engine for
    every candidate."""
    aln, tree, _, _, _ = _problem(seed=4, ntaxa=12, nsites=300)
    model, rates, _ = build_model("GTR+G", aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                           device="cpu")
    view = eng.precise()
    assert view.dtype == torch.float64 and eng.precise() is view
    if change == "parameters":
        rates.alpha = 0.3
    else:
        eng.model, eng.rates, _ = build_model("HKY+R3", aln)
    eng.refresh_model()
    sched = build_schedule(tree)
    assert eng.precise().loglik_sched(sched) == pytest.approx(
        eng.loglik_sched(sched), rel=1e-6)
