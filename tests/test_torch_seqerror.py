"""+E sequencing error (model/seqerror.py: +E, +EA, +EC, +EG, +ET) against
the JAX package's, float64 on the CPU: the tip rows (bit for bit), the
log-likelihood at a fixed epsilon (1e-9 relative), epsilon fitted by the
host alternation (the joint fit declines the model in both packages), the
float64 view's tips following epsilon, and the refusals: +E beside a
codon, mixture or YAML model (C16: the JAX package ignores the term
there) and +E on protein data (the JAX package's ValueError).
"""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu.engine import LikelihoodEngine as JEngine
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.model.optimize import \
    optimize_model_parameters as jopt_model
from iqtree2_tpu_torch import cli, kernelcheck
from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io import yamlmodels
from iqtree2_tpu_torch.model import torchfit
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.optimize import optimize_model_parameters
from iqtree2_tpu_torch.model.pack import build_model_pack
from tests.torch_parity import jax_alignment, simulate_both

KINDS = ("E", "EA", "EC", "EG", "ET")
FIXED = "HKY{3.0}+F{0.3,0.2,0.2,0.3}+%s{0.02}+G{0.6}"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """10 taxa x 300 sites under HKY+G4 with gaps and ambiguity codes in
    the tips (the error model reshapes every code's row)."""
    (aln, tree, _, _), (jaln, jtree, _, _) = simulate_both(
        "HKY+E+G4", 10, 300, seed=4)
    rng = np.random.default_rng(4)
    mat = aln.expand_to_sites().copy()
    mat[rng.random(mat.shape) < 0.05] = 14          # N
    mat[rng.random(mat.shape) < 0.03] = 4           # R
    aln = Alignment.from_site_matrix(aln.names, mat, aln.seqtype)
    return aln, tree, jax_alignment(aln), jtree


@pytest.mark.parametrize("kind", KINDS)
def test_tip_rows_match_jax(kind, problem):
    aln, _, jaln, _ = problem
    model, rates, extras = build_model(FIXED % kind, aln)
    jmodel, jrates, jextras = jbuild_model(FIXED % kind, jaln)
    assert extras["seqerr"] == jextras["seqerr"] == kind
    assert model.name == jmodel.name
    np.testing.assert_array_equal(
        model.transform_tip_table(aln.seqtype.tip_table),
        jmodel.transform_tip_table(jaln.seqtype.tip_table))
    assert not torchfit.build_spec(model, rates)
    pk = build_model_pack(aln, model, rates)
    assert ((pk.tip_table > 0) & (pk.tip_table < 1)).any()


@pytest.mark.parametrize("kind", KINDS)
def test_seqerror_loglik_matches_jax(kind, problem):
    aln, tree, jaln, jtree = problem
    model, rates, _ = build_model(FIXED % kind, aln)
    jmodel, jrates, _ = jbuild_model(FIXED % kind, jaln)
    got = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu").loglik_tree(tree)
    want = JEngine(jaln, jmodel, jrates, dtype=jnp.float64).loglik_tree(jtree)
    assert math.isclose(got, want, rel_tol=1e-9), (got, want)


def test_epsilon_fit_matches_jax(problem):
    """HKY+E+G fitted on the fixed tree by both host alternations: kappa,
    epsilon and alpha within 1e-4 relative, the logL within 1e-8."""
    aln, tree, jaln, jtree = problem
    model, rates, _ = build_model("HKY+E+G", aln)
    jmodel, jrates, _ = jbuild_model("HKY+E+G", jaln)
    got = optimize_model_parameters(
        LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                         device="cpu"), tree)
    want = jopt_model(JEngine(jaln, jmodel, jrates, dtype=jnp.float64),
                      jtree)
    assert math.isclose(got, want, rel_tol=1e-8), (got, want)
    assert model.epsilon != 0.05
    np.testing.assert_allclose(model.get_params(), jmodel.get_params(),
                               rtol=1e-4)
    np.testing.assert_allclose(rates.get_params(), jrates.get_params(),
                               rtol=1e-4)


def test_precise_view_follows_epsilon(problem):
    """A float32 engine's float64 view rebuilds its tip partials when
    epsilon moves and only the view is refreshed (the alternation's
    objectives), and the engine's own follow on its refresh."""
    aln, tree, _, _ = problem
    model, rates, _ = build_model("HKY{3.0}+E+G{0.6}", aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                           device="cpu")
    view = eng.precise()
    tips32 = eng._tipP.clone()
    model.set_params(np.array([3.0, 0.2]))
    view.refresh_model()
    fresh = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                             device="cpu")
    assert torch.equal(view._tipP, fresh._tipP)
    assert view.loglik_tree(tree) == fresh.loglik_tree(tree)
    assert torch.equal(eng._tipP, tips32)
    eng.refresh_model()
    assert torch.equal(eng._tipP, fresh._tipP.float())


def test_seqerror_refusals(tmp_path):
    """C16: +E beside a codon, mixture (MIX{...} too) or YAML model stops
    (the JAX package fits the model without the error term); on protein
    data the JAX package's ValueError."""
    cds, _, _, _ = kernelcheck.simulate("GY+F3X4+G4", 4, 10, seed=1)
    aa, _, _, _ = kernelcheck.simulate("LG+G4", 4, 20, seed=1)
    dna, _, _, _ = kernelcheck.simulate("GTR+G4", 4, 20, seed=1)
    yamlmodels.define("- model: MYGTR\n  datatype: DNA\n"
                      "  rates: [1.5, 4.0, 1.2, 0.8, 5.0, 1.0]\n"
                      "  frequencies: [0.3, 0.2, 0.2, 0.3]\n")
    for spec, aln, what in (("GY+F3X4+E", cds, "a codon model"),
                            ("KOSI07+EA", cds, "a codon model"),
                            ("LG+C20+E+G", aa, "a mixture"),
                            ("MIX{LG,WAG}+E+G", aa, "a mixture"),
                            ("MIX{HKY,GTR}+ET", dna, "a mixture"),
                            ("MYGTR+E", dna, "a YAML model")):
        with pytest.raises(SystemExit, match=f"with {what} is ignored"):
            build_model(spec, aln)
    with pytest.raises(ValueError, match="requires DNA data"):
        build_model("LG+E", aa)


def test_seqerror_command_line(tmp_path):
    """-m HKY+E+G -te through the CLI: epsilon in the report; +E{0.01}
    keeps it fixed."""
    aln, tree, _, _ = kernelcheck.simulate("HKY+E+G4", 8, 200, seed=6)
    phy, nwk = kernelcheck.write_problem(aln, tree, tmp_path / "d")
    for model, fixed in (("HKY+E+G", False), ("HKY+E{0.01}+G", True)):
        pre = tmp_path / model.replace("+", "").replace("{", "") \
            .replace("}", "")
        assert cli.main(["-s", phy, "-m", model, "-te", nwk, "--device",
                         "cpu", "-pre", str(pre), "--quiet"]) == 0
        text = Path(f"{pre}.iqtree").read_text()
        eps = float(text.split("(epsilon): ")[1].split()[0])
        assert "Model of substitution: HKY+E+F+G4" in text
        assert (eps == 0.01) == fixed and 1e-4 <= eps <= 0.5
