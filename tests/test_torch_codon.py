"""The codon models (model/codon.py: GY, MG, MGK, GY1KTS, GY1KTV, GY2K
under F, F1X4, F3X4, FQ and the default; KOSI07, ECMREST, SCHN05 with
their published frequencies, +F or +FQ) against the JAX package's, float64
on the CPU: the log-likelihood at fixed parameters (1e-9 relative), the
candidate list ModelFinder gives codon and binary data, the MK model of
codon data (C15: GY94 under another name, as in the JAX package), and one
round of the host alternation (kappa, omega, the Gamma shape and the
branch lengths; the JAX codon fit runs minutes, so parity is held at one
round on a tiny problem); then the codon command lines of the port.

Each side builds its model from the same model string on its own
package's alignment of the same simulated codons (tests/torch_parity.py).
"""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import modelfinder as jmodelfinder
from iqtree2_tpu.engine import LikelihoodEngine as JEngine
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.model.optimize import \
    optimize_model_parameters as jopt_model
from iqtree2_tpu_torch import cli, kernelcheck, modelfinder
from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model.codon import CodonModel
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.optimize import optimize_model_parameters
from tests.torch_parity import jax_alignment, simulate_both

NAMES = ("GY", "MG", "MGK", "GY1KTS", "GY1KTV", "GY2K")
FREQS = ("", "+F", "+F1X4", "+F3X4", "+FQ")
EMPIRICAL = ("KOSI07", "ECMREST", "SCHN05")
EMPIRICAL_FREQS = ("", "+F", "+FQ")
MODEL_STRINGS = ([f"{n}{{2.0,0.3}}{f}+G{{0.8}}" for n in NAMES
                  for f in FREQS]
                 + [f"{n}{f}+G{{0.8}}" for n in EMPIRICAL
                    for f in EMPIRICAL_FREQS])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """6 taxa x 40 codons simulated under GY+F3X4+G4, on both sides."""
    return simulate_both("GY+F3X4+G4", 6, 40, seed=3)


@pytest.mark.parametrize("model_str", MODEL_STRINGS)
def test_codon_loglik_matches_jax(model_str, problem):
    (aln, tree, _, _), (jaln, jtree, _, _) = problem
    model, rates, _ = build_model(model_str, aln)
    jmodel, jrates, _ = jbuild_model(model_str, jaln)
    assert (type(model).__name__, model.name) == \
        (type(jmodel).__name__, jmodel.name)
    np.testing.assert_array_equal(model.freqs, jmodel.freqs)
    got = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu").loglik_tree(tree)
    want = JEngine(jaln, jmodel, jrates, dtype=jnp.float64).loglik_tree(jtree)
    assert math.isclose(got, want, rel_tol=1e-9), (got, want)


def test_modelfinder_candidates_match_jax(problem):
    """Codon data: MK (C15) times the rate schemes; binary data: JC2."""
    (aln, _, _, _), (jaln, _, _, _) = problem
    bin_aln = Alignment.from_sequences(["a", "b", "c"],
                                       ["0101", "0011", "1110"],
                                       seqtype="BIN")
    for a, ja in ((aln, jaln), (bin_aln, jax_alignment(bin_aln))):
        for mode in ("MFP", "TESTONLY"):
            got = modelfinder.candidate_models(a, mode)
            assert got == jmodelfinder.candidate_models(ja, mode)
    assert set(modelfinder.candidate_bases(aln)) == {"MK"}
    assert set(modelfinder.candidate_bases(bin_aln)) == {"JC2"}


def test_mk_on_codon_data_is_gy94(problem):
    """C15: MK on codon data builds the codon model under the name MK
    (GY94 with F3X4), in both packages, with GY+F3X4's eigensystem."""
    (aln, _, _, _), (jaln, _, _, _) = problem
    mk, _, _ = build_model("MK+G4", aln)
    jmk, _, _ = jbuild_model("MK+G4", jaln)
    gy, _, _ = build_model("GY+F3X4+G4", aln)
    assert isinstance(mk, CodonModel) and mk.name == jmk.name == "MK"
    assert not mk._mg and mk.freq_mode == "F3X4"
    a, b, c = (m.get_eigensystem() for m in (mk, jmk, gy))
    np.testing.assert_array_equal(a.eigvals, b.eigvals)
    np.testing.assert_array_equal(a.U, b.U)
    np.testing.assert_array_equal(a.eigvals, c.eigvals)


def test_codon_alternation_round_matches_jax():
    """One round of the host alternation (L-BFGS-B over kappa, omega and
    the Gamma shape, then the branch Newton) on 5 x 40 codons: the same
    parameters (1e-6 relative) and logL (1e-8 relative)."""
    (aln, tree, _, _), (jaln, jtree, _, _) = simulate_both(
        "GY+F3X4+G4", 5, 40, seed=2)
    model, rates, _ = build_model("GY+F3X4+G", aln)
    jmodel, jrates, _ = jbuild_model("GY+F3X4+G", jaln)
    got = optimize_model_parameters(
        LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                         device="cpu"), tree, max_rounds=1)
    want = jopt_model(JEngine(jaln, jmodel, jrates, dtype=jnp.float64),
                      jtree, max_rounds=1)
    assert math.isclose(got, want, rel_tol=1e-8), (got, want)
    np.testing.assert_allclose(model.get_params(), jmodel.get_params(),
                               rtol=1e-6)
    np.testing.assert_allclose(rates.get_params(), jrates.get_params(),
                               rtol=1e-6)
    assert tree.total_length() == pytest.approx(jtree.total_length(),
                                                rel=1e-6)


def _report(prefix) -> str:
    return Path(f"{prefix}.iqtree").read_text()


def test_codon_command_lines(tmp_path):
    """-st CODON through the port's CLI: a -te fit whose report gives kappa
    and omega and whose logL is the port's own fit's; KOSI07+F+G; the
    default command (ModelFinder over MK's rate schemes, then the search
    under the winner) with -B."""
    aln, tree, _, _ = kernelcheck.simulate("GY+F3X4+G4", 8, 60, seed=5)
    phy, nwk = kernelcheck.write_problem(aln, tree, tmp_path / "cds")
    base = ["-s", phy, "-st", "CODON", "--device", "cpu", "--quiet"]
    pre = tmp_path / "gy"
    assert cli.main(base + ["-m", "GY+F3X4+G", "-te", nwk, "--f64", "-pre",
                            str(pre)]) == 0
    text = _report(pre)
    kappa = float(text.split("(kappa): ")[1].split()[0])
    omega = float(text.split("(omega): ")[1].split()[0])
    model, rates, _ = build_model("GY+F3X4+G", aln)
    logl = optimize_model_parameters(
        LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                         device="cpu"), tree)
    assert f"Log-likelihood of the tree: {logl:.4f}" in text
    assert (kappa, omega) == (round(model.kappa, 4), round(model.omega, 4))
    pre = tmp_path / "kosi"
    assert cli.main(base + ["-m", "KOSI07+F+G", "-te", nwk, "-pre",
                            str(pre)]) == 0
    assert "KOSI07+F+G4" in _report(pre)
    pre = tmp_path / "mfp"
    assert cli.main(base + ["-mrate", "E,G", "-B", "100", "-n", "1",
                            "-ninit", "3", "-ntop", "2", "-nbest", "1",
                            "-pre", str(pre)]) == 0
    text = _report(pre)
    assert "Best-fit model" in Path(f"{pre}.log").read_text()
    assert "Model of substitution: MK+F" in text
    assert len(Path(f"{pre}.ufboot").read_text().splitlines()) == 100


def test_binary_modelfinder_fits(tmp_path):
    """Binary data: ModelFinder fits JC2 under each rate scheme (the JAX
    package's candidates) and the run selects one of them."""
    aln, tree, _, _ = kernelcheck.simulate("JC2+G4", 8, 200, seed=4)
    phy, _ = kernelcheck.write_problem(aln, tree, tmp_path / "bin")
    pre = tmp_path / "bin"
    assert cli.main(["-s", phy, "-st", "BIN", "-m", "MF", "-mrate", "E,G",
                     "--device", "cpu", "-pre", str(pre), "--quiet"]) == 0
    text = _report(pre)
    assert "JC2+G" in text and "JC2 " in text
