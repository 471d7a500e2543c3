"""The port's ModelFinder (iqtree2_tpu_torch/modelfinder.py) against the JAX
package's, and -m WHTEST through the port's command line.

Each side is built by its own package from the same site matrix
(tests/torch_parity.py); both run in float32, as ModelFinder runs, on the
CPU with one torch thread. Both fit with optax's L-BFGS and zoom line
search (the port's transcription in utils/lbfgs.py), a screening fit
stopped after 8 iterations, a refit after 25; float32 rounding differs
between the two objectives, so logLs agree to a tolerance.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from iqtree2_tpu import modelfinder as jmf
from iqtree2_tpu import whtest as jwhtest
from iqtree2_tpu.io.alignment_io import read_alignment as jread_alignment
from iqtree2_tpu.ops import pars as jpars
from iqtree2_tpu.params import Params as JParams
from iqtree2_tpu_torch import cli, kernelcheck
from iqtree2_tpu_torch import modelfinder as mf
from iqtree2_tpu_torch.io.alignment_io import read_alignment as \
    mf_read_alignment
from iqtree2_tpu_torch.io.alignment_io import write_phylip
from iqtree2_tpu_torch.ops import pars
from iqtree2_tpu_torch.params import Params
from iqtree2_tpu_torch.utils.checkpoint import Checkpoint
from tests.torch_parity import jax_alignment

# logL tolerance of every candidate, refit or screened. Measured on these
# problems: at most 0.063 (GTR+R3, refit), screened entries at most 0.0084
LOGL_TOL = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(model_name: str, ntaxa: int, nsites: int, seed: int):
    aln = kernelcheck.simulate(model_name, ntaxa, nsites, seed)[0]
    return aln, jax_alignment(aln)


@pytest.fixture(scope="module")
def dna():
    return _problem("GTR+G4", 8, 300, seed=4)


@pytest.fixture(scope="module")
def protein():
    return _problem("LG+G4", 8, 200, seed=4)


def _both(aln, jaln, **kw) -> tuple[dict, dict]:
    """run_modelfinder of both packages with the same parameters."""
    res = mf.run_modelfinder(aln, Params(**kw), log=lambda s: None,
                             device="cpu")
    jres = jmf.run_modelfinder(jaln, JParams(**kw), log=lambda s: None)
    return res, jres


def _assert_same_selection(res, jres):
    """Same winner, names and df; logLs within LOGL_TOL, and the scores
    apart by what the logLs are apart."""
    assert res["best"] == jres["best"]
    rows = {e["name"]: e for e in res["table"]}
    jrows = {e["name"]: e for e in jres["table"]}
    assert rows.keys() == jrows.keys()
    for je in jres["table"]:
        e = rows[je["name"]]
        assert e["df"] == je["df"], je["name"]
        assert e["logL"] == pytest.approx(je["logL"], abs=LOGL_TOL), \
            je["name"]
        for k in ("AIC", "BIC"):
            assert e[k] - je[k] == pytest.approx(-2 * (e["logL"]
                                                       - je["logL"]))


@pytest.mark.parametrize("mode", ["MFP", "TEST", "MF", "TESTONLY", "AUTO"])
def test_candidate_lists_match_jax(dna, protein, mode):
    for aln, jaln in (dna, protein):
        assert mf.candidate_bases(aln) == jmf.candidate_bases(jaln)
        assert mf.candidate_models(aln, mode) == \
            jmf.candidate_models(jaln, mode)
    for k in (2, 4, 10):
        assert mf.rate_schemes(mode, k) == jmf.rate_schemes(mode, k)


def test_information_scores_match_jax():
    for logL, df, n in ((-21164.156, 40, 1998), (-100.0, 30, 31),
                        (-5.0, 3, 3)):
        assert mf.information_scores(logL, df, n) == \
            jmf.information_scores(logL, df, n)


@pytest.mark.parametrize("which", ["dna", "protein"])
def test_selection_tree_matches_jax(which, request):
    """The parsimony tree both packages select on (params.seed)."""
    aln, jaln = request.getfixturevalue(which)
    seed = Params().seed
    assert pars.random_stepwise_addition(
        aln, np.random.default_rng(seed)).to_newick(digits=17) == \
        jpars.random_stepwise_addition(
            jaln, np.random.default_rng(seed)).to_newick(digits=17)


def test_example_candidates_match_jax():
    """example.phy under -m MFP -mset HKY,K3Pu,TIM2 -cmax 6: the lazy +Rk
    expansion stops each base where the JAX package's does, so both list
    the same candidates (with torch.optim.LBFGS screens the port also
    listed HKY+R5)."""
    golden = str(Path(__file__).parent / "golden" / "example.phy")
    aln = mf_read_alignment(golden)
    res, jres = _both(aln, jread_alignment(golden), model="MFP",
                      mset="HKY,K3Pu,TIM2", cmax=6)
    assert [e["name"] for e in res["table"]] and \
        sorted(e["name"] for e in res["table"]) == \
        sorted(e["name"] for e in jres["table"])
    assert {"HKY+R4", "K3Pu+R4", "TIM2+R4"} <= {e["name"]
                                              for e in res["table"]}
    _assert_same_selection(res, jres)


def test_testonly_dna_matches_jax(dna):
    res, jres = _both(*dna, model="TESTONLY", mset="JC,HKY,GTR",
                      mrate="E,G,R", cmax=3)
    assert len(res["table"]) == 12
    _assert_same_selection(res, jres)
    assert set(res["seconds"]) == {"screen", "refit", "+R", "final refit"}


def test_testonly_protein_matches_jax(protein):
    """The +F bases: LG, LG+F, WAG, WAG+F, each with and without +G."""
    res, jres = _both(*protein, model="TESTONLY", mset="LG,WAG",
                      mrate="E,G")
    assert sorted(e["name"] for e in res["table"]) == sorted(
        f"{b}{f}{r}" for b in ("LG", "WAG") for f in ("", "+F")
        for r in ("", "+G"))
    _assert_same_selection(res, jres)


def test_auto_ordering_matches_jax(dna):
    """-m AUTO: every rate scheme on the first base, then each other base
    bare and with the best scheme (reference main/phylotesting.cpp:1347)."""
    res, jres = _both(*dna, model="AUTO", mset="JC,HKY,GTR", mrate="E,G,R")
    names = [e["name"] for e in sorted(res["table"], key=lambda e: (
        ["JC", "HKY", "GTR"].index(e["name"].split("+")[0]),
        e["name"]))]
    first = [n for n in names if n.split("+")[0] == "JC"]
    assert sorted(first) == sorted(
        ["JC", "JC+G"] + [f"JC+R{k}" for k in range(2, 6)])
    best_rate = min((e for e in res["table"] if e["name"] in first),
                    key=lambda e: e["BIC"])["name"][2:]
    assert set(names) - set(first) == {
        b + r for b in ("HKY", "GTR") for r in ("", best_rate)}
    _assert_same_selection(res, jres)


@pytest.mark.parametrize("mset,mrate,names", [
    ("JC,K2P", "E,G", {"JC", "JC+G", "K2P", "K2P+G"}),
    ("HKY", "I,I+G", {"HKY+I", "HKY+I+G"}),
    ("jc", "G+I", {"JC+I+G"}),
])
def test_mset_mrate_restrict_candidates(dna, mset, mrate, names):
    """-mset/-mrate restrict the grid (the analog of
    tests/test_kmeans_merge.py's test of the JAX package)."""
    res = mf.run_modelfinder(dna[0], Params(model="TESTONLY", mset=mset,
                                            mrate=mrate),
                             log=lambda s: None, device="cpu")
    assert {e["name"] for e in res["table"]} == names


@pytest.mark.parametrize("mset,mrate,message", [
    ("LG,WAG", "", "no matching models for DNA"),
    ("", "E,X", "unknown scheme"),
])
def test_mset_mrate_errors(dna, mset, mrate, message):
    with pytest.raises(ValueError, match=message):
        mf.run_modelfinder(dna[0], Params(model="TESTONLY", mset=mset,
                                          mrate=mrate),
                           log=lambda s: None, device="cpu")


def test_checkpoint_resume_fits_nothing(dna, tmp_path, monkeypatch):
    """A second run over a finished ModelFinder struct returns the same
    selection without a fit: screened fits are checkpointed too."""
    params = Params(model="TESTONLY", mset="HKY,GTR", mrate="E,G,R", cmax=3)
    path = tmp_path / "r.ckp.gz"
    first = mf.run_modelfinder(dna[0], params, log=lambda s: None,
                               ckp=Checkpoint(path), device="cpu")

    def no_fit(*args, **kw):
        raise AssertionError("a resumed ModelFinder run fitted a model")

    monkeypatch.setattr(mf, "optimize_model_parameters", no_fit)
    ckp = Checkpoint(path)
    assert ckp.load()
    again = mf.run_modelfinder(dna[0], params, log=lambda s: None, ckp=ckp,
                               device="cpu")
    assert again["best"] == first["best"]
    assert again["table"] == first["table"]


def test_whtest_statistic_matches_jax(dna, tmp_path):
    """-m WHTEST through the port's command line (a GTR+G fit on a fixed
    tree, then the test): the statistic equals the JAX package's on the
    same file, and the p-value is a fraction of the 100 simulations."""
    aln_path = str(tmp_path / "a.phy")
    write_phylip(dna[0], aln_path)
    tree = kernelcheck.simulate("GTR+G4", 8, 300, seed=4)[1]
    (tmp_path / "t.nwk").write_text(tree.to_newick() + "\n")
    prefix = tmp_path / "w"
    assert cli.main(["-s", aln_path, "-m", "WHTEST", "-te",
                     str(tmp_path / "t.nwk"), "--device", "cpu",
                     "-pre", str(prefix), "--quiet"]) == 0
    text = Path(f"{prefix}.whtest").read_text()
    stat = float(re.search(r"statistic: (\S+)", text).group(1))
    assert stat == jwhtest.wh_statistic(jread_alignment(aln_path))
    p = float(re.search(r"p-value: (\S+)", text).group(1))
    assert 0.0 < p <= 1.0
    assert "simulations: 100" in text
    assert "Log-likelihood of the tree" in \
        Path(f"{prefix}.iqtree").read_text()
