"""The port's command line: the golden -te fit, the tree search with UFBoot
and model selection end to end, and the refusals.

python -m iqtree2_tpu_torch runs in a subprocess on the CPU (--device cpu);
every flag whose path is not yet ported must stop the run with a SystemExit
that names it, and --device cuda must fail where there is no card instead
of falling back to the CPU.
"""

import json
import re

import numpy as np
import types
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from iqtree2_tpu import analysis as janalysis
from iqtree2_tpu import engine as jengine
from iqtree2_tpu.io.alignment_io import read_alignment
from iqtree2_tpu.model.factory import build_model
from iqtree2_tpu.tree.topology import Tree
from iqtree2_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
ALN = str(GOLDEN / "example.phy")
TREE = str(GOLDEN / "ref_tree.nwk")
NEX = str(GOLDEN / "example.nex")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per worker: tier-1 runs six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logl(prefix: Path) -> float:
    for line in Path(f"{prefix}.iqtree").read_text().splitlines():
        if line.startswith("Log-likelihood of the tree:"):
            return float(line.split(":")[1].split()[0])
    raise AssertionError("no logL in report")


def _run_module(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "iqtree2_tpu_torch"] + args,
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


def test_golden_fit_through_the_module(tmp_path):
    prefix = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "iqtree2_tpu_torch", "-s", ALN, "-m", "GTR+G",
         "-te", TREE, "--f64", "--device", "cpu", "-pre", str(prefix),
         "--quiet"],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr
    for ext in (".iqtree", ".treefile", ".log", ".ckp.gz"):
        assert Path(f"{prefix}{ext}").stat().st_size > 0, ext
    golden = json.loads((GOLDEN / "golden.json").read_text())["logL"]
    assert _logl(prefix) == pytest.approx(golden["g4_gtrg_opt"], abs=0.5)
    assert "Best logL" in Path(f"{prefix}.log").read_text()


def test_default_precision_golden_fit(tmp_path):
    """The JAX package's bar for its default-precision CLI
    (tests/test_cli_precision.py): the joint fit runs in float64 whatever
    the engine's float32."""
    prefix = tmp_path / "run"
    assert cli.main(["-s", ALN, "-m", "GTR+G", "-te", TREE, "--device",
                     "cpu", "-pre", str(prefix), "--quiet"]) == 0
    assert _logl(prefix) >= -21162.05


def test_search_with_ufboot_through_the_module(tmp_path):
    prefix = tmp_path / "run"
    res = _run_module(["-s", ALN, "-m", "GTR+G", "-bb", "100", "-ninit",
                       "10", "-ntop", "3", "-nbest", "2", "-n", "2",
                       "--device", "cpu", "-pre", str(prefix), "--quiet"])
    assert res.returncode == 0, res.stderr
    for ext in (".iqtree", ".treefile", ".log", ".ckp.gz", ".contree",
                ".splits.nex", ".ufboot"):
        assert Path(f"{prefix}{ext}").stat().st_size > 0, ext
    assert len(Path(f"{prefix}.ufboot").read_text().splitlines()) == 100
    labels = re.findall(r"\)([^:,();]*)",
                        Path(f"{prefix}.treefile").read_text())
    assert labels[-1] == ""       # the root carries no support
    assert all(lab.isdigit() for lab in labels[:-1]), labels
    # the reference topology's fit (golden g4) less 0.5
    assert _logl(prefix) >= -21162.44
    log = Path(f"{prefix}.log").read_text()
    assert "Search done: 2 iterations" in log
    assert "Wall seconds: quick fit" in log


@pytest.mark.parametrize("extra,message", [
    (["-lbp", "1000"], "-lbp: not yet ported"),
    (["--root-test", "-q", str(GOLDEN / "example.nex")],
     "--root-test with -p/-q/-Q"),
    (["-lmap", "100"], "-lmap: not yet ported"),
    (["--gcf", TREE], "--gcf: not yet ported"),
    (["-blmax", "5"], "-blmax: not yet ported"),
])
def test_unported_flag_is_refused(tmp_path, extra, message):
    argv = ["-s", ALN, "-m", "GTR+G", "-te", TREE, "--device", "cpu",
            "-pre", str(tmp_path / "x")] + extra
    with pytest.raises(SystemExit, match=message):
        cli.main(argv)
    assert not (tmp_path / "x.iqtree").exists()


@pytest.mark.parametrize("argv,message", [
    (["-m", "GTR+G", "--gcf", TREE], "--gcf: not yet ported .*ROADMAP C23"),
    (["-m", "GTR+G", "-te", TREE, "-bb", "100"], "-bb/-B: the ultrafast"),
    (["-m", "GTR+G", "-blfix"], "-blfix: fixes the branch lengths"),
    (["-te", TREE, "-m", "GTR+G", "--scf", "10"],
     "--scf: not yet ported .*ROADMAP C23"),
    (["-m", "GTR+G", "-t", TREE], "-t: not yet ported"),
    (["-te", TREE, "-m", "GTR+G", "-blmin", "1e-5"],
     "-blmin: not yet ported"),
    (["-m", "GTR+G", "-bnni"], "-bnni: works on the ultrafast bootstrap"),
    (["-te", TREE, "-m", "GTR+G", "--tbe"],
     "--tbe: works on the ultrafast bootstrap"),
    (["-te", TREE, "-m", "UNREST+E"], "with a nonreversible model"),
    # +E runs on DNA models; beside a mixture the JAX package ignores it
    (["-te", TREE, "-m", "MIX{HKY,GTR}+E"], "sequencing-error"),
])
def test_unported_path_is_refused(tmp_path, argv, message):
    """Paths the port does not run, and flags that need another (-bnni and
    --tbe act on -bb's replicate trees), stop before any work."""
    with pytest.raises(SystemExit, match=message):
        cli.main(["-s", ALN, "--device", "cpu", "-pre", str(tmp_path / "x"),
                  "--quiet"] + argv)


@pytest.mark.parametrize("argv,message", [
    (["-p", NEX, "-asr"], "-asr with -p/-q/-Q"),
    (["-q", NEX, "-z", TREE], "-z with -p/-q/-Q"),
    (["-p", NEX, "-b", "10"], "-b with -p/-q/-Q"),
    (["-Q", NEX, "-g", TREE], "-g with -p/-q/-Q"),
    (["-p", NEX, "--runs", "2"], "--runs with -p/-q/-Q"),
    (["-p", NEX, "-wsl"], "-wsl with -p/-q/-Q"),
    (["-p", NEX, "-o", "Frog"], "-o with -p/-q/-Q"),
    (["-S", NEX, "-B", "100", "-bsam", "GENE"], "-bsam/--sampling with -S"),
    (["-p", NEX, "-m", "WHTEST"], "-m WHTEST: not a model selection mode"),
    (["-te", TREE, "-g", TREE], "-g: constrains the tree search"),
    (["-te", TREE, "-m", "MF+MERGE"], r"-m MF\+MERGE: partition merging"),
    (["-B", "100", "-bsam", "GENE"], "-bsam GENE: resamples partitions"),
    (["-p", NEX, "--merge", "kmeans"], "--merge: chooses the partition"),
    (["-p", NEX, "--symtest-pval", "0.1"], "--symtest-pval: is the cutoff"),
])
def test_flag_the_path_would_ignore_is_refused(tmp_path, argv, message):
    """With partitions (-p/-q/-Q), each flag the JAX package's partition
    path accepts and never reads (ROADMAP C8) stops the run, and so do the
    other flags that would be ignored: -bsam with -S (the JAX package's
    own refusal), -g with a fixed -te tree, a merge or a partition
    resampling unit without partitions."""
    with pytest.raises(SystemExit, match=message):
        cli.main(["-s", ALN, "--device", "cpu", "-pre", str(tmp_path / "x"),
                  "--quiet"] + argv)
    assert not (tmp_path / "x.iqtree").exists()


def _report(prefix) -> str:
    return Path(f"{prefix}.iqtree").read_text()


def test_default_model_selection_with_te(tmp_path):
    """No -m: ModelFinder (MFP) selects on the parsimony tree, then the
    winner is fitted on the -te tree; the report names it and holds the
    selection table (a small -mset/-mrate keeps the grid short)."""
    prefix = tmp_path / "x"
    assert cli.main(["-s", ALN, "-te", TREE, "-mset", "HKY,GTR", "-mrate",
                     "E,G", "--device", "cpu", "-pre", str(prefix),
                     "--quiet"]) == 0
    report = _report(prefix)
    best = re.search(r"Best-fit model according to BIC: (\S+)",
                     report).group(1)
    assert best == "GTR+G"
    assert re.search(r"^GTR\+G +-21", report, re.M)
    assert "Model of substitution: GTR+F+G4" in report
    assert f"Best-fit model: {best}" in Path(f"{prefix}.log").read_text()
    # the winner's fit on the reference tree: golden g4 as in the GTR+G case
    golden = json.loads((GOLDEN / "golden.json").read_text())["logL"]
    assert _logl(prefix) == pytest.approx(golden["g4_gtrg_opt"], abs=0.5)


def test_testonly_stops_after_selection(tmp_path):
    """-m TESTONLY writes the selection table and the log, and no tree."""
    prefix = tmp_path / "x"
    assert cli.main(["-s", ALN, "-m", "TESTONLY", "-mset", "JC,HKY",
                     "-mrate", "E,I", "-merit", "AIC", "--device", "cpu",
                     "-pre", str(prefix), "--quiet"]) == 0
    report = _report(prefix)
    assert "Best-fit model according to AIC: HKY+I" in report
    assert "List of models sorted by AIC score:" in report
    assert len(re.findall(r"^(JC|HKY)(\+I)? ", report, re.M)) == 4
    assert "Log-likelihood of the tree" not in report
    assert "ModelFinder-only run finished" in \
        Path(f"{prefix}.log").read_text()
    assert not Path(f"{prefix}.treefile").exists()


def test_blfix_with_free_parameters_is_refused(tmp_path):
    """-blfix with free model parameters is no longer refused: it fits them
    with the branch lengths held, as the JAX package's
    _optimize_model_only does; logL within 0.05 of it."""
    prefix = tmp_path / "x"
    assert cli.main(["-s", ALN, "-m", "GTR+G", "-te", TREE, "-blfix",
                     "--f64", "--device", "cpu", "-pre", str(prefix),
                     "--quiet"]) == 0
    aln = read_alignment(ALN)
    model, rates, _ = build_model("GTR+G", aln)
    jeng = jengine.LikelihoodEngine(aln, model, rates, dtype=jnp.float64)
    tree = Tree.from_newick(Path(TREE).read_text(), aln.names)
    janalysis._optimize_model_only(jeng, tree,
                                   types.SimpleNamespace(model_eps=0.01))
    assert _logl(prefix) == pytest.approx(jeng.loglik_tree(tree), abs=0.05)


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["-s", ALN, "-m", "JC", "-te", TREE, "-blfix",
                  "-pre", str(tmp_path / "x"), "--quiet"])


@pytest.fixture(scope="module")
def protein(tmp_path_factory):
    """A 6-taxon x 80-site protein problem simulated under LG+C20+G4
    (class by class): (PHYLIP path, Newick path)."""
    from iqtree2_tpu_torch import kernelcheck
    aln, tree, _, _ = kernelcheck.simulate("LG+C20+G4", 6, 80, seed=2)
    return kernelcheck.write_problem(
        aln, tree, tmp_path_factory.mktemp("protein") / "p")


def _sitefreq(prefix, nsites):
    rows = [ln.split() for ln in
            Path(f"{prefix}.sitefreq").read_text().splitlines()]
    assert [int(r[0]) for r in rows] == list(range(1, nsites + 1))
    freqs = np.array([r[1:] for r in rows], float)
    assert freqs.shape == (nsites, 20)
    np.testing.assert_allclose(freqs.sum(1), 1.0, atol=1e-4)


def test_mixture_te_through_the_cli(protein, tmp_path):
    """-m LG+C10+G -te: the profile mixture (C = 40) fitted on the tree
    through the host alternation (the joint fit declines mixtures), the
    report naming it."""
    phy, nwk = protein
    prefix = tmp_path / "mix"
    assert cli.main(["-s", phy, "-m", "LG+C10+G", "-te", nwk, "--device",
                     "cpu", "-pre", str(prefix), "--quiet"]) == 0
    assert np.isfinite(_logl(prefix))
    assert "Model of substitution: LG+C10" in _report(prefix)


def test_pmsf_with_te_and_with_t(protein, tmp_path):
    """--pmsf -te (the guide fit on the -te tree, then the SSF fit on it)
    and --pmsf -t (the guide tree of a search that climbs with NNI1):
    .sitefreq holds every site's frequencies, summing to 1."""
    phy, nwk = protein
    te, t = tmp_path / "te", tmp_path / "t"
    assert cli.main(["-s", phy, "-m", "LG+C10+G", "--pmsf", "-te", nwk,
                     "--device", "cpu", "-pre", str(te), "--quiet"]) == 0
    _sitefreq(te, 80)
    assert "PMSF final logL" in Path(f"{te}.log").read_text()
    assert cli.main(["-s", phy, "-m", "LG+C10+G", "--pmsf", "-t", nwk,
                     "-n", "1", "-ninit", "3", "-ntop", "2", "-nbest", "1",
                     "--device", "cpu", "-pre", str(t), "--quiet"]) == 0
    _sitefreq(t, 80)
    assert "Search done: 1 iterations" in Path(f"{t}.log").read_text()
    # the same guide tree and guide fit: the same site frequencies
    assert Path(f"{t}.sitefreq").read_text() == \
        Path(f"{te}.sitefreq").read_text()


@pytest.mark.parametrize("argv,message", [
    (["--pmsf", "-wsr"], "-wsr with --pmsf"),
    (["--pmsf", "-wspm"], "-wspm with --pmsf"),
    (["--pmsf", "-asr"], "-asr with --pmsf"),
    (["--pmsf", "-mldist"], "-mldist with --pmsf"),
    (["--pmsf", "--mlrate"], "--mlrate with --pmsf"),
    (["--pmsf", "-alrt", "1000"], "-alrt with --pmsf"),
    (["--pmsf", "-blfix"], "-blfix with --pmsf"),
    (["-mldist"], "-mldist with -m LG"),
])
def test_mixture_and_pmsf_refusals(protein, tmp_path, argv, message):
    """Under --pmsf every output the JAX package's SSFEngine cannot give
    (ROADMAP C12) stops the run; -mldist under a mixture too (C13)."""
    phy, nwk = protein
    with pytest.raises(SystemExit, match=message):
        cli.main(["-s", phy, "-m", "LG+C10+G", "-te", nwk, "--device", "cpu",
                  "-pre", str(tmp_path / "x"), "--quiet"] + argv)
    assert not (tmp_path / "x.iqtree").exists()


def test_pmsf_needs_a_mixture_and_no_partitions(protein, tmp_path):
    """--pmsf under a model without classes stops, as in the JAX package;
    with -p/-q/-Q (whose JAX path ignores --pmsf) it is refused, and a
    mixture model in a partition runs without it (the partitioned run
    fits the mixture, as the JAX partition path does)."""
    from iqtree2_tpu_torch import kernelcheck
    phy, nwk = protein
    with pytest.raises(SystemExit, match="--pmsf requires a profile"):
        cli.main(["-s", phy, "-m", "LG+G", "--pmsf", "-te", nwk, "--device",
                  "cpu", "-pre", str(tmp_path / "x"), "--quiet"])
    with pytest.raises(SystemExit, match="--pmsf with -p/-q/-Q"):
        cli.main(["-s", ALN, "-p", NEX, "--pmsf", "-te", TREE, "--device",
                  "cpu", "-pre", str(tmp_path / "x"), "--quiet"])
    sa, tree, _, _ = kernelcheck.simulate_loci(
        [("AA", "LG+G{0.6}", 60, 0.0, 1.0), ("AA", "WAG+G{0.6}", 60, 0.0,
                                               1.0)], 6, seed=1)
    nex = kernelcheck.write_partitioned(sa, ["LG+C10+G", "WAG+G"], tmp_path)
    (tmp_path / "loci.nwk").write_text(tree.to_newick() + "\n")
    assert cli.main(["-p", nex, "-m", "LG+G", "-te",
                     str(tmp_path / "loci.nwk"), "--device", "cpu", "-pre",
                     str(tmp_path / "x"), "--quiet"]) == 0
    assert "LG+C10+G" in (tmp_path / "x.iqtree").read_text()
