"""Mixture models under -p/-q/-Q against the JAX partition path, float64 on
the CPU: a supermatrix of a protein locus under a mixture (LG4M's four
eigensystems fused with four Gamma categories and LG4X's with four
FreeRate categories, both with free class weights; the profile mixture
LG+C10+G) beside a DNA locus under GTR+G, simulated class by class
(kernelcheck.simulate_loci). A charpartition splits its models at commas,
so MIX{...} cannot be named there, in either package.

Held: the partition engine's logL and site logLs (1e-9 relative), its
joint Newton, whose theta takes each category's class eigenvectors
(cat_mix), and its NNI5 scores (1e-8); the partition fit
(partition/optimize.py) that carries the free class weights of each
partition; and the -q/-p -te command lines' logLs.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import cli as jcli
from iqtree2_tpu import partition_analysis as jpa
from iqtree2_tpu.ops.nni import build_nni_candidates as jbuild_cands
from iqtree2_tpu.partition.optimize import \
    optimize_partition_parameters as jopt_partitions
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import cli, kernelcheck
from iqtree2_tpu_torch.model.mixture import MixtureModel
from iqtree2_tpu_torch.ops.nni import build_nni_candidates
from iqtree2_tpu_torch.partition.optimize import \
    optimize_partition_parameters
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree
from tests.test_torch_partition import engines

# (profile, linkage): every linkage at LG4X (C = 4), the JAX side's
# compiles at C = 16 and 40 kept to two
CASES = [(p, m) for p in ("LG4M", "LG+C10+G")
         for m in ("edge-equal", "edge-proportional")] + [
    ("LG4X", m) for m in ("edge-equal", "edge-proportional", "unlinked")]
DNA = "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+G{0.6}"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def supermatrix(profile: str, tmp_path, ntaxa=7) -> tuple[str, str]:
    """(partition file, Newick file of the simulating tree): a protein
    locus simulated under ``profile`` (fixed parameters) beside a DNA
    locus, each under its family in the charpartition."""
    fixed = {"LG4M": "LG4M+G{0.6}",
             "LG+C10+G": "LG+C10+G{0.6}",
             "LG4X": "LG4X+R4{0.2,0.2,0.3,0.7,0.3,1.2,0.2,2.0}"}[profile]
    sa, tree, _, _ = kernelcheck.simulate_loci(
        [("AA", fixed, 90, 0.0, 1.0), ("DNA", DNA, 150, 0.0, 1.0)],
        ntaxa, seed=3)
    nex = kernelcheck.write_partitioned(sa, [profile, "GTR+G"], tmp_path)
    nwk = tmp_path / "true.nwk"
    nwk.write_text(tree.to_newick() + "\n")
    return nex, str(nwk)


@pytest.mark.parametrize("profile,mode", CASES)
def test_engine_matches_jax(profile, mode, tmp_path):
    """logL and site logLs at a random tree, the joint Newton from there
    (lengths within 1e-6), NNI5 scores on the result (1e-8)."""
    nex, _ = supermatrix(profile, tmp_path)
    peng, jpeng = engines(nex, mode=mode)
    assert isinstance(peng.models[0], MixtureModel)
    names = peng.aln.names
    nwk = Tree.random_topology(names, np.random.default_rng(2)).to_newick(
        digits=17)
    tree, jtree = Tree.from_newick(nwk, names), JTree.from_newick(nwk, names)
    logl, lp = peng.site_lp(tree)
    jlogl, jlp = jpeng.site_lp(jtree)
    assert logl == pytest.approx(jlogl, rel=1e-9)
    np.testing.assert_allclose(lp, jlp, rtol=1e-9)
    assert peng.optimize_branches(tree) == pytest.approx(
        jpeng.optimize_branches(jtree), abs=1e-6)
    for key, t in tree.blen.items():
        assert t == pytest.approx(jtree.blen[key], abs=1e-6)
    sched, jsched = build_schedule(tree), jbuild_schedule(jtree)
    c, jc = build_nni_candidates(tree, sched), jbuild_cands(jtree, jsched)
    ca = np.stack([c.iu, c.iv, c.slot_c, c.edge_id])
    out = peng.evaluate_nni_batch(sched, ca, nni5=True)
    jout = jpeng.evaluate_nni_batch(jsched, jnp.asarray(ca), nni5=True)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("profile", ["LG4M", "LG4X"])
def test_partition_fit_carries_class_weights(profile, tmp_path):
    """The partition fit on the simulating tree: the protein partition's
    class weights move from their start, the same as the JAX fit's (1e-4
    relative), the logL within 1e-6."""
    nex, nwk = supermatrix(profile, tmp_path)
    peng, jpeng = engines(nex, mode="edge-equal")
    text = Path(nwk).read_text()
    tree = Tree.from_newick(text, peng.aln.names)
    jtree = JTree.from_newick(text, peng.aln.names)
    start = peng.models[0].weights.copy()
    logl = optimize_partition_parameters(peng, tree)
    jlogl = jopt_partitions(jpeng, jtree)
    assert logl == pytest.approx(jlogl, abs=1e-6)
    w, jw = peng.models[0].weights, jpeng.models[0].weights
    assert not np.allclose(w, start)
    np.testing.assert_allclose(w, jw, rtol=1e-4)


def _logl(prefix) -> float:
    text = Path(f"{prefix}.iqtree").read_text()
    return float(text.split("Log-likelihood of the tree:")[1].split()[0])


@pytest.mark.parametrize("flag,profile", [("-q", "LG4X"),
                                          ("-p", "LG4M")])
def test_command_line_matches_jax(flag, profile, tmp_path):
    """-q/-p -te --f64 through the port's CLI and the JAX package's
    run_partition_analysis: the reported logLs (4 decimals) equal within
    2e-4, the table naming each partition's model."""
    nex, nwk = supermatrix(profile, tmp_path)
    argv = [flag, nex, "-m", "GTR+G", "-te", nwk, "--f64"]
    assert cli.main(argv + ["--device", "cpu", "-pre",
                            str(tmp_path / "port"), "--quiet"]) == 0
    jpa.run_partition_analysis(jcli.params_from_args(
        jcli.build_parser().parse_args(
            argv + ["-pre", str(tmp_path / "jax"), "--quiet"])))
    assert _logl(tmp_path / "port") == pytest.approx(
        _logl(tmp_path / "jax"), abs=2e-4)
    table = Path(f"{tmp_path / 'port'}.iqtree").read_text()
    assert re.search(re.escape(profile) + r"\s", table)
