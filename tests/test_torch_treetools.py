"""The port's tree tools against the JAX package's, on the CPU: random
trees (-r, -rtype), the majority-rule consensus (-con), Robinson-Foulds
distances (-rf, -rf_all) through both command lines in this process (every
output file equal byte for byte), and the gene and site concordance
factors (treeutils.gene_concordance, site_concordance) function by
function; the JAX package parses --gcf and --scf and reads them nowhere
(ROADMAP C23), and the port refuses both flags.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from iqtree2_tpu import treeutils as jtreeutils
from iqtree2_tpu.io.alignment_io import read_alignment as jread_alignment
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import cli, kernelcheck, treeutils
from iqtree2_tpu_torch.io.alignment_io import read_alignment
from iqtree2_tpu_torch.tree.topology import Tree
from tests.torch_parity import jax_cli_main

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
TREE, ALN = GOLDEN / "ref_tree.nwk", str(GOLDEN / "example.phy")
RTYPES = ["yule", "uniform", "caterpillar", "balanced", "star"]


def _tree_set(d: Path, n: int = 25) -> str:
    """n trees around the reference tree (random NNIs of two strengths)."""
    ref = Tree.from_newick(TREE.read_text())
    lines = [ref.to_newick()]
    for i in range(n - 1):
        t, _ = kernelcheck.perturbed(ref, seed=i, strength=0.1 + 0.2 * (i % 2))
        lines.append(t.to_newick())
    path = d / "trees.nwk"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _both_cli(argv, d: Path, ext: str, monkeypatch) -> tuple:
    assert cli.main(argv + ["-pre", str(d / "port")]) == 0
    assert jax_cli_main(argv + ["-pre", str(d / "jax")], monkeypatch) == 0
    return (Path(f"{d / 'port'}{ext}").read_bytes(),
            Path(f"{d / 'jax'}{ext}").read_bytes())


@pytest.mark.parametrize("rtype", RTYPES)
def test_random_tree_matches_jax(rtype):
    for n, seed in ((4, 1), (12, 3), (30, 8)):
        t = treeutils.random_tree(n, rtype, np.random.default_rng(seed))
        jt = jtreeutils.random_tree(n, rtype, np.random.default_rng(seed))
        assert t.to_newick() == jt.to_newick()


@pytest.mark.parametrize("rtype", ["yule", "balanced"])
def test_random_tree_cli_matches_jax(tmp_path, monkeypatch, rtype):
    port, jax = _both_cli(["-r", "12", "-rtype", rtype, "-seed", "5"],
                          tmp_path, ".treefile", monkeypatch)
    assert port == jax and port.count(b",") == 11


def test_consensus_cli_matches_jax(tmp_path, monkeypatch):
    trees = _tree_set(tmp_path)
    port, jax = _both_cli(["-con", trees], tmp_path, ".contree",
                          monkeypatch)
    assert port == jax
    con = Tree.from_newick(port.decode())
    assert con.ntaxa == 17
    t = [Tree.from_newick(x) for x in Path(trees).read_text().split()]
    con2, freqs = treeutils.consensus_tree(t, t[0].taxon_names, 0.7)
    jt = [JTree.from_newick(x) for x in Path(trees).read_text().split()]
    jcon2, jfreqs = jtreeutils.consensus_tree(jt, jt[0].taxon_names, 0.7)
    assert con2.to_newick() == jcon2.to_newick() and freqs == jfreqs


def test_rf_all_cli_matches_jax(tmp_path, monkeypatch):
    trees = _tree_set(tmp_path, 12)
    port, jax = _both_cli(["-rf_all", "-t", trees], tmp_path, ".rfdist",
                          monkeypatch)
    assert port == jax and len(port.decode().splitlines()) == 13


def test_rf_pairs_match_jax(tmp_path, monkeypatch, capsys):
    """-t TREES -rf OTHER prints one RF distance per pair; rf_distance and
    max_rf as the JAX functions."""
    trees = _tree_set(tmp_path, 6)
    other = tmp_path / "other.nwk"
    other.write_text("\n".join(Path(trees).read_text().split()[3:]) + "\n")
    capsys.readouterr()
    assert cli.main(["-t", trees, "-rf", str(other)]) == 0
    port = capsys.readouterr().out
    assert jax_cli_main(["-t", trees, "-rf", str(other)], monkeypatch) == 0
    jax = capsys.readouterr().out
    assert port == jax and port.count("RF(") == 18
    t = [Tree.from_newick(x) for x in Path(trees).read_text().split()]
    jt = [JTree.from_newick(x) for x in Path(trees).read_text().split()]
    assert treeutils.max_rf(t[0]) == jtreeutils.max_rf(jt[0])
    np.testing.assert_array_equal(treeutils.rf_matrix(t),
                                  jtreeutils.rf_matrix(jt))


def _same(a: dict, b: dict) -> bool:
    """Dicts of tuples equal, NaN equal to NaN."""
    def norm(v):
        return tuple("nan" if isinstance(x, float) and math.isnan(x) else x
                     for x in v)
    return a.keys() == b.keys() and all(norm(a[k]) == norm(b[k]) for k in a)


def test_gene_concordance_matches_jax():
    """gCF of the reference tree's branches over gene trees on random
    taxon subsets (some branches undecided: NaN)."""
    nwk = TREE.read_text()
    ref, jref = Tree.from_newick(nwk), JTree.from_newick(nwk)
    rng = np.random.default_rng(4)
    genes = []
    for i in range(12):
        k = int(rng.integers(4, 18))
        sub = sorted(rng.choice(ref.taxon_names, size=k, replace=False))
        genes.append(treeutils.random_tree(
            k, "uniform", np.random.default_rng(i), names=sub).to_newick())
    out = treeutils.gene_concordance(
        ref, [Tree.from_newick(g) for g in genes])
    jout = jtreeutils.gene_concordance(
        jref, [JTree.from_newick(g) for g in genes])
    assert _same(out, jout) and len(out) == 14


def test_site_concordance_matches_jax():
    nwk = TREE.read_text()
    aln, jaln = read_alignment(ALN), jread_alignment(ALN)
    ref = Tree.from_newick(nwk, aln.names)
    jref = JTree.from_newick(nwk, jaln.names)
    out = treeutils.site_concordance(ref, aln, 20,
                                     np.random.default_rng(2))
    jout = jtreeutils.site_concordance(jref, jaln, 20,
                                       np.random.default_rng(2))
    assert _same(out, jout) and len(out) == 14
    groups = treeutils._quartet_groups(ref, *next(iter(out)))
    jgroups = jtreeutils._quartet_groups(jref, *next(iter(jout)))
    assert groups == jgroups
