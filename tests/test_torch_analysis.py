"""The last single-alignment flags through the port's CLI against the JAX
package's analysis, float64 on the CPU: -g (a constraint tree), -b (the
standard bootstrap), --runs and --symtest.

The JAX package's -b fails on every replicate: its
Alignment.bootstrap_alignment maps the sites to the kept patterns' old
indices, past the rows it keeps (ROADMAP C9). Its half of the -b test runs
with that map repaired through a monkeypatch (its file unchanged), the
same draws from the same generator.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from iqtree2_tpu import analysis as janalysis
from iqtree2_tpu import cli as jcli
from iqtree2_tpu import symtest as jsymtest
from iqtree2_tpu.data.alignment import Alignment as JAlignment
from iqtree2_tpu.io.alignment_io import read_alignment as jread_alignment
from iqtree2_tpu_torch import cli
from iqtree2_tpu_torch.io.alignment_io import read_alignment
from iqtree2_tpu_torch.tree.constraint import TopologyConstraint
from iqtree2_tpu_torch.tree.topology import Tree

GOLDEN = Path(__file__).parent / "golden"
ALN, TREE = str(GOLDEN / "example.phy"), str(GOLDEN / "ref_tree.nwk")
SMALL = ["-n", "1", "-ninit", "5", "-ntop", "2", "-nbest", "2"]
CONSTRAINT = "((Frog,Turtle),(Human,Seal),Cow);"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jparams(argv):
    return jcli.params_from_args(jcli.build_parser().parse_args(argv))


def _logl(prefix) -> float:
    text = Path(f"{prefix}.iqtree").read_text()
    return float(text.split("Log-likelihood of the tree:")[1].split()[0])


def _tree(path, names) -> Tree:
    return Tree.from_newick(Path(path).read_text(), names)


def test_constraint_search_matches_jax(tmp_path):
    """-g: the searched tree holds every constraint split and is the JAX
    package's, logL within 0.01."""
    (tmp_path / "c.nwk").write_text(CONSTRAINT)
    argv = ["-s", ALN, "-m", "GTR+G", "-g", str(tmp_path / "c.nwk"),
            "--f64"] + SMALL
    assert cli.main(argv + ["--device", "cpu", "-pre",
                            str(tmp_path / "port"), "--quiet"]) == 0
    janalysis.run_analysis(_jparams(argv + ["-pre", str(tmp_path / "jax"),
                                            "--quiet"]))
    names = read_alignment(ALN).names
    tree = _tree(tmp_path / "port.treefile", names)
    jtree = _tree(tmp_path / "jax.treefile", names)
    constraint = TopologyConstraint(CONSTRAINT, names)
    assert len(constraint.splits) == 2 and constraint.compatible(tree)
    assert tree.topology_id() == jtree.topology_id()
    assert _logl(tmp_path / "port") == pytest.approx(
        _logl(tmp_path / "jax"), abs=0.01)
    assert "Constraint tree (-g): 2 splits over 5 taxa" in \
        (tmp_path / "port.log").read_text()


def _repaired_bootstrap_alignment(self, rng):
    """JAX Alignment.bootstrap_alignment with the site map over the kept
    patterns' new indices (the port's)."""
    w = self.bootstrap_pattern_weights(rng)[0]
    keep = w > 0
    return JAlignment(names=self.names, seqtype=self.seqtype,
                      patterns=self.patterns[keep], pattern_weights=w[keep],
                      site_to_pattern=np.repeat(
                          np.arange(int(keep.sum())),
                          w[keep].astype(np.int64)).astype(np.int32),
                      name=self.name)


def test_standard_bootstrap_matches_jax(tmp_path, monkeypatch):
    """-b 3: the same replicate trees, the same supports on .treefile and
    the same consensus as the JAX package with its site map repaired."""
    jaln = jread_alignment(ALN)
    with pytest.raises(IndexError):
        jaln.bootstrap_alignment(np.random.default_rng(1 ^ 0xB00)) \
            .expand_to_sites()
    argv = ["-s", ALN, "-m", "GTR+G", "-b", "3", "--f64", "-n", "1",
            "-ninit", "3", "-ntop", "1", "-nbest", "1"]
    assert cli.main(argv + ["--device", "cpu", "-pre",
                            str(tmp_path / "port"), "--quiet"]) == 0
    monkeypatch.setattr(JAlignment, "bootstrap_alignment",
                        _repaired_bootstrap_alignment)
    janalysis.run_standard_bootstrap(_jparams(
        argv + ["-pre", str(tmp_path / "jax"), "--quiet"]))
    names = jaln.names
    boots = [Tree.from_newick(ln, names).topology_id() for ln in
             (tmp_path / "port.boottrees").read_text().splitlines()]
    jboots = [Tree.from_newick(ln, names).topology_id() for ln in
              (tmp_path / "jax.boottrees").read_text().splitlines()]
    assert len(boots) == 3 and boots == jboots
    labels = re.findall(r"\)(\d+):",
                        (tmp_path / "port.treefile").read_text())
    jlabels = re.findall(r"\)(\d+):",
                         (tmp_path / "jax.treefile").read_text())
    assert len(labels) == 14 and labels == jlabels
    assert _tree(tmp_path / "port.contree", names).topology_id() == \
        _tree(tmp_path / "jax.contree", names).topology_id()


def test_independent_runs(tmp_path, capsys):
    """--runs 2: .run1 and .run2 analyses from seeds 1 and 2, the best
    logL printed."""
    assert cli.main(["-s", ALN, "-m", "GTR+G", "--runs", "2", "--device",
                     "cpu", "-pre", str(tmp_path / "r"), "--quiet"]
                    + SMALL) == 0
    best = float(re.search(r"Best of 2 runs: logL (\S+)",
                           capsys.readouterr().out).group(1))
    logls = [_logl(tmp_path / f"r.run{r}") for r in (1, 2)]
    assert best == pytest.approx(max(logls), abs=1e-4)
    for r in (1, 2):
        assert (tmp_path / f"r.run{r}.treefile").exists()
    assert not (tmp_path / "r.iqtree").exists()


def test_symtest_csv_matches_jax(tmp_path):
    """--symtest writes the JAX package's .symtest.csv for the alignment
    (the maximum-divergence pair's Bowker, Stuart and internal tests)."""
    assert cli.main(["-s", ALN, "-m", "JC", "-te", TREE, "-blfix",
                     "--symtest", "--device", "cpu", "-pre",
                     str(tmp_path / "s"), "--quiet"]) == 0
    jsymtest.write_symtest_csv(
        str(tmp_path / "j.csv"),
        [("alignment", jsymtest.run_symtest(jread_alignment(ALN)))])
    text = (tmp_path / "s.symtest.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text()
    assert text.startswith("Name,SymSig") and len(text.splitlines()) == 2
