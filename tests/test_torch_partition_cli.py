"""The port's partitioned command lines against the JAX package's, float64
on the CPU: -p/-q/-Q/-S on example.nex with -te, per-partition ModelFinder
with both merges, and the search with -bsam GENE.

The port runs through its CLI (--device cpu); the JAX package through
its own parser and run_partition_analysis / run_unlinked_topology_analysis
in this process, so both read the same files with the same flags.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from iqtree2_tpu import cli as jcli
from iqtree2_tpu import partition_analysis as jpa
from iqtree2_tpu.data.superalignment import read_partition_spec as jread_spec
from iqtree2_tpu.search.ufboot import UFBoot as JUFBoot
from iqtree2_tpu_torch import cli
from iqtree2_tpu_torch.data.superalignment import read_partition_spec
from iqtree2_tpu_torch.search.ufboot import UFBoot
from iqtree2_tpu_torch.tree.topology import Tree

GOLDEN = Path(__file__).parent / "golden"
ALN, NEX = str(GOLDEN / "example.phy"), str(GOLDEN / "example.nex")
TREE = str(GOLDEN / "ref_tree.nwk")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logl(prefix) -> float:
    text = Path(f"{prefix}.iqtree").read_text()
    return float(text.split("Log-likelihood of the tree:")[1].split()[0])


def _both(argv, d: Path):
    """The port's CLI and the JAX package's analysis on ``argv``, under
    the prefixes d/port and d/jax."""
    assert cli.main(argv + ["--device", "cpu", "-pre", str(d / "port"),
                            "--quiet"]) == 0
    pr = jcli.params_from_args(jcli.build_parser().parse_args(
        argv + ["-pre", str(d / "jax"), "--quiet"]))
    if pr.partition_type == "topo-unlinked":
        jpa.run_unlinked_topology_analysis(pr)
    else:
        jpa.run_partition_analysis(pr)
    return d / "port", d / "jax"


def _supports(path) -> dict:
    """{split (the smaller side's taxon names, or the side without the
    first taxon at a tie): label} of a Newick file's internal labels."""
    text = Path(path).read_text().strip()
    taxa = set(re.findall(r"[(,]([^(),:;]+)", text))
    stack, out = [], {}
    for tok in re.findall(r"\(|\)[^:,();]*|[^(),:;]+(?=[:,)])|[,:;]",
                          text):
        if tok == "(":
            stack.append(set())
        elif tok.startswith(")"):
            clade = stack.pop()
            if stack:
                stack[-1] |= clade
                other = taxa - clade
                side = min(clade, other, key=lambda s: (len(s), sorted(s)))
                out[frozenset(side)] = tok[1:]
        elif tok not in ",:;" and stack and tok in taxa:
            stack[-1].add(tok)
    return out


def _topology(path, names) -> str:
    return Tree.from_newick(Path(path).read_text(), names).topology_id()


@pytest.mark.parametrize("flag", ["-p", "-q", "-Q"])
def test_linkage_fit_matches_jax(flag, tmp_path):
    """-m GTR+G -te on example.nex (each partition under its
    charpartition model): the same .best_scheme.nex and tree, logL within
    0.01."""
    port, jax = _both(["-s", ALN, flag, NEX, "-m", "GTR+G", "-te", TREE,
                       "--f64"], tmp_path)
    assert Path(f"{port}.best_scheme.nex").read_text() == \
        Path(f"{jax}.best_scheme.nex").read_text()
    names = read_partition_spec(NEX, ALN).names
    assert _topology(f"{port}.treefile", names) == \
        _topology(f"{jax}.treefile", names)
    assert _logl(port) == pytest.approx(_logl(jax), abs=0.01)
    assert "PARTITION TABLE" in Path(f"{port}.iqtree").read_text()


def test_unlinked_topologies_match_jax(tmp_path):
    """-S: one tree per locus in .treefile and each locus's logL in
    .partlh, as the JAX package's (logLs within 0.01)."""
    port, jax = _both(["-s", ALN, "-S", NEX, "-m", "GTR+G", "-te", TREE,
                       "--f64"], tmp_path)
    trees = Path(f"{port}.treefile").read_text().splitlines()
    jtrees = Path(f"{jax}.treefile").read_text().splitlines()
    assert len(trees) == len(jtrees) == 3
    rows = [r.split("\t") for r in
            Path(f"{port}.partlh").read_text().splitlines()]
    jrows = [r.split("\t") for r in
             Path(f"{jax}.partlh").read_text().splitlines()]
    assert [r[:2] for r in rows] == [r[:2] for r in jrows]
    for r, jr in zip(rows, jrows):
        assert float(r[2]) == pytest.approx(float(jr[2]), abs=0.01)


@pytest.mark.parametrize("spec", ["GENE", "GENESITE"])
def test_partition_bootstrap_samples_match_jax(spec):
    """-bsam GENE/GENESITE: the UFBoot replicates' pattern weights over the
    supermatrix, from the same seed."""
    boot = UFBoot(read_partition_spec(NEX, ALN), n_replicates=50, seed=3,
                  spec=spec)
    jboot = JUFBoot(jread_spec(NEX, ALN), n_replicates=50, seed=3, spec=spec)
    np.testing.assert_array_equal(boot.samples, jboot.samples)


def test_search_with_gene_bootstrap_matches_jax(tmp_path):
    """-B 100 -bsam GENE with a small search: the same tree, logL within
    0.01, the JAX package's supports rounded (the port writes integer
    percentages) and the same consensus; the port also writes the
    replicate trees."""
    port, jax = _both(["-s", ALN, "-p", NEX, "-m", "GTR+G", "-B", "100",
                       "-bsam", "GENE", "-n", "1", "-ninit", "5", "-ntop",
                       "2", "-nbest", "2", "--f64"], tmp_path)
    names = read_partition_spec(NEX, ALN).names
    assert _topology(f"{port}.treefile", names) == \
        _topology(f"{jax}.treefile", names)
    assert _logl(port) == pytest.approx(_logl(jax), abs=0.01)
    sup, jsup = _supports(f"{port}.treefile"), _supports(f"{jax}.treefile")
    assert sup and sup.keys() == jsup.keys()
    for s, lab in sup.items():
        assert lab.isdigit() and int(lab) == round(float(jsup[s]))
    assert _topology(f"{port}.contree", names) == \
        _topology(f"{jax}.contree", names)
    assert len(Path(f"{port}.ufboot").read_text().splitlines()) == 100
