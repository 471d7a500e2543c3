"""The port's -S (one tree per locus) under a nonreversible model with the
root test against the JAX package's, float64 on the CPU.

-S runs the single-alignment analysis per locus and passes UNREST, +H, +T
and --root-test on to it (test_torch_unlinked_families.py takes +H and
+T). The port runs through its CLI (--device cpu), the JAX package
through its parser and run_unlinked_topology_analysis in this process
(tests/torch_parity.partition_cli_both), on a small simulation with its
-te tree.
"""

from pathlib import Path

import pytest
import torch

from iqtree2_tpu_torch.tree.topology import Tree
from tests.torch_parity import partition_cli_both, two_loci


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _partlh(prefix) -> list:
    return [r.split("\t") for r in
            Path(f"{prefix}.partlh").read_text().splitlines()]


def check_loci_match(port, jax, names, sites: int) -> None:
    """The same loci, logLs within 0.01 and per-locus topologies."""
    rows, jrows = _partlh(port), _partlh(jax)
    half = str(sites // 2)
    assert [r[:2] for r in rows] == [r[:2] for r in jrows] == \
        [["a", half], ["b", half]]
    for r, jr in zip(rows, jrows):
        assert float(r[2]) == pytest.approx(float(jr[2]), abs=0.01)
    trees = Path(f"{port}.treefile").read_text().splitlines()
    jtrees = Path(f"{jax}.treefile").read_text().splitlines()
    topo = [Tree.from_newick(t, names).topology_id()
            for t in trees + jtrees]
    assert topo[:2] == topo[2:]


def test_unlinked_nonrev_root_test_matches_jax(tmp_path):
    """-S -m UNREST+G --root-test on two loci of a 4-taxon UNREST+G4
    simulation: the same per-locus trees and logLs within 0.01, and each
    locus's root test over every branch. -me 1 stops the nonreversible
    fit's host alternation sooner in both packages."""
    phy, nwk, nex, tree = two_loci(tmp_path, "UNREST+G4", 4, 100)
    port, jax, stops = partition_cli_both(
        ["-s", phy, "-S", nex, "-m", "UNREST+G", "-te", nwk, "--f64", "-me",
         "1", "--root-test"], tmp_path)
    assert stops == [None, None]
    check_loci_match(port, jax, tree.taxon_names, 100)
    for locus in ("a", "b"):
        rows = Path(f"{port}.{locus}.roottest.csv").read_text().splitlines()
        assert len(rows) == 1 + 2 * 4 - 3
        assert len(rows) == len(Path(f"{jax}.{locus}.roottest.csv")
                                .read_text().splitlines())
