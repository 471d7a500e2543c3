"""The port's -S (one tree per locus) under per-class branch lengths (+H)
and a tree mixture (+T) against the JAX package's, float64 on the CPU,
through the port's CLI and the JAX package's run_unlinked_topology_analysis
in this process (tests/torch_parity.partition_cli_both).
"""

from pathlib import Path

import pytest
import torch

from iqtree2_tpu_torch import kernelcheck
from tests.test_torch_unlinked import check_loci_match
from tests.torch_parity import partition_cli_both, two_loci


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_unlinked_per_class_lengths_match_jax(tmp_path):
    """-S -m GTR+H2 on two loci of a 5-taxon simulation: the same per-locus
    trees and logLs within 0.01."""
    phy, nwk, nex, tree = two_loci(tmp_path, "UNREST+G4", 5, 120)
    port, jax, stops = partition_cli_both(
        ["-s", phy, "-S", nex, "-m", "GTR+H2", "-te", nwk, "--f64"],
        tmp_path)
    assert stops == [None, None]
    check_loci_match(port, jax, tree.taxon_names, 120)


def test_unlinked_tree_mixture_stops_as_jax(tmp_path):
    """-S with +T: the JAX package's -S stops, as the tree mixture's
    analysis returns no single tree; so does the port's, with the same
    message."""
    phy, nwk, nex, tree = two_loci(tmp_path, "GTR+G4", 5, 80)
    other, _ = kernelcheck.perturbed(tree, seed=1, strength=0.3)
    two = tmp_path / "two.nwk"
    two.write_text(Path(nwk).read_text() + other.to_newick() + "\n")
    _, _, stops = partition_cli_both(["-s", phy, "-S", nex, "-m", "GTR+G+T",
                                      "-te", str(two), "--f64"], tmp_path)
    assert stops[0] is not None and stops[0] == stops[1]
    assert "not supported with -S" in stops[0]
