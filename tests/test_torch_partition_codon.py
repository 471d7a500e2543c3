"""A -q file of codon charsets against the JAX package's partition path,
float64 on the CPU: the port through its CLI (--device cpu), the JAX
package through its parser and run_partition_analysis in this process.
"""

from pathlib import Path

import pytest
import torch

from iqtree2_tpu_torch import kernelcheck
from tests.torch_parity import partition_cli_both


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_codon_charsets_match_jax(tmp_path):
    """-q with a codon charset (RAxML style, "CODON, name = range") on a
    simulated codon alignment under GY+F3X4+G -te: the same scheme and
    logL within 0.01. Both packages read a codon charset's range in codons
    (ROADMAP C24), so the range here counts codons."""
    aln, tree, _, _ = kernelcheck.simulate("GY+F3X4+G4", 5, 60, seed=1)
    phy, nwk = kernelcheck.write_problem(aln, tree, str(tmp_path / "cds"))
    spec = tmp_path / "codon.txt"
    spec.write_text("CODON, part1 = 1-60\n")
    port, jax, stops = partition_cli_both(
        ["-s", phy, "-q", str(spec), "-m", "GY+F3X4+G", "-te", nwk, "--f64"],
        tmp_path)
    assert stops == [None, None]
    assert Path(f"{port}.best_scheme.nex").read_text() == \
        Path(f"{jax}.best_scheme.nex").read_text()

    def logl(prefix):
        text = Path(f"{prefix}.iqtree").read_text()
        return float(text.split("Log-likelihood of the tree:")[1].split()[0])
    assert logl(port) == pytest.approx(logl(jax), abs=0.01)
