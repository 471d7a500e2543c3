"""The port's AliSim (--alisim) against the JAX package's, on the CPU.

DNA runs through the port's CLI and through the JAX package's parser and
run_alisim (what its CLI's --alisim branch calls) with the same flags and
seed: the output files are equal byte for byte, plain, with indels, mimicking
an input alignment (-s), partitioned (-p), several alignments and split over
two ranks. Protein and codon models, which the JAX run_alisim cannot build
(ROADMAP C22: its dummy alignment is always DNA), are held to the JAX
simulate_alignment called directly with a model the JAX package builds on
an alignment of the right type. Under a mixture the port draws each site's
class by the weights (the JAX simulator takes class 0, C11), and under a
nonreversible model its P is expm(Q t) (C18).
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.linalg
import torch

from iqtree2_tpu import cli as jcli
from iqtree2_tpu import simulator as jsimulator
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import cli, kernelcheck, simulator
from iqtree2_tpu_torch.io.alignment_io import read_alignment
from iqtree2_tpu_torch.model.codon import sense_codons
from iqtree2_tpu_torch.tree.topology import Tree
from tests.torch_parity import jax_alignment

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
TREE, ALN = str(GOLDEN / "ref_tree.nwk"), str(GOLDEN / "example.phy")
NEX = str(GOLDEN / "example.nex")


def _port(prefix, flags) -> dict:
    """{file name: bytes} of the port CLI's --alisim run under prefix."""
    assert cli.main(["--alisim", str(prefix), "-t", TREE, "--device", "cpu"]
                    + flags) == 0
    return {p.name.replace(prefix.name, "X"): p.read_bytes()
            for p in prefix.parent.glob(prefix.name + "*")}


def _jax(prefix, flags) -> dict:
    pr = jcli.params_from_args(jcli.build_parser().parse_args(
        ["--alisim", str(prefix), "-t", TREE] + flags))
    outs = jsimulator.run_alisim(pr)
    return {Path(o).name.replace(prefix.name, "X"): Path(o).read_bytes()
            for o in outs}


@pytest.mark.parametrize("flags", [
    ["-m", "GTR+G", "--length", "300"],
    ["-m", "HKY+I+G", "--length", "200", "--indel", "0.05,0.05",
     "--indel-size", "2"],
    ["-m", "GTR+G", "-s", ALN],
    ["-m", "GTR+G", "-p", NEX, "-s", ALN, "--seed", "3"],
    ["-m", "K2P+R3", "--length", "100", "--num-alignments", "3"],
], ids=["plain", "indel", "mimic", "partitioned", "three"])
def test_dna_outputs_equal_jax(tmp_path, flags):
    port = _port(tmp_path / "port", flags)
    jax = _jax(tmp_path / "jax", flags)
    assert port and sorted(port) == sorted(jax)
    assert port == jax


def test_ranks_union_equals_single_run(tmp_path):
    """--alisim-nprocs 2: ranks 0 and 1 write replicates 1, 3 and 2, 4;
    together the single run's files, which equal the JAX package's."""
    flags = ["-m", "HKY", "--length", "120", "--num-alignments", "4",
             "--seed", "7"]
    (tmp_path / "one").mkdir()
    single = _port(tmp_path / "one" / "x", flags)
    union: dict = {}
    for rank in (0, 1):
        d = tmp_path / f"rank{rank}"
        d.mkdir()
        got = _port(d / "x", flags + ["--alisim-nprocs", "2",
                                      "--alisim-rank", str(rank)])
        assert sorted(got) == [f"X_{i}.phy" for i in (rank + 1, rank + 3)]
        union.update(got)
    assert union == single == _jax(tmp_path / "jax", flags)


def _jax_simulated(model_str: str, seqtype: str, nsites: int, seed: int):
    """The JAX simulate_alignment's PHYLIP text for replicate 0 of
    run_alisim's streams, the model built by the JAX package on an
    alignment of ``seqtype``."""
    nwk = Path(TREE).read_text()
    jtree = JTree.from_newick(nwk)
    dummy = simulator.dummy_alignment(jtree.taxon_names, seqtype)
    jmodel, jrates, _ = jbuild_model(model_str, jax_alignment(dummy))
    seqs = jsimulator.simulate_alignment(jtree, jmodel, jrates, nsites,
                                         np.random.default_rng([seed, 0]))
    return seqs


@pytest.mark.parametrize("model_str,seqtype,st_flag", [
    ("LG+G", "AA", []), ("WAG+I+G", "AA", ["-st", "AA"]),
    ("GY+F3X4+G", "CODON1", []), ("MG+F1X4", "CODON1", ["-st", "CODON"])])
def test_protein_and_codon_match_jax_simulate(tmp_path, monkeypatch,
                                              model_str, seqtype, st_flag):
    """The port builds the model on its own sequence type (C22 repaired)
    and writes what the JAX simulate_alignment gives under the JAX model
    built on such an alignment; the JAX function names codon states by an
    empty table, so its codon letters are the sense codons here."""
    port = _port(tmp_path / "port", ["-m", model_str, "--length", "80"]
                 + st_flag)
    monkeypatch.setattr(jsimulator, "model_state_chars",
                        lambda m: (sense_codons(1) if m.num_states == 61
                                   else list("ARNDCQEGHILKMFPSTWYV")))
    seqs = _jax_simulated(model_str, seqtype, 80, 1)
    jsimulator.write_phylip_seqs(tmp_path / "jax.phy", seqs)
    assert port["X.phy"] == (tmp_path / "jax.phy").read_bytes()
    aln = read_alignment(str(tmp_path / "port.phy"),
                         seqtype=seqtype if seqtype == "AA" else "CODON")
    assert aln.ntaxa == 17 and aln.nsites == 80


def test_mixture_classes_follow_the_weights(tmp_path, monkeypatch):
    """-m LG+C10 at 20 000 sites: each class simulates a share of the
    sites within 3 sigma of its weight (binomial), where the JAX simulator
    draws every site from class 0 (C11); the output reads back as 17 x
    20 000 amino acids."""
    sizes = []
    real = simulator.simulate_alignment

    def spy(tree, model, rates, nsites, rng, **kw):
        sizes.append(nsites)
        return real(tree, model, rates, nsites, rng, **kw)
    monkeypatch.setattr(simulator, "simulate_alignment", spy)
    n = 20000
    _port(tmp_path / "port", ["-m", "LG+C10", "--length", str(n)])
    names = Tree.from_newick(Path(TREE).read_text()).taxon_names
    w = simulator.alisim_model("LG+C10", names, None)[0].weights
    assert len(sizes) == len(w) == 10 and sum(sizes) == n
    sigma = np.sqrt(n * w * (1 - w))
    assert np.all(np.abs(np.asarray(sizes) - n * w) <= 3 * sigma), sizes
    aln = read_alignment(str(tmp_path / "port.phy"))
    assert aln.seqtype.name == "AA" and aln.nsites == n and aln.ntaxa == 17


def test_nonrev_simulation_uses_expm(tmp_path):
    """Under a nonreversible model (complex eigenvalues) the port's P(t)
    is expm(Q t) within 1e-12 (scipy's), and --alisim simulates through it
    (C18: the eigensystem's real parts)."""
    model_str = kernelcheck.MODELS["UNREST+G4"][2]
    names = Tree.from_newick(Path(TREE).read_text()).taxon_names
    model, rates = simulator.alisim_model(model_str, names, None)
    Q = np.asarray(model.get_eigensystem().Q)[0]
    assert np.iscomplexobj(np.linalg.eigvals(Q)) and \
        np.abs(np.linalg.eigvals(Q).imag).max() > 1e-3
    pm = simulator.nonrev_pmatrix(model)
    for t in (0.001, 0.05, 0.3, 2.0, 9.0):
        np.testing.assert_allclose(pm(t), scipy.linalg.expm(Q * t),
                                   atol=1e-12, rtol=0)
    port = _port(tmp_path / "port", ["-m", model_str, "--length", "150"])
    tree = Tree.from_newick(Path(TREE).read_text())
    seqs = simulator.simulate_nonrev(tree, model, rates, 150,
                                     np.random.default_rng([1, 0]))
    simulator.write_phylip_seqs(tmp_path / "direct.phy", seqs)
    assert port["X.phy"] == (tmp_path / "direct.phy").read_bytes()


def test_indel_under_a_mixture_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="--indel with -m LG\\+C10"):
        cli.main(["--alisim", str(tmp_path / "x"), "-t", TREE, "-m",
                  "LG+C10", "--indel", "0.1", "--device", "cpu"])
