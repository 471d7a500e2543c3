"""Set-up shared by the port's parity tests: a problem built twice from the
same plain inputs, once with the port's own host modules and once with the
JAX package's.

The port's side comes from iqtree2_tpu_torch (kernelcheck.simulate, or a
file read by the port); the JAX package's twin is rebuilt from the same
site matrix, model string and Newick text, so neither package ever receives
the other's objects.
"""

from pathlib import Path

from iqtree2_tpu import cli as jcli
from iqtree2_tpu import partition_analysis as jpa
from iqtree2_tpu.data import seqtypes as jseqtypes
from iqtree2_tpu.data.alignment import Alignment as JAlignment
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import cli, kernelcheck


def jax_alignment(aln) -> JAlignment:
    """The JAX package's Alignment of the port alignment's site matrix (the
    same patterns in the same order, from the same compressor)."""
    return JAlignment.from_site_matrix(
        list(aln.names), aln.expand_to_sites(),
        jseqtypes.get_seqtype(aln.seqtype.name))


def both_trees(tree, names) -> tuple:
    """(port Tree, JAX Tree) both parsed from the port tree's Newick text,
    so their node numbering and adjacency order (which random NNIs and
    traversals follow) are the same too."""
    nwk = tree.to_newick(digits=17)
    return type(tree).from_newick(nwk, names), JTree.from_newick(nwk, names)


def simulate_both(model_name: str, ntaxa: int, nsites: int, seed: int):
    """kernelcheck.simulate's problem on both sides: ((aln, tree, model,
    rates) of the port, the same four of the JAX package)."""
    aln, tree, model, rates = kernelcheck.simulate(model_name, ntaxa, nsites,
                                                   seed)
    tree, jtree = both_trees(tree, aln.names)
    jaln = jax_alignment(aln)
    jmodel, jrates, _ = jbuild_model(kernelcheck.MODELS[model_name][2], jaln)
    return (aln, tree, model, rates), (jaln, jtree, jmodel, jrates)


def partition_cli_both(argv, d: Path):
    """The port's CLI (--device cpu) and the JAX package's partition
    analysis (its parser, then run_unlinked_topology_analysis or
    run_partition_analysis in this process) on ``argv``, under the
    prefixes d/port and d/jax; returns them with each side's SystemExit
    message (None where it ran)."""
    stops = []
    try:
        cli.main(argv + ["--device", "cpu", "-pre", str(d / "port"),
                         "--quiet"])
        stops.append(None)
    except SystemExit as exc:
        stops.append(str(exc))
    pr = jcli.params_from_args(jcli.build_parser().parse_args(
        argv + ["-pre", str(d / "jax"), "--quiet"]))
    try:
        if pr.partition_type == "topo-unlinked":
            jpa.run_unlinked_topology_analysis(pr)
        else:
            jpa.run_partition_analysis(pr)
        stops.append(None)
    except SystemExit as exc:
        stops.append(str(exc))
    return d / "port", d / "jax", stops


def two_loci(d: Path, model_name: str, ntaxa: int, sites: int) -> tuple:
    """(PHYLIP, Newick, NEXUS of two equal charsets, true Tree) of a
    kernelcheck simulation, written under d."""
    aln, tree, _, _ = kernelcheck.simulate(model_name, ntaxa, sites, seed=1)
    phy, nwk = kernelcheck.write_problem(aln, tree, str(d / "p"))
    half = sites // 2
    nex = d / "two.nex"
    nex.write_text(f"#nexus\nbegin sets;\n  charset a = 1-{half};\n"
                   f"  charset b = {half + 1}-{sites};\nend;\n")
    return phy, nwk, str(nex), tree


def jax_cli_main(argv, monkeypatch) -> int:
    """The JAX package's command line in this process, its persistent
    compile cache left off (tests/conftest.py turns it off for the suite;
    the CLI would turn it on)."""
    from iqtree2_tpu.utils import compilecache
    monkeypatch.setattr(compilecache, "enable_compile_cache",
                        lambda **kw: None)
    monkeypatch.delenv("IQTREE2_TPU_PLATFORM", raising=False)
    return jcli.main(argv)
