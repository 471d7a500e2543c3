"""Set-up shared by the port's parity tests: a problem built twice from the
same plain inputs, once with the port's own host modules and once with the
JAX package's.

The port's side comes from iqtree2_tpu_torch (kernelcheck.simulate, or a
file read by the port); the JAX package's twin is rebuilt from the same
site matrix, model string and Newick text, so neither package ever receives
the other's objects.
"""

from iqtree2_tpu.data import seqtypes as jseqtypes
from iqtree2_tpu.data.alignment import Alignment as JAlignment
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import kernelcheck


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
