"""Transfer Bootstrap Expectation (TBE) branch supports.

Reference analog: the vendored booster library (booster/booster.h:12,
called for --tbe from main/phyloanalysis.cpp:3668; Lemoine et al. 2018).

For a reference-tree branch b with light-side size p, the transfer
distance to a bootstrap tree T* is min over branches b* of T* of the
Hamming distance between the two bipartitions (up to complement);
TBE support = 1 - mean_T*(delta(b, T*)) / (p - 1). Classic (Felsenstein)
support counts only exact matches; TBE degrades gracefully on large trees.

Implementation: bipartitions as 0/1 matrices; the pairwise intersection
sizes for one bootstrap tree are ONE integer product [R, L] x [L, B]
instead of booster's per-edge postorder recursion.

Copied from iqtree2_tpu/tbe.py (host numpy): the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.tree.topology import Tree


def _split_matrix(tree: Tree, include_trivial: bool = False):
    """(bool matrix [n_splits, L], list of defining edges)."""
    L = tree.ntaxa
    rows, edges = [], []
    for s, e in tree.splits().items():
        row = np.zeros(L, dtype=np.int64)
        row[list(s)] = 1
        rows.append(row)
        edges.append(e)
    if include_trivial:
        for x in range(L):
            row = np.zeros(L, dtype=np.int64)
            row[x] = 1
            rows.append(row)
            edges.append((x, -1))
    if not rows:
        return np.zeros((0, L), dtype=np.int64), []
    return np.stack(rows), edges


def transfer_distances(ref_rows: np.ndarray,
                       boot_rows: np.ndarray) -> np.ndarray:
    """[R] minimal transfer distance of each reference split to any split
    of one bootstrap tree (bipartitions compared up to complement)."""
    L = ref_rows.shape[1]
    sa = ref_rows.sum(1)[:, None]                  # [R, 1]
    sb = boot_rows.sum(1)[None, :]                 # [1, B]
    inter = ref_rows @ boot_rows.T                 # [R, B]
    d = sa + sb - 2 * inter                        # |A xor B|
    d = np.minimum(d, L - d)                       # up to complement
    return d.min(axis=1)


def tbe_supports(ref_tree: Tree, boot_newicks: list[str],
                 names: list[str]) -> dict:
    """{branch key: TBE support in [0, 100]} for internal branches of the
    reference tree."""
    ref_rows, edges = _split_matrix(ref_tree)
    R, L = ref_rows.shape
    if R == 0 or not boot_newicks:
        return {}
    p = np.minimum(ref_rows.sum(1), L - ref_rows.sum(1))   # light side
    denom = np.maximum(p - 1, 1)
    acc = np.zeros(R)
    for nwk in boot_newicks:
        bt = Tree.from_newick(nwk, names)
        boot_rows, _ = _split_matrix(bt, include_trivial=True)
        acc += transfer_distances(ref_rows, boot_rows)
    mean_d = acc / len(boot_newicks)
    sup = 1.0 - mean_d / denom
    out = {}
    for k, (a, b) in enumerate(edges):
        out[Tree._key(a, b)] = float(np.clip(sup[k], 0.0, 1.0)) * 100.0
    return out
