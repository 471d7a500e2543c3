"""BIONJ distance-based tree construction (host, numpy-vectorized).

Reference analog: utils/bionj2.cpp (NJ/BIONJ family behind
StartTree::Factory, utils/starttree.h:32). Implements classic BIONJ
(Gascuel 1997): neighbor-joining with variance-weighted branch estimates.

Copied from iqtree2_tpu/search/bionj.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.tree.topology import Tree


def bionj_tree(D: np.ndarray, names: list[str]) -> Tree:
    n = len(names)
    tree = Tree(names)
    if n == 1:
        return tree
    if n == 2:
        tree.add_edge(0, 1, max(D[0, 1], 0.0))
        return tree

    D = D.astype(np.float64).copy()
    V = D.copy()  # variance matrix (BIONJ: init = distances)
    active = list(range(n))
    node_of = {i: i for i in range(n)}

    while len(active) > 3:
        m = len(active)
        idx = np.asarray(active)
        d = D[np.ix_(idx, idx)]
        r = d.sum(axis=1)
        q = (m - 2) * d - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        a_, b_ = np.unravel_index(np.argmin(q), q.shape)
        i, j = idx[a_], idx[b_]
        dij = D[i, j]
        ri = (D[i, idx].sum() - dij)
        rj = (D[j, idx].sum() - dij)
        li = 0.5 * dij + (ri - rj) / (2.0 * (m - 2))
        lj = dij - li
        li = max(li, 0.0)
        lj = max(lj, 0.0)
        # BIONJ lambda weighting from variances
        vij = V[i, j]
        if vij > 0 and m > 2:
            others = [k for k in active if k != i and k != j]
            lam = 0.5 + (V[j, others].sum() - V[i, others].sum()) / \
                (2.0 * (m - 2) * vij)
            lam = min(max(lam, 0.0), 1.0)
        else:
            lam = 0.5
        u = tree.new_node()
        tree.add_edge(u, node_of[i], li)
        tree.add_edge(u, node_of[j], lj)
        node_of[u] = u
        # update distances/variances to the new node (store at slot i)
        for k in active:
            if k in (i, j):
                continue
            duk = lam * (D[i, k] - li) + (1 - lam) * (D[j, k] - lj)
            D[i, k] = D[k, i] = max(duk, 0.0)
            V[i, k] = V[k, i] = lam * V[i, k] + (1 - lam) * V[j, k] \
                - lam * (1 - lam) * vij
        node_of[i] = u
        active.remove(j)

    # join the last three at a hub
    hub = tree.new_node()
    i, j, k = active
    li = 0.5 * (D[i, j] + D[i, k] - D[j, k])
    lj = 0.5 * (D[i, j] + D[j, k] - D[i, k])
    lk = 0.5 * (D[i, k] + D[j, k] - D[i, j])
    for x, lx in ((i, li), (j, lj), (k, lk)):
        tree.add_edge(hub, node_of[x], max(lx, 0.0))
    return tree
