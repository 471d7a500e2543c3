"""Tree perturbation operators for escaping local optima.

Reference analogs (SURVEY A3): doRandomNNIs (tree/iqtree.cpp:1627) — apply
floor((L-3)*pertub_strength) random NNIs; doIQP (:1688) — delete a fraction
of leaves and re-insert each at a (quartet-judged) good position; here
re-insertion uses parsimony scoring like the stepwise-addition engine.

Copied from iqtree2_tpu/search/perturb.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.ops.pars import fitch_combine, state_bitmasks
from iqtree2_tpu_torch.tree.topology import Tree


def random_nnis(tree: Tree, rng: np.random.Generator,
                strength: float = 0.5,
                forbidden_splits: set | None = None,
                constraint=None) -> int:
    """Apply floor((L-3)*strength) random NNIs in place; returns count.

    constraint: optional TopologyConstraint (-g) — moves that would break
    a constraint split are undone (NNIs are self-inverse)."""
    n = max(1, int((tree.ntaxa - 3) * strength))
    applied = 0
    for _ in range(n):
        edges = tree.internal_edges()
        if not edges:
            break
        a, b = edges[rng.integers(0, len(edges))]
        if forbidden_splits:
            side = frozenset(tree.leaves_under(a, b))
            all_t = frozenset(range(tree.ntaxa))
            key = side if (len(side) < tree.ntaxa - len(side) or
                           (2 * len(side) == tree.ntaxa and 0 in side)) \
                else all_t - side
            if key in forbidden_splits:
                continue
        variant = int(rng.integers(0, 2))
        if constraint is None:
            tree.apply_nni(a, b, variant)
        else:
            x = [t for t in tree.adj[a] if t != b][0]
            y = [t for t in tree.adj[b] if t != a][variant]
            tree.swap_subtrees(a, x, b, y)
            if not constraint.compatible(tree):
                tree.swap_subtrees(a, y, b, x)   # undo
                continue
        applied += 1
    return applied


def p_delete_for(ntaxa: int) -> float:
    """Auto IQP deletion fraction by taxon count
    (reference: tree/iqtree.cpp:261-278)."""
    if ntaxa <= 51:
        return 0.5
    if ntaxa <= 100:
        return 0.3
    if ntaxa <= 200:
        return 0.2
    if ntaxa <= 400:
        return 0.1
    return 0.05


def iqp_perturb(tree: Tree, aln: Alignment, rng: np.random.Generator,
                p_delete: float | None = None) -> None:
    """IQP: delete random leaves, re-insert each at the best parsimony
    position (in place)."""
    L = tree.ntaxa
    if p_delete is None:
        p_delete = p_delete_for(L)
    k = max(1, int(L * p_delete))
    if L - k < 4:
        k = max(0, L - 4)
    if k == 0:
        return
    victims = list(rng.choice(L, size=k, replace=False))
    masks = state_bitmasks(aln)
    w = aln.pattern_weights

    # remove leaves (suppress resulting degree-2 nodes)
    for leaf in victims:
        nb = tree.adj[leaf][0]
        tree.remove_edge(leaf, nb)
        tree.suppress_degree_two(nb)

    # re-insert one by one at the best Fitch position
    for leaf in rng.permutation(victims):
        root = tree._default_root()
        post = list(tree.postorder(root))
        sets: dict[int, np.ndarray] = {}
        for v, p in post:
            if tree.is_leaf(v):
                sets[v] = masks[v]
            else:
                kids = [u for u in tree.adj[v] if u != p]
                acc = sets[kids[0]]
                for u in kids[1:]:
                    acc, _ = fitch_combine(acc, sets[u])
                sets[v] = acc
        edges, ctx = [], []
        for v, p in post:
            if p == -1:
                continue
            edges.append((v, p))
            ctx.append(sets[v])
        C = np.stack(ctx)
        delta = (((C & masks[leaf][None, :]) == 0) * w[None, :]).sum(axis=1)
        a, b = edges[int(np.argmin(delta))]
        mid = tree.new_node()
        lold = tree.get_blen(a, b)
        tree.remove_edge(a, b)
        tree.add_edge(a, mid, lold * 0.5)
        tree.add_edge(mid, b, lold * 0.5)
        tree.add_edge(mid, int(leaf), 0.1)
