"""Tree-set utilities: Robinson-Foulds distances, consensus trees, random
tree generation, concordance factors.

Reference analogs: RF distances (`-rf`, tree/mtreeset.cpp computeRFDist),
consensus (`-con`, main/phyloanalysis.cpp:4776), random trees (`-r`,
tree/mexttree.cpp generateRandomTree), gene/site concordance factors
(tree/discordance.cpp computeGeneConcordance :15 / computeSiteConcordance
:144).

Copied from iqtree2_tpu/treeutils.py, with consensus_tree built by the
port's search/ufboot.greedy_consensus: the port keeps its own host modules
and imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from iqtree2_tpu_torch.search.ufboot import greedy_consensus
from iqtree2_tpu_torch.tree.topology import Tree


# ----------------------------------------------------------- RF distances
def rf_distance(t1: Tree, t2: Tree) -> int:
    """Unweighted Robinson-Foulds distance (symmetric split difference)."""
    s1 = set(t1.splits().keys())
    s2 = set(t2.splits().keys())
    return len(s1 ^ s2)


def max_rf(t1: Tree) -> int:
    """Maximum possible RF (2 * number of internal branches, binary)."""
    return 2 * (t1.ntaxa - 3)


def rf_matrix(trees: list[Tree]) -> np.ndarray:
    splits = [set(t.splits().keys()) for t in trees]
    n = len(trees)
    D = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            D[i, j] = D[j, i] = len(splits[i] ^ splits[j])
    return D


# ------------------------------------------------------------- consensus
def consensus_tree(trees: list[Tree], names: list[str],
                   min_freq: float = 0.5) -> tuple[Tree, dict]:
    """Majority-rule (extended) consensus; returns (tree, split freqs)."""
    cnt: Counter = Counter()
    for t in trees:
        for s in t.splits().keys():
            cnt[s] += 1
    n = len(trees)
    freqs = {s: c / n for s, c in cnt.items()}
    majority = {s: f for s, f in freqs.items() if f >= min_freq}
    return greedy_consensus(majority, names), freqs


# ------------------------------------------------------------ random trees
def random_tree(n: int, model: str = "yule",
                rng: np.random.Generator | None = None,
                names: list[str] | None = None) -> Tree:
    """Random tree generators: yule (Yule-Harding), uniform (PDA),
    caterpillar, balanced, star. Reference: -r / -ru / -rcat / -rbal / -rcsg
    (tree/mexttree.cpp generateRandomTree)."""
    if rng is None:
        rng = np.random.default_rng()
    names = names or [f"t{i + 1}" for i in range(n)]
    t = Tree(names)
    if n == 1:
        return t
    if n == 2:
        t.add_edge(0, 1, _rexp(rng))
        return t
    model = model.lower()
    if model in ("yule", "uniform", "pda"):
        hub = t.new_node()
        order = list(rng.permutation(n))
        for x in order[:3]:
            t.add_edge(hub, x, _rexp(rng))
        edges = [(hub, order[0]), (hub, order[1]), (hub, order[2])]
        for leaf in order[3:]:
            if model == "yule":
                # split a random *pendant* edge (Yule-Harding growth)
                cand = [e for e in edges if t.is_leaf(e[1])]
            else:
                cand = edges
            a, b = cand[rng.integers(len(cand))]
            mid = t.new_node()
            lold = t.get_blen(a, b)
            t.remove_edge(a, b)
            t.add_edge(a, mid, lold * 0.5)
            t.add_edge(mid, b, lold * 0.5)
            t.add_edge(mid, leaf, _rexp(rng))
            edges.remove((a, b))
            edges.extend([(a, mid), (mid, b), (mid, leaf)])
    elif model == "caterpillar":
        prev = t.new_node()
        t.add_edge(prev, 0, _rexp(rng))
        t.add_edge(prev, 1, _rexp(rng))
        for leaf in range(2, n - 1):
            nb = t.new_node()
            t.add_edge(prev, nb, _rexp(rng))
            t.add_edge(nb, leaf, _rexp(rng))
            prev = nb
        t.add_edge(prev, n - 1, _rexp(rng))
    elif model == "star":
        hub = t.new_node()
        for i in range(n):
            t.add_edge(hub, i, _rexp(rng))
    elif model in ("balanced", "bal"):
        def build(leaves):
            if len(leaves) == 1:
                return leaves[0]
            mid = len(leaves) // 2
            a = build(leaves[:mid])
            b = build(leaves[mid:])
            v = t.new_node()
            t.add_edge(v, a, _rexp(rng))
            t.add_edge(v, b, _rexp(rng))
            return v
        root = build(list(range(n)))
        t.suppress_degree_two(root)
    else:
        raise ValueError(f"unknown random-tree model {model!r}")
    return t


def _rexp(rng, mean: float = 0.1) -> float:
    return float(rng.exponential(mean))


# ------------------------------------------------- gene concordance factors
def gene_concordance(ref_tree: Tree, gene_trees: list[Tree]
                     ) -> dict[tuple[int, int], tuple[float, int]]:
    """gCF per internal branch of ref_tree: % of decisive gene trees whose
    induced topology contains the branch's split (reference:
    computeGeneConcordance, tree/discordance.cpp). Gene trees may have taxon
    subsets; a gene tree is decisive for a split if it has >=2 taxa on each
    side. Returns {branch: (gCF_percent, n_decisive)}."""
    name_to_id = {n: i for i, n in enumerate(ref_tree.taxon_names)}
    gene_data = []
    for gt in gene_trees:
        taxa = set()
        for i, nm in enumerate(gt.taxon_names):
            if gt.degree(i) > 0 and nm in name_to_id:
                taxa.add(name_to_id[nm])
        gsplits = set()
        for s in gt.splits().keys():
            mapped = frozenset(name_to_id[gt.taxon_names[x]] for x in s
                               if gt.taxon_names[x] in name_to_id)
            gsplits.add(mapped)
        gene_data.append((taxa, gsplits))

    out = {}
    for s, (a, b) in ref_tree.splits().items():
        support = 0
        decisive = 0
        for taxa, gsplits in gene_data:
            side1 = s & taxa
            side2 = taxa - s
            if len(side1) < 2 or len(side2) < 2:
                continue
            decisive += 1
            if frozenset(side1) in gsplits or frozenset(side2) in gsplits:
                support += 1
        pct = 100.0 * support / decisive if decisive else float("nan")
        out[Tree._key(a, b)] = (pct, decisive)
    return out


def site_concordance(ref_tree: Tree, aln, n_quartets: int = 100,
                     rng: np.random.Generator | None = None
                     ) -> dict[tuple[int, int], tuple[float, int]]:
    """sCF per internal branch: average over sampled quartets (one taxon
    from each of the four subtrees around the branch) of the % of decisive
    sites supporting the branch's quartet topology over the two alternatives
    (reference: computeSiteConcordance, tree/discordance.cpp:144).
    Returns {branch: (sCF_percent, n_decisive_sites_mean)}."""
    if rng is None:
        rng = np.random.default_rng(1)
    tbl = aln.seqtype.tip_table
    definite = tbl.sum(1) == 1.0
    state_of = tbl.argmax(1)
    codes = aln.tip_codes()             # [L, P]
    st = np.where(definite[codes], state_of[codes], -1)
    w = aln.pattern_weights

    out = {}
    for s, (u, v) in ref_tree.splits().items():
        # four groups: splits() gives the side containing... derive groups
        # around edge (u, v): the two subtrees on u's side minus edge, etc.
        groups = _quartet_groups(ref_tree, u, v)
        if groups is None:
            continue
        g1, g2, g3, g4 = groups
        if not (g1 and g2 and g3 and g4):
            continue
        vals = []
        nd = []
        for _ in range(n_quartets):
            a = g1[rng.integers(len(g1))]
            b = g2[rng.integers(len(g2))]
            c = g3[rng.integers(len(g3))]
            d = g4[rng.integers(len(g4))]
            sa, sb, sc, sd = st[a], st[b], st[c], st[d]
            ok = (sa >= 0) & (sb >= 0) & (sc >= 0) & (sd >= 0)
            # decisive site: supports exactly one pairing
            s12 = (sa == sb) & (sc == sd) & (sa != sc) & ok
            s13 = (sa == sc) & (sb == sd) & (sa != sb) & ok
            s14 = (sa == sd) & (sb == sc) & (sa != sb) & ok
            n12 = float((w * s12).sum())
            n13 = float((w * s13).sum())
            n14 = float((w * s14).sum())
            tot = n12 + n13 + n14
            if tot > 0:
                vals.append(100.0 * n12 / tot)
                nd.append(tot)
        if vals:
            out[Tree._key(u, v)] = (float(np.mean(vals)),
                                    float(np.mean(nd)))
    return out


def _quartet_groups(tree: Tree, u: int, v: int):
    """The four leaf groups around internal edge (u, v): the two subtrees
    hanging off u (other than v) and the two off v (other than u)."""
    if tree.is_leaf(u) or tree.is_leaf(v):
        return None
    gu = [tree.leaves_under(x, u) for x in tree.adj[u] if x != v]
    gv = [tree.leaves_under(x, v) for x in tree.adj[v] if x != u]
    if len(gu) < 2 or len(gv) < 2:
        return None
    return gu[0], gu[1], gv[0], gv[1]
