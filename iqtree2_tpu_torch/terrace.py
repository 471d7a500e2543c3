"""Phylogenetic terrace analysis.

Reference analog: runterraceanalysis (main/terraceanalysis.cpp:18) over
terrace/ + the vendored terraphast library: a TERRACE is a set of trees
with identical per-partition induced subtrees (Sanderson et al. 2011) —
they all have exactly the same likelihood under edge-unlinked partition
models, so the search cannot distinguish them.

This module provides:
  - induced split fingerprints per partition (the terrace invariant)
  - check_terrace: is the tree on a non-trivial terrace? (finds an NNI
    neighbor with identical fingerprints)
  - enumerate_terrace: BFS over fingerprint-preserving NNIs (capped) —
    a lower bound on the terrace size, like terraphast's enumeration with
    a budget.

Copied from iqtree2_tpu/terrace.py (host Python): the port keeps its own
host modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.tree.topology import Tree


def induced_fingerprint(tree: Tree, taxa_sets: list[set]) -> tuple:
    """Tuple of per-partition canonical induced split sets."""
    prints = []
    for taxa in taxa_sets:
        eff = frozenset(taxa)
        cur = set()
        if len(eff) >= 4:
            for s in tree.splits().keys():
                r = frozenset(set(s) & eff)
                o = frozenset(eff - r)
                if len(r) >= 2 and len(o) >= 2:
                    cur.add(min(r, o, key=lambda x: tuple(sorted(x))))
        prints.append(frozenset(cur))
    return tuple(prints)


def _nni_neighbors(tree: Tree):
    """Yield (neighbor tree, move description) over all NNIs."""
    for (a, b) in tree.internal_edges():
        for var in range(2):
            t2 = tree.copy()
            t2.apply_nni(a, b, var)
            yield t2


def check_terrace(tree: Tree, taxa_sets: list[set],
                  max_neighbors: int | None = None) -> bool:
    """True iff some NNI neighbor has identical induced subtrees
    (=> the terrace containing `tree` has size > 1)."""
    fp = induced_fingerprint(tree, taxa_sets)
    n = 0
    for t2 in _nni_neighbors(tree):
        if induced_fingerprint(t2, taxa_sets) == fp:
            return True
        n += 1
        if max_neighbors and n >= max_neighbors:
            break
    return False


def enumerate_terrace(tree: Tree, taxa_sets: list[set],
                      cap: int = 1000) -> int:
    """Number of distinct topologies reachable by fingerprint-preserving
    NNIs (capped): a lower bound on the terrace size."""
    fp = induced_fingerprint(tree, taxa_sets)
    seen = {tree.topology_id()}
    frontier = [tree]
    while frontier and len(seen) < cap:
        cur = frontier.pop()
        for t2 in _nni_neighbors(cur):
            tid = t2.topology_id()
            if tid in seen:
                continue
            if induced_fingerprint(t2, taxa_sets) == fp:
                seen.add(tid)
                frontier.append(t2)
                if len(seen) >= cap:
                    break
    return len(seen)


def count_terrace_exact(tree: Tree, taxa_sets: list[set],
                        max_blocks: int = 16,
                        max_states: int = 200_000) -> int | None:
    """EXACT terrace size: the number of binary trees on the full taxon
    set whose induced subtree on every partition's taxon set equals this
    tree's (reference: the vendored terraphast library,
    terraphast's README; Constantinescu & Sankoff 1995
    supertree counting as used by Biczok et al. 2018).

    Requires a comprehensive taxon (present in every partition) — the
    same precondition terraphast imposes. Returns None when that fails
    or the state space exceeds the caps (caller falls back to the BFS
    lower bound).

    Method: root everything at a comprehensive taxon r. Each partition's
    induced tree contributes one triplet constraint (x1, x2 | z) per
    inner cluster A: x1/x2 from two different child blocks of A, z from
    parent(A) \\ A — a displaying supertree must join x1,x2 below their
    lca with z. Counting then recurses: merge constraint pairs active in
    the current leaf set into blocks, sum over all bipartitions of the
    blocks (root split), multiply the two sides, memoize on the leaf
    set."""
    L = tree.ntaxa
    full = set(range(L))
    comp = set(full)
    for s in taxa_sets:
        comp &= set(s)
    if not comp:
        return None
    r = min(comp)

    # ---- constraints from each partition's induced clusters ----------
    constraints: set[tuple[int, int, int]] = set()
    splits = list(tree.splits().keys())
    for taxa in taxa_sets:
        T = set(taxa)
        if len(T) < 4 or r not in T:
            continue
        clusters = set()
        for s in splits:
            a = set(s) & T
            b = T - a
            if r in a:
                a, b = b, a
            if len(a) >= 2 and len(b) >= 2:
                clusters.add(frozenset(a))
        univ = frozenset(T - {r})
        for A in clusters:
            # parent: smallest strict supercluster (or the root cluster)
            parent = univ
            for B in clusters:
                if A < B and B < parent:
                    parent = B
            # child blocks of A: maximal proper subclusters + leftovers
            subs = [B for B in clusters if B < A]
            maximal = [B for B in subs
                       if not any(B < Bp for Bp in subs)]
            covered = set()
            blocks = []
            for B in maximal:
                blocks.append(sorted(B))
                covered |= B
            blocks += [[x] for x in sorted(A - covered)]
            if len(blocks) < 2:
                continue
            x1, x2 = blocks[0][0], blocks[1][0]
            z = min(parent - A)
            constraints.add((min(x1, x2), max(x1, x2), z))

    cons = sorted(constraints)
    memo: dict[frozenset, int] = {}
    budget = [max_states]

    def count(S: frozenset) -> int | None:
        if len(S) <= 2:
            return 1
        hit = memo.get(S)
        if hit is not None:
            return hit
        if budget[0] <= 0:
            return None
        budget[0] -= 1
        # union-find over active constraints
        par = {x: x for x in S}

        def find(x):
            while par[x] != x:
                par[x] = par[par[x]]
                x = par[x]
            return x

        for a, b, z in cons:
            if a in par and b in par and z in par:
                ra, rb = find(a), find(b)
                if ra != rb:
                    par[ra] = rb
        groups: dict[int, list[int]] = {}
        for x in S:
            groups.setdefault(find(x), []).append(x)
        blocks = list(groups.values())
        k = len(blocks)
        if k == 1:
            return 0
        if k - 1 > max_blocks:
            return None
        total = 0
        # iterate unordered bipartitions: block 0 always on side 1
        for mask in range(1 << (k - 1)):
            s1 = set(blocks[0])
            s2 = set()
            for j in range(1, k):
                (s1 if (mask >> (j - 1)) & 1 else s2).update(blocks[j])
            if not s2:
                continue
            c1 = count(frozenset(s1))
            c2 = count(frozenset(s2))
            if c1 is None or c2 is None:
                return None
            total += c1 * c2
        memo[S] = total
        return total

    return count(frozenset(full - {r}))


def coverage_taxa_sets(super_aln) -> list[set]:
    """Per-partition sets of taxa with any non-missing data (the
    presence/absence matrix of terrace/PresenceAbsenceMatrix)."""
    return [{int(i) for i in np.nonzero(pres)[0]}
            for pres in super_aln.part_presence]



def write_terrace_report(path: str, on_terrace: bool, size_lb: int,
                         cap: int, taxa_sets: list[set],
                         exact: bool = False) -> None:
    with open(path, "w") as f:
        f.write("Terrace analysis (Sanderson et al. 2011)\n")
        f.write(f"Partitions: {len(taxa_sets)}\n")
        for i, s in enumerate(taxa_sets):
            f.write(f"  partition {i + 1}: {len(s)} taxa with data\n")
        if exact:
            if on_terrace:
                f.write(f"Tree IS on a terrace of EXACTLY {size_lb} "
                        f"trees (supertree-count enumeration, "
                        f"terraphast analog)\n")
            else:
                f.write("Tree is NOT on a non-trivial terrace "
                        "(terrace size 1, exact count)\n")
        elif on_terrace:
            f.write(f"Tree IS on a terrace: >= {size_lb} trees"
                    f"{' (enumeration capped)' if size_lb >= cap else ''}"
                    "\n")
        else:
            f.write("Tree is NOT on a non-trivial terrace (terrace size "
                    "1)\n")
