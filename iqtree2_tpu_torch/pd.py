"""Phylogenetic diversity (PD) analysis.

Reference analog: the PDA feature set (pda/, runPDTree main/main.cpp:353):
find the k-taxon subset maximizing total spanned branch length. On trees
the GREEDY algorithm is exact (Steel 2005; the reference's pda greedy
mode), so PD optimization is a host loop:
  start from the two taxa with the largest pairwise path length; then
  repeatedly add the taxon with the largest distance to the current
  Steiner subtree.

Copied from iqtree2_tpu/pd.py: the port keeps its own host modules and
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.tree.topology import Tree


def pd_score(tree: Tree, taxa: list[int]) -> float:
    """Total branch length of the Steiner subtree spanning `taxa`."""
    taxa = set(taxa)
    if len(taxa) < 2:
        return 0.0
    root = next(iter(taxa))
    # count, per edge, whether it separates two nonempty parts of taxa
    total = 0.0
    for (a, b), ln in tree.blen.items():
        side = set(tree.leaves_under(a, b)) & taxa
        if side and (taxa - side):
            total += ln
    return total


def greedy_pd(tree: Tree, k: int) -> tuple[list[int], float, list[float]]:
    """(taxa, PD, PD-per-step) of the exact greedy k-taxon PD set."""
    L = tree.ntaxa
    k = min(k, L)
    # all-pairs path lengths via per-leaf Dijkstra-free tree walk
    dist = np.zeros((L, L))
    for s in range(L):
        # BFS with accumulated branch lengths
        seen = {s: 0.0}
        stack = [s]
        while stack:
            v = stack.pop()
            for u in tree.adj[v]:
                if u not in seen:
                    seen[u] = seen[v] + tree.get_blen(v, u)
                    stack.append(u)
        for t in range(L):
            dist[s, t] = seen.get(t, 0.0)
    i, j = np.unravel_index(np.argmax(dist[:L, :L]), (L, L))
    chosen = [int(i), int(j)]
    # distance of each leaf to the current Steiner subtree: maintained as
    # min over "attachment paths"; recompute exactly per step (host, small)
    pds = [float(dist[i, j])]
    while len(chosen) < k:
        base = pd_score(tree, chosen)
        best_gain, best_t = -1.0, None
        for t in range(L):
            if t in chosen:
                continue
            g = pd_score(tree, chosen + [t]) - base
            if g > best_gain:
                best_gain, best_t = g, t
        chosen.append(int(best_t))
        pds.append(base + best_gain)
    return chosen, pds[-1], pds


def budget_pd(tree: Tree, budget: float, costs: dict[int, float]
              ) -> tuple[list[int], float]:
    """Maximum-PD taxon set under a budget: each taxon has a cost, total
    cost must not exceed `budget` (reference: PDA -bud/-cost budget mode,
    pda/pdtree.h computeBudget/getSubsetRequiredBudget).

    Exact tree knapsack when costs quantize to integers (DP over the
    rooted tree, O(n * B^2)); greedy gain/cost otherwise."""
    L = tree.ntaxa
    c = np.array([float(costs.get(i, 1.0)) for i in range(L)])
    # integer quantization check
    scale = 1
    for s in (1, 10, 100):
        if np.allclose(c * s, np.round(c * s), atol=1e-9):
            scale = s
            break
    else:
        return _budget_pd_greedy(tree, budget, c)
    ci = np.round(c * scale).astype(int)
    B = int(np.floor(budget * scale + 1e-9))
    if B <= 0 or B > 100_000:
        return _budget_pd_greedy(tree, budget, c)

    # root at an internal node; DP[v] = array over budget b of the best
    # PD of a chosen subset within subtree(v) whose Steiner tree is
    # CONNECTED TO v (edge to v's parent will be paid by the parent if
    # the subtree is nonempty), plus a parallel "empty allowed" variant.
    root = L  # first internal node id
    NEG = -1e18
    parent: dict[int, int | None] = {root: None}
    order = [root]
    stack = [root]
    while stack:
        v = stack.pop()
        for u in tree.adj[v]:
            if u not in parent:
                parent[u] = v
                order.append(u)
                stack.append(u)

    # f[v][b]: max PD (edges BELOW v only) of a selection in subtree(v)
    # with cost exactly <= b, conditioned on v lying on the final
    # Steiner tree (v's parent edge is paid by the parent when the
    # subtree is used); sets[v][b]: a witness taxon bitmask.
    # The answer is the max over ALL nodes v (the chosen set's LCA node
    # scores it exactly; the root entry would overcount the path from
    # the LCA up to the root).
    f: dict[int, np.ndarray] = {}
    w_sets: dict[int, list[int]] = {}
    best_pd, best_mask = 0.0, 0
    for v in reversed(order):
        kids = [u for u in tree.adj[v] if u != parent[v]]
        if not kids:                       # leaf
            arr = np.full(B + 1, NEG)
            msk = [0] * (B + 1)
            if ci[v] <= B:
                arr[ci[v]:] = 0.0          # choosing the leaf costs c
                for b in range(ci[v], B + 1):
                    msk[b] = 1 << v
            f[v] = arr
            w_sets[v] = msk
            continue
        # acc1: exactly one child subtree used (v on a Steiner PATH —
        # valid for the parent, NOT a valid LCA); acc2: >= 2 children
        # used (v IS the branching LCA — harvest the global best here)
        acc1 = np.full(B + 1, NEG)
        acc2 = np.full(B + 1, NEG)
        m1: list[int] = [0] * (B + 1)
        m2: list[int] = [0] * (B + 1)
        for u in kids:
            wlen = tree.get_blen(u, v)
            child = f[u] + wlen            # include child => pay edge
            cm = w_sets[u]
            n1 = acc1.copy()
            n2 = acc2.copy()
            nm1, nm2 = list(m1), list(m2)
            for bb in range(B + 1):
                if child[bb] <= NEG / 2:
                    continue
                cv, cmm = child[bb], cm[bb]
                # empty-so-far + this child -> one child used
                if cv > n1[bb]:
                    n1[bb] = cv
                    nm1[bb] = cmm
                for b in range(B - bb + 1):
                    if acc1[b] > NEG / 2:
                        tot = acc1[b] + cv
                        if tot > n2[b + bb]:
                            n2[b + bb] = tot
                            nm2[b + bb] = m1[b] | cmm
                    if acc2[b] > NEG / 2:
                        tot = acc2[b] + cv
                        if tot > n2[b + bb]:
                            n2[b + bb] = tot
                            nm2[b + bb] = m2[b] | cmm
            acc1, acc2, m1, m2 = n1, n2, nm1, nm2
            del f[u], w_sets[u]
        b_here = int(np.argmax(acc2))
        if acc2[b_here] > best_pd:
            best_pd = float(acc2[b_here])
            best_mask = m2[b_here]
        fv = np.maximum(acc1, acc2)
        f[v] = fv
        w_sets[v] = [m1[b] if acc1[b] >= acc2[b] else m2[b]
                     for b in range(B + 1)]
    chosen = [i for i in range(L) if (best_mask >> i) & 1]
    return chosen, best_pd


def _budget_pd_greedy(tree: Tree, budget: float, c: np.ndarray
                      ) -> tuple[list[int], float]:
    L = tree.ntaxa
    chosen: list[int] = []
    spent = 0.0
    while True:
        base = pd_score(tree, chosen) if len(chosen) >= 2 else 0.0
        best_r, best_t, best_g = 0.0, None, 0.0
        for t in range(L):
            if t in chosen or spent + c[t] > budget + 1e-9:
                continue
            if len(chosen) == 0:
                g = 0.0
                r = 1e-12
            else:
                g = pd_score(tree, chosen + [t]) - base
                r = g / max(c[t], 1e-12)
            if best_t is None or r > best_r:
                best_r, best_t, best_g = r, t, g
        if best_t is None:
            break
        chosen.append(int(best_t))
        spent += c[best_t]
    return chosen, pd_score(tree, chosen)


def parse_cost_file(text: str, names: list[str]) -> dict[int, float]:
    """'taxon cost' per line (reference -cost budget file)."""
    n2i = {n: i for i, n in enumerate(names)}
    out = {}
    for ln in text.splitlines():
        parts = ln.split()
        if len(parts) >= 2 and parts[0] in n2i:
            out[n2i[parts[0]]] = float(parts[1])
    return out


def parse_sets_file(text: str, names: list[str]
                    ) -> dict[str, list[int]]:
    """Taxon sets / areas: 'name: t1 t2 ...' per line, or NEXUS-style
    'taxset name = t1 t2 ...;' lines (reference area/taxa-set files)."""
    n2i = {n: i for i, n in enumerate(names)}
    out: dict[str, list[int]] = {}
    for ln in text.splitlines():
        ln = ln.strip().rstrip(";")
        if not ln or ln.startswith("#"):
            continue
        low = ln.lower()
        if low.startswith("taxset "):
            ln = ln[7:]
            if "=" in ln:
                nm, rest = ln.split("=", 1)
            else:
                continue
        elif ":" in ln:
            nm, rest = ln.split(":", 1)
        else:
            continue
        ids = [n2i[t] for t in rest.split() if t in n2i]
        if ids:
            out[nm.strip()] = ids
    return out


def pd_user_sets(tree: Tree, sets: dict[str, list[int]]
                 ) -> dict[str, float]:
    """PD score of each user-defined taxon set (reference PD_USER_SET,
    main/main.cpp:371 computePD)."""
    return {nm: pd_score(tree, ids) for nm, ids in sets.items()}


def pd_endemism(tree: Tree, areas: dict[str, list[int]]
                ) -> dict[str, float]:
    """PD endemism of each area: branch length found ONLY in that area's
    Steiner tree (reference calcPDEndemism, pda/pdnetwork.cpp)."""
    names = list(areas)
    edge_in: dict[str, set] = {nm: set() for nm in names}
    for nm in names:
        taxa = set(areas[nm])
        for (a, b), ln in tree.blen.items():
            side = set(tree.leaves_under(a, b)) & taxa
            if side and (taxa - side):
                edge_in[nm].add((a, b))
    out = {}
    for nm in names:
        others = set()
        for o in names:
            if o != nm:
                others |= edge_in[o]
        out[nm] = sum(tree.blen[e] for e in edge_in[nm] - others)
    return out


def pd_complementarity(tree: Tree, areas: dict[str, list[int]],
                       given: list[str]) -> dict[str, float]:
    """PD complementarity of each area w.r.t. a given area set: extra PD
    the area adds beyond the given areas' union (reference
    calcPDComplementarity, pda/pdnetwork.cpp)."""
    base_taxa: list[int] = []
    for g in given:
        base_taxa += areas.get(g, [])
    base = pd_score(tree, base_taxa) if len(set(base_taxa)) >= 2 else 0.0
    out = {}
    for nm, ids in areas.items():
        if nm in given:
            continue
        out[nm] = pd_score(tree, list(set(base_taxa) | set(ids))) - base
    return out


def greedy_pd_areas(tree: Tree, areas: dict[str, list[int]], k: int
                    ) -> tuple[list[str], float]:
    """Maximum-PD set of k areas (exhaustive for <= 20 areas, greedy
    otherwise; reference findPDArea_LP solves the same objective by LP,
    pda/pdnetwork.h:218)."""
    names = list(areas)
    m = len(names)
    k = min(k, m)
    if m <= 20:
        import itertools
        best, best_pd = None, -1.0
        for combo in itertools.combinations(range(m), k):
            taxa = set()
            for i in combo:
                taxa |= set(areas[names[i]])
            v = pd_score(tree, list(taxa)) if len(taxa) >= 2 else 0.0
            if v > best_pd:
                best_pd, best = v, combo
        return [names[i] for i in best], best_pd
    chosen: list[str] = []
    taxa: set[int] = set()
    for _ in range(k):
        best, best_pd = None, -1.0
        for nm in names:
            if nm in chosen:
                continue
            t2 = taxa | set(areas[nm])
            v = pd_score(tree, list(t2)) if len(t2) >= 2 else 0.0
            if v > best_pd:
                best_pd, best = v, nm
        chosen.append(best)
        taxa |= set(areas[best])
    return chosen, pd_score(tree, list(taxa))


def write_pda_report(path: str, tree: Tree, taxa: list[int], pd: float,
                     steps: list[float]) -> None:
    with open(path, "w") as f:
        f.write(f"Phylogenetic diversity (greedy, exact on trees)\n")
        f.write(f"k = {len(taxa)}  PD = {pd:.6f}\n")
        f.write("Taxa:\n")
        for t in taxa:
            f.write(f"  {tree.taxon_names[t]}\n")
        f.write("PD by subset size:\n")
        for n, v in enumerate(steps, start=2):
            f.write(f"  {n}\t{v:.6f}\n")
