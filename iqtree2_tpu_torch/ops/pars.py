"""Bit-parallel Fitch parsimony (host numpy).

States are bitmasks in uint64 (supports up to 64 states: DNA=4, AA=20,
codon=61). Reference analogs: tree/phylotreepars.cpp:32 (Fitch kernel),
pll/fastDNAparsimony.c (randomized stepwise addition used for start trees).

The pattern axis is vectorized with numpy; edge-candidate scoring during
stepwise addition is batched as one [n_edges, patterns] operation.

Copied from iqtree2_tpu/ops/pars.py: the port keeps its own host modules and
imports nothing of the JAX package. The Sankoff score runs on the host
(sankoff_score, the copy) and on a device (sankoff_score_device, in plain
torch where the JAX function is XLA: a min-plus pass over the tree
schedule's level steps).
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.tree.topology import Tree


def state_bitmasks(aln) -> np.ndarray:
    """[ntaxa, patterns] uint64 bitmask of compatible states per tip.

    SuperAlignments concatenate per-partition masks along the pattern axis
    (bitmask width is per-column, so mixed state counts coexist)."""
    if hasattr(aln, "partitions"):  # SuperAlignment
        return np.concatenate([state_bitmasks(p) for p in aln.partitions],
                              axis=1)
    tbl = aln.seqtype.tip_table  # [codes, S]
    S = aln.num_states
    if S > 64:
        raise ValueError("parsimony bitmasks support up to 64 states")
    weights = (1 << np.arange(S, dtype=np.uint64))
    code_masks = (tbl > 0) @ weights  # [codes]
    code_masks = code_masks.astype(np.uint64)
    return code_masks[aln.tip_codes()]  # [L, P]


def fitch_combine(a: np.ndarray, b: np.ndarray):
    """Fitch downpass combine: (sets, extra_cost_mask)."""
    inter = a & b
    empty = inter == 0
    out = np.where(empty, a | b, inter)
    return out, empty


def fitch_score(tree: Tree, masks: np.ndarray,
                weights: np.ndarray) -> float:
    """Weighted Fitch parsimony score of a topology.

    Uses the native bit-parallel kernel (native/iqtree2_native.cpp
    it2_fitch_score; reference analog tree/phylotreepars.cpp:32) when
    available; multifurcations are binarized into combine chains."""
    from iqtree2_tpu_torch import native
    if native.available():
        root = tree._default_root()
        L = tree.ntaxa
        rows: list[tuple[int, int]] = []
        idx: dict[int, int] = {}
        for v, p in tree.postorder(root):
            if tree.is_leaf(v):
                idx[v] = v
                continue
            kids = [idx[u] for u in tree.adj[v] if u != p]
            acc = kids[0]
            for u in kids[1:]:
                rows.append((acc, u))
                acc = L + len(rows) - 1
            idx[v] = acc
        if rows:
            out = native.fitch_score(
                masks, weights, np.asarray(rows, dtype=np.int32))
            if out is not None:
                return out
    root = tree._default_root()
    P = masks.shape[1]
    cost = np.zeros(P, dtype=np.float64)
    sets: dict[int, np.ndarray] = {}
    for v, p in tree.postorder(root):
        if tree.is_leaf(v):
            sets[v] = masks[v]
            continue
        kids = [u for u in tree.adj[v] if u != p]
        acc = sets[kids[0]]
        for u in kids[1:]:
            acc, extra = fitch_combine(acc, sets[u])
            cost += extra
        sets[v] = acc
    return float((cost * weights).sum())


def sankoff_score(tree: Tree, codes: np.ndarray, weights: np.ndarray,
                  cost: np.ndarray, tip_table: np.ndarray) -> float:
    """Weighted Sankoff parsimony with an arbitrary state-change cost
    matrix (reference: the Sankoff kernel, tree/phylotreepars.cpp:636).

    codes: [L, P] tip codes; cost: [S, S]; tip_table: [ncodes, S]
    indicator rows (ambiguity = 0-cost for every compatible state).
    Vectorized over patterns: S_v(x, p) = sum_children min_y (c(x,y) +
    S_u(y, p)).
    """
    BIG = 1e30
    # tip state costs: 0 for compatible states, BIG otherwise
    tip_cost = np.where(tip_table > 0, 0.0, BIG)      # [ncodes, S]
    root = tree._default_root()
    dp: dict[int, np.ndarray] = {}
    for v, p in tree.postorder(root):
        if tree.is_leaf(v):
            dp[v] = tip_cost[codes[v]].T              # [S, P]
            continue
        acc = None
        for u in tree.adj[v]:
            if u == p:
                continue
            # min over child state y of cost[x, y] + dp[u][y]
            m = (cost[:, :, None] + dp[u][None, :, :]).min(axis=1)
            acc = m if acc is None else acc + m
        dp[v] = acc
    return float((dp[root].min(axis=0) * weights).sum())


def sankoff_score_device(tree: Tree, codes: np.ndarray,
                         weights: np.ndarray, cost: np.ndarray,
                         tip_table: np.ndarray, device="cuda") -> float:
    """Sankoff on a device (counterpart of the JAX package's XLA
    sankoff_score_device): the min-plus analog of the down pass over the
    same TreeSchedule arrays, in float32 — each level step one batched
    [G, 2, S, S, P] min-reduction instead of a sum-product contraction,
    leaf 0 folded into the root. Reference: the Sankoff kernel of
    tree/phylotreepars.cpp:636 (computePartialParsimonySankoff). A tree
    that is not binary runs on the host (sankoff_score), as the schedule
    takes two children per node.
    """
    import torch

    from iqtree2_tpu_torch.tree.schedule import build_schedule

    if not tree.check_binary_unrooted():
        return sankoff_score(tree, codes, weights, cost, tip_table)
    BIG = 1e9
    sched = build_schedule(tree)
    L, n_int = sched.ntaxa, sched.n_int
    f32 = dict(dtype=torch.float32, device=device)
    tip_cost = np.where(tip_table > 0, 0.0, BIG)        # [ncodes, S]
    tipC = torch.as_tensor(np.transpose(tip_cost[codes], (0, 2, 1)), **f32)
    C = torch.as_tensor(cost, **f32)
    child_src = torch.as_tensor(sched.child_src, dtype=torch.long,
                                device=device)
    DP = torch.full((L + n_int,) + tipC.shape[1:], BIG, **f32)
    DP[:L] = tipC
    for nid in sched.step_node:
        nid = nid[nid < n_int]
        if not len(nid):
            continue
        rows = torch.as_tensor(nid, dtype=torch.long, device=device)
        src = DP[child_src[rows]]                        # [G, 2, S, P]
        m = (C[None, None, :, :, None] + src[:, :, None]).amin(dim=3)
        DP[L + rows] = m.sum(dim=1).clamp(max=BIG)       # [G, S, P]
    m0 = (C[:, :, None] + tipC[0][None]).amin(dim=1)
    total = (DP[L + n_int - 1] + m0).amin(dim=0)        # [P]
    return float((total * torch.as_tensor(weights, **f32)).sum())


def random_stepwise_addition(aln: Alignment, rng: np.random.Generator,
                             constraint=None) -> Tree:
    """Randomized stepwise-addition parsimony tree.

    Insert taxa in random order, each at the edge minimizing the Fitch
    insertion cost (batched over all candidate edges). The costs of a step
    come from native.stepwise_costs where the host library builds (the
    same sums in tiles of patterns, without the [edges, patterns] arrays
    that make the numpy loop take minutes at 1000 taxa x 16384 sites),
    else from the numpy loop below. Reference analog:
    pllComputeRandomizedStepwiseAdditionParsimonyTree (tree/iqtree.cpp:746).

    constraint: optional TopologyConstraint (-g) — insertion edges that
    would break a constraint split are rejected (cheapest compatible edge
    wins; reference: ConstraintTree gating in stepwise addition).
    """
    from iqtree2_tpu_torch import native
    masks = state_bitmasks(aln)
    w = aln.pattern_weights
    L = aln.ntaxa
    order = list(rng.permutation(L))
    tree = Tree(aln.names)
    if L < 4:
        if L == 2:
            tree.add_edge(order[0], order[1], 0.1)
        elif L == 3:
            c = tree.new_node()
            for x in order:
                tree.add_edge(c, x, 0.1)
        return tree

    first3 = [order.pop(), order.pop(), order.pop()]
    hub = tree.new_node()
    for x in first3:
        tree.add_edge(hub, x, 0.1)

    costs = native.stepwise_costs(masks, w, 2 * L)
    for leaf in reversed(order):
        # Fitch down+up sets for the current tree, per edge.
        # Root at the hub: the partial tree may not contain leaf 0 yet,
        # so Tree._default_root() is not usable here.
        root = hub
        post = list(tree.postorder(root))
        if costs is not None and tree._next_id > costs.down.shape[0]:
            # rejected insertions under a constraint allocate node ids
            # past the 2L the scratch was sized for
            costs = native.stepwise_costs(masks, w, 2 * tree._next_id)
        if costs is not None:
            kids = [[u for u in tree.adj[v] if u != p]
                    if not tree.is_leaf(v) else [] for v, p in post]
            edges = [(v, p) for v, p in post if p != -1]
            delta = costs(leaf, [v for v, _ in post], [p for _, p in post],
                          np.cumsum([0] + [len(k) for k in kids]),
                          [u for k in kids for u in k])
            _place(tree, leaf, edges, delta, constraint)
            continue
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
        # uppass context per node (state set seen from parent side)
        up: dict[int, np.ndarray] = {root: None}
        for v, p in reversed(post):
            if tree.is_leaf(v) and v != root:
                continue
            kids = [u for u in tree.adj[v] if u != p]
            for u in kids:
                ctx = up[v]
                acc = None
                for u2 in kids:
                    if u2 == u:
                        continue
                    acc = sets[u2] if acc is None else \
                        fitch_combine(acc, sets[u2])[0]
                if ctx is not None:
                    acc = ctx if acc is None else fitch_combine(acc, ctx)[0]
                up[u] = acc
        # candidate edges: all (child u, parent v) pairs
        edges = []
        ctx_sets = []
        for v, p in post:
            if p == -1:
                continue
            down = sets[v]
            upc = up[v]
            ctx = down if upc is None else fitch_combine(down, upc)[0]
            edges.append((v, p))
            ctx_sets.append(ctx)
        C = np.stack(ctx_sets)                    # [E, P]
        x = masks[leaf][None, :]                  # [1, P]
        delta = (((C & x) == 0) * w[None, :]).sum(axis=1)

        _place(tree, leaf, edges, delta, constraint)
    return tree


def _insert(tree: Tree, leaf: int, a: int, b: int) -> tuple[int, float]:
    """Attach ``leaf`` at the middle of edge (a, b); returns the new node
    and the edge's old length."""
    mid = tree.new_node()
    lold = tree.get_blen(a, b)
    tree.remove_edge(a, b)
    tree.add_edge(a, mid, lold * 0.5)
    tree.add_edge(mid, b, lold * 0.5)
    tree.add_edge(mid, leaf, 0.1)
    return mid, lold


def _place(tree: Tree, leaf: int, edges: list, delta: np.ndarray,
           constraint) -> None:
    """Insert ``leaf`` on the cheapest edge, under a constraint the
    cheapest that keeps every constraint split (the JAX package's
    insert/undo loop)."""
    if constraint is None or leaf not in constraint.mask:
        _insert(tree, leaf, *edges[int(np.argmin(delta))])
        return
    for ei in np.argsort(delta):
        a, b = edges[int(ei)]
        mid, lold = _insert(tree, leaf, a, b)
        if constraint.compatible(tree):
            return
        tree.remove_edge(a, mid)
        tree.remove_edge(mid, b)
        tree.remove_edge(mid, leaf)
        tree.add_edge(a, b, lold)
    # no compatible edge (should not happen)
    _insert(tree, leaf, *edges[int(np.argmin(delta))])
