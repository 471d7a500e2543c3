"""Topology -> static index arrays driving the jitted likelihood kernels.

The tree is rooted (for computation only) at the internal node adjacent to
leaf 0, and **leaf 0 itself is excluded from the traversal**: its message is
folded into the final root reduction. This makes every internal node have
exactly two children, so the pruning kernel has no wasted child slots and no
validity masking (reference contrast: phylokernelnew.h handles
multifurcations generically; we require binary trees like the search does).

Nodes are additionally grouped into **level steps**: step s holds up to G
independent internal nodes whose children were all computed in steps < s
(greedy list scheduling on the child-dependency DAG). One pruning step is
then a single batched [G*2*C, S, S] x [G*2*C, S, Ppat] contraction instead
of one tiny matmul per node — this is what lets XLA fill the MXU / keep HBM
streaming (SURVEY §7 "Small-state MXU utilization"; reference analog: the
traversal worklist of computeTraversalInfo, tree/phylokernelnew.h:1150,
which batches packets x traversal on CPU threads).

All array shapes depend only on (ntaxa, n_steps-bucket), never on the
topology itself, so NNI/SPR moves almost never trigger XLA recompilation
(n_steps is bucketed to a multiple of 4; G is fixed per ntaxa).

Unified source indexing: partials for leaves and internal nodes live in ONE
device buffer of length L + n_int (tips broadcast over rate categories),
  leaf v           -> row v                       (0..L-1)
  internal node i  -> row L + postorder(i)
so gathering a pruning step's inputs is a single take.

Edge numbering (unchanged from round 1): every node except the root owns the
edge to its parent:
  leaf v           -> edge id v                  (0..L-1; edge 0 = root-leaf0)
  internal node i  -> edge id L + postorder(i)   (root excluded)
Total edges = 2L-3 for an unrooted binary tree with L leaves.

Copied from iqtree2_tpu/tree/schedule.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from iqtree2_tpu_torch.tree.topology import Tree


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def pick_group_size(n_int: int) -> int:
    """Fixed per-ntaxa level width G (jit-key stable across topologies)."""
    return min(_next_pow2(max(n_int, 1)), 64)


@dataclasses.dataclass
class TreeSchedule:
    """Flat arrays describing one rooted traversal of a topology."""

    ntaxa: int
    n_int: int
    n_edges: int
    # [n_int, 2]: unified source index of each child (see module docstring)
    child_src: np.ndarray
    # [n_int, 2]: edge id of the child edge
    child_edge: np.ndarray
    # [n_steps, G]: postorder indices grouped into independent level steps,
    # padded with n_int (kernels scatter with mode="drop")
    step_node: np.ndarray
    # [n_edges]: unified source index of each edge's child endpoint
    edge_src: np.ndarray
    # [n_edges] branch lengths
    blens: np.ndarray
    # host bookkeeping: edge id -> (child_node, parent_node) original ids
    edge_nodes: list
    # host: postorder idx -> original node id
    postorder_nodes: list
    root: int

    def to_device_arrays(self) -> dict:
        return dict(child_src=self.child_src, child_edge=self.child_edge,
                    step_node=self.step_node, edge_src=self.edge_src)

    # convenience for host code that needs to know whether a child is a leaf
    def child_is_leaf(self, i: int, k: int) -> bool:
        return int(self.child_src[i, k]) < self.ntaxa


def _level_steps(child_src: np.ndarray, L: int, G: int) -> np.ndarray:
    """Greedy list scheduling: pack postorder nodes into width-G steps such
    that a node's internal children always land in strictly earlier steps.
    Returns [n_steps, G] int32 padded with n_int; n_steps is bucketed to a
    multiple of 4 so small topology changes reuse the compiled kernel."""
    n_int = child_src.shape[0]
    step_of = np.full(n_int, -1, dtype=np.int64)
    unscheduled = list(range(n_int))
    steps: list[list[int]] = []
    while unscheduled:
        cur: list[int] = []
        for i in unscheduled:
            if len(cur) == G:
                break
            ok = True
            for k in range(2):
                s = child_src[i, k]
                if s >= L and step_of[s - L] < 0:
                    ok = False
                    break
            if ok:
                cur.append(i)
        if not cur:  # cannot happen for a valid postorder, but be safe
            raise RuntimeError("level scheduling stalled")
        for i in cur:
            step_of[i] = len(steps)
        cur_set = set(cur)
        unscheduled = [i for i in unscheduled if i not in cur_set]
        steps.append(cur)
    n_steps = -(-len(steps) // 4) * 4
    out = np.full((n_steps, G), n_int, dtype=np.int32)
    for s, nodes in enumerate(steps):
        out[s, : len(nodes)] = nodes
    return out


def build_schedule(tree: Tree, root: int | None = None,
                   group_size: int | None = None) -> TreeSchedule:
    L = tree.ntaxa
    if root is None:
        root = tree._default_root()
    post = [(v, p) for (v, p) in tree.postorder(root)
            if not tree.is_leaf(v)]
    n_int = len(post)
    order_idx = {v: i for i, (v, p) in enumerate(post)}

    child_src = np.zeros((n_int, 2), dtype=np.int32)
    child_edge = np.zeros((n_int, 2), dtype=np.int32)

    n_edges = L + n_int - 1
    edge_nodes: list = [None] * n_edges
    blens = np.zeros(n_edges, dtype=np.float64)
    edge_src = np.zeros(n_edges, dtype=np.int32)

    def edge_id(child: int) -> int:
        if tree.is_leaf(child):
            return child
        return L + order_idx[child]

    for i, (v, p) in enumerate(post):
        kids = [u for u in tree.adj[v] if u != p]
        if v == root:
            kids = [u for u in kids if u != 0]  # leaf 0 folds into the root
        if len(kids) != 2:
            raise ValueError(
                f"node {v} has {len(kids)} children; tree must be binary "
                "(unrooted, rooted at the internal node adjacent to leaf 0)")
        for k, u in enumerate(kids):
            e = edge_id(u)
            src = u if tree.is_leaf(u) else L + order_idx[u]
            child_src[i, k] = src
            child_edge[i, k] = e
            edge_nodes[e] = (u, v)
            edge_src[e] = src
            blens[e] = tree.get_blen(u, v)

    # edge 0: root <-> leaf 0 (owned by leaf 0, folded at the root)
    edge_nodes[0] = (0, root)
    edge_src[0] = 0
    blens[0] = tree.get_blen(0, root)

    G = group_size or pick_group_size(n_int)
    step_node = _level_steps(child_src, L, G)

    return TreeSchedule(
        ntaxa=L, n_int=n_int, n_edges=n_edges,
        child_src=child_src, child_edge=child_edge, step_node=step_node,
        edge_src=edge_src, blens=blens, edge_nodes=edge_nodes,
        postorder_nodes=[v for (v, _) in post], root=root)


def write_blens_to_tree(tree: Tree, sched: TreeSchedule,
                        blens: np.ndarray) -> None:
    """Copy optimized branch lengths back onto the host tree."""
    for e, pair in enumerate(sched.edge_nodes):
        if pair is None:
            continue
        a, b = pair
        tree.set_blen(a, b, float(blens[e]))
