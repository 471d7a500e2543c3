"""Host-side phylogenetic tree: adjacency structure, Newick I/O, topology
edits (NNI/SPR), splits.

Reference analogs: tree/mtree.cpp (Newick I/O, traversal), tree/node.h
(Node/Neighbor), pda/split.h (Split bitsets). Everything here is pure-Python
control-plane; device math never sees this class — it sees the flat index
arrays produced by tree/schedule.py.

Copied from iqtree2_tpu/tree/topology.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import io
import math
import re
from collections import defaultdict

import numpy as np


class Tree:
    """An unrooted (or rooted) phylogenetic tree over named leaves.

    Nodes are integer ids. Leaves are 0..ntaxa-1 in the order of
    ``taxon_names``; internal nodes get higher ids. Branch lengths live on
    unordered node pairs.
    """

    def __init__(self, taxon_names: list[str]):
        self.taxon_names = list(taxon_names)
        self.adj: dict[int, list[int]] = defaultdict(list)
        self.blen: dict[tuple[int, int], float] = {}
        # per-class branch lengths for heterotachy (+H) models: edge key
        # -> [H] vector; edges absent here fall back to the scalar length
        # (reference: PhyloTreeMixlen stores lengths per mixture class,
        # tree/phylotreemixlen.h)
        self.blen_h: dict[tuple[int, int], "object"] = {}
        self._next_id = len(taxon_names)

    # ------------------------------------------------------------- helpers
    @property
    def ntaxa(self) -> int:
        return len(self.taxon_names)

    def copy(self) -> "Tree":
        t = Tree(self.taxon_names)
        t.adj = defaultdict(list, {k: list(v) for k, v in self.adj.items()})
        t.blen = dict(self.blen)
        t.blen_h = dict(self.blen_h)
        t._next_id = self._next_id
        return t

    def new_node(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid

    @staticmethod
    def _key(a: int, b: int) -> tuple[int, int]:
        return (a, b) if a < b else (b, a)

    def add_edge(self, a: int, b: int, length: float = 0.0) -> None:
        self.adj[a].append(b)
        self.adj[b].append(a)
        self.blen[self._key(a, b)] = length

    def remove_edge(self, a: int, b: int) -> None:
        self.adj[a].remove(b)
        self.adj[b].remove(a)
        del self.blen[self._key(a, b)]

    def get_blen(self, a: int, b: int) -> float:
        return self.blen[self._key(a, b)]

    def set_blen(self, a: int, b: int, length: float) -> None:
        self.blen[self._key(a, b)] = length

    def degree(self, v: int) -> int:
        return len(self.adj[v])

    def is_leaf(self, v: int) -> bool:
        return v < self.ntaxa

    def nodes(self) -> list[int]:
        return [v for v in self.adj if self.adj[v]] + \
            [v for v in range(self.ntaxa) if not self.adj[v]]

    def edges(self) -> list[tuple[int, int]]:
        return list(self.blen.keys())

    def internal_edges(self) -> list[tuple[int, int]]:
        return [(a, b) for (a, b) in self.blen
                if not self.is_leaf(a) and not self.is_leaf(b)]

    def num_edges(self) -> int:
        return len(self.blen)

    def total_length(self) -> float:
        return sum(self.blen.values())

    def check_binary_unrooted(self) -> bool:
        """All leaves degree 1, all internal nodes degree 3."""
        for v in self.nodes():
            d = self.degree(v)
            if self.is_leaf(v):
                if d != 1:
                    return False
            elif d != 3:
                return False
        return True

    # ----------------------------------------------------------- traversal
    def postorder(self, root: int | None = None):
        """Yield (node, parent) in postorder from an arbitrary root."""
        if root is None:
            root = self._default_root()
        stack = [(root, -1, False)]
        while stack:
            v, p, done = stack.pop()
            if done:
                yield v, p
            else:
                stack.append((v, p, True))
                for u in self.adj[v]:
                    if u != p:
                        stack.append((u, v, False))

    def _default_root(self) -> int:
        """Deterministic root: the internal node adjacent to leaf 0."""
        if self.ntaxa == 0:
            raise ValueError("empty tree")
        if not self.adj[0]:
            raise ValueError("leaf 0 not connected")
        nb = self.adj[0][0]
        return nb if not self.is_leaf(nb) else 0

    def leaves_under(self, v: int, p: int) -> list[int]:
        out = []
        stack = [(v, p)]
        while stack:
            x, par = stack.pop()
            if self.is_leaf(x):
                out.append(x)
            for u in self.adj[x]:
                if u != par:
                    stack.append((u, x))
        return out

    # -------------------------------------------------------------- splits
    def splits(self, internal_only: bool = True) -> dict[frozenset, tuple]:
        """Map from leaf-set split (smaller side, as frozenset of taxon ids)
        to the defining edge. Reference analog: pda/split.h."""
        out = {}
        all_taxa = frozenset(range(self.ntaxa))
        for (a, b) in self.blen:
            if internal_only and (self.is_leaf(a) or self.is_leaf(b)):
                continue
            side = frozenset(self.leaves_under(a, b))
            if len(side) > self.ntaxa - len(side) or (
                    2 * len(side) == self.ntaxa and 0 not in side):
                side = all_taxa - side
            out[side] = (a, b)
        return out

    def transfer_blen_h(self, dst: "Tree") -> None:
        """Copy per-class (+H) branch vectors onto ``dst``, which must
        have the same topology but possibly different node ids (e.g.
        after a newick round-trip).  Edges are matched by leaf-set
        split; tip edges by the leaf id."""
        if not self.blen_h:
            return
        src_splits = self.splits(internal_only=False)
        dst_splits = dst.splits(internal_only=False)
        for side, (a, b) in src_splits.items():
            v = self.blen_h.get(self._key(a, b))
            pair = dst_splits.get(side)
            if v is not None and pair is not None:
                dst.blen_h[self._key(*pair)] = v

    def robinson_foulds(self, other: "Tree") -> int:
        s1 = set(self.splits().keys())
        s2 = set(other.splits().keys())
        return len(s1 ^ s2)

    def topology_id(self) -> str:
        """Canonical topology string (sorted splits) for candidate-set
        dedup (reference analog: getTopologyString)."""
        keys = sorted(tuple(int(x) for x in sorted(s))
                      for s in self.splits().keys())
        return repr(keys)

    # ----------------------------------------------------------------- NNI
    def nni_candidates(self) -> list[tuple[int, int]]:
        return self.internal_edges()

    def apply_nni(self, a: int, b: int, variant: int) -> None:
        """Apply an NNI around internal edge (a,b).

        variant 0 swaps (first other-neighbor of a) with (first of b);
        variant 1 swaps it with the second of b. Branch lengths ride along.
        """
        na = [x for x in self.adj[a] if x != b]
        nb = [x for x in self.adj[b] if x != a]
        x = na[0]
        y = nb[variant]
        lx = self.get_blen(a, x)
        ly = self.get_blen(b, y)
        self.remove_edge(a, x)
        self.remove_edge(b, y)
        self.add_edge(a, y, ly)
        self.add_edge(b, x, lx)

    def swap_subtrees(self, u: int, x: int, v: int, y: int) -> None:
        """Swap neighbor x of u with neighbor y of v (branch lengths ride
        with the moved subtrees). Used to apply a specific NNI."""
        lx = self.get_blen(u, x)
        ly = self.get_blen(v, y)
        self.remove_edge(u, x)
        self.remove_edge(v, y)
        self.add_edge(u, y, ly)
        self.add_edge(v, x, lx)

    # ----------------------------------------------------------------- SPR
    def spr_prune_regraft(self, sv: int, su: int, ta: int, tb: int,
                          frac: float = 0.5) -> None:
        """Prune the subtree hanging from edge (su -> sv) (sv side kept as
        the moving subtree root attachment node su must be degree-3), and
        regraft onto edge (ta, tb)."""
        if self.degree(su) != 3:
            raise ValueError("can only prune at a degree-3 node")
        others = [x for x in self.adj[su] if x != sv]
        o1, o2 = others
        l1 = self.get_blen(su, o1)
        l2 = self.get_blen(su, o2)
        self.remove_edge(su, o1)
        self.remove_edge(su, o2)
        self.add_edge(o1, o2, l1 + l2)
        lt = self.get_blen(ta, tb)
        self.remove_edge(ta, tb)
        self.add_edge(ta, su, lt * frac)
        self.add_edge(su, tb, lt * (1 - frac))

    # --------------------------------------------------------------- I/O
    @classmethod
    def from_newick(cls, newick: str,
                    taxon_names: list[str] | None = None) -> "Tree":
        """Parse a Newick string. If taxon_names given, leaf ids follow that
        order; otherwise leaves are numbered by first appearance."""
        s = newick.strip()
        if s.endswith(";"):
            s = s[:-1]
        tokens = _tokenize_newick(s)
        names_seen: list[str] = []
        # first pass: collect leaf names in order
        _collect_leaf_names(tokens, names_seen)
        if taxon_names is None:
            taxon_names = names_seen
        name_to_id = {n: i for i, n in enumerate(taxon_names)}
        missing = [n for n in names_seen if n not in name_to_id]
        if missing:
            raise ValueError(f"tree has unknown taxa: {missing[:5]}")
        t = cls(taxon_names)
        pos = [0]

        def parse_clade() -> tuple[int, float]:
            """Returns (node_id, branch_length_to_parent)."""
            if tokens[pos[0]] == "(":
                pos[0] += 1
                children = []
                while True:
                    children.append(parse_clade())
                    if tokens[pos[0]] == ",":
                        pos[0] += 1
                        continue
                    break
                assert tokens[pos[0]] == ")", f"expected ) at {pos[0]}"
                pos[0] += 1
                v = t.new_node()
                for (c, bl) in children:
                    t.add_edge(v, c, bl)
                # optional internal label (support value) and length
                label, bl = _read_label_length(tokens, pos)
                return v, bl
            else:
                label, bl = _read_label_length(tokens, pos)
                if label not in name_to_id:
                    raise ValueError(f"unknown taxon {label!r}")
                return name_to_id[label], bl

        root, _ = parse_clade()
        # suppress a degree-2 root (rooted newick) to get unrooted form
        t.suppress_degree_two(root)
        return t

    def suppress_degree_two(self, v: int | None = None) -> None:
        targets = [v] if v is not None else [
            u for u in list(self.adj) if not self.is_leaf(u)]
        for u in targets:
            if u is None or self.is_leaf(u):
                continue
            while u in self.adj and len(self.adj[u]) == 2:
                a, b = self.adj[u]
                la = self.get_blen(u, a)
                lb = self.get_blen(u, b)
                self.remove_edge(u, a)
                self.remove_edge(u, b)
                del self.adj[u]
                self.add_edge(a, b, la + lb)
                break

    def to_newick(self, root: int | None = None, digits: int = 10,
                  support: dict[tuple[int, int], float] | None = None) -> str:
        if root is None:
            root = self._default_root()
        elif self.is_leaf(root) and self.adj[root]:
            # printing "from" a leaf (e.g. -o outgroup display rooting):
            # start at its neighbor so the outgroup leads the newick
            root = next(iter(self.adj[root]))
        buf = io.StringIO()

        def fmt(x: float) -> str:
            return f"{x:.{digits}g}"

        def write_clade(v: int, p: int) -> None:
            if self.is_leaf(v):
                buf.write(_quote_name(self.taxon_names[v]))
            else:
                buf.write("(")
                kids = [u for u in self.adj[v] if u != p]
                for i, u in enumerate(kids):
                    if i:
                        buf.write(",")
                    write_clade(u, v)
                    buf.write(":" + fmt(self.get_blen(v, u)))
                buf.write(")")
                if support is not None and p != -1:
                    key = self._key(v, p)
                    if key in support:
                        val = support[key]
                        buf.write(f"{val:g}" if isinstance(val, float)
                                  else str(val))

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10 * self.ntaxa + 1000))
        try:
            write_clade(root, -1)
        finally:
            sys.setrecursionlimit(old)
        buf.write(";")
        return buf.getvalue()

    # ------------------------------------------------------------- editing
    def set_all_blens(self, length: float) -> None:
        for k in self.blen:
            self.blen[k] = length

    def clamp_blens(self, lo: float, hi: float) -> None:
        for k in self.blen:
            self.blen[k] = min(max(self.blen[k], lo), hi)

    @classmethod
    def random_topology(cls, taxon_names: list[str],
                        rng: np.random.Generator,
                        blen_dist=None) -> "Tree":
        """Uniform random binary unrooted topology by random sequential
        addition (reference analog: MExtTree::generateRandomTree)."""
        n = len(taxon_names)
        t = cls(taxon_names)
        if n == 1:
            return t
        if n == 2:
            t.add_edge(0, 1, _draw(blen_dist, rng))
            return t
        order = rng.permutation(n)
        v = t.new_node()
        for leaf in order[:3]:
            t.add_edge(v, int(leaf), _draw(blen_dist, rng))
        for leaf in order[3:]:
            ea, eb = t.edges()[rng.integers(0, t.num_edges())]
            mid = t.new_node()
            l_old = t.get_blen(ea, eb)
            t.remove_edge(ea, eb)
            t.add_edge(ea, mid, l_old * 0.5)
            t.add_edge(mid, eb, l_old * 0.5)
            t.add_edge(mid, int(leaf), _draw(blen_dist, rng))
        return t


def _draw(dist, rng) -> float:
    if dist is None:
        return float(rng.exponential(0.1))
    return float(dist(rng))


def _quote_name(name: str) -> str:
    if re.search(r"[\s(),:;\[\]']", name):
        return "'" + name.replace("'", "''") + "'"
    return name


def _tokenize_newick(s: str) -> list[str]:
    tokens = []
    i = 0
    n = len(s)
    while i < n:
        ch = s[i]
        if ch in "(),:":
            tokens.append(ch)
            i += 1
        elif ch == "'":
            j = i + 1
            buf = []
            while j < n:
                if s[j] == "'" and j + 1 < n and s[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif s[j] == "'":
                    break
                else:
                    buf.append(s[j])
                    j += 1
            tokens.append("\x00" + "".join(buf))  # mark as quoted label
            i = j + 1
        elif ch.isspace():
            i += 1
        elif ch == "[":  # comment
            j = s.find("]", i)
            i = (j + 1) if j >= 0 else n
        else:
            j = i
            while j < n and s[j] not in "(),:;[' \t\n":
                j += 1
            tokens.append(s[i:j])
            i = j
    return tokens


def _read_label_length(tokens: list[str], pos: list[int]) -> tuple[str, float]:
    label = ""
    bl = 0.0
    if pos[0] < len(tokens) and tokens[pos[0]] not in "(),:":
        label = tokens[pos[0]]
        if label.startswith("\x00"):
            label = label[1:]
        pos[0] += 1
    if pos[0] < len(tokens) and tokens[pos[0]] == ":":
        pos[0] += 1
        bl = float(tokens[pos[0]])
        pos[0] += 1
    return label, bl


def _collect_leaf_names(tokens: list[str], out: list[str]) -> None:
    """Leaf names = label tokens immediately after '(' or ','."""
    for i, tok in enumerate(tokens):
        if tok in "(),:":
            continue
        if i > 0 and tokens[i - 1] in "(,":
            name = tok[1:] if tok.startswith("\x00") else tok
            out.append(name)
