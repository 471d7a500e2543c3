"""Constraint trees (-g): every searched topology must contain the splits
of a user-supplied (possibly multifurcating, possibly partial-taxon)
constraint tree, restricted to the constraint's taxon set.

Reference analog: ConstraintTree (tree/constrainttree.cpp) — used to gate
stepwise addition, perturbation, and NNI acceptance.


Copied from iqtree2_tpu/tree/constraint.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import re

from iqtree2_tpu_torch.tree.topology import Tree


def _tokenize(nwk: str):
    return re.findall(r"\(|\)|,|;|[^(),;:]+(?::[0-9.eE+-]+)?", nwk)


def _parse_clades(nwk: str, name_to_id: dict) -> list[set]:
    """All clades (leaf-id sets) of a newick string; names not in
    name_to_id raise."""
    clades: list[set] = []
    stack: list[set] = []
    for tok in _tokenize(nwk):
        tok = tok.strip()
        if not tok:
            continue
        if tok == "(":
            stack.append(set())
        elif tok in (")", ","):
            if tok == ")":
                clade = stack.pop()
                clades.append(clade)
                if stack:
                    stack[-1] |= clade
                else:
                    stack.append(clade)
        elif tok == ";":
            break
        else:
            name = tok.split(":")[0].strip().strip("'\"")
            if not name:        # internal label / support value
                continue
            if name not in name_to_id:
                # internal node labels (e.g. supports) are not taxa
                if re.fullmatch(r"[0-9.]+", name):
                    continue
                raise ValueError(
                    f"constraint tree taxon '{name}' not in alignment")
            if stack:
                stack[-1].add(name_to_id[name])
            else:
                stack.append({name_to_id[name]})
    return clades


class TopologyConstraint:
    """Splits of a constraint tree over a (subset of) the taxon set."""

    def __init__(self, newick: str, names: list[str]):
        name_to_id = {n: i for i, n in enumerate(names)}
        # only taxa that actually appear constrain the topology
        present = set()
        for tok in _tokenize(newick):
            nm = tok.strip().split(":")[0].strip().strip("'\"")
            if nm in name_to_id:
                present.add(name_to_id[nm])
        self.mask = frozenset(present)
        clades = _parse_clades(newick, name_to_id)
        self.splits: set[frozenset] = set()
        for c in clades:
            s = frozenset(c & self.mask)
            if 2 <= len(s) <= len(self.mask) - 2:
                self.splits.add(self._canon(s))

    @staticmethod
    def _canon_in(s: frozenset, mask: frozenset) -> frozenset:
        o = frozenset(mask - s)
        if len(s) < len(o):
            return s
        if len(o) < len(s):
            return o
        return min(s, o, key=lambda x: tuple(sorted(x)))

    def _canon(self, s: frozenset) -> frozenset:
        return self._canon_in(s, self.mask)

    def compatible(self, tree: Tree) -> bool:
        """True iff every constraint split (restricted to the taxa actually
        attached in `tree` — stepwise addition grows trees incrementally)
        is realized by the tree."""
        if not self.splits:
            return True
        present = {v for v in tree.adj if tree.is_leaf(v) and tree.adj[v]}
        eff = frozenset(self.mask & present)
        if len(eff) < 4:
            return True
        want = set()
        for s in self.splits:
            r = frozenset(s & eff)
            if 2 <= len(r) <= len(eff) - 2:
                want.add(self._canon_in(r, eff))
        if not want:
            return True
        have = set()
        for s in tree.splits().keys():
            r = frozenset(set(s) & eff)
            if 2 <= len(r) <= len(eff) - 2:
                have.add(self._canon_in(r, eff))
        return want <= have
