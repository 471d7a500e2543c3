"""Candidate tree set: best-k trees found during search.

Reference analog: CandidateSet (tree/candidateset.h:60) — a score-sorted
multimap of topologies with stable-split bookkeeping.

Copied from iqtree2_tpu/search/candidate.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from iqtree2_tpu_torch.tree.topology import Tree


@dataclasses.dataclass
class CandidateTree:
    tree: Tree
    logL: float
    topo_id: str


class CandidateSet:
    def __init__(self, max_size: int = 20, max_top: int = 5):
        self.max_size = max_size
        self.max_top = max_top          # popSize analog (best trees pool)
        self.items: list[CandidateTree] = []

    def update(self, tree: Tree, logL: float) -> bool:
        """Insert/refresh a tree. Returns True if it entered the top set.

        Trees are CANONICALIZED (newick round-trip) before storage so that
        node numbering — which determines edge enumeration order in
        perturbation and NNI scoring — depends only on the topology, not
        on the tree object's construction history. This is what makes a
        checkpoint-resumed search bit-identical to an uninterrupted one.
        """
        tid = tree.topology_id()
        canon = Tree.from_newick(tree.to_newick(digits=17),
                                 tree.taxon_names)
        # per-class (+H) vectors survive the canonicalization round-trip
        tree.transfer_blen_h(canon)
        for it in self.items:
            if it.topo_id == tid:
                if logL > it.logL:
                    it.logL = logL
                    it.tree = canon
                    self._sort()
                return self.rank_of(tid) < self.max_top
        self.items.append(CandidateTree(canon, logL, tid))
        self._sort()
        if len(self.items) > self.max_size:
            self.items = self.items[: self.max_size]
        return self.rank_of(tid) is not None and \
            self.rank_of(tid) < self.max_top

    def _sort(self) -> None:
        self.items.sort(key=lambda it: -it.logL)

    def rank_of(self, tid: str) -> int | None:
        for r, it in enumerate(self.items):
            if it.topo_id == tid:
                return r
        return None

    def best(self) -> CandidateTree:
        return self.items[0]

    def best_score(self) -> float:
        return self.items[0].logL if self.items else -np.inf

    def random_top(self, rng: np.random.Generator) -> CandidateTree:
        k = min(self.max_top, len(self.items))
        return self.items[rng.integers(0, k)]

    def stable_splits(self, thresh: float = 0.9) -> set[frozenset]:
        """Splits present in >= thresh fraction of candidate trees
        (reference: stable-split bookkeeping for -adapt-pert)."""
        if not self.items:
            return set()
        from collections import Counter
        cnt: Counter = Counter()
        for it in self.items:
            for s in it.tree.splits().keys():
                cnt[s] += 1
        n = len(self.items)
        return {s for s, c in cnt.items() if c / n >= thresh}

    def __len__(self) -> int:
        return len(self.items)
