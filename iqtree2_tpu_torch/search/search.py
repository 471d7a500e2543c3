"""Stochastic tree search controller on the host (counterpart of
iqtree2_tpu/search/search.py, whose module imports the JAX engine).

Reference analog: IQTree::doTreeSearch (tree/iqtree.cpp:2196):
  1. initCandidateTreeSet (:697): parsimony and BIONJ start trees, quick
     branch optimisation, NNI polish of the best into the candidate set;
  2. iterate: pick a top candidate, perturb it by random NNIs, NNI
     hill-climb, update the candidate set; stop by StopRule or UFBoot
     correlation.
Defaults follow the reference (numInitTrees=100, numNNITrees=20, popSize=5,
unsuccess_iteration=100). Iterations run in blocks of ``batch_iterations``
candidates, as in the JAX package: a block draws all its perturbations
first, then each tree hill-climbs on its own (search/nni.nni_optimize), so
both packages draw the same random numbers and visit the same trees. (The
JAX package climbs a block in lockstep and lets finished trees ride to keep
its compiled shapes; here a finished tree leaves the climb.) An engine
without the fused NNI round (a PartitionEngine, the PMSF SSFEngine, a
MixlenEngine) runs one candidate per block, as the JAX package runs it. A
-g constraint filters the parsimony start trees, the BIONJ tree, the
random NNIs and the climbs' swaps.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.ops.distances import hamming_jc_distances, ml_distances
from iqtree2_tpu_torch.ops.pars import (fitch_score, random_stepwise_addition,
                                        state_bitmasks)
from iqtree2_tpu_torch.search.bionj import bionj_tree
from iqtree2_tpu_torch.search.candidate import CandidateSet
from iqtree2_tpu_torch.search.nni import fused_round, nni_optimize
from iqtree2_tpu_torch.search.perturb import random_nnis
from iqtree2_tpu_torch.search.stoprule import StopRule
from iqtree2_tpu_torch.tree.topology import Tree

DEFAULT_BATCH = 8   # the JAX package's IQTREE2_TPU_SEARCH_BATCH default


@dataclasses.dataclass
class SearchParams:
    n_init_trees: int = 100         # numInitTrees
    n_nni_trees: int = 20           # numNNITrees
    pop_size: int = 5               # popSize
    pertub_strength: float = 0.5    # initPS
    loglh_epsilon: float = 0.001
    seed: int = 1
    min_iterations: int = 100
    max_iterations: int = 1000
    unsuccess_iteration: int = 100
    fixed_iterations: int | None = None


@dataclasses.dataclass
class SearchResult:
    best_tree: Tree
    best_logL: float
    n_iterations: int
    candidates: CandidateSet


class TreeSearch:
    def __init__(self, eng: LikelihoodEngine, aln: Alignment,
                 params: SearchParams | None = None, ufboot=None, log=None,
                 ckp=None, batch_iterations: int = DEFAULT_BATCH,
                 constraint=None):
        if batch_iterations < 1:
            raise ValueError(f"batch_iterations must be at least 1, not "
                             f"{batch_iterations}")
        self.eng = eng
        self.aln = aln
        self.params = params or SearchParams()
        self.rng = np.random.default_rng(self.params.seed)
        self.cands = CandidateSet(max_size=self.params.n_nni_trees,
                                  max_top=self.params.pop_size)
        self.ufboot = ufboot  # optional UFBoot collector
        self.log = log or (lambda s: None)
        self.ckp = ckp        # optional Checkpoint (mid-search resume)
        # the JAX package climbs K candidates at once only on a plain
        # engine; a partitioned or per-class one runs serially (its
        # search.py:71-77)
        self.batch_iterations = (batch_iterations if fused_round(eng)
                                 else 1)
        self.constraint = constraint   # optional TopologyConstraint (-g)
        self._resume_iter = 0
        # host wall seconds: start trees (init_candidates), iterations
        # (the perturb + NNI blocks), and the UFBoot RELL scoring inside
        # both
        self.seconds = {"start_trees": 0.0, "iterations": 0.0, "rell": 0.0}

    # ----------------------------------------------------------- checkpoint
    def _save_ckp(self, it: int, stop: StopRule) -> None:
        """Persist the whole search state so a killed run resumes exactly
        (reference: doTreeSearch checkpoint guards, tree/iqtree.cpp:2221,
        2394); the RNG state makes the resumed run identical to an
        uninterrupted one."""
        if self.ckp is None:
            return
        c = self.ckp
        c.put("search.iteration", it)
        c.put("search.last_improved", stop.last_improved)
        c.put("search.rng", self.rng.bit_generator.state)
        c.put("search.candidates",
              [[it_.tree.to_newick(digits=17), it_.logL]
               for it_ in self.cands.items])
        if self.ufboot is not None:
            c.put("search.ufboot", self.ufboot.state_dict())
        c.dump()

    def _load_ckp(self, stop: StopRule) -> bool:
        c = self.ckp
        if c is None or c.get("search.iteration") is None:
            return False
        self._resume_iter = int(c.get("search.iteration"))
        stop.last_improved = int(c.get("search.last_improved", 0))
        self.rng.bit_generator.state = c.get("search.rng")
        self.cands = CandidateSet(max_size=self.params.n_nni_trees,
                                  max_top=self.params.pop_size)
        for nwk, logL in c.get("search.candidates", []):
            self.cands.update(Tree.from_newick(nwk, self.aln.names),
                              float(logL))
        if self.ufboot is not None and c.get("search.ufboot") is not None:
            self.ufboot.load_state_dict(c.get("search.ufboot"))
        self.log(f"Resumed search from checkpoint at iteration "
                 f"{self._resume_iter} (best logL "
                 f"{self.cands.best_score():.4f})")
        return True

    # ------------------------------------------------------------ init set
    def init_candidates(self) -> None:
        p = self.params
        t0 = time.perf_counter()
        self.log(f"Generating {p.n_init_trees} parsimony start trees...")
        masks = state_bitmasks(self.aln)
        w = self.aln.pattern_weights
        scored: list[tuple[float, Tree]] = []
        seen: set[str] = set()
        for _ in range(p.n_init_trees):
            t = random_stepwise_addition(self.aln, self.rng,
                                         constraint=self.constraint)
            tid = t.topology_id()
            if tid in seen:
                continue
            seen.add(tid)
            scored.append((fitch_score(t, masks, w), t))
        # BIONJ tree from ML distances, or JC distances where the model has
        # no single reversible rate matrix (a mixture: ROADMAP C13; the
        # PMSF engine has no model at all) or the data are a supermatrix
        # (whose partitions' distances are averaged by their sites)
        try:
            if hasattr(self.aln, "partitions"):
                raise NotImplementedError("a supermatrix has no one model")
            if not hasattr(self.eng, "model"):
                raise NotImplementedError("the engine has no one model")
            D = ml_distances(self.aln, self.eng.model, dtype=self.eng.dtype,
                             device=self.eng.device)
        except NotImplementedError:
            D = hamming_jc_distances(self.aln)
        tb = bionj_tree(D, self.aln.names)
        tb.clamp_blens(1e-6, 10.0)
        if self.constraint is None or self.constraint.compatible(tb):
            scored.append((fitch_score(tb, masks, w), tb))
        scored.sort(key=lambda x: x[0])

        # quick branch optimisation of the best parsimony trees
        top = [t for _, t in scored[: max(p.n_nni_trees, 1)]]
        self.log(f"Optimizing {len(top)} best start trees...")
        if self.batch_iterations > 1:
            logLs = self.eng.optimize_branches_batch(top, n_rounds=4)
        else:
            logLs = [self.eng.optimize_branches(t, n_rounds=4) for t in top]
        for t, logL in zip(top, logLs):
            self._save_tree(t, logL)
            self.cands.update(t, logL)
        # NNI polish of the best few into local optima
        polish = [it.tree.copy()
                  for it in list(self.cands.items[: p.pop_size])]
        for t in polish:
            res, lp = self._nni_opt(t)
            self._save_tree(t, res.logL, lp)
            self.cands.update(t, res.logL)
        self.log(f"Initial best logL: {self.cands.best_score():.4f}")
        self.seconds["start_trees"] += time.perf_counter() - t0

    # ---------------------------------------------------------- main loop
    def run(self) -> SearchResult:
        p = self.params
        stop = StopRule(
            min_iterations=p.min_iterations,
            max_iterations=p.max_iterations,
            unsuccess_iteration=p.unsuccess_iteration,
            fixed_iterations=p.fixed_iterations,
            use_correlation=self.ufboot is not None)
        resumed = self._load_ckp(stop)
        if not resumed and len(self.cands) == 0:
            self.init_candidates()
            self._save_ckp(0, stop)
        t0 = time.perf_counter()
        it = self._resume_iter
        K = self.batch_iterations
        stopping = False
        while not stopping:
            ufstep = (self.ufboot.step_iterations
                      if self.ufboot is not None else None)
            # blocks align to the absolute K-grid and never cross the
            # earliest possible stop, so checkpoints land on block
            # boundaries and the RNG draws match an uninterrupted run
            kk = max(1, min(K - (it % K), stop.earliest_stop(ufstep) - it))
            trees = []
            for _ in range(kk):
                t = self.cands.random_top(self.rng).tree.copy()
                random_nnis(t, self.rng, p.pertub_strength,
                            constraint=self.constraint)
                trees.append(t)
            for t in trees:
                res, lp = self._nni_opt(t)
                it += 1
                self._save_tree(t, res.logL, lp)
                improved = (res.logL
                            > self.cands.best_score() + p.loglh_epsilon)
                self.cands.update(t, res.logL)
                if improved:
                    stop.note_improvement(it)
                    self.log(f"BETTER TREE FOUND at iteration {it}: "
                             f"{res.logL:.4f}")
                corr_done = None
                if self.ufboot is not None and \
                        it % self.ufboot.step_iterations == 0:
                    corr_done = self.ufboot.check_convergence()
                if stop.should_stop(it, corr_done):
                    stopping = True
                    break
            self._save_ckp(it, stop)
        self.seconds["iterations"] += time.perf_counter() - t0
        best = self.cands.best()
        return SearchResult(best_tree=best.tree.copy(),
                            best_logL=best.logL, n_iterations=it,
                            candidates=self.cands)

    # ------------------------------------------------------------- helpers
    def _nni_opt(self, t: Tree):
        """NNI hill-climb -> (NNIResult, lp or None); with UFBoot active the
        final tree's site log-likelihoods come from the same fused round."""
        if self.ufboot is None:
            return nni_optimize(self.eng, t,
                                loglh_epsilon=self.params.loglh_epsilon,
                                constraint=self.constraint), None
        return nni_optimize(self.eng, t,
                            loglh_epsilon=self.params.loglh_epsilon,
                            want_lp=True, constraint=self.constraint)

    def _save_tree(self, tree: Tree, logL: float, lp=None) -> None:
        """RELL-score every optimised tree for UFBoot (reference analog:
        saveCurrentTree, tree/iqtree.cpp:3553)."""
        if self.ufboot is None:
            return
        t0 = time.perf_counter()
        if logL < self.ufboot.logl_cutoff:
            self.ufboot.n_pruned += 1
        else:
            if lp is None:
                _, lp = self.eng.site_lp(tree)
            self.ufboot.add_tree(tree, lp, tree_logL=logL)
        self.seconds["rell"] += time.perf_counter() - t0
