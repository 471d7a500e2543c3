"""Tree-mixture models (+T): the site likelihood is a weighted sum over T
topologies sharing one alignment and one substitution model (counterpart of
iqtree2_tpu/model/treemix.py).

Reference analog: IQTreeMix (tree/iqtreemix.h:21, computeLikelihood
tree/iqtreemix.cpp:586): L(p) = sum_t w_t L_t(p); weights by EM; branch
lengths per tree by EM-weighted per-tree optimization.

The E-step takes each tree's site log-likelihoods (the down pass's
epilogue); the M-step for tree t's branch lengths is the engine's
all-branch Newton on a view whose pattern weights are the posterior-weighted
ones (the exact EM surrogate), which the JAX package runs through
_optimize_blens_jit with the same lengths, bounds, rounds and tolerance.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.engine import LikelihoodEngine


class TreeMixture:
    """EM fitter over a fixed set of topologies (+T)."""

    def __init__(self, eng: LikelihoodEngine, trees: list, weights=None):
        if len(trees) < 2:
            raise ValueError("+T needs at least two trees")
        self.eng = eng
        self.trees = [t.copy() for t in trees]
        T = len(trees)
        self.weights = (np.full(T, 1.0 / T) if weights is None
                        else np.asarray(weights, float))
        self.weights = self.weights / self.weights.sum()
        self.fix_weights = weights is not None

    # ------------------------------------------------------------ E-step
    def _site_lps(self) -> np.ndarray:
        """[T, P] per-tree per-pattern log-likelihoods."""
        return np.stack([self.eng.site_lp(t)[1] for t in self.trees])

    def loglik(self) -> float:
        lps = self._site_lps()
        m = lps.max(axis=0)
        lw = np.log(self.weights)[:, None]
        site = m + np.log(np.exp(lps - m[None, :] + lw).sum(0))
        return float((self.eng.aln.pattern_weights * site).sum())

    def _posteriors(self) -> np.ndarray:
        """[T, P] posterior tree responsibilities per pattern."""
        a = self._site_lps() + np.log(np.maximum(self.weights, 1e-300))[:,
                                                                        None]
        a -= a.max(axis=0, keepdims=True)
        e = np.exp(a)
        return e / np.maximum(e.sum(axis=0, keepdims=True), 1e-300)

    # ------------------------------------------------------------- M-step
    def _optimize_tree_blens(self, t_idx: int, post_row: np.ndarray,
                             n_rounds: int = 4) -> None:
        """Branch lengths of tree t under posterior-weighted patterns."""
        view = self.eng.with_pattern_weights(
            self.eng.aln.pattern_weights * post_row)
        view.optimize_branches(self.trees[t_idx], n_rounds=n_rounds)

    def fit(self, n_iter: int = 10, tol: float = 1e-3,
            log=lambda s: None) -> float:
        """EM: alternate tree responsibilities, per-tree branch lengths and
        weights until the mixture logL converges."""
        prev = -np.inf
        self.history = []
        for it in range(n_iter):
            post = self._posteriors()
            for t_idx in range(len(self.trees)):
                self._optimize_tree_blens(t_idx, post[t_idx])
            if not self.fix_weights:
                resp = (post * self.eng.aln.pattern_weights[None, :]).sum(1)
                resp = np.maximum(resp, 1e-9)
                self.weights = resp / resp.sum()
            cur = self.loglik()
            self.history.append(cur)
            log(f"  [+T] EM iter {it + 1}: logL {cur:.4f}  weights "
                f"{np.round(self.weights, 4).tolist()}")
            if cur - prev < tol and it > 0:
                return cur
            prev = cur
        return prev
