"""Heterotachy (+H, GHOST) models: H classes sharing one substitution model,
each with its own branch lengths; class weights fitted by EM (counterpart of
iqtree2_tpu/model/heterotachy.py).

Reference analogs: RateHeterotachy (model/rateheterotachy.cpp) and
PhyloTreeMixlen (tree/phylotreemixlen.cpp: per-category lengths by EM and
per-category Newton, computeLikelihoodDervMixlen).

Branch lengths become an [n_edges, H] tensor; ops/pruning.transition_tensors
takes 2-D lengths, so the same three kernels serve +H. Each Newton round is
a down pass and one theta_pass (theta does not depend on the lengths, so
the kernel's contract holds for any P; the JAX package forms the same theta
from both passes and edge_thetas), then the per-category coordinate Newton
of pruning.newton_branch_step_mixlen on every edge. The JAX engine's jit
wrappers become plain functions.
"""

from __future__ import annotations

import numpy as np
import torch

from iqtree2_tpu_torch.engine import (DEFAULT_MAX_BLEN, DEFAULT_MIN_BLEN,
                                      LikelihoodEngine, _backtrack,
                                      _sweep_until)
from iqtree2_tpu_torch.model.rates import RateModel
from iqtree2_tpu_torch.ops import nni, pruning
from iqtree2_tpu_torch.tree.schedule import build_schedule, write_blens_to_tree
from iqtree2_tpu_torch.tree.topology import Tree


class RateHeterotachy(RateModel):
    """+H{k}: k classes, all rates 1, free weights (fitted by EM, reference
    RateHeterotachy::optimizeWithEM)."""

    def __init__(self, ncat: int, weights=None):
        self._ncat = ncat
        self.weights = (np.full(ncat, 1.0 / ncat) if weights is None
                        else np.asarray(weights, float))
        self.name = f"+H{ncat}"

    @property
    def ncat(self) -> int:
        return self._ncat

    def category_rates(self) -> np.ndarray:
        return np.ones(self.ncat)

    def category_weights(self) -> np.ndarray:
        return self.weights / self.weights.sum()

    # the weights are fitted by the engine's EM, not by L-BFGS
    def get_params(self) -> np.ndarray:
        return np.zeros(0)

    def set_params(self, x) -> None:
        pass

    def param_bounds(self):
        return np.zeros(0), np.zeros(0)

    def num_free_params(self) -> int:
        return self.ncat - 1


def optimize_mixlen_blens(blens2, tipP, sched, pack, pattern_weights,
                          t_min: float, t_max: float, n_rounds: int,
                          n_newton: int):
    """All-branch per-category Newton rounds with joint backtracking (the
    [E, H] counterpart of engine.optimize_blens). Returns (blens2, logL)."""
    def lg(b2) -> float:
        return float(pruning.tree_loglik(b2, tipP, sched, pack,
                                         pattern_weights)[0])

    def one_round(b2, logL_prev):
        P = pruning.transition_tensors(b2, pack)
        dp = pruning.down_pass(P, tipP, sched, tips=False)
        th = pruning.theta_pass(P, dp, tipP, sched, pack)
        prop = pruning.newton_branch_step_mixlen(
            th.theta, th.scale, b2, pack, pack["log_ptn_invar"],
            pattern_weights, t_min, t_max, n_iter=n_newton)
        return _backtrack(lg, b2, prop.clamp(t_min, t_max), logL_prev)

    return _sweep_until(lg, one_round, blens2, n_rounds, 1e-3)


def class_posterior(blens2, tipP, sched, pack, pattern_weights):
    """(logL, class posterior [C]): the weighted mean over patterns of
    post(c | p), the EM E-step of the class weights (_class_posterior_jit)."""
    dtype = tipP.dtype
    P = pruning.transition_tensors(blens2, pack)
    dp = pruning.down_pass(P, tipP, sched, tips=False)
    Broot, SCroot = pruning.root_partial(dp, P, tipP,
                                         sched["child_src"].shape[0])
    lh_cat = torch.einsum("cx,cxp->cp", pack["root_freqs"], Broot)
    wl = pack["cat_weight"][:, None] * lh_cat
    post = wl / wl.sum(0, keepdim=True).clamp(min=torch.finfo(dtype).tiny)
    wsum = pattern_weights.sum().clamp(min=1.0)
    w_new = (post * pattern_weights[None, :]).sum(1) / wsum
    logL, _ = pruning.root_loglik(Broot, SCroot, pack["root_freqs"],
                                  pack["cat_weight"], pack["log_ptn_invar"],
                                  pattern_weights)
    return logL, w_new


class MixlenEngine(LikelihoodEngine):
    """Engine over +H models: per-category branch lengths [E, H].

    The fixed-topology fit (optimize_mixlen) alternates the per-category
    Newton with EM weight steps; in a search, optimize_branches and
    evaluate_nni_batch work on the per-class lengths kept on the tree
    (tree.blen_h). The search climbs it unfused and serially, as the JAX
    package does."""

    _fused_nni = False   # the fused round would drop the class lengths

    def __init__(self, aln, model, rates: RateHeterotachy, **kw):
        super().__init__(aln, model, rates, **kw)
        self.mixlen = rates.ncat
        self.blens2: np.ndarray | None = None

    def _spread(self) -> np.ndarray:
        return np.linspace(0.5, 1.5, self.mixlen)

    def init_blens2(self, sched) -> np.ndarray:
        """Initial per-class lengths spread around the tree's (0.5x to
        1.5x, breaking the classes' symmetry as the reference does)."""
        return np.maximum(sched.blens[:, None] * self._spread()[None, :],
                          DEFAULT_MIN_BLEN)

    def _t(self, b2: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(b2, dtype=self.dtype, device=self.device)

    def optimize_mixlen(self, tree: Tree, n_outer: int = 5,
                        n_rounds: int = 4, n_newton: int = 4) -> float:
        """Alternate branch-length Newton rounds with EM weight updates;
        writes the weight-averaged lengths back to the host tree, keeps
        self.blens2 and returns the logL."""
        sched = build_schedule(tree)
        sa = self.schedule_arrays(sched)
        b2 = self._t(self.blens2 if self.blens2 is not None
                     and self.blens2.shape[0] == sched.n_edges
                     else self.init_blens2(sched))
        for _ in range(n_outer):
            b2, _ = optimize_mixlen_blens(b2, self._tipP, sa, self._pack,
                                          self._pw, DEFAULT_MIN_BLEN,
                                          DEFAULT_MAX_BLEN, n_rounds, n_newton)
            _, w_new = class_posterior(b2, self._tipP, sa, self._pack,
                                       self._pw)
            w_new = np.maximum(w_new.double().cpu().numpy(), 1e-6)
            self.rates.weights = w_new / w_new.sum()
            self.refresh_model()
        self.blens2 = b2.double().cpu().numpy()
        mean_b = (self.blens2
                  * self.rates.category_weights()[None, :]).sum(1)
        write_blens_to_tree(tree, sched, mean_b)
        return float(class_posterior(self._t(self.blens2), self._tipP, sa,
                                     self._pack, self._pw)[0])

    # ------------------------------------------------ search integration
    # The reference searches +H models with per-class branch lengths
    # (PhyloTreeMixlen overrides optimizeOneBranch and optimizeAllBranches,
    # tree/phylotreemixlen.cpp:338, :736): optimize_branches runs the
    # per-class Newton sweeps, and NNI candidates are scored with
    # per-class central-branch (NNI1) or five-branch (NNI5) Newton.
    def _blens2_for(self, tree: Tree, sched) -> np.ndarray:
        """[E, H] start lengths from the tree's per-class vectors
        (tree.blen_h), the scalar length times the spread for an edge
        without one (a fresh edge after an NNI swap)."""
        H = self.mixlen
        out = np.empty((sched.n_edges, H))
        for e, pair in enumerate(sched.edge_nodes):
            v = None if pair is None else tree.blen_h.get(Tree._key(*pair))
            if v is None or len(v) != H:
                out[e] = max(sched.blens[e], DEFAULT_MIN_BLEN) * self._spread()
            else:
                out[e] = np.maximum(v, DEFAULT_MIN_BLEN)
        return out

    def _write_blens2(self, tree: Tree, sched, b2: np.ndarray) -> None:
        w = self.rates.category_weights()
        write_blens_to_tree(tree, sched, (b2 * w[None, :]).sum(1))
        for e, pair in enumerate(sched.edge_nodes):
            if pair is not None:
                tree.blen_h[Tree._key(*pair)] = b2[e].copy()

    def optimize_branches(self, tree: Tree, n_rounds: int = 10,
                          n_newton: int = 4,
                          t_min: float = DEFAULT_MIN_BLEN,
                          t_max: float = DEFAULT_MAX_BLEN) -> float:
        """Per-class all-branch Newton sweeps (no EM weight step: the
        weights are model parameters, refitted by optimize_mixlen)."""
        sched = build_schedule(tree)
        b2, logL = optimize_mixlen_blens(
            self._t(self._blens2_for(tree, sched)), self._tipP,
            self.schedule_arrays(sched), self._pack, self._pw, t_min, t_max,
            n_rounds, n_newton)
        b2 = b2.double().cpu().numpy()
        self._write_blens2(tree, sched, b2)
        self.blens2 = b2
        return float(logL)

    def evaluate_nni_batch(self, sched, cand_arrays,
                           t_min: float = DEFAULT_MIN_BLEN,
                           t_max: float = DEFAULT_MAX_BLEN,
                           return_site_lp: bool = False, nni5: bool = False):
        """NNI scoring with per-class branch Newton. Returns (logl [n, 3],
        t_opt [n, 3]) as class-weighted means, with nni5 also t5 [n, 3, 5];
        the per-class t5 [n, 3, 5, H] is kept on self.last_t5_h."""
        tree = getattr(self, "_nni_tree", None)
        b2 = (self._blens2_for(tree, sched) if tree is not None
              else np.maximum(sched.blens[:, None], DEFAULT_MIN_BLEN)
              * self._spread()[None, :])
        blens2 = self._t(b2)
        sa = self.schedule_arrays(sched)
        P = pruning.transition_tensors(blens2, self._pack)
        dp, up = pruning.both_passes(P, self._tipP, sa, self._pack)
        w = self.rates.category_weights()
        if nni5:
            logl, _, t5 = nni.evaluate_nnis5(
                cand_arrays, blens2, dp, up, sa, self._pack, self._pw, t_min,
                t_max, return_site_lp=return_site_lp, mixlen=True)
            t5 = t5.double().cpu().numpy()                   # [n, 3, 5, H]
            self.last_t5_h = t5
            t5m = (t5 * w).sum(-1)
            return logl.double().cpu().numpy(), t5m[:, :, 4], t5m
        logl, t_opt = nni.evaluate_nnis(
            cand_arrays, blens2, dp, up.up_in, up.up_scale, sa, self._pack,
            self._pw, t_min, t_max, return_site_lp=return_site_lp,
            mixlen=True)
        return (logl.double().cpu().numpy(),
                (t_opt.double().cpu().numpy() * w).sum(-1))

    def loglik_mixlen(self, tree: Tree) -> float:
        """logL at the kept per-class lengths (the initial spread where
        there are none for this tree)."""
        sched = build_schedule(tree)
        if self.blens2 is None or self.blens2.shape[0] != sched.n_edges:
            self.blens2 = self.init_blens2(sched)
        return float(class_posterior(
            self._t(self.blens2), self._tipP, self.schedule_arrays(sched),
            self._pack, self._pw)[0])
