"""PMSF: the posterior mean site frequency two-pass approximation for
profile mixture models, in PyTorch (counterpart of iqtree2_tpu/model/pmsf.py;
reference: computeSiteFrequencyModel, main/phyloanalysis.cpp:3744; Wang et
al. 2018).

Pass 1: fit the full mixture model (e.g. LG+C20+G) on a guide tree and
compute, per site pattern, the posterior mixture-class weights; the PMSF
profile is the posterior mean of the class frequency vectors. The
mixture's passes are the pruning kernels' (engine.site_rate_posterior).
Pass 2: replace the mixture with a site-specific-frequency model (one
reversible Q per pattern, shared exchangeabilities) on SSFEngine
(ops/sitespecific.py, plain PyTorch on the engine's device) and refit the
branch lengths and the Gamma shape.

SSFEngine offers what the analysis and the search ask of an engine under
--pmsf: loglik_tree, site_lp, optimize_branches, NNI1 scoring
(evaluate_nni_batch, so the search climbs with NNI1 as in the JAX package)
and optimize_alpha. Like the JAX class it has no model, no posteriors and
no reweighted views, so the outputs that need them are refused with
--pmsf (ROADMAP C12).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from iqtree2_tpu_torch.convert import sched_to_torch
from iqtree2_tpu_torch.engine import (DEFAULT_MAX_BLEN, DEFAULT_MIN_BLEN,
                                      PATTERN_PAD, _backtrack, _round_up)
from iqtree2_tpu_torch.ops import prec
from iqtree2_tpu_torch.ops import sitespecific as ssf
from iqtree2_tpu_torch.tree.schedule import build_schedule, write_blens_to_tree
from iqtree2_tpu_torch.utils.optimize import brent_minimize

ALPHA_BOUNDS = (0.05, 20.0)   # optimize_alpha's Brent interval


def _exch_full(exch, S: int) -> np.ndarray:
    """Full symmetric exchangeability matrix from either a full matrix or
    a row-major upper-triangle vector (the mixture component storage)."""
    exch = np.asarray(exch, dtype=np.float64)
    if exch.ndim == 2:
        return exch
    M = np.zeros((S, S))
    M[np.triu_indices(S, 1)] = exch
    return M + M.T


def site_frequency_profile(eng, tree) -> np.ndarray:
    """Posterior-mean site frequencies [num_patterns, S] from a fitted
    mixture engine on a guide tree (PMSF pass 1)."""
    _, cat_post = eng.site_rate_posterior(tree)        # [C, P]
    cat_mix = np.asarray(eng.pack_np.cat_mix)
    M = int(cat_mix.max()) + 1
    class_post = np.zeros((M, cat_post.shape[1]))
    for c in range(cat_post.shape[0]):
        class_post[cat_mix[c]] += cat_post[c]
    class_post /= np.maximum(class_post.sum(0, keepdims=True), 1e-30)
    class_freqs = np.stack([comp[1] for comp in eng.model.components])
    prof = class_post.T @ class_freqs                  # [P, S]
    return prof / prof.sum(1, keepdims=True)


class SSFEngine:
    """Fixed-topology engine over a site-specific-frequency model on one
    device (PMSF pass 2; the reference's ModelSet/site-specific models,
    tree/phylokernelsitemodel.h)."""

    # NNI candidates are scored on the central branch alone (NNI1), as the
    # JAX package scores them on its SSFEngine
    NNI5 = False

    def __init__(self, aln, exch: np.ndarray, site_freqs: np.ndarray, rates,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 min_freq: float = 1e-4):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SSFEngine: device 'cuda' was requested but "
                "torch.cuda.is_available() is false; pass device='cpu'")
        prec.apply_policy()
        self.aln = aln
        self.exch = exch
        self.rates = rates
        self.dtype = dtype
        P = aln.num_patterns
        self.Pp = _round_up(max(P, 1), PATTERN_PAD)
        pad = self.Pp - P
        # pad patterns with uniform frequencies
        S = aln.num_states
        sf = np.concatenate([site_freqs, np.full((pad, S), 1.0 / S)], axis=0)
        self.site_freqs = sf
        self._lam, self._U, self._V, self._f = ssf.build_ssf_eigensystems(
            exch, sf, min_freq=min_freq)
        kw = dict(dtype=dtype, device=self.device)
        codes = np.pad(aln.tip_codes(), ((0, 0), (0, pad)),
                       constant_values=aln.seqtype.unknown_code)
        tip_table = np.asarray(aln.seqtype.tip_table)
        self._tipP = torch.as_tensor(tip_table[codes].transpose(0, 2, 1),
                                     **kw).contiguous()       # [L, S, Pp]
        self._pw = torch.as_tensor(
            np.pad(aln.pattern_weights.astype(np.float64), (0, pad)), **kw)
        self._eig = {k: torch.as_tensor(v, **kw) for k, v in
                     (("lam", self._lam), ("U", self._U), ("V", self._V),
                      ("freqs", self._f))}
        self.refresh_rates()

    def refresh_rates(self) -> None:
        """Rebuild the pack after a change of the rate model."""
        P = self.aln.num_patterns
        p_inv = self.rates.p_invar
        if p_inv > 0:
            inv = p_inv * np.einsum("ps,ps->p", self.aln.const_state_mask(),
                                    self._f[:P])
            with np.errstate(divide="ignore"):
                log_inv = np.log(np.maximum(inv, 0.0))
        else:
            log_inv = np.full(P, -np.inf)
        log_inv = np.pad(log_inv, (0, self.Pp - P), constant_values=-np.inf)
        kw = dict(dtype=self.dtype, device=self.device)
        self.pack = {**self._eig,
                     "cat_rate": torch.as_tensor(
                         self.rates.category_rates(), **kw),
                     "cat_weight": torch.as_tensor(
                         self.rates.category_weights(), **kw),
                     "log_ptn_invar": torch.as_tensor(log_inv, **kw)}

    # ------------------------------------------------------------- API
    def schedule_arrays(self, sched) -> dict:
        return sched_to_torch(sched.to_device_arrays(), self.device)

    def _blens(self, sched, t_min: float | None = None):
        b = sched.blens if t_min is None else np.maximum(sched.blens, t_min)
        return torch.as_tensor(b, dtype=self.dtype, device=self.device)

    def loglik_tree(self, tree) -> float:
        return self.site_lp(tree)[0]

    def site_lp(self, tree) -> tuple[float, np.ndarray]:
        """(logL, per-pattern log-likelihood [num_patterns])."""
        sched = build_schedule(tree)
        logL, lp = ssf.tree_loglik(self._blens(sched), self._tipP,
                                   self.schedule_arrays(sched), self.pack,
                                   self._pw)
        return (float(logL),
                lp[: self.aln.num_patterns].double().cpu().numpy())

    def optimize_branches(self, tree, n_rounds: int = 10,
                          n_newton: int = 4,
                          t_min: float = DEFAULT_MIN_BLEN,
                          t_max: float = DEFAULT_MAX_BLEN) -> float:
        """n_rounds all-branch Newton rounds through the per-pattern
        eigenbasis thetas, each accepted monotonically (the JAX module's
        _ssf_optimize_blens_jit: a fixed number of rounds); lengths written
        into ``tree``; returns the final logL."""
        sched = build_schedule(tree)
        sa = self.schedule_arrays(sched)
        pk, tipP, pw = self.pack, self._tipP, self._pw

        def lg(b) -> float:
            return float(ssf.tree_loglik(b, tipP, sa, pk, pw)[0])

        blens = self._blens(sched, t_min)
        logL = lg(blens)
        for _ in range(n_rounds):
            dp = ssf.down_pass(blens, tipP, sa, pk)
            up = ssf.up_pass(blens, dp, tipP, sa, pk)
            th = ssf.edge_thetas(up, dp, sa["edge_src"], pk)
            prop = ssf.newton_branch_step(th.theta, th.scale, blens, pk, pw,
                                          t_min, t_max, n_iter=n_newton)
            blens, logL = _backtrack(lg, blens, prop.clamp(t_min, t_max),
                                     logL)
        write_blens_to_tree(tree, sched, blens.double().cpu().numpy())
        return logL

    def evaluate_nni_batch(self, sched, cand_arrays,
                           t_min: float = DEFAULT_MIN_BLEN,
                           t_max: float = DEFAULT_MAX_BLEN):
        """NNI1 scoring of every candidate: (logl [n, 3], t_opt [n, 3])."""
        sa = self.schedule_arrays(sched)
        blens = self._blens(sched)
        dp = ssf.down_pass(blens, self._tipP, sa, self.pack)
        up = ssf.up_pass(blens, dp, self._tipP, sa, self.pack)
        logl, t_opt = ssf.evaluate_nnis(cand_arrays, blens, dp, up, sa,
                                        self.pack, self._pw, t_min, t_max)
        return (logl.double().cpu().numpy(), t_opt.double().cpu().numpy())

    def optimize_alpha(self, tree, lo: float = ALPHA_BOUNDS[0],
                       hi: float = ALPHA_BOUNDS[1]) -> float:
        """Brent on the Gamma shape at the tree's lengths (pass 2's rate
        refit); returns the shape, left applied."""
        sched = build_schedule(tree)
        sa = self.schedule_arrays(sched)
        blens = self._blens(sched)

        def obj(a):
            self.rates.alpha = float(a)
            self.refresh_rates()
            return -float(ssf.tree_loglik(blens, self._tipP, sa, self.pack,
                                          self._pw)[0])

        a_best, _ = brent_minimize(obj, lo, hi)
        obj(a_best)
        return float(a_best)


def run_pmsf(aln, mixture_engine, guide_tree, log=print,
             blen_rounds: int = 10):
    """Two-pass PMSF. Returns (SSFEngine, tree, logL, profile [P, S]).

    mixture_engine: a LikelihoodEngine over the profile mixture, its
    parameters already fitted on guide_tree by the caller; the SSF engine
    takes its dtype and device."""
    log("PMSF pass 1: posterior mean site frequencies from the mixture...")
    prof = site_frequency_profile(mixture_engine, guide_tree)
    exch = _exch_full(mixture_engine.model.components[0][0],
                      mixture_engine.aln.num_states)
    rates = copy.deepcopy(mixture_engine.rates)
    log("PMSF pass 2: site-specific-frequency re-optimization...")
    eng2 = SSFEngine(aln, exch, prof, rates, dtype=mixture_engine.dtype,
                     device=mixture_engine.device)
    tree = guide_tree.copy()
    logL = eng2.optimize_branches(tree, n_rounds=blen_rounds)
    if hasattr(rates, "alpha"):
        eng2.optimize_alpha(tree)
        logL = eng2.optimize_branches(tree, n_rounds=4)
    log(f"PMSF final logL: {logL:.4f}")
    return eng2, tree, logL, prof
