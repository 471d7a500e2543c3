"""LikelihoodEngine in PyTorch (counterpart of iqtree2_tpu/engine.py).

Binds an Alignment + model + rate model to the pruning contracts of
ops/pruning.py on one device. Host objects (Tree, SubstModel, RateModel)
stay on the host; the engine converts them to tensors (schedule, model
pack) through convert.py. On a CUDA device every pass runs through the
Hopper kernels of ops/kernels.py; on the CPU through their plain versions.

Ported: pattern padding, refresh_model, with_pattern_weights,
schedule_arrays, loglik_tree/loglik_sched, site_lp, compute_passes, the
all-branch Newton optimize_branches (the JAX "std" path's math, through its
v2 fused-theta path: a down pass and one theta_pass per round; for a
nonreversible model, pack["Q"], the JAX "nonrev" path: both passes and the
direct derivatives per edge, optimize_blens_nonrev), NNI scoring
(evaluate_nni_batch) and the fused NNI round (optimize_and_evaluate_nnis)
with their K-tree forms. The JAX engine's mechanisms for the TPU's remote
link and compiler (_pull, _pack_flat, _unpack_ints, _dev_scalar,
_cfg_zeros, the flat-array packing of the fused round, the unrolled
lax.cond, plan2 rings and tiles, the compile cache) have no counterpart:
PyTorch runs eagerly and the round trips are local. The K-tree forms loop
over the trees, each through the kernels, and give the serial results; a
leading K axis in the kernels is later work.

Reference analog: PhyloTree (tree/phylotree.h:343) minus the search logic.
"""

from __future__ import annotations

import copy
import hashlib

import numpy as np
import torch

from iqtree2_tpu_torch.convert import pack_to_torch, sched_to_torch
from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.model.pack import ModelPack, build_model_pack
from iqtree2_tpu_torch.ops import nni, prec, pruning
from iqtree2_tpu_torch.tree.schedule import (TreeSchedule, build_schedule,
                                             write_blens_to_tree)
from iqtree2_tpu_torch.tree.topology import Tree

DEFAULT_MIN_BLEN = 1e-6   # reference: min_branch_length (utils/tools.cpp)
DEFAULT_MAX_BLEN = 10.0   # reference: max_branch_length
PATTERN_PAD = 128         # patterns are padded to a multiple of this
_SCHED_CACHE_SIZE = 32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _backtrack(lg, blens_old, prop, logL_prev, n_halve: int = 4):
    """Monotonic acceptance of a joint Newton proposal: halve toward the
    old lengths until logL does not drop, else keep the old state
    (reference contract: optimizeAllBranches never worsens). The tests are
    written so that a NaN logL keeps backtracking."""
    cur, l_new = prop, lg(prop)
    for _ in range(n_halve):
        if l_new >= logL_prev - 1e-9:
            break
        cur = 0.5 * (cur + blens_old)
        l_new = lg(cur)
    if not l_new >= logL_prev - 1e-9:
        return blens_old, logL_prev
    return cur, l_new


def _sweep_until(lg, one_round, blens, n_rounds: int, eps: float):
    """optimizeAllBranches-style sweeps until a sweep gains no more than eps
    logL (reference tolerance exit, tree/phylotree.cpp:2689) or n_rounds."""
    logL = lg(blens)
    for _ in range(n_rounds):
        nb, nl = one_round(blens, logL)
        gain = nl - logL
        blens, logL = nb, nl
        if not gain > eps:
            break
    return blens, logL


def optimize_blens(blens, tipP, sched, pack, pattern_weights, t_min: float,
                   t_max: float, n_rounds: int, n_newton: int,
                   eps: float = 1e-3):
    """Iterative all-branch Newton via theta buffers with backtracking
    (counterpart of engine._optimize_blens_jit). Each round: a down pass
    (no tip rows) and a theta pass -> thetas of every edge -> per-edge
    bounded Newton (all edges in parallel) -> monotonic acceptance. Returns
    (blens, logL)."""
    def lg(b) -> float:
        return float(pruning.tree_loglik(b, tipP, sched, pack,
                                         pattern_weights)[0])

    def one_round(b, logL_prev):
        P = pruning.transition_tensors(b, pack)
        dp = pruning.down_pass(P, tipP, sched, tips=False)
        th = pruning.theta_pass(P, dp, tipP, sched, pack)
        prop = pruning.newton_branch_step(
            th.theta, th.scale, b, pack, pack["log_ptn_invar"],
            pattern_weights, t_min, t_max, n_iter=n_newton)
        return _backtrack(lg, b, prop.clamp(t_min, t_max), logL_prev)

    return _sweep_until(lg, one_round, blens, n_rounds, eps)


# memory for one chunk of edges in the nonreversible Newton, whose edges
# each hold about NONREV_SLABS [C, S, Pp] tensors (down, E, the products
# out^T P, out^T rQ P and out^T rQ rQ P and their operands)
NONREV_CHUNK_BYTES = 4 * 2**30
NONREV_SLABS = 10


def optimize_blens_nonrev(blens, tipP, sched, pack, pattern_weights,
                          t_min: float, t_max: float, n_rounds: int,
                          n_newton: int, eps: float = 1e-3):
    """All-branch Newton for nonreversible models (counterpart of
    engine._optimize_blens_nonrev_jit): no eigenbasis theta; each round
    both passes, then per edge its down partial and its E feed the direct
    derivatives through dP/dt = Q P (pruning.branch_lh_derivs_nonrev),
    edges in chunks of NONREV_CHUNK_BYTES (each edge's sums are its own,
    so the chunks change no result), then monotonic acceptance. Returns
    (blens, logL)."""
    def lg(b) -> float:
        return float(pruning.tree_loglik(b, tipP, sched, pack,
                                         pattern_weights)[0])

    def one_round(b, logL_prev):
        P = pruning.transition_tensors(b, pack)
        dp, up = pruning.both_passes(P, tipP, sched, pack)
        src = sched["edge_src"].long()
        prop = torch.empty_like(b)
        slab = dp.all[0].numel() * dp.all.element_size() * NONREV_SLABS
        for a, z in pruning.chunk_ranges(b.shape[0], slab,
                                         NONREV_CHUNK_BYTES):
            down, down_sc = pruning.edge_down_partials(dp, src[a:z])
            prop[a:z] = pruning.newton_branch_step_nonrev(
                down, up.edge_E[a:z], up.edge_E_scale[a:z] + down_sc,
                b[a:z], pack, pack["log_ptn_invar"], pattern_weights,
                t_min, t_max, n_iter=n_newton)
        return _backtrack(lg, b, prop.clamp(t_min, t_max), logL_prev)

    return _sweep_until(lg, one_round, blens, n_rounds, eps)


class LikelihoodEngine:
    def __init__(self, aln: Alignment, model, rates,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 asc: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LikelihoodEngine: device 'cuda' was requested but "
                "torch.cuda.is_available() is false; pass device='cpu' "
                "(--device cpu) to run the plain PyTorch path")
        prec.apply_policy()
        self.aln = aln
        self.model = model
        self.rates = rates
        self.dtype = dtype
        self.asc = asc

        P = aln.num_patterns
        S = aln.num_states
        # +ASC appends S weight-0 pseudo-patterns (one constant column per
        # state) whose likelihoods feed the Lewis correction
        self.Pp = _round_up(max(P + (S if asc else 0), 1), PATTERN_PAD)
        pad = self.Pp - P
        unk = aln.seqtype.unknown_code
        self.tip_codes = np.pad(aln.tip_codes(), ((0, 0), (0, pad)),
                                constant_values=unk)
        if asc:
            definite = np.nonzero(aln.seqtype.tip_table.sum(1) == 1.0)[0]
            state_code = np.full(S, unk, dtype=np.int64)
            for c in definite:
                state_code[aln.seqtype.tip_table[c].argmax()] = c
            for x in range(S):
                self.tip_codes[:, P + x] = state_code[x]
        self.pattern_weights = np.pad(
            aln.pattern_weights.astype(np.float64), (0, pad))
        self._pw = torch.as_tensor(self.pattern_weights, dtype=dtype,
                                   device=self.device)
        self._tip_codes = torch.as_tensor(self.tip_codes, dtype=torch.int64,
                                          device=self.device)
        self._sched_cache: dict = {}
        self.pack_np: ModelPack | None = None
        self._pack: dict | None = None
        self._tipP = None
        self._tip_table = None
        self._precise: LikelihoodEngine | None = None
        self.refresh_model()

    # ----------------------------------------------------------- model mgmt
    def refresh_model(self) -> None:
        """Rebuild the model pack after model/rate parameter changes, and
        that of the float64 view where precise() has made one."""
        pk = build_model_pack(self.aln, self.model, self.rates)
        pad = self.Pp - self.aln.num_patterns
        log_inv = np.pad(pk.log_ptn_invar, (0, pad), constant_values=-np.inf)
        self.pack_np = pk
        pack = pack_to_torch(
            {**{f: getattr(pk, f) for f in ("eigvals", "U", "V", "W",
                                            "sqrt_freqs", "Q", "cat_rate",
                                            "cat_weight", "cat_mix",
                                            "root_freqs", "tip_table")},
             "log_ptn_invar": log_inv},
            self.device, self.dtype)
        if self.asc:
            P = self.aln.num_patterns
            mask = np.zeros(self.Pp)
            mask[P: P + self.aln.num_states] = 1.0
            pack.update(pack_to_torch(
                {"asc_mask": mask,
                 "asc_nsites": self.aln.pattern_weights.sum()},
                self.device, self.dtype))
        # the tip partials change only with the tip table (+E error models
        # rewrite it per parameter step), not on every model refresh
        tip_table = pack.pop("tip_table")
        if self._tipP is None or not torch.equal(tip_table, self._tip_table):
            self._tipP = pruning.tip_partials(self._tip_codes, tip_table)
            self._tip_table = tip_table
        self._pack = pack
        if self._precise is not None:
            self.precise().refresh_model()

    def precise(self) -> "LikelihoodEngine":
        """This engine in float64 (itself when it is float64), sharing its
        model objects: what the model-parameter objectives evaluate. In
        float32 their finite differences and Brent steps drown in the
        logL's rounding (at 1000 taxa x 1024 sites its ulp is 0.03), and
        the fits stall short of the optimum. A fit sets parameters,
        refreshes this view alone for each evaluation, and refreshes the
        engine (and so the view) once it is done. The view follows the
        engine's model objects, which ModelFinder swaps per candidate."""
        if self.dtype == torch.float64:
            return self
        if self._precise is None:
            view = LikelihoodEngine(self.aln, self.model, self.rates,
                                    dtype=torch.float64, device=self.device,
                                    asc=self.asc)
            view.pattern_weights = self.pattern_weights
            view._pw = torch.as_tensor(self.pattern_weights,
                                       dtype=torch.float64, device=self.device)
            self._precise = view
        self._precise.model, self._precise.rates = self.model, self.rates
        return self._precise

    def with_pattern_weights(self, weights: np.ndarray) -> "LikelihoodEngine":
        """Shallow view of this engine with different pattern weights
        (bootstrap-replicate refinement; shares the model tensors)."""
        view = copy.copy(self)
        view._precise = None
        w = np.zeros(self.Pp)
        w[: len(weights)] = weights
        view.pattern_weights = w
        view._pw = torch.as_tensor(w, dtype=self.dtype, device=self.device)
        return view

    # ------------------------------------------------------------- schedule
    def schedule_arrays(self, sched: TreeSchedule) -> dict:
        """The schedule's index arrays on the device, cached per topology
        (every fixed-topology refit evaluates the same tree)."""
        h = hashlib.blake2b(digest_size=16)
        for a in sched.to_device_arrays().values():
            h.update(np.ascontiguousarray(a).tobytes())
        key = h.digest()
        hit = self._sched_cache.get(key)
        if hit is None:
            if len(self._sched_cache) >= _SCHED_CACHE_SIZE:
                self._sched_cache.pop(next(iter(self._sched_cache)))
            hit = sched_to_torch(sched.to_device_arrays(), self.device)
            self._sched_cache[key] = hit
        return hit

    def _blens(self, sched: TreeSchedule, t_min: float | None = None):
        b = sched.blens if t_min is None else np.maximum(sched.blens, t_min)
        return torch.as_tensor(b, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ main API
    def loglik_tree(self, tree: Tree) -> float:
        return self.loglik_sched(build_schedule(tree))

    def loglik_sched(self, sched: TreeSchedule) -> float:
        logL, _ = pruning.tree_loglik(self._blens(sched), self._tipP,
                                      self.schedule_arrays(sched),
                                      self._pack, self._pw)
        return float(logL)

    def site_lp(self, tree: Tree) -> tuple[float, np.ndarray]:
        """(logL, per-pattern log-likelihood [num_patterns])."""
        sched = build_schedule(tree)
        logL, lp = pruning.tree_loglik(self._blens(sched), self._tipP,
                                       self.schedule_arrays(sched),
                                       self._pack, self._pw)
        return (float(logL),
                lp[: self.aln.num_patterns].double().cpu().numpy())

    def compute_passes(self, sched: TreeSchedule):
        """(DownPass, UpPass, logL) device tensors for one topology."""
        sa = self.schedule_arrays(sched)
        P = pruning.transition_tensors(self._blens(sched), self._pack)
        dp, up = pruning.both_passes(P, self._tipP, sa, self._pack,
                                     want_lp=True)
        logL, _ = pruning.finalize_loglik(
            pruning.site_lp(dp), self._pw,
            asc_mask=self._pack.get("asc_mask"),
            asc_nsites=self._pack.get("asc_nsites"))
        return dp, up, logL

    def ancestral_posteriors(self, tree: Tree):
        """(posteriors [n_int, S, num_patterns], postorder internal node
        ids, sched): marginal ancestral states (engine._asr_jit's first
        output; reference: computeMarginalAncestralState,
        tree/phylotree.h:1069), posterior(node, s) proportional to
        sum_c w_c down(node, c, s) up(node, c, s). One down pass and one up
        pass; the scale counts are shared by the states of a pattern, so
        the normalisation cancels them."""
        sched = build_schedule(tree)
        P = pruning.transition_tensors(self._blens(sched), self._pack)
        dp, up = pruning.both_passes(P, self._tipP,
                                     self.schedule_arrays(sched), self._pack)
        L = self._tipP.shape[0]
        post = torch.einsum("c,ncsp->nsp", self._pack["cat_weight"],
                            dp.all[L:] * up.up_in)
        post = post / post.sum(1, keepdim=True).clamp(
            min=torch.finfo(self.dtype).tiny)
        return (post[:, :, : self.aln.num_patterns].cpu().numpy(),
                list(sched.postorder_nodes), sched)

    def site_rate_posterior(self, tree: Tree):
        """(posterior mean rate per pattern [num_patterns], category
        posterior [C, num_patterns]): engine._asr_jit's second output, the
        rate categories at the root partial, the +I class left out as
        there (reference analog: the .rate output). It needs only the down
        pass."""
        sched = build_schedule(tree)
        P = pruning.transition_tensors(self._blens(sched), self._pack)
        dp = pruning.down_pass(P, self._tipP, self.schedule_arrays(sched),
                               tips=False)
        Broot, _ = pruning.root_partial(dp, P, self._tipP, sched.n_int)
        lh_cat = torch.einsum("cx,cxp->cp", self._pack["root_freqs"], Broot)
        cat_post = self._pack["cat_weight"][:, None] * lh_cat
        cat_post = cat_post / cat_post.sum(0, keepdim=True).clamp(
            min=torch.finfo(self.dtype).tiny)
        cat_post = cat_post[:, : self.aln.num_patterns].cpu().numpy()
        return np.asarray(self.pack_np.cat_rate) @ cat_post, cat_post

    @property
    def nonrev(self) -> bool:
        """The model has no eigenbasis theta (pack["Q"]): the branch Newton
        and NNI scoring take the direct derivatives (the JAX engine's
        _opt_kind "nonrev")."""
        return self._pack.get("Q") is not None

    def _optimize_blens(self, blens, sa, t_min, t_max, n_rounds: int,
                        n_newton: int):
        """(blens, logL) of the all-branch Newton this model takes."""
        opt = optimize_blens_nonrev if self.nonrev else optimize_blens
        return opt(blens, self._tipP, sa, self._pack, self._pw, t_min, t_max,
                   n_rounds, n_newton)

    def optimize_branches(self, tree: Tree, n_rounds: int = 10,
                          n_newton: int = 4,
                          t_min: float = DEFAULT_MIN_BLEN,
                          t_max: float = DEFAULT_MAX_BLEN) -> float:
        """Optimize all branch lengths in place on the host tree; returns
        the final logL."""
        sched = build_schedule(tree)
        nb, logL = self._optimize_blens(self._blens(sched, t_min),
                                        self.schedule_arrays(sched), t_min,
                                        t_max, n_rounds, n_newton)
        write_blens_to_tree(tree, sched, nb.double().cpu().numpy())
        return float(logL)

    # ------------------------------------------------------------------ NNI
    def _nni_scores(self, cand_arrays, blens, dp, up, sa, t_min, t_max,
                    nni5: bool, return_site_lp: bool = False) -> list:
        if nni5:
            out = nni.evaluate_nnis5(cand_arrays, blens, dp, up, sa,
                                     self._pack, self._pw, t_min, t_max,
                                     return_site_lp=return_site_lp,
                                     nonrev=self.nonrev)
        else:
            out = nni.evaluate_nnis(cand_arrays, blens, dp, up.up_in,
                                    up.up_scale, sa, self._pack, self._pw,
                                    t_min, t_max,
                                    return_site_lp=return_site_lp,
                                    nonrev=self.nonrev)
        out = [o.double().cpu().numpy() for o in out]
        if return_site_lp:
            out[-1] = out[-1][:, :, : self.aln.num_patterns]
        return out

    def evaluate_nni_batch(self, sched: TreeSchedule, cand_arrays,
                           t_min: float = DEFAULT_MIN_BLEN,
                           t_max: float = DEFAULT_MAX_BLEN,
                           return_site_lp: bool = False, nni5: bool = False):
        """Score every NNI candidate (both variants and the baseline) at the
        schedule's branch lengths. Returns (logl [n, 3], t_opt [n, 3]), with
        nni5 also t5 [n, 3, 5] (ops/nni.evaluate_nnis5), with
        return_site_lp also per-pattern logLs [n, 3, num_patterns]."""
        sa = self.schedule_arrays(sched)
        blens = self._blens(sched)
        P = pruning.transition_tensors(blens, self._pack)
        dp, up = pruning.both_passes(P, self._tipP, sa, self._pack)
        return tuple(self._nni_scores(cand_arrays, blens, dp, up, sa, t_min,
                                      t_max, nni5, return_site_lp))

    def optimize_and_evaluate_nnis(self, tree: Tree, sched: TreeSchedule,
                                   cand_arrays, n_rounds: int = 4,
                                   t_min: float = DEFAULT_MIN_BLEN,
                                   t_max: float = DEFAULT_MAX_BLEN,
                                   nni5: bool = False,
                                   want_lp: bool = False):
        """The fused NNI round: all-branch Newton (lengths written back into
        ``tree`` and ``sched``), both passes at the optimised lengths, NNI
        scoring, and with want_lp the optimised tree's site log-likelihoods
        (the epilogue of that down pass).

        Returns (opt_logL, logl [n, 3], t_opt [n, 3][, t5 [n, 3, 5]]
        [, site_lp [num_patterns]])."""
        sa = self.schedule_arrays(sched)
        nb, logL = self._optimize_blens(self._blens(sched, t_min), sa, t_min,
                                        t_max, n_rounds, n_newton=4)
        P = pruning.transition_tensors(nb, self._pack)
        dp, up = pruning.both_passes(P, self._tipP, sa, self._pack,
                                     want_lp=want_lp)
        out = [float(logL)] + self._nni_scores(cand_arrays, nb, dp, up, sa,
                                               t_min, t_max, nni5)
        if want_lp:
            lp = pruning.site_lp(dp)
            out.append(lp[: self.aln.num_patterns].double().cpu().numpy())
        nb = nb.double().cpu().numpy()
        write_blens_to_tree(tree, sched, nb)
        sched.blens[:] = nb
        return tuple(out)

    def optimize_and_evaluate_nnis_batch(self, trees, scheds, cand_list,
                                         n_rounds: int = 4,
                                         t_min: float = DEFAULT_MIN_BLEN,
                                         t_max: float = DEFAULT_MAX_BLEN,
                                         nni5: bool = False,
                                         want_lp: bool = False) -> list:
        """The fused round for K trees: a list of the serial results."""
        return [self.optimize_and_evaluate_nnis(
            t, s, c, n_rounds=n_rounds, t_min=t_min, t_max=t_max, nni5=nni5,
            want_lp=want_lp) for t, s, c in zip(trees, scheds, cand_list)]

    def optimize_branches_batch(self, trees, n_rounds: int = 4,
                                n_newton: int = 4,
                                t_min: float = DEFAULT_MIN_BLEN,
                                t_max: float = DEFAULT_MAX_BLEN) -> list:
        """optimize_branches for K trees (lengths written back in place);
        returns their logLs."""
        return [self.optimize_branches(t, n_rounds=n_rounds,
                                       n_newton=n_newton, t_min=t_min,
                                       t_max=t_max) for t in trees]
