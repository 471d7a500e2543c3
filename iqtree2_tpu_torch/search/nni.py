"""NNI hill-climbing on the host, scored on the device (counterpart of
iqtree2_tpu/search/nni.py, whose module imports jax).

On a LikelihoodEngine every round is one fused engine call
(engine.optimize_and_evaluate_nnis): all-branch Newton, both passes, NNI
scoring and, with want_lp, the site log-likelihoods for UFBoot. An engine
without the fused round (partition/engine.PartitionEngine, and the
per-class model/heterotachy.MixlenEngine, which opts out) takes the JAX
package's unfused climb step for step: optimize_branches, then
evaluate_nni_batch, the swaps, optimize_branches again; its unlinked mode
and the PMSF SSFEngine (model/pmsf.py) score NNI1 only, with a NOTE. The host applies the best non-conflicting
improving swaps, skipping any that breaks a -g constraint split.
Reference analog: IQTree::optimizeNNI (tree/iqtree.cpp:2998) /
evaluateNNIs (:3426).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.ops.nni import NNICandidates, build_nni_candidates
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree

MAX_ROUNDS = 100     # NNI rounds per climb
BLEN_ROUNDS = 2      # Newton sweeps in a fused round (reference economics)
POLISH_ROUNDS = 8    # Newton sweeps once at the end of a climb


@dataclasses.dataclass
class NNIResult:
    logL: float
    n_rounds: int
    n_applied_total: int


def _slot_node(tree: Tree, sched, i_node: int, slot: int) -> int:
    src = int(sched.child_src[i_node, slot])
    if src < sched.ntaxa:
        return src
    return sched.postorder_nodes[src - sched.ntaxa]


def _cand_array(cand: NNICandidates) -> np.ndarray:
    return np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])


def _apply_best_swaps(tree: Tree, sched, cand, logl, t_opt, t5,
                      loglh_epsilon: float, constraint=None):
    """Apply the best non-conflicting improving NNI swaps to ``tree`` with
    their optimised lengths, the central one alone when t5 is None (NNI1)
    (greedy by gain, one move per node; reference applyNNIs,
    tree/iqtree.cpp:3426); a swap that breaks a split of ``constraint``
    (-g) is undone and skipped. Returns (applied, undo) where undo = (swap log,
    branch lengths before the swaps, blen_h before them)."""
    base = logl[:, 2]
    gains = logl[:, :2] - base[:, None]
    best_var = gains.argmax(axis=1)
    best_gain = gains[np.arange(len(base)), best_var]
    order = np.argsort(-best_gain)
    used_nodes: set[int] = set()
    applied = 0
    swap_log: list[tuple[int, int, int, int]] = []
    undo = (swap_log, dict(tree.blen), dict(tree.blen_h))
    L = sched.ntaxa
    for ci in order:
        if best_gain[ci] <= loglh_epsilon:
            break
        u = cand.nodes_u[ci]
        v = cand.nodes_v[ci]
        if u in used_nodes or v in used_nodes:
            continue
        var = int(best_var[ci])
        # variant 0 swaps the child at slot 1 (b) with the sibling c;
        # variant 1 swaps the child at slot 0 (a) with c
        iu, iv = int(cand.iu[ci]), int(cand.iv[ci])
        a_node = _slot_node(tree, sched, iu, 0)
        b_node = _slot_node(tree, sched, iu, 1)
        moved_slot = 1 if var == 0 else 0
        x = _slot_node(tree, sched, iu, moved_slot)
        c = _slot_node(tree, sched, iv, int(cand.slot_c[ci]))
        tree.swap_subtrees(u, x, v, c)
        if constraint is not None and not constraint.compatible(tree):
            tree.swap_subtrees(u, c, v, x)   # undo: violates -g
            continue
        swap_log.append((u, x, v, c))
        tree.set_blen(u, v, float(t_opt[ci, var]))
        if t5 is None:
            used_nodes.update([u, v])
            applied += 1
            continue
        # the four outer optimised lengths, after the swap: the moved child
        # x now hangs off v, c off u
        tv5 = t5[ci, var]     # (a, b, c, d, e)
        kept = a_node if var == 0 else b_node
        tree.set_blen(kept, u, float(tv5[0] if var == 0 else tv5[1]))
        tree.set_blen(c, u, float(tv5[2]))
        tree.set_blen(x, v, float(tv5[moved_slot]))
        if iv != sched.n_int - 1:
            vp = sched.edge_nodes[L + iv][1]
            if vp not in used_nodes:
                tree.set_blen(v, vp, float(tv5[3]))
        used_nodes.update([u, v])
        applied += 1
    return applied, undo


def _revert_swaps(tree: Tree, undo) -> None:
    swaps, blen_snap, blen_h_snap = undo
    for (u_, x_, v_, c_) in reversed(swaps):
        tree.swap_subtrees(u_, c_, v_, x_)
    tree.blen = dict(blen_snap)
    tree.blen_h = dict(blen_h_snap)


def fused_round(eng) -> bool:
    """The engine has the fused NNI round and takes it: not a partition or
    PMSF engine (which lack it), not a MixlenEngine (_fused_nni False: the
    fused round would optimise scalar lengths)."""
    return (hasattr(eng, "optimize_and_evaluate_nnis")
            and getattr(eng, "_fused_nni", True))


def _supports_nni5(eng) -> bool:
    """Engines whose NNI scoring re-optimises five branches: all but a
    PartitionEngine with unlinked branch lengths (-Q) and the PMSF
    SSFEngine (NNI5 False), as in the JAX package."""
    return (getattr(eng, "NNI5", True)
            and getattr(eng, "partition_type", None) != "unlinked")


def nni_optimize(eng: LikelihoodEngine, tree: Tree,
                 loglh_epsilon: float = 0.001, max_rounds: int = MAX_ROUNDS,
                 nni5: bool = True, want_lp: bool = False, constraint=None):
    """Hill-climb with NNI moves until no improving move remains, at most
    max_rounds rounds of BLEN_ROUNDS Newton sweeps each.

    With nni5 (the reference default params.nni5) each candidate is scored
    with all five surrounding branches re-optimised and applied with those
    lengths; without it (NNI1, as -bnni refines replicate trees) with the
    central branch alone. Swaps that break a split of ``constraint`` (-g)
    are skipped. Mutates ``tree`` in place and returns an NNIResult; with
    want_lp returns (NNIResult, lp), lp being the final tree's per-pattern
    log-likelihoods for UFBoot, from the last fused round where the tree
    did not change after it.
    """
    if not fused_round(eng):
        return _nni_optimize_unfused(eng, tree, loglh_epsilon, max_rounds,
                                     nni5, want_lp, constraint)
    total_applied = 0
    logL = None
    lp = None
    rnd = 0
    dirty = False      # True iff swaps were applied after the last round
    undo = None        # reverts a regressing round's swaps, so the tree
    #                    and the returned logL stay consistent
    for rnd in range(1, max_rounds + 1):
        sched = build_schedule(tree)
        cand = build_nni_candidates(tree, sched)
        if len(cand.nodes_u) == 0:
            break
        out = eng.optimize_and_evaluate_nnis(
            tree, sched, _cand_array(cand), n_rounds=BLEN_ROUNDS, nni5=nni5,
            want_lp=want_lp)
        opt_logL, logl, t_opt = out[:3]
        t5 = out[3] if nni5 else None
        if want_lp:
            lp = out[-1]
        dirty = False
        # this round's optimised logL is the result of the previous round's
        # swaps: if they regressed, revert them
        if logL is not None and opt_logL < logL - 1e-6 and undo is not None:
            _revert_swaps(tree, undo)
            lp = None
            break
        if logL is not None and opt_logL - logL < loglh_epsilon:
            logL = max(opt_logL, logL)
            break
        logL = opt_logL
        applied, undo = _apply_best_swaps(tree, sched, cand, logl, t_opt, t5,
                                          loglh_epsilon, constraint)
        if applied == 0:
            break
        total_applied += applied
        dirty = True
    else:
        rnd = max_rounds
    # final polish: converge the lengths once at exit (reference:
    # optimizeAllBranches() after doNNISearch, tree/iqtree.cpp:2640)
    new_logL = eng.optimize_branches(tree, n_rounds=POLISH_ROUNDS)
    if logL is None:      # no NNI candidate at all
        logL = new_logL
    else:
        if dirty or new_logL > logL + 1e-9:
            lp = None
        logL = max(new_logL, logL)
    res = NNIResult(logL=logL, n_rounds=rnd, n_applied_total=total_applied)
    if want_lp:
        if lp is None:
            _, lp = eng.site_lp(tree)
        return res, lp
    return res


def _nni_optimize_unfused(eng, tree: Tree, loglh_epsilon: float,
                          max_rounds: int, nni5: bool, want_lp: bool,
                          constraint):
    """The JAX package's climb for engines without the fused round
    (iqtree2_tpu/search/nni.py:240-350): optimize_branches before the
    first round and after every round's swaps, evaluate_nni_batch in
    between; a regressing round is reverted and the lengths refitted. A
    per-class engine reads the tree's class lengths (tree.blen_h) through
    eng._nni_tree, as in the JAX package."""
    eng._nni_tree = tree
    use5 = nni5
    if use5 and not _supports_nni5(eng):
        use5 = False
        if not getattr(eng, "_warned_nni1", False):
            eng._warned_nni1 = True
            print(f"NOTE: {type(eng).__name__} scores NNIs on the central "
                  "branch only (NNI1); five-branch re-optimization is not "
                  "implemented for this engine")
    total_applied = 0
    logL = eng.optimize_branches(tree, n_rounds=BLEN_ROUNDS)
    rnd = 0
    for rnd in range(1, max_rounds + 1):
        sched = build_schedule(tree)
        cand = build_nni_candidates(tree, sched)
        if len(cand.nodes_u) == 0:
            break
        t5 = None
        if use5:
            logl, t_opt, t5 = eng.evaluate_nni_batch(sched, _cand_array(cand),
                                                     nni5=True)
        else:
            logl, t_opt = eng.evaluate_nni_batch(sched, _cand_array(cand))
        applied, undo = _apply_best_swaps(tree, sched, cand, logl, t_opt, t5,
                                          loglh_epsilon, constraint)
        if applied == 0:
            break
        total_applied += applied
        new_logL = eng.optimize_branches(tree, n_rounds=BLEN_ROUNDS)
        if new_logL < logL - 1e-6:
            _revert_swaps(tree, undo)
            logL = eng.optimize_branches(tree, n_rounds=BLEN_ROUNDS)
            break
        if new_logL - logL < loglh_epsilon:
            logL = max(new_logL, logL)
            break
        logL = new_logL
    else:
        rnd = max_rounds
    new_logL = eng.optimize_branches(tree, n_rounds=POLISH_ROUNDS)
    logL = max(new_logL, logL)
    res = NNIResult(logL=logL, n_rounds=rnd, n_applied_total=total_applied)
    if want_lp:
        return res, eng.site_lp(tree)[1]
    return res
