"""Pattern-sharded likelihood over a torch.distributed group (counterpart of
iqtree2_tpu/parallel/shard.py).

Alignment site patterns are the data-parallel axis. Each rank holds one
contiguous slice of the padded pattern axis: the tip partials
tipP[..., a:b], the pattern weights, log_ptn_invar and the +ASC mask; the
model pack, the schedule and the branch lengths are whole on every rank. A
rank runs the port's passes on its slice (on the card, the CUDA kernels of
ops/kernels.py at the slice's width), and the pattern sums (logL, the
Newton derivatives d1 and d2, the +ASC prob_unobs, s, s1 and s2) cross the
ranks through ``reduce``, the counterpart of the JAX package's psum over
the mesh axis "sites": all_reduce_sum, a dist.all_reduce with SUM. Branch
lengths are updated identically on every rank from the summed derivatives.

The JAX package pads each shard to 128 TPU lanes (pad_patterns_for_mesh);
here every slice has the same width, a multiple of the engine's
PATTERN_PAD, so every rank runs the same chunks and calls ``reduce``
equally often. Padding patterns have weight 0, all-ones tips and
log_ptn_invar -inf, so they add nothing to any sum. The +ASC
pseudo-patterns sit at the end of the engine's axis (engine.py), on the
last rank whose slice reaches them; prob_unobs is summed over the ranks
before its logarithm (pruning.finalize_loglik). The slices are made
contiguous once, at setup: the kernels refuse a non-contiguous operand.

Each function returns a callable a rank calls on its own slice, as the JAX
package's return a jitted shard_map over the whole mesh; every rank of the
group must make the same calls in the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from iqtree2_tpu_torch.engine import PATTERN_PAD
from iqtree2_tpu_torch.ops import nni, pruning


def pad_patterns_for_ranks(n_patterns: int, nranks: int,
                           pad: int = PATTERN_PAD) -> int:
    """Pattern count padded so that each of ``nranks`` slices has the same
    width, a multiple of ``pad``."""
    per = -(-n_patterns // nranks)
    return -(-per // pad) * pad * nranks


def rank_bounds(n_patterns: int, rank: int, nranks: int,
                clip: bool = False) -> tuple[int, int]:
    """[a, b) of rank's slice of the axis padded by pad_patterns_for_ranks;
    with ``clip``, of the unpadded axis (a slice there may be short or
    empty)."""
    per = pad_patterns_for_ranks(n_patterns, nranks) // nranks
    a, b = rank * per, (rank + 1) * per
    if clip:
        a, b = min(a, n_patterns), min(b, n_patterns)
    return a, b


def all_reduce_sum(group=None):
    """The ``reduce`` of ops/pruning.summed over a torch.distributed group
    (the default group where None): dist.all_reduce with SUM, in place."""
    import torch.distributed as dist

    def reduce(t: torch.Tensor) -> None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return reduce


class PatternShard(NamedTuple):
    """One rank's slice [a, b) of an engine's padded pattern axis."""
    a: int
    b: int
    tipP: torch.Tensor             # [L, S, b - a]
    pattern_weights: torch.Tensor  # [b - a]
    pack: dict    # the engine's model pack, per-pattern entries sliced


# the model pack's per-pattern entries and the value padding patterns get
_PER_PATTERN_PACK_KEYS = {"log_ptn_invar": float("-inf"), "asc_mask": 0.0}


def shard_engine_arrays(eng, rank: int, nranks: int,
                        device=None) -> PatternShard:
    """This rank's slice of a LikelihoodEngine's per-pattern arrays (its
    tip partials, pattern weights, log_ptn_invar and +ASC mask), padded to
    pad_patterns_for_ranks(eng.Pp, nranks), with the model pack, on
    ``device`` (the engine's where None), each slice contiguous. An engine
    on the CPU gives a rank the slice alone on its card."""
    Pp = eng.Pp
    extra = pad_patterns_for_ranks(Pp, nranks) - Pp
    a, b = rank_bounds(Pp, rank, nranks)
    device = eng.device if device is None else torch.device(device)

    def cut(x, fill):
        if extra:
            x = torch.nn.functional.pad(x, (0, extra), value=fill)
        return x[..., a:b].to(device).contiguous()

    pack = {k: (v if v is None else cut(v, _PER_PATTERN_PACK_KEYS[k])
                if k in _PER_PATTERN_PACK_KEYS else v.to(device))
            for k, v in eng._pack.items()}
    return PatternShard(a, b, cut(eng._tipP, 1.0), cut(eng._pw, 0.0), pack)


def sharded_loglik_fn(reduce):
    """fn(blens, tipP, sched, pack, pattern_weights) -> (logL summed over
    the group, this rank's site log-likelihoods [b - a])."""
    def fn(blens, tipP, sched, pack, pattern_weights):
        return pruning.tree_loglik(blens, tipP, sched, pack, pattern_weights,
                                   reduce=reduce)
    return fn


def sharded_optimize_step_fn(reduce, n_newton: int = 4):
    """step(blens, tipP, sched, pack, pattern_weights, t_min, t_max) ->
    (blens, logL): one branch-length round on every rank's slice, a down
    pass and a theta pass, n_newton Newton iterations on every edge at once
    with d1 and d2 summed over the group, the lengths clamped, and the
    summed logL at them. Only O(edges) scalars cross the ranks per Newton
    iteration. A reversible model's (the JAX package's edge_thetas path)."""
    def step(blens, tipP, sched, pack, pattern_weights, t_min, t_max):
        if pack.get("Q") is not None:
            raise NotImplementedError(
                "sharded_optimize_step_fn: a nonreversible model has no "
                "eigenbasis theta (the JAX package's step has none either)")
        b = blens.to(tipP.dtype)
        P = pruning.transition_tensors(b, pack)
        dp = pruning.down_pass(P, tipP, sched, tips=False)
        th = pruning.theta_pass(P, dp, tipP, sched, pack)
        new = pruning.newton_branch_step(
            th.theta, th.scale, b, pack, pack["log_ptn_invar"],
            pattern_weights, t_min, t_max, n_iter=n_newton,
            reduce=reduce).clamp(t_min, t_max)
        logL, _ = pruning.tree_loglik(new, tipP, sched, pack,
                                      pattern_weights, reduce=reduce)
        return new, logL
    return step


def sharded_rell_fn(reduce):
    """rell(samples [R, b - a], lp [b - a]) -> every replicate's RELL
    logL [R]: this rank's slice of the [R, P] @ [P] product, summed over
    the group (the product alone where ``reduce`` is None; reference
    analog: per-rank replicate slices, tree/iqtree.cpp:352-362; here every
    rank holds a pattern slice of all replicates)."""
    def rell(samples, lp):
        out = samples @ lp
        if reduce is not None:
            reduce(out)
        return out
    return rell


def sharded_nni_fn(reduce, n_newton: int = 4):
    """fn(cand, blens, dp, up_in, up_scale, sched, pack, pattern_weights,
    t_min, t_max) -> (logl [n, 3], t_opt [n, 3]): NNI1 scoring
    (ops/nni.evaluate_nnis) with the down and outside partials of this
    rank's slice (pruning.both_passes on it) and the Newton sums and logLs
    summed over the group."""
    def fn(cand, blens, dp, up_in, up_scale, sched, pack, pattern_weights,
           t_min, t_max):
        return nni.evaluate_nnis(cand, blens, dp, up_in, up_scale, sched,
                                 pack, pattern_weights, t_min, t_max,
                                 n_newton=n_newton, reduce=reduce)
    return fn
