"""Partition-model parameter optimization.

Reference analog: PartitionModel::optimizeParameters
(model/partitionmodel.cpp) — per-partition substitution/rate parameters are
independent (unlinked models), optimized one partition at a time with the
shared tree fixed; edge-proportional mode interleaves per-partition rate
multipliers (PartitionModelPlen); branch lengths re-optimized jointly.

Copied from iqtree2_tpu/partition/optimize.py, on the port's
PartitionEngine and its copy of utils/optimize.lbfgsb_minimize; the
objective evaluates the partition engine's float64 view
(LikelihoodEngine.precise()), as model/optimize.py's alternation does.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.partition.engine import PartitionEngine
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree
from iqtree2_tpu_torch.utils.optimize import lbfgsb_minimize

DEFAULT_MODEL_EPS = 0.01


def _fit_one_partition(peng: PartitionEngine, k: int, sched,
                       blens_k: np.ndarray) -> float:
    """L-BFGS-B over partition k's (model, rate) parameters with fixed
    branch lengths. Returns the partition logL."""
    model, rates = peng.models[k], peng.rates[k]
    x_model = model.get_params()
    x_rates = rates.get_params()
    nm = len(x_model)
    x0 = np.concatenate([x_model, x_rates])
    if not len(x0):
        return peng.part_loglik(sched, k, blens=blens_k)
    lo_m, hi_m = model.param_bounds() if nm else (np.zeros(0), np.zeros(0))
    lo_r, hi_r = (rates.param_bounds() if len(x_rates)
                  else (np.zeros(0), np.zeros(0)))
    lo, hi = np.concatenate([lo_m, lo_r]), np.concatenate([hi_m, hi_r])

    view = peng.engines[k].precise()

    def obj(x):
        if nm:
            model.set_params(x[:nm])
        if len(x) > nm:
            rates.set_params(x[nm:])
        view.refresh_model()
        return -peng.part_loglik(sched, k, blens=blens_k)

    xb, neg = lbfgsb_minimize(obj, np.clip(x0, lo, hi), lo, hi)
    obj(xb)
    peng.refresh_model(k)
    return -neg


def optimize_partition_parameters(peng: PartitionEngine, tree: Tree,
                                  epsilon: float = DEFAULT_MODEL_EPS,
                                  max_rounds: int = 50,
                                  blen_rounds: int = 8,
                                  log=None) -> float:
    """Alternate (per-partition model fits, partition rates, joint branch
    lengths) until the total logL gain drops below epsilon."""
    logL = peng.optimize_branches(tree, n_rounds=blen_rounds)
    for rnd in range(max_rounds):
        prev = logL
        sched = build_schedule(tree)
        rks = peng._rks()
        for k in range(peng.K):
            if peng.partition_type == "unlinked" and \
                    peng._ul_blens is not None:
                blens_k = peng._ul_blens[k]
            else:
                blens_k = np.asarray(sched.blens) * rks[k]
            _fit_one_partition(peng, k, sched, blens_k)
        if peng.partition_type == "edge-proportional":
            peng.optimize_part_rates(tree)
        logL = peng.optimize_branches(tree, n_rounds=blen_rounds)
        if log:
            log(f"  [part-opt] round {rnd + 1}: logL {logL:.4f}")
        if logL - prev < epsilon:
            break
    return logL
