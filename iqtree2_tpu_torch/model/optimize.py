"""Model-parameter optimization against the torch engine (counterpart of
iqtree2_tpu/model/optimize.py).

As in the JAX package, the joint fit with exact gradients
(model/torchfit.try_fit) runs first; the host alternation runs only where
that fit does not apply (models it does not cover, +ASC, and problems above
torchfit.MAX_REVERSE_ELEMENTS, which covers every large alignment). The
alternation: bounded L-BFGS-B over the substitution and rate parameters,
each objective evaluation one logL on the fixed topology, then all-branch
Newton, until a round gains less than epsilon. Its objectives evaluate the
engine's float64 view (LikelihoodEngine.precise()), as the partition fits
do: finite differences of a float32 logL stall short of the optimum (the
JAX package's float32 alternation stops about 2.6 logL short on a
24 x 1000 simulation, tests/test_torch_fit.py). The branch-length steps
run in the engine's own precision. Reference analog:
ModelFactory::optimizeParameters (model/modelfactory.cpp:1329).
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model import torchfit
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree
from iqtree2_tpu_torch.utils.optimize import brent_minimize, lbfgsb_minimize

DEFAULT_MODEL_EPS = 0.01  # reference: modelEps (utils/tools.cpp:1313)
MAX_ROUNDS = 100          # alternation rounds (the JAX package's default)
BLEN_ROUNDS = 8           # Newton sweeps per branch-length step


def optimize_model_parameters(eng: LikelihoodEngine, tree: Tree,
                              epsilon: float = DEFAULT_MODEL_EPS,
                              max_rounds: int = MAX_ROUNDS,
                              blen_rounds: int = BLEN_ROUNDS,
                              screen_iters: int | None = None) -> float:
    """Optimize (model params, rate params, branch lengths) in place.

    max_rounds caps the alternation's rounds, blen_rounds the Newton
    sweeps of each branch-length step, and screen_iters the joint fit's
    L-BFGS iterations (torchfit.try_fit's max_iters); ModelFinder passes
    3, 4 and 8 for its screen. Returns the final log-likelihood.
    """
    fitted = torchfit.try_fit(eng, tree, epsilon=epsilon,
                              max_iters=screen_iters)
    if fitted is not None:
        return fitted
    model, rates = eng.model, eng.rates
    logL = eng.optimize_branches(tree, n_rounds=blen_rounds)
    for _ in range(max_rounds):
        prev = logL

        # ---- substitution + rate parameters via bounded L-BFGS-B ---------
        x_model = model.get_params()
        x_rates = rates.get_params()
        nm = len(x_model)
        x0 = np.concatenate([x_model, x_rates])
        if len(x0):
            sched = build_schedule(tree)
            lo_m, hi_m = (model.param_bounds() if nm else
                          (np.zeros(0), np.zeros(0)))
            lo_r, hi_r = (rates.param_bounds() if len(x_rates) else
                          (np.zeros(0), np.zeros(0)))
            lo = np.concatenate([lo_m, lo_r])
            hi = np.concatenate([hi_m, hi_r])

            view = eng.precise()

            def obj(x):
                if nm:
                    model.set_params(x[:nm])
                if len(x) > nm:
                    rates.set_params(x[nm:])
                view.refresh_model()
                return -view.loglik_sched(sched)

            x_best, neg = lbfgsb_minimize(obj, np.clip(x0, lo, hi), lo, hi)
            obj(x_best)     # leave the best point applied
            eng.refresh_model()
            logL = -neg

        # ---- branch lengths ---------------------------------------------
        logL = eng.optimize_branches(tree, n_rounds=blen_rounds)
        if logL - prev < epsilon:
            break
    return logL


def optimize_rate_scalar(eng: LikelihoodEngine, tree: Tree, getter, setter,
                         lo: float, hi: float) -> float:
    """Brent 1-D on a single rate parameter (e.g. alpha or p_invar).

    Reference analog: RateGamma::optimizeParameters via Brent
    (utils/optimization.cpp:322)."""
    sched = build_schedule(tree)
    view = eng.precise()

    def obj(v):
        setter(float(v))
        view.refresh_model()
        return -view.loglik_sched(sched)

    x, fx = brent_minimize(obj, lo, hi, guess=getter())
    setter(float(x))
    eng.refresh_model()
    return -fx
