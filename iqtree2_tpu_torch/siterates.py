"""Site-specific ML rates (RateMeyerHaeseler analog).

Reference: RateMeyerHaeseler / RateMeyerDiscrete (model/ratemeyer*.cpp,
SURVEY #12): instead of a parametric +G law, each site gets its own ML
rate on the fixed tree. Per-pattern log-likelihoods on a log-spaced rate
grid (every grid point scales ALL branch lengths), the per-pattern argmax,
then one parabolic step in log-rate; no per-site likelihood work.

Copied from iqtree2_tpu/siterates.py, whose module imports jax. The JAX
package maps one jitted log-likelihood over the grid; here each grid point
is one ops/pruning.tree_loglik, a down pass with its site-logL epilogue,
so ML_RATE_GRID passes in all.
"""

from __future__ import annotations

import numpy as np
import torch

from iqtree2_tpu_torch.ops import pruning
from iqtree2_tpu_torch.tree.schedule import build_schedule

ML_RATE_GRID = 33          # log-spaced rate multipliers tried per site
ML_RATE_MIN = 1e-3         # the grid's least rate
ML_RATE_MAX = 20.0         # and its largest


def site_rates_ml(eng, tree):
    """(ml_rate [num_patterns], lp_at_best [num_patterns]).

    eng should carry a single-category rate model (the reference replaces
    +G by the per-site rates); with multiple categories the result is the
    ML *multiplier* on top of the rate mixture."""
    sched = build_schedule(tree)
    sa = eng.schedule_arrays(sched)
    blens = eng._blens(sched)
    grid = torch.as_tensor(
        np.geomspace(ML_RATE_MIN, ML_RATE_MAX, ML_RATE_GRID),
        dtype=eng.dtype, device=eng.device)
    lps = torch.stack([pruning.tree_loglik(blens * r, eng._tipP, sa,
                                           eng._pack, eng._pw)[1]
                       for r in grid])             # [ML_RATE_GRID, Pp]
    P = eng.aln.num_patterns
    lps = lps[:, :P].cpu().numpy()
    best = lps.argmax(axis=0)
    g = grid.cpu().numpy()
    rates = g[best]
    # one parabolic refinement in log-rate for interior maxima
    logg = np.log(g)
    for p in range(P):
        b = best[p]
        if 0 < b < ML_RATE_GRID - 1:
            y0, y1, y2 = lps[b - 1, p], lps[b, p], lps[b + 1, p]
            denom = (y0 - 2 * y1 + y2)
            if denom < -1e-12:
                dx = 0.5 * (y0 - y2) / denom
                dx = float(np.clip(dx, -1.0, 1.0))
                step = logg[b + 1] - logg[b]
                rates[p] = float(np.exp(logg[b] + dx * step))
    lp_best = lps[best, np.arange(P)]
    return rates, lp_best


def write_mlrate(path: str, aln, rates: np.ndarray) -> None:
    """.mlrate output (reference: -wsr with RateMeyerHaeseler)."""
    with open(path, "w") as f:
        f.write("# Site-specific ML rates (RateMeyerHaeseler analog)\n"
                "Site\tRate\n")
        for s in range(aln.nsites):
            f.write(f"{s + 1}\t{rates[aln.site_to_pattern[s]]:.5f}\n")
