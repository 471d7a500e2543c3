"""Single-branch support tests: SH-aLRT and aBayes.

Reference analog (SURVEY A5): testAllBranches (tree/phylotree.cpp:5315) ->
testOneBranch (:5217): per internal branch, the two NNI-alternative logLs
are computed, then RELL site resampling with per-configuration centering
gives the SH-aLRT proportion; aBayes = 1/(1+e^{l1-l0}+e^{l2-l0}) (:5244).

Copied from iqtree2_tpu/tests_branch.py, whose module imports jax. The
candidates go to the engine as the port's search gives them, one
[4, n] array of (iu, iv, slot_c, edge_id) (search/nni.py); the JAX copy
builds an eight-array tuple from fields NNICandidates does not have and
raises there. All per-branch NNI configurations are scored in one engine
call (one down pass, one up pass, then NNI1 scoring with per-pattern
logLs); the RELL resampling is a single [reps, P] x [P, 3n] product on the
host (a BLAS product where the JAX copy runs einsum's own loop). The JAX
copy's local bootstrap and parametric aLRT are left out: its analysis
never asks for them (-lbp is accepted and ignored there, refused here).
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.ops.nni import build_nni_candidates
from iqtree2_tpu_torch.search.nni import _cand_array
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree


def test_all_branches(eng, tree: Tree, n_rell: int = 1000, *,
                      rng: np.random.Generator, do_abayes: bool = False
                      ) -> dict[tuple[int, int], tuple]:
    """Returns {branch key: (SH_aLRT_pct, [aBayes])} for every internal
    branch; the RELL weights are drawn from rng."""
    aln = eng.aln
    sched = build_schedule(tree)
    cand = build_nni_candidates(tree, sched)
    if len(cand.nodes_u) == 0:
        return {}
    logl, t_opt, site_lp = eng.evaluate_nni_batch(sched, _cand_array(cand),
                                                  return_site_lp=True)
    logl = np.asarray(logl, np.float64)          # [n, 3] cols: nni1,nni2,cur
    site_lp = np.asarray(site_lp, np.float64)    # [n, 3, P]
    w = aln.pattern_weights

    # reorder to (current, nni1, nni2)
    order = [2, 0, 1]
    lh = logl[:, order]                          # [n, 3]
    pat = site_lp[:, order, :]                   # [n, 3, P]

    # RELL resampling: one multinomial weight matrix for all branches
    nsites = int(w.sum())
    probs = w / w.sum()
    Wb = rng.multinomial(nsites, probs, size=n_rell).astype(np.float64)
    # lh_new[b, rep, c] = Wb[rep] . pat[b, c], as one BLAS product (the
    # plain einsum loop takes minutes at 1000 taxa; only the summation
    # order differs)
    lh_new = np.einsum("rp,bcp->brc", Wb, pat, optimize=True)

    cs = lh_new - lh[:, None, :]                 # centered
    aLRT = lh[:, 0] - np.maximum(lh[:, 1], lh[:, 2])
    cs_sorted = np.sort(cs, axis=2)
    cs_best = cs_sorted[:, :, 2]
    cs_2nd = cs_sorted[:, :, 1]
    sh_count = (aLRT[:, None] > (cs_best - cs_2nd) + 0.05).sum(axis=1)
    sh_support = 100.0 * sh_count / n_rell

    abayes = 1.0 / (1.0 + np.exp(np.minimum(lh[:, 1] - lh[:, 0], 50))
                    + np.exp(np.minimum(lh[:, 2] - lh[:, 0], 50)))

    out = {}
    for i in range(len(lh)):
        u, v = cand.nodes_u[i], cand.nodes_v[i]
        vals = [float(sh_support[i])]
        if do_abayes:
            vals.append(float(abayes[i]))
        out[Tree._key(u, v)] = tuple(round(x, 3) for x in vals)
    return out
