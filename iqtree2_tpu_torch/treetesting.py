"""Topology tests: RELL bootstrap proportions, KH, SH, weighted variants,
ELW, and the AU (approximately unbiased) test.

Reference analogs (SURVEY A6): evaluateTrees (main/treetesting.cpp:1057)
computes per-tree pattern logLs, then RELL bootstrap proportions, KH/SH
(centered max statistics), weighted variants, ELW (:1313-1421), and
performAUTest (:788): 10 scale factors r in {0.5..1.4}, nboot multinomial
resamples per scale, per-tree win counts -> WLS fit of bp(r) to
1 - Phi(d*sqrt(r) + c/sqrt(r)) by Newton iterations -> p_AU
(Shimodaira 2002, the CONSEL procedure).

The resampling is a single [nboot, P] @ [P, ntrees] product per scale
instead of the reference's per-replicate loops.

Copied from iqtree2_tpu/treetesting.py (host numpy; run_tree_tests drives
the engine: per user tree the all-branch Newton, a down pass without tip
rows and a theta pass per round, then one log-likelihood): the port keeps
its own host modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.stats import norm

AU_SCALES = np.array([0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3, 1.4])


@dataclasses.dataclass
class TreeTestResult:
    logL: np.ndarray            # [T]
    deltaL: np.ndarray          # [T] logL_best - logL_t
    bp_rell: np.ndarray         # [T] RELL bootstrap proportion
    p_kh: np.ndarray            # [T]
    p_sh: np.ndarray            # [T]
    p_wkh: np.ndarray           # [T]
    p_wsh: np.ndarray           # [T]
    c_elw: np.ndarray           # [T]
    p_au: np.ndarray | None     # [T]


def evaluate_trees(site_lp: np.ndarray, pattern_weights: np.ndarray,
                   nboot: int = 10000, rng=None,
                   do_au: bool = True) -> TreeTestResult:
    """site_lp: [T, P] per-pattern logLs of each candidate tree (already
    branch-length-optimized); pattern_weights: [P] site counts."""
    if rng is None:
        rng = np.random.default_rng(42)
    L = np.asarray(site_lp, np.float64)
    w = np.asarray(pattern_weights, np.float64)
    T, P = L.shape
    n = int(round(w.sum()))
    logL = L @ w
    best = logL.argmax()
    deltaL = logL[best] - logL

    probs = w / w.sum()
    # ---- plain RELL resampling (scale 1) --------------------------------
    W = rng.multinomial(n, probs, size=nboot).astype(np.float64)  # [B, P]
    S = W @ L.T                                              # [B, T]
    winner = S.argmax(axis=1)
    bp = np.bincount(winner, minlength=T) / nboot

    # ---- KH test (Kishino-Hasegawa, vs the ML tree) ---------------------
    # centered test statistic per tree: delta_b = (S_best - S_t) centered
    d_obs = logL[best] - logL                                # [T]
    Sd = S[:, best][:, None] - S                             # [B, T]
    Sd_c = Sd - Sd.mean(axis=0, keepdims=True)               # centered
    p_kh = (Sd_c >= d_obs[None, :]).mean(axis=0)
    p_kh[best] = 1.0

    # ---- SH test (centered max statistic) -------------------------------
    S_c = S - S.mean(axis=0, keepdims=True)                  # [B, T]
    mx = S_c.max(axis=1, keepdims=True)                      # [B, 1]
    p_sh = (mx - S_c >= d_obs[None, :]).mean(axis=0)

    # ---- weighted variants (WKH / WSH): standardize by sd ---------------
    sd = Sd_c.std(axis=0, ddof=1)
    sd = np.where(sd < 1e-9, 1e-9, sd)
    p_wkh = (Sd_c / sd[None, :] >= (d_obs / sd)[None, :]).mean(axis=0)
    p_wkh[best] = 1.0
    # WSH: per tree, max over opponents of standardized centered diffs
    pair_sd = np.zeros((T, T))
    for t in range(T):
        D = S[:, t][:, None] - S                             # [B, T]
        Dc = D - D.mean(axis=0, keepdims=True)
        s = Dc.std(axis=0, ddof=1)
        pair_sd[t] = np.where(s < 1e-9, 1e-9, s)
    p_wsh = np.zeros(T)
    for t in range(T):
        d_t = (logL - logL[t]) / pair_sd[t]                  # observed
        D = S - S[:, t][:, None]
        Dc = (D - D.mean(axis=0, keepdims=True)) / pair_sd[t][None, :]
        stat_obs = d_t.max()
        p_wsh[t] = (Dc.max(axis=1) >= stat_obs).mean()

    # ---- ELW (expected likelihood weights) ------------------------------
    Sm = S - S.max(axis=1, keepdims=True)
    ew = np.exp(Sm)
    ew /= ew.sum(axis=1, keepdims=True)
    c_elw = ew.mean(axis=0)

    # ---- AU test ---------------------------------------------------------
    p_au = None
    if do_au and T > 1:
        nboot_au = max(nboot // 10, 1000)
        bp_scale = np.zeros((len(AU_SCALES), T))
        for si, r in enumerate(AU_SCALES):
            nr = max(int(round(n * r)), 1)
            Wr = rng.multinomial(nr, probs,
                                 size=nboot_au).astype(np.float64)
            Sr = Wr @ L.T
            winr = Sr.argmax(axis=1)
            bp_scale[si] = np.bincount(winr, minlength=T) / nboot_au
        p_au = _au_fit(bp_scale, AU_SCALES, nboot_au)
    return TreeTestResult(logL=logL, deltaL=deltaL, bp_rell=bp,
                          p_kh=p_kh, p_sh=p_sh, p_wkh=p_wkh, p_wsh=p_wsh,
                          c_elw=c_elw, p_au=p_au)


def _au_fit(bp: np.ndarray, scales: np.ndarray, nboot: int) -> np.ndarray:
    """WLS/Newton fit of bp_k(r) = 1 - Phi(d*sqrt(r) + c/sqrt(r)) per tree;
    p_AU = 1 - Phi(d - c). Reference: performAUTest
    (main/treetesting.cpp:788), following Shimodaira (2002)."""
    K, T = bp.shape
    sq = np.sqrt(scales)
    p_au = np.zeros(T)
    eps = 1.0 / (2.0 * nboot)
    for t in range(T):
        y = np.clip(bp[:, t], eps, 1 - eps)
        # if the tree (almost) always/never wins, clamp
        if (bp[:, t] > 1 - 2 * eps).all():
            p_au[t] = 1.0
            continue
        if (bp[:, t] < 2 * eps).all():
            p_au[t] = 0.0
            continue
        z = -norm.ppf(y)                       # z_k = d sqrt(r) + c/sqrt(r)
        # WLS weights: var of z via delta method
        phi = norm.pdf(z)
        var = y * (1 - y) / (nboot * phi ** 2)
        wls = 1.0 / np.maximum(var, 1e-12)
        # design matrix [sqrt(r), 1/sqrt(r)]
        X = np.stack([sq, 1.0 / sq], axis=1)
        A = X.T @ (wls[:, None] * X)
        b = X.T @ (wls * z)
        try:
            dc = np.linalg.solve(A, b)
        except np.linalg.LinAlgError:
            dc = np.array([z.mean(), 0.0])
        d, c = dc
        p_au[t] = 1.0 - norm.cdf(d - c)
    return p_au


def format_treetest_table(res: TreeTestResult, alpha: float = 0.05) -> str:
    """The USER TREES section of the .iqtree report (reference analog:
    printTreeTestResults)."""
    lines = []
    lines.append(f"{'Tree':<6}{'logL':>14}{'deltaL':>12}{'bp-RELL':>9}"
                 f"{'p-KH':>8}{'p-SH':>8}{'p-WKH':>8}{'p-WSH':>8}"
                 f"{'c-ELW':>8}" + (f"{'p-AU':>8}" if res.p_au is not None
                                    else ""))
    T = len(res.logL)

    def mark(p):
        return "+" if p >= alpha else "-"

    for t in range(T):
        row = (f"{t + 1:<6}{res.logL[t]:>14.4f}{res.deltaL[t]:>12.4f}"
               f"{res.bp_rell[t]:>8.3f}{mark(res.bp_rell[t])}"
               f"{res.p_kh[t]:>7.3f}{mark(res.p_kh[t])}"
               f"{res.p_sh[t]:>7.3f}{mark(res.p_sh[t])}"
               f"{res.p_wkh[t]:>7.3f}{mark(res.p_wkh[t])}"
               f"{res.p_wsh[t]:>7.3f}{mark(res.p_wsh[t])}"
               f"{res.c_elw[t]:>7.3f}{mark(res.c_elw[t])}")
        if res.p_au is not None:
            row += f"{res.p_au[t]:>7.3f}{mark(res.p_au[t])}"
        lines.append(row)
    lines.append("")
    lines.append("deltaL  : logL difference from the maximal logl in the set.")
    lines.append("bp-RELL : bootstrap proportion using RELL method.")
    lines.append("p-KH    : p-value of one sided Kishino-Hasegawa test.")
    lines.append("p-SH    : p-value of Shimodaira-Hasegawa test.")
    lines.append("p-WKH/p-WSH : weighted KH/SH tests.")
    lines.append("c-ELW   : Expected Likelihood Weight.")
    if res.p_au is not None:
        lines.append("p-AU    : p-value of approximately unbiased (AU) test.")
    lines.append(f"Plus signs denote the 95% confidence sets "
                 f"(alpha = {alpha}).")
    return "\n".join(lines)


def run_tree_tests(eng, trees, params, log=print):
    """Optimize branch lengths of each user tree under the fitted model,
    collect per-pattern logLs, run the test battery. Returns
    (TreeTestResult, [optimized trees])."""
    site_lps = []
    opt_trees = []
    for i, t in enumerate(trees):
        tt = t.copy()
        logL = eng.optimize_branches(tt, n_rounds=8)
        _, lp = eng.site_lp(tt)
        site_lps.append(lp)
        opt_trees.append(tt)
        log(f"Tree {i + 1}: logL {logL:.4f}")
    L = np.stack(site_lps)
    rng = np.random.default_rng(params.seed ^ 0xA0)
    res = evaluate_trees(L, eng.aln.pattern_weights,
                         nboot=max(params.topo_test_replicates, 1000),
                         rng=rng, do_au=params.do_au_test)
    return res, opt_trees
