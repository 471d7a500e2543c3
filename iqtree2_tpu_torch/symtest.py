"""Matched-pairs tests of symmetry / marginal symmetry / internal symmetry.

Reference analog: doSymTest (main/phyloanalysis.cpp:3920, SymTestResult in
alignment/alignment.h; Naser-Khdour et al. 2019). For every sequence pair
the divergence matrix n_ij is tested with:
  - Bowker's test of symmetry:        S = sum_{i<j} (n_ij-n_ji)^2/(n_ij+n_ji)
  - Stuart's test of marginal symmetry (quadratic form of row-col margins)
  - internal symmetry = Bowker - Stuart (chi-square differences)
The per-alignment summary uses the maximum-divergence pair (the
reference's default SYNTEST_MAXDIV), and partitions failing at alpha can
be flagged (--symtest-remove-bad analog left to the caller).

Copied from iqtree2_tpu/symtest.py (host numpy and scipy): the port
keeps its own host modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.stats import chi2

from iqtree2_tpu_torch.data.alignment import Alignment


@dataclasses.dataclass
class SymTestResult:
    pair: tuple[int, int]
    bowker: float
    df_bowker: int
    p_bowker: float
    stuart: float
    df_stuart: int
    p_stuart: float
    internal: float
    df_internal: int
    p_internal: float


def divergence_matrix(aln: Alignment, i: int, j: int) -> np.ndarray:
    """[S, S] counts of (state_i, state_j) over definite-state sites."""
    S = aln.num_states
    codes = aln.tip_codes()
    tbl = aln.seqtype.tip_table
    definite = tbl.sum(1) == 1.0
    state_of = tbl.argmax(1)
    ci, cj = codes[i], codes[j]
    ok = definite[ci] & definite[cj]
    w = aln.pattern_weights
    N = np.zeros((S, S))
    np.add.at(N, (state_of[ci[ok]], state_of[cj[ok]]), w[ok])
    return N


def pair_symtest(N: np.ndarray, pair=(0, 1)) -> SymTestResult:
    S = N.shape[0]
    iu = np.triu_indices(S, 1)
    num = (N[iu] - N.T[iu]) ** 2
    den = N[iu] + N.T[iu]
    mask = den > 0
    bowker = float((num[mask] / den[mask]).sum())
    dfb = int(mask.sum())
    pb = float(chi2.sf(bowker, dfb)) if dfb > 0 else 1.0

    # Stuart: d = row margins - column margins (first S-1), covariance V
    d = (N.sum(1) - N.sum(0))[: S - 1]
    V = np.zeros((S - 1, S - 1))
    for a in range(S - 1):
        for b in range(S - 1):
            if a == b:
                V[a, b] = N[a].sum() + N[:, a].sum() - 2 * N[a, a]
            else:
                V[a, b] = -(N[a, b] + N[b, a])
    try:
        stuart = float(d @ np.linalg.solve(V, d))
        dfs = S - 1
        ps = float(chi2.sf(stuart, dfs))
    except np.linalg.LinAlgError:
        stuart, dfs, ps = np.nan, S - 1, np.nan
    internal = bowker - stuart if np.isfinite(stuart) else np.nan
    dfi = max(dfb - (S - 1), 1)
    pi = float(chi2.sf(internal, dfi)) if np.isfinite(internal) else np.nan
    return SymTestResult(pair, bowker, dfb, pb, stuart, dfs, ps,
                         internal, dfi, pi)


def run_symtest(aln: Alignment, mode: str = "maxdiv") -> SymTestResult:
    """Symmetry test on the maximum-divergence sequence pair (the
    reference default)."""
    L = aln.ntaxa
    best, best_div = (0, 1), -1.0
    for i in range(L):
        for j in range(i + 1, L):
            N = divergence_matrix(aln, i, j)
            tot = N.sum()
            div = (tot - np.trace(N)) / max(tot, 1.0)
            if div > best_div:
                best_div, best = div, (i, j)
    return pair_symtest(divergence_matrix(aln, *best), pair=best)


def write_symtest_csv(path: str, results: list[tuple[str, SymTestResult]]
                      ) -> None:
    with open(path, "w") as f:
        f.write("Name,SymSig,SymNon,SymPval,MarSig,MarPval,IntSig,"
                "IntPval\n")
        for name, r in results:
            f.write(f"{name},{r.bowker:.4f},{r.df_bowker},{r.p_bowker:.5g},"
                    f"{r.stuart:.4f},{r.p_stuart:.5g},"
                    f"{r.internal:.4f},{r.p_internal:.5g}\n")
