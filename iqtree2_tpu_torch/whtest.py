"""Weiss & von Haeseler (2003) test of model homogeneity (WH-test).

Copied from iqtree2_tpu/whtest.py: the port keeps its own host modules and
imports nothing of the JAX package. run_whtest takes the fitted model and
rates themselves, where the JAX package's takes an engine only to read
them; the arithmetic is host numpy/scipy, as there.

Reference analog: the vendored whtest library (whtest/whtest.h:25, run for
-m WHTEST from main/phyloanalysis.cpp:2815). Idea: estimate an
instantaneous rate matrix Q independently from EVERY sequence pair (via
the matrix logarithm of the pair's divergence matrix); under a single
homogeneous reversible model all pair estimates agree up to sampling
noise. The statistic is the between-pair sum of squares of the 12
off-diagonal Q entries (weisslambda_sub.c ComputeWeissLambdaQ16 /
Compute_SSbetween_Matrix); its null distribution is obtained by
parametric simulation under the fitted single model, p = fraction of
simulated statistics >= observed.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import logm

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.simulator import simulate_alignment
from iqtree2_tpu_torch.symtest import divergence_matrix


def pair_q_estimate(N: np.ndarray) -> np.ndarray | None:
    """Off-diagonal entries [12] of the pairwise rate-matrix estimate
    Q = logm(P-hat), P-hat = row-normalized symmetrized divergence counts;
    None when the estimate is invalid (non-real log / too divergent)."""
    S = N.shape[0]
    F = (N + N.T) / 2.0
    tot = F.sum()
    if tot <= 0:
        return None
    rows = F.sum(axis=1, keepdims=True)
    if (rows <= 0).any():
        return None
    P = F / rows
    # regularize: P must be close enough to I for a real logarithm
    try:
        Q = logm(P)
    except (ValueError, np.linalg.LinAlgError):
        return None
    if np.iscomplexobj(Q):
        if np.abs(Q.imag).max() > 1e-8:
            return None
        Q = Q.real
    off = Q[~np.eye(S, dtype=bool)]
    if not np.isfinite(off).all():
        return None
    # normalize out the pair-specific time/rate factor (WH compares the
    # matrix SHAPE across pairs)
    mu = off.sum()
    if mu <= 1e-12:
        return None
    return off / mu


def wh_statistic(aln: Alignment) -> float | None:
    """Between-pair sum of squares of the normalized Q estimates."""
    L = aln.ntaxa
    qs = []
    for i in range(L):
        for j in range(i + 1, L):
            q = pair_q_estimate(divergence_matrix(aln, i, j))
            if q is not None:
                qs.append(q)
    if len(qs) < 2:
        return None
    Qm = np.stack(qs)
    mean = Qm.mean(axis=0)
    return float(((Qm - mean) ** 2).sum())


def run_whtest(aln: Alignment, tree, model, rates, n_sim: int = 100,
               seed: int = 1, log=lambda s: None) -> dict:
    """WH-test p-value by parametric simulation on the fitted tree under
    the fitted single model (model, rates), the homogeneous strawman."""
    obs = wh_statistic(aln)
    if obs is None:
        return {"statistic": None, "p_value": None,
                "note": "too few valid pairs"}
    rng = np.random.default_rng(seed ^ 0x3117)
    n_ge = 0
    n_ok = 0
    for b in range(n_sim):
        seqs = simulate_alignment(tree, model, rates, aln.nsites, rng)
        sim = Alignment.from_sequences(
            list(seqs.keys()), list(seqs.values()), seqtype=aln.seqtype)
        s = wh_statistic(sim)
        if s is None:
            continue
        n_ok += 1
        if s >= obs:
            n_ge += 1
    p = (n_ge + 1) / (n_ok + 1) if n_ok else None
    log(f"WH-test: statistic {obs:.6g}, p = {p} "
        f"({n_ok} valid simulations)")
    return {"statistic": obs, "p_value": p, "n_sim": n_ok}
