"""Pairwise distances for the BIONJ start tree (counterpart of
iqtree2_tpu/ops/distances.py).

The numpy helpers are copied (their module imports jax); the batched
Newton over all T = L(L-1)/2 pairs runs in torch on the given device (the
search passes the engine's), under a nonreversible model through expm(Q t)
(ROADMAP C18: the JAX package's runs on a real-part eigensystem).
Reference analogs: utils/hammingdistance.h, alignment/alignmentpairwise.cpp
(per-pair ML distance by 1-D Newton on the pair frequency table).
"""

from __future__ import annotations

import numpy as np
import torch

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.ops.pruning import expm_ss

MAX_DIST = 9.0  # reference: MAX_GENETIC_DIST


def pair_frequency_tables(aln: Alignment) -> tuple[np.ndarray, np.ndarray]:
    """[T, S, S] weighted co-occurrence counts over definite-state sites for
    every unordered pair, and the [T, 2] pair index list."""
    codes = aln.tip_codes()          # [L, P]
    tbl = aln.seqtype.tip_table
    S = aln.num_states
    L = aln.ntaxa
    definite = tbl.sum(1) == 1.0
    state_of = tbl.argmax(1)
    is_def = definite[codes]
    st = state_of[codes]
    w = aln.pattern_weights
    pairs = [(i, j) for i in range(L) for j in range(i + 1, L)]
    F = np.zeros((len(pairs), S, S), dtype=np.float64)
    for t, (i, j) in enumerate(pairs):
        ok = is_def[i] & is_def[j]
        np.add.at(F[t], (st[i][ok], st[j][ok]), w[ok])
    return F, np.asarray(pairs, dtype=np.int32)


def hamming_jc_distances(aln: Alignment) -> np.ndarray:
    """[L, L] JC-corrected observed distances (the Newton's start, and the
    BIONJ distances of a supermatrix: the partitions' averaged by their
    sites)."""
    if hasattr(aln, "partitions"):  # SuperAlignment
        w = np.array([p.nsites for p in aln.partitions], np.float64)
        Ds = [hamming_jc_distances(p) for p in aln.partitions]
        return np.tensordot(w / w.sum(), np.stack(Ds), axes=1)
    codes = aln.tip_codes()
    tbl = aln.seqtype.tip_table
    S = aln.num_states
    definite = tbl.sum(1) == 1.0
    state_of = tbl.argmax(1)
    is_def = definite[codes]
    st = np.where(is_def, state_of[codes], -1)
    w = aln.pattern_weights
    L = aln.ntaxa
    D = np.zeros((L, L))
    for i in range(L):
        ok = (st[i][None, :] >= 0) & (st >= 0)
        diff = ((st != st[i][None, :]) & ok) * w[None, :]
        tot = ok * w[None, :]
        with np.errstate(invalid="ignore", divide="ignore"):
            p = diff.sum(1) / np.maximum(tot.sum(1), 1e-9)
        k = (S - 1.0) / S
        p = np.minimum(p, k * 0.9999)
        D[i] = -k * np.log(1.0 - p / k)
    np.fill_diagonal(D, 0.0)
    return np.maximum(D, 0.0)


def _newton(F, t0, derivs, n_iter: int):
    """Batched 1-D Newton maximising sum_xy F log P_xy(t) for every pair,
    derivs(t) -> (P, dP/dt, d2P/dt2) [T, S, S]."""
    t = t0
    for _ in range(n_iter):
        P, P1, P2 = derivs(t)
        P = P.clamp(min=1e-12)
        r = P1 / P                                   # dP/dt / P
        d1 = (F * r).sum((1, 2))
        d2 = (F * (P2 / P - r * r)).sum((1, 2))
        step = torch.where(d2 < 0, -d1 / d2, torch.sign(d1) * 0.5 * t)
        t = (t + step).clamp(1e-6, MAX_DIST)
    return t


def ml_dist_newton(F, t0, lam, U, V, n_iter: int = 20):
    """The Newton of every pair under one reversible rate matrix: F [T, S,
    S]; t0 [T]; lam [S], U, V [S, S] its eigensystem."""
    def pt(w):
        return torch.einsum("xk,pk,ky->pxy", U, w, V)

    def derivs(t):
        e = torch.exp(lam * t[:, None])
        return pt(e), pt(e * lam), pt(e * lam * lam)
    return _newton(F, t0, derivs, n_iter)


def ml_dist_newton_q(F, t0, Q, n_iter: int = 20):
    """The Newton of every pair under a nonreversible rate matrix Q [S, S]:
    P = expm(Q t), dP/dt = Q P, d2P/dt2 = Q Q P. The JAX package runs
    ml_dist_newton on the real parts of Q's complex eigensystem instead
    (ROADMAP C18)."""
    def derivs(t):
        P = expm_ss(Q[None] * t[:, None, None])
        QP = torch.matmul(Q, P)
        return P, QP, torch.matmul(Q, QP)
    return _newton(F, t0, derivs, n_iter)


def ml_distances(aln: Alignment, model, dtype=torch.float64,
                 device="cuda") -> np.ndarray:
    """[L, L] ML pairwise distances under a single rate matrix, on the card
    unless ``device`` says otherwise (as the engine): through its
    eigensystem for a reversible model, through expm(Q t) for a
    nonreversible one (pack Q). Reference analog: computeMLDist
    (main/phyloanalysis.cpp:1932).

    Raises NotImplementedError for a mixture model, whose first
    eigensystem does not describe the whole model, and for a model whose
    states are not the alignment's (PoMo: the JAX package's distances fail
    there and its search takes the JC distances)."""
    eig = model.get_eigensystem()
    if eig.num_mixtures > 1:
        raise NotImplementedError("ML distances need one rate matrix")
    if model.num_states != aln.num_states:
        raise NotImplementedError("ML distances need the model's states to "
                                  "be the alignment's")
    F, pairs = pair_frequency_tables(aln)
    D0 = hamming_jc_distances(aln)
    t0 = np.maximum(D0[pairs[:, 0], pairs[:, 1]], 1e-4)
    kw = dict(dtype=dtype, device=device)
    F, t0 = torch.as_tensor(F, **kw), torch.as_tensor(t0, **kw)
    if eig.Q is not None:
        t = ml_dist_newton_q(F, t0, torch.as_tensor(np.asarray(eig.Q)[0],
                                                    **kw))
    else:
        t = ml_dist_newton(F, t0,
                           torch.as_tensor(np.asarray(eig.eigvals)[0], **kw),
                           torch.as_tensor(np.asarray(eig.U)[0], **kw),
                           torch.as_tensor(np.asarray(eig.V)[0], **kw))
    D = np.zeros((aln.ntaxa, aln.ntaxa))
    D[pairs[:, 0], pairs[:, 1]] = D[pairs[:, 1], pairs[:, 0]] = \
        t.double().cpu().numpy()
    return D
