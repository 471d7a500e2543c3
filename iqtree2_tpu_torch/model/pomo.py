"""PoMo: polymorphism-aware phylogenetic model.

State space = 4 fixed allele states + one frequency ladder per unordered
allele pair: num_states = 4 + 6*(N-1) (N = virtual population size,
default 9 => 52 states; reference assert at model/modelpomo.cpp:177).

Dynamics (neutral Moran with boundary mutation, as in the reference):
  fixed i --(mutation i->j at theta * rho_ij * pi_j)--> {(N-1) i, 1 j}
  {k i, (N-k) j} --(drift at rate k(N-k)/N)--> k+1 or k-1 (absorbing into
  the fixed states at the ladder ends)
Tip likelihoods: a sampled read of base x from a population in state
{k i, (N-k) j} has probability k/N (x=i) / (N-k)/N (x=j) — the reference's
"sampled" input method. Stationary frequencies solve pi Q = 0 numerically.

Reference: ModelPoMo (model/modelpomo.h:40, modelpomo.cpp); branch-length
rescaling convention noted at main/phyloanalysis.cpp:4183.

The engine consumes PoMo through the generic nonreversible path (Q +
scaling-and-squaring expm on device), so no extra kernel code is needed.

Copied from iqtree2_tpu/model/pomo.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.model.subst import Eigensystem, SubstModel

PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


class PoMoModel(SubstModel):
    def __init__(self, N: int = 9, exch=None, freqs=None,
                 theta: float = 0.01, fix_theta: bool = False):
        self.N = int(N)
        self.num_states = 4 + 6 * (self.N - 1)
        self.exch = (np.ones(6) if exch is None
                     else np.asarray(exch, float))          # GTR order
        self.base_freqs = (np.full(4, 0.25) if freqs is None
                           else np.asarray(freqs, float))
        self.theta = float(theta)
        self.fix_theta = fix_theta
        self.name = f"PoMo{self.N}"
        self.freq_type = "estimate"

    # ----------------------------------------------------------- indexing
    def poly_index(self, pair_m: int, k: int) -> int:
        """State {k of allele i, N-k of allele j}, pair m=(i,j), k=1..N-1."""
        return 4 + pair_m * (self.N - 1) + (k - 1)

    # ------------------------------------------------------------ Q build
    def build_Q(self) -> np.ndarray:
        N, S = self.N, self.num_states
        Q = np.zeros((S, S))
        exch_m = np.zeros((4, 4))
        iu = np.triu_indices(4, 1)
        exch_m[iu] = self.exch
        exch_m += exch_m.T
        pi = self.base_freqs / self.base_freqs.sum()
        for m, (i, j) in enumerate(PAIRS):
            # boundary mutations off the fixed states
            Q[i, self.poly_index(m, N - 1)] += \
                self.theta * exch_m[i, j] * pi[j]
            Q[j, self.poly_index(m, 1)] += \
                self.theta * exch_m[i, j] * pi[i]
            # neutral Moran drift along the ladder
            for k in range(1, N):
                rate = k * (N - k) / N
                up = i if k + 1 == N else None
                s = self.poly_index(m, k)
                dst_up = i if k + 1 == N else self.poly_index(m, k + 1)
                dst_dn = j if k - 1 == 0 else self.poly_index(m, k - 1)
                Q[s, dst_up] += rate
                Q[s, dst_dn] += rate
        np.fill_diagonal(Q, 0.0)
        Q[np.arange(S), np.arange(S)] = -Q.sum(axis=1)
        return Q

    def stationary(self, Q: np.ndarray) -> np.ndarray:
        """pi Q = 0 via the null space of Q^T."""
        S = Q.shape[0]
        A = np.vstack([Q.T, np.ones((1, S))])
        b = np.zeros(S + 1)
        b[-1] = 1.0
        pi, *_ = np.linalg.lstsq(A, b, rcond=None)
        pi = np.maximum(pi, 1e-12)
        return pi / pi.sum()

    def get_eigensystem(self) -> Eigensystem:
        Q = self.build_Q()
        pi = self.stationary(Q)
        # normalize: mean substitution rate 1 (PoMo time is in Moran
        # events; the reference rescales branch bounds by N^2 instead —
        # normalizing Q keeps our branch-length conventions uniform)
        mu = float(-(pi * np.diag(Q)).sum())
        Q = Q / max(mu, 1e-12)
        return Eigensystem(
            eigvals=np.zeros((1, self.num_states)),
            U=np.zeros((1, self.num_states, self.num_states)),
            V=np.zeros((1, self.num_states, self.num_states)),
            W=None, freqs=pi[None, :],
            mix_weights=np.ones(1), Q=Q[None, :, :])

    def is_reversible(self) -> bool:
        return False   # consumed via the generic nonreversible path

    # ------------------------------------------------------- tip sampling
    def transform_tip_table(self, table_dna: np.ndarray) -> np.ndarray:
        """[dna_codes, 4] indicator rows -> [dna_codes, S'] sampled-read
        likelihoods (reference input method 'sampled')."""
        N = self.N
        ncodes = table_dna.shape[0]
        out = np.zeros((ncodes, self.num_states))
        out[:, :4] = table_dna
        for m, (i, j) in enumerate(PAIRS):
            for k in range(1, N):
                s = self.poly_index(m, k)
                out[:, s] = (table_dna[:, i] * k +
                             table_dna[:, j] * (N - k)) / N
        return out

    # -------------------------------------------------------- parameters
    def get_params(self) -> np.ndarray:
        p = list(self.exch[:5] / self.exch[5])
        if not self.fix_theta:
            p.append(self.theta)
        return np.asarray(p)

    def set_params(self, x: np.ndarray) -> None:
        self.exch = np.concatenate([x[:5], [1.0]])
        if not self.fix_theta:
            self.theta = float(np.clip(x[5], 1e-4, 1.0))

    def param_bounds(self):
        lo = [1e-4] * 5
        hi = [100.0] * 5
        if not self.fix_theta:
            lo.append(1e-4)
            hi.append(1.0)
        return np.asarray(lo), np.asarray(hi)

    def num_free_params(self) -> int:
        return 5 + (0 if self.fix_theta else 1)
