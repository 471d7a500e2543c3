"""Nonreversible DNA models: UNREST (12 free rates) and the Lie-Markov
family's nonreversible members by constraint strings.

Reference analogs: ModelUnrest/ModelNonRev (model/modelunrest.cpp) — Q has
independent off-diagonal entries; stationary frequencies are the left null
vector of Q (not free parameters); likelihood uses the nonreversible device
path (pack["Q"] -> scaling-and-squaring expm, ops/pruning.py).

Copied from iqtree2_tpu/model/nonrev.py: the port keeps its own host
modules and imports nothing of the JAX package. get_eigensystem keeps the
JAX package's real parts of a complex eigensystem (ROADMAP C18), which no
likelihood reads: the passes, the branch Newton and NNI scoring take
pack["Q"], and ops/distances.ml_distances maximises under expm(Q t).
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.model.subst import (Eigensystem, SubstModel,
                                           eigen_general)


def stationary_of(Q: np.ndarray) -> np.ndarray:
    """Left null vector of Q (pi Q = 0, pi >= 0, sum 1)."""
    S = Q.shape[0]
    A = np.vstack([Q.T, np.ones((1, S))])
    b = np.zeros(S + 1)
    b[-1] = 1.0
    pi, *_ = np.linalg.lstsq(A, b, rcond=None)
    pi = np.maximum(pi, 1e-12)
    return pi / pi.sum()


class UnrestModel(SubstModel):
    """UNREST: all 12 off-diagonal DNA rates free (last fixed to 1).

    Rate order: row-major off-diagonals (A>C, A>G, A>T, C>A, C>G, C>T,
    G>A, G>C, G>T, T>A, T>C, T>G); reference: model/modelunrest.cpp.
    """

    def __init__(self, num_states: int = 4, rates=None, name: str = "UNREST"):
        self.num_states = num_states
        self.name = name
        n_off = num_states * (num_states - 1)
        self.rates = (np.asarray(rates, np.float64) if rates is not None
                      else np.ones(n_off))
        self.freq_type = "model"

    def is_reversible(self) -> bool:
        return False

    def _build_q(self) -> tuple[np.ndarray, np.ndarray]:
        S = self.num_states
        Q = np.zeros((S, S))
        k = 0
        for i in range(S):
            for j in range(S):
                if i == j:
                    continue
                Q[i, j] = self.rates[k]
                k += 1
        np.fill_diagonal(Q, -Q.sum(axis=1))
        pi = stationary_of(Q)
        mu = -(pi * np.diag(Q)).sum()
        return Q / mu, pi

    @property
    def freqs(self) -> np.ndarray:
        return self._build_q()[1]

    def get_eigensystem(self) -> Eigensystem:
        Q, pi = self._build_q()
        w, U, V = eigen_general(Q)
        return Eigensystem(eigvals=np.real(w)[None], U=np.real(U)[None],
                           V=np.real(V)[None], freqs=pi[None],
                           mix_weights=np.ones(1), Q=Q[None])

    # ------------------------------------------------------------ params
    def get_params(self) -> np.ndarray:
        return self.rates[:-1] / self.rates[-1]

    def set_params(self, x: np.ndarray) -> None:
        self.rates = np.concatenate([np.asarray(x, np.float64), [1.0]])

    def param_bounds(self):
        n = len(self.get_params())
        return np.full(n, 1e-4), np.full(n, 100.0)

    def num_free_params(self) -> int:
        return len(self.rates) - 1
