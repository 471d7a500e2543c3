"""Substitution-model core: rate matrices, eigendecomposition, P(t).

Reference analogs: model/modelsubst.h (interface), model/modelmarkov.cpp
(reversible core: decomposeRateMatrixRev :1602 via the sqrt(pi) similarity
transform of utils/eigendecomposition.cpp:165; computeTransMatrix :504).

Design: model parameters and eigensystems are built on host in float64
numpy (cold path); the resulting (eigvals, U, V) arrays are shipped to the
device where per-edge transition tensors P(t) = U diag(e^{lambda r t}) V are
built in batch inside the jitted likelihood kernels (hot path).

Copied from iqtree2_tpu/model/subst.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Eigensystem:
    """Eigen-decomposition of a (possibly per-mixture-class) rate matrix.

    eigvals: [M, S] eigenvalues of Q (M mixture classes; 1 if no mixture)
    U:       [M, S, S] right eigenvectors (columns)  Q = U diag(l) V
    V:       [M, S, S] inverse eigenvectors
    freqs:   [M, S] stationary frequencies
    mix_weights: [M] mixture-class weights (sums to 1)
    """

    eigvals: np.ndarray
    U: np.ndarray
    V: np.ndarray
    freqs: np.ndarray
    mix_weights: np.ndarray
    # For reversible models: orthonormal eigenvectors W of the symmetrized
    # rate matrix B = D^{1/2} Q D^{-1/2} (None for nonreversible). Enables
    # the cancellation-free float32 transition form
    #   P(t) = D^{-1/2} (I + W diag(expm1(lambda t)) W^T) D^{1/2}.
    W: np.ndarray | None = None
    # For nonreversible models: the normalized rate matrices [M, S, S];
    # the device path then uses a scaling-and-squaring expm instead of the
    # eigenbasis (reference analog: tree/phylokernelnonrev.h).
    Q: np.ndarray | None = None

    @property
    def num_states(self) -> int:
        return self.eigvals.shape[-1]

    @property
    def num_mixtures(self) -> int:
        return self.eigvals.shape[0]


def build_gtr_rate_matrix(exch_rates: np.ndarray, freqs: np.ndarray,
                          normalize: bool = True) -> np.ndarray:
    """Q for a general time-reversible model.

    exch_rates: [S*(S-1)/2] upper-triangle exchangeabilities (row-major:
      for S=4 the order is AC,AG,AT,CG,CT,GT — reference order
      model/modelmarkov.cpp decomposeRateMatrixRev half_matrix loop).
    freqs: [S] stationary frequencies.
    Returns Q (rows sum to 0) normalized so -sum_i pi_i Q_ii = 1
    (reference: utils/eigendecomposition.cpp computeRateMatrix).
    """
    S = len(freqs)
    R = np.zeros((S, S), dtype=np.float64)
    iu = np.triu_indices(S, 1)
    R[iu] = exch_rates
    R = R + R.T
    Q = R * freqs[None, :]
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    if normalize:
        mu = -(freqs * np.diag(Q)).sum()
        if mu > 0:
            Q = Q / mu
    return Q


def eigen_reversible(Q: np.ndarray, freqs: np.ndarray):
    """Eigendecompose a reversible Q via the sqrt(pi) symmetrization.

    B = D^{1/2} Q D^{-1/2} is symmetric for reversible Q; B = W L W^T gives
    U = D^{-1/2} W and V = W^T D^{1/2} (reference math:
    utils/eigendecomposition.cpp:165 eigensystem_sym).
    Returns (eigvals [S], U [S,S], V [S,S]).
    """
    f = np.maximum(freqs, 1e-300)
    sq = np.sqrt(f)
    B = Q * (sq[:, None] / sq[None, :])
    B = 0.5 * (B + B.T)  # clean numeric asymmetry
    w, W = np.linalg.eigh(B)
    U = W / sq[:, None]
    V = W.T * sq[None, :]
    return w, U, V, W


def eigen_general(Q: np.ndarray):
    """Eigendecomposition for non-reversible Q (complex eigenvalues).

    Returns complex (eigvals, U, V). Reference analog:
    utils/eigendecomposition.cpp eigensystem_nonrev :319.
    """
    w, U = np.linalg.eig(Q)
    V = np.linalg.inv(U)
    return w, U, V


def transition_matrix(eig, t: float, mix: int = 0) -> np.ndarray:
    """P(t) on host (for tests/simulation; the device path batches this)."""
    lam = eig.eigvals[mix]
    U = eig.U[mix]
    V = eig.V[mix]
    P = (U * np.exp(lam * t)[None, :]) @ V
    return np.maximum(P, 0.0)


class SubstModel:
    """Base class for substitution models (host-side parameter objects).

    Subclasses define parameterization; all expose:
      num_states, name, get_eigensystem() -> Eigensystem,
      get_params()/set_params() flat optimizable vectors with bounds.
    """

    name: str = "?"
    num_states: int = 0
    freq_type: str = "estimate"  # equal | empirical | estimate | user

    def get_eigensystem(self) -> Eigensystem:
        raise NotImplementedError

    # --- optimizable parameter interface (exchangeabilities + freqs) -----
    def get_params(self) -> np.ndarray:
        return np.zeros(0)

    def set_params(self, x: np.ndarray) -> None:
        pass

    def param_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        x = self.get_params()
        return (np.full(x.shape, 1e-4), np.full(x.shape, 100.0))

    def num_free_params(self) -> int:
        return len(self.get_params())

    def is_reversible(self) -> bool:
        return True


class GTRModel(SubstModel):
    """General time-reversible model over any state space.

    Parameterization: exchangeabilities (last fixed to 1) + frequencies.
    Covers every named DNA model through equality constraints on rates
    (model/dna.py) and empirical protein matrices with fixed rates
    (model/protein.py).
    """

    def __init__(self, num_states: int, exch_rates=None, freqs=None,
                 freq_type: str = "estimate", name: str = "GTR",
                 rate_constraints: str | None = None,
                 fixed_rates: bool = False):
        self.num_states = num_states
        self.name = name
        nr = num_states * (num_states - 1) // 2
        self.exch_rates = (np.asarray(exch_rates, dtype=np.float64)
                           if exch_rates is not None else np.ones(nr))
        if freqs is None:
            freqs = np.full(num_states, 1.0 / num_states)
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.freq_type = freq_type
        self.fixed_rates = fixed_rates
        # rate_constraints: digit string like "010010"; same digit = same
        # parameter; digit 0 is the reference class fixed at relative rate 1
        self.rate_constraints = rate_constraints
        if rate_constraints is not None:
            assert len(rate_constraints) == nr
            classes = sorted(set(rate_constraints))
            self._class_of = np.array(
                [classes.index(c) for c in rate_constraints])
            self._nclasses = len(classes)
            # class containing the last rate (GT) is the fixed reference
            self._ref_class = self._class_of[-1]
        else:
            self._class_of = np.arange(nr)
            self._nclasses = nr
            self._ref_class = nr - 1

    # ------------------------------------------------------------ identity
    def is_reversible(self) -> bool:
        return True

    def get_eigensystem(self) -> Eigensystem:
        Q = build_gtr_rate_matrix(self.exch_rates, self.freqs)
        w, U, V, W = eigen_reversible(Q, self.freqs)
        return Eigensystem(eigvals=w[None], U=U[None], V=V[None],
                           freqs=self.freqs[None],
                           mix_weights=np.ones(1), W=W[None])

    # ------------------------------------------------- free rate parameters
    def free_rate_classes(self) -> list[int]:
        return [c for c in range(self._nclasses) if c != self._ref_class]

    def get_rate_params(self) -> np.ndarray:
        out = []
        for c in self.free_rate_classes():
            idx = int(np.nonzero(self._class_of == c)[0][0])
            out.append(self.exch_rates[idx])
        return np.asarray(out)

    def set_rate_params(self, x: np.ndarray) -> None:
        for val, c in zip(x, self.free_rate_classes()):
            self.exch_rates[self._class_of == c] = val
        self.exch_rates[self._class_of == self._ref_class] = 1.0

    def get_params(self) -> np.ndarray:
        parts = []
        if not self.fixed_rates:
            parts.append(self.get_rate_params())
        if self.freq_type == "estimate":
            parts.append(self.freqs[:-1] / self.freqs[-1])
        if not parts:
            return np.zeros(0)
        return np.concatenate(parts)

    def set_params(self, x: np.ndarray) -> None:
        i = 0
        if not self.fixed_rates:
            nr = len(self.free_rate_classes())
            self.set_rate_params(x[i:i + nr])
            i += nr
        if self.freq_type == "estimate":
            raw = np.concatenate([x[i:i + self.num_states - 1], [1.0]])
            self.freqs = raw / raw.sum()

    def param_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        n = len(self.get_params())
        lo = np.full(n, 1e-4)
        hi = np.full(n, 100.0)
        return lo, hi

    def num_free_params(self) -> int:
        n = 0
        if not self.fixed_rates:
            n += len(self.free_rate_classes())
        if self.freq_type in ("estimate", "empirical"):
            n += self.num_states - 1
        return n
