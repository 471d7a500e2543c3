"""Lie-Markov DNA models (37 models of Woodhams, Fernandez-Sanchez &
Sumner 2015) — the full family closed under matrix multiplication,
including nonreversible members.

Reference analog: ModelLieMarkov (model/modelliemarkov.cpp:60-330): each
model is a span of basis matrices {A, A2, B, C, D1, F1, F2, G1, G2, D, E1,
E2} (12-vectors over the off-diagonal rates in the symmetry's base order);
rate vector = A + norm * sum_i p_i B_i with p_i in [-0.98, 0.98] and norm
chosen so all off-diagonal rates stay nonnegative; a symmetry permutation
(RY / WS / MK pairing) maps to ACGT order. Q feeds the nonreversible device
path (expm) — reversible members work through it identically.

The basis 12-vectors are published constants from the paper.

Copied from iqtree2_tpu/model/liemarkov.py: the port keeps its own
host modules and imports nothing of the JAX package (the real-part
eigensystem of ROADMAP C18 as in model/nonrev.py).
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.model.nonrev import stationary_of
from iqtree2_tpu_torch.model.subst import (Eigensystem, SubstModel,
                                           eigen_general)

# off-diagonal rate order (unpermuted): 12 entries as in the reference
_BASIS = {
    "A":  [+1, +1, +1, +1, +1, +1, +1, +1, +1, +1, +1, +1],
    "A2": [+2, -1, -1, +2, -1, -1, -1, -1, +2, -1, -1, +2],
    "B":  [0, +1, -1, 0, -1, +1, +1, -1, 0, -1, +1, 0],
    "C":  [0, -1, +1, 0, +1, -1, +1, -1, 0, -1, +1, 0],
    "D1": [+1, 0, 0, +1, 0, 0, 0, 0, -1, 0, 0, -1],
    "D":  [+1, -1, -1, +1, -1, -1, +1, +1, -1, +1, +1, -1],
    "E1": [-1, 0, 0, +1, 0, 0, +1, -1, 0, +1, -1, 0],
    "E2": [0, +1, -1, 0, +1, -1, 0, 0, -1, 0, 0, +1],
    "F1": [-1, 0, 0, +1, 0, 0, -1, +1, 0, -1, +1, 0],
    "F2": [0, +1, -1, 0, +1, -1, 0, 0, +1, 0, 0, -1],
    "G1": [+1, -1, -1, -1, +1, +1, 0, 0, 0, 0, 0, 0],
    "G2": [0, 0, 0, 0, 0, 0, +1, +1, -1, -1, -1, +1],
}

# model -> basis matrix names (A first; D/E1/E2 are the frequency dof)
LM_MODELS = {
    "1.1":   ["A"],
    "2.2b":  ["A", "A2"],
    "3.3a":  ["A", "A2", "B"],
    "3.3b":  ["A", "A2", "C"],
    "3.3c":  ["A", "A2", "D1"],
    "3.4":   ["A", "A2", "D"],
    "4.4a":  ["A", "D", "E1", "E2"],
    "4.4b":  ["A", "A2", "D1", "D"],
    "4.5a":  ["A", "A2", "B", "D"],
    "4.5b":  ["A", "A2", "C", "D"],
    "5.6a":  ["A", "A2", "B", "C", "D1"],
    "5.6b":  ["A", "A2", "D", "E1", "E2"],
    "5.7a":  ["A", "A2", "B", "E1", "E2"],
    "5.7b":  ["A", "A2", "B", "F1", "F2"],
    "5.7c":  ["A", "A2", "B", "G1", "G2"],
    "5.11a": ["A", "A2", "D1", "E1", "E2"],
    "5.11b": ["A", "A2", "D1", "F1", "F2"],
    "5.11c": ["A", "A2", "D1", "G1", "G2"],
    "5.16":  ["A", "A2", "G1", "G2", "D"],
    "6.6":   ["A", "A2", "B", "C", "D1", "D"],
    "6.7a":  ["A", "A2", "B", "D", "E1", "E2"],
    "6.7b":  ["A", "A2", "C", "D", "E1", "E2"],
    "6.8a":  ["A", "A2", "D1", "D", "E1", "E2"],
    "6.8b":  ["A", "A2", "D1", "G1", "G2", "D"],
    "6.17a": ["A", "A2", "B", "G1", "G2", "D"],
    "6.17b": ["A", "A2", "C", "G1", "G2", "D"],
    "8.8":   ["A", "A2", "D1", "F1", "F2", "D", "E1", "E2"],
    "8.10a": ["A", "A2", "B", "C", "D1", "D", "E1", "E2"],
    "8.10b": ["A", "A2", "B", "C", "D1", "G1", "G2", "D"],
    "8.16":  ["A", "A2", "D1", "G1", "G2", "D", "E1", "E2"],
    "8.17":  ["A", "A2", "B", "G1", "G2", "D", "E1", "E2"],
    "8.18":  ["A", "A2", "B", "F1", "F2", "D", "E1", "E2"],
    "9.20a": ["A", "A2", "B", "C", "D1", "F1", "F2", "E1", "E2"],
    "9.20b": ["A", "A2", "B", "C", "D1", "F1", "F2", "G1", "G2"],
    "10.12": ["A", "A2", "B", "C", "D1", "F1", "F2", "D", "E1", "E2"],
    "10.34": ["A", "A2", "B", "C", "D1", "G1", "G2", "D", "E1", "E2"],
    "12.12": ["A", "A2", "B", "C", "D1", "F1", "F2", "G1", "G2", "D",
              "E1", "E2"],
}

# models where RY/WS/MK pairings are isomorphic (no symmetry prefix needed)
FULL_SYMMETRY = {"1.1", "3.3a", "4.4a", "6.7a", "9.20b", "12.12"}

# permutation of the unpermuted rate order into ACGT row-major off-diagonals
_SYM_PERM = {
    "RY": [1, 0, 2, 6, 7, 8, 3, 4, 5, 9, 11, 10],
    "WS": [1, 2, 0, 6, 8, 7, 9, 11, 10, 3, 4, 5],
    "MK": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
}

MIN_LIE_WEIGHT = -0.98
MAX_LIE_WEIGHT = 0.98


def is_lie_markov_name(name: str) -> bool:
    return _parse_name(name) is not None


def _parse_name(name: str):
    up = name.upper()
    if up in ("STRSYM",):
        return ("WS", "6.6")
    sym = "RY"
    body = name
    for s in ("RY", "WS", "MK"):
        if up.startswith(s):
            sym = s
            body = name[2:]
            break
    body = body.lower()
    if body in LM_MODELS:
        return (sym, body)
    return None


class LieMarkovModel(SubstModel):
    """One of the 37 Lie-Markov models (optionally nonreversible)."""

    def __init__(self, name: str, params=None):
        parsed = _parse_name(name)
        if parsed is None:
            raise ValueError(f"unknown Lie-Markov model {name!r}")
        self.symmetry, self.model_key = parsed
        self.num_states = 4
        self.name = (self.model_key if self.model_key in FULL_SYMMETRY
                     else f"{self.symmetry}{self.model_key}")
        self.basis_names = LM_MODELS[self.model_key]
        n = len(self.basis_names) - 1
        self.params = (np.asarray(params, np.float64) if params is not None
                       else np.zeros(n))
        assert len(self.params) == n
        self.freq_type = "model"

    def is_reversible(self) -> bool:
        return False  # treated uniformly through the expm path

    def _rates12(self) -> np.ndarray:
        """Reference setRates (model/modelliemarkov.cpp:1194): rate vector =
        A + norm * sum p_i B_i, norm keeping all rates nonnegative."""
        A = np.asarray(_BASIS["A"], np.float64)
        acc = np.zeros(12)
        max_abs = 0.0
        for p, bn in zip(self.params, self.basis_names[1:]):
            max_abs = max(max_abs, abs(p))
            acc += p * np.asarray(_BASIS[bn], np.float64)
        if max_abs == 0:
            rates = A.copy()
        else:
            ratio = acc / A
            norm = -max_abs / ratio.min() if ratio.min() < 0 else \
                (max_abs / max(ratio.max(), 1e-12))
            # reference: norm = -max_abs/min(ratio) (min is negative for any
            # nontrivial parameter vector); guard the all-positive corner
            if ratio.min() < 0:
                norm = -max_abs / ratio.min()
            rates = A + norm * acc
        perm = _SYM_PERM[self.symmetry]
        return rates[perm]

    def _build_q(self):
        r12 = np.maximum(self._rates12(), 0.0)
        Q = np.zeros((4, 4))
        k = 0
        for i in range(4):
            for j in range(4):
                if i == j:
                    continue
                Q[i, j] = r12[k]
                k += 1
        np.fill_diagonal(Q, -Q.sum(axis=1))
        pi = stationary_of(Q)
        mu = -(pi * np.diag(Q)).sum()
        if mu <= 0:
            mu = 1.0
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

    def get_params(self) -> np.ndarray:
        return self.params.copy()

    def set_params(self, x: np.ndarray) -> None:
        self.params = np.clip(np.asarray(x, np.float64),
                              MIN_LIE_WEIGHT, MAX_LIE_WEIGHT)

    def param_bounds(self):
        n = len(self.params)
        return (np.full(n, MIN_LIE_WEIGHT), np.full(n, MAX_LIE_WEIGHT))

    def num_free_params(self) -> int:
        return len(self.params)
