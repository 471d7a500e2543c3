"""Sequencing-error models (+E / +EA / +EC / +EG / +ET).

A wrapper around any DNA substitution model: the rate matrix is untouched;
only the TIP likelihood vectors change — an observed state may be a
sequencing error. Uniform model (Felsenstein 2004) with k observed states:
  observed state likelihood   = 1 - (4-k) * eps / 3
  unobserved state likelihood = k * eps / 3
Base-specific variants (+EA..+ET, Nicola De Maio): errors only toward
base b. Reference: ModelDNAError::computeTipLikelihood
(model/modeldnaerror.cpp:89-145); epsilon optimizable in [1e-4, 0.5]
unless pinned with +E{eps}.

Copied from iqtree2_tpu/model/seqerror.py: the port keeps its own host
modules and imports nothing of the JAX package. The joint fit declines
the model (model/torchfit.build_spec), so epsilon is fitted by the host
alternation, whose float64 view rebuilds its tips as epsilon moves
(LikelihoodEngine.refresh_model).
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.model.subst import SubstModel

MIN_EPS, MAX_EPS = 1e-4, 0.5


class DNAErrorModel(SubstModel):
    """Delegating wrapper adding the error parameter epsilon."""

    def __init__(self, inner: SubstModel, epsilon: float = 0.05,
                 fix_epsilon: bool = False, error_base: int = -1):
        self.inner = inner
        self.epsilon = float(epsilon)
        self.fix_epsilon = fix_epsilon
        self.error_base = error_base        # -1 uniform; 0..3 = A,C,G,T
        self.num_states = inner.num_states
        suffix = "+E" if error_base < 0 else "+E" + "ACGT"[error_base]
        self.name = getattr(inner, "name", "DNA") + suffix
        self.freq_type = getattr(inner, "freq_type", "empirical")

    # ------------------------------------------------------- delegation
    def get_eigensystem(self):
        return self.inner.get_eigensystem()

    def is_reversible(self) -> bool:
        return self.inner.is_reversible()

    @property
    def freqs(self):
        return self.inner.freqs

    # -------------------------------------------------------- parameters
    def get_params(self) -> np.ndarray:
        p = self.inner.get_params()
        if self.fix_epsilon:
            return p
        return np.concatenate([p, [self.epsilon]])

    def set_params(self, x: np.ndarray) -> None:
        if self.fix_epsilon:
            self.inner.set_params(x)
            return
        self.inner.set_params(x[:-1])
        self.epsilon = float(np.clip(x[-1], MIN_EPS, MAX_EPS))

    def param_bounds(self):
        lo, hi = self.inner.param_bounds()
        if self.fix_epsilon:
            return lo, hi
        return (np.concatenate([lo, [MIN_EPS]]),
                np.concatenate([hi, [MAX_EPS]]))

    def num_free_params(self) -> int:
        return self.inner.num_free_params() + (0 if self.fix_epsilon
                                               else 1)

    # --------------------------------------------------------- tip table
    def transform_tip_table(self, table: np.ndarray) -> np.ndarray:
        """Apply the error model to indicator tip rows [codes, S]."""
        eps = self.epsilon
        if eps <= 0:
            return table
        S = table.shape[1]
        obs = table > 0
        k = obs.sum(axis=1, keepdims=True).astype(float)
        out = np.empty_like(table, dtype=np.float64)
        if self.error_base < 0:
            o_lk = 1.0 - (S - k) * eps / (S - 1.0)
            u_lk = k * eps / (S - 1.0)
            out = np.where(obs, o_lk, u_lk)
        else:
            has_b = obs[:, self.error_base: self.error_base + 1]
            o_lk = np.where(has_b, 1.0, 1.0 - eps)
            u_lk = np.where(has_b, eps, 0.0)
            out = np.where(obs, o_lk, u_lk)
        return out
