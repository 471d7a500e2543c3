"""Rate-heterogeneity models: +G (discrete Gamma), +I, +I+G, +R (FreeRate).

Reference analogs: model/rategamma.cpp (computeRates :98 — Yang-1994 mean or
median discretization), model/rategammainvar.cpp (gamma rates scaled by
1/(1-p_inv) so the total mean rate stays 1), model/ratefree.cpp.

Interface to the kernels: category_rates() [C], category_weights() [C]
(weights already folded with (1-p_invar)), and p_invar handled separately by
adding the invariant-site likelihood outside the scaled partials
(reference contract: tree/phylokernelnew.h:3295, SURVEY A13).

Copied from iqtree2_tpu/model/rates.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaincinv, gammainc


class RateModel:
    """Base: no heterogeneity (single category, rate 1)."""

    name = ""

    @property
    def ncat(self) -> int:
        return 1

    @property
    def p_invar(self) -> float:
        return 0.0

    def category_rates(self) -> np.ndarray:
        return np.ones(1)

    def category_weights(self) -> np.ndarray:
        return np.ones(1)

    # optimizable parameters (host Brent/BFGS loops)
    def get_params(self) -> np.ndarray:
        return np.zeros(0)

    def set_params(self, x: np.ndarray) -> None:
        pass

    def param_bounds(self):
        x = self.get_params()
        return np.full(x.shape, 1e-4), np.full(x.shape, 100.0)

    def num_free_params(self) -> int:
        return len(self.get_params())


def discrete_gamma_rates(alpha: float, ncat: int,
                         median: bool = False) -> np.ndarray:
    """Discrete Gamma category rates with mean 1.

    Mean-of-bin method (default, Yang 1994): bin boundaries at quantiles
    i/K of Gamma(alpha, mean 1); category rate = conditional mean
    K*(I(a+1, a*b_{i+1}) - I(a+1, a*b_i)). Median method: quantiles at
    (2i+1)/(2K), rescaled to mean 1 (reference: model/rategamma.cpp:98-131).
    """
    a = float(alpha)
    if ncat == 1:
        return np.ones(1)
    if median:
        probs = (2.0 * np.arange(ncat) + 1.0) / (2.0 * ncat)
        r = gammaincinv(a, probs) / a
        return r * ncat / r.sum()
    # boundaries b_0=0 < b_1 < ... < b_K = inf in mean-1 parameterization
    edges = gammaincinv(a, np.arange(1, ncat) / ncat) / a
    cum = gammainc(a + 1.0, a * edges)  # I(a+1, a*b) at interior edges
    cum = np.concatenate([[0.0], cum, [1.0]])
    return np.diff(cum) * ncat


class RateGamma(RateModel):
    def __init__(self, ncat: int = 4, alpha: float = 1.0,
                 median: bool = False, p_invar: float = 0.0,
                 invar_free: bool = True, alpha_free: bool = True,
                 fix_alpha: bool = False):
        self._ncat = ncat
        self.alpha = alpha
        self.median = median
        self._p_invar = p_invar
        self.has_invar = p_invar > 0 or invar_free is None
        self.alpha_free = alpha_free
        self.invar_free = invar_free
        # "+G{0.6}" pins alpha (reference: brace params fix the value,
        # model/modelfactory.cpp:151 grammar)
        self.fix_alpha = fix_alpha
        self.name = f"+G{ncat}"

    @property
    def ncat(self) -> int:
        return self._ncat

    @property
    def p_invar(self) -> float:
        return self._p_invar

    def category_rates(self) -> np.ndarray:
        r = discrete_gamma_rates(self.alpha, self._ncat, self.median)
        if self._p_invar > 0:
            r = r / (1.0 - self._p_invar)
        return r

    def category_weights(self) -> np.ndarray:
        return np.full(self._ncat, (1.0 - self._p_invar) / self._ncat)

    def get_params(self) -> np.ndarray:
        if self.fix_alpha:
            return np.zeros(0)
        return np.array([self.alpha])

    def set_params(self, x: np.ndarray) -> None:
        if not self.fix_alpha:
            self.alpha = float(x[0])

    def param_bounds(self):
        # reference MIN_GAMMA_SHAPE=0.02, MAX_GAMMA_SHAPE=1000
        if self.fix_alpha:
            return np.zeros(0), np.zeros(0)
        return np.array([0.02]), np.array([100.0])


class RateInvar(RateModel):
    def __init__(self, p_invar: float = 0.1, fix_pinv: bool = False):
        self._p_invar = p_invar
        self.fix_pinv = fix_pinv
        self.name = "+I"

    @property
    def p_invar(self) -> float:
        return self._p_invar

    @p_invar.setter
    def p_invar(self, v: float) -> None:
        self._p_invar = v

    def category_rates(self) -> np.ndarray:
        return np.ones(1) / max(1.0 - self._p_invar, 1e-10)

    def category_weights(self) -> np.ndarray:
        return np.array([1.0 - self._p_invar])

    def get_params(self) -> np.ndarray:
        if self.fix_pinv:
            return np.zeros(0)
        return np.array([self._p_invar])

    def set_params(self, x: np.ndarray) -> None:
        if not self.fix_pinv:
            self._p_invar = float(x[0])

    def param_bounds(self):
        if self.fix_pinv:
            return np.zeros(0), np.zeros(0)
        return np.array([1e-6]), np.array([0.9999])


class RateGammaInvar(RateGamma):
    def __init__(self, ncat: int = 4, alpha: float = 1.0,
                 p_invar: float = 0.1, median: bool = False,
                 fix_alpha: bool = False, fix_pinv: bool = False):
        super().__init__(ncat, alpha, median, p_invar, fix_alpha=fix_alpha)
        self.fix_pinv = fix_pinv
        self.name = f"+I+G{ncat}"

    @RateGamma.p_invar.getter
    def p_invar(self) -> float:
        return self._p_invar

    def set_p_invar(self, v: float) -> None:
        self._p_invar = v

    def get_params(self) -> np.ndarray:
        out = []
        if not self.fix_alpha:
            out.append(self.alpha)
        if not self.fix_pinv:
            out.append(self._p_invar)
        return np.array(out)

    def set_params(self, x: np.ndarray) -> None:
        i = 0
        if not self.fix_alpha:
            self.alpha = float(x[i])
            i += 1
        if not self.fix_pinv:
            self._p_invar = float(x[i])

    def param_bounds(self):
        lo, hi = [], []
        if not self.fix_alpha:
            lo.append(0.02)
            hi.append(100.0)
        if not self.fix_pinv:
            lo.append(1e-6)
            hi.append(0.9999)
        return np.array(lo), np.array(hi)


class RateFree(RateModel):
    """+R{k}: free category rates and weights, normalized mean rate 1.

    Reference: model/ratefree.cpp (optimized by EM :504 or BFGS).
    """

    def __init__(self, ncat: int = 4, rates=None, weights=None,
                 p_invar: float = 0.0, fix_rates: bool = False):
        self._ncat = ncat
        if rates is None:
            # reference init: gamma-like spread
            rates = discrete_gamma_rates(1.0, ncat)
        if weights is None:
            weights = np.full(ncat, 1.0 / ncat)
        self.rates = np.asarray(rates, dtype=np.float64)
        self.weights = np.asarray(weights, dtype=np.float64)
        self._p_invar = p_invar
        # "+R4{w1,r1,...}" pins rates and weights
        self.fix_rates = fix_rates
        self.normalize()
        self.name = f"+R{ncat}"

    @property
    def ncat(self) -> int:
        return self._ncat

    @property
    def p_invar(self) -> float:
        return self._p_invar

    def normalize(self) -> None:
        self.weights = np.maximum(self.weights, 1e-10)
        self.weights = self.weights / self.weights.sum()
        mean = (self.rates * self.weights).sum()
        if mean > 0:
            self.rates = self.rates / mean

    def category_rates(self) -> np.ndarray:
        r = self.rates
        if self._p_invar > 0:
            r = r / (1.0 - self._p_invar)
        return r

    def category_weights(self) -> np.ndarray:
        return self.weights * (1.0 - self._p_invar)

    def get_params(self) -> np.ndarray:
        # parameterize as (rates[1:]/rates[0] increments, weight logits[1:])
        if self.fix_rates:
            return np.zeros(0)
        return np.concatenate([self.rates, self.weights[:-1]])

    def set_params(self, x: np.ndarray) -> None:
        if self.fix_rates:
            return
        self.rates = np.asarray(x[: self._ncat], dtype=np.float64)
        w = np.concatenate([x[self._ncat:], [0.0]])
        w[-1] = max(1.0 - w[:-1].sum(), 1e-10)
        self.weights = w
        self.normalize()

    def param_bounds(self):
        if self.fix_rates:
            return np.zeros(0), np.zeros(0)
        lo = np.concatenate(
            [np.full(self._ncat, 1e-4), np.full(self._ncat - 1, 1e-6)])
        hi = np.concatenate(
            [np.full(self._ncat, 100.0), np.full(self._ncat - 1, 0.999)])
        return lo, hi

    def num_free_params(self) -> int:
        return 2 * self._ncat - 1


class RateFreeInvar(RateFree):
    def __init__(self, ncat: int = 4, p_invar: float = 0.1,
                 fix_pinv: bool = False, **kw):
        super().__init__(ncat, p_invar=p_invar, **kw)
        self.fix_pinv = fix_pinv
        self.name = f"+I+R{ncat}"

    def set_p_invar(self, v: float) -> None:
        self._p_invar = v

    def get_params(self) -> np.ndarray:
        base = super().get_params()
        if self.fix_pinv:
            return base
        return np.concatenate([base, [self._p_invar]])

    def set_params(self, x: np.ndarray) -> None:
        if not self.fix_pinv:
            self._p_invar = float(x[-1])
            x = x[:-1]
        super().set_params(x)

    def param_bounds(self):
        lo, hi = super().param_bounds()
        if self.fix_pinv:
            return lo, hi
        return (np.concatenate([lo, [1e-6]]),
                np.concatenate([hi, [0.9999]]))

    def num_free_params(self) -> int:
        return 2 * self._ncat
