"""L-BFGS with the zoom line search, transcribed from optax 0.2.6 so that the
port's joint model fit takes the same steps as the JAX package's
(model/jaxfit._fit_core runs ``optax.lbfgs()``).

The pieces and their origin in optax/_src/:
- alias.py:2591 ``lbfgs``: memory 10, ``scale_init_precond=True``, the
  direction negated, then the line search;
- transform.py:1573 ``scale_by_lbfgs`` (and ``_precondition_by_lbfgs``
  :1497): the memory of parameter and gradient differences, written before
  the direction is formed, the two-loop product, gamma_k from the newest
  pair or min(1, 1/|g|) at the first step;
- linesearch.py:1331 ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` over ``zoom_linesearch`` (:576): the
  interval search and zoom of Nocedal and Wright (Algorithms 3.5, 3.6)
  with the approximate sufficient decrease of Hager and Zhang, its
  defaults slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6,
  increase_factor 2, stepsize_precision 1e-5 and tol 0;
- utils.py:266 ``value_and_grad_from_state``: the value and gradient the
  line search ended on are reused, unless that value is not finite.

The stopping rule is jaxfit._fit_core's: the first step is always taken,
then steps continue while the count is below max_iters, the largest
gradient entry above gtol and the value finite. Vectors stay tensors on
their device; the line search's scalars are numpy scalars of the
objective's dtype, as optax keeps them in the parameters' dtype.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

MEMORY = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5


def _dot(a, b):
    return (a * b).sum()


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none (linesearch.py:455)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1 = fb - fa - C * db
    r2 = fc - fa - C * dc
    A = (dc ** 2 * r1 - db ** 2 * r2) / denom
    B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (linesearch.py:496)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _Zoom:
    """One run of optax's zoom line search along ``d`` from ``z``."""

    def __init__(self, fun, z, d, value, grad, f):
        self.fun, self.z, self.d, self.f = fun, z, d, f
        slope = self._slope(grad)
        self.value_init, self.slope_init = value, slope
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = f(0.0), value, \
            grad, slope
        self.decrease_error = self.curvature_error = f(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = f(0.0), value, slope
        self.high, self.value_high, self.slope_high = f(0.0), value, slope
        self.cubic_ref, self.value_cubic_ref = f(0.0), value
        self.safe_stepsize, self.safe_value, self.safe_grad = f(0.0), value, \
            grad

    def _slope(self, grad):
        return self.f(_dot(grad, self.d).item())

    def _on_line(self, stepsize):
        value, grad = self.fun(self.z + float(stepsize) * self.d)
        return self.f(value.item()), grad, self._slope(grad)

    def _errors(self, stepsize, value, slope):
        f = self.f
        dec = value - self.value_init - f(SLOPE_RTOL) * stepsize \
            * self.slope_init
        approx = slope - f(2 * SLOPE_RTOL - 1.0) * self.slope_init
        delta = value - self.value_init \
            - f(APPROX_DEC_RTOL) * np.abs(self.value_init)
        dec = np.minimum(np.maximum(approx, delta), dec)
        dec = np.maximum(dec, f(0.0))
        dec = f(np.inf) if np.isnan(dec) else dec
        curv = np.maximum(np.abs(slope) - f(CURV_RTOL)
                          * np.abs(self.slope_init), f(0.0))
        curv = f(np.inf) if np.isnan(curv) else curv
        return dec, curv, np.maximum(dec, curv)

    def _search_interval(self):
        """linesearch.py:815, with no maximal stepsize."""
        it = self.count
        prev = (self.stepsize, self.value, self.slope)
        new = self.f(1.0) if it == 0 else self.f(INCREASE_FACTOR) \
            * self.stepsize
        value, grad, slope = self._on_line(new)
        dec, curv, err = self._errors(new, value, slope)
        if dec <= 0.0:
            self.safe_stepsize, self.safe_value, self.safe_grad = \
                new, value, grad
        set_high = bool(dec > 0.0) or (bool(value >= prev[1]) and it > 0)
        set_low = bool(slope >= 0.0) and not set_high
        if set_low:
            (self.low, self.value_low, self.slope_low) = (new, value, slope)
            (self.high, self.value_high, self.slope_high) = prev
        else:
            (self.low, self.value_low, self.slope_low) = prev
            (self.high, self.value_high, self.slope_high) = (new, value,
                                                             slope)
        self.interval_found = set_high or set_low or bool(err <= 0.0)
        self.done = bool(err <= 0.0)
        self.failed = it + 1 >= MAX_LINESEARCH_STEPS and not self.done
        self.count = it + 1
        self.stepsize, self.value, self.grad, self.slope = new, value, grad, \
            slope
        self.decrease_error, self.curvature_error = dec, curv
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low

    def _zoom_into_interval(self):
        """linesearch.py:971."""
        low, vl, sl = self.low, self.value_low, self.slope_low
        high, vh, sh = self.high, self.value_high, self.slope_high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = self.f(0.2) * delta, self.f(0.1) * delta
        too_small = bool(delta <= STEPSIZE_PRECISION)
        with np.errstate(all="ignore"):
            mc = _cubicmin(low, vl, sl, high, vh, self.cubic_ref,
                           self.value_cubic_ref)
            mq = _quadmin(low, vl, sl, high, vh)
        if bool(mc > left + cubic_chk) and bool(mc < right - cubic_chk):
            middle = mc
        elif bool(mq > left + quad_chk) and bool(mq < right - quad_chk):
            middle = mq
        else:
            middle = (low + high) / self.f(2.0)
        middle = self.f(middle)
        value, grad, slope = self._on_line(middle)
        dec, curv, err = self._errors(middle, value, slope)
        if bool(dec <= 0.0) and bool(value < self.safe_value):
            self.safe_stepsize, self.safe_value, self.safe_grad = \
                middle, value, grad
        self.done = bool(err <= 0.0)
        set_high_mid = bool(dec > 0.0) or bool(value >= vl)
        set_high_low = bool(slope * (high - low) >= 0.0) and not set_high_mid
        if set_high_mid:
            self.high, self.value_high, self.slope_high = middle, value, slope
        if set_high_low:
            self.high, self.value_high, self.slope_high = low, vl, sl
        if not set_high_mid:
            self.low, self.value_low, self.slope_low = middle, value, slope
        if set_high_mid or set_high_low:
            self.cubic_ref, self.value_cubic_ref = high, vh
        else:
            self.cubic_ref, self.value_cubic_ref = low, vl
        failed = (self.count + 1 >= MAX_LINESEARCH_STEPS
                  or (too_small and bool(self.safe_stepsize > 0.0)))
        self.failed = failed and not self.done
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = middle, value, \
            grad, slope
        self.decrease_error, self.curvature_error = dec, curv

    def _try_safe_step(self):
        """linesearch.py:768."""
        if bool(self.safe_stepsize > 0.0) or np.isinf(self.decrease_error):
            self.stepsize, self.value, self.grad = \
                self.safe_stepsize, self.safe_value, self.safe_grad

    def run(self):
        """(stepsize, value, grad) where the search ended."""
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom_into_interval()
            else:
                self._search_interval()
            if self.failed:
                self._try_safe_step()
        return self.stepsize, self.value, self.grad


def lbfgs_minimize(fun: Callable, z0: torch.Tensor, max_iters: int,
                   gtol: float) -> tuple[torch.Tensor, int]:
    """Minimize ``fun`` from ``z0`` by optax.lbfgs() under jaxfit._fit_core's
    stopping rule. ``fun(z)`` returns (value, gradient) tensors; its dtype
    is the fit's. Returns (z, number of L-BFGS steps)."""
    f = np.float64 if z0.dtype == torch.float64 else np.float32
    n = z0.numel()
    dw = torch.zeros((MEMORY, n), dtype=z0.dtype, device=z0.device)
    du = torch.zeros_like(dw)
    rho = torch.zeros(MEMORY, dtype=z0.dtype, device=z0.device)
    prev_z = torch.zeros_like(z0)
    prev_g = torch.zeros_like(z0)
    z = z0
    count = 0
    value, grad = f(np.inf), torch.zeros_like(z0)   # the line search's state
    while count == 0 or (count < max_iters and np.isfinite(value)
                         and float(grad.abs().max()) > gtol):
        if not np.isfinite(value):
            v, grad = fun(z)
            value = f(v.item())
        # transform.py:1676: the memory first, then the direction
        mem_idx, prev_idx = count % MEMORY, (count - 1) % MEMORY
        if count > 0:
            d_z, d_g = z - prev_z, grad - prev_g
            vdot = _dot(d_g, d_z)
            dw[prev_idx], du[prev_idx] = d_z, d_g
            rho[prev_idx] = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
            den = _dot(d_g, d_g)
            gamma = torch.where(den > 0.0, vdot / den, 1.0)
        else:
            dw[prev_idx], du[prev_idx], rho[prev_idx] = 0.0, 0.0, 0.0
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        order = [(mem_idx + i) % MEMORY for i in range(MEMORY)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = rho[i] * _dot(dw[i], vec)
            vec = vec - alphas[i] * du[i]
        vec = gamma * vec
        for i in order:
            vec = vec + (alphas[i] - rho[i] * _dot(du[i], vec)) * dw[i]
        prev_z, prev_g = z, grad
        count += 1
        d = -vec
        step, value, grad = _Zoom(fun, z, d, value, grad, f).run()
        z = z + float(step) * d
    return z, count
