"""Host-side numeric optimizers.

Reference analogs: utils/optimization.cpp — Brent 1-D (minimizeOneDimen
:322), Newton 1-D (minimizeNewton :422), multi-dim BFGS/L-BFGS-B
(minimizeMultiDimen / lbfgsb). Here: a self-contained Brent and thin
wrappers over scipy.optimize for the multivariate cases. These optimize
*host* scalars (model parameters); each function evaluation is a jitted
device call, so the chatty loop lives on host by design (SURVEY §7).

Copied from iqtree2_tpu/utils/optimize.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize as sopt


def brent_minimize(f, lo: float, hi: float, guess: float | None = None,
                   xtol: float = 1e-6, max_iter: int = 100):
    """Minimize f on [lo, hi]; returns (x, f(x))."""
    res = sopt.minimize_scalar(
        f, bounds=(lo, hi), method="bounded",
        options={"xatol": xtol, "maxiter": max_iter})
    x, fx = float(res.x), float(res.fun)
    if guess is not None:
        fg = f(guess)
        if fg < fx:
            return float(guess), float(fg)
    return x, fx


def lbfgsb_minimize(f, x0: np.ndarray, lower: np.ndarray, upper: np.ndarray,
                    grad=None, eps: float = 1e-4, max_iter: int = 200,
                    ftol: float = 1e-8):
    """Bounded multivariate minimization (projected BFGS + backtracking).

    Reference analog: L-BFGS-B entry (utils/optimization.h:234).

    The likelihood surface is NaN/-inf at extreme parameter corners
    (likelihood underflow); scipy's L-BFGS-B line search places its first
    (generalized Cauchy) trial exactly on such corners and aborts without
    progress, so we run our own projected-BFGS: non-finite trial values are
    treated as +inf and the Armijo backtracking simply shortens the step.
    """
    x = np.clip(np.asarray(x0, dtype=np.float64), lower, upper)
    n = len(x)
    if n == 0:
        return x, float(f(x))

    def fval(z):
        v = f(z)
        return float(v) if np.isfinite(v) else np.inf

    def num_grad(z, fz):
        g = np.zeros(n)
        for i in range(n):
            h = eps * max(1.0, abs(z[i]))
            zp = z.copy()
            if z[i] + h > upper[i]:        # one-sided at the bound
                zp[i] = z[i] - h
                fp = fval(zp)
                g[i] = (fz - fp) / h if np.isfinite(fp) else 0.0
            else:
                zp[i] = z[i] + h
                fp = fval(zp)
                g[i] = (fp - fz) / h if np.isfinite(fp) else 0.0
        return g

    def gradient(z, fz):
        if grad is not None:
            return np.asarray(grad(z), dtype=np.float64)
        return num_grad(z, fz)

    fx = fval(x)
    g = gradient(x, fx)
    H = np.eye(n)
    for _ in range(max_iter):
        d = -H @ g
        if np.dot(d, g) >= 0:              # not a descent direction: reset
            H = np.eye(n)
            d = -g
        if not np.any(d):
            break
        # scale the first trial so no component moves more than ~0.5 of its
        # current magnitude (keeps trials out of the degenerate corners)
        dmax = np.max(np.abs(d) / np.maximum(np.abs(x), 1e-2))
        alpha = min(1.0, 0.5 / dmax) if dmax > 0 else 1.0
        xn = fn = None
        ok = False
        for _ls in range(40):
            xn = np.clip(x + alpha * d, lower, upper)
            fn = fval(xn)
            if np.isfinite(fn) and fn <= fx + 1e-4 * np.dot(g, xn - x):
                ok = True
                break
            alpha *= 0.5
        if not ok:
            break                           # no step size improves: done
        converged = fx - fn < ftol * max(abs(fx), 1.0)
        gn = gradient(xn, fn)
        s, y = xn - x, gn - g
        sy = np.dot(s, y)
        if sy > 1e-12 * np.linalg.norm(s) * np.linalg.norm(y):
            rho = 1.0 / sy
            I = np.eye(n)
            V = I - rho * np.outer(s, y)
            H = V @ H @ V.T + rho * np.outer(s, s)
        x, fx, g = xn, fn, gn
        if converged:
            break
    return x, float(fx)


def bfgs_box_minimize(f, x0, lower, upper, max_iter: int = 200):
    x, fx = lbfgsb_minimize(f, x0, lower, upper, max_iter=max_iter)
    return x, fx
