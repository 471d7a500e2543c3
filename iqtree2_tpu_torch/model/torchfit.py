"""Joint model fit with exact gradients (counterpart of
iqtree2_tpu/model/jaxfit.py: try_fit and what it needs).

The objective is the JAX package's: unconstrained parameters x (log
exchangeabilities, log-ratio frequencies, log alpha or FreeRate rates and
weights, logit p_invar) and log branch lengths go through Q, P(t) by
scaling-and-squaring expm and a pruning down pass to logL, and both are
fitted jointly on gradients from autograd by the JAX package's optimizer:
optax.lbfgs() with its zoom line search (utils/lbfgs.py) under
jaxfit._fit_core's stopping rule. The finite-difference host
alternation of model/optimize.py stalls short of the optimum in float32;
this fit runs in float64 whenever epsilon < 0.05, whatever the engine's
dtype, as in the JAX package.

The down pass here is plain torch under autograd, as it is plain XLA in the
JAX package: it is differentiated, so it does not go through the pruning
kernels. The fit runs on the engine's device.

Reference analog: ModelFactory::optimizeParameters
(model/modelfactory.cpp:1329).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from iqtree2_tpu_torch.model.rates import (RateFree, RateFreeInvar, RateGamma,
                                           RateGammaInvar, RateInvar,
                                           RateModel)
from iqtree2_tpu_torch.model.subst import GTRModel
from iqtree2_tpu_torch.ops.prec import scaling_consts
from iqtree2_tpu_torch.ops.pruning import expm_ss
from iqtree2_tpu_torch.tree.schedule import build_schedule, write_blens_to_tree
from iqtree2_tpu_torch.utils.lbfgs import lbfgs_minimize

# residual-memory guard for reverse mode through the down pass:
# n_int * C * S * Pp elements (the saved messages are about twice that)
MAX_REVERSE_ELEMENTS = 2.0e8


# --------------------------------------------------------------- special fns
def _gammainc_series(a, x):
    """(P(a, x), dP/da) of the regularized lower incomplete gamma, in
    float64 on the host, from the series
    P = sum_n exp((a+n) log x - x - lgamma(a+n+1)) and
    dP/da = sum_n exp(...) (log x - digamma(a+n+1)). The terms peak near
    n = x - a and fall off within a few sqrt(x) past it.
    (torch.special.gammainc is off by about 1e-9 relative at a = 21.)"""
    a64, x64 = torch.broadcast_tensors(a.detach().double().cpu(),
                                       x.detach().double().cpu())
    xmax = float(x64.max()) if x64.numel() else 0.0
    n = torch.arange(int(xmax + 20.0 * math.sqrt(xmax + 1.0) + 60.0),
                     dtype=torch.float64)
    an1 = a64[..., None] + n + 1.0
    logx = torch.log(x64)[..., None]
    terms = torch.exp((an1 - 1.0) * logx - x64[..., None] - torch.lgamma(an1))
    return terms.sum(-1), (terms * (logx - torch.digamma(an1))).sum(-1)


def _gamma_logpdf(a, x):
    return (a - 1.0) * torch.log(x) - x - torch.lgamma(a)


def _like(t, ref):
    return t.to(dtype=ref.dtype, device=ref.device)


class _GammaInc(torch.autograd.Function):
    """P(a, x) with gradients for both arguments. These special functions
    of one shape parameter and C quantiles run on the host: on a card each
    of their many tiny steps would be a launch and a wait."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        return _like(_gammainc_series(a, x)[0], x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = (g * _like(_gammainc_series(a, x)[1], x)).sum_to_size(
                a.shape)
        if ctx.needs_input_grad[1]:
            gx = (g * torch.exp(_gamma_logpdf(a, x))).sum_to_size(x.shape)
        return ga, gx


class _GammaIncInv(torch.autograd.Function):
    """Inverse of P(a, x) = q in x. Forward: Wilson-Hilferty start and 40
    damped Newton steps in log x (jaxfit.gammaincinv), on the host.
    Backward: the implicit-function derivative,
    dx = (dq - dP/da da) / pdf(x)."""

    @staticmethod
    def forward(ctx, a, q):
        a_, q_ = torch.broadcast_tensors(a.detach().double().cpu(),
                                         q.detach().double().cpu())
        z = math.sqrt(2.0) * torch.special.erfinv(2.0 * q_ - 1.0)
        c = 1.0 - 1.0 / (9.0 * a_) + z * torch.sqrt(1.0 / (9.0 * a_))
        x0 = (a_ * c.clamp(min=1e-8) ** 3).clamp(
            torch.finfo(a.dtype).tiny * 100, 1e8)
        u = torch.log(x0)
        lg = torch.lgamma(a_)
        for _ in range(40):
            x = torch.exp(u)
            P = _gammainc_series(a_, x)[0]
            step = (P - q_) * torch.exp(-((a_ - 1.0) * u - x - lg + u))
            u = u - step.clamp(-4.0, 4.0)
        x = _like(torch.exp(u), q)
        ctx.save_for_backward(a, q, x)
        return x

    @staticmethod
    def backward(ctx, g):
        a, q, x = ctx.saved_tensors
        inv_pdf = torch.exp(-_gamma_logpdf(a, x))
        ga = gq = None
        if ctx.needs_input_grad[0]:
            ga = (-g * _like(_gammainc_series(a, x)[1], x)
                  * inv_pdf).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gq = (g * inv_pdf).sum_to_size(q.shape)
        return ga, gq


def gammainc(a, x):
    return _GammaInc.apply(a, x)


def gammaincinv(a, q):
    """x with P(a, x) = q (scipy.special.gammaincinv), differentiable."""
    return _GammaIncInv.apply(a, q)


def gamma_cat_rates(alpha, ncat: int, median: bool = False):
    """Discrete Gamma category rates of mean 1, differentiable in alpha
    (model/rates.py discrete_gamma_rates; reference:
    model/rategamma.cpp:98-131)."""
    kw = dict(dtype=alpha.dtype, device=alpha.device)
    if ncat == 1:
        return torch.ones(1, **kw)
    if median:
        probs = (2.0 * torch.arange(ncat, **kw) + 1.0) / (2.0 * ncat)
        r = gammaincinv(alpha, probs) / alpha
        return r * ncat / r.sum()
    xq = gammaincinv(alpha, torch.arange(1, ncat, **kw) / ncat)
    cum = gammainc(alpha + 1.0, xq)
    cum = torch.cat([torch.zeros(1, **kw), cum, torch.ones(1, **kw)])
    return torch.diff(cum) * ncat


# ------------------------------------------------------------------- spec
@dataclasses.dataclass
class FitSpec:
    """Structure and inputs of one fittable (model, rates): the segment
    layout (r, f, a, c, w, p) of x and its masks are jaxfit.FitSpec's, so
    an x vector means the same in both packages."""
    S: int
    C: int
    nr: int                     # number of exchangeability slots S(S-1)/2
    rate_kind: str              # "gamma" | "free"
    has_pinv: bool
    median: bool
    Cmat: np.ndarray            # [nr, nr] expands free-class values
    ref_mask: np.ndarray        # [nr] positions fixed at rate 1
    x0: np.ndarray              # [k] unconstrained start
    mask: np.ndarray            # [k] 1 = free, 0 = frozen at x0
    model: GTRModel = None
    rates: RateModel = None
    seg: dict = None

    @property
    def k(self) -> int:
        return len(self.x0)


def _logit(p):
    return float(np.log(p / (1.0 - p)))


def build_spec(model, rates) -> FitSpec | None:
    """Map host (model, rates) onto a FitSpec, or None if unsupported.

    Supported: plain GTRModel (every named DNA model through rate
    constraints, GTR on any state space, empirical protein matrices with
    or without +F) x {none, +I, +G, +I+G, +R, +I+R}. Copied from
    jaxfit.build_spec, whose module imports jax.
    """
    if type(model) is not GTRModel:
        return None
    if hasattr(model, "transform_tip_table"):
        return None
    t = type(rates)
    if t not in (RateModel, RateInvar, RateGamma, RateGammaInvar,
                 RateFree, RateFreeInvar):
        return None

    S = model.num_states
    nr = S * (S - 1) // 2

    # exchangeabilities
    Cmat = np.zeros((nr, nr))
    ref_mask = np.zeros(nr)
    xr0 = np.zeros(nr)
    free_classes = [] if model.fixed_rates else model.free_rate_classes()
    for j, c in enumerate(free_classes):
        pos = model._class_of == c
        Cmat[pos, j] = 1.0
        v = float(model.exch_rates[np.nonzero(pos)[0][0]])
        xr0[j] = np.log(np.clip(v, 1e-6, 1e6))
    if model.fixed_rates:
        # the whole exchangeability vector frozen at its current values
        ref_mask = np.asarray(model.exch_rates, float).copy()
    else:
        ref_mask[model._class_of == model._ref_class] = 1.0
    mask_r = np.zeros(nr)
    mask_r[: len(free_classes)] = 1.0

    # frequencies
    f = np.clip(np.asarray(model.freqs, float), 1e-10, None)
    xf0 = np.log(f[:-1] / f[-1])
    freqs_free = model.freq_type == "estimate"
    mask_f = np.full(S - 1, 1.0 if freqs_free else 0.0)

    # rate heterogeneity ("gamma" covers plain and +I too: C=1 Gamma is
    # the identity)
    median = bool(getattr(rates, "median", False))
    rate_kind = "free" if t in (RateFree, RateFreeInvar) else "gamma"
    C = rates.ncat

    p_inv = float(rates.p_invar)
    free_pinv = ((t is RateInvar and not getattr(rates, "fix_pinv", False))
                 or (t in (RateGammaInvar, RateFreeInvar)
                     and not getattr(rates, "fix_pinv", False)))
    has_pinv = bool(p_inv > 0 or free_pinv)

    alpha0 = float(np.clip(getattr(rates, "alpha", 1.0), 0.02, 100.0))
    xa0 = np.array([np.log(alpha0)])
    afree = (rate_kind == "gamma" and C > 1
             and not getattr(rates, "fix_alpha", True))
    mask_a = np.array([1.0 if afree else 0.0])
    xc0 = np.zeros(0)
    xw0 = np.zeros(0)
    mask_c = np.zeros(0)
    mask_w = np.zeros(0)
    if rate_kind == "free":
        r = np.clip(np.asarray(rates.rates, float), 1e-4, 100.0)
        w = np.clip(np.asarray(rates.weights, float), 1e-8, None)
        xc0 = np.log(r)
        xw0 = np.log(w[:-1] / w[-1])
        fr = 0.0 if rates.fix_rates else 1.0
        mask_c = np.full(C, fr)
        mask_w = np.full(C - 1, fr)
    xp0 = np.array([_logit(np.clip(p_inv if p_inv > 0 else 0.1,
                                   1e-4, 0.99))])
    mask_p = np.array([1.0 if free_pinv else 0.0])

    segs = {}
    off = 0
    for name, arr in (("r", xr0), ("f", xf0), ("a", xa0), ("c", xc0),
                      ("w", xw0), ("p", xp0)):
        segs[name] = (off, off + len(arr))
        off += len(arr)
    x0 = np.concatenate([xr0, xf0, xa0, xc0, xw0, xp0])
    mask = np.concatenate([mask_r, mask_f, mask_a, mask_c, mask_w, mask_p])
    return FitSpec(S=S, C=C, nr=nr, rate_kind=rate_kind, has_pinv=has_pinv,
                   median=median, Cmat=Cmat, ref_mask=ref_mask,
                   x0=x0, mask=mask, model=model, rates=rates, seg=segs)


# -------------------------------------------------------------- objective
def _unpack(x, spec: FitSpec, consts):
    """x -> (exch [nr], freqs [S], cat_rate [C], cat_weight [C], p_inv)."""
    def seg(name):
        a, b = spec.seg[name]
        return x[a:b]

    zero = torch.zeros(1, dtype=x.dtype, device=x.device)
    exch = consts["Cmat"] @ torch.exp(seg("r").clamp(-18.0, 18.0)) \
        + consts["ref_mask"]
    freqs = torch.softmax(torch.cat([seg("f"), zero]).clamp(-30.0, 30.0), 0)
    p_inv = torch.sigmoid(seg("p")[0]) * 0.9999 * consts["pinv_flag"]
    if spec.rate_kind == "gamma":
        alpha = torch.exp(seg("a")[0].clamp(math.log(0.02), math.log(1e3)))
        r = gamma_cat_rates(alpha, spec.C, spec.median)
        w = torch.full((spec.C,), 1.0 / spec.C, dtype=x.dtype,
                       device=x.device)
    else:
        w = torch.softmax(torch.cat([seg("w"), zero]).clamp(-30.0, 30.0), 0)
        raw = torch.exp(seg("c").clamp(math.log(1e-4), math.log(100.0)))
        r = raw / (w * raw).sum()
    return exch, freqs, r / (1.0 - p_inv), w * (1.0 - p_inv), p_inv


def _gtr_q(exch, freqs, iu):
    """Normalised reversible Q from exchangeabilities and frequencies
    (model/subst.py build_gtr_rate_matrix)."""
    S = freqs.shape[0]
    R = torch.zeros((S, S), dtype=exch.dtype,
                    device=exch.device).index_put(iu, exch)
    Q = (R + R.T) * freqs[None, :]
    Q = Q - torch.diag(Q.sum(1))
    mu = -(freqs * torch.diagonal(Q)).sum()
    return Q / mu.clamp(min=1e-12)


def fit_levels(sched, device) -> list:
    """Per level step of a TreeSchedule: (internal node ids, their child
    rows [g, 2] on the host, their child edges [g, 2] on ``device``); pad
    slots (nid == n_int) are dropped, as the JAX pass drops their writes."""
    out = []
    for row in sched.step_node:
        nid = row[row < sched.n_int].astype(np.int64)
        if len(nid):
            out.append((nid, sched.child_src[nid].astype(np.int64),
                        torch.as_tensor(sched.child_edge[nid],
                                        dtype=torch.int64, device=device)))
    return out


def down_pass_autograd(P, tipP, levels, n_int: int):
    """Pruning down pass for autograd (jaxfit._down_pass_unrolled): the
    per-node partials stay in a list, so reverse mode saves each level's
    children and messages rather than a copy of the whole buffer per level.
    Returns (root partial [C, S, Pp], root scale count [Pp], float)."""
    thresh, factor, _ = scaling_consts(P.dtype)
    L, S, Pp = tipP.shape
    C = P.shape[1]
    tips = tipP[:, None].expand(L, C, S, Pp)
    zero = torch.zeros(Pp, dtype=P.dtype, device=P.device)
    part = [None] * n_int
    scale = [None] * n_int
    for nid, src, eid in levels:
        kids = torch.stack([tips[s] if s < L else part[s - L]
                            for s in src.reshape(-1)])
        msg = torch.matmul(P[eid], kids.view(len(nid), 2, C, S, Pp))
        prod = msg[:, 0] * msg[:, 1]
        sc = torch.stack([(zero if a < L else scale[a - L])
                          + (zero if b < L else scale[b - L])
                          for a, b in src])
        need = prod.detach().amax(dim=(1, 2)) < thresh
        prod = torch.where(need[:, None, None], prod * factor, prod)
        sc = sc + need.to(sc.dtype)
        for k, node in enumerate(nid):
            part[node] = prod[k]
            scale[node] = sc[k]
    return part[n_int - 1], scale[n_int - 1]


def fit_loglik(x, log_t, spec: FitSpec, consts):
    """Joint objective logL(x, log branch lengths) (jaxfit._loglik)."""
    dtype = log_t.dtype
    exch, freqs, cat_r, cat_w, p_inv = _unpack(x, spec, consts)
    Q = _gtr_q(exch, freqs, consts["iu"])
    t = torch.exp(log_t.clamp(math.log(1e-7), math.log(10.0)))
    A = Q[None, None] * (cat_r[None, :, None, None] * t[:, None, None, None])
    if dtype == torch.float64:
        P = expm_ss(A, order=12, squarings=14)
    else:
        P = expm_ss(A, order=8, squarings=8)
    P = P.clamp(min=0.0)
    tipP = consts["tipP"]
    part, sc = down_pass_autograd(P, tipP, consts["levels"], consts["n_int"])
    Broot = part * torch.matmul(P[0], tipP[0])
    _, _, log_rescale = scaling_consts(dtype)
    site = cat_w @ torch.einsum("x,cxp->cp", freqs, Broot)
    tiny = torch.finfo(dtype).tiny
    lp = torch.log(site.clamp(min=tiny)) - sc * log_rescale
    use = consts["is_const"] & (consts["pinv_flag"] > 0)
    cmf = consts["cmf_raw"] @ freqs
    lpi = torch.where(
        use, torch.log(p_inv.clamp(min=tiny))
        + torch.log(torch.where(use, cmf.clamp(min=tiny), 1.0)),
        -torch.inf)
    return (consts["pw"] * torch.logaddexp(lp, lpi)).sum()


def fit_consts(eng, sched, spec: FitSpec, dtype: torch.dtype) -> dict:
    """Fit-precision constants on the engine's device, independent of the
    engine's own tensors (which may be float32)."""
    dev = eng.device
    kw = dict(dtype=dtype, device=dev)
    tip_table = torch.as_tensor(eng.pack_np.tip_table, **kw)
    codes = torch.as_tensor(eng.tip_codes, dtype=torch.int64, device=dev)
    cm = np.zeros((eng.Pp, spec.S))
    cm[: eng.aln.num_patterns] = eng.aln.const_state_mask()
    iu = np.triu_indices(spec.S, 1)
    return dict(
        Cmat=torch.as_tensor(spec.Cmat, **kw),
        ref_mask=torch.as_tensor(spec.ref_mask, **kw),
        iu=tuple(torch.as_tensor(i, dtype=torch.int64, device=dev)
                 for i in iu),
        tipP=tip_table[codes].transpose(1, 2).contiguous(),
        pw=torch.as_tensor(eng.pattern_weights, **kw),
        cmf_raw=torch.as_tensor(cm, **kw),
        is_const=torch.as_tensor(cm.sum(1) > 0, device=dev),
        pinv_flag=torch.tensor(1.0 if spec.has_pinv else 0.0, **kw),
        levels=fit_levels(sched, dev),
        n_int=sched.n_int)


# -------------------------------------------------------------------- fit
def _writeback(spec: FitSpec, x: np.ndarray) -> None:
    """Set the host model and rate objects from the fitted vector (copied
    from jaxfit._writeback)."""
    model, rates = spec.model, spec.rates

    def seg(name):
        a, b = spec.seg[name]
        return x[a:b]

    if not model.fixed_rates and np.any(spec.mask[slice(*spec.seg["r"])]):
        exch = spec.Cmat @ np.exp(seg("r")) + spec.ref_mask
        model.exch_rates = np.asarray(exch, np.float64)
    if model.freq_type == "estimate" and \
            np.any(spec.mask[slice(*spec.seg["f"])]):
        uf = np.concatenate([seg("f"), [0.0]])
        e = np.exp(uf - uf.max())
        model.freqs = e / e.sum()
    p_inv = 0.0
    if spec.has_pinv:
        p_inv = float(1.0 / (1.0 + np.exp(-seg("p")[0])) * 0.9999)
    if spec.rate_kind == "gamma":
        if spec.mask[spec.seg["a"][0]]:
            rates.alpha = float(np.exp(seg("a")[0]))
        if spec.mask[spec.seg["p"][0]]:
            rates._p_invar = p_inv
    elif spec.rate_kind == "free":
        if not rates.fix_rates and np.any(spec.mask[slice(*spec.seg["c"])]):
            uw = np.concatenate([seg("w"), [0.0]])
            e = np.exp(uw - uw.max())
            w = e / e.sum()
            raw = np.exp(seg("c"))
            rates.weights = w
            rates.rates = raw / (w * raw).sum()
            rates.normalize()
        if spec.mask[spec.seg["p"][0]]:
            rates._p_invar = p_inv


def try_fit(eng, tree, fix_blens: bool = False, epsilon: float = 0.01,
            max_iters: int | None = None) -> float | None:
    """Joint fit of (model parameters, branch lengths) on one topology.

    Returns the final logL (at the fit's precision) and updates the host
    model, rates and tree in place, or None when the objective does not
    cover this (engine, model, rates) or the problem is too large for
    reverse mode; the caller then runs the host alternation. max_iters
    caps the L-BFGS iterations (None: 400 for a thorough fit, 25 for a
    screening one; ModelFinder's quick screen passes 8).
    """
    if eng.asc:
        return None
    spec = build_spec(eng.model, eng.rates)
    if spec is None:
        return None
    sched = build_schedule(tree)
    if sched.n_int * spec.C * spec.S * eng.Pp > MAX_REVERSE_ELEMENTS:
        return None
    # thorough fits (final refit, fixed-topology runs) in float64;
    # screening fits (search start, epsilon >= 0.05) in float32
    dtype = torch.float64 if epsilon < 0.05 else torch.float32
    blens = np.clip(sched.blens, 1e-6, 10.0)
    mask = np.concatenate(
        [spec.mask, np.full(len(blens), 0.0 if fix_blens else 1.0)])
    if not np.any(mask):
        return None
    if max_iters is None:
        max_iters = 400 if epsilon < 0.05 else 25
    gtol = 1e-4 if epsilon < 0.05 else 0.05
    if dtype == torch.float32:
        gtol = max(gtol, 1e-2)

    consts = fit_consts(eng, sched, spec, dtype)
    kw = dict(dtype=dtype, device=eng.device)
    z0 = torch.as_tensor(np.concatenate([spec.x0, np.log(blens)]), **kw)
    m = torch.as_tensor(mask, **kw)
    k = spec.k

    def pinned(z):
        # frozen entries pinned to z0: their gradient is exactly 0
        return z0 * (1.0 - m) + z * m

    def value_and_grad(z):
        z = z.detach().requires_grad_(True)
        zz = pinned(z)
        loss = -fit_loglik(zz[:k], zz[k:], spec, consts)
        (g,) = torch.autograd.grad(loss, z)
        return loss.detach(), g

    z, _ = lbfgs_minimize(value_and_grad, z0, max_iters, gtol)
    with torch.no_grad():
        zz = pinned(z)
        logL = float(fit_loglik(zz[:k], zz[k:], spec, consts))
    if not math.isfinite(logL):
        return None
    zz = zz.double().cpu().numpy()
    _writeback(spec, zz[:k])
    write_blens_to_tree(tree, sched, np.clip(np.exp(zz[k:]), 1e-6, 10.0))
    eng.refresh_model()
    return logL
