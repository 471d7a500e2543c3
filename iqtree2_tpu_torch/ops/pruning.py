"""Felsenstein pruning in PyTorch (counterpart of iqtree2_tpu/ops/pruning.py).

The math and the layout are the JAX package's: pattern-last partials
[.., C, S, Pp], one unified buffer DownPass.all [L + n_int, C, S, Pp] with the
tips broadcast over categories in rows 0..L-1, int32 scale counts, and the
2^-B per-pattern rescale of ``scaling_consts``. A pass over the level steps
of tree/schedule.py is one call of a kernel wrapper in ops/kernels.py,
which launches the Hopper kernel once for CUDA tensors and runs its plain
PyTorch version (a loop over the steps) for CPU tensors. The site
log-likelihoods are the down pass's epilogue (down_pass with ``pack``) and
the Newton round's theta buffers come from one theta_pass, which never
writes E; both_passes and edge_thetas keep E and the tip rows for NNI
scoring. ``vmap`` over edges in the JAX engine becomes an explicit leading
E axis here (theta_pass, branch_lh_derivs, newton_branch_step and their
nonreversible and mixlen forms).

Nonreversible models (pack["Q"]: UNREST, Lie-Markov, PoMo, YAML
``reversible: false``) take P = max(expm_ss(Q r t), 0) and the direct
derivatives through dP/dt = Q P (branch_lh_derivs_nonrev), since their
eigensystems are complex; per-category (mixlen, +H) branch lengths are a
[E, C] ``blens`` and take a coordinate Newton per category
(branch_lh_derivs_mixlen). Both run through the same three kernels as a
reversible model. ``expm_ss`` also serves the joint model fit
(model/torchfit.py), which differentiates through it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from iqtree2_tpu_torch.ops import kernels
from iqtree2_tpu_torch.ops.kernels import apply_P, root_lp
from iqtree2_tpu_torch.ops.prec import scaling_consts


class DownPass(NamedTuple):
    all: torch.Tensor        # [L + n_int, C, S, Pp] unified partials
    scale: torch.Tensor      # [L + n_int, Pp] int32 scale counts
    lp: torch.Tensor | None = None   # [Pp] site log-likelihoods, if asked


class UpPass(NamedTuple):
    edge_E: torch.Tensor        # [E, C, S, Pp] outside partial per edge
    edge_E_scale: torch.Tensor  # [E, Pp]
    up_in: torch.Tensor         # [n_int, C, S, Pp] outside partial per node
    up_scale: torch.Tensor      # [n_int, Pp]


class Thetas(NamedTuple):
    theta: torch.Tensor      # [E, C, S, Pp] eigenbasis products
    scale: torch.Tensor      # [E, Pp] total scale counts


# --------------------------------------------------------------- transition
def transition_tensors(blens, pack):
    """P[e, c] = exp(Q_m r_c t_e) -> [E, C, S, S].

    ``blens`` is [E] (one length per edge) or [E, C] (one per edge and
    category: the mixlen models, +H). A nonreversible model (pack["Q"])
    takes the scaling-and-squaring exponential of Q r t; a reversible one
    with the orthonormal eigenvectors W (pack["W"]) the cancellation-free
    form P = D^-1/2 (I + W diag(expm1(lambda r t)) W^T) D^1/2, otherwise
    U diag(exp(lambda r t)) V (reference: ModelMarkov::computeTransMatrix,
    model/modelmarkov.cpp:504).
    """
    cat_mix = pack["cat_mix"]
    t_ec = blens[:, None] if blens.dim() == 1 else blens          # [E, C]
    if pack.get("Q") is not None:
        A = pack["Q"][cat_mix][None] * (pack["cat_rate"][None, :, None, None]
                                        * t_ec[:, :, None, None])
        return expm_ss(A).clamp(min=0.0).contiguous()
    lam = pack["eigvals"][cat_mix]                               # [C, S]
    expo = lam[None] * pack["cat_rate"][None, :, None] * t_ec[:, :, None]
    # each product as a broadcast and a batched matmul: a three-operand
    # einsum asks opt_einsum for a contraction path on every call, which
    # costs more host time than the product at the search's sizes
    if pack.get("W") is not None:
        Wc = pack["W"][cat_mix]                                  # [C, S, S]
        sq = pack["sqrt_freqs"][cat_mix]                         # [C, S]
        core = torch.matmul(Wc * torch.expm1(expo)[:, :, None, :],
                            Wc.transpose(-1, -2))
        eye = torch.eye(lam.shape[-1], dtype=core.dtype, device=core.device)
        P = (eye + core) * (sq[None, :, None, :] / sq[None, :, :, None])
    else:
        P = torch.matmul(pack["U"][cat_mix] * torch.exp(expo)[:, :, None, :],
                         pack["V"][cat_mix])
    return P.clamp(min=0.0).contiguous()   # the kernels take [E, C, S, S]


# the largest scaled norm ||A / 2^k||_inf the Taylor series of expm_ss
# takes, per precision: its order-8 remainder is then below 0.1^9 / 9! =
# 3e-15 in float64 and 0.5^9 / 9! = 5.4e-9 in float32, under the rounding
# of each
EXPM_MAX_SCALED_NORM = {torch.float64: 0.1, torch.float32: 0.5}
# the fewest squarings per precision: the JAX package's fixed eight in
# float64 (its values wherever eight suffice); none in float32, where each
# squaring doubles the rounding error that P carries (ROADMAP C-port 3: at
# GTR+P19+G4 on example.phy the float32 logL read 0.214 below the float64
# one with nine squarings for every matrix, within 0.002 with these)
EXPM_MIN_SQUARINGS = {torch.float64: 8, torch.float32: 0}


def expm_ss(A, order: int = 8, squarings: int | None = None):
    """Batched matrix exponential by scaling and squaring with a truncated
    Taylor series, exp(A) = (exp(A / 2^k))^(2^k), k chosen per matrix. For
    rate matrices Q t with t <= 10 and mean rate 1 the scaled norm is tiny
    at the JAX package's fixed k = 8, which float64 keeps as its floor
    (``squarings`` overrides the floor); a stiffer A (PoMo's drift rates
    over its small mean rate reach hundreds) takes more squarings, until its
    scaled norm is at most EXPM_MAX_SCALED_NORM (the JAX package's fixed k
    gives P entries far above 1 there, ROADMAP C20). Each matrix takes its
    own k, so a short branch is not squared as often as the stiffest one.
    Matmuls only, so autograd is smooth at the degenerate eigenvalues where
    an eigendecomposition's gradient is not."""
    floor = EXPM_MIN_SQUARINGS.get(A.dtype, 8) if squarings is None \
        else squarings
    eye = torch.eye(A.shape[-1], dtype=A.dtype,
                    device=A.device).expand(A.shape)
    if not A.numel():
        return eye
    norm = A.detach().abs().sum(-1).amax(-1)
    theta = EXPM_MAX_SCALED_NORM.get(A.dtype, 0.1)
    k = torch.ceil(torch.log2(norm / theta)).nan_to_num(neginf=0.0) \
        .clamp(min=floor)
    k_min, k_max = (int(v) for v in torch.stack([k.min(), k.max()]).tolist())
    A = A * torch.exp2(-k)[..., None, None]
    P = eye
    term = eye
    for i in range(1, order + 1):
        term = torch.matmul(term, A) / i
        P = P + term
    for i in range(k_max):
        PP = torch.matmul(P, P)
        P = PP if i < k_min else torch.where((k > i)[..., None, None], PP, P)
    return P


def tip_partials(tip_codes, tip_table):
    """[L, Pp] codes + [ncodes, S] table -> [L, S, Pp] leaf partials."""
    return tip_table[tip_codes].transpose(1, 2).contiguous()


# ----------------------------------------------------------------- passes
def down_buffers(P, tipP, n_int: int, tips: bool = True) -> DownPass:
    """Unified buffers of a down pass: tip rows of the scales zero, tip rows
    of the partials filled with the tips (broadcast over categories) only
    with ``tips``; no kernel reads them, NNI scoring does. The internal rows
    are left unset: the pass writes each once."""
    L, S, Pp = tipP.shape
    ALL = torch.empty((L + n_int, P.shape[1], S, Pp), dtype=tipP.dtype,
                      device=tipP.device)
    if tips:
        ALL[:L] = tipP[:, None]
    SC = torch.empty((L + n_int, Pp), dtype=torch.int32, device=tipP.device)
    SC[:L] = 0
    return DownPass(ALL, SC)


def down_pass(P, tipP, sched, pack=None, tips: bool = True) -> DownPass:
    """Post-order sweep over the level steps (contract of
    pruning._down_pass_xla): one down_pass kernel call. With ``pack`` the
    same launch also writes the site log-likelihoods (DownPass.lp); with
    ``tips=False`` the tip rows of DownPass.all are left unset (a
    log-likelihood or a theta pass does not read them)."""
    dp = down_buffers(P, tipP, sched["child_src"].shape[0], tips)
    sitelp = None
    if pack is not None:
        dp = dp._replace(lp=torch.empty(tipP.shape[-1], dtype=tipP.dtype,
                                        device=tipP.device))
        sitelp = (pack["root_freqs"], pack["cat_weight"],
                  pack["log_ptn_invar"], dp.lp)
    kernels.down_pass(P, tipP, dp.all, dp.scale, sched["child_src"],
                      sched["child_edge"], sched["step_node"], sitelp=sitelp)
    return dp


def _rows(n: int, P, tipP):
    """Unset [n, C, S, Pp] partials and [n, Pp] int32 scales."""
    _, S, Pp = tipP.shape
    return (torch.empty((n, P.shape[1], S, Pp), dtype=tipP.dtype,
                        device=tipP.device),
            torch.empty((n, Pp), dtype=torch.int32, device=tipP.device))


def up_buffers(P, dp: DownPass, tipP, root_freqs) -> UpPass:
    """Buffers of an up pass with the root initialised (plain, as in the
    JAX package): UP[root] = pi * (P_0 tip_0) and E[0] = pi * down[root]
    (leaf 0's edge is folded into the root). The pass writes every other
    row once."""
    E, ES = _rows(P.shape[0], P, tipP)
    UP, UPS = _rows(dp.all.shape[0] - tipP.shape[0], P, tipP)
    kernels.root_init_plain(P, tipP, dp.all, dp.scale, UP, UPS, E, ES,
                            root_freqs)
    return UpPass(E, ES, UP, UPS)


def up_pass(P, dp: DownPass, tipP, sched, root_freqs) -> UpPass:
    """Pre-order sweep (contract of pruning._up_pass_xla): E per edge and UP
    per internal node, one up_pass kernel call."""
    up = up_buffers(P, dp, tipP, root_freqs)
    kernels.up_pass(P, tipP, dp.all, dp.scale, up.up_in, up.up_scale,
                    up.edge_E, up.edge_E_scale, sched["child_src"],
                    sched["child_edge"], sched["step_node"])
    return up


def both_passes(P, tipP, sched, pack, want_lp: bool = False):
    """(DownPass, UpPass) for one topology, with the tip rows set for NNI
    scoring; with ``want_lp`` the down pass also writes DownPass.lp."""
    dp = down_pass(P, tipP, sched, pack=pack if want_lp else None)
    return dp, up_pass(P, dp, tipP, sched, pack["root_freqs"])


def theta_pass(P, dp: DownPass, tipP, sched, pack) -> Thetas:
    """Theta buffers of every edge from one theta_pass kernel call over a
    finished down pass (tip rows of dp.all not needed): the outside sweep
    with theta formed per edge inside it, E never stored in edge rows (past
    64 states the kernel keeps it in a workspace of its own; contract of
    pallas_pruning2.thetas_v2; the same values as edge_thetas on
    both_passes)."""
    UP, UPS = _rows(dp.all.shape[0] - tipP.shape[0], P, tipP)
    theta, tsc = _rows(P.shape[0], P, tipP)
    cat_mix = pack["cat_mix"]
    kernels.theta_pass(P, tipP, dp.all, dp.scale, UP, UPS, theta, tsc,
                       sched["child_src"], sched["child_edge"],
                       sched["step_node"], pack["U"][cat_mix].contiguous(),
                       pack["V"][cat_mix].contiguous(), pack["root_freqs"])
    return Thetas(theta, tsc)


def gather_messages(dp: DownPass, P, src_idx, eids):
    """Child messages msg = P_e partial[src] for arbitrary index tensors
    (NNI scoring recomputes them; the passes do not store them).

    src_idx/eids: [...] int64; returns (msg [..., C, S, Pp], scale [..., Pp]).
    A batched matmul, not apply_P's broadcast product, whose [..., S, S, Pp]
    temporary would be S times the message.
    """
    return torch.matmul(P[eids], dp.all[src_idx]), dp.scale[src_idx]


# ------------------------------------------------------------------- root
def root_partial(dp: DownPass, P, tipP, n_int: int):
    """Combined root partial B_root * (P_0 @ tip_0) [C, S, Pp] and its
    scale [Pp] (leaf 0 is folded into the root)."""
    L = tipP.shape[0]
    return (dp.all[L + n_int - 1] * apply_P(P[0], tipP[0]),
            dp.scale[L + n_int - 1])


def root_loglik(Broot, SCroot, root_freqs, cat_weight, log_ptn_invar,
                pattern_weights, asc_mask=None, asc_nsites=None):
    """(logL, site lp [Pp]) from the combined root partial."""
    lp = root_lp(Broot, SCroot, root_freqs, cat_weight, log_ptn_invar)
    return finalize_loglik(lp, pattern_weights, asc_mask=asc_mask,
                           asc_nsites=asc_nsites)


def site_lp(dp: DownPass):
    """Per-pattern log-likelihoods [Pp] of a down pass run with ``pack``
    (its epilogue's output)."""
    if dp.lp is None:
        raise ValueError("site_lp: the down pass ran without pack, so it "
                         "wrote no site log-likelihoods")
    return dp.lp


def summed(reduce, *xs):
    """The equally shaped tensors ``xs`` summed over a rank group by one
    call of ``reduce`` (a callable that sums a tensor over the group in
    place, parallel/shard.all_reduce_sum: the counterpart of the JAX
    package's psum over ``axis_name``); ``xs`` themselves where reduce is
    None, so an unsharded call computes exactly what it did without it."""
    if reduce is None:
        return xs
    flat = torch.stack(xs)
    reduce(flat)
    return flat.unbind(0)


def finalize_loglik(lp, pattern_weights, asc_mask=None, asc_nsites=None,
                    reduce=None):
    """(logL, lp): weighted pattern sum, optional Lewis +ASC correction
    logL -= N log(1 - sum_x L_x) (reference: tree/phylokernelnew.h:3275).
    With ``reduce`` (see summed) lp is a rank's slice of the patterns and
    the pattern sums, sum_x L_x included, cross the ranks before the
    correction's logarithm."""
    logL = (pattern_weights * lp).sum()
    if asc_mask is None:
        (logL,) = summed(reduce, logL)
        return logL, lp
    prob_unobs = (asc_mask * torch.exp(lp)).sum()
    logL, prob_unobs = summed(reduce, logL, prob_unobs)
    logL = logL - asc_nsites * torch.log1p(
        -prob_unobs.clamp(max=1.0 - 1e-10))
    return logL, lp


def tree_loglik(blens, tipP, sched, pack, pattern_weights, reduce=None):
    """(logL, lp) of one topology: transition tensors, the down pass with
    its site-logL epilogue (no tip rows), the weighted sum (over the rank
    group with ``reduce``, finalize_loglik)."""
    P = transition_tensors(blens.to(tipP.dtype), pack)
    dp = down_pass(P, tipP, sched, pack=pack, tips=False)
    return finalize_loglik(site_lp(dp), pattern_weights,
                           asc_mask=pack.get("asc_mask"),
                           asc_nsites=pack.get("asc_nsites"), reduce=reduce)


# ------------------------------------------------------------- theta buffers
def edge_down_partials(dp: DownPass, edge_src):
    """Per-edge child-side partials and scale counts (one gather; dp needs
    its tip rows)."""
    src = edge_src.long()
    return dp.all[src], dp.scale[src]


def edge_thetas(up: UpPass, dp: DownPass, edge_src, pack) -> Thetas:
    """theta_e(c,k,p) = (sum_x E_e(c,x,p) U(c,x,k)) (sum_y V(c,k,y) D_e(c,y,p))
    for every edge at once, from both passes' E (plain torch; theta_pass
    computes the same inside the sweep). Branch likelihood:
    f(t) = sum_k theta_k exp(lambda_k r_c t) per category."""
    cat_mix = pack["cat_mix"]
    D, Dsc = edge_down_partials(dp, edge_src)
    theta, scale = kernels.edge_theta_plain(
        up.edge_E, up.edge_E_scale, D, Dsc, pack["U"][cat_mix],
        pack["V"][cat_mix])
    return Thetas(theta, scale)


def branch_lh_derivs(theta, scale, t, pack, log_ptn_invar, pattern_weights,
                     order: int = 2, reduce=None):
    """logL(t) of branches from their theta buffers, with d/dt and d2/dt2.

    theta [..., C, K, Pp]; scale [..., Pp]; t [...] (one length per leading
    index, e.g. every edge at once). Returns (logL, d1, d2) of shape [...]
    (d1 = d2 = None for order 0). Includes the Lewis +ASC terms when the
    pack carries asc_mask. With ``reduce`` (see summed) the patterns are a
    rank's slice: the pattern sums (logL, d1, d2 and the +ASC s, s1, s2)
    cross the ranks in one call before they are used. Reference:
    computeLikelihoodDervSIMD (tree/phylokernelnew.h:2235, :3196).
    """
    dtype = theta.dtype
    _, _, log_rescale = scaling_consts(dtype)
    lr = pack["eigvals"][pack["cat_mix"]] * pack["cat_rate"][:, None]  # [C, K]
    wet = pack["cat_weight"][:, None] * torch.exp(lr * t[..., None, None])
    sc = scale.to(dtype) * log_rescale
    tiny = torch.finfo(dtype).tiny
    asc_mask = pack.get("asc_mask")
    if order == 0:
        site0 = torch.einsum("...ckp,...ck->...p", theta, wet).clamp(min=0.0)
        lp = torch.logaddexp(torch.log(site0.clamp(min=tiny)) - sc,
                             log_ptn_invar)
        logL = (pattern_weights * lp).sum(-1)
        if asc_mask is None:
            (logL,) = summed(reduce, logL)
            return logL, None, None
        prob_unobs = (asc_mask * torch.exp(lp)).sum(-1)
        logL, prob_unobs = summed(reduce, logL, prob_unobs)
        logL = logL - pack["asc_nsites"] * torch.log1p(
            -prob_unobs.clamp(max=1.0 - 1e-10))
        return logL, None, None
    # one pass over theta (the large array) for all three t-derivative sums
    coef = torch.stack([wet, wet * lr, wet * lr * lr], dim=-1)  # [..., C, K, 3]
    s012 = torch.einsum("...ckp,...ckj->...jp", theta, coef)
    site0 = s012[..., 0, :].clamp(min=0.0)
    lp = torch.logaddexp(torch.log(site0.clamp(min=tiny)) - sc, log_ptn_invar)
    logL = (pattern_weights * lp).sum(-1)
    # denom = site0 + inv * 2^{B sc}; overflow -> inf -> ratios 0 (the
    # scaled-out variable part is negligible against the invariant part)
    denom = site0 + torch.exp(log_ptn_invar + sc)
    d1p = s012[..., 1, :] / denom
    d2p = s012[..., 2, :] / denom - d1p * d1p
    d1 = (pattern_weights * d1p).sum(-1)
    d2 = (pattern_weights * d2p).sum(-1)
    if asc_mask is None:
        return summed(reduce, logL, d1, d2)
    # d/dt of -N log(1 - s), s = sum_x e^{lp_x}
    sx = asc_mask * torch.exp(lp)
    s = sx.sum(-1)
    s1 = (sx * d1p).sum(-1)
    s2 = (sx * (d2p + d1p * d1p)).sum(-1)
    logL, d1, d2, s, s1, s2 = summed(reduce, logL, d1, d2, s, s1, s2)
    N = pack["asc_nsites"]
    om = (1.0 - s).clamp(min=1e-10)
    logL = logL - N * torch.log(om)
    d1 = d1 + N * s1 / om
    d2 = d2 + N * (s2 / om + (s1 / om) ** 2)
    return logL, d1, d2


def newton_branch_step(theta, scale, t0, pack, log_ptn_invar,
                       pattern_weights, t_min, t_max, n_iter: int = 4,
                       reduce=None):
    """A few bounded Newton iterations on every branch length of ``t0``
    at once (leading axes as in branch_lh_derivs; with ``reduce`` each
    iteration's d1 and d2 are summed over the rank group, so every rank
    takes the same steps). Mirrors minimizeNewton
    (utils/optimization.cpp:422): with the wrong curvature, step
    geometrically toward the bound the gradient points at."""
    def derivs(t):
        return branch_lh_derivs(theta, scale, t, pack, log_ptn_invar,
                                pattern_weights, reduce=reduce)[1:]
    return _newton_iter(derivs, t0, t_min, t_max, n_iter)


def branch_site_lp(theta, scale, t, pack, log_ptn_invar):
    """Per-pattern log-likelihood [..., Pp] of branches from their theta
    buffers (SH-aLRT / RELL resampling of NNI alternatives)."""
    dtype = theta.dtype
    _, _, log_rescale = scaling_consts(dtype)
    lr = pack["eigvals"][pack["cat_mix"]] * pack["cat_rate"][:, None]
    wet = pack["cat_weight"][:, None] * torch.exp(lr * t[..., None, None])
    site0 = torch.einsum("...ckp,...ck->...p", theta, wet).clamp(min=0.0)
    sc = scale.to(dtype) * log_rescale
    tiny = torch.finfo(dtype).tiny
    return torch.logaddexp(torch.log(site0.clamp(min=tiny)) - sc,
                           log_ptn_invar)


# ------------------------------------------- nonreversible branch derivatives
def _newton_iter(derivs, t, t_min, t_max, n_iter: int):
    """Bounded Newton on t (any shape) from derivs(t) -> (d1, d2): with the
    wrong curvature, step geometrically toward the bound the gradient
    points at (minimizeNewton, utils/optimization.cpp:422)."""
    for _ in range(n_iter):
        d1, d2 = derivs(t)
        newton_t = t - d1 / d2
        bad = (d2 >= 0) | ~torch.isfinite(newton_t)
        fallback = torch.where(d1 > 0, (t * 4.0).clamp(max=t_max),
                               (t * 0.25).clamp(min=t_min))
        t = torch.where(bad, fallback, newton_t.clamp(t_min, t_max))
    return t


def _nonrev_site0(down, out, t, pack):
    """(site0 [..., Pp], out^T P per category, P, rQ) of branches of length
    t [...] between the outside partials ``out`` and the down partials
    ``down`` [..., C, S, Pp]: site0 = sum_c w_c out_c . P_c(t) . down_c."""
    rQ = pack["Q"][pack["cat_mix"]] * pack["cat_rate"][:, None, None]
    A = pack["Q"][pack["cat_mix"]] * (pack["cat_rate"][:, None, None]
                                      * t[..., None, None, None])
    P = expm_ss(A)                                           # [..., C, S, S]
    outP = torch.matmul(P.transpose(-1, -2), out)            # [..., C, S, Pp]
    w = pack["cat_weight"][:, None, None]
    return (w * outP * down).sum((-3, -2)).clamp(min=0.0), P, rQ


def _finish_lp(site0, scale, log_ptn_invar):
    dtype = site0.dtype
    _, _, log_rescale = scaling_consts(dtype)
    sc = scale.to(dtype) * log_rescale
    tiny = torch.finfo(dtype).tiny
    return torch.logaddexp(torch.log(site0.clamp(min=tiny)) - sc,
                           log_ptn_invar), sc


def branch_lh_derivs_nonrev(down, out, scale, t, pack, log_ptn_invar,
                            pattern_weights, order: int = 2):
    """logL(t) of branches under a nonreversible model (no eigenbasis),
    with d/dt and d2/dt2 through dP/dt = (r Q) P per category: site0 =
    out . P(t) . down, site1 = out . rQ P . down, site2 = out . rQ rQ P .
    down. down/out [..., C, S, Pp], scale [..., Pp], t [...]; returns
    (logL, d1, d2) of shape [...] (d1 = d2 = None for order 0). Reference
    analog: the nonreversible derivative kernels
    (tree/phylokernelnonrev.h)."""
    site0, P, rQ = _nonrev_site0(down, out, t, pack)
    lp, sc = _finish_lp(site0, scale, log_ptn_invar)
    logL = (pattern_weights * lp).sum(-1)
    if order == 0:
        return logL, None, None
    rQt = rQ.transpose(-1, -2)
    Pt = P.transpose(-1, -2)
    q1 = torch.matmul(rQt, out)
    q2 = torch.matmul(rQt, q1)
    w = pack["cat_weight"][:, None, None]
    site1 = (w * torch.matmul(Pt, q1) * down).sum((-3, -2))
    site2 = (w * torch.matmul(Pt, q2) * down).sum((-3, -2))
    denom = site0 + torch.exp(log_ptn_invar + sc)
    d1p = site1 / denom
    d2p = site2 / denom - d1p * d1p
    return (logL, (pattern_weights * d1p).sum(-1),
            (pattern_weights * d2p).sum(-1))


def newton_branch_step_nonrev(down, out, scale, t0, pack, log_ptn_invar,
                              pattern_weights, t_min, t_max,
                              n_iter: int = 4):
    """A few bounded Newton iterations on every branch of ``t0`` at once
    under a nonreversible model (leading axes as in
    branch_lh_derivs_nonrev)."""
    def derivs(t):
        return branch_lh_derivs_nonrev(down, out, scale, t, pack,
                                       log_ptn_invar, pattern_weights)[1:]
    return _newton_iter(derivs, t0, t_min, t_max, n_iter)


def branch_site_lp_nonrev(down, out, scale, t, pack, log_ptn_invar):
    """Per-pattern log-likelihood [..., Pp] of branches under a
    nonreversible model: site0 = out . P(t) . down."""
    site0, _, _ = _nonrev_site0(down, out, t, pack)
    return _finish_lp(site0, scale, log_ptn_invar)[0]


# ------------------------------------------------ mixlen branch derivatives
def branch_lh_derivs_mixlen(theta, scale, tvec, pack, log_ptn_invar,
                            pattern_weights):
    """Per-category branch derivatives of the heterotachy (+H) models:
    theta [..., C, K, Pp], tvec [..., C] (one length per category);
    returns (logL [...], d1 [..., C], d2 [..., C]), the partial derivatives
    per category with the cross terms through the site likelihood's
    denominator kept (exact coordinate Newton). Reference analog:
    computeLikelihoodDervMixlen (tree/phylotreemixlen.cpp)."""
    lr = pack["eigvals"][pack["cat_mix"]] * pack["cat_rate"][:, None]  # [C, K]
    wet = pack["cat_weight"][:, None] * torch.exp(lr * tvec[..., None])
    s0c = (theta * wet[..., None]).sum(-2)                       # [..., C, Pp]
    site0 = s0c.sum(-2).clamp(min=0.0)
    lp, sc = _finish_lp(site0, scale, log_ptn_invar)
    logL = (pattern_weights * lp).sum(-1)
    s1c = (theta * (wet * lr)[..., None]).sum(-2)
    s2c = (theta * (wet * lr * lr)[..., None]).sum(-2)
    denom = (site0 + torch.exp(log_ptn_invar + sc))[..., None, :]
    d1p = s1c / denom
    d2p = s2c / denom - d1p * d1p
    return (logL, (pattern_weights * d1p).sum(-1),
            (pattern_weights * d2p).sum(-1))


def newton_branch_step_mixlen(theta, scale, t0vec, pack, log_ptn_invar,
                              pattern_weights, t_min, t_max,
                              n_iter: int = 4):
    """Bounded coordinate Newton on the C per-category lengths of every
    branch jointly, each category's length stepped by its own d1/d2."""
    def derivs(t):
        return branch_lh_derivs_mixlen(theta, scale, t, pack, log_ptn_invar,
                                       pattern_weights)[1:]
    return _newton_iter(derivs, t0vec, t_min, t_max, n_iter)


def chunk_ranges(n: int, item_bytes: int, budget: int) -> list:
    """[a, b) ranges over n items of item_bytes each, at most ``budget``
    bytes a range (at least one item)."""
    m = max(1, int(budget // max(item_bytes, 1)))
    return [(i, min(n, i + m)) for i in range(0, n, m)]
