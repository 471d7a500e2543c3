"""Site-specific-frequency likelihood in plain PyTorch (PMSF pass 2):
counterpart of iqtree2_tpu/ops/sitespecific.py.

Every pattern p owns its own reversible eigensystem (lam[p], U[p], V[p])
built from shared exchangeabilities and per-site stationary frequencies.
An edge's message is therefore two pattern-batched contractions, into and
out of each pattern's eigenbasis, with the rate categories a broadcast
axis; P per (edge, category, pattern) is never formed (at 100 taxa x 10000
patterns it would take 12.8 GB in float32). The JAX module runs no Pallas
kernel (its passes are XLA scans over the nodes), so there is no Hopper
kernel here either: each pass is a loop over the level steps of
tree/schedule.py, one batch of einsums per step, as the port's plain
passes (ops/kernels.py) run, on whatever device the tensors are on.

Layouts are the JAX package's: partials [.., C, S, Pp] with the tips in
rows 0..L-1 of the unified buffer, int32 scale counts, the 2^-B
per-pattern rescale of ``prec.scaling_consts``; ``vmap`` over edges or
NNI candidates becomes an explicit leading axis.

Reference analog: the site-specific-model kernels
(tree/phylokernelsitemodel.h), used by PMSF (main/phyloanalysis.cpp:3744
computeSiteFrequencyModel).
"""

from __future__ import annotations

import numpy as np
import torch

from iqtree2_tpu_torch.ops.pruning import DownPass, Thetas, UpPass
from iqtree2_tpu_torch.ops.prec import scaling_consts

# bytes of the largest temporaries of one chunk of NNI candidates
CHUNK_BYTES = 1 << 29


def build_ssf_eigensystems(exch: np.ndarray, site_freqs: np.ndarray,
                           min_freq: float = 1e-4):
    """Per-pattern eigensystems from shared exchangeabilities (host numpy,
    float64; the JAX module's function unchanged).

    exch: [S, S] symmetric exchangeability matrix (zero diagonal);
    site_freqs: [P, S]. Returns (lam [P, S], U [P, S, S], V [P, S, S],
    f [P, S]), each Q normalized to mean rate 1 under its own frequencies
    (reference: ModelMarkov::decomposeRateMatrix per site class).
    """
    f = np.maximum(site_freqs, min_freq)
    f = f / f.sum(axis=1, keepdims=True)            # [P, S]
    S = exch.shape[0]
    Q = exch[None, :, :] * f[:, None, :]            # [P, S, S] off-diag
    Q[:, np.arange(S), np.arange(S)] = 0.0
    rowsum = Q.sum(axis=2)
    Q[:, np.arange(S), np.arange(S)] = -rowsum
    mu = np.einsum("ps,ps->p", f, rowsum)           # mean rate
    Q = Q / np.maximum(mu, 1e-12)[:, None, None]
    # symmetrize: B = D^{1/2} Q D^{-1/2} (D = diag(f)); eigh
    sq = np.sqrt(f)
    B = Q * (sq[:, :, None] / sq[:, None, :])
    B = 0.5 * (B + np.swapaxes(B, 1, 2))
    lam, W = np.linalg.eigh(B)                      # [P, S], [P, S, S]
    U = W / sq[:, :, None]                          # rows x, cols k
    V = np.swapaxes(W, 1, 2) * sq[:, None, :]       # V = W^T D^{1/2}
    return lam, U, V, f


def _expo(pk: dict, t):
    """exp(lam_p,k r_c t) [..., C, K, Pp] for lengths t [...]."""
    lr = pk["lam"].T[None] * pk["cat_rate"][:, None, None]   # [C, K, Pp]
    return torch.exp(lr * t[..., None, None, None])


def message(pk: dict, child, t):
    """U_p diag(e^{lam_p r_c t}) V_p child per pattern: child [..., C, S, Pp]
    and t [...] with the same leading axes."""
    b = torch.einsum("pks,...csp->...ckp", pk["V"], child)
    return torch.einsum("pxk,...ckp->...cxp", pk["U"], b * _expo(pk, t))


def message_T(pk: dict, out, t):
    """The transpose direction, V_p^T diag(e) U_p^T out (the up pass)."""
    b = torch.einsum("pxk,...cxp->...ckp", pk["U"], out)
    return torch.einsum("pks,...ckp->...csp", pk["V"], b * _expo(pk, t))


def _rescale(v, count, thresh, factor):
    """Per-(row, pattern) underflow rescale over the trailing [C, S]."""
    need = v.amax(dim=(-3, -2)) < thresh
    return (torch.where(need[..., None, None, :], v * factor, v),
            count + need.to(count.dtype))


def _tip_message(pk: dict, tipP, blens):
    """Leaf 0's message over edge 0 [C, S, Pp] (folded into the root)."""
    C = pk["cat_rate"].shape[0]
    return message(pk, tipP[0].expand(C, *tipP.shape[1:]), blens[0])


def down_pass(blens, tipP, sched, pk: dict) -> DownPass:
    """Post-order sweep, one batch per level step (contract of the JAX
    module's ssf_down_pass): the unified buffer with the tips broadcast
    over the categories in rows 0..L-1, scale counts zero there."""
    thresh, factor, _ = scaling_consts(tipP.dtype)
    child_src, child_edge = sched["child_src"], sched["child_edge"]
    n_int = child_src.shape[0]
    C = pk["cat_rate"].shape[0]
    L, S, Pp = tipP.shape
    ALL = torch.empty((L + n_int, C, S, Pp), dtype=tipP.dtype,
                      device=tipP.device)
    ALL[:L] = tipP[:, None]
    SC = torch.zeros((L + n_int, Pp), dtype=torch.int32, device=tipP.device)
    for row in sched["step_node"]:
        nid = row[row < n_int].long()
        if nid.numel() == 0:
            continue
        src = child_src[nid].long()                  # [g, 2]
        msg = message(pk, ALL[src], blens[child_edge[nid].long()])
        prod, sc = _rescale(msg[:, 0] * msg[:, 1],
                            SC[src[:, 0]] + SC[src[:, 1]], thresh, factor)
        ALL[L + nid] = prod
        SC[L + nid] = sc
    return DownPass(ALL, SC)


def up_pass(blens, dp: DownPass, tipP, sched, pk: dict) -> UpPass:
    """Pre-order outside partials (contract of the JAX module's
    ssf_up_pass): E per edge and UP per internal node with their scales,
    the root's set from the stationary frequencies first."""
    dtype = dp.all.dtype
    thresh, factor, _ = scaling_consts(dtype)
    child_src, child_edge = sched["child_src"], sched["child_edge"]
    n_int = child_src.shape[0]
    C = pk["cat_rate"].shape[0]
    L, S, Pp = tipP.shape
    n_edges = blens.shape[0]
    kw = dict(dtype=dtype, device=dp.all.device)
    rootf = pk["freqs"].T[None]                      # [1, S, Pp]
    UP = torch.zeros((n_int, C, S, Pp), **kw)
    UPS = torch.zeros((n_int, Pp), dtype=torch.int32, device=kw["device"])
    E = torch.zeros((n_edges, C, S, Pp), **kw)
    ES = torch.zeros((n_edges, Pp), dtype=torch.int32, device=kw["device"])
    UP[n_int - 1] = rootf * _tip_message(pk, tipP, blens)
    E[0] = rootf * dp.all[L + n_int - 1]
    ES[0] = dp.scale[L + n_int - 1]
    for s in range(sched["step_node"].shape[0] - 1, -1, -1):
        row = sched["step_node"][s]
        nid = row[row < n_int].long()
        if nid.numel() == 0:
            continue
        src = child_src[nid].long()                  # [g, 2]
        eid = child_edge[nid].long()
        t = blens[eid]
        msg = message(pk, dp.all[src], t)
        Es, Esc = _rescale(UP[nid][:, None] * msg.flip(1),
                           UPS[nid][:, None] + dp.scale[src].flip(1),
                           thresh, factor)
        E[eid] = Es
        ES[eid] = Esc
        upc, upc_sc = _rescale(message_T(pk, Es, t), Esc, thresh, factor)
        is_int = src >= L
        UP[src[is_int] - L] = upc[is_int]
        UPS[src[is_int] - L] = upc_sc[is_int]
    return UpPass(E, ES, UP, UPS)


def site_lp(dp: DownPass, blens, tipP, pk: dict):
    """Per-pattern log-likelihoods [Pp] from a down pass (the JAX module's
    ssf_root_loglik before its weighted sum)."""
    dtype = dp.all.dtype
    _, _, log_rescale = scaling_consts(dtype)
    root = dp.all.shape[0] - 1
    Broot = dp.all[root] * _tip_message(pk, tipP, blens)
    site = torch.einsum("c,px,cxp->p", pk["cat_weight"], pk["freqs"], Broot)
    tiny = torch.finfo(dtype).tiny
    lp = torch.log(site.clamp(min=tiny)) - dp.scale[root].to(dtype) \
        * log_rescale
    return torch.logaddexp(lp, pk["log_ptn_invar"])


def tree_loglik(blens, tipP, sched, pk: dict, pattern_weights):
    """(logL, lp [Pp]) of one topology."""
    lp = site_lp(down_pass(blens, tipP, sched, pk), blens, tipP, pk)
    return (pattern_weights * lp).sum(), lp


def edge_thetas(up: UpPass, dp: DownPass, edge_src, pk: dict) -> Thetas:
    """theta_e(c,k,p) = (E_e U_p)_k (V_p D_e)_k in each pattern's
    eigenbasis, for every edge at once."""
    down = dp.all[edge_src.long()]
    a = torch.einsum("pxk,ecxp->eckp", pk["U"], up.edge_E)
    b = torch.einsum("pks,ecsp->eckp", pk["V"], down)
    return Thetas(a * b, up.edge_E_scale + dp.scale[edge_src.long()])


def branch_lh_derivs(theta, scale, t, pk: dict, pattern_weights,
                     order: int = 2):
    """logL of branches from their theta buffers [..., C, K, Pp] at lengths
    t [...], with d/dt and d2/dt2 (None for order 0)."""
    dtype = theta.dtype
    _, _, log_rescale = scaling_consts(dtype)
    lr = pk["lam"].T[None] * pk["cat_rate"][:, None, None]   # [C, K, Pp]
    et = torch.exp(lr * t[..., None, None, None]) \
        * pk["cat_weight"][:, None, None]
    te = theta * et
    site0 = te.sum((-3, -2)).clamp(min=0.0)
    sc = scale.to(dtype) * log_rescale
    tiny = torch.finfo(dtype).tiny
    lp = torch.logaddexp(torch.log(site0.clamp(min=tiny)) - sc,
                         pk["log_ptn_invar"])
    logL = (pattern_weights * lp).sum(-1)
    if order == 0:
        return logL, None, None
    site1 = (te * lr).sum((-3, -2))
    site2 = (te * lr * lr).sum((-3, -2))
    denom = site0 + torch.exp(pk["log_ptn_invar"] + sc)
    d1p = site1 / denom
    d2p = site2 / denom - d1p * d1p
    return (logL, (pattern_weights * d1p).sum(-1),
            (pattern_weights * d2p).sum(-1))


def newton_branch_step(theta, scale, t0, pk: dict, pattern_weights, t_min,
                       t_max, n_iter: int = 4):
    """Bounded Newton iterations on every branch length of t0 at once;
    with the wrong curvature, step geometrically toward the bound the
    gradient points at (minimizeNewton, utils/optimization.cpp:422)."""
    t = t0
    for _ in range(n_iter):
        _, d1, d2 = branch_lh_derivs(theta, scale, t, pk, pattern_weights)
        newton_t = t - d1 / d2
        bad = (d2 >= 0) | ~torch.isfinite(newton_t)
        fallback = torch.where(d1 > 0, (t * 4.0).clamp(max=t_max),
                               (t * 0.25).clamp(min=t_min))
        t = torch.where(bad, fallback, newton_t.clamp(t_min, t_max))
    return t


def evaluate_nnis(cand_arrays, blens, dp: DownPass, up: UpPass, sched,
                  pk: dict, pattern_weights, t_min, t_max,
                  n_newton: int = 4):
    """NNI1 scoring under the site-specific model (contract of the JAX
    module's ssf_evaluate_nnis): per candidate the two swaps and the
    current topology (column 2), the central branch Newton-optimised.
    cand_arrays [4, n] (iu, iv, slot_c, edge id). Returns (logl [n, 3],
    t_opt [n, 3]); the candidates go in chunks of CHUNK_BYTES."""
    ca = torch.as_tensor(np.asarray(cand_arrays), dtype=torch.int64,
                         device=blens.device)
    child_src = sched["child_src"].long()
    child_edge = sched["child_edge"].long()
    _, C, S, Pp = dp.all.shape
    # the largest temporaries: three variants' thetas and products
    per_cand = 8 * 3 * C * S * Pp * dp.all.element_size()
    chunk = max(1, CHUNK_BYTES // per_cand)
    logl, t_opt = [], []
    for lo in range(0, ca.shape[1], chunk):
        iu, iv, slot_c, eid = ca[:, lo: lo + chunk]

        def gmsg(src, e):
            return message(pk, dp.all[src], blens[e]), dp.scale[src]

        m_a, s_a = gmsg(child_src[iu, 0], child_edge[iu, 0])
        m_b, s_b = gmsg(child_src[iu, 1], child_edge[iu, 1])
        m_c, s_c = gmsg(child_src[iv, slot_c], child_edge[iv, slot_c])
        rest, s_rest = up.up_in[iv], up.up_scale[iv]
        # down side, outside side of the central branch, per variant
        down = torch.stack([m_a * m_c, m_b * m_c, m_a * m_b], 1)
        s_down = torch.stack([s_a + s_c, s_b + s_c, s_a + s_b], 1)
        out = rest[:, None] * torch.stack([m_b, m_a, m_c], 1)
        s_out = s_rest[:, None] + torch.stack([s_b, s_a, s_c], 1)
        theta = torch.einsum("pxk,nvcxp->nvckp", pk["U"], out) \
            * torch.einsum("pks,nvcsp->nvckp", pk["V"], down)
        scale = s_down + s_out
        t0 = blens[eid][:, None].expand(-1, 3)
        t = newton_branch_step(theta, scale, t0, pk, pattern_weights,
                               t_min, t_max, n_iter=n_newton)
        logl.append(branch_lh_derivs(theta, scale, t, pk, pattern_weights,
                                     order=0)[0])
        t_opt.append(t)
    return torch.cat(logl), torch.cat(t_opt)
