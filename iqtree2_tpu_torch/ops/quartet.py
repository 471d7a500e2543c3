"""Likelihood mapping: batched quartet likelihoods on the engine's device.

Reference analog: doLikelihoodMapping (tree/quartet.cpp:1365): sample
quartets (a,b,c,d), compute the ML logL of the three quartet topologies
(ab|cd), (ac|bd), (ad|bc), convert to posterior weights, and map each
quartet onto the barycentric simplex — corner/edge/center region counts
diagnose tree-likeness of the data.

Counterpart of iqtree2_tpu/ops/quartet.py, whose quartet Newton is XLA
(jax.vmap of jax.hessian), not a Pallas kernel: here it is plain torch,
every (quartet, topology) pair a row of one batch. The rows' objectives
are independent, so the gradient of their sum is each row's gradient and
five more backward passes give each row's 5 x 5 Hessian; the Newton step
is the JAX function's (a 1e-3 ridge, the step clipped to +-2, a gradient
step where the solve is not finite, log-lengths clipped to [log 1e-6,
log 9], n_iter iterations). The messages are batched matrix products
over [C, S, S] x [S, P]. likelihood_mapping and write_lmap_svg are copied
from the JAX module, the quartets run on the engine's float64 view: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from iqtree2_tpu_torch.ops import pruning

# the three quartet topologies as orders of (a, b, c, d): ab|cd, ac|bd,
# ad|bc
TOPOLOGY_ORDERS = ((0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2))
RIDGE = 1e-3
MAX_STEP = 2.0
GRADIENT_STEP = 0.1
LOG_T_MIN, LOG_T_MAX = math.log(1e-6), math.log(9.0)


def _quartet_logls(x, tips, pack, pw):
    """[B] logL of B quartet topologies given their log branch lengths
    x [B, 5] (ta, tb, tc, td, tm) and leaf partials tips [B, 4, S, P] in
    topology order (a, b | c, d, the central edge between)."""
    B = x.shape[0]
    P5 = pruning.transition_tensors(torch.exp(x).reshape(-1), pack)
    P5 = P5.reshape(B, 5, *P5.shape[1:])                   # [B, 5, C, S, S]

    def msg(k, L):                                         # L [B, S, P]
        return torch.matmul(P5[:, k], L[:, None])          # [B, C, S, P]

    pu = msg(0, tips[:, 0]) * msg(1, tips[:, 1])
    pv = msg(2, tips[:, 2]) * msg(3, tips[:, 3])
    mv = torch.matmul(P5[:, 4], pv)
    w = pack["cat_weight"][:, None] * pack["root_freqs"]   # [C, S]
    site = (w[None, :, :, None] * pu * mv).sum(dim=(1, 2))  # [B, P]
    lp = torch.log(site.clamp(min=torch.finfo(site.dtype).tiny))
    lp = torch.logaddexp(lp, pack["log_ptn_invar"])
    return (pw * lp).sum(-1)


def _grad_hess(x, tips, pack, pw):
    """(g [B, 5], H [B, 5, 5]) of the negative logLs [B]."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        f = -_quartet_logls(x, tips, pack, pw)
        g, = torch.autograd.grad(f.sum(), x, create_graph=True)
        rows = [torch.autograd.grad(g[:, k].sum(), x, retain_graph=k < 4)[0]
                for k in range(5)]
    return g.detach(), torch.stack(rows, dim=1).detach()


def quartet_topology_logls(tip_idx, tipP, pack, pw, t_init: float = 0.1,
                           n_iter: int = 5):
    """[Q, 4] taxon indices -> [Q, 3] optimized topology logLs.

    Branch lengths optimized per (quartet, topology) by full Newton on the
    5-vector of log lengths (counterpart of the JAX function's jitted
    vmap of jax.grad and jax.hessian)."""
    idx = torch.as_tensor(np.asarray(tip_idx), dtype=torch.long,
                          device=tipP.device)
    Q = idx.shape[0]
    order = torch.as_tensor(TOPOLOGY_ORDERS, dtype=torch.long,
                            device=tipP.device)
    # [Q, 3, 4] taxa of each topology in its order, flattened to rows
    taxa = idx[:, order].reshape(Q * 3, 4)
    tips = tipP[taxa]                                      # [B, 4, S, P]
    x = torch.full((Q * 3, 5), math.log(t_init), dtype=tipP.dtype,
                   device=tipP.device)
    eye = torch.eye(5, dtype=tipP.dtype, device=tipP.device)
    for _ in range(n_iter):
        g, H = _grad_hess(x, tips, pack, pw)
        dx, info = torch.linalg.solve_ex(H + RIDGE * eye, g)
        ok = (info == 0)[:, None] & torch.isfinite(dx).all(-1, keepdim=True)
        x = torch.where(ok, x - dx.clamp(-MAX_STEP, MAX_STEP),
                        x - GRADIENT_STEP * g)
        x = x.clamp(LOG_T_MIN, LOG_T_MAX)
    with torch.no_grad():
        return _quartet_logls(x, tips, pack, pw).reshape(Q, 3)


def likelihood_mapping(eng, n_quartets: int = 1000,
                       rng: np.random.Generator | None = None,
                       chunk: int = 128):
    """Sample quartets, compute topology weights, bin into the 7 simplex
    regions. Returns dict with regions, weights, quartet indices. The
    quartets run on the engine's float64 view (LikelihoodEngine.precise):
    in float32 the rounding moves the five Newton steps' path, and with it
    a balanced quartet's weights by up to 2.6e-3 (1000 quartets of
    example.phy on an H100, against the CPU's float64)."""
    if rng is None:
        rng = np.random.default_rng(1)
    L = eng.aln.ntaxa
    if L < 4:
        raise ValueError("likelihood mapping needs >= 4 taxa")
    qs = np.stack([rng.choice(L, size=4, replace=False)
                   for _ in range(n_quartets)]).astype(np.int32)
    logls = np.zeros((n_quartets, 3))
    view = eng.precise()
    for i in range(0, n_quartets, chunk):
        out = quartet_topology_logls(qs[i:i + chunk], view._tipP,
                                     view._pack, view._pw, 0.1)
        logls[i:i + chunk] = out.cpu().numpy().astype(np.float64)

    m = logls.max(axis=1, keepdims=True)
    wts = np.exp(logls - m)
    wts /= wts.sum(axis=1, keepdims=True)

    regions = np.zeros(7, dtype=np.int64)
    for w in wts:
        regions[region_of(w)] += 1
    return {"regions": regions, "weights": wts, "quartets": qs,
            "logls": logls}


def region_of(w: np.ndarray) -> int:
    """The simplex region of one quartet's three topology weights, one of
    7 (Strimmer & von Haeseler 1997): 0-2 the corners (resolved), 3-5 the
    edges (partly resolved), 6 the center (star-like)."""
    order = np.argsort(-w)
    if w[order[0]] > 2.0 / 3.0 or (w[order[0]] > 0.5 and
                                   w[order[1]] < 1.0 / 6.0):
        return int(order[0])                          # corner 1..3
    if w[order[2]] < 1.0 / 6.0:
        pair = tuple(sorted(order[:2]))
        return {(0, 1): 3, (0, 2): 4, (1, 2): 5}[pair]  # edge regions
    return 6                                          # center


def write_lmap_svg(path, wts: np.ndarray) -> None:
    """Simplex scatter plot of quartet weights (.lmap.svg analog)."""
    W, H = 500, 460
    # triangle corners
    ax, ay = W / 2, 30
    bx, by = 40, H - 30
    cx, cy = W - 40, H - 30
    pts = []
    for w in wts:
        x = w[0] * ax + w[1] * bx + w[2] * cx
        y = w[0] * ay + w[1] * by + w[2] * cy
        pts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="1.5" '
                   'fill="#1f6feb" fill-opacity="0.5"/>')
    svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
           f'height="{H}">'
           f'<polygon points="{ax},{ay} {bx},{by} {cx},{cy}" fill="none" '
           'stroke="black"/>' + "".join(pts) +
           '<text x="10" y="20" font-size="12">likelihood mapping: '
           'corners = resolved quartets</text></svg>')
    with open(path, "w") as f:
        f.write(svg)
