"""Batched NNI candidate scoring (counterpart of iqtree2_tpu/ops/nni.py).

For every internal edge e = (u child, v parent) both NNI rearrangements and
the unchanged topology are scored at once from the down-pass partials and
the up-pass outside partials, with no per-candidate tree traversal. Around
e the four subtrees are (a, b | c, d): a, b the children of u, c the other
child of v, d the rest above v. Variant 0 swaps b and c, variant 1 swaps a
and c, column 2 is the baseline.

The JAX package vmaps a per-candidate function over candidates and over the
three variants; here both are explicit leading axes [n, 3] of every tensor,
and the candidate axis is cut into chunks whose temporaries fit
CHUNK_BYTES. Every candidate is computed independently, so the chunking
changes no result beyond rounding (a batched GEMM may sum in another order
for another batch size). This is plain torch, as it is plain XLA in the JAX
package; the partials come from the pruning kernels' passes.

Reference analog: getBestNNIForBran (tree/phylotree.cpp:4058), NNI1 and
NNI5 modes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from iqtree2_tpu_torch.ops import pruning
from iqtree2_tpu_torch.ops.prec import scaling_consts
from iqtree2_tpu_torch.tree.schedule import TreeSchedule
from iqtree2_tpu_torch.tree.topology import Tree

# memory for one chunk's temporaries; a candidate holds about SLABS_NNI1 or
# SLABS_NNI5 [C, S, Pp] tensors at once over its three variants (the
# five-branch Newton keeps three subtree partials and their messages per
# variant, plus the theta products of each Newton step)
CHUNK_BYTES = 4 * 2**30
SLABS_NNI1 = 32
SLABS_NNI5 = 64
# the branch roles (x1, x2, x3) of each variant as slots of t5 = (a, b, c,
# d, e): u' children = (x1, x2), v' children = (u', x3)
_IDX1, _IDX2, _IDX3 = (0, 1, 0), (2, 2, 1), (1, 0, 2)


class NNICandidates(NamedTuple):
    """Host-built index arrays, one row per internal edge."""
    iu: np.ndarray        # [n] postorder index of the child node u
    iv: np.ndarray        # [n] postorder index of the parent node v
    slot_c: np.ndarray    # [n] slot of the sibling c at v (u is 1-slot_c)
    edge_id: np.ndarray   # [n] central edge id
    nodes_u: list         # host node ids, for applying moves
    nodes_v: list


def build_nni_candidates(tree: Tree, sched: TreeSchedule) -> NNICandidates:
    """Every internal edge of ``tree`` as an NNI candidate (copied from
    iqtree2_tpu.ops.nni, whose module imports jax)."""
    L = sched.ntaxa
    order_idx = {v: i for i, v in enumerate(sched.postorder_nodes)}
    rows = []
    nodes_u, nodes_v = [], []
    for e, pair in enumerate(sched.edge_nodes):
        if pair is None:
            continue
        u, v = pair
        if tree.is_leaf(u) or tree.is_leaf(v):
            continue
        iv = order_idx[v]
        k_u = 0 if int(sched.child_edge[iv, 0]) == e else 1
        # internal node u owns edge L + postorder(u)
        rows.append((e - L, iv, 1 - k_u, e))
        nodes_u.append(u)
        nodes_v.append(v)
    if not rows:
        z = np.zeros(0, np.int32)
        return NNICandidates(z, z, z, z, [], [])
    arr = np.asarray(rows, dtype=np.int32)
    return NNICandidates(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3],
                         nodes_u, nodes_v)


def candidate_rows(cand_arrays, device) -> torch.Tensor:
    """A [4, n] array of (iu, iv, slot_c, edge_id) as an int64 tensor on
    ``device``."""
    return torch.as_tensor(np.asarray(cand_arrays), dtype=torch.int64,
                           device=device)


def _chunks(n: int, dp: pruning.DownPass, slabs: int):
    return pruning.chunk_ranges(
        n, slabs * dp.all[0].numel() * dp.all.element_size(), CHUNK_BYTES)


def _theta(out, down, pack):
    """theta = (U^T out) (V down) per category and eigencomponent."""
    cm = pack["cat_mix"]
    return (torch.matmul(pack["U"][cm].transpose(-1, -2), out)
            * torch.matmul(pack["V"][cm], down))


def _rescale(x, sc, thresh, factor):
    """Per-pattern underflow rescale over the trailing [C, S] block."""
    need = x.amax(dim=(-3, -2)) < thresh
    return (torch.where(need[..., None, None, :], x * factor, x),
            sc + need.to(sc.dtype))


def _cat(parts, n, tail, dtype, device):
    if parts:
        return torch.cat(parts)
    return torch.zeros((n, *tail), dtype=dtype, device=device)


def _branch_fns(pack, log_inv, pattern_weights, t_min, t_max, n_newton: int,
                nonrev: bool, mixlen: bool, reduce=None):
    """(operand(out, down) -> x, newton(x, scale, t), score(x, scale, t,
    want_lp) -> (logl, site lp or None)) of a branch between an outside and
    a down partial: x is the eigenbasis theta for a reversible model (per
    category for mixlen, t then [..., C]), the two partials themselves for
    a nonreversible one (the direct derivatives). With ``reduce``
    (pruning.summed) the partials hold a rank's slice of the patterns and
    the Newton sums and logLs cross the ranks: a reversible model's
    scalar-length path alone, as the JAX package's axis_name."""
    if reduce is not None and (nonrev or mixlen):
        raise NotImplementedError(
            "NNI scoring over a rank group under a nonreversible or "
            "per-class-length model: the JAX package sums no mesh axis "
            "there either")
    if nonrev:
        def operand(out, down):
            return out, down

        def newton(x, sc, t):
            return pruning.newton_branch_step_nonrev(
                x[1], x[0], sc, t, pack, log_inv, pattern_weights, t_min,
                t_max, n_iter=n_newton)

        def score(x, sc, t, want_lp):
            logl = pruning.branch_lh_derivs_nonrev(
                x[1], x[0], sc, t, pack, log_inv, pattern_weights,
                order=0)[0]
            return logl, (pruning.branch_site_lp_nonrev(
                x[1], x[0], sc, t, pack, log_inv) if want_lp else None)
        return operand, newton, score
    step = (pruning.newton_branch_step_mixlen if mixlen
            else pruning.newton_branch_step)

    def operand(out, down):
        return _theta(out, down, pack)

    kw = {} if mixlen else {"reduce": reduce}

    def newton(theta, sc, t):
        return step(theta, sc, t, pack, log_inv, pattern_weights, t_min,
                    t_max, n_iter=n_newton, **kw)

    def score(theta, sc, t, want_lp):
        if mixlen:
            return pruning.branch_lh_derivs_mixlen(
                theta, sc, t, pack, log_inv, pattern_weights)[0], None
        logl = pruning.branch_lh_derivs(theta, sc, t, pack, log_inv,
                                        pattern_weights, order=0,
                                        reduce=reduce)[0]
        return logl, (pruning.branch_site_lp(theta, sc, t, pack, log_inv)
                      if want_lp else None)
    return operand, newton, score


def _refuse_mixlen_lp(mixlen: bool, return_site_lp: bool) -> None:
    if mixlen and return_site_lp:
        raise NotImplementedError(
            "per-pattern NNI logLs under per-class lengths (+H): the JAX "
            "package returns none either")


def evaluate_nnis(cand_arrays, blens, dp: pruning.DownPass, up_in, up_scale,
                  sched, pack, pattern_weights, t_min, t_max,
                  n_newton: int = 4, return_site_lp: bool = False,
                  nonrev: bool = False, mixlen: bool = False, reduce=None):
    """NNI1: both variants and the baseline with the central branch
    re-optimised, for every candidate. Returns (logl [n, 3], t_opt [n, 3])
    and with return_site_lp also per-pattern logLs [n, 3, Pp]. ``nonrev``
    scores through the direct derivatives (a model with pack["Q"]; the JAX
    package returns no per-pattern logLs there, this port does);
    ``mixlen`` takes blens [E, C] and returns t_opt [n, 3, C]. With
    ``reduce`` the buffers hold a rank's slice of the patterns
    (parallel/shard.sharded_nni_fn): every rank must give the same
    candidates and an equal slice width, so that the chunks, and with
    them the calls of ``reduce``, are the same on every rank."""
    _refuse_mixlen_lp(mixlen, return_site_lp)
    rows = candidate_rows(cand_arrays, dp.all.device)
    dtype = dp.all.dtype
    P = pruning.transition_tensors(blens.to(dtype), pack)
    cs = sched["child_src"].long()
    ce = sched["child_edge"].long()
    log_inv = pack["log_ptn_invar"]
    operand, newton, score = _branch_fns(pack, log_inv, pattern_weights,
                                         t_min, t_max, n_newton, nonrev,
                                         mixlen, reduce)
    tail = tuple(blens.shape[1:])
    outs = ([], [], [])
    for a, b in _chunks(rows.shape[1], dp, SLABS_NNI1):
        iu, iv, slot, eid = rows[:, a:b]
        m_a, s_a = pruning.gather_messages(dp, P, cs[iu, 0], ce[iu, 0])
        m_b, s_b = pruning.gather_messages(dp, P, cs[iu, 1], ce[iu, 1])
        m_c, s_c = pruning.gather_messages(dp, P, cs[iv, slot], ce[iv, slot])
        rest, s_rest = up_in[iv], up_scale[iv]
        down = torch.stack([m_a * m_c, m_b * m_c, m_a * m_b], 1)
        out = torch.stack([rest * m_b, rest * m_a, rest * m_c], 1)
        scale = (torch.stack([s_a + s_c, s_b + s_c, s_a + s_b], 1)
                 + torch.stack([s_rest + s_b, s_rest + s_a, s_rest + s_c], 1))
        x = operand(out, down)
        t0 = blens[eid].to(dtype)[:, None].expand(-1, 3, *tail)
        t_opt = newton(x, scale, t0)
        logl, lp = score(x, scale, t_opt, return_site_lp)
        outs[0].append(logl)
        outs[1].append(t_opt)
        if return_site_lp:
            outs[2].append(lp)
    n, dev = rows.shape[1], dp.all.device
    res = (_cat(outs[0], n, (3,), dtype, dev),
           _cat(outs[1], n, (3, *tail), dtype, dev))
    if return_site_lp:
        res += (_cat(outs[2], n, (3, dp.all.shape[-1]), dtype, dev),)
    return res


def evaluate_nnis5(cand_arrays, blens, dp: pruning.DownPass,
                   up: pruning.UpPass, sched, pack, pattern_weights, t_min,
                   t_max, n_rounds: int = 2, n_newton: int = 2,
                   return_site_lp: bool = False, nonrev: bool = False,
                   mixlen: bool = False):
    """NNI5: both variants and the baseline with all five surrounding
    branches re-optimised by rounds of coordinate Newton (reference
    default, params.nni5).

    Returns (logl [n, 3], t_e [n, 3], t5 [n, 3, 5]) where t5 holds the
    lengths of (a, b, c, d, e): a, b the child edges of u, c the other child
    edge of v, d the parent edge of v (kept when v is the schedule root),
    e the central edge; with return_site_lp also per-pattern logLs
    [n, 3, Pp]. ``nonrev`` runs the same coordinate Newton on the direct
    derivatives; ``mixlen`` takes blens [E, C] and gives t_e [n, 3, C] and
    t5 [n, 3, 5, C].
    """
    _refuse_mixlen_lp(mixlen, return_site_lp)
    rows = candidate_rows(cand_arrays, dp.all.device)
    dtype, dev = dp.all.dtype, dp.all.device
    thresh, factor, _ = scaling_consts(dtype)
    cs = sched["child_src"].long()
    ce = sched["child_edge"].long()
    n_int = cs.shape[0]
    L = dp.all.shape[0] - n_int
    C, S, Pp = dp.all.shape[1:]
    log_inv = pack["log_ptn_invar"]
    blens = blens.to(dtype)
    roles = (_IDX1, _IDX2, _IDX3)
    idx = [torch.tensor(r, device=dev) for r in roles]

    def resc(x, sc):
        return _rescale(x, sc, thresh, factor)

    tail = tuple(blens.shape[1:])          # (C,) under mixlen
    ones = (1,) * len(tail)

    def trans(t):
        """P [m, 3, C, S, S] of lengths t [m, 3, *tail]."""
        return pruning.transition_tensors(t.reshape(-1, *tail), pack).view(
            *t.shape[:2], C, S, S)

    operand, newton_x, score = _branch_fns(pack, log_inv, pattern_weights,
                                           t_min, t_max, n_newton, nonrev,
                                           mixlen)

    def newton(out, down, sc, t):
        return newton_x(operand(out, down), sc, t)

    outs = ([], [], [], [])
    for a, b in _chunks(rows.shape[1], dp, SLABS_NNI5):
        iu, iv, slot, eid = rows[:, a:b]
        m = iu.shape[0]
        srcs = (cs[iu, 0], cs[iu, 1], cs[iv, slot])      # a, b, c
        p_abc = [dp.all[s] for s in srcs]
        s_abc = [dp.scale[s] for s in srcs]
        is_root = iv == n_int - 1
        ed = torch.where(is_root, 0, L + iv)               # v's parent edge
        E_d, s_Ed = up.edge_E[ed][:, None], up.edge_E_scale[ed][:, None]
        root5 = is_root[:, None, None, None, None]
        # at the root the fixed outside at v replaces P_d^T E_d
        out_root, s_out = up.up_in[iv][:, None], torch.where(
            is_root[:, None, None], up.up_scale[iv][:, None], s_Ed)
        t5 = torch.stack([blens[ce[iu, 0]], blens[ce[iu, 1]],
                          blens[ce[iv, slot]], blens[ed], blens[eid]],
                         1)[:, None].repeat(1, 3, 1, *ones)
        PX = [torch.stack([p_abc[i] for i in r], 1) for r in roles]
        SX = [torch.stack([s_abc[i] for i in r], 1) for r in roles]
        gi = [j.view(1, 3, 1, *ones).expand(m, 3, 1, *tail) for j in idx]
        keep_d = is_root.view(m, 1, *ones)

        def lengths(ts):
            return [ts.gather(2, g)[:, :, 0] for g in gi]

        def outside_v(td):
            return torch.where(root5, out_root, torch.matmul(
                trans(td).transpose(-1, -2), E_d))

        def around_e(ts):
            """Messages of x1, x2, x3 and the two sides of the central edge
            at the lengths ``ts``."""
            m1, m2, m3 = (torch.matmul(trans(t), px)
                          for t, px in zip(lengths(ts), PX))
            out_v = outside_v(ts[:, :, 3])
            down_u, s_du = resc(m1 * m2, SX[0] + SX[1])
            out_e, s_oe = resc(out_v * m3, s_out + SX[2])
            return m2, m3, out_v, down_u, s_du, out_e, s_oe

        ts = t5
        for _ in range(n_rounds):
            t1, t2, t3 = lengths(ts)
            td, te = ts[:, :, 3], ts[:, :, 4]
            m2, m3, out_v, down_u, s_du, out_e, s_oe = around_e(ts)
            te = newton(out_e, down_u, s_du + s_oe, te)
            Pe = trans(te)
            m_u = torch.matmul(Pe, down_u)
            out_3, s_o3 = resc(out_v * m_u, s_out + s_du)
            t3 = newton(out_3, PX[2], s_o3 + SX[2], t3)
            out_u = torch.matmul(Pe.transpose(-1, -2), out_e)
            o1, s_o1 = resc(out_u * m2, s_oe + SX[1])
            t1 = newton(o1, PX[0], s_o1 + SX[0], t1)
            o2, s_o2 = resc(out_u * torch.matmul(trans(t1), PX[0]),
                            s_oe + SX[0])
            t2 = newton(o2, PX[1], s_o2 + SX[1], t2)
            down_v, s_dv = resc(m_u * m3, s_du + SX[2])
            td = torch.where(keep_d, td,
                             newton(E_d, down_v, s_dv + s_Ed, td))
            ts = (ts.scatter(2, gi[0], t1[:, :, None])
                  .scatter(2, gi[1], t2[:, :, None])
                  .scatter(2, gi[2], t3[:, :, None]))
            ts = torch.cat([ts[:, :, :3], td[:, :, None], te[:, :, None]], 2)
        # the score at the optimised lengths
        _, _, _, down_u, s_du, out_e, s_oe = around_e(ts)
        logl, lp = score(operand(out_e, down_u), s_du + s_oe, ts[:, :, 4],
                         return_site_lp)
        outs[0].append(logl)
        outs[1].append(ts[:, :, 4])
        outs[2].append(ts)
        if return_site_lp:
            outs[3].append(lp)
    n = rows.shape[1]
    res = (_cat(outs[0], n, (3,), dtype, dev),
           _cat(outs[1], n, (3, *tail), dtype, dev),
           _cat(outs[2], n, (3, 5, *tail), dtype, dev))
    if return_site_lp:
        res += (_cat(outs[3], n, (3, Pp), dtype, dev),)
    return res
