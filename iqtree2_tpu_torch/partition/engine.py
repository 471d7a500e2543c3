"""PartitionEngine in PyTorch (counterpart of iqtree2_tpu/partition/engine.py).

A partitioned supermatrix on one shared tree: one port LikelihoodEngine
per partition (its own model pack, tip partials, pattern padding and so
its own instance of each pass kernel, so partitions may differ in the
number of rate categories and of states), and the partition loop on the
host. Every pass is still one kernel launch per partition; nothing is
packed across partitions.

Three linkage modes (CLI -q / -p / -Q):
  edge-equal:        one branch-length vector, r_k == 1
  edge-proportional: one branch-length vector, a free rate r_k per
                     partition (partition k's lengths are r_k * t)
  unlinked:          per-partition branch-length vectors on the shared
                     topology (optimised independently, logLs summed)

The model-parameter objectives (part_loglik, which the per-partition fits
of partition/optimize.py evaluate, and the Brent search on each r_k)
evaluate each partition engine's float64 view (LikelihoodEngine.precise(),
which the single-alignment alternation of model/optimize.py evaluates
too): in float32 the alternation stalls short (the JAX package's float32
fit stops 9 logL short on example.nex, and at 1000 taxa hundreds).

The linked modes' branch-length Newton is joint: every edge's derivatives
are summed over partitions by the chain rule through r_k,
d/dt logL = sum_k r_k dlogL_k/dt_k at t_k = r_k t (and r_k^2 on the second
derivative), each partition's theta buffers from its down pass and its
theta_pass. These sums, the NNI1 and NNI5 scoring around each candidate and
the Brent search on each r_k are plain torch and host code, as the JAX
package computes them in XLA outside any Pallas kernel.

Reference analogs: PhyloSuperTree (tree/phylosupertree.h:57, the
partition-parallel likelihood :701-777), PhyloSuperTreePlen (edge-linked
proportional partitions, tree/phylosupertreeplen.h:38),
PhyloSuperTreeUnlinked, PartitionModel / PartitionModelPlen
(model/partitionmodel.cpp).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from iqtree2_tpu_torch.data.superalignment import SuperAlignment
from iqtree2_tpu_torch.engine import (DEFAULT_MAX_BLEN, DEFAULT_MIN_BLEN,
                                      LikelihoodEngine, optimize_blens)
from iqtree2_tpu_torch.ops import nni, pruning
from iqtree2_tpu_torch.ops.prec import scaling_consts
from iqtree2_tpu_torch.tree.schedule import build_schedule, write_blens_to_tree
from iqtree2_tpu_torch.tree.topology import Tree
from iqtree2_tpu_torch.utils.optimize import brent_minimize

LINKAGES = ("edge-proportional", "edge-equal", "unlinked", "edge-linked")
RATE_MIN, RATE_MAX = 1e-3, 100.0    # the partition rates' bounds


def joint_newton(thetas, scales, t0, packs, pws, rks, t_min, t_max,
                 n_iter: int):
    """Bounded Newton on shared branch lengths t0 [...] (any leading axes,
    as pruning.newton_branch_step) with the derivatives summed over
    partitions through each partition's rate r_k (JAX _joint_newton)."""
    t = t0
    for _ in range(n_iter):
        d1, d2 = 0.0, 0.0
        for th, sc, pack, pw, rk in zip(thetas, scales, packs, pws, rks):
            _, d1k, d2k = pruning.branch_lh_derivs(
                th, sc, t * rk, pack, pack["log_ptn_invar"], pw)
            d1 = d1 + rk * d1k
            d2 = d2 + rk * rk * d2k
        newton_t = t - d1 / d2
        bad = (d2 >= 0) | ~torch.isfinite(newton_t)
        fallback = torch.where(d1 > 0, (t * 4.0).clamp(max=t_max),
                               (t * 0.25).clamp(min=t_min))
        t = torch.where(bad, fallback, newton_t.clamp(t_min, t_max))
    return t


def _chunks(n: int, dps, slabs: int):
    """Candidate ranges whose temporaries over every partition fit
    nni.CHUNK_BYTES."""
    per = sum(dp.all[0].numel() * dp.all.element_size() for dp in dps)
    m = max(1, int(nni.CHUNK_BYTES // (slabs * per)))
    return [(i, min(n, i + m)) for i in range(0, n, m)]


class PartitionEngine:
    """The parts of LikelihoodEngine that the search, the NNI climb, the
    model fits and the branch tests use, for a partitioned supermatrix."""

    def __init__(self, super_aln: SuperAlignment, models: list, rates: list,
                 partition_type: str = "edge-proportional",
                 dtype: torch.dtype = torch.float32, device="cuda",
                 asc_flags: list[bool] | None = None):
        if partition_type not in LINKAGES:
            raise ValueError(f"unknown partition type {partition_type!r}")
        if partition_type == "edge-linked":
            partition_type = "edge-proportional"
        self.aln = super_aln
        self.partition_type = partition_type
        self.models = models
        self.rates = rates
        self.dtype = dtype
        asc_flags = asc_flags or [False] * len(models)
        self.engines = [
            LikelihoodEngine(p, m, r, dtype=dtype, device=device, asc=a)
            for p, m, r, a in zip(super_aln.partitions, models, rates,
                                  asc_flags)]
        self.device = self.engines[0].device
        self.part_rates = np.ones(self.K, dtype=np.float64)
        w = np.array([p.nsites for p in super_aln.partitions], np.float64)
        self._site_w = w / w.sum()
        # unlinked mode: per-partition branch lengths of the current topology
        self._ul_blens: list[np.ndarray] | None = None
        self._ul_tid: str | None = None

    # -------------------------------------------------------------- helpers
    @property
    def K(self) -> int:
        return len(self.engines)

    @property
    def model(self):
        return self.models[0]

    def _rks(self) -> tuple:
        if self.partition_type == "edge-proportional":
            return tuple(float(r) for r in self.part_rates)
        return tuple(1.0 for _ in self.engines)

    def _packs(self):
        return [e._pack for e in self.engines]

    def _pws(self):
        return [e._pw for e in self.engines]

    def _sched(self, sched):
        """The schedule's device arrays (the same for every partition: they
        share the taxon set), cached per topology by the first engine."""
        return self.engines[0].schedule_arrays(sched)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def refresh_model(self, k: int | None = None) -> None:
        """Rebuild the model packs of partition k (all when None) after a
        parameter change."""
        for j in (range(self.K) if k is None else [k]):
            self.engines[j].refresh_model()

    def _part_blens(self, sched, tid=None) -> list:
        """Each partition's branch lengths: the unlinked mode's own (for
        topology ``tid`` when given), else the shared lengths times r_k."""
        if self.partition_type == "unlinked" and self._ul_blens is not None \
                and (tid is None or tid == self._ul_tid):
            return [self._tensor(b) for b in self._ul_blens]
        blens = self._tensor(sched.blens)
        return [blens * r for r in self._rks()]

    # ------------------------------------------------------------- loglik
    def _loglik(self, sched, bl_k) -> tuple[float, list]:
        sa = self._sched(sched)
        total, lps = 0.0, []
        for bl, e in zip(bl_k, self.engines):
            logL, lp = pruning.tree_loglik(bl, e._tipP, sa, e._pack, e._pw)
            total += float(logL)
            lps.append(lp)
        return total, lps

    def loglik_tree(self, tree: Tree) -> float:
        return self.loglik_sched(build_schedule(tree))

    def loglik_sched(self, sched) -> float:
        return self._loglik(sched, self._part_blens(sched))[0]

    def site_lp(self, tree: Tree) -> tuple[float, np.ndarray]:
        """(logL, per-pattern log-likelihoods concatenated over
        partitions)."""
        sched = build_schedule(tree)
        total, lps = self._loglik(sched,
                                  self._part_blens(sched, tree.topology_id()))
        return total, np.concatenate([
            lp[: p.num_patterns].double().cpu().numpy()
            for lp, p in zip(lps, self.aln.partitions)])

    def part_loglik(self, sched, k: int, blens=None) -> float:
        """One partition's logL at (shared blens * r_k) or explicit
        blens, in float64 (the engine's precise() view)."""
        e = self.engines[k].precise()
        if blens is None:
            blens = np.asarray(sched.blens) * self._rks()[k]
        logL, _ = pruning.tree_loglik(
            torch.as_tensor(blens, dtype=e.dtype, device=self.device),
            e._tipP, self._sched(sched), e._pack, e._pw)
        return float(logL)

    # ----------------------------------------------------- branch optimizer
    def optimize_branches(self, tree: Tree, n_rounds: int = 10,
                          n_newton: int = 4,
                          t_min: float = DEFAULT_MIN_BLEN,
                          t_max: float = DEFAULT_MAX_BLEN) -> float:
        """Optimise the branch lengths in place on the host tree; returns
        the total logL. Linked modes: n_rounds rounds of the joint
        all-branch Newton, each proposal halved toward the old lengths up
        to 4 times while the logL drops (JAX _multi_opt_blens). Unlinked:
        each partition's own lengths by its engine's optimiser, their
        site-weighted mean written to the tree."""
        sched = build_schedule(tree)
        sa = self._sched(sched)
        if self.partition_type == "unlinked":
            tid = tree.topology_id()
            if self._ul_tid == tid and self._ul_blens is not None:
                starts = self._ul_blens
            else:
                starts = [np.maximum(sched.blens, t_min)] * self.K
            total, new_bl = 0.0, []
            for start, e in zip(starts, self.engines):
                bl, logL = optimize_blens(self._tensor(start), e._tipP, sa,
                                          e._pack, e._pw, t_min, t_max,
                                          n_rounds, n_newton)
                new_bl.append(bl.double().cpu().numpy())
                total += float(logL)
            self._ul_blens = new_bl
            self._ul_tid = tid
            write_blens_to_tree(tree, sched, np.average(
                np.stack(new_bl), axis=0, weights=self._site_w))
            return total

        rks = self._rks()

        def lg(b) -> float:
            return self._loglik(sched, [b * rk for rk in rks])[0]

        blens = self._tensor(np.maximum(sched.blens, t_min))
        logL = lg(blens)
        for _ in range(n_rounds):
            thetas, scales = [], []
            for e, rk in zip(self.engines, rks):
                P = pruning.transition_tensors(blens * rk, e._pack)
                dp = pruning.down_pass(P, e._tipP, sa, tips=False)
                th = pruning.theta_pass(P, dp, e._tipP, sa, e._pack)
                thetas.append(th.theta)
                scales.append(th.scale)
            prop = joint_newton(thetas, scales, blens, self._packs(),
                                self._pws(), rks, t_min, t_max,
                                n_newton).clamp(t_min, t_max)
            cur, l_cur = prop, lg(prop)
            for _ in range(4):
                if not l_cur < logL - 1e-9:
                    break
                cur = 0.5 * (cur + blens)
                l_cur = lg(cur)
            blens, logL = cur, l_cur
        write_blens_to_tree(tree, sched, blens.double().cpu().numpy())
        return logL

    # --------------------------------------------------------- rate scalars
    def optimize_part_rates(self, tree: Tree) -> float:
        """Optimise the per-partition rates (edge-proportional mode) by
        Brent, one partition at a time, then renormalise so the
        site-weighted mean rate is 1 (absorbed into the branch lengths).
        Brent searches log r_k over the JAX package's [1e-3, 100]: in r
        itself its first probes (38.2 and 61.8) fall where a large tree's
        logL is flat (every branch saturated), and on a 1000-taxon
        supermatrix that search ended there for every partition and kept
        the start (ROADMAP C10). Reference analog: PartitionModelPlen's
        part_rate optimisation (model/partitionmodel.cpp)."""
        if self.partition_type != "edge-proportional" or self.K == 1:
            return self.loglik_tree(tree)
        sched = build_schedule(tree)
        sa = self._sched(sched)
        for k in range(self.K):
            e = self.engines[k].precise()
            blens = torch.as_tensor(sched.blens, dtype=e.dtype,
                                    device=self.device)

            def obj(log_r):
                lg, _ = pruning.tree_loglik(blens * math.exp(log_r),
                                            e._tipP, sa, e._pack, e._pw)
                return -float(lg)
            log_r, _ = brent_minimize(obj, math.log(RATE_MIN),
                                      math.log(RATE_MAX), guess=math.log(
                                          float(self.part_rates[k])))
            self.part_rates[k] = math.exp(log_r)
        mean = float(np.sum(self._site_w * self.part_rates))
        self.part_rates /= mean
        for key in tree.blen:
            tree.blen[key] *= mean
        return self.loglik_tree(tree)

    # ------------------------------------------------------------- NNI eval
    def evaluate_nni_batch(self, sched, cand_arrays,
                           t_min: float = DEFAULT_MIN_BLEN,
                           t_max: float = DEFAULT_MAX_BLEN,
                           return_site_lp: bool = False, nni5: bool = False):
        """Score every NNI candidate jointly over the partitions at the
        schedule's lengths: (logl [n, 3], t_opt [n, 3]) in master lengths,
        with nni5 also t5 [n, 3, 5] (JAX _multi_nni5_eval; no site logLs),
        else with return_site_lp the per-pattern logLs [n, 3, sum P]
        concatenated over partitions (JAX _multi_nni_eval). Each partition
        runs one down pass and one up pass at its lengths r_k * t."""
        sa = self._sched(sched)
        blens = self._tensor(sched.blens)
        rks = self._rks()
        bufs = []
        for e, rk in zip(self.engines, rks):
            P = pruning.transition_tensors(blens * rk, e._pack)
            bufs.append((P, *pruning.both_passes(P, e._tipP, sa, e._pack)))
        rows = nni.candidate_rows(cand_arrays, self.device)
        if nni5:
            out = self._nni5(rows, blens, bufs, sa, rks, t_min, t_max)
        else:
            out = self._nni1(rows, blens, bufs, sa, rks, t_min, t_max,
                             return_site_lp)
        return tuple(o.double().cpu().numpy() for o in out)

    def _nni1(self, rows, blens, bufs, sa, rks, t_min, t_max,
              return_site_lp: bool, n_newton: int = 4):
        """NNI1: the central branch of both variants and the baseline
        re-optimised by the joint Newton (ops/nni.evaluate_nnis summed over
        partitions)."""
        cs, ce = sa["child_src"].long(), sa["child_edge"].long()
        packs, pws = self._packs(), self._pws()
        outs = ([], [], [])
        for a, b in _chunks(rows.shape[1], [dp for _, dp, _ in bufs],
                            nni.SLABS_NNI1):
            iu, iv, slot, eid = rows[:, a:b]
            thetas, scales = [], []
            for (P, dp, up), pack in zip(bufs, packs):
                m_a, s_a = pruning.gather_messages(dp, P, cs[iu, 0],
                                                   ce[iu, 0])
                m_b, s_b = pruning.gather_messages(dp, P, cs[iu, 1],
                                                   ce[iu, 1])
                m_c, s_c = pruning.gather_messages(dp, P, cs[iv, slot],
                                                   ce[iv, slot])
                rest, s_rest = up.up_in[iv], up.up_scale[iv]
                down = torch.stack([m_a * m_c, m_b * m_c, m_a * m_b], 1)
                out = torch.stack([rest * m_b, rest * m_a, rest * m_c], 1)
                thetas.append(nni._theta(out, down, pack))
                scales.append(
                    torch.stack([s_a + s_c, s_b + s_c, s_a + s_b], 1)
                    + torch.stack([s_rest + s_b, s_rest + s_a,
                                   s_rest + s_c], 1))
            t0 = blens[eid][:, None].expand(-1, 3)
            t_opt = joint_newton(thetas, scales, t0, packs, pws, rks, t_min,
                                 t_max, n_newton)
            logl, lps = 0.0, []
            for th, sc, pack, pw, rk, p in zip(thetas, scales, packs, pws,
                                               rks, self.aln.partitions):
                lk, _, _ = pruning.branch_lh_derivs(
                    th, sc, t_opt * rk, pack, pack["log_ptn_invar"], pw,
                    order=0)
                logl = logl + lk
                if return_site_lp:
                    lps.append(pruning.branch_site_lp(
                        th, sc, t_opt * rk, pack,
                        pack["log_ptn_invar"])[..., : p.num_patterns])
            outs[0].append(logl)
            outs[1].append(t_opt)
            if return_site_lp:
                outs[2].append(torch.cat(lps, -1))
        return tuple(torch.cat(o) for o in outs if o)

    def _nni5(self, rows, blens, bufs, sa, rks, t_min, t_max,
              n_rounds: int = 2, n_newton: int = 2):
        """NNI5: the five branches around each candidate re-optimised by
        rounds of coordinate Newton, each step's derivatives summed over
        partitions (ops/nni.evaluate_nnis5 with a joint_newton step)."""
        cs, ce = sa["child_src"].long(), sa["child_edge"].long()
        n_int = cs.shape[0]
        L = bufs[0][1].all.shape[0] - n_int
        packs, pws = self._packs(), self._pws()
        K = self.K
        thresh, factor, _ = scaling_consts(self.dtype)
        roles = (nni._IDX1, nni._IDX2, nni._IDX3)
        idx = [torch.tensor(r, device=self.device) for r in roles]

        def resc(x, sc):
            return nni._rescale(x, sc, thresh, factor)

        def trans(k, t):
            C, S = packs[k]["cat_rate"].shape[0], bufs[k][1].all.shape[2]
            return pruning.transition_tensors(
                (t * rks[k]).reshape(-1), packs[k]).view(*t.shape, C, S, S)

        def newton(outs_, downs, scs, t):
            ths = [nni._theta(o, d, pk) for o, d, pk in zip(outs_, downs,
                                                           packs)]
            return joint_newton(ths, scs, t, packs, pws, rks, t_min, t_max,
                                n_newton)

        def add(xs, ys):
            return [x + y for x, y in zip(xs, ys)]

        outs = ([], [], [])
        for a, b in _chunks(rows.shape[1], [dp for _, dp, _ in bufs],
                            nni.SLABS_NNI5):
            iu, iv, slot, eid = rows[:, a:b]
            m = iu.shape[0]
            srcs = (cs[iu, 0], cs[iu, 1], cs[iv, slot])      # a, b, c
            is_root = iv == n_int - 1
            ed = torch.where(is_root, 0, L + iv)               # v's parent
            root5 = is_root[:, None, None, None, None]
            gi = [j.expand(m, 3)[..., None] for j in idx]
            PX, SX, E_d, s_Ed, out_root, s_out = [], [], [], [], [], []
            for _, dp, up in bufs:
                p_abc = [dp.all[s] for s in srcs]
                s_abc = [dp.scale[s] for s in srcs]
                PX.append([torch.stack([p_abc[i] for i in r], 1)
                           for r in roles])
                SX.append([torch.stack([s_abc[i] for i in r], 1)
                           for r in roles])
                E_d.append(up.edge_E[ed][:, None])
                s_Ed.append(up.edge_E_scale[ed][:, None])
                out_root.append(up.up_in[iv][:, None])
                s_out.append(torch.where(is_root[:, None, None],
                                         up.up_scale[iv][:, None],
                                         s_Ed[-1]))
            t5 = torch.stack([blens[ce[iu, 0]], blens[ce[iu, 1]],
                              blens[ce[iv, slot]], blens[ed], blens[eid]],
                             -1)[:, None].repeat(1, 3, 1)

            def lengths(ts):
                return [ts.gather(-1, g)[..., 0] for g in gi]

            def around_e(ts):
                """Per partition: messages of x2, x3, the outside at v and
                the two sides of the central edge at the lengths ts."""
                res = []
                for k in range(K):
                    m1, m2, m3 = (torch.matmul(trans(k, t), px)
                                  for t, px in zip(lengths(ts), PX[k]))
                    out_v = torch.where(root5, out_root[k], torch.matmul(
                        trans(k, ts[..., 3]).transpose(-1, -2), E_d[k]))
                    down_u, s_du = resc(m1 * m2, SX[k][0] + SX[k][1])
                    out_e, s_oe = resc(out_v * m3, s_out[k] + SX[k][2])
                    res.append((m2, m3, out_v, down_u, s_du, out_e, s_oe))
                return [list(x) for x in zip(*res)]

            ts = t5
            for _ in range(n_rounds):
                t1, t2, t3 = lengths(ts)
                td, te = ts[..., 3], ts[..., 4]
                m2, m3, out_v, down_u, s_du, out_e, s_oe = around_e(ts)
                te = newton(out_e, down_u, add(s_du, s_oe), te)
                Pe = [trans(k, te) for k in range(K)]
                m_u = [torch.matmul(Pe[k], down_u[k]) for k in range(K)]
                o3 = [resc(out_v[k] * m_u[k], s_out[k] + s_du[k])
                      for k in range(K)]
                t3 = newton([o for o, _ in o3], [px[2] for px in PX],
                            [s + sx[2] for (_, s), sx in zip(o3, SX)], t3)
                out_u = [torch.matmul(Pe[k].transpose(-1, -2), out_e[k])
                         for k in range(K)]
                o1 = [resc(out_u[k] * m2[k], s_oe[k] + SX[k][1])
                      for k in range(K)]
                t1 = newton([o for o, _ in o1], [px[0] for px in PX],
                            [s + sx[0] for (_, s), sx in zip(o1, SX)], t1)
                o2 = [resc(out_u[k] * torch.matmul(trans(k, t1), PX[k][0]),
                           s_oe[k] + SX[k][0]) for k in range(K)]
                t2 = newton([o for o, _ in o2], [px[1] for px in PX],
                            [s + sx[1] for (_, s), sx in zip(o2, SX)], t2)
                dv = [resc(m_u[k] * m3[k], s_du[k] + SX[k][2])
                      for k in range(K)]
                td = torch.where(is_root[:, None], td, newton(
                    E_d, [d for d, _ in dv],
                    [s + se for (_, s), se in zip(dv, s_Ed)], td))
                ts = (ts.scatter(-1, gi[0], t1[..., None])
                      .scatter(-1, gi[1], t2[..., None])
                      .scatter(-1, gi[2], t3[..., None]))
                ts = torch.cat([ts[..., :3], td[..., None], te[..., None]],
                               -1)
            # the score at the optimised lengths
            _, _, _, down_u, s_du, out_e, s_oe = around_e(ts)
            logl = 0.0
            for k in range(K):
                lk, _, _ = pruning.branch_lh_derivs(
                    nni._theta(out_e[k], down_u[k], packs[k]),
                    s_du[k] + s_oe[k], ts[..., 4] * rks[k], packs[k],
                    packs[k]["log_ptn_invar"], pws[k], order=0)
                logl = logl + lk
            outs[0].append(logl)
            outs[1].append(ts[..., 4])
            outs[2].append(ts)
        return tuple(torch.cat(o) for o in outs)
