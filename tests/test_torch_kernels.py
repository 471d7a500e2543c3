"""The JAX package's eight TPU kernel contracts (T1-T8) vs the port, float32.

Each Pallas kernel of iqtree2_tpu/ops/pallas_pruning.py and pallas_pruning2.py
runs in interpret mode on the CPU (full-float32 matmul precision, as
tests/test_pallas.py and tests/test_pallas2.py run them) and is held against
the port's plain counterpart on identical inputs: the same simulated
alignment (built on the JAX side by the JAX package, tests/torch_parity.py),
and the JAX engine's model pack, schedule and transition tensors as numpy
arrays.

  T1 down_sitelp_pallas   -> down_pass(pack, tips=False)  lp (epilogue)
  T2 down_pass_pallas     -> down_pass                    partials, scales
  T3 up_pass_pallas       -> up_pass                      E, UP, scales
  T4 stream_pass sitelp   -> down_pass(pack, tips=False)  lp (epilogue)
  T5 stream_pass export   -> down_pass                    partials, scales
  T6 stream_pass slim     -> down_pass                    child blocks, root
  T7 stream_up_pass       -> up_pass                      E, UP
  T8 stream_theta_pass    -> theta_pass                   theta

Tolerances (test_pallas2._tol for float32): 2e-5 on site log-likelihoods;
1e-4 relative on partials, E, UP and theta, measured per (row, pattern)
column against the column's largest value; scale counts equal where a
kernel exports them per node, rescale-invariant values (partial x
2^(-30 sc)) where the kernel reassembles them (T7, T8).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from iqtree2_tpu.engine import LikelihoodEngine as JaxEngine
from iqtree2_tpu.ops import pallas_pruning as pp1
from iqtree2_tpu.ops import pallas_pruning2 as pp2
from iqtree2_tpu.ops import prec
from iqtree2_tpu.ops import pruning as jpr
from iqtree2_tpu.tree.plan2 import (build_stream_plan, edge_maps, pick_tile,
                                    pick_tile_export, pick_tile_up,
                                    slot_pitch, up_scalar_arrays)
from iqtree2_tpu.tree.schedule import build_schedule
from iqtree2_tpu_torch.convert import pack_to_torch, sched_to_torch
from iqtree2_tpu_torch.ops import pruning as tpr
from tests.torch_parity import simulate_both

LP_TOL = 2e-5
REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _highest_and_one_thread():
    prec.set_precision("highest")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    prec.set_precision(os.environ.get("IQTREE2_TPU_MM_PRECISION", "high"))


def _col_rel(a, b):
    """max |a - b| / max |b| over each (row, pattern) column's [C, S]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = np.abs(a - b).max(axis=(-3, -2))
    den = np.maximum(np.abs(b).max(axis=(-3, -2)), 1e-300)
    return float((num / den).max())


def _eff(v, sc):
    """Rescale-invariant value of stored partials: v * 2^(-30 sc)."""
    return np.asarray(v, np.float64) * np.exp2(
        -30.0 * np.asarray(sc, np.float64))[..., None, None, :]


@pytest.fixture(scope="module", params=[8, 33])
def prob(request):
    ntaxa = request.param
    _, (aln, tree, model, rates) = simulate_both("GTR+G4", ntaxa, 256,
                                                 seed=ntaxa)
    eng = JaxEngine(aln, model, rates, dtype=jnp.float32)
    sched = build_schedule(tree)
    sa = eng.schedule_arrays(sched)
    pack = eng._dev_pack
    tipP = eng._dev_tipP
    P = jpr.transition_tensors(jnp.asarray(sched.blens, jnp.float32), pack)
    t_pack = pack_to_torch({k: None if v is None else np.asarray(v)
                            for k, v in pack.items()}, "cpu", torch.float32)
    t_sched = sched_to_torch({k: np.asarray(v) for k, v in sa.items()}, "cpu")
    t_tip = torch.as_tensor(np.array(tipP))
    t_P = torch.as_tensor(np.array(P))
    dp = tpr.down_pass(t_P, t_tip, t_sched)
    up = tpr.up_pass(t_P, dp, t_tip, t_sched, t_pack["root_freqs"])
    # a log-likelihood's and a Newton round's down pass: no tip rows
    dp_lp = tpr.down_pass(t_P, t_tip, t_sched, pack=t_pack, tips=False)
    C = int(pack["cat_rate"].shape[0])
    S = tipP.shape[1]
    plan = build_stream_plan(sched, S=S, C=C)
    ms, sl = plan.scalar_arrays()
    ms_u, sl_u = up_scalar_arrays(plan)
    e_step, e_side, e_slot, *_ = edge_maps(plan, sched)
    root = plan.node_step[sched.n_int - 1], plan.node_slot[sched.n_int - 1]
    pa = dict(p2_meta_step=jnp.asarray(ms), p2_meta_slot=jnp.asarray(sl),
              p2_edge=jnp.asarray(plan.edge), p2_int=jnp.asarray(plan.is_int),
              p2_tip=jnp.asarray(plan.tip),
              p2u_meta_step=jnp.asarray(ms_u),
              p2u_meta_slot=jnp.asarray(sl_u),
              p2_node_step=jnp.asarray(plan.node_step),
              p2_node_slot=jnp.asarray(plan.node_slot),
              p2_e_step=jnp.asarray(e_step), p2_e_side=jnp.asarray(e_side),
              p2_e_slot=jnp.asarray(e_slot),
              p2u_root_step=jnp.asarray(int(root[0])),
              p2u_root_slot=jnp.asarray(int(root[1])))
    return dict(
        eng=eng, sched=sched, pack=pack, tipP=tipP, P=P, L=tipP.shape[0],
        C=C, S=S, CS=C * S, CSP=slot_pitch(C * S), plan=plan, pa=pa,
        edge_maps=(e_step, e_side, e_slot),
        wf=(pack["cat_weight"][:, None] * pack["root_freqs"]).reshape(-1),
        flat_src=jnp.asarray(sched.child_src.reshape(-1)),
        flat_eid=jnp.asarray(sched.child_edge.reshape(-1)),
        t_pack=t_pack, t_sched=t_sched, t_tip=t_tip, t_P=t_P, dp=dp, up=up,
        dp_lp=dp_lp, lp=tpr.site_lp(dp_lp))


def test_t1_down_sitelp_pallas(prob):
    p = prob
    with pltpu.force_tpu_interpret_mode():
        lp = pp1.down_sitelp_pallas(p["flat_src"], p["flat_eid"], p["tipP"],
                                    p["P"], p["wf"],
                                    p["pack"]["log_ptn_invar"], pt=128)
    np.testing.assert_allclose(p["lp"].numpy(), np.asarray(lp),
                               rtol=LP_TOL, atol=LP_TOL)


def test_t2_down_pass_pallas(prob):
    p = prob
    with pltpu.force_tpu_interpret_mode():
        all_int, sc_int = pp1.down_pass_pallas(p["flat_src"], p["flat_eid"],
                                               p["tipP"], p["P"], pt=128)
    L = p["L"]
    assert _col_rel(p["dp"].all[L:].numpy(), all_int) <= REL_TOL
    np.testing.assert_array_equal(p["dp"].scale[L:].numpy(),
                                  np.asarray(sc_int, np.int32))


def test_t3_up_pass_pallas(prob):
    p = prob
    L = p["L"]
    dp, up = p["dp"], p["up"]
    with pltpu.force_tpu_interpret_mode():
        E, ES, UP, UPS = pp1.up_pass_pallas(
            p["flat_src"], p["flat_eid"], p["tipP"],
            jnp.asarray(dp.all[L:].numpy()),
            jnp.asarray(dp.scale[L:].numpy().astype(np.float32)), p["P"],
            p["pack"]["root_freqs"], pt=128)
    assert _col_rel(up.edge_E.numpy(), E) <= REL_TOL
    assert _col_rel(up.up_in.numpy(), UP) <= REL_TOL
    np.testing.assert_array_equal(up.edge_E_scale.numpy(),
                                  np.asarray(ES, np.int32))
    np.testing.assert_array_equal(up.up_scale.numpy(),
                                  np.asarray(UPS, np.int32))


def _v2_lp(p, export):
    plan = p["plan"]
    pt = pick_tile(plan, p["eng"].Pp, export=export)
    return pp2.sitelp_v2(p["P"], p["tipP"], p["pa"], p["wf"],
                         p["pack"]["log_ptn_invar"], CSP=p["CSP"],
                         ring_blocks=plan.ring_blocks, pt=pt, export=export,
                         interpret=True)


def test_t4_stream_pass_sitelp(prob):
    lp = _v2_lp(prob, export=False)
    np.testing.assert_allclose(prob["lp"].numpy(), np.asarray(lp),
                               rtol=LP_TOL, atol=LP_TOL)


def test_t5_stream_pass_export(prob):
    p = prob
    lp, parts, scs, *_ = _v2_lp(p, export=True)
    plan, L, CS, CSP = p["plan"], p["L"], p["CS"], p["CSP"]
    n_int = p["sched"].n_int
    parts = np.asarray(parts)
    got = np.stack([parts[plan.node_step[i],
                          plan.node_slot[i] * CSP:plan.node_slot[i] * CSP
                          + CS] for i in range(n_int)])
    got = got.reshape(n_int, p["C"], p["S"], -1)
    assert _col_rel(p["dp"].all[L:].numpy(), got) <= REL_TOL
    np.testing.assert_array_equal(
        p["dp"].scale[L:].numpy(),
        np.asarray(scs)[plan.node_step, plan.node_slot].astype(np.int32))
    np.testing.assert_allclose(p["lp"].numpy(), np.asarray(lp),
                               rtol=LP_TOL, atol=LP_TOL)


def test_t6_stream_pass_slim(prob):
    """Slim export: the child blocks each step reads, their scales, and the
    root partial -- the theta pass's inputs."""
    p = prob
    plan, L, C, S, CS, CSP = (p[k] for k in ("plan", "L", "C", "S", "CS",
                                             "CSP"))
    Pp = p["eng"].Pp
    edge, is_int, tip = (p["pa"][k] for k in ("p2_edge", "p2_int", "p2_tip"))
    ops = pp2.build_ops(p["P"], edge, is_int, tip, L, CSP)
    tips = pp2.build_tip_streams(p["tipP"], tip, pp2._round_up(plan.G * S, 8))
    _, rhsA, rhsB, scA, scB, root_part, root_sc = pp2.stream_pass(
        p["pa"]["p2_meta_step"], p["pa"]["p2_meta_slot"], tips[0], tips[1],
        *ops[:4], ops[4], jnp.zeros((CSP, 1), jnp.float32), tips[2],
        jnp.full((1, Pp), -jnp.inf, jnp.float32), CSP=CSP,
        ring_blocks=plan.ring_blocks, pt=pick_tile_export(plan, Pp),
        export=True, slim=True, interpret=True)
    dp = p["dp"]
    all_, scale = dp.all.numpy(), dp.scale.numpy()
    edge_src = p["sched"].edge_src
    got, want, got_sc, want_sc = [], [], [], []
    for k, (rhs, sc) in enumerate(((rhsA, scA), (rhsB, scB))):
        rhs, sc = np.asarray(rhs), np.asarray(sc)
        for s in range(plan.n_steps):
            for g in range(plan.G):
                if plan.valid[s, g] and plan.is_int[s, g, k]:
                    src = edge_src[plan.edge[s, g, k]]
                    got.append(rhs[s, g * CSP:g * CSP + CS].reshape(C, S, -1))
                    want.append(all_[src])
                    got_sc.append(sc[s, g])
                    want_sc.append(scale[src])
    assert got, "no internal child blocks to compare"
    assert _col_rel(np.stack(want), np.stack(got)) <= REL_TOL
    np.testing.assert_array_equal(np.stack(want_sc),
                                  np.stack(got_sc).astype(np.int32))
    root = L + p["sched"].n_int - 1
    assert _col_rel(all_[root][None],
                    np.asarray(root_part)[None, :CS].reshape(1, C, S, -1)
                    ) <= REL_TOL
    np.testing.assert_array_equal(scale[root],
                                  np.asarray(root_sc).astype(np.int32))


def test_t7_stream_up_pass(prob):
    p = prob
    plan, Pp = p["plan"], p["eng"].Pp
    dp2, up2 = pp2.passes_v2(p["P"], p["tipP"], p["pa"],
                             p["pack"]["root_freqs"], CSP=p["CSP"],
                             ring_blocks=plan.ring_blocks,
                             up_ring_blocks=plan.up_ring_blocks,
                             pt=pick_tile_export(plan, Pp),
                             ptu=pick_tile_up(plan, Pp), interpret=True)
    up = p["up"]
    assert _col_rel(_eff(up.edge_E.numpy(), up.edge_E_scale.numpy()),
                    _eff(up2.edge_E, up2.edge_E_scale)) <= REL_TOL
    assert _col_rel(_eff(up.up_in.numpy(), up.up_scale.numpy()),
                    _eff(up2.up_in, up2.up_scale)) <= REL_TOL


def test_t8_stream_theta_pass(prob):
    p = prob
    plan, Pp, C, S, CS, CSP = (p["plan"], p["eng"].Pp, p["C"], p["S"],
                               p["CS"], p["CSP"])
    thA, thB, tscA, tscB, th0, tsc0 = pp2.thetas_v2(
        p["P"], p["tipP"], p["pa"], p["pack"], CSP=CSP,
        ring_blocks=plan.ring_blocks, up_ring_blocks=plan.up_ring_blocks,
        pt=pick_tile_export(plan, Pp), ptu=pick_tile_up(plan, Pp),
        interpret=True)
    th = tpr.theta_pass(p["t_P"], p["dp_lp"], p["t_tip"], p["t_sched"],
                        p["t_pack"])
    e_step, e_side, e_slot = p["edge_maps"]
    packed = [(np.asarray(thA), np.asarray(tscA)),
              (np.asarray(thB), np.asarray(tscB))]
    got = [np.asarray(th0)]
    got_sc = [np.asarray(tsc0)]
    for e in range(1, p["sched"].n_edges):
        t_, sc_ = packed[int(e_side[e])]
        s_, g_ = int(e_step[e]), int(e_slot[e])
        got.append(t_[s_, g_ * CSP:g_ * CSP + CS].reshape(C, S, -1))
        got_sc.append(sc_[s_, g_])
    assert _col_rel(_eff(th.theta.numpy(), th.scale.numpy()),
                    _eff(np.stack(got), np.stack(got_sc))) <= REL_TOL
