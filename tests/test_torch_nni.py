"""The port's NNI scoring, fused NNI round, ML distances and NNI
hill-climb vs the JAX package's, float64 on the CPU.

Inputs are kernelcheck.simulate seeds or the golden files, built on each
side by its own package (tests/torch_parity.py); the tolerance of each
comparison is written at its assert.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.io.alignment_io import read_alignment as jread_alignment
from iqtree2_tpu.model import optimize as jopt
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.ops import distances as jdist
from iqtree2_tpu.search import nni as jnni
from iqtree2_tpu.search.bionj import bionj_tree as jbionj_tree
from iqtree2_tpu.search.perturb import random_nnis as jrandom_nnis
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io.alignment_io import read_alignment
from iqtree2_tpu_torch.model import optimize as topt
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.ops import distances as tdist
from iqtree2_tpu_torch.ops import nni as tops
from iqtree2_tpu_torch.search import nni as tnni
from iqtree2_tpu_torch.search.bionj import bionj_tree
from iqtree2_tpu_torch.search.perturb import random_nnis
from iqtree2_tpu_torch.tree.schedule import build_schedule
from tests.torch_parity import simulate_both

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _engines(model_name, ntaxa, nsites=300, seed=5):
    """(port tree, port engine, JAX tree, JAX engine) of one simulated
    problem."""
    (aln, tree, model, rates), (jaln, jtree, jmodel, jrates) = simulate_both(
        model_name, ntaxa, nsites, seed)
    return (tree,
            LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                             device="cpu"),
            jtree,
            jengine.LikelihoodEngine(jaln, jmodel, jrates,
                                     dtype=jnp.float64))


def _cands(tree):
    sched = build_schedule(tree)
    cand = tops.build_nni_candidates(tree, sched)
    return sched, cand, np.stack([cand.iu, cand.iv, cand.slot_c,
                                  cand.edge_id])


@pytest.mark.parametrize("ntaxa", [8, 20])
@pytest.mark.parametrize("model_name", ["GTR+G4", "HKY+I", "LG+G4"])
def test_evaluate_nnis_match_jax(model_name, ntaxa):
    tree, teng, jtree, jeng = _engines(model_name, ntaxa)
    sched, cand, ca = _cands(tree)
    jsched = jbuild_schedule(jtree)
    jc = jnni.build_nni_candidates(jtree, jsched)
    for a, b in zip(cand[:4], jc[:4]):
        np.testing.assert_array_equal(a, b)
    for nni5 in (False, True):
        got = teng.evaluate_nni_batch(sched, ca, nni5=nni5,
                                      return_site_lp=True)
        want = jeng.evaluate_nni_batch(jsched, jnp.asarray(ca), nni5=nni5,
                                       return_site_lp=True)
        assert len(got) == len(want) == (4 if nni5 else 3)
        # logl, t_opt, [t5,] site lp: 1e-9 relative
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel(g, w) < 1e-9


@pytest.mark.parametrize("nni5", [False, True])
def test_chunking_changes_no_result(monkeypatch, nni5):
    tree, teng, _, _ = _engines("GTR+G4", 20)
    sched, _, ca = _cands(tree)
    whole = teng.evaluate_nni_batch(sched, ca, nni5=nni5,
                                    return_site_lp=True)
    # a budget below one candidate's temporaries: one candidate per chunk
    monkeypatch.setattr(tops, "CHUNK_BYTES", 1)
    one_by_one = teng.evaluate_nni_batch(sched, ca, nni5=nni5,
                                         return_site_lp=True)
    # candidates are computed independently; only the batched GEMMs may
    # sum in another order for another batch size: 1e-10 relative
    for a, b in zip(whole, one_by_one):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)


@pytest.mark.parametrize("model_name", ["GTR+G4", "HKY+I"])
def test_fused_round_and_k_tree_form_match_jax(model_name):
    tree, teng, jtree, jeng = _engines(model_name, 14, seed=9)
    sides = {}
    for eng, t0, nnis, bs in ((teng, tree, random_nnis, build_schedule),
                              (jeng, jtree, jrandom_nnis, jbuild_schedule)):
        trees = [t0, t0.copy()]
        nnis(trees[1], np.random.default_rng(4), 0.5)
        sides[eng] = (trees, bs)
    # the serial fused round on trees[0], the K-tree form on both
    for k_form in (False, True):
        outs = []
        for eng in (teng, jeng):
            trees, bs = sides[eng]
            ts = [t.copy() for t in trees]
            scheds = [bs(t) for t in ts]
            cas = [_cands(t)[2] for t in ts]
            if k_form:
                res = eng.optimize_and_evaluate_nnis_batch(
                    ts, scheds, cas, n_rounds=2, nni5=True, want_lp=True)
            else:
                res = [eng.optimize_and_evaluate_nnis(
                    ts[0], scheds[0], cas[0] if eng is teng
                    else jnp.asarray(cas[0]), n_rounds=2, nni5=True,
                    want_lp=True)]
            outs.append((res, [s.blens.copy() for s in scheds]))
        (tres, tbl), (jres, jbl) = outs
        for t_out, j_out, tb, jb in zip(tres, jres, tbl, jbl):
            assert t_out[0] == pytest.approx(j_out[0], abs=1e-6)   # logL
            np.testing.assert_allclose(tb, jb, atol=1e-5)          # blens
            np.testing.assert_allclose(t_out[1], j_out[1], atol=1e-6)
            np.testing.assert_allclose(t_out[-1], j_out[-1], atol=1e-6)


def test_k_tree_forms_equal_serial_calls():
    tree, teng, _, _ = _engines("GTR+G4", 12, seed=3)
    trees = [tree.copy(), tree.copy()]
    random_nnis(trees[1], np.random.default_rng(1), 0.5)
    a = [t.copy() for t in trees]
    sa = [build_schedule(t) for t in a]
    batch = teng.optimize_and_evaluate_nnis_batch(
        a, sa, [_cands(t)[2] for t in a], nni5=True, want_lp=True)
    for k, t in enumerate(trees):
        b = t.copy()
        s = build_schedule(b)
        want = teng.optimize_and_evaluate_nnis(b, s, _cands(b)[2], nni5=True,
                                               want_lp=True)
        assert batch[k][0] == want[0]
        for x, y in zip(batch[k][1:], want[1:]):
            np.testing.assert_array_equal(x, y)
        assert a[k].to_newick() == b.to_newick()
    c = [t.copy() for t in trees]
    d = [t.copy() for t in trees]
    assert teng.optimize_branches_batch(c) == [teng.optimize_branches(
        t, n_rounds=4) for t in d]


@pytest.mark.parametrize("data", ["golden-HKY", "LG+G4"])
def test_ml_distances_match_jax(data):
    if data == "golden-HKY":
        aln = read_alignment(str(GOLDEN / "example.phy"))
        model, _, _ = build_model("HKY", aln)
        jaln = jread_alignment(str(GOLDEN / "example.phy"))
        jmodel, _, _ = jbuild_model("HKY", jaln)
    else:
        (aln, _, model, _), (jaln, _, jmodel, _) = simulate_both(
            "LG+G4", 10, 200, seed=1)
    want = jdist.ml_distances(jaln, jmodel, dtype=jnp.float64)
    got = tdist.ml_distances(aln, model, device="cpu")
    off = ~np.eye(aln.ntaxa, dtype=bool)
    assert _rel(got[off], want[off]) < 1e-9
    assert (np.diag(got) == 0).all()


def test_ml_distances_refuse_a_nonreversible_model():
    """A model with Q takes its distances from expm(Q t) (C18): with the
    GTR's own rate matrix as Q they are the eigenbasis ones; a model whose
    states are not the alignment's (PoMo) is still refused."""
    (aln, _, model, _), _ = simulate_both("GTR+G4", 6, 100, seed=1)
    want = tdist.ml_distances(aln, model, device="cpu")
    eig = model.get_eigensystem()
    eig.Q = ((eig.U[0] * eig.eigvals[0]) @ eig.V[0])[None]
    model.get_eigensystem = lambda: eig
    got = tdist.ml_distances(aln, model, device="cpu")
    off = ~np.eye(aln.ntaxa, dtype=bool)
    assert _rel(got[off], want[off]) < 1e-8
    pomo, _, _ = build_model("GTR+P", aln)
    with pytest.raises(NotImplementedError, match="alignment's"):
        tdist.ml_distances(aln, pomo, device="cpu")


def test_nni5_predicted_logl_matches_applied():
    """tests/test_nni5.py's check on the port: a candidate's predicted logL
    equals the logL of the tree with its swap and its five optimised
    lengths applied; five-branch scores dominate central-branch ones."""
    tree, teng, _, _ = _engines("GTR+G4", 12, nsites=200, seed=3)
    teng.optimize_branches(tree, n_rounds=6)
    sched, cand, ca = _cands(tree)
    logl5, t_e, t5 = teng.evaluate_nni_batch(sched, ca, nni5=True)
    logl1, _ = teng.evaluate_nni_batch(sched, ca)
    assert (logl5 >= logl1 - 1e-6).all()
    L = sched.ntaxa
    for ci in range(min(len(cand.nodes_u), 4)):
        for var in range(2):
            t = tree.copy()
            iu, iv = int(cand.iu[ci]), int(cand.iv[ci])
            u, v = cand.nodes_u[ci], cand.nodes_v[ci]
            a_node = tnni._slot_node(t, sched, iu, 0)
            b_node = tnni._slot_node(t, sched, iu, 1)
            moved_slot = 1 if var == 0 else 0
            x = tnni._slot_node(t, sched, iu, moved_slot)
            c = tnni._slot_node(t, sched, iv, int(cand.slot_c[ci]))
            t.swap_subtrees(u, x, v, c)
            tv5 = t5[ci, var]
            t.set_blen(u, v, float(t_e[ci, var]))
            kept = a_node if var == 0 else b_node
            t.set_blen(kept, u, float(tv5[0] if var == 0 else tv5[1]))
            t.set_blen(c, u, float(tv5[2]))
            t.set_blen(x, v, float(tv5[moved_slot]))
            if iv != sched.n_int - 1:
                vp = sched.edge_nodes[L + iv][1]
                t.set_blen(v, vp, float(tv5[3]))
            assert teng.loglik_tree(t) == pytest.approx(logl5[ci, var],
                                                        abs=1e-5)


def test_nni_optimize_from_bionj_matches_jax():
    """tests/test_optimize.py::test_nni_search_from_bionj on both packages:
    the same final topology, and the port at least g0 - 1.0 after the
    model fit."""
    golden = json.loads((GOLDEN / "golden.json").read_text())["logL"]
    tops_ = []
    for read, bm, eng_of, dist, bionj, nni_opt, fit in (
            (read_alignment, build_model,
             lambda a, m, r: LikelihoodEngine(a, m, r, dtype=torch.float64,
                                              device="cpu"),
             lambda a, m: tdist.ml_distances(a, m, device="cpu"),
             bionj_tree, tnni.nni_optimize, topt.optimize_model_parameters),
            (jread_alignment, jbuild_model,
             lambda a, m, r: jengine.LikelihoodEngine(a, m, r,
                                                      dtype=jnp.float64),
             lambda a, m: jdist.ml_distances(a, m, dtype=jnp.float64),
             jbionj_tree, jnni.nni_optimize,
             jopt.optimize_model_parameters)):
        aln = read(str(GOLDEN / "example.phy"))
        model, rates, _ = bm("HKY", aln)
        eng = eng_of(aln, model, rates)
        t = bionj(dist(aln, model), aln.names)
        t.clamp_blens(1e-6, 10.0)
        res = nni_opt(eng, t)
        tops_.append((t.topology_id(), res.logL, fit(eng, t,
                                                     epsilon=0.01)))
    (tid, l_nni, l_fit), (jtid, jl_nni, _) = tops_
    assert tid == jtid
    # both end in sweeps that stop once a sweep gains under 1e-3
    assert l_nni == pytest.approx(jl_nni, abs=1e-4)
    assert l_fit >= golden["g0_search"] - 1.0
