"""The port's pattern-sharded likelihood (parallel/shard.py) on the CPU in
float64: its four sharded functions on 2 and 4 spawned gloo ranks against
the JAX package's parallel/shard.py on the 8-device CPU mesh of
tests/conftest.py and against the port's unsharded engine, all within
1e-9 relative, with one +ASC case whose pseudo-patterns straddle the two
ranks' slices (prob_unobs is summed before its logarithm); reduce=None
against an identity reduce, bit for bit; UFBoot's device RELL alone and
over 2 ranks; dryrun_multichip on 2 gloo ranks.

Both packages build their problem from the same site matrix (random DNA
columns from a numpy seed), model string and Newick text.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu.ops import pruning as jpruning
from iqtree2_tpu.ops.nni import build_nni_candidates as jbuild_nni_candidates
from iqtree2_tpu.parallel import shard as jshard
from iqtree2_tpu.tree.schedule import build_schedule as jbuild_schedule
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import kernelcheck
from iqtree2_tpu_torch.data import seqtypes
from iqtree2_tpu_torch.ops import nni, pruning
from iqtree2_tpu_torch.ops.nni import build_nni_candidates
from iqtree2_tpu_torch.parallel import dryrun, shard
from iqtree2_tpu_torch.tree.topology import Tree
from tests.torch_parity import jax_alignment
from tests.torch_ranks import (T_MAX, T_MIN, rell_inputs, rell_rank,
                               run_ranks, several, shard_outputs,
                               shard_problem, shard_rank)

N_DEV = 8
MODEL = kernelcheck.MODELS["GTR+G4"][2]
REL = 1e-9
# (taxa, sites, +ASC): the +ASC problem's 4 pseudo-patterns follow its
# 125-127 patterns, across the 128-pattern boundary of two ranks' slices
CASES = {"plain": (14, 500, False), "asc": (8, 126, True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < N_DEV:
        pytest.skip("needs the 8-device CPU mesh (conftest XLA_FLAGS)")
    return jshard.make_mesh(N_DEV)


def _inputs(case: str):
    """(names, site matrix, Newick, +ASC) of a case."""
    ntaxa, nsites, asc = CASES[case]
    rng = np.random.default_rng(ntaxa)
    names = [f"t{i}" for i in range(ntaxa)]
    sites = seqtypes.DNA_STATE_TO_CODE[rng.integers(0, 4, (nsites, ntaxa))]
    return names, sites, Tree.random_topology(names, rng).to_newick(
        digits=17), asc


_JAX_OUTPUTS: dict = {}


def _jax_outputs(mesh, eng, newick: str, n: int):
    """The JAX package's four sharded functions on the same problem as the
    port engine ``eng`` and the tree ``newick``, on the 8-device mesh;
    computed once per problem and RELL width (each call compiles)."""
    key = (newick, eng.asc, shard.pad_patterns_for_ranks(eng.Pp, n))
    if key not in _JAX_OUTPUTS:
        _JAX_OUTPUTS[key] = _jax_sharded(mesh, eng, newick, key[2])
    return _JAX_OUTPUTS[key]


def _jax_sharded(mesh, eng, newick: str, width: int):
    jaln = jax_alignment(eng.aln)
    jmodel, jrates, _ = jbuild_model(MODEL, jaln)
    jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jnp.float64,
                                    asc=eng.asc)
    assert jeng.Pp == eng.Pp
    jtree = JTree.from_newick(newick, jaln.names)
    jsched = jbuild_schedule(jtree)
    sa = jeng.schedule_arrays(jsched)
    tipP, pw, log_inv = jshard.shard_engine_arrays(
        mesh, jeng._dev_tipP, jeng._dev_pw, jeng._dev_pack["log_ptn_invar"])
    pack = dict(jeng._dev_pack, log_ptn_invar=log_inv)
    blens = jnp.asarray(jsched.blens, jnp.float64)
    t_min, t_max = jnp.asarray(T_MIN), jnp.asarray(T_MAX)
    logL, lp = jshard.sharded_loglik_fn(mesh, pack)(blens, tipP, sa, pack,
                                                    pw)
    step_b, step_logL = jshard.sharded_optimize_step_fn(mesh, pack)(
        blens, tipP, sa, pack, pw, t_min, t_max)
    samples, lp_r = rell_inputs(width)
    rell = jshard.sharded_rell_fn(mesh)(
        jax.device_put(samples, NamedSharding(mesh, P(None, jshard.AXIS))),
        jax.device_put(lp_r, NamedSharding(mesh, P(jshard.AXIS))))
    cand = jbuild_nni_candidates(jtree, jsched)
    cand_arrays = tuple(jnp.asarray(x) for x in (cand.iu, cand.iv,
                                                  cand.slot_c, cand.edge_id))
    Pm = jpruning.transition_tensors(blens, jeng._dev_pack)
    dp = jpruning.down_pass(Pm, jeng._dev_tipP, sa)
    up = jpruning.up_pass(Pm, dp, jeng._dev_tipP, sa,
                          jeng._dev_pack["root_freqs"])
    s4 = NamedSharding(mesh, P(None, None, None, jshard.AXIS))
    s2 = NamedSharding(mesh, P(None, jshard.AXIS))
    logl, topt = jshard.sharded_nni_fn(mesh, pack)(
        cand_arrays, blens, jpruning.DownPass(jax.device_put(dp.all, s4),
                                              jax.device_put(dp.scale, s2)),
        jax.device_put(up.up_in, s4), jax.device_put(up.up_scale, s2), sa,
        pack, pw, t_min, t_max)
    return {"logL": float(logL), "lp": np.asarray(lp),
            "step_blens": np.asarray(step_b), "step_logL": float(step_logL),
            "rell": np.asarray(rell), "nni_logl": np.asarray(logl),
            "nni_topt": np.asarray(topt)}


def _merged(ranks: list, Pp: int) -> dict:
    """The ranks' outputs as one: the site lps of the slices joined and
    cut to the engine's axis, the rest rank 0's (equal on every rank)."""
    for r in ranks[1:]:
        for k in ("logL", "step_logL", "step_blens", "rell", "nni_logl",
                  "nni_topt"):
            np.testing.assert_array_equal(r[k], ranks[0][k])
    out = {k: np.asarray(v) for k, v in ranks[0].items()
           if k not in ("rank", "slice", "lp")}
    out["lp"] = np.concatenate([r["lp"] for r in ranks])[:Pp]
    return out


def _close(got: dict, want: dict, tag: str) -> None:
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=REL, atol=REL * 1e-3,
                                   err_msg=f"{tag}: {k}")


RELL_SEED = 4
TWO_RANK_CASES = ("plain", "asc")


@pytest.fixture(scope="module")
def two_ranks():
    """The jobs of two ranks, in turn in one spawn: shard_rank on each of
    TWO_RANK_CASES, then rell_rank. {case or "rell": [rank 0's output,
    rank 1's]}."""
    jobs = [(shard_rank, (*_inputs(c)[:3], MODEL, _inputs(c)[3]))
            for c in TWO_RANK_CASES]
    jobs.append((rell_rank, (*_inputs("plain")[:2], RELL_SEED)))
    ranks = run_ranks(several, 2, jobs)
    return {c: [r["jobs"][k] for r in ranks]
            for k, c in enumerate(TWO_RANK_CASES + ("rell",))}


@pytest.mark.parametrize("case,n", [("plain", 2), ("plain", 4), ("asc", 2)])
def test_sharded_functions_match_jax_and_unsharded(mesh, case, n, request):
    names, sites, newick, asc = _inputs(case)
    eng, tree, sched = shard_problem(names, sites, newick, MODEL, asc)
    if asc:
        n_pat = eng.aln.num_patterns
        end0 = shard.rank_bounds(eng.Pp, 0, n)[1]
        assert n_pat < end0 < n_pat + eng.aln.num_states, (n_pat, end0)
    ranks = (request.getfixturevalue("two_ranks")[case] if n == 2 else
             run_ranks(shard_rank, n, names, sites, newick, MODEL, asc))
    got = _merged(ranks, eng.Pp)
    _close(got, _jax_outputs(mesh, eng, newick, n), f"{case} x{n} vs JAX")
    want = {k: np.asarray(v) for k, v in shard_outputs(
        eng, tree, sched, 0, 1, None).items() if k not in ("slice", "rell")}
    samples, lp_r = rell_inputs(shard.pad_patterns_for_ranks(eng.Pp, n))
    want["rell"] = samples @ lp_r
    _close(got, want, f"{case} x{n} vs unsharded")


def _identity(t):
    return None


@pytest.mark.parametrize("asc", [False, True])
def test_reduce_none_is_bit_identical(asc):
    """reduce=None computes what a one-rank identity reduce does, bit for
    bit: the stacked sums of pruning.summed change no value."""
    names, sites, newick, _ = _inputs("asc")
    eng, tree, sched = shard_problem(names, sites, newick, MODEL, asc)
    sa = eng.schedule_arrays(sched)
    blens = torch.as_tensor(sched.blens, dtype=torch.float64)
    pk, pw = eng._pack, eng._pw
    outs = []
    for red in (None, _identity):
        got = list(pruning.tree_loglik(blens, eng._tipP, sa, pk, pw,
                                       reduce=red))
        P_ = pruning.transition_tensors(blens, pk)
        dp = pruning.down_pass(P_, eng._tipP, sa, tips=False)
        th = pruning.theta_pass(P_, dp, eng._tipP, sa, pk)
        for order in (0, 2):
            got += [x for x in pruning.branch_lh_derivs(
                th.theta, th.scale, blens, pk, pk["log_ptn_invar"], pw,
                order=order, reduce=red) if x is not None]
        got.append(pruning.newton_branch_step(
            th.theta, th.scale, blens, pk, pk["log_ptn_invar"], pw, T_MIN,
            T_MAX, reduce=red))
        dp2, up = pruning.both_passes(P_, eng._tipP, sa, pk)
        cand = build_nni_candidates(tree, sched)
        got += list(nni.evaluate_nnis(
            np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id]), blens,
            dp2, up.up_in, up.up_scale, sa, pk, pw, T_MIN, T_MAX,
            reduce=red))
        outs.append(got)
    for x, y in zip(*outs):
        assert torch.equal(x, y)


def test_ufboot_device_rell_matches_host(two_ranks):
    """tests/test_shard.py's device RELL on the port: UFBoot's matvec on
    the engine's device, alone and over two ranks' pattern slices summed by
    one all_reduce, equals the host's."""
    from iqtree2_tpu_torch.search.ufboot import UFBoot
    names, sites, newick, _ = _inputs("plain")
    eng, _, _ = shard_problem(names, sites, newick, MODEL, False)
    host = UFBoot(eng.aln, n_replicates=50, seed=7)
    dev = UFBoot(eng.aln, n_replicates=50, seed=7)
    dev.enable_device_rell("cpu")
    lp = np.random.default_rng(RELL_SEED).normal(-7.0, 1.0,
                                                 eng.aln.num_patterns)
    want = host._rell_scores(lp)
    np.testing.assert_allclose(dev._rell_scores(lp), want, rtol=2e-5)
    for r in two_ranks["rell"]:
        np.testing.assert_allclose(r["rell"], want, rtol=2e-5)


def test_dryrun_multichip_two_gloo_ranks():
    """dryrun_multichip(2, "gloo", "cpu") passes checks (a)-(f)."""
    reps = dryrun.dryrun_multichip(2, "gloo", "cpu", timeout=60)
    assert [r["rank"] for r in reps] == [0, 1]
    assert reps[0]["logL_err"] <= 1e-2 and reps[0]["blen_err"] <= 1e-3
