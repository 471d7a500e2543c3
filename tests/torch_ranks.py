"""Ranks of the port's distributed tests (tests/test_torch_multihost.py,
tests/test_torch_shard.py on the CPU, tests/test_torch_cuda.py on one
card): run_ranks starts n
processes (start method spawn) joined by a gloo group on localhost, runs a
target of this module in each and returns what each gives. A rank that
fails, or a run that outlasts its timeout, kills every rank and fails the
test. This module imports only the port (a spawned rank imports it)."""

import datetime
import queue as queue_mod
import time
import traceback

import numpy as np
import torch

from iqtree2_tpu_torch.parallel.dryrun import free_port

# a rank's gloo rendezvous and collectives, and FileGossip's barrier
RANK_TIMEOUT = 60.0


def _rank_main(target, rank, n, port, out, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        try:
            out.put({"rank": rank, **target(rank, n, *args)})
        finally:
            dist.destroy_process_group()
    except Exception:
        out.put({"rank": rank, "error": traceback.format_exc()})


def run_ranks(target, n: int, *args, timeout: float = 120.0) -> list:
    """[target(rank, n, *args) | {"rank": rank}] for rank 0..n-1, each in a
    spawned process; raises AssertionError with a failing rank's
    traceback, or TimeoutError after ``timeout`` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, rank, n, port, out, args))
             for rank in range(n)]
    for p in procs:
        p.start()
    got = []
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n:
            try:
                res = out.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue_mod.Empty:
                raise TimeoutError(f"{n - len(got)} of {n} ranks gave "
                                   f"nothing in {timeout} s") from None
            if "error" in res:
                raise AssertionError(f"rank {res['rank']}:\n{res['error']}")
            got.append(res)
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return sorted(got, key=lambda r: r["rank"])


def several(rank: int, n: int, jobs) -> dict:
    """{"jobs": [target(rank, n, *args) for (target, args) in jobs]}: the
    jobs of one spawn of ranks, in turn (a spawn costs seconds)."""
    return {"jobs": [target(rank, n, *args) for target, args in jobs]}


# ------------------------------------------------------------------ search
def search_problem():
    """The port's problem of the distributed-search tests: GTR+G4 (fixed
    parameters) simulated at 8 taxa x 64 sites, seed 2, float64 on the
    CPU (the size of tests/test_multihost.py)."""
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    aln, _, model, rates = kernelcheck.simulate("GTR+G4", 8, 64, seed=2)
    return aln, LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                                 device="cpu")


SEARCH_KW = dict(seed=5, n_init_trees=6, n_rounds=2, round_size=4)
BOOT_REPLICATES = 40


def search_result(eng, aln, gossip, rank: int, n: int) -> dict:
    """DistributedSearch with UFBoot on one rank: its tree's topology id,
    logL and the merged UFBoot champions."""
    from iqtree2_tpu_torch.parallel.multihost import DistributedSearch
    from iqtree2_tpu_torch.search.ufboot import UFBoot
    uf = UFBoot(aln, n_replicates=BOOT_REPLICATES, seed=3)
    tree, logL = DistributedSearch(eng, aln, gossip, rank, n, ufboot=uf,
                                   **SEARCH_KW).run()
    return {"tid": tree.topology_id(), "logL": logL,
            "boot_logl": uf.boot_logl.tolist(),
            "boot_trees": list(uf.boot_trees)}


def search_rank(rank: int, n: int, transport: str, root: str) -> dict:
    """search_result over FileGossip (in ``root``) or TorchGossip."""
    from iqtree2_tpu_torch.parallel.multihost import FileGossip, TorchGossip
    aln, eng = search_problem()
    gossip = (FileGossip(root, rank, n, timeout=RANK_TIMEOUT)
              if transport == "file" else TorchGossip(rank, n))
    return search_result(eng, aln, gossip, rank, n)


# ------------------------------------------------------------------- shard
T_MIN, T_MAX = 1e-6, 10.0
RELL_REPLICATES = 16


def shard_problem(names, sites, newick: str, model_str: str, asc: bool,
                  device="cpu"):
    """(engine, tree, schedule) of the port on a site matrix, float64 on
    ``device``."""
    from iqtree2_tpu_torch.data import seqtypes
    from iqtree2_tpu_torch.data.alignment import Alignment
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.model.factory import build_model
    from iqtree2_tpu_torch.tree.schedule import build_schedule
    from iqtree2_tpu_torch.tree.topology import Tree
    aln = Alignment.from_site_matrix(list(names), np.asarray(sites),
                                     seqtypes.get_seqtype("DNA"))
    model, rates, _ = build_model(model_str, aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device=device, asc=asc)
    tree = Tree.from_newick(newick, aln.names)
    return eng, tree, build_schedule(tree)


def rell_inputs(n_patterns: int, seed: int = 1):
    """(samples [R, n_patterns], lp [n_patterns]) of the RELL check."""
    rng = np.random.default_rng(seed)
    return (rng.poisson(1.0, size=(RELL_REPLICATES, n_patterns)).astype(
        np.float64), rng.normal(-8.0, 1.0, size=n_patterns))


def shard_outputs(eng, tree, sched, rank: int, n: int, reduce) -> dict:
    """The four sharded functions of parallel/shard.py on this rank's slice
    (reduce None and one rank: the unsharded engine's arrays): logL and the
    slice's site lp, one optimize step's lengths and logL, RELL, the NNI
    batch's logLs and lengths."""
    from iqtree2_tpu_torch.ops import pruning
    from iqtree2_tpu_torch.ops.nni import build_nni_candidates
    from iqtree2_tpu_torch.parallel import shard
    sa = eng.schedule_arrays(sched)
    dev = eng.device
    blens = torch.as_tensor(sched.blens, dtype=torch.float64, device=dev)
    sh = shard.shard_engine_arrays(eng, rank, n)
    args = (sh.tipP, sa, sh.pack, sh.pattern_weights)
    logL, lp = pruning.tree_loglik(blens, *args, reduce=reduce)
    step_b, step_logL = shard.sharded_optimize_step_fn(reduce)(
        blens, *args, T_MIN, T_MAX)
    samples, lp_r = rell_inputs(shard.pad_patterns_for_ranks(eng.Pp, n))
    samples = torch.as_tensor(samples[:, sh.a:sh.b], device=dev)
    lp_r = torch.as_tensor(lp_r[sh.a:sh.b], device=dev)
    rell = (samples @ lp_r if reduce is None else
            shard.sharded_rell_fn(reduce)(samples.contiguous(), lp_r))
    cand = build_nni_candidates(tree, sched)
    P = pruning.transition_tensors(blens, sh.pack)
    dp, up = pruning.both_passes(P, sh.tipP, sa, sh.pack)
    logl, topt = shard.sharded_nni_fn(reduce)(
        np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id]), blens, dp,
        up.up_in, up.up_scale, sa, sh.pack, sh.pattern_weights, T_MIN,
        T_MAX)
    return {"slice": [sh.a, sh.b], "logL": float(logL),
            "lp": lp.tolist(), "step_blens": step_b.tolist(),
            "step_logL": float(step_logL), "rell": rell.tolist(),
            "nni_logl": logl.tolist(), "nni_topt": topt.tolist()}


def shard_rank(rank: int, n: int, names, sites, newick: str, model_str: str,
               asc: bool, device: str = "cpu") -> dict:
    """shard_outputs over the rank group, every rank on ``device``."""
    from iqtree2_tpu_torch.parallel import shard
    eng, tree, sched = shard_problem(names, sites, newick, model_str, asc,
                                     device)
    return shard_outputs(eng, tree, sched, rank, n, shard.all_reduce_sum())


# ------------------------------------------------------------------- RELL
def rell_rank(rank: int, n: int, names, sites, seed: int) -> dict:
    """UFBoot's RELL scores of one site lp on the group's pattern slices
    (enable_device_rell with the default group)."""
    import torch.distributed as dist

    from iqtree2_tpu_torch.data import seqtypes
    from iqtree2_tpu_torch.data.alignment import Alignment
    from iqtree2_tpu_torch.search.ufboot import UFBoot
    aln = Alignment.from_site_matrix(list(names), np.asarray(sites),
                                     seqtypes.get_seqtype("DNA"))
    uf = UFBoot(aln, n_replicates=50, seed=7)
    uf.enable_device_rell("cpu", group=dist.group.WORLD)
    lp = np.random.default_rng(seed).normal(-7.0, 1.0, aln.num_patterns)
    return {"rell": uf._rell_scores(lp).tolist()}
