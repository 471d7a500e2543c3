"""dryrun_multichip: the sharded likelihood and the gossip on n ranks
(counterpart of __graft_entry__.dryrun_multichip), and search_multichip,
the distributed search on n ranks.

    python -m iqtree2_tpu_torch.parallel.dryrun N BACKEND DEVICE [--f64]

spawns N ranks (torch.multiprocessing, start method spawn, which CUDA
needs) joined by a torch.distributed group of the caller's BACKEND (gloo
or nccl) on DEVICE (cpu, or cuda: rank k on card k mod the card count),
and checks on a GTR+G4 problem (kernelcheck.MODELS: a 12-taxon, 600-site
simulation, or a problem the caller passes, which the spawn pickles to
every rank):

  (a) the sharded logL equals the unsharded engine's;
  (b) a sharded optimize step (down pass, theta pass, 4 Newton iterations
      with summed derivatives) runs and gives a finite logL;
  (c) its branch lengths equal the unsharded step's;
  (d) the sharded RELL equals the host matvec;
  (e) the sharded NNI batch equals the unsharded batch;
  (f) one gossip round over TorchGossip (a gloo group).

The tolerances are the JAX dry run's: logL within 5e-3 + 1e-6 |logL|,
lengths within 5e-3, RELL within 1e-2 of the largest score, NNI logLs
within 5e-3 + 1e-6 of the largest. Rank 0 computes the unsharded
references on its device, the other ranks build their engine on the CPU
and move only their slice to theirs. On a card each rank counts its
kernels' launches per check (one per pass) and its peak device memory
over the sharded checks. Nothing here picks the backend or the device: a
missing card or a backend that cannot start raises.
"""

from __future__ import annotations

import argparse
import datetime
import json
import socket
import sys
import time

import numpy as np
import torch

# the JAX dry run's tolerances
LOGL_TOL, LOGL_REL = 5e-3, 1e-6
BLEN_TOL = 5e-3
RELL_REL = 1e-2
NNI_TOL, NNI_REL = 5e-3, 1e-6
RELL_REPLICATES = 32
TOY_TAXA, TOY_SITES = 12, 600
TIME_REPS = 3


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def toy_problem():
    """(Alignment, Tree, model, rates) of the default dry run."""
    from iqtree2_tpu_torch import kernelcheck
    return kernelcheck.simulate("GTR+G4", TOY_TAXA, TOY_SITES, seed=0)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, dev, reps: int = TIME_REPS) -> float:
    """Mean wall milliseconds of fn() after one warm-up, the card drained
    before and after (a sharded call waits for its collectives anyway)."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _rank_checks(rank: int, n: int, dev, dtype, gossip_group,
                 problem) -> dict:
    import torch.distributed as dist

    from iqtree2_tpu_torch.engine import (DEFAULT_MAX_BLEN, DEFAULT_MIN_BLEN,
                                          LikelihoodEngine)
    from iqtree2_tpu_torch.ops import kernels, pruning
    from iqtree2_tpu_torch.ops.nni import build_nni_candidates
    from iqtree2_tpu_torch.parallel import shard
    from iqtree2_tpu_torch.parallel.multihost import TorchGossip
    from iqtree2_tpu_torch.tree.schedule import build_schedule

    aln, tree, model, rates = problem
    eng = LikelihoodEngine(aln, model, rates, dtype=dtype,
                           device=dev if rank == 0 else "cpu")
    sched = build_schedule(tree)
    sa = {k: v.to(dev) for k, v in eng.schedule_arrays(sched).items()}
    blens = torch.as_tensor(sched.blens, dtype=dtype, device=dev)
    sh = shard.shard_engine_arrays(eng, rank, n, device=dev)
    reduce = shard.all_reduce_sum()
    t_min, t_max = DEFAULT_MIN_BLEN, DEFAULT_MAX_BLEN
    out = {"rank": rank, "slice": [sh.a, sh.b], "launches": {}}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def counted(tag, fn):
        kernels.reset_launch_counts()
        res = fn()
        _sync(dev)
        out["launches"][tag] = dict(kernels.LAUNCHES)
        return res

    loglik = shard.sharded_loglik_fn(reduce)
    logL_s, _ = counted("loglik", lambda: loglik(
        blens, sh.tipP, sa, sh.pack, sh.pattern_weights))
    step = shard.sharded_optimize_step_fn(reduce)

    def sharded_step():
        return step(blens, sh.tipP, sa, sh.pack, sh.pattern_weights, t_min,
                    t_max)
    new_b, logL_step = counted("step", sharded_step)
    dist.barrier()
    out["step_ms"] = _ms(sharded_step, dev)

    total = shard.pad_patterns_for_ranks(eng.Pp, n)
    rng = np.random.default_rng(1)
    samples = rng.poisson(1.0, size=(RELL_REPLICATES, total))
    lp = rng.normal(-8.0, 1.0, size=total)
    rell = shard.sharded_rell_fn(reduce)(
        torch.as_tensor(samples[:, sh.a:sh.b], dtype=dtype,
                        device=dev).contiguous(),
        torch.as_tensor(lp[sh.a:sh.b], dtype=dtype, device=dev))

    cand = build_nni_candidates(tree, sched)
    cand_arrays = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])
    P = pruning.transition_tensors(blens, sh.pack)
    dp, up = counted("nni passes", lambda: pruning.both_passes(
        P, sh.tipP, sa, sh.pack))
    logl_s, topt_s = shard.sharded_nni_fn(reduce)(
        cand_arrays, blens, dp, up.up_in, up.up_scale, sa, sh.pack,
        sh.pattern_weights, t_min, t_max)
    _sync(dev)
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30

    got = TorchGossip(rank, n, group=gossip_group).allgather(
        0, {"rank": rank, "logL": float(logL_s)})
    if [g["rank"] for g in got] != list(range(n)) or len(
            {g["logL"] for g in got}) != 1:
        raise AssertionError(f"(f) gossip round gave {got}")
    del dp, up, P
    if rank != 0:
        return out

    # the unsharded references, on rank 0's full engine
    logL_1 = eng.loglik_sched(sched)
    err = abs(float(logL_s) - logL_1)
    out["logL"] = [float(logL_s), logL_1]
    out["logL_err"] = err
    if not err <= LOGL_TOL + LOGL_REL * abs(logL_1):
        raise AssertionError(f"(a) sharded logL {float(logL_s)} != "
                             f"unsharded {logL_1} (|diff| {err})")
    if not np.isfinite(float(logL_step)):
        raise AssertionError(f"(b) sharded step logL {float(logL_step)}")
    ref_step = shard.sharded_optimize_step_fn(None)

    def unsharded_step():
        return ref_step(blens, eng._tipP, sa, eng._pack, eng._pw, t_min,
                        t_max)
    ref_b, ref_logL = unsharded_step()
    out["unsharded_step_ms"] = _ms(unsharded_step, dev)
    bdiff = float((new_b - ref_b).abs().max())
    out["blen_err"] = bdiff
    out["step_logL"] = [float(logL_step), float(ref_logL)]
    if not bdiff <= BLEN_TOL:
        raise AssertionError(f"(c) sharded Newton lengths differ from the "
                             f"unsharded step's by {bdiff}")
    want = samples.astype(np.float64) @ lp
    rdiff = float(np.abs(rell.double().cpu().numpy() - want).max())
    out["rell_err"] = rdiff / float(np.abs(want).max())
    if not rdiff <= RELL_REL * float(np.abs(want).max()):
        raise AssertionError(f"(d) sharded RELL differs by {rdiff}")
    P1 = pruning.transition_tensors(blens, eng._pack)
    dp1, up1 = pruning.both_passes(P1, eng._tipP, sa, eng._pack)
    logl_1, topt_1 = shard.sharded_nni_fn(None)(
        cand_arrays, blens, dp1, up1.up_in, up1.up_scale, sa, eng._pack,
        eng._pw, t_min, t_max)
    ndiff = float((logl_s - logl_1).abs().max())
    out["nni_err"] = ndiff
    out["nni_topt_err"] = float((topt_s - topt_1).abs().max())
    if not ndiff <= NNI_TOL + NNI_REL * float(logl_1.abs().max()):
        raise AssertionError(f"(e) sharded NNI batch differs by {ndiff}")
    return out


def _rank_search(rank: int, n: int, dev, dtype, gossip_group, problem,
                 kw: dict) -> dict:
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.ops import kernels
    from iqtree2_tpu_torch.parallel.multihost import (DistributedSearch,
                                                      TorchGossip)
    aln, _, model, rates = problem
    eng = LikelihoodEngine(aln, model, rates, dtype=dtype, device=dev)
    ds = DistributedSearch(eng, aln, TorchGossip(rank, n, gossip_group),
                           rank, n, **kw)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tree, logL = ds.run()
    _sync(dev)
    return {"rank": rank, "tid": tree.topology_id(), "logL": logL,
            "newick": tree.to_newick(), "wall": time.perf_counter() - t0,
            "seconds": ds.seconds, "launches": dict(kernels.LAUNCHES)}


def _rank_main(rank: int, job, n: int, backend: str, device: str, f64: bool,
               port: int, timeout: float, queue, args) -> None:
    import torch.distributed as dist
    if device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device(device, rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=n,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    try:
        # the gossip is host JSON: gloo whatever the likelihood's backend
        gossip_group = None if backend == "gloo" else dist.new_group(
            backend="gloo")
        queue.put(job(rank, n, dev, torch.float64 if f64 else torch.float32,
                      gossip_group, *args))
    finally:
        dist.destroy_process_group()


def _spawn(job, n_ranks: int, backend: str, device: str, f64: bool,
           timeout: float, *args) -> list[dict]:
    """job(rank, n, device, dtype, gossip group, *args) on each of
    ``n_ranks`` spawned ranks; their reports in rank order. A rank that
    raises ends the others (torch.multiprocessing.start_processes)."""
    import torch.multiprocessing as mp
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: cpu or cuda")
    if device == "cuda":
        # build once here: the ranks load the library this leaves behind
        from iqtree2_tpu_torch.ops import kernels
        kernels.build_library()
    queue = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_rank_main, nprocs=n_ranks, join=True,
                       start_method="spawn",
                       args=(job, n_ranks, backend, device, f64, free_port(),
                             timeout, queue, args))
    reports = [queue.get() for _ in range(n_ranks)]
    return sorted(reports, key=lambda r: r["rank"])


def dryrun_multichip(n_ranks: int, backend: str, device: str,
                     problem=None, f64: bool = False,
                     timeout: float = 120.0) -> list[dict]:
    """Run checks (a)-(f) on ``n_ranks`` spawned ranks over ``backend``
    on ``device`` (on toy_problem() where ``problem`` is None); raises
    where a check fails or a rank does not finish. Returns each rank's
    report (rank 0's with the references' errors and the unsharded step's
    ms), in rank order. ``timeout`` bounds the group's rendezvous and each
    collective (seconds)."""
    return _spawn(_rank_checks, n_ranks, backend, device, f64, timeout,
                  problem or toy_problem())


def search_multichip(n_ranks: int, backend: str, device: str, problem,
                     f64: bool = False, timeout: float = 120.0,
                     **kw) -> list[dict]:
    """parallel/multihost.DistributedSearch (keywords ``kw``) on
    ``n_ranks`` spawned ranks over TorchGossip, each with an engine of
    ``problem`` (Alignment, Tree, model, rates) on ``device``. Returns
    each rank's tree (topology id, Newick), logL, walls and kernel
    launches, in rank order."""
    return _spawn(_rank_search, n_ranks, backend, device, f64, timeout,
                  problem, kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("backend")
    ap.add_argument("device")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args(argv)
    for rep in dryrun_multichip(args.n, args.backend, args.device,
                                f64=args.f64):
        print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
