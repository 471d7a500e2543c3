"""Multi-process distributed tree search: replicated controllers with
candidate-tree gossip, deterministic BSP rounds, and UFBoot state merge
(counterpart of iqtree2_tpu/parallel/multihost.py).

Reference analog: the MPI search parallelism (utils/MPIHelper.h:118-136
sendCheckpoint/recvCheckpoint, tree/iqtree.cpp:4337 syncCandidateTrees,
:4406 syncCurrentTree, :4479 sendStopMessage): each rank runs independent
perturb+NNI iterations and exchanges candidate trees / UFBoot deltas as
serialized key-value blobs.

Redesign for determinism, copied from the JAX package: search proceeds in
BSP (bulk-synchronous) ROUNDS of K iterations. Iteration i is owned by rank
(i mod nranks); its RNG stream is seeded by (seed, 0xD15C0, i) and it
perturbs a candidate chosen from the LAST ROUND's merged candidate
snapshot, and the merge applies every iteration's result in iteration
order, so the merged state after every round is a pure function of (seed,
data), independent of the number of ranks: an n-process run gives the
1-process run's tree.

UFBoot differs from the JAX package's (ROADMAP C26): there each rank
RELL-scores its own iterations' trees on its own replicate slice, so a
slice's replicates never see another rank's trees. Here every result
carries its tree's site log-likelihoods and every rank RELL-scores every
round's trees on all replicates in iteration order, as one rank does: n
ranks keep one rank's champions, with no replicate slices and no last
exchange.

Transports:
  - FileGossip: shared-directory barrier files (copied; several processes
    on one host, or a shared filesystem);
  - TorchGossip: dist.all_gather_object over a gloo group, the counterpart
    of the JAX package's JaxGossip (process_allgather over
    jax.distributed). The gossip is host JSON and never needs NCCL.

init_distributed() sets torch.distributed up from torchrun's environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) where the JAX package's reads
JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from pathlib import Path

import numpy as np

from iqtree2_tpu_torch.ops.pars import random_stepwise_addition
from iqtree2_tpu_torch.search.candidate import CandidateSet
from iqtree2_tpu_torch.search.nni import nni_optimize
from iqtree2_tpu_torch.search.perturb import random_nnis
from iqtree2_tpu_torch.tree.topology import Tree


# seconds a rank waits at a gossip barrier or collective (FileGossip's
# default too): a rank that never arrives fails the others' runs
GROUP_TIMEOUT = 600.0


def torchrun_world() -> tuple[int, int]:
    """(RANK, WORLD_SIZE) of torchrun's environment, (0, 1) outside it."""
    return (int(os.environ.get("RANK", "0")),
            int(os.environ.get("WORLD_SIZE", "1")))


def init_distributed(backend: str = "gloo") -> tuple[int, int]:
    """Initialise torch.distributed's default group from torchrun's
    environment when it names more than one process (a group already
    initialised is kept), its collectives bounded by GROUP_TIMEOUT.
    ``backend`` is the caller's: gloo for the gossip's host objects.
    Returns (rank, world size)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank, world = torchrun_world()
    if world > 1:
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                                 f"{os.environ['MASTER_PORT']}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    return rank, world


class FileGossip:
    """Shared-directory all-gather of JSON blobs with a round barrier.

    Round files are never removed: a directory holds one run's rounds
    (a second run in the same directory reads the first one's, ROADMAP
    C25)."""

    def __init__(self, root: str | Path, rank: int, nranks: int,
                 timeout: float = GROUP_TIMEOUT):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.rank = rank
        self.nranks = nranks
        self.timeout = timeout

    def allgather(self, round_id: int, payload: dict) -> list[dict]:
        me = self.root / f"r{round_id:06d}_rank{self.rank}.json"
        tmp = me.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(me)
        out = []
        t0 = time.time()
        for k in range(self.nranks):
            f = self.root / f"r{round_id:06d}_rank{k}.json"
            while not f.exists():
                if time.time() - t0 > self.timeout:
                    raise TimeoutError(f"gossip barrier timed out on {f}")
                time.sleep(0.02)
            while True:   # atomic rename guarantees full content
                try:
                    out.append(json.loads(f.read_text()))
                    break
                except json.JSONDecodeError:
                    time.sleep(0.02)
        return out


class TorchGossip:
    """All-gather of JSON-able payloads over a torch.distributed gloo group
    (``group``; the default group where None, which must then be gloo)."""

    def __init__(self, rank: int, nranks: int, group=None):
        self.rank = rank
        self.nranks = nranks
        self.group = group

    def allgather(self, round_id: int, payload: dict) -> list[dict]:
        import torch.distributed as dist
        out: list = [None] * self.nranks
        dist.all_gather_object(out, (round_id, payload), group=self.group)
        rounds = [r for r, _ in out]
        if rounds != [round_id] * self.nranks:
            raise RuntimeError(f"gossip ranks out of step: rounds {rounds}")
        return [p for _, p in out]


class DistributedSearch:
    """BSP-round tree search over any gossip transport.

    A 1-rank instance is the deterministic serial reference; n ranks
    split each round's iterations and merge results identically.
    ``seconds`` splits the wall of run(): start trees (round 0 before its
    gossip), iterations (rounds 1.. before theirs) and gossip (all
    exchanges and merges, barrier waits included)."""

    def __init__(self, eng, aln, gossip, rank: int, nranks: int,
                 seed: int = 1, n_init_trees: int = 20,
                 n_nni_trees: int = 10, pop_size: int = 5,
                 round_size: int | None = None, n_rounds: int = 4,
                 pertub_strength: float = 0.5, ufboot=None,
                 log=lambda s: None, constraint=None):
        self.eng = eng
        self.aln = aln
        self.gossip = gossip
        self.rank = rank
        self.nranks = nranks
        self.seed = seed
        self.n_init = n_init_trees
        self.pop_size = pop_size
        self.round_size = round_size or max(nranks, 4)
        self.n_rounds = n_rounds
        self.strength = pertub_strength
        self.cands = CandidateSet(max_size=n_nni_trees, max_top=pop_size)
        self.ufboot = ufboot
        self.log = log
        self.constraint = constraint   # -g topology constraint (enforced
        #                                in starts, perturbation and NNI)
        self.seconds = {"start trees": 0.0, "iterations": 0.0,
                        "gossip": 0.0}

    # ------------------------------------------------------------ helpers
    def _iter_result(self, i: int, snapshot: list[tuple[str, float]]):
        """Run ONE search iteration with an iteration-seeded RNG stream
        against the frozen candidate snapshot."""
        rng = np.random.default_rng((self.seed, 0xD15C0, i))
        k = min(self.pop_size, len(snapshot))
        nwk, _ = snapshot[rng.integers(0, k)]
        t = Tree.from_newick(nwk, self.aln.names)
        random_nnis(t, rng, self.strength, constraint=self.constraint)
        res = nni_optimize(self.eng, t, loglh_epsilon=0.001,
                           constraint=self.constraint)
        return t, res.logL

    def _result(self, t: Tree, logL: float) -> list:
        """[Newick, logL] of one iteration, and with UFBoot the tree's site
        log-likelihoods, which every rank RELL-scores."""
        out = [t.to_newick(digits=17), logL]
        if self.ufboot is not None:
            out.append(self.eng.site_lp(t)[1].tolist())
        return out

    def _merge_round(self, blobs: list[dict]) -> None:
        """Deterministic merge: apply every iteration's result in
        iteration order (the merged state is rank-count independent)."""
        items = []
        for blob in blobs:
            for it_s, res in blob["results"].items():
                items.append((int(it_s), *res))
        for i, nwk, logL, *lp in sorted(items, key=lambda x: x[0]):
            t = Tree.from_newick(nwk, self.aln.names)
            self.cands.update(t, float(logL))
            if self.ufboot is not None:
                self.ufboot.add_tree(t, np.asarray(lp[0]),
                                     tree_logL=float(logL))

    def _exchange(self, round_id: int, results: dict) -> None:
        t0 = time.perf_counter()
        self._merge_round(self.gossip.allgather(
            round_id, {"results": {str(k): v for k, v in results.items()}}))
        self.seconds["gossip"] += time.perf_counter() - t0

    # --------------------------------------------------------------- run
    def run(self):
        # round 0: deterministic init (identical on all ranks, iteration
        # split): stepwise-addition parsimony starts
        t0 = time.perf_counter()
        results: dict[int, list] = {}
        for i in range(self.n_init):
            if i % self.nranks != self.rank:
                continue
            rng = np.random.default_rng((self.seed, 0x1217, i))
            t = random_stepwise_addition(self.aln, rng,
                                         constraint=self.constraint)
            logL = self.eng.optimize_branches(t, n_rounds=4)
            results[i] = self._result(t, logL)
        self.seconds["start trees"] = time.perf_counter() - t0
        self._exchange(0, results)

        for rnd in range(1, self.n_rounds + 1):
            t0 = time.perf_counter()
            snapshot = [(it.tree.to_newick(digits=17), it.logL)
                        for it in self.cands.items]
            results = {}
            base = rnd * 1_000_000
            for j in range(self.round_size):
                i = base + j
                if j % self.nranks != self.rank:
                    continue
                results[i] = self._result(*self._iter_result(i, snapshot))
            self.seconds["iterations"] += time.perf_counter() - t0
            self._exchange(rnd, results)
            self.log(f"[rank {self.rank}] round {rnd}: best "
                     f"{self.cands.best_score():.4f}")
        best = self.cands.best()
        return best.tree.copy(), best.logL
