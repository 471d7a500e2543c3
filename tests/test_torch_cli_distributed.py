"""The port's distributed search through its command line: two ranks as
processes (jax and iqtree2_tpu blocked, as in tests/test_torch_nojax.py)
over FileGossip, with tests/test_cli_distributed.py's flags, write the
same tree, rank 1 under .rank1, and that tree is the port's
DistributedSearch's on one rank after the same quick fit (float32 on the
CPU, in this process); two ranks under torchrun's environment (no --dist-*
flag; TorchGossip over a gloo group) write the same tree, rank 1 under
.rank1; and every --dist-* and torchrun combination the port refuses.

The JAX command line's two-rank run of the same flags is not run here: it
takes over a minute on the CPU (compiles included), more than this file's
budget.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from iqtree2_tpu_torch import cli, kernelcheck
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io.alignment_io import read_alignment
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.optimize import optimize_model_parameters
from iqtree2_tpu_torch.ops.pars import random_stepwise_addition
from iqtree2_tpu_torch.parallel.dryrun import free_port
from iqtree2_tpu_torch.parallel.multihost import DistributedSearch, FileGossip
from iqtree2_tpu_torch.tree.topology import Tree

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
ALN = str(GOLDEN / "example.phy")
NEX = str(GOLDEN / "example.nex")
FLAGS = ["-s", ALN, "-m", "HKY", "-seed", "7", "-ninit", "6", "-ntop", "2",
         "-nbest", "2", "-n", "8"]
RUN = r"""
import sys
for name in ("jax", "optax", "iqtree2_tpu", "yaml"):
    sys.modules[name] = None
from iqtree2_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _splits(path, names) -> set:
    return set(Tree.from_newick(Path(path).read_text(), names).splits())


def _one_rank_tree(tmp_path) -> Tree:
    """analysis._run_distributed's search on one rank: the quick fit on the
    seed's stepwise-addition tree, then DistributedSearch with K = 4
    iterations a round for ceil(8 / 4) rounds."""
    aln = read_alignment(ALN)
    model, rates, _ = build_model("HKY", aln)
    eng = LikelihoodEngine(aln, model, rates, device="cpu")
    optimize_model_parameters(eng, random_stepwise_addition(
        aln, np.random.default_rng(7)), epsilon=0.1)
    tree, _ = DistributedSearch(
        eng, aln, FileGossip(tmp_path / "one", 0, 1, timeout=TIMEOUT), 0, 1,
        seed=7, n_init_trees=6, n_nni_trees=2, pop_size=2, round_size=4,
        n_rounds=2).run()
    return tree


def _run_ranks(argvs, envs) -> None:
    """The port's CLI on each argv (jax and iqtree2_tpu blocked), all at
    once, each with its env; every one killed after TIMEOUT seconds, and
    each must exit 0."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", RUN] + argv, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for argv, env in zip(argvs, envs)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (so[-1500:], se[-1500:])


def _env(**kw) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **kw)


def test_two_cli_ranks_agree(tmp_path):
    _run_ranks([FLAGS + [
        "--dist-nranks", "2", "--dist-rank", str(k), "--dist-dir",
        str(tmp_path / "gossip"), "--device", "cpu", "-pre",
        str(tmp_path / "run"), "--quiet"] for k in range(2)], [_env()] * 2)
    names = read_alignment(ALN).names
    s0 = _splits(tmp_path / "run.treefile", names)
    assert s0 == _splits(tmp_path / "run.rank1.treefile", names)
    for log in ("run.log", "run.rank1.log"):
        text = (tmp_path / log).read_text()
        assert "Wall seconds: quick fit" in text and "gossip" in text
    assert "Distributed ranks" in (tmp_path / "run.rank1.iqtree").read_text()
    assert s0 == set(_one_rank_tree(tmp_path).splits())


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """A small simulated alignment and its tree, written to files."""
    d = tmp_path_factory.mktemp("p")
    aln, tree, _, _ = kernelcheck.simulate("GTR+G4", 6, 60, seed=1)
    return kernelcheck.write_problem(aln, tree, d / "p")


def _torchrun(rank: int, port: int) -> dict:
    """torchrun's variables of ``rank`` of two."""
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
            "WORLD_SIZE": "2", "RANK": str(rank)}


def test_two_torchrun_ranks_agree(tmp_path, problem):
    """Under torchrun's environment and no --dist-* flag, two CLI ranks
    gossip over torch.distributed (gloo) and write the same tree, rank 1
    under .rank1."""
    phy, _ = problem
    port = free_port()
    _run_ranks([["-s", phy, "-m", "HKY", "-seed", "7", "-ninit", "4", "-n",
                 "4", "-bb", "20", "--device", "cpu", "-pre",
                 str(tmp_path / "run"), "--quiet"]] * 2,
               [_env(**_torchrun(k, port)) for k in range(2)])
    names = read_alignment(phy).names
    assert _splits(tmp_path / "run.treefile", names) == \
        _splits(tmp_path / "run.rank1.treefile", names)
    for pre in ("run", "run.rank1"):
        assert "(torch.distributed, gloo)" in \
            (tmp_path / f"{pre}.log").read_text()
        assert "Distributed ranks" in (tmp_path / f"{pre}.iqtree").read_text()
        assert len((tmp_path / f"{pre}.ufboot").read_text().splitlines()) \
            == 20


@pytest.mark.parametrize("argv,message", [
    (["-m", "GTR+G", "-te", "TREE"], "-te with torchrun \\(WORLD_SIZE=2\\): "
     "a -te tree is fixed"),
    (["-m", "GTR+G", "-b", "2"], "-b with torchrun .*C25"),
    (["-m", "TESTONLY"], "torchrun \\(WORLD_SIZE=2\\) with -m TESTONLY"),
    (["-m", "GTR+H2"], "-m GTR\\+H2 with torchrun \\(WORLD_SIZE=2\\): the "
     "distributed search is not held"),
])
def test_torchrun_combination_is_refused(tmp_path, problem, monkeypatch,
                                         argv, message):
    """Under torchrun's WORLD_SIZE > 1 the --dist-* refusals hold, before
    any process group is joined."""
    for k, v in _torchrun(1, free_port()).items():
        monkeypatch.setenv(k, v)
    phy, nwk = problem
    argv = [nwk if a == "TREE" else a for a in argv]
    with pytest.raises(SystemExit, match=message):
        cli.main(["-s", phy, "--device", "cpu", "-pre",
                  str(tmp_path / "x"), "--quiet"] + argv)
    assert not (tmp_path / "x.iqtree").exists()


DIST = ["--dist-nranks", "2", "--dist-dir", "GOSSIP"]


@pytest.mark.parametrize("argv,message", [
    (["-m", "GTR+G", "--dist-nranks", "2"],
     "--dist-nranks > 1 requires --dist-dir"),
    (["-m", "GTR+G", "--dist-rank", "1"],
     "--dist-rank/--dist-dir: act in a distributed search"),
    (["-m", "GTR+G", "--dist-dir", "GOSSIP"],
     "--dist-rank/--dist-dir: act in a distributed search"),
    (["-m", "GTR+G", "--dist-rank", "2"] + DIST, "--dist-rank 2: the ranks"),
    (["-p", NEX] + DIST,
     "-p/-spp with --dist-nranks: the JAX package's partition path"),
    (["-q", NEX] + DIST, "-q\\S* with --dist-nranks"),
    (["-Q", NEX] + DIST, "-Q\\S* with --dist-nranks"),
    (["-S", NEX] + DIST, "-S\\S* with --dist-nranks"),
    (["-m", "GTR+G", "-te", "TREE"] + DIST,
     "-te with --dist-nranks: a -te tree is fixed"),
    (["-m", "GTR+G+T", "-te", "TREE"] + DIST, "-te with --dist-nranks"),
    (["-m", "GTR+G", "-b", "2"] + DIST,
     "-b with --dist-nranks: reruns the analysis .*C25"),
    (["-m", "GTR+G", "--runs", "2"] + DIST,
     "--runs with --dist-nranks: reruns the analysis .*C25"),
    (["-m", "LG+C10+G", "--pmsf"] + DIST, "--pmsf with --dist-nranks"),
    (["-m", "TESTONLY"] + DIST, "--dist-nranks with -m TESTONLY"),
    (["-r", "10"] + DIST, "--dist-nranks with the standalone tool "
     "random_tree"),
    (["-m", "GTR+H2"] + DIST, "-m GTR\\+H2 with --dist-nranks: the "
     "distributed search is not held"),
    (["-m", "UNREST+G"] + DIST, "-m UNREST\\+G with --dist-nranks"),
])
def test_dist_combination_is_refused(tmp_path, problem, argv, message):
    phy, nwk = problem
    argv = [str(tmp_path / "g") if a == "GOSSIP" else nwk if a == "TREE"
            else a for a in argv]
    with pytest.raises(SystemExit, match=message):
        cli.main(["-s", phy, "--device", "cpu", "-pre",
                  str(tmp_path / "x"), "--quiet"] + argv)
    assert not (tmp_path / "x.iqtree").exists()
    assert not (tmp_path / "g").exists()
