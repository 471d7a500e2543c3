"""kernelcheck.check must fail a kernel that leaves rows unwritten.

On the CPU the wrappers run their plain versions, so an unchanged check
passes every kernel; a pass replaced by one that skips its work, one step's
writes or one slot of every step, must then fail that kernel alone. The
helpers that chip_smoke.py uses to set up its problems are tested here as
well.
"""

import re
from pathlib import Path

import pytest
import torch

from iqtree2_tpu_torch import kernelcheck
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.ops import kernels

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def problem():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    aln, tree, model, rates = kernelcheck.simulate("GTR+G4", 12, 200, seed=5)
    yield LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu"), tree
    torch.set_num_threads(n)


def _noop(*args):
    pass


def _steps_in_order(step_plain, steps):
    """Step indices in the order the pass walks them (postorder for the
    down pass, the reverse for the up pass)."""
    n = steps.shape[0]
    return range(n) if step_plain is kernels.down_step_plain \
        else range(n - 1, -1, -1)


def _skip_first_slot(step_plain):
    """The plain pass with the first slot of every step left out."""
    def pass_(*args):
        for s in _steps_in_order(step_plain, args[-1]):
            step_plain(*args[:-1], args[-1][s][1:])
    return pass_


def _skip_step(step_plain):
    """The plain pass with the writes of step 0 left out."""
    def pass_(*args):
        for s in _steps_in_order(step_plain, args[-1]):
            if s:
                step_plain(*args[:-1], args[-1][s])
    return pass_


def test_check_passes_plain_versions(problem):
    res = kernelcheck.check(*problem)
    assert [r["name"] for r in res] == ["down_pass", "root_sitelp",
                                        "up_pass", "edge_theta"]
    assert all(r["ok"] for r in res), res


@pytest.mark.parametrize("name,fake", [
    ("down_pass", _noop),
    ("down_pass", _skip_first_slot(kernels.down_step_plain)),
    ("down_pass", _skip_step(kernels.down_step_plain)),
    ("up_pass", _noop),
    ("up_pass", _skip_first_slot(kernels.up_step_plain)),
    ("up_pass", _skip_step(kernels.up_step_plain)),
], ids=["down_noop", "down_skip_slot", "down_skip_step", "up_noop",
        "up_skip_slot", "up_skip_step"])
def test_check_fails_unwritten_rows(problem, monkeypatch, name, fake):
    monkeypatch.setattr(kernels, name, fake)
    ok = {r["name"]: r["ok"] for r in kernelcheck.check(*problem)}
    assert ok == {k: k != name for k in ok}


@pytest.mark.parametrize("labels", [False, True], ids=["plain", "supports"])
def test_load_problem_golden(labels, tmp_path):
    """The flagship's problem (example.phy under GTR+G4) loads from a Newick
    file, with or without the integer supports a search writes, and every
    kernel passes its check at the flagship's pattern count."""
    nwk = (GOLDEN / "ref_tree.nwk").read_text()
    if labels:
        nwk = re.sub(r"\):", ")95:", nwk)
    path = tmp_path / "tree.nwk"
    path.write_text(nwk)
    aln, tree, model, rates = kernelcheck.load_problem(
        GOLDEN / "example.phy", path, "GTR+G4")
    assert (aln.ntaxa, tree.ntaxa) == (17, 17)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                           device="cpu")
    assert eng.Pp == 1152
    res = kernelcheck.check(eng, tree)
    assert all(r["ok"] for r in res), res


def test_perturbed_copies_and_moves():
    _, tree, _, _ = kernelcheck.simulate("GTR+G4", 40, 50, seed=3)
    before = tree.topology_id()
    a, n_a = kernelcheck.perturbed(tree, seed=2, strength=0.1)
    b, n_b = kernelcheck.perturbed(tree, seed=2, strength=0.1)
    assert tree.topology_id() == before
    assert n_a == n_b > 0
    assert a.topology_id() == b.topology_id() != before
