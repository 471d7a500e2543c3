"""kernelcheck.check must fail a kernel that leaves rows unwritten.

On the CPU the wrappers run their plain versions, so an unchanged check
passes every kernel; a pass replaced by one that skips its work, one step's
writes or one slot of every step, the site-logL epilogue, one edge's theta
or edge 0's, or that reads the tip rows of the unified buffer instead of
the tips, must then fail that kernel alone. The helpers that chip_smoke.py
uses to set up its problems are tested here as well.
"""

import re
from pathlib import Path

import numpy as np
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


def _noop(*args, **kw):
    pass


def _steps_in_order(step_plain, steps):
    """Step indices in the order the pass walks them (postorder for the
    down pass, the reverse for the up pass)."""
    n = steps.shape[0]
    return range(n) if step_plain is kernels.down_step_plain \
        else range(n - 1, -1, -1)


def _skip_first_slot(step_plain):
    """The plain pass with the first slot of every step left out."""
    def pass_(*args, **kw):
        for s in _steps_in_order(step_plain, args[-1]):
            step_plain(*args[:-1], args[-1][s][1:])
    return pass_


def _skip_step(step_plain):
    """The plain pass with the writes of step 0 left out."""
    def pass_(*args, **kw):
        for s in _steps_in_order(step_plain, args[-1]):
            if s:
                step_plain(*args[:-1], args[-1][s])
    return pass_


def _down_without_epilogue(*args, sitelp=None):
    """The plain down pass that leaves lp unwritten."""
    kernels.down_pass_plain(*args)


def _down_reading_tip_rows(P, tip, all_, *rest, sitelp=None):
    """The plain down pass taking its tips from the unified buffer's tip
    rows."""
    kernels.down_pass_plain(P, all_[:tip.shape[0], 0].contiguous(), all_,
                            *rest, sitelp=sitelp)


def _theta_skipping(edge):
    """The plain theta pass with one edge's theta and scale left out."""
    def pass_(*args):
        th, tsc = args[6], args[7]
        tmp_th, tmp_sc = th.clone(), tsc.clone()
        kernels.theta_pass_plain(*args[:6], tmp_th, tmp_sc, *args[8:])
        keep = torch.ones(th.shape[0], dtype=torch.bool)
        keep[edge] = False
        th[keep] = tmp_th[keep]
        tsc[keep] = tmp_sc[keep]
    return pass_


def _theta_reading_tip_rows(P, tip, all_, *rest):
    """The plain theta pass taking its tips from the unified buffer's tip
    rows."""
    kernels.theta_pass_plain(P, all_[:tip.shape[0], 0].contiguous(), all_,
                             *rest)


def test_check_passes_plain_versions(problem):
    res = kernelcheck.check(*problem)
    assert [r["name"] for r in res] == ["down_pass", "up_pass",
                                        "theta_pass"]
    assert all(r["ok"] for r in res), res


@pytest.mark.parametrize("name,fake", [
    ("down_pass", _noop),
    ("down_pass", _skip_first_slot(kernels.down_step_plain)),
    ("down_pass", _skip_step(kernels.down_step_plain)),
    ("down_pass", _down_without_epilogue),
    ("down_pass", _down_reading_tip_rows),
    ("up_pass", _noop),
    ("up_pass", _skip_first_slot(kernels.up_step_plain)),
    ("up_pass", _skip_step(kernels.up_step_plain)),
    ("theta_pass", _noop),
    ("theta_pass", _theta_skipping(-1)),
    ("theta_pass", _theta_skipping(0)),
    ("theta_pass", _theta_reading_tip_rows),
], ids=["down_noop", "down_skip_slot", "down_skip_step", "down_skip_lp",
        "down_reads_tip_rows", "up_noop", "up_skip_slot", "up_skip_step",
        "theta_noop", "theta_skip_edge", "theta_skip_edge0",
        "theta_reads_tip_rows"])
def test_check_fails_unwritten_rows(problem, monkeypatch, name, fake):
    monkeypatch.setattr(kernels, name, fake)
    ok = {r["name"]: r["ok"] for r in kernelcheck.check(*problem)}
    assert ok == {k: k != name for k in ok}


MUTANTS = [
    ("down_pass", _skip_first_slot(kernels.down_step_plain)),
    ("down_pass", _down_without_epilogue),
    ("up_pass", _skip_step(kernels.up_step_plain)),
    ("theta_pass", _theta_skipping(-1)),
    ("theta_pass", _theta_reading_tip_rows)]


@pytest.mark.parametrize("name,fake", MUTANTS, ids=[
    "down_skip_slot", "down_skip_lp", "up_skip_step", "theta_skip_edge",
    "theta_reads_tip_rows"])
def test_windowed_check_fails_unwritten_rows(problem, monkeypatch, name,
                                             fake):
    """With the plain references run window by window (the large mixture
    problems' check), the plain versions pass with the whole problem's
    errors and a mutant fails its kernel alone."""
    eng, tree = problem
    assert kernelcheck.windows(eng.Pp, 50)[-1] == (100, 128)   # ragged
    whole = kernelcheck.check(eng, tree)
    res = kernelcheck.check(eng, tree, window=50)
    assert all(r["ok"] for r in res) and [r["max_rel_err"] for r in res] \
        == [r["max_rel_err"] for r in whole]
    monkeypatch.setattr(kernels, name, fake)
    ok = {r["name"]: r["ok"] for r in kernelcheck.check(eng, tree,
                                                         window=50)}
    assert ok == {k: k != name for k in ok}


def test_plain_window_keeps_the_temporaries_in_budget(problem):
    eng, _ = problem
    assert kernelcheck.plain_window(eng) is None
    per = (2 * 12 - 3) * 4 * 4 * 4 * 8      # n_edges * C * S * S * 8 bytes
    assert kernelcheck.plain_window(eng, budget=per * 50) == 50


def test_theta_bound_counts_its_result_only(problem):
    """theta_pass's bytes: each input read once (P, tips, the schedule, the
    down pass's internal rows and scales, U, V, pi) and theta with its scale
    written once; E and UP are the sweep's intermediates, not its result."""
    eng, tree = problem
    pb = kernelcheck.Problem(eng, tree)
    dp = pb.down(kernels.down_pass_plain, pb.down_buffers())
    t = pb.theta_buffers()
    want = sum(x.numel() * x.element_size() for x in (
        pb.P, pb.tipP, pb.cs, pb.ce, pb.steps, dp.all[pb.L:],
        dp.scale[pb.L:], pb.U, pb.V, pb.pack["root_freqs"], t.theta,
        t.scale))
    assert kernelcheck.bounds(eng, tree)["theta_pass"]["bytes"] == want


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


@pytest.mark.parametrize("n_loci", [2, 10])
def test_simulated_loci_lack_taxa_but_cover_all(n_loci, tmp_path):
    """simulate_loci (phase 12d's supermatrix): every locus lacks its share
    of the taxa, yet every taxon has data somewhere, and the partition
    file written for it reads back with the same presence."""
    from iqtree2_tpu_torch.data.superalignment import read_partition_spec
    model = kernelcheck.MODELS["GTR+G4"][2]
    sa, tree, _, _ = kernelcheck.simulate_loci(
        [("DNA", model, 60, 0.5, 1.0)] * n_loci, 30, seed=4)
    assert sorted(sa.names) == sorted(f"t{i}" for i in range(30))
    assert tree.taxon_names == sa.names
    present = np.array(sa.part_presence)
    assert present.any(axis=0).all()
    assert (present[:-1].sum(axis=1) == 15).all()
    back = read_partition_spec(kernelcheck.write_partitioned(
        sa, ["GTR+G"] * n_loci, tmp_path))
    assert back.names == sa.names
    np.testing.assert_array_equal(np.array(back.part_presence), present)


@pytest.mark.parametrize("window", [None, 50])
def test_check_times_every_pass(problem, monkeypatch, window):
    """check(time_reps=...)'s timing closures, run on the CPU with the
    card's clocks replaced by a call count: each kernel and each plain
    version (window by window) runs, every time key is filled."""
    calls = []

    def clock(fn, reps=1):
        fn()
        calls.append(reps)
        return 1.0

    monkeypatch.setattr(kernelcheck, "timed_ms", clock)
    monkeypatch.setattr(kernelcheck, "back_to_back_ms", clock)
    res = kernelcheck.check(*problem, time_reps=3, window=window,
                            b2b_reps=2)
    assert all(r["ms"] == r["plain_ms"] == r["b2b_ms"] == 1.0 for r in res)
    assert res[0]["sitelp_ms"] == res[0]["sitelp_b2b_ms"] == 1.0
    plain_reps = 3 if window is None else 1
    assert sorted(calls) == sorted([plain_reps, 3, 3, plain_reps, 2] * 4)


@pytest.mark.parametrize("model_name", ["GY+F3X4+G4", "JC2+G4", "MK7+G4"])
def test_bounds_count_the_state_space_of_the_tensors(model_name):
    """At 61 (codons), 2 and 7 states the bounds' bytes are the sizes of
    the tensors each pass reads and writes (down_pass: P, tips, the
    schedule, the internal rows with their scales; theta_pass as above),
    and the operations follow S from the tip partials."""
    aln, tree, model, rates = kernelcheck.simulate(model_name, 9, 40, seed=2)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                           device="cpu")
    pb = kernelcheck.Problem(eng, tree)
    S = pb.tipP.shape[1]
    assert S == {"GY+F3X4+G4": 61, "JC2+G4": 2, "MK7+G4": 7}[model_name]
    dp = pb.down(kernels.down_pass_plain, pb.down_buffers())
    t = pb.theta_buffers()
    size = lambda *xs: sum(x.numel() * x.element_size() for x in xs)
    ops = (pb.P, pb.tipP, pb.cs, pb.ce, pb.steps, dp.all[pb.L:],
           dp.scale[pb.L:])
    bnd = kernelcheck.bounds(eng, tree)
    assert bnd["down_pass"]["bytes"] == size(*ops)
    assert bnd["theta_pass"]["bytes"] == size(
        *ops, pb.U, pb.V, pb.pack["root_freqs"], t.theta, t.scale)
    C, Pp = pb.P.shape[1], pb.tipP.shape[-1]
    assert bnd["down_pass"]["flops"] == pb.n_int * Pp * C * (4 * S * S + S)


def test_build_parts_define_every_bound_symbol_once():
    """kernels.build_parts finds each IQ_PART unit of csrc/pruning.cu, and
    the units together define every launcher and occupancy query that
    kernels.bind declares, each in one unit only."""
    src = kernels.SOURCE.read_text()
    blocks = re.findall(r"#if !defined\(IQ_PART\) \|\| IQ_PART == (\d+)\n"
                        r"(.*?)#endif", src, re.S)
    assert [int(k) for k, _ in blocks] == kernels.build_parts(src.encode())
    defined = []
    for _, body in blocks:
        defined += [f"iq_{kind.lower()}_{sfx}" for kind, sfx in re.findall(
            r"^IQ_(DOWN_PASS|UP_PASS|THETA_PASS)\((\w+),", body, re.M)]
        defined += [f"iq_pass_occupancy_{kind}_{sfx}" for kind, sfx in
                    re.findall(r"^IQ_PASS_OCCUPANCY\((\w+), \d, (\w+),",
                               body, re.M)]
    expected = [f"iq_{name}_{sfx}" for sfx in kernels._SUFFIX.values()
                for name in kernels._SIGNATURES]
    expected += [f"iq_pass_occupancy_{kind}_{sfx}"
                 for sfx in kernels._SUFFIX.values()
                 for kind in kernels.PASS_KINDS]
    assert sorted(defined) == sorted(expected)
