"""Each Hopper kernel held against its plain PyTorch version on the card.

Used by chip_smoke.py and tests/test_torch_cuda.py (the parity tests use
its ``simulate``). A problem is an alignment simulated under one of MODELS on
a random topology; every kernel then gets exactly the inputs its plain
version gets:

- down_step: the plain down pass is the reference; the kernel runs every
  step on a copy of it, last step first, so each step reads reference rows;
- root_sitelp and edge_theta: one call each on the reference passes;
- up_step: the plain up pass is the reference; the kernel runs the steps on
  a copy in postorder (the reverse of the sweep), so each step reads the
  reference UP of its nodes.

Just before a step runs, the rows it writes are set to a sentinel (NaN
partials, scale count -1), so a row the kernel leaves unwritten fails the
comparison instead of passing as the reference's copy.

Errors are relative per (row, pattern) column: max |kernel - plain| over the
C x S values over their largest |plain|, the scale that the per-pattern
rescale also uses (theta mixes signs, so element-wise ratios of values that
cancel say nothing). Site log-likelihoods are compared absolutely in
float32 and relative to max(|lp|, 1) in float64. Scale counts must be equal.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from iqtree2_tpu.data.alignment import Alignment
from iqtree2_tpu.io.alignment_io import read_alignment, write_phylip
from iqtree2_tpu.model.factory import build_model
from iqtree2_tpu.search.perturb import random_nnis
from iqtree2_tpu.simulator import simulate_alignment
from iqtree2_tpu.tree.schedule import build_schedule
from iqtree2_tpu.tree.topology import Tree
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.ops import kernels, pruning

# name -> (sequence type, state alphabet, model string with every parameter
# fixed, so the problem is the same in every run)
MODELS = {
    "GTR+G4": ("DNA", "ACGT",
               "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+G{0.6}"),
    "LG+G4": ("AA", "ARNDCQEGHILKMFPSTWYV", "LG+G{0.6}"),
    "HKY+I": ("DNA", "ACGT", "HKY{3.0}+F{0.3,0.2,0.2,0.3}+I{0.2}"),
}
# float64: 1e-9 relative everywhere; float32: 1e-4 relative on partials and
# theta, 1e-3 absolute on site log-likelihoods
TOLERANCE = {torch.float64: {"partials": 1e-9, "lp": 1e-9},
             torch.float32: {"partials": 1e-4, "lp": 1e-3}}


def simulate(model_name: str, ntaxa: int, nsites: int, seed: int):
    """(Alignment, true Tree, model, rates) simulated under MODELS[name]."""
    seqtype, alphabet, model_str = MODELS[model_name]
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    tree = Tree.random_topology(names, rng)
    dummy = Alignment.from_sequences(names, [alphabet] * ntaxa,
                                     seqtype=seqtype)
    model, rates, _ = build_model(model_str, dummy)
    seqs = simulate_alignment(tree, model, rates, nsites, rng)
    aln = Alignment.from_sequences(list(seqs), list(seqs.values()),
                                   seqtype=seqtype)
    model, rates, _ = build_model(model_str, aln)
    return aln, Tree.from_newick(tree.to_newick(), aln.names), model, rates


def load_problem(aln_path, tree_path, model_name: str):
    """(Alignment, Tree, model, rates) of an alignment file and a Newick
    tree file under MODELS[name]'s fixed parameters."""
    aln = read_alignment(str(aln_path))
    model, rates, _ = build_model(MODELS[model_name][2], aln)
    tree = Tree.from_newick(Path(tree_path).read_text(), aln.names)
    return aln, tree, model, rates


def perturbed(tree: Tree, seed: int, strength: float) -> tuple[Tree, int]:
    """A copy of ``tree`` moved by the search's random NNIs
    (search/perturb.random_nnis), and the number of moves."""
    start = tree.copy()
    return start, random_nnis(start, np.random.default_rng(seed), strength)


def write_problem(aln: Alignment, tree: Tree, prefix) -> tuple[str, str]:
    """Write a simulated problem for the command line: (PHYLIP alignment
    path, Newick tree path)."""
    aln_path, tree_path = f"{prefix}.phy", f"{prefix}.nwk"
    write_phylip(aln, aln_path)
    Path(tree_path).write_text(tree.to_newick() + "\n")
    return aln_path, tree_path


def _col_rel(a, b) -> float:
    """max over columns of max|a - b| / max|b| over the trailing [C, S]."""
    num = (a - b).abs().amax(dim=(-3, -2))
    den = b.abs().amax(dim=(-3, -2)).clamp(min=torch.finfo(b.dtype).tiny)
    return float((num / den).max())


def _timed(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check(eng: LikelihoodEngine, tree: Tree, time_reps: int = 0) -> list:
    """Compare the four kernels with their plain versions on one problem.

    Returns one dict per kernel: name, max_abs_err, max_rel_err,
    scales_equal, tol, ok, and with time_reps > 0 also ms and plain_ms
    (mean time of one pass: all steps of a sweep for down_step and up_step,
    one call for root_sitelp and edge_theta)."""
    sched = build_schedule(tree)
    sa = eng.schedule_arrays(sched)
    pack, tipP = eng._pack, eng._tipP
    P = pruning.transition_tensors(eng._blens(sched), pack)
    cs, ce, steps = sa["child_src"], sa["child_edge"], sa["step_node"]
    n_steps = steps.shape[0]
    L = tipP.shape[0]
    root_row = L + sched.n_int - 1
    rf, w, li = pack["root_freqs"], pack["cat_weight"], pack["log_ptn_invar"]
    U = pack["U"][pack["cat_mix"]].contiguous()
    V = pack["V"][pack["cat_mix"]].contiguous()
    tol = TOLERANCE[eng.dtype]

    def down(step):
        dp = pruning.down_buffers(P, tipP, sched.n_int)
        for s in range(n_steps):
            step(P, tipP, dp.all, dp.scale, cs, ce, steps[s])
        return dp

    def up(dp, step):
        u = pruning.up_buffers(P, dp, tipP, rf)
        for s in range(n_steps - 1, -1, -1):
            step(P, tipP, dp.all, dp.scale, u.up_in, u.up_scale, u.edge_E,
                 u.edge_E_scale, cs, ce, steps[s])
        return u

    def step_rows(s):
        """(internal node ids, their child rows, their child edges) of step
        s, pad slots dropped."""
        nid = steps[s][steps[s] < sched.n_int].long()
        return nid, cs[nid].long(), ce[nid].long()

    dp = down(kernels.down_step_plain)
    up_ref = up(dp, kernels.up_step_plain)
    out = []

    # H1 down_step
    ALL, SC = dp.all.clone(), dp.scale.clone()
    for s in range(n_steps - 1, -1, -1):
        nid, _, _ = step_rows(s)
        ALL[L + nid] = float("nan")
        SC[L + nid] = -1
        kernels.down_step(P, tipP, ALL, SC, cs, ce, steps[s])
    out.append(dict(name="down_step",
                    max_abs_err=float((ALL - dp.all).abs().max()),
                    max_rel_err=_col_rel(ALL[L:], dp.all[L:]),
                    scales_equal=bool(torch.equal(SC, dp.scale)),
                    tol=tol["partials"]))

    # H2 root_sitelp
    lp = kernels.root_sitelp(P, tipP, dp.all, dp.scale, root_row, rf, w, li)
    lp_ref = kernels.root_sitelp_plain(P, tipP, dp.all, dp.scale, root_row,
                                       rf, w, li)
    err = (lp - lp_ref).abs()
    rel = float((err / lp_ref.abs().clamp(min=1.0)).max())
    out.append(dict(name="root_sitelp", max_abs_err=float(err.max()),
                    max_rel_err=rel, scales_equal=True, tol=tol["lp"],
                    lp_metric="abs" if eng.dtype == torch.float32 else "rel"))

    # H3 up_step
    E, ES = up_ref.edge_E.clone(), up_ref.edge_E_scale.clone()
    UP, UPS = up_ref.up_in.clone(), up_ref.up_scale.clone()
    for s in range(n_steps):
        _, src, eid = step_rows(s)
        E[eid] = float("nan")
        ES[eid] = -1
        child = src[src >= L] - L
        UP[child] = float("nan")
        UPS[child] = -1
        kernels.up_step(P, tipP, dp.all, dp.scale, UP, UPS, E, ES, cs, ce,
                        steps[s])
    # np.max, not max(): a NaN in either operand must carry through
    out.append(dict(
        name="up_step",
        max_abs_err=float(np.max([float((E - up_ref.edge_E).abs().max()),
                                  float((UP - up_ref.up_in).abs().max())])),
        max_rel_err=float(np.max([_col_rel(E, up_ref.edge_E),
                                  _col_rel(UP, up_ref.up_in)])),
        scales_equal=bool(torch.equal(ES, up_ref.edge_E_scale)
                          and torch.equal(UPS, up_ref.up_scale)),
        tol=tol["partials"]))

    # H4 edge_theta
    args = (up_ref.edge_E, up_ref.edge_E_scale, dp.all, dp.scale,
            sa["edge_src"], U, V)
    th, tsc = kernels.edge_theta(*args)
    th_ref, tsc_ref = kernels.edge_theta_plain(*args)
    out.append(dict(name="edge_theta",
                    max_abs_err=float((th - th_ref).abs().max()),
                    max_rel_err=_col_rel(th, th_ref),
                    scales_equal=bool(torch.equal(tsc, tsc_ref)),
                    tol=tol["partials"]))
    if tipP.is_cuda:
        torch.cuda.synchronize()

    for r in out:
        metric = r["max_abs_err"] if r.get("lp_metric") == "abs" \
            else r["max_rel_err"]
        r["ok"] = bool(metric <= r["tol"] and r["scales_equal"])

    if time_reps:
        timings = {
            "down_step": (lambda: down(kernels.down_step),
                          lambda: down(kernels.down_step_plain)),
            "root_sitelp": (
                lambda: kernels.root_sitelp(P, tipP, dp.all, dp.scale,
                                            root_row, rf, w, li),
                lambda: kernels.root_sitelp_plain(P, tipP, dp.all, dp.scale,
                                                  root_row, rf, w, li)),
            "up_step": (lambda: up(dp, kernels.up_step),
                        lambda: up(dp, kernels.up_step_plain)),
            "edge_theta": (lambda: kernels.edge_theta(*args),
                           lambda: kernels.edge_theta_plain(*args)),
        }
        for r in out:
            fk, fp = timings[r["name"]]
            # plain, kernel, kernel, plain: drift in clocks hits both alike
            p1 = _timed(fp, time_reps)
            k1 = _timed(fk, time_reps)
            k2 = _timed(fk, time_reps)
            p2 = _timed(fp, time_reps)
            r["ms"] = (k1 + k2) / 2
            r["plain_ms"] = (p1 + p2) / 2
    return out
