"""Each Hopper kernel held against its plain PyTorch version on the card.

Used by chip_smoke.py and tests/test_torch_cuda.py (the parity tests use
its ``simulate``). A problem is an alignment simulated under one of MODELS on
a random topology; every kernel then gets exactly the inputs its plain
version gets:

- down_pass: the plain down pass (down_pass_plain) is the reference; the
  kernel runs the whole pass on fresh buffers;
- root_sitelp and edge_theta: one call each on the reference passes;
- up_pass: the plain up pass is the reference; the kernel runs the whole
  sweep on fresh buffers over the reference down pass.

Before a pass runs, every row it writes is set to a sentinel (NaN partials,
scale count -1), so a row the kernel leaves unwritten fails the comparison
instead of passing as the reference's copy. ``bounds`` gives each kernel's
least possible time on an H100 for the same work.

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

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io.alignment_io import read_alignment, write_phylip
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.ops import kernels, pruning
from iqtree2_tpu_torch.search.perturb import random_nnis
from iqtree2_tpu_torch.simulator import simulate_alignment
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree

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


def col_rel(a, b) -> float:
    """max over columns of max|a - b| / max|b| over the trailing [C, S]."""
    num = (a - b).abs().amax(dim=(-3, -2))
    den = b.abs().amax(dim=(-3, -2)).clamp(min=torch.finfo(b.dtype).tiny)
    return float((num / den).max())


def timed_ms(fn, reps: int) -> float:
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


def _pair(fk, fp, reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two runs taken in the order
    plain, kernel, kernel, plain, so drift in clocks hits both alike."""
    p1 = timed_ms(fp, reps)
    k1 = timed_ms(fk, reps)
    k2 = timed_ms(fk, reps)
    p2 = timed_ms(fp, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


class Problem:
    """The tensors every kernel of one (engine, tree) problem takes."""

    def __init__(self, eng: LikelihoodEngine, tree: Tree):
        self.sched = build_schedule(tree)
        sa = eng.schedule_arrays(self.sched)
        self.pack, self.tipP = eng._pack, eng._tipP
        self.P = pruning.transition_tensors(eng._blens(self.sched), self.pack)
        self.cs, self.ce = sa["child_src"], sa["child_edge"]
        self.steps, self.edge_src = sa["step_node"], sa["edge_src"]
        self.L = self.tipP.shape[0]
        self.n_int = self.sched.n_int
        self.root_row = self.L + self.n_int - 1

    def down_buffers(self):
        return pruning.down_buffers(self.P, self.tipP, self.n_int)

    def up_buffers(self, dp):
        return pruning.up_buffers(self.P, dp, self.tipP,
                                  self.pack["root_freqs"])

    def down(self, fn, dp):
        fn(self.P, self.tipP, dp.all, dp.scale, self.cs, self.ce, self.steps)
        return dp

    def up(self, fn, dp, u):
        fn(self.P, self.tipP, dp.all, dp.scale, u.up_in, u.up_scale,
           u.edge_E, u.edge_E_scale, self.cs, self.ce, self.steps)
        return u


def check(eng: LikelihoodEngine, tree: Tree, time_reps: int = 0) -> list:
    """Compare the four kernels with their plain versions on one problem.

    Returns one dict per kernel: name, max_abs_err, max_rel_err,
    scales_equal, tol, ok, and with time_reps > 0 also ms and plain_ms:
    the mean time of one pass (down_pass, up_pass) or call (root_sitelp,
    edge_theta) alone, its buffers built outside the timed region
    (time_buffers times those)."""
    pb = Problem(eng, tree)
    L, P, tipP = pb.L, pb.P, pb.tipP
    rf, w, li = (pb.pack[k] for k in ("root_freqs", "cat_weight",
                                      "log_ptn_invar"))
    U = pb.pack["U"][pb.pack["cat_mix"]].contiguous()
    V = pb.pack["V"][pb.pack["cat_mix"]].contiguous()
    tol = TOLERANCE[eng.dtype]

    dp = pb.down(kernels.down_pass_plain, pb.down_buffers())
    up_ref = pb.up(kernels.up_pass_plain, dp, pb.up_buffers(dp))
    out = []

    # H1 down_pass: every internal row is written by the pass
    got = pb.down_buffers()
    got.all[L:] = float("nan")
    got.scale[L:] = -1
    pb.down(kernels.down_pass, got)
    out.append(dict(name="down_pass",
                    max_abs_err=float((got.all - dp.all).abs().max()),
                    max_rel_err=col_rel(got.all[L:], dp.all[L:]),
                    scales_equal=bool(torch.equal(got.scale, dp.scale)),
                    tol=tol["partials"]))

    # H2 root_sitelp
    lp = kernels.root_sitelp(P, tipP, dp.all, dp.scale, pb.root_row, rf, w,
                             li)
    lp_ref = kernels.root_sitelp_plain(P, tipP, dp.all, dp.scale,
                                       pb.root_row, rf, w, li)
    err = (lp - lp_ref).abs()
    rel = float((err / lp_ref.abs().clamp(min=1.0)).max())
    out.append(dict(name="root_sitelp", max_abs_err=float(err.max()),
                    max_rel_err=rel, scales_equal=True, tol=tol["lp"],
                    lp_metric="abs" if eng.dtype == torch.float32 else "rel"))

    # H3 up_pass: E of every child edge and UP of every internal child;
    # E of edge 0 and UP of the root come from up_buffers
    u = pb.up_buffers(dp)
    eid = pb.ce.flatten().long()
    kid = pb.cs.flatten().long()
    kid = kid[kid >= L] - L
    u.edge_E[eid] = float("nan")
    u.edge_E_scale[eid] = -1
    u.up_in[kid] = float("nan")
    u.up_scale[kid] = -1
    pb.up(kernels.up_pass, dp, u)
    # np.max, not max(): a NaN in either operand must carry through
    out.append(dict(
        name="up_pass",
        max_abs_err=float(np.max([
            float((u.edge_E - up_ref.edge_E).abs().max()),
            float((u.up_in - up_ref.up_in).abs().max())])),
        max_rel_err=float(np.max([col_rel(u.edge_E, up_ref.edge_E),
                                  col_rel(u.up_in, up_ref.up_in)])),
        scales_equal=bool(torch.equal(u.edge_E_scale, up_ref.edge_E_scale)
                          and torch.equal(u.up_scale, up_ref.up_scale)),
        tol=tol["partials"]))

    # H4 edge_theta
    args = (up_ref.edge_E, up_ref.edge_E_scale, dp.all, dp.scale,
            pb.edge_src, U, V)
    th, tsc = kernels.edge_theta(*args)
    th_ref, tsc_ref = kernels.edge_theta_plain(*args)
    out.append(dict(name="edge_theta",
                    max_abs_err=float((th - th_ref).abs().max()),
                    max_rel_err=col_rel(th, th_ref),
                    scales_equal=bool(torch.equal(tsc, tsc_ref)),
                    tol=tol["partials"]))
    if tipP.is_cuda:
        torch.cuda.synchronize()

    for r in out:
        metric = r["max_abs_err"] if r.get("lp_metric") == "abs" \
            else r["max_rel_err"]
        r["ok"] = bool(metric <= r["tol"] and r["scales_equal"])

    if time_reps:
        # one set of buffers per version, built once: a pass rewrites
        # every row it owns, so repeating it on the same buffers is the
        # same work
        dk, dpl = pb.down_buffers(), pb.down_buffers()
        uk, upl = pb.up_buffers(dp), pb.up_buffers(dp)
        timings = {
            "down_pass": (lambda: pb.down(kernels.down_pass, dk),
                          lambda: pb.down(kernels.down_pass_plain, dpl)),
            "root_sitelp": (
                lambda: kernels.root_sitelp(P, tipP, dp.all, dp.scale,
                                            pb.root_row, rf, w, li),
                lambda: kernels.root_sitelp_plain(P, tipP, dp.all, dp.scale,
                                                  pb.root_row, rf, w, li)),
            "up_pass": (lambda: pb.up(kernels.up_pass, dp, uk),
                        lambda: pb.up(kernels.up_pass_plain, dp, upl)),
            "edge_theta": (lambda: kernels.edge_theta(*args),
                           lambda: kernels.edge_theta_plain(*args)),
        }
        for r in out:
            r["ms"], r["plain_ms"] = _pair(*timings[r["name"]], time_reps)
    return out


def time_buffers(eng: LikelihoodEngine, tree: Tree, reps: int) -> dict:
    """Mean milliseconds of pruning.down_buffers (the unified buffer with
    the tips copied in) and pruning.up_buffers (the root's rows) on the
    card: the set-up of a pass that check() leaves out of its times."""
    pb = Problem(eng, tree)
    dp = pb.down(kernels.down_pass, pb.down_buffers())
    return {"down_buffers": timed_ms(pb.down_buffers, reps),
            "up_buffers": timed_ms(lambda: pb.up_buffers(dp), reps)}


# NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3; 67 TFLOP/s in float32
# and 34 TFLOP/s in float64 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bounds(eng: LikelihoodEngine, tree: Tree) -> dict:
    """name -> dict(bytes, flops, bound_ms, bound_by): the least time an
    H100 could take for each kernel's work on this problem, the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its floating-point operations over the peak rate."""
    sched = build_schedule(tree)
    L, n_int, n_edges = sched.ntaxa, sched.n_int, sched.n_edges
    C = int(eng._pack["cat_rate"].shape[0])
    S, Pp = eng._tipP.shape[1], eng.Pp
    f = torch.finfo(eng.dtype).bits // 8
    col, scale = C * S * Pp * f, Pp * 4          # one row of partials, scales
    mats = n_edges * C * S * S * f
    index = 4 * (4 * n_int + sched.step_node.size)
    tips = L * S * Pp * f
    work = {
        # read P, tips, schedule; write every internal row and its scale
        "down_pass": (mats + tips + index + n_int * (col + scale),
                      n_int * Pp * C * (4 * S * S + S)),
        # read P, tips, down rows and scales, the root's UP; write E of
        # every child edge and UP of every internal child, with scales
        "up_pass": (mats + tips + index + n_int * (col + scale)
                    + col + scale
                    + (n_edges - 1 + n_int - 1) * (col + scale),
                    Pp * C * ((n_edges - 1) * (2 * S * S + S)
                              + (n_int - 1) * 2 * S * S)),
        # read P_0, tip 0, the root row, its scale, pi, w, log_inv; write lp
        "root_sitelp": (C * S * S * f + S * Pp * f + col + scale
                        + (C * S + C) * f + 2 * Pp * f,
                        Pp * C * (2 * S * S + 3 * S + 2)),
        # read E, its scales, every edge's child row and scale, U, V;
        # write theta and its scales
        "edge_theta": (n_edges * (3 * col + 3 * scale + 4)
                       + 2 * C * S * S * f,
                       n_edges * Pp * C * (4 * S * S + S)),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[eng.dtype] * 1e3
        out[name] = dict(bytes=nbytes, flops=flops,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations")
    return out
