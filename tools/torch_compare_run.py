#!/usr/bin/env python3
"""One side of a parent-vs-change comparison of the port on one NVIDIA GPU.

    python3 tools/torch_compare_run.py --root DIR --tag NAME --work DIR \\
        --out FILE [--passes-only]
    python3 tools/torch_compare_run.py --diff A,B --work DIR

Imports iqtree2_tpu_torch from DIR (the root of a checkout of either
commit, e.g. one unpacked with git archive) and measures in one process,
with only module entry points that every version has:

- one pruning.down_pass and one pruning.up_pass (buffers included, as the
  engine calls them), a log-likelihood (pruning.tree_loglik: transition
  tensors, the down pass and the site log-likelihoods) and a Newton
  round's passes (the down pass and the theta buffers of every edge:
  both_passes + edge_thetas where the tree has no theta_pass, else a down
  pass without tip rows + theta_pass) and their theta half alone (given
  the down pass), CUDA events, at the flagship's shapes (example.phy on
  ref_tree.nwk under kernelcheck's GTR+G4, Pp 1152) and at 1000 taxa x
  16384 sites simulated under GTR+G4 (seed 1), float32, the same
  alignment under GTR+G8 (8 categories), float32, and at 64 taxa x 4096
  sites simulated under LG+G4 (seed 1), float32 and float64; the
  sha256 of the site log-likelihoods and of theta at each shape, and at
  the flagship's shapes both arrays in --work (bits_TAG.npz), so two
  trees' values can be compared to the bit;
- the flagship, -s example.phy -m GTR+G -bb 1000 through the CLI at the
  default settings, float32: wall, iterations, the log's wall split, logL
  and the kernel launch counts;
- the GTR+G fit of the 1000 x 16384 problem on its simulating tree
  through the CLI (-te), float32: wall and logL.

--passes-only measures the passes and skips the two CLI runs. --diff A,B
prints, for the flagship's arrays of runs A and B, how many values differ
and the largest relative difference.

The simulated problems are made once into --work by the first run and
read back by the others. Appends one JSON line to --out. Run the sides in
separate processes, in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "golden"


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after one
    warm-up call); defined here because the parent's kernelcheck may name
    its own helper otherwise."""
    import torch
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


def report_logl(prefix: Path) -> float:
    for line in Path(f"{prefix}.iqtree").read_text().splitlines():
        if line.startswith("Log-likelihood of the tree:"):
            return float(line.split(":")[1].split()[0])
    raise RuntimeError(f"no logL in {prefix}.iqtree")


def sha(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def diff(work: Path, tags: str) -> int:
    import numpy as np
    a, b = (np.load(work / f"bits_{t}.npz") for t in tags.split(","))
    for key in a.files:
        x, y = a[key], b[key]
        rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-30)
        print(json.dumps({"tags": tags, "array": key, "size": int(x.size),
                          "differ": int((x != y).sum()),
                          "max_rel": float(rel.max())}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root")
    ap.add_argument("--tag")
    ap.add_argument("--work", required=True)
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--passes-only", action="store_true")
    ap.add_argument("--diff", default="")
    args = ap.parse_args()
    if args.diff:
        return diff(Path(args.work), args.diff)
    if not (args.root and args.tag and args.out):
        ap.error("--root, --tag and --out are required")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no GPU", file=sys.stderr)
        return 1
    from iqtree2_tpu_torch import cli, kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine, build_schedule
    from iqtree2_tpu_torch.ops import kernels, pruning

    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    big = work / "big"
    aln_path, tree_path = Path(f"{big}.phy"), Path(f"{big}.nwk")
    if not (aln_path.exists() and tree_path.exists()):
        aln, tree, _, _ = kernelcheck.simulate("GTR+G4", 1000, 16384, seed=1)
        kernelcheck.write_problem(aln, tree, big)
    lg = work / "lg"
    lg_aln, lg_tree = Path(f"{lg}.phy"), Path(f"{lg}.nwk")
    if not (lg_aln.exists() and lg_tree.exists()):
        aln, tree, _, _ = kernelcheck.simulate("LG+G4", 64, 4096, seed=1)
        kernelcheck.write_problem(aln, tree, lg)
    # as the change's kernelcheck.MODELS has it; an older tree lacks it
    kernelcheck.MODELS.setdefault("GTR+G8", (
        "DNA", "ACGT", "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+G8{0.6}"))
    row = {"tag": args.tag, "root": args.root,
           "device": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip()}

    # one pass through the module API, each shape
    for shape, a_path, t_path, name, dtype in (
            ("flagship", GOLDEN / "example.phy", GOLDEN / "ref_tree.nwk",
             "GTR+G4", torch.float32),
            ("1000x16384", aln_path, tree_path, "GTR+G4", torch.float32),
            ("g8_1000x16384", aln_path, tree_path, "GTR+G8", torch.float32),
            ("lg64x4096_f32", lg_aln, lg_tree, "LG+G4", torch.float32),
            ("lg64x4096_f64", lg_aln, lg_tree, "LG+G4", torch.float64)):
        aln, tree, model, rates = kernelcheck.load_problem(a_path, t_path,
                                                           name)
        eng = LikelihoodEngine(aln, model, rates, dtype=dtype,
                               device="cuda")
        sched = build_schedule(tree)
        sa = eng.schedule_arrays(sched)
        blens, pack, tipP = eng._blens(sched), eng._pack, eng._tipP
        P = pruning.transition_tensors(blens, pack)
        dp = pruning.down_pass(P, tipP, sa)
        rf = pack["root_freqs"]
        reps = (max(args.reps // 4, 3) if shape.endswith("1000x16384")
                else args.reps)
        row[f"{shape}_down_pass_ms"] = timed_ms(
            lambda: pruning.down_pass(P, tipP, sa), reps)
        row[f"{shape}_up_pass_ms"] = timed_ms(
            lambda: pruning.up_pass(P, dp, tipP, sa, rf), reps)
        row[f"{shape}_loglik_ms"] = timed_ms(
            lambda: pruning.tree_loglik(blens, tipP, sa, pack, eng._pw),
            reps)
        if hasattr(pruning, "theta_pass"):
            dp_nt = pruning.down_pass(P, tipP, sa, tips=False)

            def thetas():
                return pruning.theta_pass(P, dp_nt, tipP, sa, pack)

            def round_():
                return pruning.theta_pass(
                    P, pruning.down_pass(P, tipP, sa, tips=False), tipP, sa,
                    pack)
        else:
            def thetas():
                return pruning.edge_thetas(
                    pruning.up_pass(P, dp, tipP, sa, rf), dp,
                    sa["edge_src"], pack)

            def round_():
                d, u = pruning.both_passes(P, tipP, sa, pack)
                return pruning.edge_thetas(u, d, sa["edge_src"], pack)
        row[f"{shape}_thetas_ms"] = timed_ms(thetas, reps)
        row[f"{shape}_newton_passes_ms"] = timed_ms(round_, reps)
        row[f"{shape}_steps"] = int(sa["step_node"].shape[0])
        _, lp = pruning.tree_loglik(blens, tipP, sa, pack, eng._pw)
        th = thetas()
        row[f"{shape}_sha256_lp"] = sha(lp)
        row[f"{shape}_sha256_theta"] = sha(th.theta)
        if shape == "flagship":
            import numpy as np
            np.savez(work / f"bits_{args.tag}.npz", lp=lp.cpu().numpy(),
                     theta=th.theta.cpu().numpy(),
                     theta_scale=th.scale.cpu().numpy())

    def run_cli(argv, prefix):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-pre", str(prefix), "--device", "cuda",
                              "-redo", "--quiet"])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"CLI returned {rc}: {argv}")
        return time.perf_counter() - t0, dict(kernels.LAUNCHES)

    if args.passes_only:
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        return 0
    flag = work / f"flagship_{args.tag}"
    wall, launches = run_cli(["-s", str(GOLDEN / "example.phy"), "-m",
                              "GTR+G", "-bb", "1000"], flag)
    log = Path(f"{flag}.log").read_text()
    row.update(flagship_wall_s=wall, flagship_launches=launches,
               flagship_logl=report_logl(flag),
               flagship_iterations=int(re.search(
                   r"Search done: (\d+) iterations", log).group(1)),
               flagship_wall_split=re.search(r"Wall seconds: (.*)",
                                             log).group(1))
    fit = work / f"fit_{args.tag}"
    wall, launches = run_cli(["-s", str(aln_path), "-m", "GTR+G", "-te",
                              str(tree_path)], fit)
    row.update(fit_wall_s=wall, fit_launches=launches,
               fit_logl=report_logl(fit))
    print(json.dumps(row), flush=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
