#!/usr/bin/env python3
"""One side of a parent-vs-change comparison of the pass kernels' outputs
and back-to-back times on one NVIDIA GPU, at the narrow instances' shapes.

    python3 tools/torch_kernel_bits.py --root DIR --tag NAME --out FILE \
        [--reps N]
    python3 tools/torch_kernel_bits.py --diff FILE

Imports iqtree2_tpu_torch from DIR (the root of a checkout of either
commit, e.g. one unpacked with git archive) and, for each problem of
chip_smoke.py's phases 3, 14a and 15a (64 taxa x 4096 sites simulated
with seed 1 under each kernelcheck.MODELS name, in the precisions those
phases check), runs the three kernels once on fresh buffers through
kernelcheck.Problem (down_pass with its site-logL epilogue, up_pass over
that down pass, theta_pass) and records the sha256 of every output (the
internal rows and scale counts, lp, E, UP, theta and their scale counts)
and each kernel's back-to-back ms (kernelcheck.back_to_back_ms, N
launches). Appends one JSON line to FILE. Run the sides in separate
processes, in the order parent, change, change, parent.

--diff FILE prints, per problem, whether every run's outputs are the same
to the bit and each kernel's back-to-back ms per run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

# (kernelcheck.MODELS name, dtype): phase 3's CHECK_MODELS in both
# precisions, then phase 14a's FAMILY_CHECKS and phase 15a's NONREV_CHECKS
PROBLEMS = [(m, d) for m in ("GTR+G4", "GTR+G8", "LG+G4", "JC", "GTR+I+R3",
                             "GTR+R10", "LG+I", "LG+F+R10")
            for d in ("float32", "float64")] + [
    ("GY+F3X4+G4", "float32"), ("GY+F3X4+G4", "float64"),
    ("KOSI07+G4", "float32"), ("HKY+E+G4", "float32"),
    ("JC2+G4", "float32"), ("MK7+G4", "float32"),
    ("UNREST+G4", "float32"), ("UNREST+G4", "float64"),
    ("12.12+G4", "float32"), ("GTR+P+G4", "float32"),
    ("GTR+P+G4", "float64"), ("GTR+H4", "float32"),
    ("UNREST+G4 rooted", "float32")]
TAXA, SITES = 64, 4096


def sha(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def measure(root: str, tag: str, reps: int) -> dict:
    sys.path.insert(0, root)
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    assert Path(kernelcheck.__file__).resolve().is_relative_to(
        Path(root).resolve()), kernelcheck.__file__
    kernels.library()
    out = {"tag": tag, "device": torch.cuda.get_device_name(0),
           "problems": {}}
    for name, dt in PROBLEMS:
        model_name = name.removesuffix(" rooted")
        aln, tree, model, rates = kernelcheck.simulate(model_name, TAXA,
                                                       SITES, seed=1)
        if model_name != name:
            aln, tree = kernelcheck.rooted_problem(aln, tree)
        eng = kernelcheck.make_engine(aln, model, rates,
                                      dtype=getattr(torch, dt), device="cuda")
        pb = kernelcheck.Problem(eng, tree)
        lp = pb.lp_buffer()
        dp = pb.down(kernels.down_pass, pb.down_buffers(), pb.sitelp(lp))
        u = pb.up(kernels.up_pass, dp, pb.up_buffers(dp))
        t = pb.theta(kernels.theta_pass, dp, pb.theta_buffers())
        torch.cuda.synchronize()
        digest = hashlib.sha256("".join(
            sha(x) for x in (dp.all[pb.L:], dp.scale, lp, *u, *t)).encode()
        ).hexdigest()
        lp_k = pb.sitelp(lp)
        ms = {"down_pass": kernelcheck.back_to_back_ms(
                  lambda: pb.down(kernels.down_pass, dp), reps),
              "sitelp": kernelcheck.back_to_back_ms(
                  lambda: pb.down(kernels.down_pass, dp, lp_k), reps),
              "up_pass": kernelcheck.back_to_back_ms(
                  lambda: pb.up(kernels.up_pass, dp, u), reps),
              "theta_pass": kernelcheck.back_to_back_ms(
                  lambda: pb.theta(kernels.theta_pass, dp, t), reps)}
        key = f"{name} {dt}"
        out["problems"][key] = {"sha256": digest, "b2b_ms": ms}
        print(f"{tag} {key}: {digest[:16]} b2b ms {ms}", flush=True)
        del eng, pb, dp, u, t
        torch.cuda.empty_cache()
    return out


def diff(path: str) -> int:
    runs = [json.loads(line) for line in Path(path).read_text().splitlines()]
    same = True
    for key in runs[0]["problems"]:
        shas = {r["tag"]: r["problems"][key]["sha256"] for r in runs}
        ok = len(set(shas.values())) == 1
        same &= ok
        ms = {k: [round(r["problems"][key]["b2b_ms"][k], 4) for r in runs]
              for k in runs[0]["problems"][key]["b2b_ms"]}
        print(f"{key}: {'same bits' if ok else 'DIFFERENT bits ' + str(shas)}"
              f"; b2b ms per run ({', '.join(r['tag'] for r in runs)}) {ms}")
    print("every problem the same to the bit" if same
          else "some outputs differ")
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root")
    ap.add_argument("--tag")
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--diff", default="")
    args = ap.parse_args()
    if args.diff:
        return diff(args.diff)
    res = measure(args.root, args.tag, args.reps)
    with open(args.out, "a") as f:
        f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
