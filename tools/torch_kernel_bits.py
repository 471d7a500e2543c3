#!/usr/bin/env python3
"""One side of a parent-vs-change comparison of the pass kernels' outputs
and back-to-back times on one NVIDIA GPU, at the narrow instances' shapes,
and with --wide of the wide down pass's times and errors.

    python3 tools/torch_kernel_bits.py --root DIR --tag NAME --out FILE \
        [--reps N] [--wide] [--plain]
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
launches).

--wide then takes each shape of WIDE (chip_smoke.py's 18a problems at 64
taxa, 18b's 100 x 16384 PoMo and 18e's 100 x 12288 65-state datatype,
simulated with seed 1 as those phases simulate them): the wide down pass
(S > 64) once with its epilogue on fresh buffers against the plain
version (the largest relative error over the internal rows, the site
logL error, the scale counts equal), then its times, loaded
(kernelcheck.timed_ms, the host launching) and back to back, N launches
each, without and with the epilogue (with --plain also the plain
version's time), its occupancy (resident blocks per SM, shared bytes a
block) and kernelcheck.bounds.

Appends one JSON line to FILE, with the card's name and power limit. Run
the sides in separate processes, in the order parent, change, change,
parent.

--diff FILE prints, per problem, whether every run's outputs are the same
to the bit and each kernel's back-to-back ms per run; per wide shape, each
run's back-to-back ms, share of the bound, occupancy and errors. It exits
non-zero if the narrow problems' bits differ.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
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
# the wide down pass's shapes: (kernelcheck.MODELS name, dtype, taxa, sites)
WIDE = [("GTR+P13+G4", "float32", 64, 4096),
        ("GTR+P13+G4", "float64", 64, 4096),
        ("GTR+P19+G4", "float32", 64, 4096),
        ("GTR+P19+G4", "float64", 64, 4096),
        ("GTR+P23+G4", "float32", 64, 1024),
        ("GTR+P19+G4", "float32", 100, 16384),
        ("MK65+G4", "float32", 100, 12288)]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def sha(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def down_errors(pb, wins, kernels, kernelcheck, dtype) -> dict:
    """The kernel's down pass with its epilogue against the plain one, on
    fresh buffers (the plain version window by window)."""
    import torch
    L = pb.L
    got, lp = pb.down_buffers(), pb.lp_buffer()
    got.all[L:] = float("nan")
    got.scale[L:] = -1
    pb.down(kernels.down_pass, got, pb.sitelp(lp))
    torch.cuda.synchronize()
    rel, lp_err, same = 0.0, 0.0, True
    for a, b in wins:
        sub = pb.window(a, b)
        lp_w = sub.lp_buffer()
        ref = sub.down(kernels.down_pass_plain, sub.down_buffers(),
                       sub.sitelp(lp_w))
        rel = max(rel, kernelcheck.col_rel(got.all[L:, ..., a:b],
                                           ref.all[L:]))
        lp_err = max(lp_err, kernelcheck.lp_error(lp[a:b], lp_w, dtype))
        same &= bool(torch.equal(got.scale[:, a:b], ref.scale))
        del ref
    return {"max_rel_err": rel, "lp_err": lp_err, "scales_equal": same}


def measure_wide(reps: int, plain: bool, tag: str) -> dict:
    """The wide down pass at each shape of WIDE."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    out = {}
    for name, dt, taxa, sites in WIDE:
        dtype = getattr(torch, dt)
        aln, tree, model, rates = kernelcheck.simulate(name, taxa, sites,
                                                       seed=1)
        eng = kernelcheck.make_engine(aln, model, rates, dtype=dtype,
                                      device="cuda")
        pb = kernelcheck.Problem(eng, tree)
        wins = kernelcheck.windows(eng.Pp, kernelcheck.plain_window(eng))
        C, S = pb.P.shape[1], pb.tipP.shape[1]
        row = {"C": C, "S": S, "Pp": eng.Pp,
               **down_errors(pb, wins, kernels, kernelcheck, dtype)}
        dp, lp = pb.down_buffers(), pb.lp_buffer()
        lp_k = pb.sitelp(lp)
        fns = {"down_pass": lambda: pb.down(kernels.down_pass, dp),
               "sitelp": lambda: pb.down(kernels.down_pass, dp, lp_k)}
        for key, fn in fns.items():
            row[key] = {"ms": kernelcheck.timed_ms(fn, reps),
                        "b2b_ms": kernelcheck.back_to_back_ms(fn, reps)}
        if plain:  # one run over the plain version's windows
            subs = [pb.window(a, b) for a, b in wins]
            row["down_pass"]["plain_ms"] = kernelcheck.timed_ms(
                lambda: [w.down(kernels.down_pass_plain, w.down_buffers())
                         for w in subs], 1)
            row["sitelp"]["plain_ms"] = kernelcheck.timed_ms(
                lambda: [w.down(kernels.down_pass_plain, w.down_buffers(),
                                w.sitelp(w.lp_buffer())) for w in subs], 1)
        bnd = kernelcheck.bounds(eng, tree)
        for key, b in (("down_pass", "down_pass"),
                       ("sitelp", "down_pass_sitelp")):
            row[key].update(bound_ms=bnd[b]["bound_ms"],
                            bound_by=bnd[b]["bound_by"],
                            share=bnd[b]["bound_ms"] / row[key]["b2b_ms"])
        row["occupancy"] = kernels.pass_occupancy("down_pass", dtype, C, S,
                                                  eng.Pp)
        key = f"{name} {dt} {taxa}x{sites}"
        out[key] = row
        print(f"{tag} {key}: {json.dumps(row)}", flush=True)
        del eng, pb, dp, lp, lp_k, fns
        torch.cuda.empty_cache()
    return out


def measure(root: str, tag: str, reps: int, wide: bool, plain: bool
            ) -> dict:
    sys.path.insert(0, root)
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    assert Path(kernelcheck.__file__).resolve().is_relative_to(
        Path(root).resolve()), kernelcheck.__file__
    kernels.library()
    out = {"tag": tag, "device": torch.cuda.get_device_name(0),
           "card": card(), "problems": {}}
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
    if wide:
        out["wide"] = measure_wide(reps, plain, tag)
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
    print(f"cards: {sorted({r.get('card', r['device']) for r in runs})}")
    for key in runs[0].get("wide", {}):
        cells = []
        for r in runs:
            s = r["wide"][key]
            cells.append(f"{r['tag']} {s['down_pass']['b2b_ms']:.4f} "
                         f"({s['sitelp']['b2b_ms']:.4f}) ms, "
                         f"{100 * s['down_pass']['share']:.2f}%, "
                         f"occ {s['occupancy']}, rel {s['max_rel_err']:.1e}"
                         f" lp {s['lp_err']:.1e} sc {s['scales_equal']}")
        print(f"{key}: " + "; ".join(cells))
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root")
    ap.add_argument("--tag")
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--diff", default="")
    args = ap.parse_args()
    if args.diff:
        return diff(args.diff)
    res = measure(args.root, args.tag, args.reps, args.wide, args.plain)
    with open(args.out, "a") as f:
        f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
