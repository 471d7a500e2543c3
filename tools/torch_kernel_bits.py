#!/usr/bin/env python3
"""One side of a parent-vs-change comparison of the pass kernels' outputs
and back-to-back times on one NVIDIA GPU, at the narrow instances' shapes,
and with --wide of the wide instance's times and errors.

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
launches). Both sides' kernels read the same inputs: where a model takes
the scaling-and-squaring exponential (nonreversible models and PoMo, whose
ops/pruning.expm_ss may differ between the sides), P is replaced by
torch.linalg.matrix_exp of the same rate matrices in float64, cast to the
problem's precision (same_P).

--wide then takes each shape of WIDE (chip_smoke.py's 18a problems at 64
taxa, 18b's 100 x 16384 PoMo and 18e's 100 x 12288 65-state datatype,
simulated with seed 1 as those phases simulate them): the sha256 of the
wide down pass with its epilogue on fresh buffers; the three kernels
against their plain versions (kernelcheck.check: the largest relative
errors, the site logL error, the scale counts equal, one launch a pass);
in float32 the down pass's kernel and plain version against a float64
evaluation of the same float32 inputs (f64_view); then each kernel's
times, loaded (kernelcheck.timed_ms, the host launching) and back to
back, N launches each (the down pass without and with its epilogue, the
up pass, the theta pass; with --plain also the plain versions' times),
the occupancy of the three (resident blocks per SM, shared bytes a block)
and kernelcheck.bounds.

Appends one JSON line to FILE, with the card's name and power limit. Run
the sides in separate processes, in the order parent, change, change,
parent.

--diff FILE prints, per problem, whether every run's outputs are the same
to the bit and each kernel's back-to-back ms per run; per wide shape,
whether the down pass's bits are the same and each run's back-to-back ms,
shares of the bound, errors and occupancy. It exits non-zero if the
narrow problems' or the wide down pass's bits differ.
"""

from __future__ import annotations

import argparse
import copy
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
# the wide instance's shapes: (kernelcheck.MODELS name, dtype, taxa, sites)
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


def same_P(pb) -> None:
    """pb.P from torch.linalg.matrix_exp(Q r t) in float64, where the
    model takes the scaling-and-squaring exponential (pack["Q"]), so that
    it does not depend on the side's expm_ss; the eigen path's P is left
    as it is."""
    import torch
    pack = pb.pack
    if pack.get("Q") is None:
        return
    blens = torch.as_tensor(pb.sched.blens, dtype=torch.float64,
                            device=pb.P.device)
    Q = pack["Q"][pack["cat_mix"]].double()
    A = Q[None] * (pack["cat_rate"].double()[None, :, None, None]
                   * blens[:, None, None, None])
    pb.P = torch.linalg.matrix_exp(A).clamp(min=0.0).to(
        pb.P.dtype).contiguous()


def down_bits(pb, kernels) -> str:
    """sha256 of the down pass with its epilogue on fresh buffers: the
    internal rows, scale counts and site logLs."""
    import torch
    dp, lp = pb.down_buffers(), pb.lp_buffer()
    pb.down(kernels.down_pass, dp, pb.sitelp(lp))
    torch.cuda.synchronize()
    return hashlib.sha256("".join(
        sha(x) for x in (dp.all[pb.L:], dp.scale, lp)).encode()).hexdigest()


def f64_view(pb, wins, kernels, kernelcheck) -> dict:
    """The float32 down pass with its epilogue, the kernel's and the plain
    version's, against a float64 evaluation of the same float32 inputs (P
    and the tips cast up), window by window: the largest column-relative
    error of the internal rows (the float64 rows brought to the float32
    rows' scaling, v64 x 2^(30 sc32 - 256 sc64) per column) and the
    largest absolute site-logL error of each."""
    import torch
    dp, lp = pb.down_buffers(), pb.lp_buffer()
    pb.down(kernels.down_pass, dp, pb.sitelp(lp))
    L, out = pb.L, {"kernel": [0.0, 0.0], "plain": [0.0, 0.0]}
    P64 = pb.P.double()
    for a, b in wins:
        sub = pb.window(a, b)
        lp32 = sub.lp_buffer()
        ref32 = sub.down(kernels.down_pass_plain, sub.down_buffers(),
                         sub.sitelp(lp32))
        sub64 = copy.copy(sub)
        sub64.P, sub64.tipP = P64, sub.tipP.double()
        sub64.pack = {k: v.double() if torch.is_tensor(v)
                      and v.is_floating_point() else v
                      for k, v in sub.pack.items()}
        lp64 = sub64.lp_buffer()
        ref64 = sub64.down(kernels.down_pass_plain, sub64.down_buffers(),
                           sub64.sitelp(lp64))
        for key, rows, sc, l32 in (
                ("kernel", dp.all[L:, ..., a:b], dp.scale[L:, a:b], lp[a:b]),
                ("plain", ref32.all[L:], ref32.scale[L:], lp32)):
            shift = (30 * sc - 256 * ref64.scale[L:]).double()
            want = ref64.all[L:] * torch.exp2(shift)[:, None, None, :]
            out[key][0] = max(out[key][0], kernelcheck.col_rel(
                rows.double(), want))
            out[key][1] = max(out[key][1],
                              float((l32.double() - lp64).abs().max()))
        del ref32, ref64
    return {k: {"max_rel_err": v[0], "lp_abs_err": v[1]}
            for k, v in out.items()}


def measure_wide(reps: int, plain: bool, tag: str) -> dict:
    """The wide down pass and sweeps at each shape of WIDE."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    from iqtree2_tpu_torch.ops.pruning import DownPass
    out = {}
    for name, dt, taxa, sites in WIDE:
        dtype = getattr(torch, dt)
        aln, tree, model, rates = kernelcheck.simulate(name, taxa, sites,
                                                       seed=1)
        eng = kernelcheck.make_engine(aln, model, rates, dtype=dtype,
                                      device="cuda")
        pb = kernelcheck.Problem(eng, tree)
        same_P(pb)
        window = kernelcheck.plain_window(eng)
        wins = kernelcheck.windows(eng.Pp, window)
        C, S = pb.P.shape[1], pb.tipP.shape[1]
        row = {"C": C, "S": S, "Pp": eng.Pp, "down_sha256": down_bits(
            pb, kernels)}
        for r in kernelcheck.check(eng, tree, window=window):
            row[r["name"]] = {k: r[k] for k in (
                "max_rel_err", "max_abs_err", "scales_equal", "launches",
                "lp_err") if k in r}
        if dtype == torch.float32:
            row["f64_view"] = f64_view(pb, wins, kernels, kernelcheck)
        dp, lp = pb.down_buffers(), pb.lp_buffer()
        pb.down(kernels.down_pass, dp)
        u, t = pb.up_buffers(dp), pb.theta_buffers()
        lp_k = pb.sitelp(lp)
        fns = {"down_pass": lambda: pb.down(kernels.down_pass, dp),
               "sitelp": lambda: pb.down(kernels.down_pass, dp, lp_k),
               "up_pass": lambda: pb.up(kernels.up_pass, dp, u),
               "theta_pass": lambda: pb.theta(kernels.theta_pass, dp, t)}
        for key, fn in fns.items():
            row.setdefault(key, {}).update(
                ms=kernelcheck.timed_ms(fn, reps),
                b2b_ms=kernelcheck.back_to_back_ms(fn, reps))
        if plain:  # one run over the plain version's windows
            subs = [(pb.window(a, b),
                     DownPass(dp.all[..., a:b].contiguous(),
                              dp.scale[:, a:b].contiguous()))
                    for a, b in wins]
            runs = {
                "down_pass": lambda w, d: w.down(kernels.down_pass_plain,
                                                 w.down_buffers()),
                "sitelp": lambda w, d: w.down(kernels.down_pass_plain,
                                              w.down_buffers(),
                                              w.sitelp(w.lp_buffer())),
                "up_pass": lambda w, d: w.up(kernels.up_pass_plain, d,
                                             w.up_buffers(d)),
                "theta_pass": lambda w, d: w.theta(kernels.theta_pass_plain,
                                                   d, w.theta_buffers())}
            for key, run in runs.items():
                row[key]["plain_ms"] = kernelcheck.timed_ms(
                    lambda: [run(w, d) for w, d in subs], 1)
            del subs
        bnd = kernelcheck.bounds(eng, tree)
        for key, b in (("down_pass", "down_pass"),
                       ("sitelp", "down_pass_sitelp"),
                       ("up_pass", "up_pass"), ("theta_pass", "theta_pass")):
            row[key].update(bound_ms=bnd[b]["bound_ms"],
                            bound_by=bnd[b]["bound_by"],
                            share=bnd[b]["bound_ms"] / row[key]["b2b_ms"])
        row["occupancy"] = {k: kernels.pass_occupancy(k, dtype, C, S, eng.Pp)
                            for k in ("down_pass", "up_pass", "theta_pass")}
        key = f"{name} {dt} {taxa}x{sites}"
        out[key] = row
        print(f"{tag} {key}: {json.dumps(row)}", flush=True)
        del eng, pb, dp, lp, lp_k, u, t, fns
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
        same_P(pb)
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
        bits = {r["tag"]: r["wide"][key].get("down_sha256") for r in runs}
        ok = len(set(bits.values())) == 1
        same &= ok
        print(f"{key}: down pass {'same bits' if ok else 'DIFFERENT bits'}")
        for r in runs:
            s = r["wide"][key]
            cells = [f"{k} {s[k]['b2b_ms']:.4f} ms {100 * s[k]['share']:.2f}%"
                     f" rel {s[k].get('max_rel_err', float('nan')):.1e}"
                     for k in ("down_pass", "sitelp", "up_pass", "theta_pass")
                     if k in s]
            occ = s["occupancy"]
            view = s.get("f64_view")
            print(f"  {r['tag']}: " + "; ".join(cells) + f"; occ {occ}"
                  + (f"; against float64 {view}" if view else ""))
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
