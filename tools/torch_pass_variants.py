#!/usr/bin/env python3
"""Time variants of the whole-pass kernels on one NVIDIA GPU.

    python3 tools/torch_pass_variants.py [--reps N] [--variants A,B] [--out FILE]

Each variant is iqtree2_tpu_torch/csrc/pruning.cu with one or two of its
constants replaced (kWarps: warps per block; kMinBlocks / kMinBlocksWide:
the __launch_bounds__ minimum of resident blocks per SM of the S <= 4 and
the wider instances; kStageBytes: 0 turns the shared-memory staging of
transition matrices off; kPrefetch: false loads a slot's inputs with plain
loads instead of cp.async copies into a buffer; kRegCats: 0 computes DNA
columns twice instead of holding them in registers). The chosen variants
(default all) are built by nvcc at once with -Xptxas -v, whose report (registers, spill bytes per kernel instance) goes
to the output as one JSON line per variant; each is bound with ctypes,
held against the plain versions (ops/kernels.py) and timed with CUDA
events, kernel only (buffers built once, outside the timed region): the
down pass without and with its site-logL epilogue, the up pass and the
theta pass, each launched as the host goes ("ms") and queued back to back
behind a spinning kernel ("b2b_ms", kernelcheck.back_to_back_ms), at the
flagship's shapes (example.phy on ref_tree.nwk, GTR+G4, Pp 1152) and at
1000 taxa x 16384 sites simulated under GTR+G4 (seed 1), in float32, the
same alignment under GTR+G8 (8 categories: the two-sweep DNA column) in
float32, and at 64 taxa x 4096 sites simulated under LG+G4 (seed 1) in
float32 and float64. Variants are timed in turns, forward then backward, so drift in
clocks hits all alike. One JSON line per (variant, shape) goes to stdout
and to --out. Then, for the first variant, where a pass spends its time:
each pass (down, up, theta) run over the first k level steps of the
flagship's and of the 1000 x 16384 schedule only (k = 1, 2, 4, ..., all),
with the number of nodes in those steps, as one more JSON line each.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
# the source as it is (8 warps, at least 4 resident blocks at S <= 4 and
# no minimum above, matrices staged, float32 DNA inputs by cp.async, DNA
# columns in registers), and one or two constants changed; warps x blocks
# stays at 32 warps per SM (64 registers a thread) in the warps4 and
# warps16 variants
VARIANTS = {
    "base": {},
    "minblocks1": {"kMinBlocks": "1"},
    "minblocks3": {"kMinBlocks": "3"},
    "warps4": {"kWarps": "4", "kMinBlocks": "8"},
    "warps16": {"kWarps": "16", "kMinBlocks": "2"},
    "nostage": {"kStageBytes": "0"},
    "noprefetch": {"kPrefetch": "false"},
    "regcats0": {"kRegCats": "0"},
    "regcats0_noprefetch": {"kRegCats": "0", "kPrefetch": "false"},
    "widemin2": {"kMinBlocksWide": "2"},
    "widemin4": {"kMinBlocksWide": "4"},
}
PASSES = ("down_pass", "sitelp", "up_pass", "theta_pass")


def variant_source(subs: dict) -> str:
    src = (ROOT / "iqtree2_tpu_torch" / "csrc" / "pruning.cu").read_text()
    for name, value in subs.items():
        src, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"constant {name} not found once in pruning.cu")
    return src


def ptxas_summary(report: str) -> dict:
    """Kernel instance -> [registers, spill store bytes, spill load bytes]
    from nvcc -Xptxas -v output; instances are named like
    up_pass_kernel<f,4,1,1,1> (type, SMAX, then the bool flags)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)I(\w)Li(\d+)E((?:Lb[01]E)+)",
                          m.group(1))
            name = (f"{k.group(1)}<{k.group(2)},{k.group(3)},"
                    f"{','.join(re.findall(r'Lb([01])E', k.group(4)))}>"
                    if k else m.group(1))
            out[name] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def build_all(tmp: Path, names: list) -> tuple[dict, dict]:
    """(name -> bound library, name -> ptxas summary) of the variants."""
    from iqtree2_tpu_torch.ops import kernels
    procs = {}
    for name in names:
        subs = VARIANTS[name]
        cu = tmp / f"{name}.cu"
        cu.write_text(variant_source(subs))
        so = tmp / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = kernels.bind(ctypes.CDLL(str(so)))
        ptxas[name] = ptxas_summary(out)
    return libs, ptxas


def step_profile(lib, shape, pb, ref, uref, smi: str) -> dict:
    """Kernel ms (back to back) of each pass over the first k level steps
    of pb's schedule, k = 1, 2, 4, ... and all (the up and theta passes
    walk the same steps in reverse, reading the full reference pass's
    outside partials)."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    stream = torch.cuda.current_stream().cuda_stream
    steps = pb.steps
    n = steps.shape[0]
    ks = sorted({min(2 ** i, n) for i in range(n.bit_length() + 1)})
    dk, tk = pb.down_buffers(), pb.theta_buffers()
    tk.up.copy_(uref.up_in)
    out = {"profile": "steps", "shape": shape, "n_steps": n, "k": ks,
           "nodes": [], "down_pass_ms": [], "up_pass_ms": [],
           "theta_pass_ms": [], "device": smi}
    for k in ks:
        sub = steps[:k].contiguous()
        out["nodes"].append(int((sub < pb.n_int).sum()))
        out["down_pass_ms"].append(kernelcheck.back_to_back_ms(
            lambda: kernels.launch_down_pass(
                lib, stream, pb.P, pb.tipP, dk.all, dk.scale, pb.cs, pb.ce,
                sub)))
        out["up_pass_ms"].append(kernelcheck.back_to_back_ms(
            lambda: kernels.launch_up_pass(
                lib, stream, pb.P, pb.tipP, ref.all, ref.scale, uref.up_in,
                uref.up_scale, uref.edge_E, uref.edge_E_scale, pb.cs, pb.ce,
                sub)))
        out["theta_pass_ms"].append(kernelcheck.back_to_back_ms(
            lambda: kernels.launch_theta_pass(
                lib, stream, pb.P, pb.tipP, ref.all, ref.scale, tk.up,
                tk.up_scale, tk.theta, tk.scale, pb.cs, pb.ce, sub, pb.U,
                pb.V, pb.pack["root_freqs"])))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names; the first is profiled")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    names = args.variants.split(",")
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.model.factory import build_model
    from iqtree2_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    f32, f64 = torch.float32, torch.float64
    lg = kernelcheck.simulate("LG+G4", 64, 4096, 1)
    big = kernelcheck.simulate("GTR+G4", 1000, 16384, 1)
    g8_model, g8_rates, _ = build_model(kernelcheck.MODELS["GTR+G8"][2],
                                        big[0])
    problems = [
        ("flagship", kernelcheck.load_problem(
            GOLDEN / "example.phy", GOLDEN / "ref_tree.nwk", "GTR+G4"), f32),
        ("1000x16384", big, f32),
        ("g8_1000x16384", (big[0], big[1], g8_model, g8_rates), f32),
        ("lg64x4096", lg, f32),
        ("lg64x4096", lg, f64),
    ]
    with tempfile.TemporaryDirectory() as d:
        libs, ptxas = build_all(Path(d), names)
        profiled = {}
        rows = [{"variant": name, "ptxas": ptxas[name], "device": smi}
                for name in names]
        for row in rows:
            print(json.dumps(row), flush=True)
        for shape, (aln, tree, model, rates), dtype in problems:
            eng = LikelihoodEngine(aln, model, rates, dtype=dtype,
                                   device="cuda")
            pb = kernelcheck.Problem(eng, tree)
            lp_ref = pb.lp_buffer()
            ref = pb.down(kernels.down_pass_plain, pb.down_buffers(),
                          pb.sitelp(lp_ref))
            uref = pb.up(kernels.up_pass_plain, ref, pb.up_buffers(ref))
            tref = pb.theta(kernels.theta_pass_plain, ref,
                            pb.theta_buffers())
            if shape in ("flagship", "1000x16384"):
                profiled[shape] = (pb, ref, uref)
            stream = torch.cuda.current_stream().cuda_stream
            tol = kernelcheck.TOLERANCE[dtype]
            # one set of kernel buffers for all variants: each variant is
            # checked right after it has rewritten them
            dk, lpk = pb.down_buffers(), pb.lp_buffer()
            uk, tk = pb.up_buffers(ref), pb.theta_buffers()
            sitelp = pb.sitelp(lpk)
            times = {name: {k: [] for k in PASSES} for name in libs}
            b2b = {name: {k: [] for k in PASSES} for name in libs}
            fns, errs = {}, {}
            for name, lib in libs.items():
                fns[name] = {
                    "down_pass": lambda lib=lib: pb.down(
                        lambda *a: kernels.launch_down_pass(
                            lib, stream, *a), dk),
                    "sitelp": lambda lib=lib: pb.down(
                        lambda *a, **kw: kernels.launch_down_pass(
                            lib, stream, *a, **kw), dk, sitelp),
                    "up_pass": lambda lib=lib: pb.up(
                        lambda *a: kernels.launch_up_pass(
                            lib, stream, *a), ref, uk),
                    "theta_pass": lambda lib=lib: pb.theta(
                        lambda *a: kernels.launch_theta_pass(
                            lib, stream, *a), ref, tk),
                }
                for k in ("sitelp", "up_pass", "theta_pass"):
                    fns[name][k]()
                torch.cuda.synchronize()
                errs[name] = max(
                    kernelcheck.col_rel(dk.all[pb.L:], ref.all[pb.L:]),
                    kernelcheck.col_rel(uk.edge_E, uref.edge_E),
                    kernelcheck.col_rel(uk.up_in, uref.up_in),
                    kernelcheck.col_rel(tk.theta, tref.theta),
                    kernelcheck.col_rel(tk.up, tref.up))
                lp_err = kernelcheck.lp_error(lpk, lp_ref, dtype)
                if not (errs[name] <= tol["partials"]
                        and lp_err <= tol["lp"]
                        and torch.equal(dk.scale, ref.scale)
                        and torch.equal(uk.up_scale, uref.up_scale)
                        and torch.equal(uk.edge_E_scale, uref.edge_E_scale)
                        and torch.equal(tk.scale, tref.scale)
                        and torch.equal(tk.up_scale, tref.up_scale)):
                    raise RuntimeError(f"{name} disagrees on {shape} {dtype}")
            order = list(libs) + list(reversed(libs))
            for name in order:
                for k in PASSES:
                    times[name][k].append(
                        kernelcheck.timed_ms(fns[name][k], args.reps))
                    b2b[name][k].append(
                        kernelcheck.back_to_back_ms(fns[name][k]))
            for name in libs:
                row = {"variant": name, "subs": VARIANTS[name],
                       "shape": shape, "dtype": str(dtype).split(".")[-1],
                       "Pp": eng.Pp, "n_steps": int(pb.steps.shape[0]),
                       "max_rel_err": errs[name], "device": smi}
                for k in PASSES:
                    row[f"{k}_ms"] = times[name][k]
                    row[f"{k}_b2b_ms"] = b2b[name][k]
                rows.append(row)
                print(json.dumps(row), flush=True)
        for shape, prob in profiled.items():
            rows.append(step_profile(libs[names[0]], shape, *prob, smi))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0

if __name__ == "__main__":
    sys.exit(main())
