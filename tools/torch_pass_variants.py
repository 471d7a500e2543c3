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
(default all) are built by nvcc at once, bound with ctypes, held against
the plain versions (ops/kernels.py) and timed with CUDA events, kernel only
(buffers built once, outside the timed region), at the flagship's shapes
(example.phy on ref_tree.nwk, GTR+G4, Pp 1152) and at 1000 taxa x 16384
sites simulated under GTR+G4 (seed 1), in float32, and at 64 taxa x 4096
sites simulated under LG+G4 (seed 1) in float32 and float64. Variants are
timed in turns, forward then backward, so drift in clocks hits all alike.
One JSON line per (variant, shape) goes to stdout and to --out. Then, for
the first variant, where a pass spends its time: each pass run over the
first k level steps of the 1000 x 16384 schedule only (k = 1, 2, 4, ...,
all), with the number of nodes in those steps, as one more JSON line.
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


def variant_source(subs: dict) -> str:
    src = (ROOT / "iqtree2_tpu_torch" / "csrc" / "pruning.cu").read_text()
    for name, value in subs.items():
        src, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"constant {name} not found once in pruning.cu")
    return src


def build_all(tmp: Path, names: list) -> dict:
    from iqtree2_tpu_torch.ops import kernels
    procs = {}
    for name in names:
        subs = VARIANTS[name]
        cu = tmp / f"{name}.cu"
        cu.write_text(variant_source(subs))
        so = tmp / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = kernels.bind(ctypes.CDLL(str(so)))
    return libs


def step_profile(lib, pb, ref, uref, reps: int, smi: str) -> dict:
    """Kernel ms of each pass over the first k level steps of pb's
    schedule, k = 1, 2, 4, ... and all (the up pass walks the same steps
    in reverse, reading the full reference pass's outside partials)."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    stream = torch.cuda.current_stream().cuda_stream
    steps = pb.steps
    n = steps.shape[0]
    ks = sorted({min(2 ** i, n) for i in range(n.bit_length() + 1)})
    dk = pb.down_buffers()
    out = {"profile": "steps", "n_steps": n, "k": ks, "nodes": [],
           "down_pass_ms": [], "up_pass_ms": [], "device": smi}
    for k in ks:
        sub = steps[:k].contiguous()
        out["nodes"].append(int((sub < pb.n_int).sum()))
        out["down_pass_ms"].append(kernelcheck.timed_ms(
            lambda: kernels.launch_down_pass(
                lib, stream, pb.P, pb.tipP, dk.all, dk.scale, pb.cs, pb.ce,
                sub), reps))
        out["up_pass_ms"].append(kernelcheck.timed_ms(
            lambda: kernels.launch_up_pass(
                lib, stream, pb.P, pb.tipP, ref.all, ref.scale, uref.up_in,
                uref.up_scale, uref.edge_E, uref.edge_E_scale, pb.cs, pb.ce,
                sub), reps))
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
    from iqtree2_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    f32, f64 = torch.float32, torch.float64
    lg = kernelcheck.simulate("LG+G4", 64, 4096, 1)
    problems = [
        ("flagship", kernelcheck.load_problem(
            GOLDEN / "example.phy", GOLDEN / "ref_tree.nwk", "GTR+G4"), f32),
        ("1000x16384", kernelcheck.simulate("GTR+G4", 1000, 16384, 1), f32),
        ("lg64x4096", lg, f32),
        ("lg64x4096", lg, f64),
    ]
    with tempfile.TemporaryDirectory() as d:
        libs = build_all(Path(d), names)
        rows = []
        for shape, (aln, tree, model, rates), dtype in problems:
            eng = LikelihoodEngine(aln, model, rates, dtype=dtype,
                                   device="cuda")
            pb = kernelcheck.Problem(eng, tree)
            ref = pb.down(kernels.down_pass_plain, pb.down_buffers())
            uref = pb.up(kernels.up_pass_plain, ref, pb.up_buffers(ref))
            if shape == "1000x16384":
                profiled = (pb, ref, uref)
            stream = torch.cuda.current_stream().cuda_stream
            tol = kernelcheck.TOLERANCE[dtype]["partials"]
            times = {name: {"down_pass": [], "up_pass": []} for name in libs}
            errs = {}
            for name, lib in libs.items():
                dk, uk = pb.down_buffers(), pb.up_buffers(ref)

                def down(lib=lib, dk=dk):
                    pb.down(lambda *a: kernels.launch_down_pass(
                        lib, stream, *a), dk)

                def up(lib=lib, uk=uk):
                    pb.up(lambda *a: kernels.launch_up_pass(
                        lib, stream, *a), ref, uk)

                down()
                up()
                torch.cuda.synchronize()
                errs[name] = max(
                    kernelcheck.col_rel(dk.all[pb.L:], ref.all[pb.L:]),
                    kernelcheck.col_rel(uk.edge_E, uref.edge_E),
                    kernelcheck.col_rel(uk.up_in, uref.up_in))
                if not (errs[name] <= tol
                        and torch.equal(dk.scale, ref.scale)
                        and torch.equal(uk.up_scale, uref.up_scale)
                        and torch.equal(uk.edge_E_scale, uref.edge_E_scale)):
                    raise RuntimeError(f"{name} disagrees on {shape} {dtype}")
                times[name]["fns"] = (down, up)
            order = list(libs) + list(reversed(libs))
            for name in order:
                down, up = times[name]["fns"]
                times[name]["down_pass"].append(
                    kernelcheck.timed_ms(down, args.reps))
                times[name]["up_pass"].append(
                    kernelcheck.timed_ms(up, args.reps))
            for name in libs:
                row = {"variant": name, "subs": VARIANTS[name],
                       "shape": shape, "dtype": str(dtype).split(".")[-1],
                       "Pp": eng.Pp, "n_steps": int(pb.steps.shape[0]),
                       "max_rel_err": errs[name],
                       "down_pass_ms": times[name]["down_pass"],
                       "up_pass_ms": times[name]["up_pass"],
                       "device": smi}
                rows.append(row)
                print(json.dumps(row), flush=True)
        rows.append(step_profile(libs[names[0]], *profiled, args.reps, smi))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0

if __name__ == "__main__":
    sys.exit(main())
