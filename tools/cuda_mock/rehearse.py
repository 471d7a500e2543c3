#!/usr/bin/env python3
"""Rehearse iqtree2_tpu_torch/csrc/pruning.cu on the CPU, without a card.

    python3 tools/cuda_mock/rehearse.py [--build-dir DIR]

The source is compiled by g++ against the mock cuda_runtime.h beside this
script (every CUDA thread of a block a std::thread, __syncthreads and
__syncwarp std::barriers, blocks one after another), after each
``kernel<<<grid, block, shm, stream>>>(`` is rewritten into
``mock_launch(grid, block, shm, stream, kernel, ``. The library is bound
with ops/kernels.bind and the whole-pass kernels run on CPU tensors
(stream None) against their plain versions: the down pass with its
site-logL epilogue, the up pass and the theta pass, on down-pass buffers
whose tip rows are NaN (no kernel may read them); DNA (the register
column, and C = 8 through the two-sweep column), protein and a 61-state
GTR, float32 and float64, on trees deep enough to rescale; the shapes
ModelFinder brings (one category, FreeRate weights with +I, ten
categories, at 4 and 20 states); the codon models (GY+F3X4, KOSI07), +E
tips, two states and seven; every partition engine of the
supermatrices of kernelcheck.PARTITIONS (a short partition, one lacking
taxa, protein beside DNA); and the wide instance (S > 64: PoMo at 76, 112
and 136 states, a 65-state --mdef datatype under a reversible model, and
PoMo at 76 with one category, where theta_pass stages U and V, and PoMo
at 454 states, past what shared memory stages in float64), which two more
builds run again with smaller shared-memory budgets (kWideShmBytes): 48 KB
stages the columns but not the output tile (the recomputing sweeps), 0
stages nothing (the columns read in place, theta_pass's workspace of E).
``--wide`` runs the wide shapes alone. It checks indexing, the barriers,
the block reductions and the rescale; it says nothing of speed or of what
nvcc accepts.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))

from iqtree2_tpu_torch import kernelcheck  # noqa: E402
from iqtree2_tpu_torch.data.alignment import Alignment  # noqa: E402
from iqtree2_tpu_torch.engine import LikelihoodEngine  # noqa: E402
from iqtree2_tpu_torch.model.factory import build_model  # noqa: E402
from iqtree2_tpu_torch.model.rates import RateGamma  # noqa: E402
from iqtree2_tpu_torch.model.subst import GTRModel  # noqa: E402
from iqtree2_tpu_torch.ops import kernels  # noqa: E402
from iqtree2_tpu_torch.partition.engine import PartitionEngine  # noqa: E402
from iqtree2_tpu_torch.tree.topology import Tree  # noqa: E402


# the wide instance's shapes: (model, taxa, sites); "... C1" drops +G4; 30
# taxa rescale the down pass in float32
WIDE = (("GTR+P13+G4", 30, 60), ("GTR+P19+G4", 9, 100),
        ("GTR+P23+G4", 9, 60), ("MK65+G4", 12, 100),
        ("GTR+P13+G4 C1", 9, 60))
# 454 states, past what shared memory stages in float64: the default
# build's passes read their columns in place there
WIDE_IN_PLACE = (("GTR+P76+G4", 6, 12),)
# the wide instance's shared-memory budgets besides the card's: 48 KB stages
# the columns but not the output tile (float32 at 76 states; float64 theta
# reads in place), 0 stages nothing
WIDE_BUDGETS = (("48 * 1024", " (columns staged)"), ("0", " (in place)"))


def build(out_dir: Path, tag: str = "", replace=()) -> ctypes.CDLL:
    src = kernels.SOURCE.read_text()
    for old, new in replace:
        assert old in src, old
        src = src.replace(old, new)
    src, n = re.subn(r"(\w+(?:<[^<>;]*>)?)<<<([^>]*)>>>\(",
                     r"mock_launch(\2, \1, ", src)
    cpp = out_dir / f"pruning_mock{tag}.cpp"
    cpp.write_text(src)
    so = out_dir / f"libpruning_mock{tag}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{HERE}", "-o", str(so), str(cpp)],
                   check=True)
    print(f"{n} launches rewritten; built {so}")
    return kernels.bind(ctypes.CDLL(str(so)))


def check_wide(lib, tag: str, shapes=WIDE) -> None:
    for name, ntaxa, nsites in shapes:
        model_name = name.removesuffix(" C1")
        aln, tree, model, rates = kernelcheck.simulate(model_name, ntaxa,
                                                       nsites, seed=3)
        if name != model_name:
            model, rates, _ = build_model(
                kernelcheck.MODELS[model_name][2].removesuffix("+G{0.6}"),
                aln)
        for dtype in (torch.float32, torch.float64):
            check(lib, kernelcheck.make_engine(aln, model, rates,
                                               dtype=dtype, device="cpu"),
                  tree, f"{name}{tag}")


def check(lib, eng: LikelihoodEngine, tree: Tree, tag: str) -> None:
    pb = kernelcheck.Problem(eng, tree)
    lp_ref, lp = pb.lp_buffer(), pb.lp_buffer()
    ref = pb.down(kernels.down_pass_plain, pb.down_buffers(),
                  pb.sitelp(lp_ref))
    uref = pb.up(kernels.up_pass_plain, ref, pb.up_buffers(ref))
    tref = pb.theta(kernels.theta_pass_plain, ref, pb.theta_buffers())
    got = pb.down_buffers()
    got.all[pb.L:] = float("nan")
    pb.down(lambda *a, **kw: kernels.launch_down_pass(lib, None, *a, **kw),
            got, pb.sitelp(lp))
    u = pb.up_buffers(ref)
    u.edge_E[1:] = float("nan")
    u.up_in[:pb.n_int - 1] = float("nan")
    pb.up(lambda *a: kernels.launch_up_pass(lib, None, *a), ref, u)
    t = pb.theta(lambda *a: kernels.launch_theta_pass(lib, None, *a), ref,
                 pb.theta_buffers())
    err = max(kernelcheck.col_rel(got.all[pb.L:], ref.all[pb.L:]),
              kernelcheck.col_rel(u.edge_E, uref.edge_E),
              kernelcheck.col_rel(u.up_in, uref.up_in),
              kernelcheck.col_rel(t.theta, tref.theta),
              kernelcheck.col_rel(t.up, tref.up))
    lp_err = kernelcheck.lp_error(lp, lp_ref, eng.dtype)
    same = (torch.equal(got.scale, ref.scale)
            and torch.equal(u.edge_E_scale, uref.edge_E_scale)
            and torch.equal(u.up_scale, uref.up_scale)
            and torch.equal(t.scale, tref.scale)
            and torch.equal(t.up_scale, tref.up_scale))
    tol = kernelcheck.TOLERANCE[eng.dtype]
    print(f"{tag} {eng.dtype}: max rel err {err:.2e}, lp err {lp_err:.2e}, "
          f"scales equal {same}, rescaled columns: down "
          f"{int((ref.scale > 0).sum())}, UP "
          f"{int((tref.up_scale > 0).sum())}")
    if not (err <= tol["partials"] and lp_err <= tol["lp"] and same):
        raise SystemExit(f"{tag}: the mock build disagrees")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-dir", default="")
    ap.add_argument("--wide", action="store_true",
                    help="the wide instance's shapes alone")
    args = ap.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        lib = build(Path(args.build_dir or d))
        check_wide(lib, "", WIDE + WIDE_IN_PLACE)
        for k, (budget, tag) in enumerate(WIDE_BUDGETS):
            check_wide(build(Path(args.build_dir or d), f"_budget{k}",
                             [("kWideShmBytes = 227 * 1024",
                               f"kWideShmBytes = {budget}")]), tag)
        if args.wide:
            return 0
        for name, ntaxa, nsites in (("GTR+G4", 40, 300), ("HKY+I", 9, 150),
                                    ("GTR+G8", 30, 200), ("LG+G4", 9, 150),
                                    ("JC", 30, 200), ("GTR+I+R3", 30, 200),
                                    ("GTR+R10", 30, 200), ("LG+I", 9, 150),
                                    ("LG+F+R10", 9, 150),
                                    ("GY+F3X4+G4", 12, 60),
                                    ("KOSI07+G4", 12, 60),
                                    ("HKY+E+G4", 40, 300),
                                    ("JC2+G4", 40, 300),
                                    ("MK7+G4", 30, 200),
                                    ("UNREST+G4", 30, 200),
                                    ("12.12+G4", 30, 200),
                                    ("GTR+P+G4", 9, 150),
                                    ("GTR+H4", 30, 200),
                                    ("UNREST+G4 rooted", 30, 200)):
            model_name = name.removesuffix(" rooted")
            aln, tree, model, rates = kernelcheck.simulate(model_name, ntaxa,
                                                           nsites, seed=3)
            if name != model_name:
                aln, tree = kernelcheck.rooted_problem(aln, tree)
            for dtype in (torch.float32, torch.float64):
                check(lib, kernelcheck.make_engine(aln, model, rates,
                                                   dtype=dtype, device="cpu"),
                      tree, name)
        for name in kernelcheck.PARTITIONS:
            sa, tree, models, rates = kernelcheck.simulate_partitioned(
                name, 30, seed=3)
            for dtype in (torch.float32, torch.float64):
                peng = PartitionEngine(sa, models, rates, dtype=dtype,
                                       device="cpu")
                for k, eng in enumerate(peng.engines):
                    check(lib, eng, tree, f"{name} partition {k + 1}")
        rng = np.random.default_rng(3)
        names = [f"t{i}" for i in range(7)]
        codons = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
                  if a + b + c not in ("TAA", "TAG", "TGA")]
        aln = Alignment.from_sequences(
            names, ["".join(rng.choice(codons, 40)) for _ in names],
            seqtype="CODON")
        model = GTRModel(61, exch_rates=rng.uniform(0.2, 3.0, 1830),
                         freq_type="equal", fixed_rates=True)
        for dtype in (torch.float32, torch.float64):
            check(lib, LikelihoodEngine(aln, model, RateGamma(4, alpha=0.6),
                                        dtype=dtype, device="cpu"),
                  Tree.random_topology(names, rng), "GTR61+G4")
    return 0


if __name__ == "__main__":
    sys.exit(main())
