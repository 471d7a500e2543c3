#!/usr/bin/env python3
"""Whether a partitioned fit nests the unpartitioned one, on the CPU.

    python tools/torch_partition_nesting.py [--taxa 100] [--sites 4096]
                                            [--charsets 4] [--f64]

Simulates kernelcheck's GTR+G4 problem (seed 1), cuts it into equal
charsets and fits, on the simulating tree (-te), the unpartitioned model
and the edge-equal (-q) partitioned one under GTR+G (each partition's
empirical frequencies differ from the whole alignment's, so the partitioned
model does not nest the unpartitioned one) and under GTR+FQ+G (equal
frequencies: it does). Prints one line per fit and the differences.
chip_smoke.py's phase 12c holds the partitioned fit to the unpartitioned
one under GTR+FQ+G for this reason.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def logl(prefix: str) -> float:
    text = Path(f"{prefix}.iqtree").read_text()
    return float(text.split("Log-likelihood of the tree:")[1].split()[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--taxa", type=int, default=100)
    ap.add_argument("--sites", type=int, default=4096)
    ap.add_argument("--charsets", type=int, default=4)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()
    from iqtree2_tpu_torch import cli, kernelcheck
    aln, tree, _, _ = kernelcheck.simulate("GTR+G4", args.taxa, args.sites,
                                           seed=1)
    width = args.sites // args.charsets
    with tempfile.TemporaryDirectory() as d:
        phy, nwk = kernelcheck.write_problem(aln, tree, f"{d}/sim")
        nex = Path(d) / "charsets.nex"
        nex.write_text("#nexus\nbegin sets;\n" + "".join(
            f"  charset c{k + 1} = {k * width + 1}-{(k + 1) * width};\n"
            for k in range(args.charsets)) + "end;\n")
        extra = ["--device", "cpu", "-redo", "--quiet"] + (
            ["--f64"] if args.f64 else [])
        for model in ("GTR+G", "GTR+FQ+G"):
            got = []
            for part in ([], ["-q", str(nex)]):
                pre = f"{d}/{model}{len(part)}"
                cli.main(["-s", phy, "-m", model, "-te", nwk, "-pre", pre]
                         + part + extra)
                got.append(logl(pre))
            print(f"{model}: unpartitioned {got[0]:.4f}, -q in "
                  f"{args.charsets} charsets {got[1]:.4f}, difference "
                  f"{got[1] - got[0]:+.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
