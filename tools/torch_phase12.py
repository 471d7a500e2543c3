#!/usr/bin/env python3
"""chip_smoke.py's phase 12 (the partitioned path, then the last
single-alignment flags) by itself, on one card.

    python3 tools/torch_phase12.py [--parts a,b,c,d,e] [--loci N] [--profile]

Builds the kernels, then runs the chosen parts of phase 12 through
chip_smoke.py's own functions, with its checks: a, the partitioned default
command; b, the linkages on example.nex and -S; c, phase 5's 1000 x 16384
alignment in 16 charsets (simulated and written first); d, the simulated
loci, searched (--loci sets their number, chip_smoke.LOCI by default);
e, the single-alignment flags -g, -b, --runs and --symtest.
With --profile each part runs under cProfile and its 40 most expensive
functions by own time and by cumulative time are printed. Outputs go to
chip_smoke_out/.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="a,b,c,d,e")
    ap.add_argument("--loci", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import chip_smoke as cs
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs.OUT.mkdir(parents=True, exist_ok=True)
    if args.loci:
        cs.LOCI = args.loci
    kernels.library()
    errors = {k: 0.0 for k in cs.REPLACES}

    def wide():
        aln, tree, _, _ = kernelcheck.simulate("GTR+G4", cs.BIG_TAXA,
                                               cs.BIG_SITES, seed=1)
        cs.part_wide(*kernelcheck.write_problem(aln, tree, cs.OUT / "big"))

    parts = {"a": cs.part_default, "b": cs.part_linkages, "c": wide,
             "d": lambda: cs.part_loci(errors), "e": cs.part_flags}
    for name in args.parts.split(","):
        prof = cProfile.Profile() if args.profile else None
        t0 = time.perf_counter()
        if prof:
            prof.enable()
        try:
            parts[name]()
        finally:
            if prof:
                prof.disable()
            print(f"[12{name}] {time.perf_counter() - t0:.1f} s", flush=True)
            if prof:
                for key in ("tottime", "cumulative"):
                    s = io.StringIO()
                    pstats.Stats(prof, stream=s).sort_stats(key) \
                        .print_stats(40)
                    print(s.getvalue(), flush=True)
    print(f"kernel errors {errors}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
