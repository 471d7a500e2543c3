#!/usr/bin/env python3
"""chip_smoke.py's phase 14 (codon models, +E, --mdef, partitioned
mixtures) by itself, on one card.

    python3 tools/torch_phase14.py [--parts a,b,c,d,e,f] [--profile]
                                   [--keep-going]

Builds the kernels, simulates phase 5's 1000 x 16384 GTR+G4 alignment
where parts d or e need it, then runs the chosen parts of phase 14 through
chip_smoke.py's own functions, with its checks: a, the kernels against
their plain versions on the model families' problems; b, the codon search
(-st CODON -m GY+F3X4+G -B 1000, 100 x 2000 codons); c, KOSI07+F+G and
MG+F3X4 -te on b's data (b runs with it); d, +E at full width and on
example.phy; e, the --mdef models; f, the partitioned mixture. With
--profile each part runs under cProfile and its 40 most expensive
functions by own time and by cumulative time are printed. Outputs go to
chip_smoke_out/.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="a,b,c,d,e,f")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--keep-going", action="store_true",
                    help="run the later parts after one fails (the exit "
                         "code is still 1)")
    args = ap.parse_args()
    import chip_smoke as cs
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs.OUT.mkdir(parents=True, exist_ok=True)
    parts = args.parts.split(",")
    t0 = time.perf_counter()
    kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    aln_path = tree_path = ""
    if "d" in parts or "e" in parts:
        t0 = time.perf_counter()
        aln, tree, _, _ = kernelcheck.simulate("GTR+G4", cs.BIG_TAXA,
                                               cs.BIG_SITES, seed=1)
        aln_path, tree_path = kernelcheck.write_problem(aln, tree,
                                                        cs.OUT / "big")
        print(f"phase 5's alignment in {time.perf_counter() - t0:.1f} s",
              flush=True)
    errors = {k: 0.0 for k in cs.REPLACES}
    launches: dict = {}
    failed = []
    for name in parts:
        if name == "c" and "b" in parts:
            continue      # b runs c with it
        # c needs b's alignment and fit
        chosen = {"b": "bc" if "c" in parts else "b", "c": "bc"}.get(name,
                                                                     name)
        prof = cProfile.Profile() if args.profile else None
        t0 = time.perf_counter()
        if prof:
            prof.enable()
        try:
            got, _ = cs.model_families(errors, aln_path, tree_path,
                                       parts=chosen)
            cs.add(launches, got)
        except Exception:
            if not args.keep_going:
                raise
            traceback.print_exc()
            failed.append(name)
        finally:
            if prof:
                prof.disable()
            print(f"[14{name}] {time.perf_counter() - t0:.1f} s", flush=True)
            if prof:
                for key in ("tottime", "cumulative"):
                    s = io.StringIO()
                    pstats.Stats(prof, stream=s).sort_stats(key) \
                        .print_stats(40)
                    print(s.getvalue(), flush=True)
    print(f"kernel errors {errors}; launches {json.dumps(launches)}")
    if failed:
        print(f"failed parts: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
