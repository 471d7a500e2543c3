#!/usr/bin/env python3
"""chip_smoke.py's phase 15 (nonreversible models, Lie-Markov, PoMo, +H,
+T, the root test) by itself, on one card.

    python3 tools/torch_phase15.py [--parts a,b,c,d,e,f,g] [--profile]
                                   [--keep-going]

Builds the kernels, then runs the chosen parts of phase 15 through
chip_smoke.py's own functions, with its checks: a, the kernels against
their plain versions at 64 x 4096 under UNREST+G4, 12.12+G4, GTR+P+G4,
GTR+H4 and the rooted UNREST+G4 problem; b, the nonreversible Newton and
NNI climb at 1000 x 16384; c, example.phy -m UNREST+G -B 1000 --root-test;
d, -m GTR+H4 -B 1000; e, PoMo and 3.3b+G -te against the CPU; f, the tree
mixture GTR+G+T; g, a --mdef reversible: false model against UNREST{...}.
Each part prints its wall. With --profile each part runs under cProfile
and its 40 most expensive functions by own time and by cumulative time
are printed. Outputs go to chip_smoke_out/.
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
    ap.add_argument("--parts", default="a,b,c,d,e,f,g")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--keep-going", action="store_true",
                    help="run the later parts after one fails (the exit "
                         "code is still 1)")
    args = ap.parse_args()
    import chip_smoke as cs
    from iqtree2_tpu_torch.ops import kernels
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs.OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    errors = {k: 0.0 for k in cs.REPLACES}
    launches: dict = {}
    failed = []
    for name in args.parts.split(","):
        prof = cProfile.Profile() if args.profile else None
        t0 = time.perf_counter()
        if prof:
            prof.enable()
        try:
            got, _, search = cs.nonrev_families(errors, parts=name)
            cs.add(launches, got)
            cs.add(launches, search)
        except Exception:
            if not args.keep_going:
                raise
            traceback.print_exc()
            failed.append(name)
        finally:
            if prof:
                prof.disable()
            print(f"[15{name}] {time.perf_counter() - t0:.1f} s", flush=True)
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
