#!/usr/bin/env python3
"""chip_smoke.py's phase 13 (mixture models and PMSF) by itself, on one
card.

    python3 tools/torch_phase13.py [--parts a,b,c,d,e] [--profile]

Builds the kernels, then runs the chosen parts of phase 13 through
chip_smoke.py's own functions, with its checks: a, the kernels against
their plain versions at the mixtures' shapes (C = 80 and 240, LG4X); b,
the PMSF guide fit at C = 240 (-m LG+C60+G --pmsf -te, 100 x 2000); c, a
mixture search (-m LG+C20+G -B 1000 -wspm, 24 x 1000); d, the PMSF search
on c's alignment (c runs first if it is not chosen); e, MIX{LG,WAG}+G's
fitted weights on the card against the CPU in float64 (the CPU fit starts
first and runs beside the other parts). With --profile each part runs
under cProfile and its 40 most expensive functions by own time and by
cumulative time are printed. Outputs go to chip_smoke_out/.
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
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import chip_smoke as cs
    from iqtree2_tpu_torch.ops import kernels
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs.OUT.mkdir(parents=True, exist_ok=True)
    parts = args.parts.split(",")
    cpu = cs.start_cpu_weights_fit() if "e" in parts else None
    try:
        t0 = time.perf_counter()
        kernels.library()
        print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
        errors = {k: 0.0 for k in cs.REPLACES}
        state: dict = {}

        def search():
            state["phy"] = cs.mix_search()[0]

        def pmsf_search():
            if "phy" not in state:
                search()
            cs.mix_pmsf_search(state["phy"])

        run = {"a": lambda: cs.mix_kernels(errors), "b": cs.mix_pmsf_guide,
               "c": search, "d": pmsf_search,
               "e": lambda: cs.mix_weights(cpu)}
        for name in parts:
            prof = cProfile.Profile() if args.profile else None
            t0 = time.perf_counter()
            if prof:
                prof.enable()
            try:
                run[name]()
            finally:
                if prof:
                    prof.disable()
                print(f"[13{name}] {time.perf_counter() - t0:.1f} s",
                      flush=True)
                if prof:
                    for key in ("tottime", "cumulative"):
                        s = io.StringIO()
                        pstats.Stats(prof, stream=s).sort_stats(key) \
                            .print_stats(40)
                        print(s.getvalue(), flush=True)
        print(f"kernel errors {errors}")
    finally:
        if cpu is not None:
            cpu.kill()
            cpu.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
