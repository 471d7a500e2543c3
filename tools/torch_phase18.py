#!/usr/bin/env python3
"""chip_smoke.py's phase 18 (the kernels' wide instance, S > 64) by itself,
on one card.

    python3 tools/torch_phase18.py [--parts a,b,c,d,e] [--measure-te]

Builds the kernels, then runs the chosen parts of phase 18 through
chip_smoke.py's own functions, with its checks: a, the kernels against
their plain versions under PoMo at 76, 112 and 136 states; b, 100 x 16384
under GTR+P19+G4 (a logL, a Newton round, an NNI round, the kernels
there); c, -m GTR+P19+G4 -B 1000 on example.phy; d, -m GTR+P19+G4 -te in
float64 against the CPU; e, a 65-state --mdef datatype's -te fit.
--measure-te first runs d's -te fit in float32 and bounds c by its logL
less 0.5 (how chip_smoke.POMO_TE_LOGL is measured). Prints each part's
lines, the phase's wall, the launches of c and e and the kernels' errors.
Outputs go to chip_smoke_out/.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="a,b,c,d,e")
    ap.add_argument("--measure-te", action="store_true")
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
    te = cs.pomo_te("float32") if args.measure_te else None
    errors = {k: 0.0 for k in cs.REPLACES}
    timed, launches = cs.wide_states(errors, args.parts.replace(",", ""),
                                     te_bound=te)
    print(f"wide launches {json.dumps(launches)}; kernel errors "
          f"{json.dumps(errors)}; 18b ms "
          f"{ {k: (r['ms'], r['b2b_ms'], r['plain_ms'], r['bound_ms'])
              for k, r in timed.items()} }")
    return 0


if __name__ == "__main__":
    sys.exit(main())
