#!/usr/bin/env python3
"""chip_smoke.py's phase 17 (the distributed search and the pattern-sharded
likelihood) by itself, on one card.

    python3 tools/torch_phase17.py [--parts a,b,c]

Builds the kernels, then runs the chosen parts of phase 17 through
chip_smoke.py's own functions, with its checks: a, dryrun_multichip on
phase 5's problem (1000 x 16384 GTR+G4 simulated, seed 1, float32) over 2
gloo ranks on the card and 1 NCCL rank, then the kernels at a rank's
shapes; b, the distributed command line, two processes on the card; c,
DistributedSearch at 1 and 2 ranks at the flagship's shapes. Prints each
part's lines, the phase's wall, the launches of b and the kernels' errors.
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
    ap.add_argument("--parts", default="a,b,c")
    args = ap.parse_args()
    import chip_smoke as cs
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs.OUT.mkdir(parents=True, exist_ok=True)
    parts = args.parts.replace(",", "")
    t0 = time.perf_counter()
    kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    problem = None
    if "a" in parts:
        t0 = time.perf_counter()
        problem = kernelcheck.simulate("GTR+G4", cs.BIG_TAXA, cs.BIG_SITES,
                                       seed=1)
        print(f"simulated {cs.BIG_TAXA} x {cs.BIG_SITES} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    g4 = json.loads((cs.GOLDEN / "golden.json").read_text())[
        "logL"]["g4_gtrg_opt"]
    errors = {k: 0.0 for k in cs.REPLACES}
    started: list = []
    try:
        launches = cs.distributed(problem, g4, errors, started, parts)
    finally:
        for proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"distributed launches {json.dumps(launches)}; kernel errors "
          f"{json.dumps(errors)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
