#!/usr/bin/env python3
"""chip_smoke.py's phase 16 (the standalone tools and dating) by itself, on
one card.

    python3 tools/torch_phase16.py [--parts a,b,c,d,e] [--cpu-threads N]

Builds the kernels, then runs the chosen parts of phase 16 through
chip_smoke.py's own functions, with its checks: a, --alisim under GTR+G,
LG+G, LG+C10, mimicking example.phy and with indels; b, the search with
UFBoot and --date --date-ci on a strict-clock simulation, launches counted;
c, likelihood mapping on the card against a CPU float64 engine (the CPU
side starts first, on --cpu-threads threads, default 6); d, Sankoff on
the card against the host; e, -r, -con, -rf_all, -pd and -bud. Prints
each part's wall and the launches of b. Outputs go to chip_smoke_out/.
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
    ap.add_argument("--cpu-threads", type=int, default=6)
    args = ap.parse_args()
    import chip_smoke as cs
    from iqtree2_tpu_torch.ops import kernels
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cs.OUT.mkdir(parents=True, exist_ok=True)
    parts = args.parts.replace(",", "")
    cpu = cs.start_cpu_lmap(args.cpu_threads) if "c" in parts else None
    try:
        t0 = time.perf_counter()
        kernels.library()
        print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
        launches = cs.standalone_tools(cpu, parts)
    finally:
        if cpu is not None and cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    print(f"dating launches {json.dumps(launches)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
