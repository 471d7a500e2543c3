#!/usr/bin/env python3
"""ModelFinder of both packages on one alignment, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_modelfinder_parity.py \\
        [-s tests/golden/example.phy] [-m MF] [--top 8] [--json OUT]

Runs iqtree2_tpu.modelfinder.run_modelfinder (the reference) and
iqtree2_tpu_torch.modelfinder.run_modelfinder (--device cpu) with the same
parameters on the same file, each side built by its own package, and
prints each winner, wall seconds and top table (name, logL, df, BIC)
side by side. With --json the whole tables go to OUT.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _run(side: str, aln_file: str, mode: str) -> dict:
    if side == "jax":
        from iqtree2_tpu.io.alignment_io import read_alignment
        from iqtree2_tpu.modelfinder import run_modelfinder
        from iqtree2_tpu.params import Params
        kw = {}
    else:
        from iqtree2_tpu_torch.io.alignment_io import read_alignment
        from iqtree2_tpu_torch.modelfinder import run_modelfinder
        from iqtree2_tpu_torch.params import Params
        kw = {"device": "cpu"}
    aln = read_alignment(aln_file)
    t0 = time.perf_counter()
    res = run_modelfinder(aln, Params(aln_file=aln_file, model=mode),
                          log=lambda s: None, **kw)
    res["wall"] = time.perf_counter() - t0
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-s", default=str(ROOT / "tests" / "golden"
                                      / "example.phy"))
    ap.add_argument("-m", default="MF")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--json", default="")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = {side: _run(side, args.s, args.m) for side in ("jax", "torch")}
    for side, res in out.items():
        print(f"{side}: best {res['best']} ({res['criterion']}), "
              f"{len(res['table'])} candidates, {res['wall']:.1f} s on the "
              f"CPU")
        for e in res["table"][: args.top]:
            print(f"  {e['name']:<12} logL {e['logL']:.3f}  df {e['df']}  "
                  f"BIC {e['BIC']:.3f}")
    if args.json:
        Path(args.json).write_text(json.dumps(
            {side: {"best": r["best"], "wall": r["wall"],
                    "table": [{k: e[k] for k in ("name", "logL", "df",
                                                 "BIC")}
                              for e in r["table"]]}
             for side, r in out.items()}, indent=1))
    return 0 if out["jax"]["best"] == out["torch"]["best"] else 1


if __name__ == "__main__":
    sys.exit(main())
