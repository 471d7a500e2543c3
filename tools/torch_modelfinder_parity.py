#!/usr/bin/env python3
"""ModelFinder of both packages on one alignment, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_modelfinder_parity.py \\
        [-s tests/golden/example.phy | --simulate TAXA SITES] [-m MF]
        [-mset L] [-mrate L] [-cmax K] [--alternation-cats C] [--top 8]
        [--json OUT] [--fits M1,M2,...]

Runs iqtree2_tpu.modelfinder.run_modelfinder (the reference) and
iqtree2_tpu_torch.modelfinder.run_modelfinder (--device cpu) with the same
parameters on the same file, each side built by its own package, and
prints each winner, wall seconds and top table (name, logL, df, BIC)
side by side. With --json the whole tables go to OUT.

--simulate writes chip_smoke.py phase 5's alignment (GTR+G4, seed 1) at
TAXA x SITES to a temporary file and selects on it. --alternation-cats C
sets both packages' joint-fit size guard (MAX_REVERSE_ELEMENTS) so that
every model with C or more rate categories takes the host alternation,
as C = 4 does at 1000 x 16384 (chip_smoke.py phase 9) under the real
guard: phase 9's routes at a width the CPU can run, e.g.

    JAX_PLATFORMS=cpu python tools/torch_modelfinder_parity.py \\
        --simulate 100 2048 -m TESTONLY -mset HKY,GTR -mrate E,G,R \\
        -cmax 4 --alternation-cats 4 --top 20

--fits (with --simulate) runs no ModelFinder: each listed model gets one
joint fit (try_fit, float32, ModelFinder's epsilon 0.1) from its default
start on the simulating tree in each package, without the warm starts
ModelFinder hands from fit to fit, and the two logLs are printed.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _run(side: str, aln_file: str, mode: str, extra: dict) -> dict:
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
    res = run_modelfinder(aln, Params(aln_file=aln_file, model=mode,
                                      **extra),
                          log=lambda s: None, **kw)
    res["wall"] = time.perf_counter() - t0
    return res


def _single_fits(aln, tree, models: list[str]) -> None:
    import jax.numpy as jnp
    import torch
    from iqtree2_tpu import engine as jengine
    from iqtree2_tpu.model import jaxfit
    from iqtree2_tpu.model.factory import build_model as jbuild_model
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.model import torchfit
    from iqtree2_tpu_torch.model.factory import build_model
    from tests.torch_parity import both_trees, jax_alignment
    jaln = jax_alignment(aln)
    for name in models:
        t, jt = both_trees(tree, aln.names)
        model, rates, _ = build_model(name, aln)
        lt = torchfit.try_fit(LikelihoodEngine(
            aln, model, rates, dtype=torch.float32, device="cpu"), t,
            epsilon=0.1)
        jmodel, jrates, _ = jbuild_model(name, jaln)
        lj = jaxfit.try_fit(jengine.LikelihoodEngine(
            jaln, jmodel, jrates, dtype=jnp.float32), jt, epsilon=0.1)
        print(f"{name}: jax {lj:.3f}  torch {lt:.3f}  torch - jax "
              f"{lt - lj:.3f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-s", default=str(ROOT / "tests" / "golden"
                                      / "example.phy"))
    ap.add_argument("--simulate", type=int, nargs=2, default=None,
                    metavar=("TAXA", "SITES"))
    ap.add_argument("-m", default="MF")
    ap.add_argument("-mset", default="")
    ap.add_argument("-mrate", default="")
    ap.add_argument("-cmax", type=int, default=10)
    ap.add_argument("--alternation-cats", type=int, default=0)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--json", default="")
    ap.add_argument("--fits", default="")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    tmp = tempfile.TemporaryDirectory()
    if args.simulate:
        from iqtree2_tpu_torch import kernelcheck
        aln, tree, _, _ = kernelcheck.simulate("GTR+G4", *args.simulate,
                                               seed=1)
        if args.fits:
            _single_fits(aln, tree, args.fits.split(","))
            return 0
        args.s = kernelcheck.write_problem(aln, tree,
                                           Path(tmp.name) / "sim")[0]
    if args.alternation_cats:
        from iqtree2_tpu.model import jaxfit
        from iqtree2_tpu_torch.io.alignment_io import read_alignment
        from iqtree2_tpu_torch.model import torchfit
        aln = read_alignment(args.s)
        # n_int * C * S * Pp against the guard; half a category of margin
        # covers the pattern padding
        jaxfit.MAX_REVERSE_ELEMENTS = torchfit.MAX_REVERSE_ELEMENTS = (
            (aln.ntaxa - 2) * (args.alternation_cats - 0.5)
            * aln.num_states * aln.num_patterns)
    extra = dict(mset=args.mset, mrate=args.mrate, cmax=args.cmax)
    out = {}
    for side in ("jax", "torch"):
        res = out[side] = _run(side, args.s, args.m, extra)
        print(f"{side}: best {res['best']} ({res['criterion']}), "
              f"{len(res['table'])} candidates, {res['wall']:.1f} s on the "
              f"CPU")
        for e in res["table"][: args.top]:
            print(f"  {e['name']:<12} logL {e['logL']:.3f}  df {e['df']}  "
                  f"BIC {e['BIC']:.3f}", flush=True)
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
