#!/usr/bin/env python3
"""chip_smoke.py's phase 18 (the kernels' wide instance, S > 64) by itself,
on one card.

    python3 tools/torch_phase18.py [--parts a,b,c,d,e] [--fit32] [--depths]
        [--root DIR]

Builds the kernels, then runs the chosen parts of phase 18 through
chip_smoke.py's own functions, with its checks: a, the kernels against
their plain versions under PoMo at 76, 112 and 136 states; b, 100 x 16384
under GTR+P19+G4 (a logL, a Newton round, an NNI round, the kernels
there); d, -m GTR+P19+G4 -te in float64 against the CPU; c, -m GTR+P19+G4
-B 1000 on example.phy in float32, its final tree and parameters in
float64 on the CPU against d's logL less 0.5 (c runs d first); e, a
65-state --mdef datatype's -te fit. Prints each part's lines, the phase's
wall, the launches of c and e and the kernels' errors.

--fit32 then compares the float32 and float64 -te fits of d: the float32
fit's own logL, the CPU's float64 logL of its tree and parameters, and
the float64 fit's tree and parameters evaluated in float32 on the card
(the float32 pass's error at a fixed state), on the CPU, and on the card
with P formed in float64, with the float32 site logLs' differences from
the float64 ones on the card. --depths runs c's search at
POMO_DEPTH and at deeper settings, each against d's bound, and goes on
past a search below it. --root DIR takes iqtree2_tpu_torch (and so the
kernels) from DIR, the root of another checkout (e.g. a parent unpacked
with git archive), with this checkout's chip_smoke.py. Outputs go to
chip_smoke_out/. Exits non-zero if a check failed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEPTHS = (["-n", "5", "-ninit", "10", "-ntop", "3", "-nbest", "2"],
          ["-n", "3", "-ninit", "20", "-ntop", "5", "-nbest", "3"],
          ["-n", "10", "-ninit", "20", "-ntop", "5", "-nbest", "5"],
          ["-n", "20", "-ninit", "100", "-ntop", "20", "-nbest", "5"])


def fit32(cs) -> None:
    """The float32 -te fit beside the float64 one (--fit32), then where
    the float32 reading of the float64 fit's state loses its logL: the
    same state in float32 on the CPU (the plain passes), on the card with
    P formed in float64 and cast, and per pattern against the float64
    site logLs on the card (the weighted sum of the differences, the
    largest one, and the share of the patterns more than 1 below)."""
    import numpy as np
    import torch
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.ops import pruning
    from iqtree2_tpu_torch.tree.schedule import build_schedule
    k64: dict = {}
    k32: dict = {}
    l64 = cs.pomo_te("float64", k64)
    r32 = cs.pomo_te("float32", k32)
    v32, _ = cs.cpu_logl(k32)
    state = (k64["aln"], k64["model"], k64["rates"])
    tree = k64["tree"]
    e32 = LikelihoodEngine(*state, dtype=torch.float32, device="cuda")
    e64 = LikelihoodEngine(*state, dtype=torch.float64, device="cuda")
    c32 = LikelihoodEngine(*state, dtype=torch.float32,
                           device="cpu").loglik_tree(tree)
    card32, lp32 = e32.site_lp(tree)
    _, lp64 = e64.site_lp(tree)
    sched = build_schedule(tree)
    P = pruning.transition_tensors(e64._blens(sched), e64._pack).float()
    dp = pruning.down_pass(P, e32._tipP, e32.schedule_arrays(sched),
                           pack=e32._pack, tips=False)
    p64 = float((e32._pw.double() * pruning.site_lp(dp).double()).sum())
    w = e64.pattern_weights[:lp64.size]
    d = lp32 - lp64
    print(f"[fit32] float64 fit {l64:.6f}; float32 fit {r32:.6f}, its tree "
          f"and parameters in float64 on the CPU {v32:.6f} ({v32 - l64:+.6f}"
          f" from the float64 fit); the float64 fit's state in float32 on "
          f"the card {card32:.6f} ({card32 - l64:+.6f}), on the CPU "
          f"{c32:.6f} ({c32 - l64:+.6f}), on the card with P formed in "
          f"float64 {p64:.6f} ({p64 - l64:+.6f}); per pattern, float32 "
          f"less float64 on the card: weighted sum {float(w @ d):+.6f}, "
          f"largest {float(np.abs(d).max()):.6f}, {int((d < -1).sum())} of "
          f"{d.size} patterns more than 1 below, weight "
          f"{float(w[d < -1].sum()):g}", flush=True)


def depths(cs, errors: dict) -> bool:
    """c at POMO_DEPTH and DEPTHS (--depths); True if every one held."""
    bound = cs.pomo_te("float64") - 0.5
    ok = True
    for k, depth in enumerate((cs.POMO_DEPTH,) + DEPTHS):
        print(f"[depths] {' '.join(depth)}", flush=True)
        t0 = time.perf_counter()
        try:
            cs.pomo_search(bound, errors, depth, name=f"pomo_depth{k}")
        except RuntimeError as e:
            ok = False
            print(f"[depths] FAILED: {e}", flush=True)
        print(f"[depths] {time.perf_counter() - t0:.1f} s", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="a,b,c,d,e")
    ap.add_argument("--fit32", action="store_true")
    ap.add_argument("--depths", action="store_true")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from iqtree2_tpu_torch.ops import kernels
    assert Path(kernels.__file__).resolve().is_relative_to(
        Path(args.root).resolve()), kernels.__file__
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"iqtree2_tpu_torch from {args.root}", flush=True)
    cs.OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    errors = {k: 0.0 for k in cs.REPLACES}
    parts = args.parts.replace(",", "")
    if parts:
        timed, launches = cs.wide_states(errors, parts)
        print(f"wide launches {json.dumps(launches)}; kernel errors "
              f"{json.dumps(errors)}; 18b ms "
              f"{ {k: (r['ms'], r['b2b_ms'], r['plain_ms'], r['bound_ms'])
                  for k, r in timed.items()} }", flush=True)
    if args.fit32:
        fit32(cs)
    return 0 if not args.depths or depths(cs, errors) else 1


if __name__ == "__main__":
    sys.exit(main())
