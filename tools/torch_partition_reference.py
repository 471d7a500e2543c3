#!/usr/bin/env python3
"""The JAX package's partitioned results on tests/golden/example.nex, on the
CPU: the reference numbers chip_smoke.py's phase 12 holds the port to
(PART_TE_LOGL, PART_WINNERS, PART_DEFAULT_LOGL), since the machine with the
card has no JAX.

    python tools/torch_partition_reference.py [--default]

Runs `-s example.phy -p|-q|-Q example.nex -m GTR+G -te ref_tree.nwk` in
float64 and in float32 (about 20-45 s each) and prints each logL; with
--default also the partitioned default command `-p example.nex -B 1000`
(ModelFinder per partition, then the search; about 45 min on an 8-core
CPU) and prints its winners and logL. The JAX package compiles an
executable per shape and never frees one; a long run maps more code
sections than a host's map count allows (64K by default), so the search
here clears JAX's caches every 10 climbs, which changes no result.
Outputs go to a temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
GOLDEN = ROOT / "tests" / "golden"
CLEAR_EVERY = 10     # climbs between two clears of JAX's caches


def logl(prefix: Path) -> float:
    text = Path(f"{prefix}.iqtree").read_text()
    return float(text.split("Log-likelihood of the tree:")[1].split()[0])


def run_default(prefix: str) -> None:
    """The partitioned default command in this process, JAX's caches
    cleared every CLEAR_EVERY climbs."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from iqtree2_tpu import cli
    from iqtree2_tpu.search import search
    real, n = search.TreeSearch._nni_opt, [0]

    def nni_opt(self, t):
        n[0] += 1
        if n[0] % CLEAR_EVERY == 0:
            jax.clear_caches()
        return real(self, t)

    search.TreeSearch._nni_opt = nni_opt
    cli.main(["-s", str(GOLDEN / "example.phy"), "-p",
              str(GOLDEN / "example.nex"), "-B", "1000", "-pre", prefix,
              "-redo", "--quiet"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--default", action="store_true",
                    help="also run the partitioned default command")
    ap.add_argument("--default-prefix", default="",
                    help=argparse.SUPPRESS)   # the subprocess of --default
    args = ap.parse_args()
    if args.default_prefix:
        run_default(args.default_prefix)
        return 0
    # no persistent compile cache: its directory lies outside the checkout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               IQTREE2_TPU_NO_COMPILE_CACHE="1")
    phy, nex = str(GOLDEN / "example.phy"), str(GOLDEN / "example.nex")
    ref = str(GOLDEN / "ref_tree.nwk")
    out: dict = {"te": {}}
    with tempfile.TemporaryDirectory() as d:
        # each run in a process of its own, as a user runs it (--f64
        # switches JAX to 64-bit for the rest of a process)
        for flag in ("-p", "-q", "-Q"):
            got = []
            for prec in (["--f64"], []):
                pre = Path(d) / f"te{flag[1]}{len(prec)}"
                subprocess.run([sys.executable, "-m", "iqtree2_tpu", "-s",
                                phy, flag, nex, "-m", "GTR+G", "-te", ref,
                                "-pre", str(pre), "-redo", "--quiet"]
                               + prec, env=env, check=True)
                got.append(logl(pre))
            out["te"][flag] = got       # (float64, float32)
            print(f"{flag} -te: f64 {got[0]}, f32 {got[1]}", flush=True)
        if args.default:
            pre = Path(d) / "default"
            subprocess.run([sys.executable, __file__, "--default-prefix",
                            str(pre)], env=env, check=True)
            scheme = Path(f"{pre}.best_scheme.nex").read_text()
            line = re.search(r"charpartition \S+ = (.*);", scheme).group(1)
            out["winners"] = {name.strip(): model.strip() for model, name in
                              (e.rsplit(":", 1) for e in line.split(","))}
            out["default_logL"] = logl(pre)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
