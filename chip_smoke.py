#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (iqtree2_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It imports nothing of JAX and, itself, only iqtree2_tpu_torch. Phases, each
ending in torch.cuda.synchronize():

1. the card's name and power limit (nvidia-smi);
2. building the kernels of iqtree2_tpu_torch/csrc/pruning.cu with nvcc, and
   the resident blocks per SM and shared memory per block of each pass
   instance at 16384 patterns (DNA, protein, and 112 and 454 states, the
   wide instance with its columns staged in shared memory and, in
   float64 at 454, read in place; 1, 4 and 10 categories, float32 and
   float64);
3. each kernel against its plain PyTorch version on the same inputs, on a
   simulated 64-taxon x 4096-site problem under GTR+G4, GTR+G8 (more
   categories than the DNA register column holds), LG+G4, and the shapes
   ModelFinder's candidates bring: JC (one category), GTR+I+R3 (unequal
   FreeRate weights and a finite invariant-site term), GTR+R10, LG+I and
   LG+F+R10 (C * S = 200), in float32 and float64 (tolerances in
   iqtree2_tpu_torch/kernelcheck.py; down_pass with its site-logL
   epilogue, up_pass, theta_pass), timed through the wrappers and back to
   back (2 repetitions, cut from 10 for time), with each problem's bounds;
4. the golden run through the CLI, -s tests/golden/example.phy -m GTR+G
   -te tests/golden/ref_tree.nwk, in float64 (logL within 0.5 of the
   reference IQ-TREE's) and float32 (finite, within 10); the launch counts
   of the float64 run are printed: the joint model fit it runs is
   differentiated plain torch and launches no pruning kernel, as the JAX
   package's runs no Pallas kernel;
5. the fixed-topology fit at a realistic size: 1000 taxa x 16384 sites
   simulated under GTR+G4 (seed 1) and fitted through the CLI in float32
   (too large for the joint fit, so the host alternation runs the
   kernels: down passes with the epilogue for each log-likelihood, a down
   pass and a theta pass for each Newton round), with the launch counts
   reset just before and read just after, and one launch required per
   pass; then each kernel against its plain version at that problem's
   shapes, timed alone (buffers built outside the timed region; the
   buffers are timed on their own line, beside each kernel's bound);
6. the flagship, this slice's main path: -s tests/golden/example.phy
   -m GTR+G -bb 1000 through the CLI in float32 at the default search
   settings, launch counts reset just before and read just after; logL at
   least the reference topology's fit - 0.5, .contree, .splits.nex, 1000
   replicate trees in .ufboot, integer supports in .treefile, every kernel
   launched, one down_pass, up_pass or theta_pass launch per pass and one
   epilogue per log-likelihood pass; wall time, iterations, the split of
   the wall and the launches are printed;
   then each kernel against its plain version at the flagship's shapes
   (example.phy in float32 under GTR+G4, at the reference topology and at
   the tree the search returned), with the bounds there;
7. the NNI hill-climb at the realistic width: phase 5's problem, the
   simulating tree moved by 19 random NNIs, search/nni.nni_optimize on the
   card in float32 with the site log-likelihoods; the wall of each fused
   round, the peak device memory (under 40 GiB) and the launches are
   printed, and the final logL must be finite and no lower than the start
   tree's after optimize_branches;
8. the program's default command, -s tests/golden/example.phy -bb 1000
   with no -m (the search's depth cut to DEFAULT_DEPTH), through the CLI
   in float32: ModelFinder (-m MFP) on the parsimony tree, then the search
   with UFBoot under the winner, launch
   counts reset just before and read just after. The winner must be
   TIM2+I+G, the JAX package's on the same file; the .iqtree must hold the
   selection table; the search's files pass phase 6's checks, its logL at
   least the winner's fit on the reference tree (-te, float64) - 0.5; one
   launch per pass. ModelFinder's wall split (screen, refit, +R, final
   refit), its fits by route (the joint fit or the host alternation) and
   the launches during ModelFinder and during the search are printed;
9. model selection at the realistic width: -m TESTONLY -mset HKY,GTR
   -mrate E,G,R -cmax 4 through the CLI on phase 5's alignment in float32.
   Candidates with C <= 3 fit jointly; C = 4 is above the joint fit's
   size guard there, so its fits run the host alternation through the
   kernels: down_pass, its epilogue and theta_pass must launch, once per
   pass, and the winner's base must be GTR (the data are simulated under
   GTR+G4). The wall, the fits by route, the peak device memory and the
   table's top 4 are printed;
10. the branch supports, user-tree tests and per-site outputs through the
   CLI on example.phy in float32 at the default settings, the launch
   counts reset just before each run and read just after: (1) -m GTR+G
   -B 100 (cut from 1000 for time: -bnni's NNI1 round per replicate was
   most of this phase) -alrt 1000 -abayes --tbe -bnni -wsl -wsr -wspr
   -asr --mlrate -mldist -o Frog,Turtle: every file parses, the .treefile labels read
   aLRT/aBayes/UFBoot in range, .state holds 15 x 1998 rows summing to 1,
   the weighted .sitelh sum is the reported logL within 1e-2, the logL
   passes phase 6's bound; (2) -te ref_tree.nwk -z (the reference tree and
   two trees moved by random NNIs) -au -zb 10000: the table ranks the
   reference tree first; (3) -m GTR+G+ASC -te on the alignment's variable
   columns (written to chip_smoke_out/): a finite logL. Each analysis's
   launches are held to what its code asks for: ASR one down_pass and one
   up_pass, the rate posteriors one down_pass, a site logL one epilogue
   pass, the branch tests one down_pass and one up_pass, --mlrate 33
   epilogue passes, -bnni one up_pass per replicate, the tree tests none;
11. the slice at the realistic width, through the functions, in float32:
   ancestral_posteriors (every row sums to 1 within 1e-4),
   site_rate_posterior, tests_branch.test_all_branches(n_rell=1000),
   siterates.site_rates_ml and treetesting.run_tree_tests on phase 5's
   fitted tree and two trees moved by 19 random NNIs, each with its wall,
   launches and peak device memory; then the same functions at 64 x 1024
   (cut from 4096 for time) on the card and on the CPU (the plain versions), in float32 and
   float64, held within 1e-4 relative (the largest difference over the
   largest value); SH-aLRT and aBayes, steps of the float32 logLs, are
   held in float64;
12. the partitioned path, float32 unless stated, launch counts reset just
   before each command line and read just after, one kernel launch per pass
   of each partition (passes counted per partition): (a) the partitioned
   default command, -s example.phy -p example.nex -B 1000 -n 10 (depth
   cut for time) with no -m, so
   ModelFinder runs per partition: each partition's winner the JAX
   package's (PART_WINNERS), .best_scheme.nex, the .iqtree partition table,
   1000 replicate trees, integer supports, logL at least the JAX package's
   (PART_DEFAULT_LOGL) - 0.5; (b) -m GTR+G -te ref_tree.nwk on example.nex
   (each partition under its charpartition model): -q and -Q in float32
   and -p in float32 and float64, each logL held to the JAX package's
   float64 one (PART_TE_LOGL: float64 within 0.01, float32 at least it -
   0.5; the model-parameter objectives run in float64),
   and -S: three per-locus trees and a .partlh; (c) phase 5's 1000 x 16384
   alignment as 16 charsets of 1024 sites, -p -m GTR+FQ+G -te on the
   simulating tree: logL at least the unpartitioned GTR+FQ+G fit's - 1
   (with equal frequencies the partitioned model nests it; GTR+G's
   empirical frequencies differ per partition), every partition rate
   within 5% of 1 and not all at their start, the peak device memory
   and the wall split into model fits, partition rates and branch
   lengths;
   (d) a supermatrix of 10 loci x 1000 sites over 100 taxa, each locus
   simulated under GTR+G4, HKY+G4, TN+I+G4 or K2P+R3 at a rate in 0.25-4
   without a tenth of the taxa, one PHYLIP file per locus, searched with
   -p -m GTR+G -B 1000 -n 2 -ninit 10 -nbest 1 (iterations and start
   trees cut for time) under the charpartition's models: a .terrace
   report, 1000 replicate trees; then each kernel against its plain
   version at the shapes of its smallest partition and of its largest
   (each lacks a tenth of the taxa); (e) the last single-alignment flags
   on example.phy under -m GTR+G, each command line counted and every
   kernel launched: -g with a 4-taxon constraint that the reference
   topology breaks (its split in .treefile), -b 2 (2 trees in .boottrees,
   14 supports, a .contree), --runs 2 (.run1 and .run2, the best printed)
   and --symtest (a .symtest.csv row);
13. the mixture models and PMSF, float32 unless stated, each command line
   under the launch and pass counters (one launch per pass): (a) each
   kernel against its plain version (the plain references window by
   window of patterns, kernelcheck.plain_window) at LG+C20+G4 (C = 80,
   one eigensystem per class) and LG4X (four eigensystems on four
   categories) at 64 x 4096, LG+C60+G4 (C = 240) at 64 x 5400 (4163
   patterns: the unified buffer holds 2.55 x 10^9 values, past 2^31), and
   LG+C20+G4 at 64 x 1024 in float64, with times (1 repetition),
   bounds, shares, occupancy, launches and peak memory; (b) -m LG+C60+G
   --pmsf -te on 100 taxa x 2000 sites
   simulated class by class (kernelcheck.simulate_mixture): the guide
   fit runs the kernels at C = 240, .sitefreq rows sum to 1 within 1e-4,
   the PMSF logL is at least the guide mixture's - 1, peak device memory
   under 70 GiB; (c) -m LG+C20+G -B 1000 -wspm -n 3 -ninit 10 -nbest 2
   (the search's depth cut for time) on 24 x 1000: 1000 replicate trees,
   .siteprob with 20 class columns summing to 1, every kernel launched;
   (d) -m LG+C20+G --pmsf -B 1000 at (c)'s depth on (c)'s alignment:
   the search on the site-specific-frequency engine with NNI1, .sitefreq,
   1000 replicate trees; (e) MIX{LG,WAG}+G fitted (class weights, Gamma
   shape, branch lengths) at 64 x 1024 in float64 on the card, its logL
   within 1e-3 of the same fit on the CPU (the plain versions), which
   runs beside phases 2-13 in a process of its own;
14. the model families of codon data, +E sequencing error, --mdef YAML
   definitions and partitioned mixtures, each command line under the
   launch and pass counters (one launch per pass): (a) each kernel against
   its plain version at 64 x 4096 under GY+F3X4+G4 (61 states: 4096
   codons, float32 and float64), KOSI07+G4, HKY+E+G4 (tip rows that are
   not indicators), JC2+G4 on binary data (2 states) and MK+G4 on a
   7-state --mdef datatype, with times loaded and back to back, bounds,
   shares and occupancy; (b) 100 x 2000 codons simulated under
   GY{2.0,0.3}+F3X4+G{0.8}, -st CODON -m GY+F3X4+G -B 1000 (CODON_DEPTH,
   cut for time): logL at least the -te fit on the simulating tree - 0.5
   (CODON_TE_LOGL, that fit's logL),
   kappa and omega within 15% of 2.0 and 0.3, phase 6's files, every
   kernel launched; (c) -m KOSI07+F+G and MG+F3X4 -te on (b)'s data:
   finite logLs, tree lengths within 2x of (b)'s; (d) phase 5's
   alignment with 1% of its tip states replaced by another base:
   -m GTR+E+G -te fits epsilon in [0.003, 0.03] and a logL above GTR+G's,
   then -m HKY+E+G -B 1000 (ERROR_DEPTH) on example.phy under phase 6's
   checks; (e) --mdef: MYRY+G2 -B 1000 (FAMILY_DEPTH) on 100 x 4096 sites
   of a 2-state RY datatype (phase 6's files),
   and MYGTR+G{0.6} -te on phase 5's alignment in float64 equal to the
   same GTR given in the -m string within 1e-6 relative; (f) a -q
   supermatrix of 50 taxa, an LG+C20+G protein locus (1000 sites, C = 80)
   beside a GTR+G DNA locus (2000 sites): -te in float64 on the card, its
   fitted state evaluated on the CPU within 1e-3, then -B 1000
   (FAMILY_DEPTH);
15. the nonreversible and per-class-length families, each command line
   under the launch and pass counters (one launch per pass): (a) each
   kernel against its plain version at 64 x 4096 under UNREST+G4 (complex
   eigenvalues; float32 and float64), 12.12+G4 (a Lie-Markov model),
   GTR+P+G4 (PoMo, 52 states, tips of k/N sampling weights; float32 and
   float64), GTR+H4 (per-class lengths) and UNREST+G4 rooted (the root
   test's all-unknown __ROOT__ leaf on a zero-length edge), with times
   loaded and back to back, bounds, shares and occupancy; (b) 1000 x 16384
   simulated under UNREST+G4 by expm: one logL, the nonreversible Newton
   (ms per round, peak memory, one launch per pass), an NNI climb of at
   most 3 rounds, and the card's site logLs against the plain path at
   64 x 1024 within kernelcheck.TOLERANCE; (c) example.phy -m UNREST+G
   -B 1000 --root-test (NONREV_DEPTH): logL at least the -te fit's - 0.5
   (UNREST_TE_LOGL), 31 rootings whose rootstrap sums to 1; (d) -m GTR+H4
   -B 1000: the final per-class fit at least the search's logL, the class
   weights summing to 1; (e) -m GTR+P and -m 3.3b+G -te in float64, each
   within 1e-3 of the CPU's logL at the same tree and parameters; (f) -m
   GTR+G+T -te with the golden tree and one NNI from it: EM's logL never
   falling, weights summing to 1; (g) a --mdef model with reversible:
   false against -m UNREST{...} of the same matrix, -te in float64, equal
   within 1e-6 relative.

16. the standalone tools and dating, through the CLI where a flag
   exists: (a) --alisim on tests/golden/ref_tree.nwk under GTR+G, LG+G,
   LG+C10 (each site's class drawn by the weights), mimicking example.phy
   (-s) and with --indel 0.05,0.05, each output read back with the
   tree's taxa, its sites and sequence type; (b) tip dates of a strict
   clock at rate 0.01 on the golden tree rooted at its midpoint, 1998
   sites simulated under GTR+G on it, then -m GTR+G -B 1000 -n 3 -ninit
   10 -ntop 3 -nbest 2 --date --date-ci 100 in float32, launch counts
   reset just before and read just after, one launch per pass, the
   .timetree files parsed, the rate within 25% of 0.01 (0.0091847 on the
   CPU), the failed replicates printed; (c) likelihood mapping of 1000
   quartets of example.phy under a fixed GTR+G4 on a float32 card engine
   (the mapping runs on its float64 view), the weights within 1e-3 of a
   CPU float64 engine's (run beside phases 2-15), regions moved only near
   a boundary; (d) Sankoff parsimony of
   example.phy on the card equal to the host's under a unit and a
   transition/transversion cost matrix; (e) -r 100, -con and -rf_all on
   (b)'s replicate trees, -pd 5 and -bud 4, each file checked.

17. the distributed search and the pattern-sharded likelihood
   (parallel/): (a) dryrun_multichip on phase 5's 1000 x 16384 GTR+G4
   problem in float32, 2 ranks over gloo on the one card and 1 over NCCL:
   the sharded logL, optimize step, RELL and NNI batch against the
   unsharded engine to the JAX dry run's tolerances, one gossip round,
   each rank's launches one per pass, its peak memory and the sharded
   Newton round's ms beside the unsharded one's, then the kernels against
   their plain versions at a rank's shapes (1000 x 8192), with their
   bounds and shares; (b) -m GTR+G -B
   1000 on example.phy, two processes on the card (depth cut to
   DIST_DEPTH), first with --dist-nranks 2 --dist-dir (FileGossip), then
   under torchrun's environment (WORLD_SIZE=2, TorchGossip over gloo;
   beside (c), whose walls it shares), launches reset just before and read just after in each, one per pass,
   both ranks writing the same tree under phase 6's checks; (c) DistributedSearch at 1 rank and at 2 over
   gloo at the flagship's shapes: the same topology, logL within 1e-6
   relative.

18. the kernels' wide instance (S > 64: a node's states split across the
   block's threads): (a) each kernel against its plain version on
   64 x 4096 problems simulated under GTR+G4 and fitted under GTR+P13+G4
   and GTR+P19+G4 (PoMo, 76 and 112 states), float32 and float64, and
   GTR+P23+G4 (136) at 64 x 1024 in float32, with times loaded and back
   to back, bounds, shares, occupancy and one launch per pass; (b) the
   realistic width, 100 x 16384 under GTR+P19+G4 in float32: one logL,
   one nonreversible Newton round (ms, peak memory), NNI5 scores of 8
   candidates (peak memory below 40 GiB), then each kernel against its
   plain version there;
   (c) -s example.phy -m GTR+P19+G4 -B 1000 (depth cut to POMO_DEPTH),
   launches reset just before and read just after, one per pass, phase
   6's files, logL at least the -te fit's (POMO_TE_LOGL) - 0.5, then the
   kernels against their plain versions at its shapes (untimed); (d) -m
   GTR+P19+G4 -te in float64, its fitted state evaluated on the CPU within
   1e-3; (e) a 65-state --mdef datatype, 100 x 12288 under MK+G -te, whose
   host alternation runs theta_pass (PoMo's nonreversible Newton does
   not), then the kernels against their plain versions there (untimed)
   with their bounds.

A "[time]" line gives the start of each phase and the end of phase 18.
Phase 9 runs in a process of its own beside phases 10 and 11, and 12a
beside 12b-e (start_part; their lines print when they are joined, after
11 and after 12e): each is host-paced, and the script's wall must stay
inside its limit on slow hosts. The walls of phases 9-12 are therefore
taken with two processes sharing the card and the host. After phase 13
the parts that time the device run first (14a, 15a-b, 17a, 18a-b), then
14b-e and 14f in two processes of their own beside 15c-g, 16, 17b-c and
18c-e (their lines print at the end), whose walls share the card and the
host likewise: three processes.

Outputs go to chip_smoke_out/. Any failure exits non-zero. Before the
last line it prints one JSON object {"kernels": [...]} (launches from the
phase-8 default command, the program's main path, slice_launches
from phase 10's first command line, the supports' path,
partition_launches from phase 12's partitioned default command and
mixture_launches from phase 13c's mixture search,
model_family_launches from phase 14b-f's command lines, nonrev_launches
from phase 15c's UNREST search with the root test, dating_launches from
phase 16b's search with --date, distributed_launches summed over 17b's
two ranks on both routes; times,
back-to-back times
and bounds (kernelcheck.bounds) from the phase-5 check at 1000 x 16384;
then one entry per kernel for its wide instance, "down_pass (S > 64)"
and so on, with launches summed over 18c and 18e and times, errors and
bounds from phase 18b at 100 x 16384; no single PyTorch call computes a
pruning pass, so library_ms is null); the last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
OUT = ROOT / "chip_smoke_out"
SOURCE = "iqtree2_tpu_torch/csrc/pruning.cu"
# TPU kernels each Hopper kernel replaces (file:line of the pl.pallas_call)
REPLACES = {
    "down_pass": "iqtree2_tpu/ops/pallas_pruning2.py:342, "
                 "iqtree2_tpu/ops/pallas_pruning.py:224, "
                 "iqtree2_tpu/ops/pallas_pruning.py:452",
    "up_pass": "iqtree2_tpu/ops/pallas_pruning2.py:567, "
               "iqtree2_tpu/ops/pallas_pruning.py:372",
    "theta_pass": "iqtree2_tpu/ops/pallas_pruning2.py:804",
}
# the kernels of the standalone launches the passes absorbed
GONE = ("root_sitelp", "edge_theta")
CHECK_TAXA, CHECK_SITES = 64, 4096
# phase 3's timing repetitions, cut from 10, then 3, for the script's time
CHECK_REPS = 2
# phase 3's problems: the search's models, then ModelFinder's shapes
CHECK_MODELS = ("GTR+G4", "GTR+G8", "LG+G4", "JC", "GTR+I+R3", "GTR+R10",
                "LG+I", "LG+F+R10")
BIG_TAXA, BIG_SITES = 1000, 16384
FLAGSHIP_REPLICATES = 1000
MAX_CLIMB_GIB = 40.0
# the JAX package's ModelFinder winner on example.phy (BIC), run on the CPU
DEFAULT_WINNER = "TIM2+I+G"
# phase 8's search depth after ModelFinder, cut from the default (200
# iterations) for the script's room on slow hosts: at -n 10 the port on
# the CPU reaches the default depth's logL, -21152.4834
DEFAULT_DEPTH = ["-n", "10"]
WIDE_SELECTION = ["-m", "TESTONLY", "-mset", "HKY,GTR", "-mrate", "E,G,R",
                  "-cmax", "4"]
# phase 10's first command line: every support and per-site output
# phase 10's -B, cut from 1000 for the script's time: -bnni runs one NNI1
# round per replicate, at 1000 most of phase 10's wall
SUPPORT_REPLICATES = 100
SUPPORT_FLAGS = ["-m", "GTR+G", "-B", str(SUPPORT_REPLICATES), "-alrt",
                 "1000", "-abayes", "--tbe", "-bnni", "-wsl", "-wsr", "-wspr",
                 "-asr", "--mlrate", "-mldist", "-o", "Frog,Turtle"]
ML_RATE_GRID = 33          # siterates.site_rates_ml's rate grid
# phase 11: card against the plain versions at 64 x SLICE_SITES (cut from
# CHECK_SITES for the script's time), and ASR rows summing to 1
SLICE_SITES = 1024
SLICE_TOL = 1e-4
SUPPORT_KEYS = ("SH-aLRT / 100", "aBayes")   # held in float64 only
# phase 12: the JAX package's results on example.nex, on the CPU: the
# per-partition ModelFinder winners (BIC) and the logL of the partitioned
# default command (float32, -B 1000), and the -m GTR+G -te ref_tree.nwk
# logLs (float64, float32) of each linkage
PART_WINNERS = {"part1": "TIM2+G", "part2": "TIM2+G", "part3": "TIM2+I+G"}
PART_DEFAULT_LOGL = -21145.4121
PART_TE_LOGL = {"-p": (-21784.3628, -21793.6152),
                "-q": (-21812.1665, -21816.2031),
                "-Q": (-21723.8209, -21731.1389)}
WIDE_CHARSETS = 16          # 12c: charsets of BIG_SITES / 16 sites
# 12c's model: equal frequencies, so that the partitioned model nests the
# unpartitioned one (empirical frequencies differ per partition)
WIDE_MODEL = "GTR+FQ+G"
MAX_RATE_DEV = 0.05         # 12c: every locus has the same rate
# 12d: the loci's simulating models (every parameter fixed) and the model
# the charpartition names for each
# (LOCI cut from 20 for phase 17's room)
LOCI, LOCUS_SITES, LOCUS_TAXA, LOCUS_GAPS = 10, 1000, 100, 0.1
# 12d's search depth, cut from the defaults (-ninit 100, -nbest 5) for the
# script's time: each NNI polish of a start tree takes about 13 s there;
# cut from -n 10 -ninit 20 -nbest 2 for phase 13, then from -n 5 and -ntop
# 20 (10 start trees polished, 29 s) for phase 14, then from -n 3 for
# phase 15
LOCUS_DEPTH = ["-n", "2", "-ninit", "10", "-ntop", "2", "-nbest", "1"]
# 12a's search depth, cut from the default (about 100 iterations, 44.8 s
# of its wall) for phase 15: at -n 10 it reaches the same logL,
# -21141.4985, on the CPU
PART_DEFAULT_DEPTH = ["-n", "10"]
LOCUS_MODELS = (
    ("GTR+G", "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+G{0.6}"),
    ("HKY+G", "HKY{3.0}+F{0.25,0.25,0.2,0.3}+G{0.8}"),
    ("TN+I+G", "TN{2.0,4.0}+F{0.3,0.2,0.3,0.2}+I{0.2}+G{0.7}"),
    ("K2P+R3", "K2P{2.5}+R3{0.2,0.3,0.5,1.0,0.3,2.2}"))
# 12e: a 4-taxon constraint that the reference topology breaks (there
# Frog,Turtle | Human,Mouse), and the standard bootstrap's replicates
CONSTRAINT = "((Frog,Human),(Turtle,Mouse));"
STANDARD_REPLICATES = 2     # 12e's -b, cut from 5, then 3
# phase 13: the mixture problems of the kernel checks (kernelcheck.MODELS
# name, sites, dtype) at CHECK_TAXA taxa; LG+C60+G4's 5400 sites give 4163
# patterns, so its unified buffer holds 126 x 4800 x 4224 values, past 2^31
MIX_CHECKS = (("LG+C20+G4", CHECK_SITES, "float32"),
              ("LG+C60+G4", 5400, "float32"),
              ("LG+C20+G4", SLICE_SITES, "float64"),
              ("LG4X", CHECK_SITES, "float32"))
# 13a's timing repetitions, cut from 2: a pass takes up to 250 ms there
MIX_TIME_REPS = 1
PMSF_TAXA, PMSF_SITES = 100, 2000      # 13b: the guide fit at C = 240
MAX_PMSF_GIB = 70.0
MIX_TAXA, MIX_SITES = 24, 1000         # 13c and 13d
MIX_REPLICATES = 1000
# 13c's and 13d's search depth, cut for the script's time from the
# defaults (about 100 iterations, -ninit 100 -nbest 5): an iteration took
# 1.2-1.3 s there; cut from -n 5 -ninit 20 -ntop 20 for phase 14
MIX_DEPTH = ["-n", "3", "-ninit", "10", "-ntop", "3", "-nbest", "2"]
WEIGHT_TAXA, WEIGHT_SITES = 64, 1024   # 13e: MIX{LG,WAG}+G's weights
WEIGHT_TOL = 1e-3                      # 13e: card against the CPU, float64
# phase 14: the kernel checks of the model families (kernelcheck.MODELS
# name, dtype) at CHECK_TAXA x CHECK_SITES, codons in both precisions
FAMILY_CHECKS = (("GY+F3X4+G4", "float32"), ("GY+F3X4+G4", "float64"),
                 ("KOSI07+G4", "float32"), ("HKY+E+G4", "float32"),
                 ("JC2+G4", "float32"), ("MK7+G4", "float32"))
FAMILY_TIME_REPS, FAMILY_B2B_REPS = 1, 3
CODON_TAXA, CODON_SITES = 100, 2000    # 14b: 6 kb of coding sequence
CODON_TRUE = (2.0, 0.3)                # GY{2.0,0.3}: kappa, omega
# the -te fits whose logL less 0.5 bounds 14b's and 14d's searches, as the
# reference fit bounds phase 6's: -st CODON -m GY+F3X4+G -te on 14b's
# simulation (seed 4) and -m HKY+E+G -te ref_tree.nwk on example.phy, both
# float32, as this script measured them on an H100 80GB HBM3 (every run
# the same)
CODON_TE_LOGL = -100709.2812
HKY_E_TE_LOGL = -21499.8633
PARAM_TOL = 0.15                       # 14b: relative
# the searches' depth, cut for the script's time from the defaults (about
# 100 iterations, -ninit 100 -ntop 20 -nbest 5): 14b's (at -n 5 -ninit 20
# -ntop 5 it took 33 s, at -n 3 -ninit 10 -ntop 3 26 s), and 14e's and
# 14f's (14f's took 103 s and 78 s at those depths: 9 s an iteration)
CODON_DEPTH = ["-n", "2", "-ninit", "5", "-ntop", "2", "-nbest", "2"]
FAMILY_DEPTH = ["-n", "1", "-ninit", "3", "-ntop", "1", "-nbest", "1"]
ERROR_SHARE = 0.01                     # 14d: tip states replaced
ERROR_RANGE = (0.003, 0.03)            # 14d: the fitted epsilon
# 14d's search of example.phy, cut from the defaults (24 s of iterations),
# then from -n 10 -ninit 20 -ntop 5 for the script's room on slow hosts
# (the port on the CPU reaches -21497.0352 at this depth, above the bound)
ERROR_DEPTH = ["-n", "3", "-ninit", "10", "-ntop", "3", "-nbest", "2"]
RY_TAXA, RY_SITES = 100, 4096          # 14e
MDEF_TOL = 1e-6                        # 14e: relative, float64
MDEF_YAML = """\
# phase 14e's --mdef file: a 2-state datatype and two models
- datatype: RY
  state: [R, Y]
  missing: "?-"
- model: MYRY
  datatype: RY
  rates: [1.0]
  frequencies: [0.6, 0.4]
- model: MYGTR
  datatype: DNA
  rates: [1.5, 4.0, 1.2, 0.8, 5.0, 1.0]
  frequencies: [0.3, 0.2, 0.2, 0.3]
"""
MDEF_GTR = "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+G{0.6}"
# 14f: the supermatrix's loci (sequence type, simulating model, sites) and
# the models its charpartition names (taxa cut from 100 for phase 18's
# room: -te, its CPU evaluation and -B took 19.8, 13.5 and 48.4 s there)
PMIX_TAXA = 50
PMIX_LOCI = (("AA", "LG+C20+G{0.6}", 1000),
             ("DNA", "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+G{0.6}",
              2000))
PMIX_MODELS = ["LG+C20+G", "GTR+G"]
PMIX_TOL = 1e-3                        # 14f: card against the CPU, float64
# phase 15: the nonreversible and per-class-length families. 15a's kernel
# checks (kernelcheck.MODELS name, dtype) at CHECK_TAXA x CHECK_SITES: UNREST
# and 12.12 with complex eigenvalues, PoMo's 52 states, +H's per-class
# lengths, and the root test's __ROOT__ pseudo-taxon
NONREV_CHECKS = (("UNREST+G4", "float32"), ("UNREST+G4", "float64"),
                 ("12.12+G4", "float32"), ("GTR+P+G4", "float32"),
                 ("GTR+P+G4", "float64"), ("GTR+H4", "float32"),
                 ("UNREST+G4 rooted", "float32"))
NONREV_ROUNDS = 4                      # 15b: nonreversible Newton rounds
NONREV_CLIMB_ROUNDS = 3                # 15b: NNI rounds of the climb
NONREV_CUT_SITES = 1024                # 15b: the card against the plain path
# the -te fit whose logL less 0.5 bounds 15c's search, as the reference
# fit bounds phase 6's: -m UNREST+G -te ref_tree.nwk on example.phy in
# float32, as this script measured it on an H100 80GB HBM3
UNREST_TE_LOGL = -21150.2891
# 15c's and 15d's search depth, cut from the defaults for the script's time
NONREV_DEPTH = ["-n", "3", "-ninit", "10", "-ntop", "3", "-nbest", "2"]
ROOTTEST_ROWS = 2 * 17 - 3             # 15c: every branch of example.phy's
CARD_CPU_TOL = 1e-3                    # 15e: card against the CPU, float64
MDEF_NONREV_TOL = 1e-6                 # 15g: relative, float64
MDEF_NONREV_MATRIX = ((0, 1.5, 3.0, 0.6), (0.9, 0, 1.1, 2.8),
                      (2.5, 0.7, 0, 1.3), (0.8, 3.3, 1.2, 0))
# phase 16: the standalone tools and dating. 16a's AliSim runs on the
# golden tree: (name, flags, suffix, sequence type, sites; None where
# indels make it vary)
ALISIM_CASES = (
    ("GTR+G", ["-m", "GTR+G", "--length", "1998"], ".phy", "DNA", 1998),
    ("LG+G", ["-m", "LG+G", "--length", "600"], ".phy", "AA", 600),
    ("LG+C10", ["-m", "LG+C10", "--length", "600"], ".phy", "AA", 600),
    ("mimic", ["-m", "GTR+G", "-s", str(GOLDEN / "example.phy")], ".phy",
     "DNA", 1998),
    ("indel", ["-m", "GTR+G", "--length", "600", "--indel", "0.05,0.05"],
     ".fa", "DNA", None))
DATE_RATE = 0.01           # 16b: the strict clock of the tip dates
DATE_RATE_TOL = 0.25       # 16b: relative; the CPU run gives 0.0091847465
DATE_CI_REPS = 100
DATE_DEPTH = ["-n", "3", "-ninit", "10", "-ntop", "3", "-nbest", "2"]
LMAP_QUARTETS = 1000       # 16c
LMAP_TOL = 1e-3            # 16c: card float32 against the CPU's float64
SANKOFF_COSTS = {          # 16d
    "unit": ((0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1), (1, 1, 1, 0)),
    "ts/tv": ((0, 2, 1, 2), (2, 0, 2, 1), (1, 2, 0, 2), (2, 1, 2, 0))}
RANDOM_TAXA, RF_TREES, PD_K, PD_BUDGET = 100, 100, 5, 4   # 16e
# phase 17: one rank's launches in 17a's sharded checks, one per pass
DRYRUN_LAUNCHES = {
    "loglik": {"down_pass": 1, "sitelp": 1, "up_pass": 0, "theta_pass": 0},
    "step": {"down_pass": 2, "sitelp": 1, "up_pass": 0, "theta_pass": 1},
    "nni passes": {"down_pass": 1, "sitelp": 0, "up_pass": 1,
                   "theta_pass": 0}}
# 17a's back-to-back timing repetitions at a rank's slice (kernelcheck's
# default of 50 takes seconds at 1000 x 8192)
SLICE_B2B_REPS = 10
# 17b's depth, cut from the default -n 100 -ninit 100 for the phase's time
DIST_DEPTH = ["-n", "12", "-ninit", "20"]
# 17c: DistributedSearch's settings, and its 1- and 2-rank logLs' bound
DIST_SEARCH = dict(seed=1, n_init_trees=10, n_rounds=2, round_size=4)
DIST_SEARCH_REL = 1e-6
# phase 18: the kernels' wide instance (S > 64). 18a's kernel checks
# (kernelcheck.MODELS name, dtype, sites) at CHECK_TAXA taxa: PoMo at N =
# 13 and 19 (76 and 112 states) and, at SLICE_SITES for the phase's time,
# N = 23 (136)
WIDE_CHECKS = (("GTR+P13+G4", "float32", CHECK_SITES),
               ("GTR+P13+G4", "float64", CHECK_SITES),
               ("GTR+P19+G4", "float32", CHECK_SITES),
               ("GTR+P19+G4", "float64", CHECK_SITES),
               ("GTR+P23+G4", "float32", SLICE_SITES))
POMO_CHECK = "GTR+P19+G4"              # 18b's fixed parameters
POMO_TAXA, POMO_SITES = 100, 16384     # 18b
# 18b's NNI5 candidates, cut from all 97 for the phase's time (a chunk of
# candidates holds what any chunk of a whole round holds)
POMO_NNI_CANDIDATES = 8
POMO_MODEL = "GTR+P19+G4"              # 18c's and 18d's -m
# the -te fit whose logL less 0.5 bounds 18c's search, as the reference
# fit bounds phase 6's: -m GTR+P19+G4 -te ref_tree.nwk on example.phy in
# float32, as this script measured it on an H100 80GB HBM3
POMO_TE_LOGL = -21809.3438
# 18c's search depth, cut from the defaults for the phase's time: at the
# defaults the iterations took 171 s (logL -21809.2734), at this depth
# 1.5 s (-21809.4043); at -n 2 -ninit 5 -ntop 2 the search ended below
# the bound (-21809.957)
POMO_DEPTH = ["-n", "3", "-ninit", "10", "-ntop", "3", "-nbest", "2"]
# 18e: a 65-state --mdef datatype under MK+G, -te at a size past the joint
# fit's guard (torchfit.MAX_REVERSE_ELEMENTS: 98 x 4 x 65 x 10496 padded
# patterns), so that the host alternation's Newton runs theta_pass; at
# 8192 sites (6929 patterns) the joint fit took it, launching no kernel
MDEF_WIDE_TAXA, MDEF_WIDE_SITES = 100, 12288
# start_part's process: this script's function on JSON arguments
PART_RUN = ("import json, sys, chip_smoke as cs; print('RESULT ' + "
            "json.dumps(getattr(cs, sys.argv[1])(*json.loads(sys.argv[2]))))")
PART_TIMEOUT = 900          # seconds a start_part process may take


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def report_logl(prefix: Path) -> float:
    for line in Path(f"{prefix}.iqtree").read_text().splitlines():
        if line.startswith("Log-likelihood of the tree:"):
            return float(line.split(":")[1].split()[0])
    raise RuntimeError(f"no logL in {prefix}.iqtree")


def log_lines(prefix: Path) -> str:
    return Path(f"{prefix}.log").read_text()


def check_flagship(prefix: Path, bound: float) -> float:
    """Phase 6's output checks; returns the logL."""
    logl = report_logl(prefix)
    if not logl >= bound:
        raise RuntimeError(f"flagship logL {logl} below {bound}")
    for ext in (".contree", ".splits.nex", ".ufboot", ".treefile"):
        if not Path(f"{prefix}{ext}").stat().st_size:
            raise RuntimeError(f"flagship {ext} is empty")
    n_boot = len(Path(f"{prefix}.ufboot").read_text().splitlines())
    if n_boot != FLAGSHIP_REPLICATES:
        raise RuntimeError(f".ufboot holds {n_boot} trees, not "
                           f"{FLAGSHIP_REPLICATES}")
    labels = re.findall(r"\)([^:,();]*)", Path(f"{prefix}.treefile")
                        .read_text())
    if not labels or not all(lab.isdigit() for lab in labels[:-1]):
        raise RuntimeError(f"support labels are not integers: {labels}")
    return logl


def check_supports(prefix: Path, bound: float) -> float:
    """Phase 10's checks of the first command line's files; returns the
    logL."""
    import numpy as np
    logl = report_logl(prefix)
    if not logl >= bound:
        raise RuntimeError(f"logL {logl} below {bound}")
    text = {ext: Path(f"{prefix}{ext}").read_text()
            for ext in (".contree", ".splits.nex", ".ufboot", ".treefile",
                        ".sitelh", ".rate", ".siteprob", ".state", ".mlrate",
                        ".mldist")}
    empty = [ext for ext, t in text.items() if not t.strip()]
    if empty:
        raise RuntimeError(f"empty outputs {empty}")
    if len(text[".ufboot"].splitlines()) != SUPPORT_REPLICATES:
        raise RuntimeError(".ufboot does not hold every replicate tree")
    labels = re.findall(r"\)([^:,();]+)", text[".treefile"])
    if len(labels) != 14:
        raise RuntimeError(f"{len(labels)} support labels, not 14")
    for lab in labels:
        sh, ab, uf = lab.split("/")
        if not (0 <= float(sh) <= 100 and 0 <= float(ab) <= 1
                and uf.isdigit() and int(uf) <= 100):
            raise RuntimeError(f"support label {lab} is not aLRT/aBayes/"
                               f"UFBoot in range")
    head, row = text[".sitelh"].splitlines()
    n_sites = int(head.split()[1])
    lh = np.array(row.split()[1:], float)
    if len(lh) != n_sites or not abs(lh.sum() - logl) <= 1e-2:
        raise RuntimeError(f".sitelh sums to {lh.sum()}, logL {logl}")

    def table(ext, skip):
        return np.array([ln.split("\t")[3 if ext == ".state" else 1:]
                         for ln in text[ext].splitlines()[skip:]], float)

    state, prob = table(".state", 2), table(".siteprob", 1)
    rate, mlrate = table(".rate", 2), table(".mlrate", 2)
    if state.shape != (15 * n_sites, 4) or prob.shape != (n_sites, 4):
        raise RuntimeError(f".state {state.shape}, .siteprob {prob.shape}")
    for name, t in ((".state", state), (".siteprob", prob)):
        if not np.abs(t.sum(1) - 1.0).max() <= 1e-4:
            raise RuntimeError(f"{name} rows do not sum to 1")
    if not (len(rate) == len(mlrate) == n_sites and (mlrate > 0).all()
            and np.isfinite(rate).all()):
        raise RuntimeError(".rate / .mlrate do not hold every site")
    rows = text[".mldist"].splitlines()
    D = np.array([r.split()[1:] for r in rows[1:]], float)
    if not (int(rows[0]) == 17 and D.shape == (17, 17)
            and np.abs(D - D.T).max() <= 1e-6 and (np.diag(D) == 0).all()):
        raise RuntimeError(".mldist is not a symmetric 17 x 17 matrix")
    return logl


SLICE_WANT = {"asr": (1, 0, 1, 0), "site rates": (1, 0, 0, 0),
              "nni scores": (1, 0, 1, 0), "branch tests": (1, 0, 1, 0),
              "mlrate": (ML_RATE_GRID, ML_RATE_GRID, 0, 0)}


def run_slice(eng, tree, tag: str, report: bool = False) -> dict:
    """Phase 11: the slice's functions on one engine and tree (the tree
    tests on it and two copies moved by 19 random NNIs). On the card each
    call's launches are held to SLICE_WANT (the tree tests: no up_pass);
    with report, each call's wall, launches and peak device memory are
    printed."""
    import numpy as np
    import torch
    from iqtree2_tpu_torch import kernelcheck, siterates, tests_branch
    from iqtree2_tpu_torch import treetesting
    from iqtree2_tpu_torch.ops import kernels
    from iqtree2_tpu_torch.ops.nni import build_nni_candidates
    from iqtree2_tpu_torch.params import Params
    from iqtree2_tpu_torch.tree.schedule import build_schedule
    cuda = eng.device.type == "cuda"
    trees = [tree] + [kernelcheck.perturbed(tree, seed=s, strength=0.02)[0]
                      for s in (2, 3)]
    sched = build_schedule(tree)
    c = build_nni_candidates(tree, sched)
    cand = np.stack([c.iu, c.iv, c.slot_c, c.edge_id])
    calls = {
        "asr": lambda: eng.ancestral_posteriors(tree)[0],
        "site rates": lambda: eng.site_rate_posterior(tree),
        "branch tests": lambda: tests_branch.test_all_branches(
            eng, tree, n_rell=1000, rng=np.random.default_rng(1),
            do_abayes=True),
        "mlrate": lambda: siterates.site_rates_ml(eng, tree),
        "tree tests": lambda: treetesting.run_tree_tests(
            eng, trees, Params(topo_test_replicates=1000, do_au_test=True),
            log=lambda s: None)[0].logL}
    if not report:
        calls["nni scores"] = lambda: eng.evaluate_nni_batch(
            sched, cand, return_site_lp=True)
    out = {}
    for name, fn in calls.items():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out[name] = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = tuple(kernels.LAUNCHES[k] for k in CallLaunches.KEYS)
        if cuda and not (got == SLICE_WANT[name] if name in SLICE_WANT
                         else got[2] == 0 and got[1] >= len(trees)):
            raise RuntimeError(f"{tag} {name} launched (down, sitelp, up, "
                               f"theta) {got}")
        if report:
            print(f"{tag} {name}: {wall:.3f} s; launches (down, sitelp, "
                  f"up, theta) {got}; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  flush=True)
    return out


def slice_errors(card: dict, plain: dict) -> dict:
    """Phase 11's differences of the card's results from the plain
    versions': the largest difference over the largest value per array;
    the supports (rounded as written) as the largest difference in SH-aLRT
    points / 100 and in aBayes; the ML rates as the share of patterns off
    by more than SLICE_TOL relative (a near-flat pattern may pick the
    neighbouring grid point)."""
    import numpy as np

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    br, pbr = card["branch tests"], plain["branch tests"]
    if br.keys() != pbr.keys():
        raise RuntimeError("the branch tests cover other branches")
    r, pr = card["mlrate"][0], plain["mlrate"][0]
    return {
        "asr": rel(card["asr"], plain["asr"]),
        "rate posterior": rel(card["site rates"][1], plain["site rates"][1]),
        "mean rate": rel(card["site rates"][0], plain["site rates"][0]),
        "nni logL": rel(card["nni scores"][0], plain["nni scores"][0]),
        "nni length": rel(card["nni scores"][1], plain["nni scores"][1]),
        "nni site logL": rel(card["nni scores"][2], plain["nni scores"][2]),
        "SH-aLRT / 100": max(abs(br[k][0] - pbr[k][0]) for k in br) / 100,
        "aBayes": max(abs(br[k][1] - pbr[k][1]) for k in br),
        "mlrate lp": rel(card["mlrate"][1], plain["mlrate"][1]),
        "mlrate share off": float(np.mean(np.abs(r - pr)
                                          > SLICE_TOL * np.abs(pr))),
        "tree logL": rel(card["tree tests"], plain["tree tests"])}


def climb(eng, tree, rounds: list) -> tuple:
    """search/nni.nni_optimize with want_lp, each fused round timed on the
    host (its results come back to the host, which waits for the card)."""
    import torch
    from iqtree2_tpu_torch.search.nni import nni_optimize
    fused = eng.optimize_and_evaluate_nnis

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = fused(*args, **kw)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
        return out

    eng.optimize_and_evaluate_nnis = timed
    try:
        return nni_optimize(eng, tree, want_lp=True)
    finally:
        del eng.optimize_and_evaluate_nnis


class PassCount:
    """Counts the calls of ops/pruning.down_pass, up_pass and theta_pass
    while active, and the down passes asked for site log-likelihoods
    (sitelp), so a run can show one kernel launch per pass and one
    epilogue per log-likelihood pass."""

    PASSES = ("down_pass", "up_pass", "theta_pass")

    def __enter__(self):
        from iqtree2_tpu_torch.ops import pruning
        self.calls = {"down_pass": 0, "sitelp": 0, "up_pass": 0,
                      "theta_pass": 0}
        # passes per tip-partial tensor: one per engine, so one per
        # partition of a partitioned run
        self.by_tips: dict = {}
        self._saved = {k: getattr(pruning, k) for k in self.PASSES}

        def counted(name):
            def call(*args, **kw):
                self.calls[name] += 1
                tips = args[1 if name == "down_pass" else 2]
                key = (tuple(tips.shape), tips.data_ptr())
                self.by_tips[key] = self.by_tips.get(key, 0) + 1
                if name == "down_pass" and kw.get("pack") is not None:
                    self.calls["sitelp"] += 1
                return self._saved[name](*args, **kw)
            return call

        for k in self.PASSES:
            setattr(pruning, k, counted(k))
        return self

    def __exit__(self, *exc):
        from iqtree2_tpu_torch.ops import pruning
        for k, fn in self._saved.items():
            setattr(pruning, k, fn)

    def check(self, launches: dict, tag: str) -> None:
        gone = sorted(set(GONE) & set(launches))
        if gone:
            raise RuntimeError(f"{tag}: standalone kernels {gone} counted")
        for k, n in self.calls.items():
            if launches[k] != n:
                raise RuntimeError(f"{tag}: {launches[k]} {k} launches for "
                                   f"{n} passes, not one per pass")


class ModelFinderSpy:
    """While active, wraps analysis.run_modelfinder: keeps its result, the
    kernel launches during it, and the route of each candidate fit
    (torchfit.try_fit returning a logL: the joint fit; None: the host
    alternation, whose passes run the kernels)."""

    def __enter__(self):
        import torch
        from iqtree2_tpu_torch import analysis
        from iqtree2_tpu_torch.model import torchfit
        from iqtree2_tpu_torch.ops import kernels
        self.routes = {"joint fit": 0, "alternation": 0}
        self.result, self.launches = None, {}
        self._mf, self._fit = analysis.run_modelfinder, torchfit.try_fit

        def fit(*args, **kw):
            out = self._fit(*args, **kw)
            self.routes["alternation" if out is None else "joint fit"] += 1
            return out

        def mf(*args, **kw):
            before = dict(kernels.LAUNCHES)
            torchfit.try_fit = fit
            try:
                self.result = self._mf(*args, **kw)
            finally:
                torchfit.try_fit = self._fit
            torch.cuda.synchronize()
            self.launches = {k: kernels.LAUNCHES[k] - before[k]
                             for k in before}
            return self.result

        analysis.run_modelfinder = mf
        return self

    def __exit__(self, *exc):
        from iqtree2_tpu_torch import analysis
        analysis.run_modelfinder = self._mf


class CallLaunches:
    """While active, wraps the slice's analyses (ASR, the rate-category
    posteriors, a site logL, the branch tests, --mlrate, the tree tests,
    -bnni) and keeps the launches made during each call, as (down_pass,
    sitelp, up_pass, theta_pass)."""

    KEYS = ("down_pass", "sitelp", "up_pass", "theta_pass")

    def __enter__(self):
        from iqtree2_tpu_torch import analysis, tests_branch
        from iqtree2_tpu_torch.engine import LikelihoodEngine
        from iqtree2_tpu_torch.ops import kernels
        from iqtree2_tpu_torch.search.ufboot import UFBoot
        self.calls: dict = {}
        self._saved = []
        for owner, attr, label in (
                (LikelihoodEngine, "ancestral_posteriors", "asr"),
                (LikelihoodEngine, "site_rate_posterior", "site rates"),
                (LikelihoodEngine, "site_lp", "site logL"),
                (tests_branch, "test_all_branches", "branch tests"),
                (analysis, "site_rates_ml", "mlrate"),
                (analysis, "run_tree_tests", "tree tests"),
                (UFBoot, "refine_boot_trees", "bnni")):
            fn = getattr(owner, attr)

            def call(*args, _fn=fn, _label=label, **kw):
                before = dict(kernels.LAUNCHES)
                out = _fn(*args, **kw)
                self.calls.setdefault(_label, []).append(tuple(
                    kernels.LAUNCHES[k] - before[k] for k in self.KEYS))
                return out

            self._saved.append((owner, attr, fn))
            setattr(owner, attr, call)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)

    def check(self, want: dict, tag: str) -> None:
        """want: label -> the launches of every call, or a predicate on
        them."""
        for label, w in want.items():
            got = self.calls.get(label)
            if not got:
                raise RuntimeError(f"{tag}: {label} never ran")
            for g in got:
                if not (w(g) if callable(w) else g == w):
                    raise RuntimeError(f"{tag}: {label} launched (down, "
                                       f"sitelp, up, theta) {g}")


class FitSplit:
    """While active, times the parts of partition/optimize's alternation,
    each ending in a device synchronize: the per-partition model fits, the
    partition rates and the branch lengths (seconds)."""

    def __enter__(self):
        import torch
        from iqtree2_tpu_torch.partition import optimize
        from iqtree2_tpu_torch.partition.engine import PartitionEngine
        self.seconds = {"model fits": 0.0, "part rates": 0.0,
                        "branch lengths": 0.0}
        self._saved = []
        for owner, attr, label in (
                (optimize, "_fit_one_partition", "model fits"),
                (PartitionEngine, "optimize_part_rates", "part rates"),
                (PartitionEngine, "optimize_branches", "branch lengths")):
            fn = getattr(owner, attr)

            def call(*args, _fn=fn, _label=label, **kw):
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds[_label] += time.perf_counter() - t0
                return out

            self._saved.append((owner, attr, fn))
            setattr(owner, attr, call)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)


def scheme_models(prefix: Path) -> dict:
    """partition name -> model of a .best_scheme.nex."""
    text = Path(f"{prefix}.best_scheme.nex").read_text()
    line = re.search(r"charpartition \S+ = (.*);", text).group(1)
    return {name.strip(): model.strip() for model, name in
            (entry.rsplit(":", 1) for entry in line.split(","))}


def partition_rates(prefix: Path) -> list[float]:
    """The Rate column of the .iqtree's PARTITION TABLE."""
    table = Path(f"{prefix}.iqtree").read_text().split(
        "PARTITION TABLE")[1].split("\n\n")[0]
    return [float(row.split()[-1]) for row in table.splitlines()[3:]]


def counted(args: list[str], tag: str, split: bool = False,
            runner=None) -> dict:
    """Phase 12's, 13's and 14's run of one command line (through
    ``runner``, run_cli where None): the launch counts reset just before
    and read just after, held to one launch per pass; prints the wall, the
    launches, the passes per partition (per tip-partial tensor, one per
    partition engine), the peak device memory and with split the partition
    fit's wall split. Returns the launches."""
    import torch
    from iqtree2_tpu_torch.ops import kernels
    torch.cuda.reset_peak_memory_stats()
    with PassCount() as passes, FitSplit() as fits:
        kernels.reset_launch_counts()
        wall = (runner or run_cli)(args)
        launches = dict(kernels.LAUNCHES)
    passes.check(launches, tag)
    print(f"{tag} {' '.join(args[-12:])}: {wall:.1f} s; launches "
          f"{launches}; passes per partition (tips shape: passes) "
          f"{ {k[0]: n for k, n in passes.by_tips.items()} }; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
          + (f"; fit split (s) {fits.seconds}" if split else ""),
          flush=True)
    return launches


def wide_selection(aln_path: str) -> dict:
    """Phase 9: WIDE_SELECTION through the CLI on phase 5's alignment,
    launches reset just before and read just after, one per pass; raises
    unless it picks a GTR model by both fit routes."""
    import torch
    from iqtree2_tpu_torch.ops import kernels
    wide = OUT / "wide"
    torch.cuda.reset_peak_memory_stats()
    with PassCount() as passes, ModelFinderSpy() as spy:
        kernels.reset_launch_counts()
        wall = run_cli(["-s", aln_path] + WIDE_SELECTION + ["-pre", str(wide)])
        launches = dict(kernels.LAUNCHES)
    mf = spy.result
    peak = torch.cuda.max_memory_allocated() / 2**30
    top = [(e["name"], round(e["logL"], 3), e["df"], round(e["BIC"], 3))
           for e in mf["table"][:4]]
    print(f"[phase 9] {' '.join(WIDE_SELECTION)} on {BIG_TAXA} x "
          f"{BIG_SITES} f32: winner {mf['best']} in {wall:.1f} s "
          f"(ModelFinder wall seconds {mf['seconds']}); fits by route "
          f"{spy.routes}; peak device memory {peak:.2f} GiB; top 4 (name, "
          f"logL, df, BIC) {top}; launches {launches}; passes "
          f"{passes.calls}", flush=True)
    if not mf["best"].startswith("GTR"):
        raise RuntimeError(f"phase 9 picked {mf['best']}; the data are "
                           f"GTR+G4")
    if not (spy.routes["joint fit"] and spy.routes["alternation"]):
        raise RuntimeError(f"phase 9 did not take both routes: "
                           f"{spy.routes}")
    if not all(launches[k] > 0 for k in ("down_pass", "sitelp",
                                         "theta_pass")):
        raise RuntimeError(f"a kernel of the path was never launched: "
                           f"{launches}")
    passes.check(launches, "[phase 9]")
    return launches


def start_part(fn: str, *args, env: dict | None = None) -> subprocess.Popen:
    """This script's function ``fn`` on ``args`` in a python process of its
    own (from the checkout's root: the kernels built there are loaded;
    ``env`` added to this process's environment), whose last line of
    output is RESULT and fn's JSON result; join_part collects it. Its
    launch counts are its own."""
    return subprocess.Popen(
        [sys.executable, "-c", PART_RUN, fn, json.dumps(args)], cwd=ROOT,
        env=None if env is None else {**os.environ, **env},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def join_part(proc: subprocess.Popen, tag: str):
    """Wait for a start_part process, print its output and return its
    result; raises if it failed or outlasted PART_TIMEOUT."""
    out, err = proc.communicate(timeout=PART_TIMEOUT)
    lines = out.splitlines()
    for ln in lines:
        if not ln.startswith("RESULT "):
            print(ln, flush=True)
    results = [ln[7:] for ln in lines if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not results:
        raise RuntimeError(f"{tag} exited {proc.returncode}: "
                           f"{err[-3000:]}")
    return json.loads(results[-1])


def part_default() -> dict:
    """12a, the partitioned default command; returns its launches."""
    pdef = OUT / "part_default"
    launches = counted(["-s", str(GOLDEN / "example.phy"), "-p",
                        str(GOLDEN / "example.nex"), "-B",
                        str(FLAGSHIP_REPLICATES)] + PART_DEFAULT_DEPTH
                       + ["-pre", str(pdef)], "[phase 12a]")
    winners = scheme_models(pdef)
    logl = check_flagship(pdef, PART_DEFAULT_LOGL - 0.5)
    print(f"[phase 12a] winners {winners} (the JAX package's "
          f"{PART_WINNERS}); logL {logl:.4f} (bound "
          f"{PART_DEFAULT_LOGL - 0.5:.4f}); wall seconds: "
          f"{re.search(r'Wall seconds: (.*)', log_lines(pdef)).group(1)}",
          flush=True)
    if winners != PART_WINNERS:
        raise RuntimeError(f"per-partition winners {winners}, the JAX "
                           f"package's {PART_WINNERS}")
    if "PARTITION TABLE" not in Path(f"{pdef}.iqtree").read_text():
        raise RuntimeError(f"{pdef}.iqtree holds no partition table")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel of the path was never launched: "
                           f"{launches}")
    return launches


def part_linkages() -> None:
    """12b: -q, -Q and -p (float32, and float64) with -te, and -S."""
    phy, nex = str(GOLDEN / "example.phy"), str(GOLDEN / "example.nex")
    ref = str(GOLDEN / "ref_tree.nwk")
    for flag, f64 in (("-q", False), ("-Q", False), ("-p", False),
                      ("-p", True)):
        pre = OUT / f"part_te_{flag[1]}{'_f64' if f64 else ''}"
        counted(["-s", phy, flag, nex, "-m", "GTR+G", "-te", ref]
                + (["--f64"] if f64 else []) + ["-pre", str(pre)],
                f"[phase 12b {flag}{' f64' if f64 else ''}]")
        got, (ref64, ref32) = report_logl(pre), PART_TE_LOGL[flag]
        print(f"[phase 12b] {flag} {'f64' if f64 else 'f32'}: logL "
              f"{got:.4f} (the JAX package's f64 {ref64}, f32 {ref32})",
              flush=True)
        if not (abs(got - ref64) <= 0.01 if f64 else got >= ref64 - 0.5):
            raise RuntimeError(f"{flag} logL {got} against the JAX "
                               f"package's {ref64} (f64)")
    unl = OUT / "part_S"
    counted(["-s", phy, "-S", nex, "-m", "GTR+G", "-te", ref, "-pre",
             str(unl)], "[phase 12b -S]")
    trees = Path(f"{unl}.treefile").read_text().splitlines()
    rows = [r.split("\t") for r in
            Path(f"{unl}.partlh").read_text().splitlines()]
    print(f"[phase 12b] -S: {len(trees)} trees; per-locus (name, sites, "
          f"logL) {rows}", flush=True)
    if len(trees) != 3 or len(rows) != 3 or not all(
            math.isfinite(float(r[2])) for r in rows):
        raise RuntimeError("-S wrote no three trees and logLs")


def part_wide(big_aln: str, big_tree: str) -> None:
    """12c: phase 5's alignment as WIDE_CHARSETS charsets, -te, against
    the unpartitioned fit of the same model (WIDE_MODEL)."""
    width = BIG_SITES // WIDE_CHARSETS
    wnex = OUT / "wide_charsets.nex"
    wnex.write_text("#nexus\nbegin sets;\n" + "".join(
        f"  charset w{k + 1} = {k * width + 1}-{(k + 1) * width};\n"
        for k in range(WIDE_CHARSETS)) + "end;\n")
    unpart, wide = OUT / "wide_unpartitioned", OUT / "part_wide"
    wall = run_cli(["-s", big_aln, "-m", WIDE_MODEL, "-te", big_tree,
                    "-pre", str(unpart)])
    counted(["-s", big_aln, "-p", str(wnex), "-m", WIDE_MODEL, "-te",
             big_tree, "-pre", str(wide)], "[phase 12c]", split=True)
    got, rates = report_logl(wide), partition_rates(wide)
    ref = report_logl(unpart)
    print(f"[phase 12c] {WIDE_CHARSETS} x {width} sites -p -m {WIDE_MODEL} "
          f"-te: logL {got:.4f} (unpartitioned {ref:.4f} in {wall:.1f} s); "
          f"rates {rates}", flush=True)
    if not got >= ref - 1.0:
        raise RuntimeError(f"partitioned logL {got} below the "
                           f"unpartitioned {ref} - 1")
    if len(rates) != WIDE_CHARSETS or not max(
            abs(r - 1.0) for r in rates) <= MAX_RATE_DEV:
        raise RuntimeError(f"partition rates {rates} not within "
                           f"{MAX_RATE_DEV} of 1")
    if all(r == 1.0 for r in rates):
        raise RuntimeError("no partition rate moved from its start: the "
                           "rate search did not run")


def part_loci(errors: dict) -> None:
    """12d: a gappy supermatrix of simulated loci, searched, then the
    kernels at its smallest and largest partitions' shapes."""
    import numpy as np
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.partition.engine import PartitionEngine
    from iqtree2_tpu_torch.tree.topology import Tree
    t0 = time.perf_counter()
    loci = [("DNA", LOCUS_MODELS[i % len(LOCUS_MODELS)][1], LOCUS_SITES,
             LOCUS_GAPS, 0.25 * 16.0 ** (i / (LOCI - 1)))
            for i in range(LOCI)]
    sa, _, smodels, srates = kernelcheck.simulate_loci(loci, LOCUS_TAXA,
                                                       seed=1)
    ldir = OUT / "loci"
    ldir.mkdir(exist_ok=True)
    lnex = kernelcheck.write_partitioned(
        sa, [LOCUS_MODELS[i % len(LOCUS_MODELS)][0] for i in range(LOCI)],
        ldir)
    print(f"[phase 12d] simulated {LOCI} loci x {LOCUS_SITES} sites over "
          f"{LOCUS_TAXA} taxa in {time.perf_counter() - t0:.1f} s; "
          f"patterns {[p.num_patterns for p in sa.partitions]}", flush=True)
    sup = OUT / "part_loci"
    counted(["-p", lnex, "-m", "GTR+G", "-B", str(FLAGSHIP_REPLICATES)]
            + LOCUS_DEPTH + ["-pre", str(sup)], "[phase 12d]")
    terrace = Path(f"{sup}.terrace").read_text()
    n_boot = len(Path(f"{sup}.ufboot").read_text().splitlines())
    print(f"[phase 12d] logL {report_logl(sup):.4f}; {n_boot} replicate "
          f"trees; terrace: {terrace.splitlines()[-1]}; wall seconds: "
          f"{re.search(r'Wall seconds: (.*)', log_lines(sup)).group(1)}",
          flush=True)
    if n_boot != FLAGSHIP_REPLICATES or f"partition {LOCI}:" not in terrace:
        raise RuntimeError(f"12d wrote no {FLAGSHIP_REPLICATES} replicate "
                           f"trees or no terrace report over {LOCI} loci")
    tree = Tree.from_newick(Path(f"{sup}.treefile").read_text(), sa.names)
    peng = PartitionEngine(sa, smodels, srates, dtype=torch.float32,
                           device="cuda")
    pats = [p.num_patterns for p in sa.partitions]
    for k in sorted({int(np.argmin(pats)), int(np.argmax(pats))}):
        check_kernels(f"[phase 12d] locus {k + 1} ({pats[k]} patterns, "
                      f"{int((~sa.part_presence[k]).sum())} taxa all-gap)",
                      peng.engines[k], tree, 3, errors)



def part_flags() -> None:
    """12e: the last single-alignment flags on example.phy, each command
    line counted: -g (every constraint split in .treefile), -b (.boottrees,
    supports, .contree), --runs (.run1 and .run2, the best printed) and
    --symtest (.symtest.csv)."""
    import contextlib
    import io
    from iqtree2_tpu_torch.io.alignment_io import read_alignment
    from iqtree2_tpu_torch.tree.constraint import TopologyConstraint
    from iqtree2_tpu_torch.tree.topology import Tree
    phy = str(GOLDEN / "example.phy")
    names = read_alignment(phy).names
    base = ["-s", phy, "-m", "GTR+G"]

    def searched(args: list[str], tag: str) -> str:
        """counted() of a command line that searches (so launches every
        kernel); returns what it printed."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launches = counted(base + args, f"[phase 12e {tag}]")
        sys.stdout.write(out.getvalue())
        if not all(v > 0 for v in launches.values()):
            raise RuntimeError(f"12e {tag}: a kernel was never launched: "
                               f"{launches}")
        return out.getvalue()

    cfile, con = OUT / "constraint.nwk", OUT / "flag_g"
    cfile.write_text(CONSTRAINT)
    searched(["-g", str(cfile), "-n", "2", "-pre", str(con)], "-g")
    constraint = TopologyConstraint(CONSTRAINT, names)
    tree = Tree.from_newick(Path(f"{con}.treefile").read_text(), names)
    ref = Tree.from_newick((GOLDEN / "ref_tree.nwk").read_text(), names)
    print(f"[phase 12e] -g {CONSTRAINT}: {len(constraint.splits)} split(s), "
          f"in .treefile {constraint.compatible(tree)} (in the reference "
          f"topology {constraint.compatible(ref)}); logL "
          f"{report_logl(con):.4f}", flush=True)
    if not (constraint.splits and constraint.compatible(tree)):
        raise RuntimeError("-g: .treefile breaks a constraint split")

    boot = OUT / "flag_b"
    searched(["-b", str(STANDARD_REPLICATES), "-n", "1", "-pre", str(boot)],
             "-b")
    trees = Path(f"{boot}.boottrees").read_text().splitlines()
    labels = re.findall(r"\)(\d+):", Path(f"{boot}.treefile").read_text())
    print(f"[phase 12e] -b {STANDARD_REPLICATES}: {len(trees)} replicate "
          f"trees; supports {labels}", flush=True)
    if len(trees) != STANDARD_REPLICATES or len(labels) != 14 or not all(
            int(x) <= 100 for x in labels) or not Path(
                f"{boot}.contree").read_text().strip():
        raise RuntimeError("-b: no replicate trees, supports or .contree")

    runs = OUT / "flag_runs"
    printed = searched(["--runs", "2", "-n", "2", "-pre", str(runs)],
                       "--runs")
    best = re.search(r"Best of 2 runs: logL (\S+)", printed)
    logls = [report_logl(Path(f"{runs}.run{r}")) for r in (1, 2)]
    print(f"[phase 12e] --runs 2: run logLs {logls}, best printed "
          f"{best and best.group(1)}", flush=True)
    if not (best and abs(float(best.group(1)) - max(logls)) <= 1e-3):
        raise RuntimeError("--runs: the best run was not printed")

    sym = OUT / "flag_symtest"
    searched(["--symtest", "-n", "1", "-pre", str(sym)], "--symtest")
    rows = Path(f"{sym}.symtest.csv").read_text().splitlines()
    print(f"[phase 12e] --symtest: {rows}", flush=True)
    if len(rows) != 2 or not rows[0].startswith("Name,SymSig"):
        raise RuntimeError("--symtest wrote no .symtest.csv row")

def mix_kernels(errors: dict) -> None:
    """13a: the kernels against their plain versions at the mixtures'
    shapes (MIX_CHECKS; the plain references window by window), each pass
    one launch, with times, bounds, shares, occupancy and peak memory."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.ops import kernels
    from iqtree2_tpu_torch.tree.schedule import build_schedule
    largest = 0
    for name, sites, dt in MIX_CHECKS:
        dtype = getattr(torch, dt)
        aln, tree, model, rates = kernelcheck.simulate(name, CHECK_TAXA,
                                                       sites, seed=1)
        eng = LikelihoodEngine(aln, model, rates, dtype=dtype, device="cuda")
        C, S = int(eng._pack["cat_rate"].shape[0]), aln.num_states
        torch.cuda.reset_peak_memory_stats()
        window = kernelcheck.plain_window(eng)
        tag = f"[phase 13a] {name} {CHECK_TAXA} x {sites}"
        res = check_kernels(tag, eng, tree, MIX_TIME_REPS, errors,
                            window=window, b2b_reps=MIX_TIME_REPS)
        bnd = kernelcheck.bounds(eng, tree)
        share = {r["name"]: (round(bnd[r["name"]]["bound_ms"], 6),
                             round(bnd[r["name"]]["bound_ms"] / r["b2b_ms"],
                                   4)) for r in res}
        share["down_pass + epilogue"] = (
            round(bnd["down_pass_sitelp"]["bound_ms"], 6),
            round(bnd["down_pass_sitelp"]["bound_ms"]
                  / res[0]["sitelp_b2b_ms"], 4))
        occ = {k: kernels.pass_occupancy(k, dtype, C, S, eng.Pp)
               for k in kernels.PASS_KINDS}
        rows = (aln.ntaxa + build_schedule(tree).n_int) * C * S * eng.Pp
        largest = max(largest, rows)
        print(f"{tag} {dt} C={C} M={len(model.components)}: unified buffer "
              f"{rows} values ({rows / 2**31:.2f} x 2^31); plain window "
              f"{window}; launches per pass "
              f"{ {r['name']: r['launches'] for r in res} } (sitelp "
              f"{res[0]['sitelp_launches']}); (bound ms, share of back to "
              f"back) {share}; (blocks per SM, shared bytes) {occ}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB", flush=True)
        if any(r["launches"] != 1 for r in res) or \
                res[0]["sitelp_launches"] != 1:
            raise RuntimeError(f"{tag}: not one launch per pass: {res}")
        del eng, res
        torch.cuda.empty_cache()
    if largest <= 2 ** 31:
        raise RuntimeError(f"no unified buffer past 2^31 values: {largest}")


def log_value(prefix: Path, label: str) -> float:
    """The number after ``label`` in a run's .log."""
    return float(re.search(re.escape(label) + r" (-?[\d.]+)",
                           log_lines(prefix)).group(1))


def check_rows(path: Path, skip: int, ncol: int, nrows: int) -> None:
    """A per-site table (.sitefreq, .siteprob) holds nrows rows of ncol
    probabilities after the site number, each row summing to 1 within
    1e-4."""
    import numpy as np
    rows = [ln.split() for ln in path.read_text().splitlines()[skip:]]
    t = np.array([r[1:] for r in rows], float)
    if t.shape != (nrows, ncol):
        raise RuntimeError(f"{path.name} holds {t.shape}, not "
                           f"{(nrows, ncol)}")
    err = float(np.abs(t.sum(1) - 1.0).max())
    if not err <= 1e-4:
        raise RuntimeError(f"{path.name} rows sum to 1 only within {err}")


def mix_pmsf_guide() -> None:
    """13b: -m LG+C60+G --pmsf -te on PMSF_TAXA x PMSF_SITES simulated
    class by class: the guide fit runs the kernels at C = 240; .sitefreq
    rows sum to 1, the PMSF logL is at least the guide's - 1, peak memory
    under MAX_PMSF_GIB."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    aln, tree, _, _ = kernelcheck.simulate("LG+C60+G4", PMSF_TAXA,
                                           PMSF_SITES, seed=1)
    pre = OUT / "pmsf_guide"
    phy, nwk = kernelcheck.write_problem(aln, tree, pre)
    tag = "[phase 13b]"
    launches = counted(["-s", phy, "-m", "LG+C60+G", "--pmsf", "-te", nwk,
                        "-pre", str(pre)], tag)
    peak = torch.cuda.max_memory_allocated() / 2**30
    guide, final = log_value(pre, "PMSF guide fit logL:"), \
        log_value(pre, "PMSF final logL:")
    print(f"{tag} on {aln.ntaxa} x {aln.nsites} ({aln.num_patterns} "
          f"patterns) f32: guide mixture logL {guide:.4f}, PMSF logL "
          f"{final:.4f}, report {report_logl(pre):.4f}", flush=True)
    check_rows(Path(f"{pre}.sitefreq"), 0, 20, aln.nsites)
    if not final >= guide - 1.0:
        raise RuntimeError(f"PMSF logL {final} below the guide's {guide} - 1")
    if not peak < MAX_PMSF_GIB:
        raise RuntimeError(f"peak device memory {peak:.2f} GiB")
    if not all(launches[k] > 0 for k in ("down_pass", "sitelp",
                                         "theta_pass")):
        raise RuntimeError(f"a kernel of the guide fit was never launched: "
                           f"{launches}")
    ssf_times(aln, tree, Path(f"{pre}.sitefreq"))


def ssf_times(aln, tree, sitefreq: Path) -> None:
    """13b's site-specific-frequency functions (plain PyTorch on the card)
    timed per call with CUDA events at 13b's shapes, on the written
    profile under LG+G4: a log-likelihood, the down pass, the up pass, the
    edge thetas, NNI1 scoring of every candidate (with its passes) and a
    branch-length round."""
    import numpy as np
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.model import pmsf
    from iqtree2_tpu_torch.model.factory import build_model
    from iqtree2_tpu_torch.ops import sitespecific as ssf
    from iqtree2_tpu_torch.ops.nni import build_nni_candidates
    from iqtree2_tpu_torch.tree.schedule import build_schedule
    site = np.loadtxt(sitefreq)[:, 1:]
    prof = np.zeros((aln.num_patterns, site.shape[1]))
    prof[aln.site_to_pattern] = site
    lg, rates, _ = build_model("LG+G4", aln)
    eng = pmsf.SSFEngine(aln, pmsf._exch_full(lg.exch_rates, 20), prof,
                         rates, dtype=torch.float32, device="cuda")
    sched = build_schedule(tree)
    sa, b = eng.schedule_arrays(sched), eng._blens(sched)
    c = build_nni_candidates(tree, sched)
    cand = np.stack([c.iu, c.iv, c.slot_c, c.edge_id])
    dp = ssf.down_pass(b, eng._tipP, sa, eng.pack)
    up = ssf.up_pass(b, dp, eng._tipP, sa, eng.pack)
    calls = {
        "loglik": lambda: ssf.tree_loglik(b, eng._tipP, sa, eng.pack,
                                          eng._pw),
        "down_pass": lambda: ssf.down_pass(b, eng._tipP, sa, eng.pack),
        "up_pass": lambda: ssf.up_pass(b, dp, eng._tipP, sa, eng.pack),
        "edge_thetas": lambda: ssf.edge_thetas(up, dp, sa["edge_src"],
                                               eng.pack),
        "nni1 scoring": lambda: eng.evaluate_nni_batch(sched, cand),
        "branch round": lambda: eng.optimize_branches(tree.copy(),
                                                      n_rounds=1)}
    ms = {k: round(kernelcheck.timed_ms(fn, 3), 3) for k, fn in calls.items()}
    print(f"[phase 13b] SSF engine per call (ms, {aln.ntaxa} taxa, "
          f"{eng.Pp} patterns, C = 4, f32, CUDA events): {ms}", flush=True)


def mix_search() -> tuple[str, dict]:
    """13c: -m LG+C20+G -B 1000 -wspm on MIX_TAXA x MIX_SITES: 1000
    replicate trees, .siteprob with the 20 classes' posteriors (rows
    summing to 1), every kernel launched. Returns the alignment's path and
    the launches."""
    from iqtree2_tpu_torch import kernelcheck
    aln, tree, _, _ = kernelcheck.simulate("LG+C20+G4", MIX_TAXA, MIX_SITES,
                                           seed=2)
    pre = OUT / "mix_search"
    phy, _ = kernelcheck.write_problem(aln, tree, pre)
    tag = "[phase 13c]"
    launches = counted(["-s", phy, "-m", "LG+C20+G", "-B",
                        str(MIX_REPLICATES), "-wspm"] + MIX_DEPTH
                       + ["-pre", str(pre)], tag)
    n_boot = len(Path(f"{pre}.ufboot").read_text().splitlines())
    print(f"{tag} on {aln.ntaxa} x {aln.nsites} ({aln.num_patterns} "
          f"patterns) f32: logL {report_logl(pre):.4f}, {n_boot} replicate "
          f"trees; wall seconds: "
          f"{re.search(r'Wall seconds: (.*)', log_lines(pre)).group(1)}",
          flush=True)
    if n_boot != MIX_REPLICATES:
        raise RuntimeError(f".ufboot holds {n_boot} trees")
    check_rows(Path(f"{pre}.siteprob"), 1, 20, aln.nsites)
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel of the path was never launched: "
                           f"{launches}")
    return phy, launches


def mix_pmsf_search(phy: str) -> None:
    """13d: -m LG+C20+G --pmsf -B 1000 on 13c's alignment: the guide fit on
    a stepwise-addition tree, .sitefreq, then the search on the
    site-specific-frequency engine (NNI1) with 1000 replicate trees."""
    import contextlib
    import io
    pre = OUT / "mix_pmsf_search"
    tag = "[phase 13d]"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        counted(["-s", phy, "-m", "LG+C20+G", "--pmsf", "-B",
                 str(MIX_REPLICATES)] + MIX_DEPTH + ["-pre", str(pre)], tag)
    n_boot = len(Path(f"{pre}.ufboot").read_text().splitlines())
    print(f"{out.getvalue().strip()}\n{tag} guide logL "
          f"{log_value(pre, 'PMSF guide fit logL:'):.4f}, logL "
          f"{report_logl(pre):.4f}, {n_boot} replicate trees; wall seconds: "
          f"{re.search(r'Wall seconds: (.*)', log_lines(pre)).group(1)}",
          flush=True)
    if "(NNI1)" not in out.getvalue():
        raise RuntimeError("the PMSF search did not climb with NNI1")
    if n_boot != MIX_REPLICATES:
        raise RuntimeError(f".ufboot holds {n_boot} trees")
    check_rows(Path(f"{pre}.sitefreq"), 0, 20, MIX_SITES)


def weights_fit(device: str) -> dict:
    """13e's fit: MIX{LG,WAG}+G on WEIGHT_TAXA x WEIGHT_SITES (simulated
    class by class) in float64 on ``device``, the class weights and the
    Gamma shape fitted with the branch lengths on the simulating tree
    (the host alternation; the joint fit declines mixtures)."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.model.factory import build_model
    from iqtree2_tpu_torch.model.optimize import optimize_model_parameters
    aln, tree, _, _ = kernelcheck.simulate("MIX{LG,WAG}+G4", WEIGHT_TAXA,
                                           WEIGHT_SITES, seed=3)
    model, rates, _ = build_model("MIX{LG,WAG}+G", aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device=device)
    t0 = time.perf_counter()
    logl = optimize_model_parameters(eng, tree)
    return {"logL": logl, "weights": model.weights.tolist(),
            "alpha": rates.alpha, "seconds": time.perf_counter() - t0}


def start_cpu_weights_fit() -> subprocess.Popen:
    """13e's CPU side in a process of its own, on three CPU threads (the
    plain versions' fit takes minutes)."""
    import os
    env = dict(os.environ, OMP_NUM_THREADS="3")
    return subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke, torch; "
         "torch.set_num_threads(3); "
         "print(json.dumps(chip_smoke.weights_fit('cpu')))"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def mix_weights(cpu: subprocess.Popen) -> None:
    """13e: the fitted MIX{LG,WAG}+G weights on the card, against the
    port's own CPU fit in float64 (logL within WEIGHT_TOL)."""
    import torch
    from iqtree2_tpu_torch.ops import kernels
    tag = "[phase 13e]"
    with PassCount() as passes:
        kernels.reset_launch_counts()
        card = weights_fit("cuda")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    passes.check(launches, tag)
    t0 = time.perf_counter()
    stdout, stderr = cpu.communicate(timeout=900)
    print(f"{tag} waited {time.perf_counter() - t0:.1f} s for the CPU fit",
          flush=True)
    if cpu.returncode != 0:
        raise RuntimeError(f"{tag} the CPU fit failed: {stderr[-2000:]}")
    host = json.loads(stdout.strip().splitlines()[-1])
    print(f"{tag} MIX{{LG,WAG}}+G -te {WEIGHT_TAXA} x {WEIGHT_SITES} f64: "
          f"card logL {card['logL']:.6f}, weights {card['weights']}, alpha "
          f"{card['alpha']:.6f} in {card['seconds']:.1f} s; CPU logL "
          f"{host['logL']:.6f}, weights {host['weights']}, alpha "
          f"{host['alpha']:.6f} in {host['seconds']:.1f} s; launches "
          f"{launches}", flush=True)
    if abs(card["weights"][0] - 0.5) < 1e-3:
        raise RuntimeError(f"{tag} the class weights were not fitted")
    if not abs(card["logL"] - host["logL"]) <= WEIGHT_TOL:
        raise RuntimeError(f"{tag} card logL {card['logL']} against the "
                           f"CPU's {host['logL']}")
    if not all(launches[k] > 0 for k in ("down_pass", "sitelp",
                                         "theta_pass")):
        raise RuntimeError(f"{tag} a kernel was never launched: {launches}")


def family_kernels(errors: dict) -> list:
    """14a: the kernels against their plain versions on the model families'
    problems (FAMILY_CHECKS, at CHECK_TAXA x CHECK_SITES: codons for the
    codon models), each pass one launch, with times loaded and back to
    back, bounds, shares, occupancy and peak memory. Returns one row per
    problem for the summary line."""
    return kernel_rows(FAMILY_CHECKS, "14a", errors,
                       not_indicators=("HKY+E+G4",))


def kernel_rows(checks, phase: str, errors: dict,
                not_indicators=()) -> list:
    """Each (kernelcheck.MODELS name, dtype[, sites]) of ``checks`` at
    CHECK_TAXA x sites (CHECK_SITES where none is given; a name ending in
    " rooted" as the root test's problem,
    kernelcheck.rooted_problem), on the engine its model takes
    (kernelcheck.make_engine): the kernels against their plain versions,
    one launch per pass, times loaded and back to back, bounds, shares,
    occupancy and peak memory; the tips of the problems in
    ``not_indicators`` must not be indicator rows. Returns one row per
    problem."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.ops import kernels
    rows = []
    for name, dt, *sites in checks:
        sites = sites[0] if sites else CHECK_SITES
        dtype = getattr(torch, dt)
        model_name = name.removesuffix(" rooted")
        aln, tree, model, rates = kernelcheck.simulate(model_name, CHECK_TAXA,
                                                       sites, seed=1)
        if model_name != name:
            aln, tree = kernelcheck.rooted_problem(aln, tree)
        eng = kernelcheck.make_engine(aln, model, rates, dtype=dtype,
                                      device="cuda")
        C, S = int(eng._pack["cat_rate"].shape[0]), eng._tipP.shape[1]
        torch.cuda.reset_peak_memory_stats()
        window = kernelcheck.plain_window(eng)
        tag = f"[phase {phase}] {name} {aln.ntaxa} x {sites}"
        res = check_kernels(tag, eng, tree, FAMILY_TIME_REPS, errors,
                            window=window, b2b_reps=FAMILY_B2B_REPS)
        bnd = kernelcheck.bounds(eng, tree)
        row = {"problem": name, "dtype": dt, "C": C, "S": S, "Pp": eng.Pp}
        for r in res:
            b = bnd[r["name"]]
            row[r["name"]] = {
                "ms": round(r["ms"], 4), "b2b_ms": round(r["b2b_ms"], 4),
                "bound_ms": round(b["bound_ms"], 6),
                "bound_by": b["bound_by"],
                "share": round(b["bound_ms"] / r["b2b_ms"], 4),
                "plain_ms": round(r["plain_ms"], 3),
                "occupancy": kernels.pass_occupancy(r["name"], dtype, C, S,
                                                    eng.Pp)}
        b = bnd["down_pass_sitelp"]
        row["down_pass + epilogue"] = {
            "ms": round(res[0]["sitelp_ms"], 4),
            "b2b_ms": round(res[0]["sitelp_b2b_ms"], 4),
            "bound_ms": round(b["bound_ms"], 6),
            "share": round(b["bound_ms"] / res[0]["sitelp_b2b_ms"], 4),
            "plain_ms": round(res[0]["sitelp_plain_ms"], 3)}
        print(f"{tag} {dt} C={C} S={S} Pp={eng.Pp}: plain window {window}; "
              f"launches per pass "
              f"{ {r['name']: r['launches'] for r in res} } (sitelp "
              f"{res[0]['sitelp_launches']}); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{json.dumps(row)}", flush=True)
        if any(r["launches"] != 1 for r in res) or \
                res[0]["sitelp_launches"] != 1:
            raise RuntimeError(f"{tag}: not one launch per pass: {res}")
        if name in not_indicators and not bool(((eng._tipP > 0)
                                                 & (eng._tipP < 1)).any()):
            raise RuntimeError(f"{tag}: the tips are indicator rows")
        rows.append(row)
        del eng, res
        torch.cuda.empty_cache()
    return rows


def report_value(prefix: Path, label: str) -> float:
    """The number after ``label:`` in a run's .iqtree."""
    return float(re.search(re.escape(label) + r": (-?[\d.]+)",
                           Path(f"{prefix}.iqtree").read_text()).group(1))


def tree_length(prefix: Path) -> float:
    return report_value(prefix, "Total tree length (sum of branch lengths)")


def wall_split(prefix: Path) -> str:
    return re.search(r"Wall seconds: (.*)", log_lines(prefix)).group(1)


def family_codon(launches: dict) -> tuple[str, str, Path]:
    """14b: CODON_TAXA x CODON_SITES codons simulated under
    GY{2.0,0.3}+F3X4+G{0.8}; -st CODON -m GY+F3X4+G -B 1000 (CODON_DEPTH)
    in float32: logL at least the -te fit on the simulating tree
    (CODON_TE_LOGL) - 0.5, kappa and omega within PARAM_TOL of the
    simulating values, phase 6's files, every kernel launched. Adds the
    launches to ``launches``; returns the alignment's and the simulating
    tree's paths and the search's prefix."""
    from iqtree2_tpu_torch import kernelcheck
    aln, tree, _, _ = kernelcheck.simulate("GY+F3X4+G4", CODON_TAXA,
                                           CODON_SITES, seed=4)
    phy, nwk = kernelcheck.write_problem(aln, tree, OUT / "codon")
    bound = CODON_TE_LOGL - 0.5
    pre = OUT / "codon_search"
    tag = "[phase 14b]"
    got = counted(["-s", phy, "-st", "CODON", "-m", "GY+F3X4+G", "-B",
                   str(FLAGSHIP_REPLICATES)] + CODON_DEPTH
                  + ["-pre", str(pre)], tag)
    add(launches, got)
    logl = check_flagship(pre, bound)
    kappa = report_value(pre, "Transition/transversion ratio (kappa)")
    omega = report_value(pre, "Nonsynonymous/synonymous ratio (omega)")
    print(f"{tag} {aln.ntaxa} x {aln.nsites} codons ({aln.num_patterns} "
          f"patterns) f32: logL {logl:.4f} (bound {bound:.4f}, the -te "
          f"fit's - 0.5), tree length {tree_length(pre):.4f}, kappa "
          f"{kappa} omega {omega} (simulated "
          f"{CODON_TRUE}); wall seconds: {wall_split(pre)}", flush=True)
    for v, true in zip((kappa, omega), CODON_TRUE):
        if not abs(v - true) <= PARAM_TOL * true:
            raise RuntimeError(f"{tag} kappa {kappa}, omega {omega}: not "
                               f"within {PARAM_TOL} of {CODON_TRUE}")
    if not all(v > 0 for v in got.values()):
        raise RuntimeError(f"{tag} a kernel of the path was never "
                           f"launched: {got}")
    return phy, nwk, pre


def family_codon_models(phy: str, nwk: str, gy: Path,
                        launches: dict) -> None:
    """14c: -m KOSI07+F+G and -m MG+F3X4 -te on 14b's data and simulating
    tree: finite logLs, tree lengths within 2x of 14b's GY fit's."""
    length = tree_length(gy)
    for model in ("KOSI07+F+G", "MG+F3X4"):
        pre = OUT / f"codon_{model.split('+')[0].lower()}"
        tag = f"[phase 14c {model}]"
        add(launches, counted(["-s", phy, "-st", "CODON", "-m", model, "-te",
                               nwk, "-pre", str(pre)], tag))
        logl, tl = report_logl(pre), tree_length(pre)
        print(f"{tag} logL {logl:.4f}, tree length {tl:.4f} (GY+F3X4+G's "
              f"{length:.4f})", flush=True)
        if not math.isfinite(logl) or not length / 2 <= tl <= 2 * length:
            raise RuntimeError(f"{tag} logL {logl}, tree length {tl}")


def with_errors(aln_path: str, share: float, seed: int) -> str:
    """A copy of a DNA alignment file with ``share`` of its tip states, drawn
    from ``seed``, each replaced by one of the other three bases (drawn
    uniformly); returns its path."""
    import numpy as np
    from iqtree2_tpu_torch.data.alignment import Alignment
    from iqtree2_tpu_torch.data.seqtypes import DNA_STATE_TO_CODE
    from iqtree2_tpu_torch.io.alignment_io import read_alignment, write_phylip
    aln = read_alignment(aln_path)
    mat = aln.expand_to_sites().copy()
    rng = np.random.default_rng(seed)
    hit = rng.random(mat.shape) < share
    state = np.searchsorted(DNA_STATE_TO_CODE, mat[hit])
    if not np.array_equal(DNA_STATE_TO_CODE[state], mat[hit]):
        raise RuntimeError("the alignment holds ambiguous states")
    mat[hit] = DNA_STATE_TO_CODE[(state + rng.integers(1, 4, state.size))
                                 % 4]
    path = str(OUT / "big_errors.phy")
    write_phylip(Alignment.from_site_matrix(aln.names, mat, aln.seqtype),
                 path)
    return path


def family_seqerror(aln_path: str, tree_path: str, launches: dict) -> None:
    """14d: phase 5's alignment with ERROR_SHARE of its tip states
    replaced: -m GTR+E+G -te fits epsilon within ERROR_RANGE and a logL
    above -m GTR+G -te's on the same file; then -m HKY+E+G -B 1000 on
    example.phy under phase 6's checks (its logL at least the -te fit on
    the reference tree, HKY_E_TE_LOGL, - 0.5)."""
    noisy = with_errors(aln_path, ERROR_SHARE, seed=7)
    fits = {}
    for model in ("GTR+E+G", "GTR+G"):
        pre = OUT / f"errors_{model.replace('+', '')}"
        add(launches, counted(["-s", noisy, "-m", model, "-te", tree_path,
                               "-pre", str(pre)],
                              f"[phase 14d {model}]"))
        fits[model] = pre
    eps = report_value(fits["GTR+E+G"],
                       "Sequencing error probability (epsilon)")
    le, lg = report_logl(fits["GTR+E+G"]), report_logl(fits["GTR+G"])
    print(f"[phase 14d] {ERROR_SHARE:.0%} of the tips replaced: epsilon "
          f"{eps} (range {ERROR_RANGE}); logL GTR+E+G {le:.4f}, GTR+G "
          f"{lg:.4f}", flush=True)
    if not (ERROR_RANGE[0] <= eps <= ERROR_RANGE[1] and le > lg):
        raise RuntimeError(f"[phase 14d] epsilon {eps}, logLs {le} / {lg}")
    pre = OUT / "hky_e_search"
    tag = "[phase 14d HKY+E+G -B]"
    got = counted(["-s", str(GOLDEN / "example.phy"), "-m", "HKY+E+G", "-B",
                   str(FLAGSHIP_REPLICATES)] + ERROR_DEPTH
                  + ["-pre", str(pre)], tag)
    add(launches, got)
    logl = check_flagship(pre, HKY_E_TE_LOGL - 0.5)
    print(f"{tag} logL {logl:.4f} (-te {HKY_E_TE_LOGL}), epsilon "
          f"{report_value(pre, 'Sequencing error probability (epsilon)')};"
          f" wall seconds: {wall_split(pre)}", flush=True)
    if not all(v > 0 for v in got.values()):
        raise RuntimeError(f"{tag} a kernel was never launched: {got}")


def family_mdef(aln_path: str, tree_path: str, launches: dict) -> None:
    """14e: --mdef MDEF_YAML: MYRY+G2 -B 1000 (FAMILY_DEPTH) on RY_TAXA x
    RY_SITES of the 2-state RY datatype (phase 6's files, a finite logL),
    and MYGTR+G{0.6} -te on phase 5's alignment in float64 equal to the
    same GTR written in the -m string within MDEF_TOL relative."""
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.io.alignment_io import write_phylip
    defs = OUT / "defs.yml"
    defs.write_text(MDEF_YAML)
    aln, _, _, _ = kernelcheck.simulate("JC2+G4", RY_TAXA, RY_SITES, seed=5)
    phy = str(OUT / "ry.phy")
    write_phylip(aln, phy)
    # binary states 0/1 as R/Y, after each line's 12-character name field
    head, *rows = Path(phy).read_text().splitlines()
    Path(phy).write_text("\n".join(
        [head] + [r[:12] + r[12:].translate(str.maketrans("01", "RY"))
                  for r in rows]) + "\n")
    pre = OUT / "ry_search"
    tag = "[phase 14e MYRY+G2 -B]"
    got = counted(["--mdef", str(defs), "-s", phy, "-st", "RY", "-m",
                   "MYRY+G2", "-B", str(FLAGSHIP_REPLICATES)] + FAMILY_DEPTH
                  + ["-pre", str(pre)], tag)
    add(launches, got)
    logl = check_flagship(pre, -math.inf)
    print(f"{tag} {RY_TAXA} x {RY_SITES} RY: logL {logl:.4f}; wall "
          f"seconds: {wall_split(pre)}", flush=True)
    if not math.isfinite(logl):
        raise RuntimeError(f"{tag} logL {logl}")
    if not all(v > 0 for v in got.values()):
        raise RuntimeError(f"{tag} a kernel was never launched: {got}")
    logls = {}
    for model, extra in (("MYGTR+G{0.6}", ["--mdef", str(defs)]),
                         (MDEF_GTR, [])):
        pre = OUT / f"mdef_{'yaml' if extra else 'gtr'}"
        add(launches, counted(extra + ["-s", aln_path, "-m", model, "-te",
                                       tree_path, "--f64", "-pre", str(pre)],
                              f"[phase 14e {model} f64]"))
        logls[model] = report_logl(pre)
    a, b = logls.values()
    print(f"[phase 14e] f64 -te on phase 5's alignment: {logls}; relative "
          f"difference {abs(a - b) / abs(b):.3e} (tol {MDEF_TOL:g})",
          flush=True)
    if not abs(a - b) <= MDEF_TOL * abs(b):
        raise RuntimeError(f"[phase 14e] MYGTR and GTR differ: {logls}")


def family_partitions(launches: dict) -> None:
    """14f: a -q supermatrix of PMIX_TAXA taxa, an LG+C20+G protein locus
    beside a GTR+G DNA locus (PMIX_LOCI, the protein locus simulated class
    by class): -te in float64 on the card, its fitted parameters and tree
    evaluated on the CPU (the plain versions) within PMIX_TOL; then -B 1000
    in float32 at FAMILY_DEPTH."""
    import torch
    from iqtree2_tpu_torch import cli, kernelcheck, partition_analysis
    from iqtree2_tpu_torch.data.superalignment import read_partition_spec
    from iqtree2_tpu_torch.partition.engine import PartitionEngine
    sa, tree, _, _ = kernelcheck.simulate_loci(
        [(st, m, n, 0.0, 1.0) for st, m, n in PMIX_LOCI], PMIX_TAXA, seed=6)
    d = OUT / "pmix"
    d.mkdir(exist_ok=True)
    nex = kernelcheck.write_partitioned(sa, PMIX_MODELS, d)
    nwk = d / "true.nwk"
    nwk.write_text(tree.to_newick() + "\n")
    res = {}

    def run_te(args):
        parser = cli.build_parser()
        ns = parser.parse_args(args + ["--device", "cuda", "-redo",
                                       "--quiet"])
        cli.refuse_unported(ns, parser)
        t0 = time.perf_counter()
        res.update(partition_analysis.run_partition_analysis(
            cli.params_from_args(ns), device="cuda"))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    base = ["-q", nex, "-m", "GTR+G"]
    tag = "[phase 14f -te f64]"
    add(launches, counted(base + ["-te", str(nwk), "--f64", "-pre",
                                  str(d / "te")], tag, runner=run_te))
    card = res["logL"]
    t0 = time.perf_counter()
    peng = res["peng"]
    host = PartitionEngine(read_partition_spec(nex), peng.models,
                           peng.rates, partition_type=peng.partition_type,
                           dtype=torch.float64, device="cpu")
    cpu = host.loglik_tree(res["tree"])
    print(f"{tag} {PMIX_TAXA} taxa, {PMIX_MODELS} over "
          f"{[n for _, _, n in PMIX_LOCI]} sites: card logL {card:.6f}, the "
          f"CPU's at its fitted parameters {cpu:.6f} (in "
          f"{time.perf_counter() - t0:.1f} s); fitted {res['models']}",
          flush=True)
    if not abs(card - cpu) <= PMIX_TOL:
        raise RuntimeError(f"{tag} card {card} against the CPU's {cpu}")
    pre = d / "search"
    tag = "[phase 14f -B]"
    got = counted(base + ["-B", str(FLAGSHIP_REPLICATES)] + FAMILY_DEPTH
                  + ["-pre", str(pre)], tag)
    add(launches, got)
    n_boot = len(Path(f"{pre}.ufboot").read_text().splitlines())
    print(f"{tag} logL {report_logl(pre):.4f}, {n_boot} replicate trees; "
          f"wall seconds: {wall_split(pre)}", flush=True)
    if n_boot != FLAGSHIP_REPLICATES:
        raise RuntimeError(f"{tag} .ufboot holds {n_boot} trees")
    if not all(v > 0 for v in got.values()):
        raise RuntimeError(f"{tag} a kernel was never launched: {got}")


def family_runs(aln_path: str, tree_path: str, parts: str) -> dict:
    """Phase 14's ``parts`` (of b-f), in start_part's process; returns
    their launches."""
    return model_families({}, aln_path, tree_path, parts=parts)[0]


def add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def model_families(errors: dict, aln_path: str, tree_path: str,
                   parts: str = "abcdef") -> tuple[dict, list]:
    """Phase 14's parts; returns the launches of 14b-f's command lines and
    14a's rows."""
    launches: dict = {}
    rows = family_kernels(errors) if "a" in parts else []
    if "b" in parts or "c" in parts:
        phy, nwk, gy = family_codon(launches)
        if "c" in parts:
            family_codon_models(phy, nwk, gy, launches)
    if "d" in parts:
        family_seqerror(aln_path, tree_path, launches)
    if "e" in parts:
        family_mdef(aln_path, tree_path, launches)
    if "f" in parts:
        family_partitions(launches)
    return launches, rows


def run_analysis(args: list[str], keep: dict) -> float:
    """The command line's single-alignment analysis in this process
    (cli.refuse_unported, then analysis.run_analysis on the card, as
    cli.main runs it), its result dict kept in ``keep``; returns its wall
    seconds."""
    import torch
    from iqtree2_tpu_torch import analysis, cli
    parser = cli.build_parser()
    ns = parser.parse_args(args + ["-redo", "--quiet"])
    cli.refuse_unported(ns, parser)
    t0 = time.perf_counter()
    keep.update(analysis.run_analysis(cli.params_from_args(ns),
                                      device="cuda"))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def nonrev_wide(launches: dict) -> None:
    """15b: BIG_TAXA x BIG_SITES simulated under UNREST+G4 (complex
    eigenvalues, P by expm) in float32: one logL, optimize_branches with
    the nonreversible Newton (NONREV_ROUNDS rounds: both passes, then the
    direct derivatives per edge), then the NNI climb (phase 7's, with the
    site logLs, at most NONREV_CLIMB_ROUNDS rounds) from the simulating
    tree moved by 19 random NNIs; launches per pass (one each), ms per
    Newton round, peak device memory. Then the card's site logLs against
    the plain path on a CHECK_TAXA x NONREV_CUT_SITES cut within
    kernelcheck.TOLERANCE."""
    import numpy as np
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.ops import kernels
    from iqtree2_tpu_torch.search.nni import nni_optimize
    tag = "[phase 15b]"
    t0 = time.perf_counter()
    aln, tree, model, rates = kernelcheck.simulate("UNREST+G4", BIG_TAXA,
                                                   BIG_SITES, seed=1)
    print(f"{tag} simulated {BIG_TAXA} x {BIG_SITES} under UNREST+G4 by "
          f"expm in {time.perf_counter() - t0:.1f} s", flush=True)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                           device="cuda")
    eng.loglik_tree(tree)                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logl0 = eng.loglik_tree(tree)
    lg_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with PassCount() as passes:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logl = eng.optimize_branches(tree, n_rounds=NONREV_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
    passes.check(got, tag)
    add(launches, got)
    rounds = passes.calls["up_pass"]
    round_ms = (wall - passes.calls["sitelp"] * lg_s) / max(rounds, 1) * 1e3
    print(f"{tag} f32 logL {logl0:.4f} ({lg_s * 1e3:.2f} ms) -> "
          f"{logl:.4f} after {rounds} nonreversible Newton rounds in "
          f"{wall:.2f} s ({passes.calls['sitelp']} logLs): {round_ms:.2f} "
          f"ms per round without its logLs; launches {got}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if not (math.isfinite(logl) and logl >= logl0 - 1e-3 and rounds > 0):
        raise RuntimeError(f"{tag} logL {logl0} -> {logl}")
    start, n = kernelcheck.perturbed(tree, seed=7, strength=0.02)
    eng.optimize_branches(start, n_rounds=2)
    times: list = []
    torch.cuda.reset_peak_memory_stats()
    with PassCount() as passes:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res, lp = nni_optimize(eng, start, want_lp=True,
                               max_rounds=NONREV_CLIMB_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
    passes.check(got, tag)
    add(launches, got)
    print(f"{tag} NNI climb from {n} random NNIs: {res.n_rounds} rounds, "
          f"{res.n_applied_total} swaps, logL {res.logL:.4f} in {wall:.1f} "
          f"s; launches {got}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if not (math.isfinite(res.logL) and np.isfinite(lp).all()):
        raise RuntimeError(f"{tag} climb logL {res.logL}")
    del eng
    torch.cuda.empty_cache()
    s_aln, s_tree, s_model, s_rates = kernelcheck.simulate(
        "UNREST+G4", CHECK_TAXA, NONREV_CUT_SITES, seed=1)
    for dtype in (torch.float32, torch.float64):
        lps = [LikelihoodEngine(s_aln, s_model, s_rates, dtype=dtype,
                                device=dev).site_lp(s_tree)[1]
               for dev in ("cuda", "cpu")]
        err = kernelcheck.lp_error(torch.as_tensor(lps[0]),
                                   torch.as_tensor(lps[1]), dtype)
        tol = kernelcheck.TOLERANCE[dtype]["lp"]
        print(f"{tag} {CHECK_TAXA} x {NONREV_CUT_SITES} {str(dtype)[6:]}: "
              f"site logLs of the card against the plain path within "
              f"{err:.3e} (tol {tol:g})", flush=True)
        if not err <= tol:
            raise RuntimeError(f"{tag} site logLs differ by {err}")


def roottest_rows(prefix: Path) -> list:
    import csv
    with open(f"{prefix}.roottest.csv") as f:
        return list(csv.DictReader(f))


def nonrev_search() -> dict:
    """15c: example.phy -m UNREST+G -B 1000 --root-test (NONREV_DEPTH) in
    float32: phase 6's files, logL at least UNREST_TE_LOGL - 0.5, every
    kernel of the nonreversible path launched (down_pass with and without
    its epilogue, up_pass), .roottest.csv with ROOTTEST_ROWS rows whose
    rootstrap sums to 1 within 1e-9, .rooted.nwk. Returns the launches."""
    pre = OUT / "unrest_search"
    tag = "[phase 15c]"
    got = counted(["-s", str(GOLDEN / "example.phy"), "-m", "UNREST+G",
                   "-B", str(FLAGSHIP_REPLICATES), "--root-test"]
                  + NONREV_DEPTH + ["-pre", str(pre)], tag)
    bound = UNREST_TE_LOGL - 0.5
    logl = check_flagship(pre, bound)
    rows = roottest_rows(pre)
    total = sum(float(r["rootstrap"]) for r in rows)
    best = max(rows, key=lambda r: float(r["logL"]))
    print(f"{tag} logL {logl:.4f} (bound {bound:.4f}); root test: "
          f"{len(rows)} branches, best {best['Branch']} (logL "
          f"{best['logL']}, rootstrap {best['rootstrap']}), rootstrap sum "
          f"{total!r}; wall seconds: {wall_split(pre)}", flush=True)
    if len(rows) != ROOTTEST_ROWS or not abs(total - 1.0) <= 1e-9:
        raise RuntimeError(f"{tag} {len(rows)} rows, rootstrap sum {total}")
    if "__ROOT__" in Path(f"{pre}.rooted.nwk").read_text():
        raise RuntimeError(f"{tag} the pseudo-taxon is in .rooted.nwk")
    # the nonreversible Newton takes both passes and no theta
    if not all(got[k] > 0 for k in ("down_pass", "sitelp", "up_pass")):
        raise RuntimeError(f"{tag} a kernel was never launched: {got}")
    return got


def class_weights(prefix: Path) -> list[float]:
    """The proportions of the .iqtree's rate-category table."""
    text = Path(f"{prefix}.iqtree").read_text()
    table = text.split("Category  Relative_rate  Proportion")[1]
    return [float(m) for m in re.findall(r"^\s+\d+\s+[\d.]+\s+([\d.]+)$",
                                         table.split("\n\n")[0], re.M)]


def mixlen_search(launches: dict) -> None:
    """15d: example.phy -m GTR+H4 -B 1000 (NONREV_DEPTH) in float32: phase
    6's files with the search's own bound (the final per-class fit at
    least the search's logL - 1e-6), four class weights summing to 1."""
    pre = OUT / "h4_search"
    tag = "[phase 15d]"
    add(launches, counted(["-s", str(GOLDEN / "example.phy"), "-m",
                           "GTR+H4", "-B", str(FLAGSHIP_REPLICATES)]
                          + NONREV_DEPTH + ["-pre", str(pre)], tag))
    searched = float(re.search(r"Search done: .* best logL (-?[\d.]+)",
                               log_lines(pre)).group(1))
    logl = check_flagship(pre, searched - 1e-6)
    w = class_weights(pre)
    print(f"{tag} search logL {searched:.4f}, final per-class fit "
          f"{logl:.4f}, class weights {w} (sum {sum(w):.4f}); wall "
          f"seconds: {wall_split(pre)}", flush=True)
    if len(w) != 4 or not abs(sum(w) - 1.0) <= 2e-4:
        raise RuntimeError(f"{tag} class weights {w}")


def family_te(launches: dict) -> None:
    """15e: -m GTR+P (PoMo, 52 states) and -m 3.3b+G (Lie-Markov) -te on
    the golden tree in float64 on the card: each logL within CARD_CPU_TOL
    of the port's CPU evaluation of the same tree and parameters."""
    import torch
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    for model in ("GTR+P", "3.3b+G"):
        keep: dict = {}
        tag = f"[phase 15e {model}]"
        pre = OUT / f"te_{model.replace('+', '_')}"
        add(launches, counted(
            ["-s", str(GOLDEN / "example.phy"), "-m", model, "-te",
             str(GOLDEN / "ref_tree.nwk"), "--f64", "-pre", str(pre)], tag,
            runner=lambda a: run_analysis(a, keep)))
        cpu = LikelihoodEngine(keep["aln"], keep["model"], keep["rates"],
                               dtype=torch.float64, device="cpu"
                               ).loglik_tree(keep["tree"])
        print(f"{tag} card f64 logL {keep['logL']:.6f}, the CPU's at the "
              f"same tree and parameters {cpu:.6f} (tol {CARD_CPU_TOL:g})",
              flush=True)
        if not abs(keep["logL"] - cpu) <= CARD_CPU_TOL:
            raise RuntimeError(f"{tag} card {keep['logL']} != CPU {cpu}")


def treemix_te(launches: dict) -> None:
    """15f: example.phy -m GTR+G+T -te with the golden tree and one NNI
    from it: EM's logL never falls between iterations, the weights sum to
    1."""
    import numpy as np
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.io.alignment_io import read_alignment
    from iqtree2_tpu_torch.tree.topology import Tree
    aln = read_alignment(str(GOLDEN / "example.phy"))
    tree = Tree.from_newick((GOLDEN / "ref_tree.nwk").read_text(), aln.names)
    other, _ = kernelcheck.perturbed(tree, seed=1, strength=1 / 14)
    two = OUT / "two_trees.nwk"
    two.write_text(tree.to_newick() + "\n" + other.to_newick() + "\n")
    keep: dict = {}
    pre = OUT / "treemix"
    tag = "[phase 15f]"
    add(launches, counted(["-s", str(GOLDEN / "example.phy"), "-m",
                           "GTR+G+T", "-te", str(two), "-pre", str(pre)],
                          tag, runner=lambda a: run_analysis(a, keep)))
    em = [float(x) for x in re.findall(r"EM iter \d+: logL (-?[\d.]+)",
                                       log_lines(pre))]
    w = keep["weights"]
    print(f"{tag} EM logLs {em}, weights {w}", flush=True)
    if len(em) < 2 or any(b < a - 1e-3 for a, b in zip(em, em[1:])) or \
            not abs(sum(w) - 1.0) <= 1e-9 or \
            not np.isfinite(keep["logL"]):
        raise RuntimeError(f"{tag} EM {em}, weights {w}")


def mdef_nonrev(launches: dict) -> None:
    """15g: a --mdef model with reversible: false and the same matrix as
    -m UNREST{...}, -te on example.phy in float64: equal logLs within
    MDEF_NONREV_TOL relative."""
    defs = OUT / "nonrev.yml"
    defs.write_text("- model: MYNONREV\n  datatype: DNA\n"
                    "  reversible: false\n  matrix: ["
                    + ", ".join("[" + ", ".join(str(v) for v in row) + "]"
                                for row in MDEF_NONREV_MATRIX) + "]\n")
    rates = [v for i, row in enumerate(MDEF_NONREV_MATRIX)
             for j, v in enumerate(row) if i != j]
    logls = {}
    for model, extra in (("MYNONREV+G", ["--mdef", str(defs)]),
                         ("UNREST{" + ",".join(str(r) for r in rates)
                          + "}+G", [])):
        pre = OUT / f"nonrev_{'yaml' if extra else 'unrest'}"
        add(launches, counted(extra + [
            "-s", str(GOLDEN / "example.phy"), "-m", model, "-te",
            str(GOLDEN / "ref_tree.nwk"), "--f64", "-pre", str(pre)],
            f"[phase 15g {model} f64]"))
        logls[model] = report_logl(pre)
    a, b = logls.values()
    print(f"[phase 15g] {logls}; relative difference "
          f"{abs(a - b) / abs(b):.3e} (tol {MDEF_NONREV_TOL:g})", flush=True)
    if not abs(a - b) <= MDEF_NONREV_TOL * abs(b):
        raise RuntimeError(f"[phase 15g] the YAML model and UNREST differ: "
                           f"{logls}")


def nonrev_families(errors: dict, parts: str = "abcdefg"
                    ) -> tuple[dict, list, dict]:
    """Phase 15's parts; returns the launches of 15b and 15d-g, 15a's rows
    and 15c's search launches."""
    launches: dict = {}
    search: dict = {}
    rows = (kernel_rows(NONREV_CHECKS, "15a", errors,
                        not_indicators=("GTR+P+G4",))
            if "a" in parts else [])
    if "b" in parts:
        nonrev_wide(launches)
    if "c" in parts:
        search = nonrev_search()
    if "d" in parts:
        mixlen_search(launches)
    if "e" in parts:
        family_te(launches)
    if "f" in parts:
        treemix_te(launches)
    if "g" in parts:
        mdef_nonrev(launches)
    return launches, rows, search


def tools_alisim() -> None:
    """16a: --alisim on the golden tree under each of ALISIM_CASES, every
    output read back by the port's reader with the tree's taxa, the sites
    and the sequence type."""
    from iqtree2_tpu_torch.io.alignment_io import read_alignment
    names = set(Path(GOLDEN / "ref_tree.nwk").read_text()
                .replace("(", ",").replace(")", ",").split(","))
    for i, (name, flags, suffix, seqtype, nsites) in enumerate(ALISIM_CASES):
        pre = OUT / f"alisim_{i}"
        wall = run_cli(["--alisim", str(pre), "-t",
                        str(GOLDEN / "ref_tree.nwk")] + flags)
        aln = read_alignment(f"{pre}{suffix}", seqtype=seqtype)
        taxa = {n.split(":")[0] for n in names} & set(aln.names)
        print(f"[phase 16a] --alisim {name}: {aln.ntaxa} x {aln.nsites} "
              f"{aln.seqtype.name} ({aln.num_patterns} patterns) in "
              f"{wall:.2f} s", flush=True)
        if len(taxa) != 17 or aln.ntaxa != 17 or \
                aln.seqtype.name != seqtype or \
                (nsites is not None and aln.nsites != nsites):
            raise RuntimeError(f"[phase 16a] {name}: {aln.ntaxa} taxa, "
                               f"{aln.nsites} sites, {aln.seqtype.name}")


def tools_dating() -> dict:
    """16b: tip dates of a strict clock at DATE_RATE on the golden tree
    rooted at its midpoint (kernelcheck.clock_dates), 1998 sites simulated
    under GTR+G on it, then the search with UFBoot and --date --date-ci
    in float32, launches counted (one per pass): every kernel launched,
    the three .timetree files parsed, the rate within DATE_RATE_TOL of
    DATE_RATE, the failed replicates printed. Returns the launches."""
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.tree.topology import Tree
    tag = "[phase 16b]"
    ref = GOLDEN / "ref_tree.nwk"
    dates = kernelcheck.clock_dates(Tree.from_newick(ref.read_text()),
                                    DATE_RATE)
    dfile = OUT / "dates.txt"
    dfile.write_text("".join(f"{n} {d!r}\n" for n, d in dates.items()))
    sim = OUT / "date_sim"
    run_cli(["--alisim", str(sim), "-t", str(ref), "-m", "GTR+G",
             "--length", "1998"])
    pre = OUT / "dating"
    got = counted(["-s", f"{sim}.phy", "-m", "GTR+G", "-B",
                   str(FLAGSHIP_REPLICATES)] + DATE_DEPTH
                  + ["--date", str(dfile), "--date-ci", str(DATE_CI_REPS),
                     "-pre", str(pre)], tag)
    if not all(got[k] > 0 for k in ("down_pass", "sitelp", "up_pass",
                                    "theta_pass")):
        raise RuntimeError(f"{tag} a kernel was never launched: {got}")
    names = list(dates)
    timed = Tree.from_newick(Path(f"{pre}.timetree.nwk").read_text(), names)
    nex = Path(f"{pre}.timetree.nex").read_text()
    lsd = Path(f"{pre}.timetree.lsd").read_text()
    rate = float(re.search(r"^rate (\S+?),", lsd, re.M).group(1))
    failed = re.search(r"^failed replicates: (\d+) of (\d+)$", lsd, re.M)
    root = re.search(r"^tMRCA (\S+?),", lsd, re.M).group(1)
    print(f"{tag} rate {rate!r} (clock {DATE_RATE}), root date {root}, "
          f"{lsd.splitlines()[1]}; failed replicates {failed.group(1)} of "
          f"{failed.group(2)}; time tree {timed.ntaxa} taxa, "
          f"{nex.count('[&date=')} dated nodes in the NEXUS; wall seconds: "
          f"{wall_split(pre)}", flush=True)
    if timed.ntaxa != 17 or nex.count("[&date=") != 2 * 17 - 1 or \
            int(failed.group(2)) != DATE_CI_REPS:
        raise RuntimeError(f"{tag} the time tree files are incomplete")
    if not (math.isfinite(rate) and rate > 0
            and abs(rate - DATE_RATE) <= DATE_RATE_TOL * DATE_RATE):
        raise RuntimeError(f"{tag} rate {rate} against {DATE_RATE}")
    return got


def lmap_problem(device: str, dtype: str):
    """16c's engine: example.phy under GTR+G4 with every parameter fixed
    (kernelcheck.MODELS), so both sides share them."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.io.alignment_io import read_alignment
    from iqtree2_tpu_torch.model.factory import build_model
    aln = read_alignment(str(GOLDEN / "example.phy"))
    model, rates, _ = build_model(kernelcheck.MODELS["GTR+G4"][2], aln)
    return LikelihoodEngine(aln, model, rates,
                            dtype=getattr(torch, dtype), device=device)


def lmap_weights(device: str, dtype: str) -> dict:
    """16c's likelihood mapping of LMAP_QUARTETS quartets (seed 1) on
    ``device``: the weights and its wall seconds."""
    import numpy as np
    from iqtree2_tpu_torch.ops import quartet
    eng = lmap_problem(device, dtype)
    t0 = time.perf_counter()
    res = quartet.likelihood_mapping(eng, LMAP_QUARTETS,
                                     np.random.default_rng(1))
    return {"weights": res["weights"].tolist(),
            "regions": res["regions"].tolist(),
            "seconds": time.perf_counter() - t0}


def start_cpu_lmap(threads: int = 2) -> subprocess.Popen:
    """16c's CPU side (float64) in a process of its own on ``threads`` CPU
    threads, beside phases 2-15 (it takes minutes there)."""
    import os
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    return subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke, torch; "
         f"torch.set_num_threads({threads}); "
         "print(json.dumps(chip_smoke.lmap_weights('cpu', 'float64')))"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def tools_lmap(cpu: subprocess.Popen) -> None:
    """16c: likelihood mapping on a float32 card engine (its float64 view)
    against a CPU float64 engine at the same parameters: weights within
    LMAP_TOL; a quartet's region may differ only where the CPU weights lie
    within LMAP_TOL of a region boundary (a move of one weight by LMAP_TOL
    changes the region)."""
    import numpy as np
    import torch
    from iqtree2_tpu_torch.ops import quartet
    tag = "[phase 16c]"
    card = lmap_weights("cuda", "float32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stdout, stderr = cpu.communicate(timeout=900)
    waited = time.perf_counter() - t0
    if cpu.returncode != 0:
        raise RuntimeError(f"{tag} the CPU mapping failed: {stderr[-2000:]}")
    host = json.loads(stdout.strip().splitlines()[-1])
    w, hw = np.asarray(card["weights"]), np.asarray(host["weights"])
    err = float(np.abs(w - hw).max())
    moved = sum(quartet.region_of(a) != quartet.region_of(b)
                for a, b in zip(w, hw))
    steps = np.concatenate([np.eye(3), -np.eye(3)]) * LMAP_TOL
    near = sum(any(quartet.region_of(v + d) != quartet.region_of(v)
                   for d in steps) for v in hw)
    print(f"{tag} {LMAP_QUARTETS} quartets: card {card['seconds']:.2f} s, "
          f"regions {card['regions']}; CPU f64 {host['seconds']:.1f} s "
          f"(waited {waited:.1f} s), regions {host['regions']}; max weight "
          f"error {err:.3e} (tol {LMAP_TOL:g}); {moved} quartets in another "
          f"region, {near} near a boundary", flush=True)
    if not err <= LMAP_TOL or moved > near:
        raise RuntimeError(f"{tag} the card's mapping disagrees")


def tools_sankoff() -> None:
    """16d: Sankoff parsimony of example.phy on the golden tree on the
    card, equal to the host score under each of SANKOFF_COSTS."""
    import numpy as np
    import torch
    from iqtree2_tpu_torch.io.alignment_io import read_alignment
    from iqtree2_tpu_torch.ops import pars
    from iqtree2_tpu_torch.tree.topology import Tree
    aln = read_alignment(str(GOLDEN / "example.phy"))
    tree = Tree.from_newick((GOLDEN / "ref_tree.nwk").read_text(), aln.names)
    for name, cost in SANKOFF_COSTS.items():
        args = (aln.tip_codes(), aln.pattern_weights,
                np.asarray(cost, np.float64), aln.seqtype.tip_table)
        t0 = time.perf_counter()
        card = pars.sankoff_score_device(tree, *args, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = pars.sankoff_score(tree, *args)
        t2 = time.perf_counter()
        print(f"[phase 16d] Sankoff ({name}): card {card!r} in "
              f"{t1 - t0:.3f} s, host {host!r} in {t2 - t1:.3f} s",
              flush=True)
        if card != host or not host < 2 ** 24:
            raise RuntimeError(f"[phase 16d] {name}: {card} != {host}")


def tools_cli() -> None:
    """16e: -r, -con on 16b's replicate trees, -rf_all on RF_TREES of
    them, -pd and -bud on the golden tree, each file checked."""
    from iqtree2_tpu_torch.tree.topology import Tree
    tag = "[phase 16e]"
    ref = str(GOLDEN / "ref_tree.nwk")
    boots = OUT / "rf_trees.nwk"
    boots.write_text("\n".join(Path(f"{OUT / 'dating'}.ufboot").read_text()
                               .splitlines()[:RF_TREES]) + "\n")
    walls = {"-r": run_cli(["-r", str(RANDOM_TAXA), "-pre",
                            str(OUT / "random")]),
             "-con": run_cli(["-con", f"{OUT / 'dating'}.ufboot", "-pre",
                              str(OUT / "con")]),
             "-rf_all": run_cli(["-rf_all", "-t", str(boots), "-pre",
                                 str(OUT / "rf")]),
             "-pd": run_cli(["-pd", str(PD_K), "-t", ref, "-pre",
                             str(OUT / "pd")]),
             "-bud": run_cli(["-bud", str(PD_BUDGET), "-t", ref, "-pre",
                              str(OUT / "bud")])}
    rnd = Tree.from_newick((OUT / "random.treefile").read_text())
    con = Tree.from_newick((OUT / "con.contree").read_text())
    rf = (OUT / "rf.rfdist").read_text().splitlines()
    D = [[int(x) for x in row.split()[1:]] for row in rf[1:]]
    pd_text = (OUT / "pd.pda").read_text()
    bud = (OUT / "bud.pda").read_text()
    print(f"{tag} walls (s) { {k: round(v, 2) for k, v in walls.items()} }; "
          f"random tree {rnd.ntaxa} taxa, consensus {con.ntaxa} taxa, RF "
          f"matrix {len(D)} x {len(D[0])} (max {max(map(max, D))}), "
          f"{pd_text.splitlines()[1]}, {bud.splitlines()[1]}", flush=True)
    if rnd.ntaxa != RANDOM_TAXA or con.ntaxa != 17 or \
            len(D) != RF_TREES or any(D[i][i] for i in range(len(D))) or \
            any(D[i][j] != D[j][i] for i in range(len(D))
                for j in range(i)) or f"k = {PD_K}" not in pd_text or \
            f"budget = {PD_BUDGET}" not in bud:
        raise RuntimeError(f"{tag} an output file is wrong")


def standalone_tools(cpu_lmap: subprocess.Popen, parts: str = "abcde"
                     ) -> dict:
    """Phase 16's parts, each timed; returns 16b's launches."""
    split = {}
    launches: dict = {}
    for part, fn in (("a", tools_alisim), ("b", tools_dating),
                     ("c", lambda: tools_lmap(cpu_lmap)),
                     ("d", tools_sankoff), ("e", tools_cli)):
        if part not in parts:
            continue
        t0 = time.perf_counter()
        got = fn()
        if part == "b":
            launches = got
        split[part] = round(time.perf_counter() - t0, 1)
    print(f"[phase 16] wall seconds by part {split}, in all "
          f"{sum(split.values()):.1f}", flush=True)
    return launches


def dist_dryrun(problem, errors: dict) -> None:
    """17a: dryrun_multichip on ``problem`` (phase 5's) over 2 gloo ranks
    on the one card and 1 NCCL rank, then the kernels against their plain
    versions at a rank's shapes, with their bounds and shares."""
    import numpy as np
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import PATTERN_PAD, LikelihoodEngine
    from iqtree2_tpu_torch.parallel import dryrun, shard
    for n, backend in ((2, "gloo"), (1, "nccl")):
        tag = f"[phase 17a] {n} rank{'s' * (n > 1)} over {backend}"
        t0 = time.perf_counter()
        reps = dryrun.dryrun_multichip(n, backend, "cuda", problem)
        r0 = reps[0]
        print(f"{tag} in {time.perf_counter() - t0:.1f} s, slices "
              f"{[r['slice'] for r in reps]}: logL sharded / unsharded "
              f"{r0['logL']} (|diff| {r0['logL_err']:.3e}); one step's "
              f"lengths |diff| {r0['blen_err']:.3e}, logLs "
              f"{r0['step_logL']}; RELL {r0['rell_err']:.3e} relative; NNI "
              f"logLs |diff| {r0['nni_err']:.3e}, lengths "
              f"{r0['nni_topt_err']:.3e}; sharded Newton round ms per rank "
              f"{[round(r['step_ms'], 3) for r in reps]}, unsharded "
              f"{r0['unsharded_step_ms']:.3f}; peak device memory GiB per "
              f"rank {[round(r['peak_gib'], 2) for r in reps]}; launches "
              f"per rank {[r['launches'] for r in reps]}", flush=True)
        for r in reps:
            if r["launches"] != DRYRUN_LAUNCHES:
                raise RuntimeError(f"{tag} rank {r['rank']}: launches "
                                   f"{r['launches']}, not one per pass")
    aln, tree, model, rates = problem
    Pp = -(-aln.num_patterns // PATTERN_PAD) * PATTERN_PAD
    per = shard.rank_bounds(Pp, 0, 2)[1]
    sub = aln.subset_sites(np.nonzero(aln.site_to_pattern < per)[0])
    eng = LikelihoodEngine(sub, model, rates, dtype=torch.float32,
                           device="cuda")
    tag = f"[phase 17a] a rank's slice {sub.ntaxa} x {sub.num_patterns}"
    res = check_kernels(tag, eng, tree, 1, errors, b2b_reps=SLICE_B2B_REPS)
    bnd = kernelcheck.bounds(eng, tree)
    shares = {r["name"]: (round(bnd[r["name"]]["bound_ms"], 6),
                          round(bnd[r["name"]]["bound_ms"] / r["b2b_ms"], 4))
              for r in res}
    print(f"{tag} (bound ms, share of the back-to-back time): {shares}",
          flush=True)


def cli_rank(args: list[str]) -> dict:
    """One rank of 17b's command line in this process: launches reset just
    before it and read just after, one per pass (PassCount)."""
    import torch
    from iqtree2_tpu_torch.ops import kernels
    torch.cuda.reset_peak_memory_stats()
    with PassCount() as passes:
        kernels.reset_launch_counts()
        wall = run_cli(args)
        launches = dict(kernels.LAUNCHES)
    passes.check(launches, "[phase 17b]")
    return {"wall": wall, "launches": launches,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def dist_cli_start(route: str, started: list) -> tuple:
    """17b's command line as two processes on the card: over FileGossip
    (``route`` "file": --dist-nranks 2 --dist-dir) or under torchrun's
    environment ("torchrun": TorchGossip on a gloo group). Returns what
    dist_cli_join reads."""
    from iqtree2_tpu_torch.parallel.dryrun import free_port
    gossip = OUT / "dist_gossip"
    # a fresh directory: an earlier run's round files would be read
    shutil.rmtree(gossip, ignore_errors=True)
    prefix = OUT / f"dist_{route}"
    args = (["-s", str(GOLDEN / "example.phy"), "-m", "GTR+G", "-B",
             str(FLAGSHIP_REPLICATES)] + DIST_DEPTH + ["-pre", str(prefix)])
    if route == "file":
        runs = [(args + ["--dist-nranks", "2", "--dist-dir", str(gossip),
                         "--dist-rank", str(k)], None) for k in range(2)]
    else:
        port = str(free_port())
        runs = [(args, {"MASTER_ADDR": "localhost", "MASTER_PORT": port,
                        "WORLD_SIZE": "2", "RANK": str(k)})
                for k in range(2)]
    procs = [start_part("cli_rank", a, env=e) for a, e in runs]
    started.extend(procs)
    return route, prefix, procs, time.perf_counter()


def dist_cli_join(run: tuple, g4: float) -> dict:
    """Join dist_cli_start's processes and check them: both ranks write
    the same tree under phase 6's checks, gossip over the route's
    transport and launch every kernel, one launch per pass (cli_rank).
    Returns the launches summed over the ranks."""
    from iqtree2_tpu_torch.tree.topology import Tree
    route, prefix, procs, t0 = run
    ranks = [join_part(p, f"[phase 17b {route}] rank {k}")
             for k, p in enumerate(procs)]
    wall = time.perf_counter() - t0
    names = Tree.from_newick((GOLDEN / "ref_tree.nwk").read_text(),
                             None).taxon_names
    prefixes = [prefix, Path(f"{prefix}.rank1")]
    logls = [check_flagship(pre, g4 - 0.5) for pre in prefixes]
    splits = [set(Tree.from_newick(Path(f"{pre}.treefile").read_text(),
                                   names).splits()) for pre in prefixes]
    gossips = [re.search(r"Distributed search: rank .*", log_lines(pre))
               for pre in prefixes]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    flags = "--dist-nranks 2" if route == "file" else "WORLD_SIZE=2"
    print(f"[phase 17b] -m GTR+G -B {FLAGSHIP_REPLICATES} "
          f"{' '.join(DIST_DEPTH)} {flags} f32: {wall:.1f} s for both "
          f"processes, CLI walls {[round(r['wall'], 1) for r in ranks]} s; "
          f"{[g and g.group(0) for g in gossips]}; logLs {logls} (bound "
          f"{g4 - 0.5:.4f}); the same splits {splits[0] == splits[1]}; "
          f"peak GiB {[round(r['peak_gib'], 2) for r in ranks]}; launches "
          f"per rank {[r['launches'] for r in ranks]}; wall seconds: "
          f"{[wall_split(pre) for pre in prefixes]}", flush=True)
    want = "FileGossip" if route == "file" else "torch.distributed"
    if not all(g and want in g.group(0) for g in gossips):
        raise RuntimeError(f"[phase 17b {route}] the ranks did not gossip "
                           f"over {want}: {gossips}")
    if splits[0] != splits[1]:
        raise RuntimeError(f"[phase 17b {route}] the ranks wrote different "
                           f"trees")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"[phase 17b {route}] a kernel of the path was "
                           f"never launched: {launches}")
    return launches


def dist_search() -> None:
    """17c: DistributedSearch at 1 rank (this process, FileGossip) and at 2
    spawned ranks over gloo at the flagship's shapes (example.phy, GTR+G4
    of kernelcheck.MODELS, float32): the same topology, logL within
    DIST_SEARCH_REL relative."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.parallel import dryrun
    from iqtree2_tpu_torch.parallel.multihost import (DistributedSearch,
                                                      FileGossip)
    problem = kernelcheck.load_problem(GOLDEN / "example.phy",
                                       GOLDEN / "ref_tree.nwk", "GTR+G4")
    aln, _, model, rates = problem
    eng = LikelihoodEngine(aln, model, rates, device="cuda")
    one = OUT / "dist_one"
    shutil.rmtree(one, ignore_errors=True)
    t0 = time.perf_counter()
    tree, logl = DistributedSearch(eng, aln, FileGossip(one, 0, 1), 0, 1,
                                   **DIST_SEARCH).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reps = dryrun.search_multichip(2, "gloo", "cuda", problem,
                                   **DIST_SEARCH)
    diffs = [r["logL"] - logl for r in reps]
    same = [r["tid"] == tree.topology_id() for r in reps]
    split = [{k: round(v, 3) for k, v in r["seconds"].items()} for r in reps]
    print(f"[phase 17c] DistributedSearch {DIST_SEARCH} f32: 1 rank logL "
          f"{logl:.6f} in {wall:.2f} s; 2 ranks over gloo logL - 1 rank's "
          f"{diffs}, the same topology {same}, walls "
          f"{[round(r['wall'], 2) for r in reps]} s, split {split}, "
          f"launches {[r['launches'] for r in reps]}", flush=True)
    if not all(same) or max(map(abs, diffs)) > DIST_SEARCH_REL * abs(logl):
        raise RuntimeError(f"[phase 17c] 2 ranks differ from 1: {same}, "
                           f"{diffs}")


def distributed(problem, g4: float, errors: dict, started: list,
                parts: str = "abc") -> dict:
    """Phase 17's parts (a, b, c); returns 17b's launches (empty without
    b). 17b's torchrun pair runs beside 17c, for the phase's time."""
    t0 = time.perf_counter()
    launches: dict = {}
    if "a" in parts:
        dist_dryrun(problem, errors)
    if "b" in parts:
        add(launches, dist_cli_join(dist_cli_start("file", started), g4))
        torchrun = dist_cli_start("torchrun", started)
    if "c" in parts:
        dist_search()
    if "b" in parts:
        add(launches, dist_cli_join(torchrun, g4))
    print(f"[phase 17] {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def pomo_wide(errors: dict) -> dict:
    """18b: POMO_TAXA x POMO_SITES simulated under GTR+G4 and fitted under
    POMO_CHECK (kernelcheck.MODELS' fixed parameters, 112 states) in
    float32: one logL, one nonreversible Newton round (both passes and the
    direct derivatives per edge) with its ms and peak device memory, the
    NNI5 scores of POMO_NNI_CANDIDATES candidates (each chunk of candidates
    takes what a whole round's chunks take) with the peak device memory
    below MAX_CLIMB_GIB, one launch per pass; then each kernel against its
    plain version at those shapes. Returns kernelcheck.check's rows by
    name, each with its bound."""
    import numpy as np
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.ops import kernels
    from iqtree2_tpu_torch.ops.nni import build_nni_candidates
    from iqtree2_tpu_torch.tree.schedule import build_schedule
    tag = "[phase 18b]"
    t0 = time.perf_counter()
    aln, tree, model, rates = kernelcheck.simulate(POMO_CHECK, POMO_TAXA,
                                                   POMO_SITES, seed=1)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                           device="cuda")
    print(f"{tag} simulated {POMO_TAXA} x {POMO_SITES} under GTR+G4, "
          f"{eng.Pp} patterns under {POMO_CHECK} (S = "
          f"{eng._tipP.shape[1]}), in {time.perf_counter() - t0:.1f} s",
          flush=True)
    eng.loglik_tree(tree)                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logl0 = eng.loglik_tree(tree)
    lg_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with PassCount() as passes:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logl = eng.optimize_branches(tree, n_rounds=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
    passes.check(got, tag)
    round_ms = (wall - passes.calls["sitelp"] * lg_s) * 1e3
    print(f"{tag} f32 logL {logl0:.4f} ({lg_s * 1e3:.2f} ms) -> {logl:.4f} "
          f"after one nonreversible Newton round in {wall:.3f} s "
          f"({passes.calls['sitelp']} logLs): {round_ms:.2f} ms without its "
          f"logLs; launches {got}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if not (math.isfinite(logl) and logl >= logl0 - 1e-3
            and got["up_pass"] == 1):
        raise RuntimeError(f"{tag} logL {logl0} -> {logl}, launches {got}")
    sched = build_schedule(tree)
    cand = build_nni_candidates(tree, sched)
    ca = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id]
                  )[:, :POMO_NNI_CANDIDATES]
    torch.cuda.reset_peak_memory_stats()
    with PassCount() as passes:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        scores = eng.evaluate_nni_batch(sched, ca, nni5=True)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
    passes.check(got, tag)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} NNI5 scores of {ca.shape[1]} candidates in {wall:.2f} s "
          f"(both passes, then the candidates in chunks of "
          f"ops/nni.CHUNK_BYTES): launches {got}; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    if not (np.isfinite(scores).all() and peak < MAX_CLIMB_GIB):
        raise RuntimeError(f"{tag} NNI5 scores {scores}, peak {peak}")
    res = check_kernels(f"{tag} {POMO_CHECK}", eng, tree, 1, errors,
                        window=kernelcheck.plain_window(eng), b2b_reps=2)
    bnd = kernelcheck.bounds(eng, tree)
    print(f"{tag} bounds (ms): "
          f"{ {k: round(v['bound_ms'], 6) for k, v in bnd.items()} }",
          flush=True)
    return {r["name"]: {**r, **bnd[r["name"]]} for r in res}


def pomo_search(bound: float, errors: dict) -> dict:
    """18c: example.phy -m POMO_MODEL -B 1000 (POMO_DEPTH) in float32:
    phase 6's files, logL at least ``bound``, down_pass with and without
    its epilogue and up_pass launched (PoMo takes the nonreversible Newton:
    both passes, no theta), one launch per pass; then the kernels against
    their plain versions at its shapes (the search's tree, POMO_CHECK's
    fixed parameters; untimed: it runs beside 14b-f). Returns the
    launches."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    pre = OUT / "pomo_search"
    tag = "[phase 18c]"
    got = counted(["-s", str(GOLDEN / "example.phy"), "-m", POMO_MODEL,
                   "-B", str(FLAGSHIP_REPLICATES)] + POMO_DEPTH
                  + ["-pre", str(pre)], tag)
    logl = check_flagship(pre, bound)
    print(f"{tag} logL {logl:.4f} (bound {bound:.4f}); wall seconds: "
          f"{wall_split(pre)}", flush=True)
    if not all(got[k] > 0 for k in ("down_pass", "sitelp", "up_pass")):
        raise RuntimeError(f"{tag} a kernel was never launched: {got}")
    p_aln, p_tree, p_model, p_rates = kernelcheck.load_problem(
        GOLDEN / "example.phy", f"{pre}.treefile", POMO_CHECK)
    check_kernels(f"{tag} {POMO_CHECK} search's tree",
                  LikelihoodEngine(p_aln, p_model, p_rates,
                                   dtype=torch.float32, device="cuda"),
                  p_tree, 0, errors)
    return got


def pomo_te(dtype: str) -> float:
    """18d: -m POMO_MODEL -te on the golden tree on the card, its logL
    (float64: within CARD_CPU_TOL of the port's CPU evaluation of the same
    tree and parameters; no fit runs on the CPU). Returns the logL."""
    import torch
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    keep: dict = {}
    tag = f"[phase 18d {dtype}]"
    pre = OUT / f"pomo_te_{dtype}"
    counted(["-s", str(GOLDEN / "example.phy"), "-m", POMO_MODEL, "-te",
             str(GOLDEN / "ref_tree.nwk"), "-pre", str(pre)]
            + (["--f64"] if dtype == "float64" else []), tag,
            runner=lambda a: run_analysis(a, keep))
    if dtype != "float64":
        print(f"{tag} card logL {keep['logL']:.4f}", flush=True)
        return keep["logL"]
    t0 = time.perf_counter()
    cpu = LikelihoodEngine(keep["aln"], keep["model"], keep["rates"],
                           dtype=torch.float64, device="cpu"
                           ).loglik_tree(keep["tree"])
    print(f"{tag} card logL {keep['logL']:.6f}, the CPU's at the same tree "
          f"and parameters {cpu:.6f} in {time.perf_counter() - t0:.1f} s "
          f"(tol {CARD_CPU_TOL:g})", flush=True)
    if not abs(keep["logL"] - cpu) <= CARD_CPU_TOL:
        raise RuntimeError(f"{tag} card {keep['logL']} != CPU {cpu}")
    return keep["logL"]


def mdef_wide(errors: dict) -> dict:
    """18e: MDEF_WIDE_TAXA x MDEF_WIDE_SITES simulated under MK65+G4 (a
    65-state --mdef datatype), then --mdef ... -st STATES65 -m MK+G -te on
    its tree in float32: past the joint fit's guard, so the host
    alternation's Newton rounds run theta_pass; a finite logL, down_pass
    with its epilogue and theta_pass launched, one launch per pass; then
    the kernels against their plain versions at its shapes (untimed: it
    runs beside 14b-f) and their bounds. Returns the launches."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    tag = "[phase 18e]"
    t0 = time.perf_counter()
    aln, tree, model, rates = kernelcheck.simulate(
        "MK65+G4", MDEF_WIDE_TAXA, MDEF_WIDE_SITES, seed=1)
    phy, nwk = kernelcheck.write_problem(aln, tree, OUT / "states65")
    defs = OUT / "states65.yml"
    defs.write_text(kernelcheck.YAML_DATATYPES["STATES65"])
    print(f"{tag} simulated {aln.ntaxa} x {aln.nsites} ({aln.num_patterns} "
          f"patterns) in {time.perf_counter() - t0:.1f} s", flush=True)
    pre = OUT / "states65_te"
    got = counted(["--mdef", str(defs), "-s", phy, "-st", "STATES65", "-m",
                   "MK+G", "-te", nwk, "-pre", str(pre)], tag)
    logl = report_logl(pre)
    print(f"{tag} logL {logl:.4f}", flush=True)
    if not (math.isfinite(logl)
            and all(got[k] > 0 for k in ("down_pass", "sitelp",
                                         "theta_pass"))):
        raise RuntimeError(f"{tag} logL {logl}, launches {got}")
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                           device="cuda")
    check_kernels(f"{tag} MK65+G4", eng, tree, 0, errors,
                  window=kernelcheck.plain_window(eng))
    bound = kernelcheck.bounds(eng, tree)
    print(f"{tag} MK65+G4 Pp={eng.Pp} bounds (ms): "
          f"{ {k: (round(v['bound_ms'], 6), v['bound_by']) for k, v in bound.items()} }",
          flush=True)
    return got


def wide_states(errors: dict, parts: str = "abcde",
                te_bound: float | None = None) -> tuple[dict, dict]:
    """Phase 18's parts: 18a, the wide instance against the plain versions
    on WIDE_CHECKS (PoMo's sampled-read tips, not indicator rows), then
    18b-e. Returns 18b's kernel rows and the launches of 18c and 18e (the
    wide instance's paths), summed. 18c is bounded by POMO_TE_LOGL - 0.5,
    or te_bound where given."""
    t0 = time.perf_counter()
    if "a" in parts:
        kernel_rows(WIDE_CHECKS, "18a", errors,
                    not_indicators=[name for name, *_ in WIDE_CHECKS])
    timed = pomo_wide(errors) if "b" in parts else {}
    launches: dict = {}
    if "c" in parts:
        add(launches, pomo_search(
            (POMO_TE_LOGL if te_bound is None else te_bound) - 0.5, errors))
    if "d" in parts:
        pomo_te("float64")
    if "e" in parts:
        add(launches, mdef_wide(errors))
    print(f"[phase 18] {time.perf_counter() - t0:.1f} s", flush=True)
    return timed, launches


def run_cli(args: list[str]) -> float:
    """One run of the port's command line; returns its wall seconds."""
    import torch
    from iqtree2_tpu_torch import cli
    t0 = time.perf_counter()
    rc = cli.main(args + ["--device", "cuda", "-redo", "--quiet"])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"CLI returned {rc}: {args}")
    return time.perf_counter() - t0


def check_kernels(tag: str, eng, tree, time_reps: int, errors: dict,
                  **check_kw) -> list:
    """kernelcheck.check on one problem (check_kw: its window and
    b2b_reps; time_reps 0 times nothing); prints one line per kernel,
    keeps the largest absolute error per kernel in ``errors``, raises on a
    disagreement."""
    import torch
    from iqtree2_tpu_torch import kernelcheck
    res = kernelcheck.check(eng, tree, time_reps=time_reps, **check_kw)
    torch.cuda.synchronize()
    for r in res:
        extra = times = ""
        if time_reps:
            times = (f" kernel {r['ms']:.4f} ms, back to back "
                     f"{r['b2b_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
        if "lp_err" in r:
            extra = f" lp_err {r['lp_err']:.3e} (tol {r['lp_tol']:g})"
            if time_reps:
                extra += (f"; with the epilogue kernel {r['sitelp_ms']:.4f} "
                          f"ms, back to back {r['sitelp_b2b_ms']:.4f} ms, "
                          f"plain {r['sitelp_plain_ms']:.4f} ms")
        print(f"{tag} {str(eng.dtype)[6:]} Pp={eng.Pp} {r['name']}: "
              f"max_abs_err {r['max_abs_err']:.3e} max_rel_err "
              f"{r['max_rel_err']:.3e} (tol {r['tol']:g}) scales_equal "
              f"{r['scales_equal']}{times}{extra}", flush=True)
        if not r["ok"]:
            raise RuntimeError(f"{r['name']} disagrees with its plain "
                               f"version ({tag}, {eng.dtype}): {r}")
        errors[r["name"]] = max(errors[r["name"]], r["max_abs_err"])
    return res


def main() -> int:
    started: list = []
    try:
        return run(started)
    finally:
        for proc in started:
            proc.kill()
            proc.wait()


def run(started: list) -> int:
    """Phases 1-18; each process it starts goes into ``started``."""
    if not (ROOT / "iqtree2_tpu_torch").is_dir() or not GOLDEN.is_dir():
        return fail("run from the root of a checkout of the repository "
                    "(iqtree2_tpu_torch/ and tests/golden/ are missing)")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from iqtree2_tpu_torch import kernelcheck
    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.io.alignment_io import write_phylip
    from iqtree2_tpu_torch.ops import kernels
    from iqtree2_tpu_torch.tree.topology import Tree

    OUT.mkdir(parents=True, exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    def stamp(phase) -> None:
        print(f"[time] phase {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"[phase 1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {kind}", flush=True)
    # phase 13e's CPU side: the plain versions' fit takes minutes, so it
    # runs beside phases 2-13 in a process of its own
    cpu_fit = start_cpu_weights_fit()
    started.append(cpu_fit)
    cpu_lmap = start_cpu_lmap()
    started.append(cpu_lmap)

    stamp(2)
    # 2. build
    t0 = time.perf_counter()
    kernels.library()
    print(f"[phase 2] built {kernels.build_library().name} from {SOURCE} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for C in (1, 4, 10):
        occ = {f"{kind} S={S} {str(dtype)[6:]}": kernels.pass_occupancy(
            kind, dtype, C, S, BIG_SITES)
            for S in (4, 20, 112, 454)
            for dtype in (torch.float32, torch.float64)
            for kind in kernels.PASS_KINDS}
        print(f"[phase 2] C={C}, {BIG_SITES} patterns: (blocks per SM, "
              f"shared bytes per block) {occ}", flush=True)
        if min(b for b, _ in occ.values()) < 1:
            return fail(f"a pass instance fits no block on an SM: {occ}")
    torch.cuda.synchronize()

    stamp(3)
    # 3. kernel vs plain on the card
    errors = {k: 0.0 for k in REPLACES}
    for name in CHECK_MODELS:
        aln, tree, model, rates = kernelcheck.simulate(
            name, CHECK_TAXA, CHECK_SITES, seed=1)
        for dtype in (torch.float32, torch.float64):
            eng = LikelihoodEngine(aln, model, rates, dtype=dtype,
                                   device="cuda")
            check_kernels(f"[phase 3] {name}", eng, tree, CHECK_REPS,
                          errors)
            c_bound = kernelcheck.bounds(eng, tree)
            print(f"[phase 3] {name} {str(dtype)[6:]} C="
                  f"{eng._pack['cat_rate'].shape[0]} bounds (ms): "
                  f"{ {k: round(v['bound_ms'], 6) for k, v in c_bound.items()} }",
                  flush=True)

    stamp(4)
    # 4. the golden run: GTR+G fitted on example.phy + ref_tree.nwk
    ref = json.loads((GOLDEN / "golden.json").read_text())["logL"]
    g4 = ref["g4_gtrg_opt"]
    gargs = ["-s", str(GOLDEN / "example.phy"), "-m", "GTR+G",
             "-te", str(GOLDEN / "ref_tree.nwk")]
    kernels.reset_launch_counts()
    wall = run_cli(gargs + ["--f64", "-pre", str(OUT / "golden_f64")])
    launches = dict(kernels.LAUNCHES)
    logl64 = report_logl(OUT / "golden_f64")
    print(f"[phase 4] golden f64: logL {logl64:.4f} (reference {g4}) in "
          f"{wall:.1f} s; launches {launches} (joint fit)", flush=True)
    if not abs(logl64 - g4) <= 0.5:
        return fail(f"float64 golden logL {logl64} not within 0.5 of {g4}")
    wall = run_cli(gargs + ["-pre", str(OUT / "golden_f32")])
    logl32 = report_logl(OUT / "golden_f32")
    print(f"[phase 4] golden f32: logL {logl32:.4f} in {wall:.1f} s",
          flush=True)
    if not (math.isfinite(logl32) and abs(logl32 - g4) <= 10.0):
        return fail(f"float32 golden logL {logl32} not within 10 of {g4}")

    stamp(5)
    # 5. the main path at a realistic size, then the kernels at its shapes
    t0 = time.perf_counter()
    aln, tree, model, rates = kernelcheck.simulate(
        "GTR+G4", BIG_TAXA, BIG_SITES, seed=1)
    big = OUT / "big"
    aln_path, tree_path = kernelcheck.write_problem(aln, tree, big)
    print(f"[phase 5] simulated {aln.ntaxa} taxa x {aln.nsites} sites "
          f"({aln.num_patterns} patterns) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    with PassCount() as passes:
        kernels.reset_launch_counts()
        wall = run_cli(["-s", aln_path, "-m", "GTR+G", "-te", tree_path,
                        "-pre", str(big)])
        launches = dict(kernels.LAUNCHES)
    logl = report_logl(big)
    print(f"[phase 5] GTR+G fit f32: logL {logl:.4f} in {wall:.1f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; launches {launches}; passes {passes.calls}", flush=True)
    if not math.isfinite(logl):
        return fail(f"realistic-size logL is not finite: {logl}")
    # the fit runs log-likelihoods and Newton rounds, no NNI round's up_pass
    if not all(launches[k] > 0 for k in ("down_pass", "sitelp",
                                         "theta_pass")):
        return fail(f"a kernel of the path was never launched: {launches}")
    passes.check(launches, "[phase 5]")
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                           device="cuda")
    timed = {r["name"]: r for r in check_kernels(
        "[phase 5] GTR+G4", eng, tree, 3, errors)}
    bound = kernelcheck.bounds(eng, tree)
    print(f"[phase 5] buffers alone (ms): "
          f"{kernelcheck.time_buffers(eng, tree, 3)}; bounds (ms): "
          f"{ {k: round(v['bound_ms'], 6) for k, v in bound.items()} }",
          flush=True)

    stamp(6)
    # 6. the flagship: tree search with ultrafast bootstrap
    flag = OUT / "flagship"
    with PassCount() as passes:
        kernels.reset_launch_counts()
        wall = run_cli(["-s", str(GOLDEN / "example.phy"), "-m", "GTR+G",
                        "-bb", str(FLAGSHIP_REPLICATES), "-pre", str(flag)])
        launches = dict(kernels.LAUNCHES)
    logl = check_flagship(flag, g4 - 0.5)
    text = log_lines(flag)
    iters = re.search(r"Search done: (\d+) iterations", text).group(1)
    split = re.search(r"Wall seconds: (.*)", text).group(1)
    print(f"[phase 6] flagship -m GTR+G -bb {FLAGSHIP_REPLICATES} f32, "
          f"default settings: logL {logl:.4f} (bound {g4 - 0.5:.4f}) in "
          f"{wall:.1f} s, {iters} iterations; wall seconds: {split}; "
          f"launches down_pass {launches['down_pass']} (sitelp "
          f"{launches['sitelp']}), up_pass {launches['up_pass']}, "
          f"theta_pass {launches['theta_pass']}; passes {passes.calls}",
          flush=True)
    if not all(v > 0 for v in launches.values()):
        return fail(f"a kernel of the path was never launched: {launches}")
    passes.check(launches, "[phase 6]")
    for tag, f_path in (("reference tree", GOLDEN / "ref_tree.nwk"),
                        ("search's tree", Path(f"{flag}.treefile"))):
        f_aln, f_tree, f_model, f_rates = kernelcheck.load_problem(
            GOLDEN / "example.phy", f_path, "GTR+G4")
        f_eng = LikelihoodEngine(f_aln, f_model, f_rates,
                                 dtype=torch.float32, device="cuda")
        check_kernels(f"[phase 6] GTR+G4 {tag}", f_eng, f_tree, 3, errors)
        f_bound = kernelcheck.bounds(f_eng, f_tree)
        print(f"[phase 6] GTR+G4 {tag} bounds (ms): "
              f"{ {k: round(v['bound_ms'], 6) for k, v in f_bound.items()} }",
              flush=True)

    stamp(7)
    # 7. the NNI hill-climb at the realistic width
    start, n_moves = kernelcheck.perturbed(tree, seed=2, strength=0.02)
    polished = start.copy()
    l_start = eng.optimize_branches(polished)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rounds: list = []
    t0 = time.perf_counter()
    res, lp = climb(eng, start, rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    climb_launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[phase 7] NNI climb {aln.ntaxa} x {aln.nsites} f32 from "
          f"{n_moves} random NNIs: logL {res.logL:.4f} (start after "
          f"optimize_branches {l_start:.4f}), {res.n_rounds} rounds, "
          f"{res.n_applied_total} swaps, {wall:.2f} s; fused rounds s "
          f"{[round(r, 3) for r in rounds]}; peak device memory {peak:.2f} "
          f"GiB; launches {climb_launches}", flush=True)
    if not (math.isfinite(res.logL) and res.logL >= l_start):
        return fail(f"climb logL {res.logL} below the start {l_start}")
    if not (lp.shape == (aln.num_patterns,) and np.isfinite(lp).all()):
        return fail("climb site log-likelihoods are not finite")
    if not peak < MAX_CLIMB_GIB:
        return fail(f"climb peak device memory {peak:.2f} GiB")

    stamp(8)
    # 8. the default command: ModelFinder, then the search under the winner
    dflt = OUT / "default"
    with PassCount() as passes, ModelFinderSpy() as spy:
        kernels.reset_launch_counts()
        wall = run_cli(["-s", str(GOLDEN / "example.phy"),
                        "-bb", str(FLAGSHIP_REPLICATES)] + DEFAULT_DEPTH
                       + ["-pre", str(dflt)])
        main_launches = dict(kernels.LAUNCHES)
    mf = spy.result
    top = [(e["name"], round(e["BIC"], 3)) for e in mf["table"][:8]]
    search_launches = {k: main_launches[k] - spy.launches[k]
                       for k in main_launches}
    text = log_lines(dflt)
    print(f"[phase 8] default command -bb {FLAGSHIP_REPLICATES} f32: "
          f"winner {mf['best']} (expected {DEFAULT_WINNER}) in {wall:.1f} s; "
          f"ModelFinder wall seconds {mf['seconds']}; fits by route "
          f"{spy.routes}; {len(mf['table'])} candidates, top 8 by BIC {top}; "
          f"launches during ModelFinder {spy.launches}, during the search "
          f"{search_launches}; passes {passes.calls}; wall seconds: "
          f"{re.search(r'Wall seconds: (.*)', text).group(1)}", flush=True)
    if mf["best"] != DEFAULT_WINNER:
        return fail(f"ModelFinder picked {mf['best']} on example.phy, the "
                    f"JAX package {DEFAULT_WINNER}")
    report = Path(f"{dflt}.iqtree").read_text()
    if f"Best-fit model according to BIC: {DEFAULT_WINNER}" not in report \
            or "List of models sorted by BIC score:" not in report:
        return fail(f"{dflt}.iqtree holds no model-selection table")
    run_cli(["-s", str(GOLDEN / "example.phy"), "-m", DEFAULT_WINNER,
             "-te", str(GOLDEN / "ref_tree.nwk"), "--f64",
             "-pre", str(OUT / "winner_ref")])
    w_ref = report_logl(OUT / "winner_ref")
    logl = check_flagship(dflt, w_ref - 0.5)
    iters = re.search(r"Search done: (\d+) iterations", text).group(1)
    print(f"[phase 8] search under {DEFAULT_WINNER}: logL {logl:.4f} (the "
          f"reference tree's f64 fit {w_ref:.4f} - 0.5), {iters} "
          f"iterations", flush=True)
    if not all(v > 0 for v in search_launches.values()):
        return fail(f"a kernel of the path was never launched: "
                    f"{search_launches}")
    passes.check(main_launches, "[phase 8]")

    stamp(9)
    # 9. model selection at the realistic width, in a process of its own
    # beside phases 10 and 11 (host-paced fits on both sides)
    wide_proc = start_part("wide_selection", aln_path)
    started.append(wide_proc)

    stamp(10)
    # 10. the branch supports, tree tests and per-site outputs via the CLI
    sup = OUT / "supports"
    torch.cuda.reset_peak_memory_stats()
    with PassCount() as passes, CallLaunches() as calls:
        kernels.reset_launch_counts()
        wall = run_cli(["-s", str(GOLDEN / "example.phy")] + SUPPORT_FLAGS
                       + ["-pre", str(sup)])
        slice_launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_call = {k: v if len(v) < 4 else v[:3] + ["..."]
                for k, v in calls.calls.items()}
    logl = report_logl(sup)
    print(f"[phase 10] {' '.join(SUPPORT_FLAGS)} f32: logL {logl:.4f} in "
          f"{wall:.1f} s; peak device memory {peak:.2f} GiB; launches "
          f"{slice_launches}; per analysis (down, sitelp, up, theta) "
          f"{per_call}; split: "
          f"{re.search(r'Wall seconds: (.*)', log_lines(sup)).group(1)}",
          flush=True)
    if not all(v > 0 for v in slice_launches.values()):
        return fail(f"a kernel of the path was never launched: "
                    f"{slice_launches}")
    passes.check(slice_launches, "[phase 10]")
    calls.check({**{k: v for k, v in SLICE_WANT.items() if k != "nni scores"},
                 "site logL": (1, 1, 0, 0),
                 "bnni": lambda g: g[2] == SUPPORT_REPLICATES
                 and g[3] >= g[2]}, "[phase 10]")
    check_supports(sup, g4 - 0.5)
    ref_aln, ref_tree, _, _ = kernelcheck.load_problem(
        GOLDEN / "example.phy", GOLDEN / "ref_tree.nwk", "GTR+G4")
    ztrees = OUT / "user_trees.nwk"
    ztrees.write_text("".join(t.to_newick() + "\n" for t in [ref_tree] + [
        kernelcheck.perturbed(ref_tree, seed=s, strength=0.5)[0]
        for s in (1, 2)]))
    ztest = OUT / "usertrees"
    with PassCount() as passes, CallLaunches() as calls:
        kernels.reset_launch_counts()
        wall = run_cli(["-s", str(GOLDEN / "example.phy"), "-m", "GTR+G",
                        "-te", str(GOLDEN / "ref_tree.nwk"), "-z",
                        str(ztrees), "-au", "-zb", "10000",
                        "-pre", str(ztest)])
        z_launches = dict(kernels.LAUNCHES)
    passes.check(z_launches, "[phase 10 -z]")
    calls.check({"tree tests": lambda g: g[2] == 0 and g[1] >= 3
                 and g[3] >= 3}, "[phase 10 -z]")
    table = Path(f"{ztest}.iqtree").read_text().split("USER TREES")[1]
    rows = re.findall(r"^(\d)\s+(-\d+\.\d+)\s+(\d+\.\d+)", table, re.M)
    print(f"[phase 10] -z 3 trees -au -zb 10000 f32 in {wall:.1f} s: "
          f"(tree, logL, deltaL) {rows}; launches {z_launches}; tree tests "
          f"{calls.calls['tree tests']}", flush=True)
    if len(rows) != 3 or rows[0][2] != "0.0000":
        return fail(f"-z does not rank the reference tree first: {rows}")
    if len(Path(f"{ztest}.treelh").read_text().split()) != 3 or len(
            Path(f"{ztest}.trees").read_text().splitlines()) != 3:
        return fail("-z wrote no .treelh / .trees of 3 trees")
    keep = ~ref_aln.is_constant_pattern()[ref_aln.site_to_pattern]
    var_path = OUT / "variable.phy"
    write_phylip(ref_aln.subset_sites(np.nonzero(keep)[0]), var_path)
    asc = OUT / "asc"
    with PassCount() as passes:
        kernels.reset_launch_counts()
        wall = run_cli(["-s", str(var_path), "-m", "GTR+G+ASC", "-te",
                        str(GOLDEN / "ref_tree.nwk"), "-pre", str(asc)])
        asc_launches = dict(kernels.LAUNCHES)
    passes.check(asc_launches, "[phase 10 +ASC]")
    asc_logl = report_logl(asc)
    print(f"[phase 10] -m GTR+G+ASC -te on the {int(keep.sum())} variable "
          f"columns f32: logL {asc_logl:.4f} in {wall:.1f} s; launches "
          f"{asc_launches}", flush=True)
    if not (math.isfinite(asc_logl) and asc_launches["sitelp"] > 0):
        return fail(f"+ASC fit: logL {asc_logl}, launches {asc_launches}")

    stamp(11)
    # 11. the slice at the realistic width, then against the plain versions
    ftree = Tree.from_newick(Path(f"{big}.treefile").read_text(), aln.names)
    wide_out = run_slice(eng, ftree, "[phase 11] 1000 x 16384", report=True)
    post = wide_out["asr"]
    err = float(np.abs(post.sum(1, dtype=np.float64) - 1.0).max())
    print(f"[phase 11] ASR rows sum to 1 within {err:.3e}", flush=True)
    if not err <= SLICE_TOL:
        return fail(f"ASR posteriors sum to 1 only within {err}")
    if wide_out["tree tests"][0] != wide_out["tree tests"].max():
        return fail("the fitted tree is not the best of the -z set")
    s_aln, s_tree, s_model, s_rates = kernelcheck.simulate(
        "GTR+G4", CHECK_TAXA, SLICE_SITES, seed=1)
    for dtype in (torch.float32, torch.float64):
        small = [run_slice(LikelihoodEngine(s_aln, s_model, s_rates,
                                            dtype=dtype, device=dev),
                           s_tree, f"[phase 11] {CHECK_TAXA} x {SLICE_SITES} "
                           f"{dev}") for dev in ("cuda", "cpu")]
        errs = slice_errors(*small)
        print(f"[phase 11] {CHECK_TAXA} x {SLICE_SITES} {str(dtype)[6:]} "
              f"card against the plain versions: {errs}", flush=True)
        # SH-aLRT counts and aBayes are steps of the logLs: in float32 a
        # RELL margin or a printed digit within a logL's rounding (a few
        # 1e-2 at this size) moves, so they are held in float64
        held = {k: v for k, v in errs.items() if dtype == torch.float64
                or k not in SUPPORT_KEYS}
        if not all(v <= SLICE_TOL for v in held.values()):
            return fail(f"phase 11 disagrees with the plain versions: "
                        f"{held}")

    join_part(wide_proc, "[phase 9]")

    stamp(12)
    # 12. the partitioned path; 12a (ModelFinder per partition, host-paced)
    # in a process of its own beside 12b-e
    part_proc = start_part("part_default")
    started.append(part_proc)
    part_linkages()
    part_wide(aln_path, tree_path)
    part_loci(errors)
    part_flags()
    part_launches = join_part(part_proc, "[phase 12a]")

    stamp(13)
    # 13. mixtures and PMSF
    mix_kernels(errors)
    mix_pmsf_guide()
    mix_phy, mix_launches = mix_search()
    mix_pmsf_search(mix_phy)
    mix_weights(cpu_fit)

    # 14-18: first the parts that time the device (14a, 15a-b, 17a,
    # 18a-b), then the host-paced rest (15c-g, 16, 17b-c, 18c-e) with
    # 14b-e's and 14f's command lines in two processes of their own
    # beside them
    stamp(14)
    # 14. the model families: codon, +E, --mdef, partitioned mixtures
    model_families(errors, aln_path, tree_path, parts="a")
    stamp(15)
    # 15. nonreversible models, PoMo, +H, +T, the root test
    nonrev_families(errors, parts="ab")
    stamp(17)
    # 17. the distributed search and the pattern-sharded likelihood
    problem = (aln, tree, model, rates)
    distributed(problem, g4, errors, started, parts="a")
    stamp(18)
    # 18. the kernels' wide instance (S > 64): PoMo at N = 13-23, a 65-state
    # --mdef datatype
    wide_errors = {k: 0.0 for k in REPLACES}
    wide_timed, _ = wide_states(wide_errors, parts="ab")
    stamp("14b-e and 14f (beside the rest), 15c")
    family_procs = [start_part("family_runs", aln_path, tree_path, parts)
                    for parts in ("bcde", "f")]
    started.extend(family_procs)
    _, _, nonrev_launches = nonrev_families(errors, parts="cdefg")
    stamp(16)
    # 16. the standalone tools and dating
    dating_launches = standalone_tools(cpu_lmap)
    stamp("17b")
    dist_launches = distributed(problem, g4, errors, started, parts="bc")
    stamp("18c")
    _, wide_launches = wide_states(wide_errors, parts="cde")
    if not all(wide_launches.get(k, 0) > 0 for k in REPLACES):
        return fail(f"a wide kernel was never launched on 18c and 18e: "
                    f"{wide_launches}")
    family_launches: dict = {}
    for proc, tag in zip(family_procs, ("[phase 14b-e]", "[phase 14f]")):
        add(family_launches, join_part(proc, tag))
    print(f"[time] phases 1-18 in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": main_launches[k],
         "slice_launches": slice_launches[k],
         "partition_launches": part_launches[k],
         "mixture_launches": mix_launches[k],
         "model_family_launches": family_launches[k],
         "nonrev_launches": nonrev_launches[k],
         "dating_launches": dating_launches[k],
         "distributed_launches": dist_launches[k],
         "max_abs_err": errors[k], "ms": timed[k]["ms"],
         "b2b_ms": timed[k]["b2b_ms"], "plain_ms": timed[k]["plain_ms"],
         "bound_ms": bound[k]["bound_ms"], "bound_by": bound[k]["bound_by"],
         # no single PyTorch call computes a pruning pass
         "library_ms": None} for k in REPLACES] + [
        {"name": f"{k} (S > 64)", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": wide_launches[k],
         "max_abs_err": wide_errors[k], "ms": wide_timed[k]["ms"],
         "b2b_ms": wide_timed[k]["b2b_ms"],
         "plain_ms": wide_timed[k]["plain_ms"],
         "bound_ms": wide_timed[k]["bound_ms"],
         "bound_by": wide_timed[k]["bound_by"], "library_ms": None}
        for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
