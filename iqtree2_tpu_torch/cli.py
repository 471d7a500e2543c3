"""Command line of the PyTorch/CUDA port (counterpart of iqtree2_tpu/cli.py).

  python -m iqtree2_tpu_torch -s ALN [-m MODEL|MFP|TEST|MF|TESTONLY|AUTO|WHTEST]
                              [-mset M1,M2,..] [-mrate E,I,G,I+G,R]
                              [-cmax K] [-merit AIC|AICc|BIC]
                              [-te TREE [-blfix]] [-g TREE]
                              [-bb N [-bnni] [--tbe]] [-b N] [--runs N]
                              [-alrt N] [-abayes] [-z TREES [-zb N] [-au]]
                              [-wsl] [-wsr] [-wspr|-wspm|-wspmr] [--mlrate]
                              [-asr] [-mldist] [-o TAXA] [--symtest]
                              [--root-test] [--pmsf [-t TREE]] [-n N]
                              [-nstop N] [-ninit N] [-ntop N] [-nbest N]
                              [-pers X] [--f64] [--device cuda|cpu]
                              [--date FILE|TAXNAME [--date-ci N]
                               [--clock-sd X] [--date-root D]
                               [--date-rate R] [--date-no-outgroup]]
                              [--dist-nranks N --dist-rank K --dist-dir D]
  python -m iqtree2_tpu_torch [-s ALN] -p|-q|-Q|-S PARTITIONS
                              [-m MODEL|MFP|MF|TEST|TESTONLY|MF+MERGE|
                               MFP+MERGE|TESTMERGE] [--merge greedy|kmeans]
                              [-te TREE] [-bb N [-bsam SITE|GENE|GENESITE]]
                              [-alrt N] [-abayes] [--symtest]
                              [--symtest-remove-bad [--symtest-pval P]] ...
  python -m iqtree2_tpu_torch --alisim PREFIX -t TREE [-m MODEL] [-st TYPE]
                              [--length N] [--num-alignments N]
                              [--indel INS,DEL [--indel-size X]] [-s ALN]
                              [-p PARTITIONS] [--alisim-nprocs N
                               --alisim-rank R] [-seed N]
  python -m iqtree2_tpu_torch -r N [-rtype MODEL] | -con TREES |
                              -t TREES (-rf TREES2 | -rf_all) |
                              -t TREE (-pd K | -bud B [-cost FILE] |
                              -pdsets FILE [-pd K] [-endem] [-comp AREAS])

The flags are the JAX package's: build_parser and params_from_args are
copied from iqtree2_tpu/cli.py, the whole parser, so that refuse_unported
names every flag the port does not run. One flag is added, ``--device``,
the counterpart of IQTREE2_TPU_PLATFORM: ``cuda`` (the default) runs the
Hopper kernels and fails where there is no card; ``cpu`` runs their plain
PyTorch versions. The port runs model selection (ModelFinder, the default
-m MFP, and the WH test), the fixed-topology model fit (-te, with +ASC)
and the stochastic tree search with ultrafast bootstrap (under -g a
constraint tree), then the branch supports (-alrt, -abayes, -bnni,
--tbe), the user-tree tests (-z, -zb, -au) and the per-site and per-tree
outputs (-wsl, -wsr, -wspr/-wspm/-wspmr, --mlrate, -asr, -mldist, -o),
the standard bootstrap (-b), independent runs (--runs) and the symmetry
tests (--symtest), under any model of the factory (mixtures included,
with -wspm; the nonreversible, Lie-Markov and PoMo models; +H per-class
branch lengths; +T tree mixtures over the -te trees) and under PMSF
(--pmsf, -t naming its guide tree), and the root position test
(--root-test), and least-squares dating of the final tree (--date); the
distributed search (--dist-nranks N --dist-rank K --dist-dir D, one process
per rank, or under torchrun's environment: parallel/multihost.py; rank K >
0 writes under PREFIX.rankK); the
partitioned analysis (-p edge-proportional, -q edge-equal, -Q unlinked
branch lengths, -S one tree per locus) with per-partition ModelFinder and
merging, -bsam and --symtest-remove-bad; and the standalone tools
(standalone.py): AliSim (--alisim), random trees (-r), consensus (-con),
Robinson-Foulds distances (-rf, -rf_all) and phylogenetic diversity (-pd,
-bud, -pdsets). -lmap, --gcf and --scf, which the JAX package parses and
never reads (ROADMAP C23), stop with a SystemExit naming the port's
function that computes each.
Any flag whose path is not yet ported stops the run with a SystemExit that
names it, and so does each flag the JAX package's partition path accepts
and ignores (-g, -b, --runs, -bnni, --tbe, -z, -wsl, -wsr, -wsp*,
--mlrate, -asr, -mldist, -o, -blfix, --pmsf, --mdef, --root-test, --date;
and the model families of ROADMAP C19), and with --pmsf each output
the JAX package's site-specific-frequency engine cannot give (PMSF_REFUSED),
so nothing is silently ignored. The --dist-* flags, and torchrun's
environment, stop the run beside each route the JAX package's distributed
branch never reaches or reaches wrongly (DIST_REFUSED, ROADMAP C25), and
beside a standalone tool.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from iqtree2_tpu_torch.params import Params

# argparse destinations the port honours; num_threads is accepted for
# compatibility only, as in the JAX package
PORTED_DESTS = frozenset({
    "aln_file", "seqtype", "user_tree", "out_prefix", "model", "seed",
    "model_eps", "fix_branch_lengths", "use_f64", "redo", "quiet",
    "num_threads", "device", "n_iterations", "unsuccess_iteration",
    "n_init_trees", "n_nni_trees", "pop_size", "pertub_strength",
    "ufboot_replicates", "mset", "mrate", "cmax", "merit",
    "alrt_replicates", "abayes", "bnni", "tbe", "user_trees_file",
    "topo_test_replicates", "do_au_test", "write_site_lh", "write_site_rate",
    "write_site_prob", "write_ml_rate", "do_asr", "write_ml_dist",
    "outgroup", "constraint_tree", "standard_bootstrap", "num_runs",
    "symtest", "symtest_remove_bad", "symtest_pval", "partition_edge_prop",
    "partition_edge_equal", "partition_unlinked", "partition_topo_unlinked",
    "merge_algorithm", "boot_spec", "pmsf", "start_tree", "mdef_file",
    "root_test", "date_file", "date_ci", "clock_sd", "date_root",
    "date_rate", "date_no_outgroup", "dist_nranks", "dist_rank",
    "dist_dir"} | {
    # the standalone tools (main's dispatch)
    "alisim", "sim_length", "sim_num_alignments", "indel", "indel_size",
    "sim_nprocs", "sim_rank", "random_tree_n", "random_tree_model",
    "consensus_of", "rf_tree_file", "rf_all", "pd_k", "pd_budget", "pd_cost",
    "pd_sets", "pd_endem", "pd_comp"})
# destinations the JAX package parses and never reads (ROADMAP C23), and the
# port's function that computes what each asks for
PARSED_AND_IGNORED = {
    "lmap_quartets": "ops/quartet.likelihood_mapping",
    "gcf_tree_file": "treeutils.gene_concordance",
    "scf_quartets": "treeutils.site_concordance"}
# the dating flags that act only beside --date
DATE_OPTIONS = ("date_ci", "clock_sd", "date_root", "date_rate",
                "date_no_outgroup")
# destinations the JAX package's partition path (-p/-q/-Q) accepts and never
# reads: the port refuses them there
PARTITION_IGNORED = ("constraint_tree", "standard_bootstrap", "num_runs",
                     "bnni", "tbe", "user_trees_file", "write_site_lh",
                     "write_site_rate", "write_site_prob", "write_ml_rate",
                     "do_asr", "write_ml_dist", "outgroup",
                     "fix_branch_lengths", "pmsf", "mdef_file", "root_test",
                     "date_file")
# destinations whose path needs what the PMSF site-specific-frequency engine
# lacks (rate posteriors, ASR, a model, NNI site log-likelihoods, reweighted
# views): each raises AttributeError in the JAX package (ROADMAP C12)
PMSF_REFUSED = ("write_site_rate", "write_site_prob", "do_asr",
                "write_ml_dist", "write_ml_rate", "alrt_replicates", "abayes",
                "bnni", "fix_branch_lengths")
# destinations a distributed search (--dist-*) refuses, and why: the JAX
# package's partition path never reads --dist-*, its -te path builds the
# gossip and never uses it (+T needs -te), -b and --runs rerun the analysis
# in the same --dist-dir, whose round files the next run reads (ROADMAP
# C25), and the PMSF search is not held to the JAX package's
DIST_REFUSED = (
    (("partition_edge_prop", "partition_edge_equal", "partition_unlinked",
      "partition_topo_unlinked"),
     "the JAX package's partition path never reads --dist-* (ROADMAP C8's "
     "kind)"),
    (("user_tree",), "a -te tree is fixed: the JAX package builds the gossip "
     "and never uses it"),
    (("standard_bootstrap", "num_runs"), "reruns the analysis in the same "
     "--dist-dir, whose round files the next run reads (ROADMAP C25)"),
    (("pmsf",), "the distributed search is not held to the JAX package's "
     "under the site-specific-frequency engine"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iqtree2_tpu_torch",
        description="PyTorch/CUDA port of iqtree2_tpu: maximum-likelihood "
                    "model fit and tree search with ultrafast bootstrap")
    p.add_argument("-s", dest="aln_file", help="alignment file")
    p.add_argument("-st", dest="seqtype",
                   help="sequence type (DNA/AA/BIN/MORPH/CODON)")
    p.add_argument("-m", dest="model", default="MFP",
                   help="model string or MFP/TEST/MF")
    p.add_argument("-p", "-spp", dest="partition_edge_prop",
                   help="partition file (edge-proportional)")
    p.add_argument("-q", dest="partition_edge_equal",
                   help="partition file (edge-linked equal)")
    p.add_argument("-S", dest="partition_topo_unlinked", default="",
                   help="topology-UNLINKED partitions: one independent "
                        "tree per locus (PhyloSuperTreeUnlinked analog)")
    p.add_argument("-Q", dest="partition_unlinked",
                   help="partition file (unlinked/separate)")
    p.add_argument("-te", dest="user_tree",
                   help="fixed user topology (evaluate only)")
    p.add_argument("-t", dest="start_tree", help="starting tree file")
    p.add_argument("-g", dest="constraint_tree", help="constraint tree")
    p.add_argument("-pre", "--prefix", dest="out_prefix", default="")
    p.add_argument("-seed", "--seed", dest="seed", type=int, default=1)
    p.add_argument("-n", dest="n_iterations", type=int, default=None)
    p.add_argument("-nstop", dest="unsuccess_iteration", type=int,
                   default=100)
    p.add_argument("-ninit", dest="n_init_trees", type=int, default=100)
    p.add_argument("-ntop", dest="n_nni_trees", type=int, default=20)
    p.add_argument("-nbest", dest="pop_size", type=int, default=5)
    p.add_argument("-pers", dest="pertub_strength", type=float, default=0.5)
    p.add_argument("-bb", "-B", dest="ufboot_replicates", type=int,
                   default=0, help="ultrafast bootstrap replicates")
    p.add_argument("-b", dest="standard_bootstrap", type=int, default=0,
                   help="standard nonparametric bootstrap replicates")
    p.add_argument("-alrt", dest="alrt_replicates", type=int, default=0)
    p.add_argument("-abayes", dest="abayes", action="store_true")
    p.add_argument("-lbp", dest="lbp_replicates", type=int, default=0)
    p.add_argument("--runs", dest="num_runs", type=int, default=1)
    p.add_argument("-bnni", dest="bnni", action="store_true",
                   help="refine UFBoot replicate trees by NNI under "
                        "resampled weights (refineBootTrees)")
    p.add_argument("--mlrate", dest="write_ml_rate", action="store_true",
                   help="per-site ML rates (RateMeyerHaeseler analog, "
                        ".mlrate)")
    p.add_argument("--tbe", dest="tbe", action="store_true",
                   help="transfer bootstrap expectation supports "
                        "(booster/booster.h)")
    p.add_argument("-mset", dest="mset", default="",
                   help="comma-separated base models for ModelFinder")
    p.add_argument("-mrate", dest="mrate", default="",
                   help="comma-separated rate schemes (E,I,G,I+G,R)")
    p.add_argument("-cmax", dest="cmax", type=int, default=10,
                   help="max categories for +R rate models")
    p.add_argument("-merit", dest="merit", default="BIC",
                   choices=["AIC", "AICc", "BIC"],
                   help="model-selection criterion "
                        "(reference: params.model_test_criterion)")
    p.add_argument("-bsam", "--sampling", dest="boot_spec", default="",
                   choices=["", "SITE", "GENE", "GENESITE"],
                   help="bootstrap resampling unit for partitioned data "
                        "(reference: -bsam, alignment/alignment.cpp:3709)")
    p.add_argument("--dist-nranks", dest="dist_nranks", type=int, default=1,
                   help="distributed search: total process count "
                        "(launch one process per rank; reference analog: "
                        "the MPI run mode)")
    p.add_argument("--dist-rank", dest="dist_rank", type=int, default=0,
                   help="distributed search: this process's rank")
    p.add_argument("--dist-dir", dest="dist_dir", default="",
                   help="distributed search: shared gossip directory "
                        "(FileGossip); under torchrun the ranks gossip "
                        "over torch.distributed instead")
    p.add_argument("--merge", dest="merge_algorithm", default="greedy",
                   choices=["greedy", "kmeans"],
                   help="partition merging algorithm for -m MF+MERGE "
                        "(kmeans: cluster by partition tree length, "
                        "doKmeansClustering analog)")
    p.add_argument("--root-test", dest="root_test", action="store_true",
                   help="evaluate every branch as a root position "
                        "(nonreversible models; doRootTest + rootstrap)")
    p.add_argument("--symtest-remove-bad", dest="symtest_remove_bad",
                   action="store_true",
                   help="drop partitions failing the symmetry test "
                        "(reference: main/phyloanalysis.cpp:3920)")
    p.add_argument("--symtest-pval", dest="symtest_pval", type=float,
                   default=0.05, help="symmetry-test p-value cutoff")
    p.add_argument("--symtest", dest="symtest", action="store_true",
                   help="matched-pairs symmetry tests (doSymTest)")
    p.add_argument("-blfix", dest="fix_branch_lengths",
                   action="store_true")
    p.add_argument("-blmin", dest="min_branch_length", type=float,
                   default=1e-6)
    p.add_argument("-blmax", dest="max_branch_length", type=float,
                   default=10.0)
    p.add_argument("-me", dest="model_eps", type=float, default=0.01)
    p.add_argument("--mdef", dest="mdef_file", default="",
                   help="YAML model/datatype definition file "
                        "(phylo-yaml analog)")
    p.add_argument("--date", dest="date_file", default="",
                   help="tip-date file for least-squares dating, or "
                        "TAXNAME to parse dates from taxon names "
                        "(LSD2 analog, main/timetree.cpp)")
    p.add_argument("--date-ci", dest="date_ci", type=int, default=0,
                   help="number of branch-resampling replicates for "
                        "dating confidence intervals (LSD2 -f)")
    p.add_argument("--clock-sd", dest="clock_sd", type=float, default=0.2,
                   help="relaxed-clock lognormal stddev for --date-ci "
                        "replicates (LSD2 -q)")
    p.add_argument("--date-root", dest="date_root", default="",
                   help="fix the root date (LSD2 -a)")
    p.add_argument("--date-rate", dest="date_rate", default="",
                   help="fix the clock rate instead of estimating it "
                        "(LSD2 -w given-rate mode)")
    p.add_argument("--date-no-outgroup", dest="date_no_outgroup",
                   action="store_true",
                   help="root with -o outgroup but exclude it from "
                        "dating (LSD2 -G)")
    p.add_argument("-o", dest="outgroup", default="",
                   help="comma-separated outgroup taxa for rooting "
                        "the output / time tree")
    p.add_argument("--pmsf", dest="pmsf", action="store_true",
                   help="posterior mean site frequency two-pass for "
                        "profile mixtures (reference: "
                        "computeSiteFrequencyModel)")
    p.add_argument("-redo", "--redo", dest="redo", action="store_true")
    p.add_argument("-wsl", dest="write_site_lh", action="store_true")
    p.add_argument("-wsr", dest="write_site_rate", action="store_true",
                   help="write per-site posterior mean rates (.rate)")
    p.add_argument("-wspr", dest="write_site_prob", action="store_const",
                   const="ratecat", default="",
                   help="write per-site rate-category posterior "
                        "probabilities (.siteprob)")
    p.add_argument("-wspm", dest="write_site_prob", action="store_const",
                   const="mixture",
                   help="write per-site mixture-class posteriors "
                        "(.siteprob)")
    p.add_argument("-wspmr", "-wsprm", dest="write_site_prob",
                   action="store_const", const="mixture_ratecat",
                   help="write per-site mixture+rate category "
                        "posteriors (.siteprob)")
    p.add_argument("-z", dest="user_trees_file", default="",
                   help="evaluate a set of user trees (topology tests)")
    p.add_argument("-zb", dest="topo_test_replicates", type=int,
                   default=10000, help="RELL replicates for -z tests")
    p.add_argument("-au", dest="do_au_test", action="store_true",
                   help="perform the approximately-unbiased (AU) test")
    p.add_argument("-asr", dest="do_asr", action="store_true",
                   help="ancestral state reconstruction (.state)")
    p.add_argument("-mldist", dest="write_ml_dist", action="store_true",
                   help="write ML pairwise distances (.mldist)")
    p.add_argument("-lmap", dest="lmap_quartets", type=int, default=0,
                   help="likelihood mapping with N quartets (.lmap.svg)")
    p.add_argument("--gcf", dest="gcf_tree_file", default="",
                   help="gene-tree file for gene concordance factors")
    p.add_argument("--scf", dest="scf_quartets", type=int, default=0,
                   help="quartets per branch for site concordance factors")
    p.add_argument("-rf", dest="rf_tree_file", default="",
                   help="compute RF distance between -t tree(s) and FILE")
    p.add_argument("-rf_all", dest="rf_all", action="store_true",
                   help="all-to-all RF distances of the -t tree set")
    p.add_argument("-pd", dest="pd_k", type=int, default=0,
                   help="phylogenetic diversity: best k-taxon subset of "
                        "the -t tree (pda/ analog)")
    p.add_argument("-bud", dest="pd_budget", type=float, default=0.0,
                   help="PD under a budget: maximize PD with total "
                        "taxon cost <= BUDGET (pda -bud)")
    p.add_argument("-cost", dest="pd_cost", default="",
                   help="taxon cost file for -bud ('taxon cost' lines, "
                        "pda -cost; default all costs 1)")
    p.add_argument("-pdsets", dest="pd_sets", default="",
                   help="score user-defined taxon sets / areas from "
                        "FILE ('name: t1 t2 ...' lines; pda user-set "
                        "mode) — with -pd K picks the best K areas")
    p.add_argument("-endem", dest="pd_endem", action="store_true",
                   help="with -pdsets: also compute PD endemism per "
                        "area (pda -endem)")
    p.add_argument("-comp", dest="pd_comp", default="",
                   help="with -pdsets: PD complementarity given "
                        "comma-separated area names (pda -comp)")
    p.add_argument("-con", dest="consensus_of", default="",
                   help="majority-rule consensus of trees in FILE")
    p.add_argument("-r", dest="random_tree_n", type=int, default=0,
                   help="generate a random tree with N taxa")
    p.add_argument("-rtype", dest="random_tree_model", default="yule",
                   help="random tree model: yule|uniform|caterpillar|"
                        "balanced|star")
    p.add_argument("--f64", dest="use_f64", action="store_true",
                   help="float64 likelihood (parity mode)")
    p.add_argument("-nt", "-T", dest="num_threads", default="AUTO",
                   help="(accepted for compatibility)")
    p.add_argument("--quiet", dest="quiet", action="store_true")
    p.add_argument("--alisim", dest="alisim", default="",
                   help="simulate alignments (AliSim analog)")
    p.add_argument("--length", dest="sim_length", type=int, default=1000)
    p.add_argument("--num-alignments", dest="sim_num_alignments", type=int,
                   default=1)
    p.add_argument("--indel", dest="indel", default="",
                   help="insertion,deletion rates for AliSim (e.g. "
                        "0.03,0.1; simulator/alisimulator.h:241)")
    p.add_argument("--indel-size", dest="indel_size", type=float,
                   default=3.0, help="mean geometric indel size")
    p.add_argument("--alisim-nprocs", dest="sim_nprocs", type=int,
                   default=1, help="MPI-style AliSim split: total workers")
    p.add_argument("--alisim-rank", dest="sim_rank", type=int, default=0,
                   help="this worker's rank (simulates replicates "
                        "rank, rank+nprocs, ...)")
    p.add_argument("--device", dest="device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="cuda (default): the Hopper kernels, an error where "
                        "no card is present; cpu: their plain PyTorch "
                        "versions")
    return p


def params_from_args(args) -> Params:
    """Params of the parsed flags (iqtree2_tpu/cli.py's): a rank K > 0 of a
    distributed search, by --dist-rank or by torchrun's RANK, writes under
    PREFIX.rankK, so that the ranks' output files never collide (the JAX
    package's ranks under jax.distributed all write PREFIX, ROADMAP
    C25)."""
    pr = Params()
    for f in vars(pr):
        if hasattr(args, f):
            setattr(pr, f, getattr(args, f))
    for dest, kind in (("partition_topo_unlinked", "topo-unlinked"),
                       ("partition_edge_prop", "edge-proportional"),
                       ("partition_edge_equal", "edge-equal"),
                       ("partition_unlinked", "unlinked")):
        if getattr(args, dest):
            pr.partition_file, pr.partition_type = getattr(args, dest), kind
            break
    if args.quiet:
        pr.verbose = 0
    if not pr.out_prefix:
        pr.out_prefix = pr.aln_file or pr.partition_file
    from iqtree2_tpu_torch.parallel.multihost import torchrun_world
    rank, world = torchrun_world()
    if pr.dist_nranks > 1:
        rank = pr.dist_rank
    if rank > 0 and (pr.dist_nranks > 1 or world > 1):
        pr.out_prefix += f".rank{rank}"
    return pr


def refuse_unported(args: argparse.Namespace,
                    parser: argparse.ArgumentParser) -> None:
    """SystemExit naming the first given flag whose path is not ported."""
    for action in parser._actions:
        if not action.option_strings or action.dest in PORTED_DESTS:
            continue
        default = parser.get_default(action.dest)
        if getattr(args, action.dest, default) != default:
            flag = '/'.join(action.option_strings)
            if action.dest in PARSED_AND_IGNORED:
                raise SystemExit(
                    f"{flag}: not yet ported to iqtree2_tpu_torch as a flag: "
                    f"parsed and ignored by the JAX package (ROADMAP C23); "
                    f"the function is {PARSED_AND_IGNORED[action.dest]}")
            raise SystemExit(f"{flag}: not yet ported to iqtree2_tpu_torch")
    if not args.date_file:
        _refuse_with(args, parser, "no --date", DATE_OPTIONS,
                     "acts on the dating of --date FILE|TAXNAME")
    refuse_distributed(args, parser)
    if tool_mode(args):
        return
    if args.date_file and args.model.upper() in ("MF", "TESTONLY"):
        raise SystemExit(f"--date: dates the analysis' tree; -m {args.model} "
                         f"builds none")
    if args.user_tree and args.ufboot_replicates:
        raise SystemExit("-bb/-B: the ultrafast bootstrap samples the trees "
                         "of a search; drop -te or -bb")
    for flag, dest in (("-bnni", "bnni"), ("--tbe", "tbe")):
        if getattr(args, dest) and not args.ufboot_replicates:
            raise SystemExit(f"{flag}: works on the ultrafast bootstrap's "
                             f"replicate trees; add -bb/-B N")
    if args.start_tree and not args.pmsf:
        raise SystemExit("-t: not yet ported to iqtree2_tpu_torch except as "
                         "the --pmsf guide tree (the JAX package reads it "
                         "nowhere else)")
    if args.pmsf:
        _refuse_with(args, parser, "--pmsf", PMSF_REFUSED,
                     "needs the mixture engine's posteriors, model or "
                     "reweighted views, which the site-specific-frequency "
                     "engine lacks (the JAX package raises AttributeError)")
    if args.fix_branch_lengths and not args.user_tree:
        raise SystemExit("-blfix: fixes the branch lengths of a -te tree; "
                         "a search has none to fix")
    if args.constraint_tree and args.user_tree:
        raise SystemExit("-g: constrains the tree search; a -te tree is "
                         "fixed, drop -te or -g")
    if args.boot_spec and not args.ufboot_replicates:
        raise SystemExit("-bsam: chooses what the ultrafast bootstrap "
                         "resamples; add -bb/-B N")
    if args.merge_algorithm != parser.get_default("merge_algorithm") \
            and "MERGE" not in args.model.upper():
        raise SystemExit("--merge: chooses the partition merging of -m "
                         "MF+MERGE, MFP+MERGE or TESTMERGE")
    if args.symtest_pval != parser.get_default("symtest_pval") \
            and not args.symtest_remove_bad:
        raise SystemExit("--symtest-pval: is the cutoff of "
                         "--symtest-remove-bad")
    if args.num_runs > 1 and args.model.upper() in ("MF", "TESTONLY"):
        raise SystemExit("--runs: compares the runs' trees; -m "
                         f"{args.model} builds none")
    partitioned = (args.partition_edge_prop or args.partition_edge_equal
                   or args.partition_unlinked)
    if args.partition_topo_unlinked:
        _refuse_with(args, parser, "-S", ("boot_spec", "merge_algorithm",
                                          "symtest_remove_bad",
                                          "standard_bootstrap", "num_runs"),
                     "analyses each locus as a single alignment")
    elif partitioned:
        _refuse_with(args, parser, "-p/-q/-Q", PARTITION_IGNORED,
                     "is not run on partitions (the JAX package's partition "
                     "path ignores it)")
        if args.model.upper() in ("AUTO", "WHTEST"):
            raise SystemExit(f"-m {args.model}: not a model selection mode "
                             f"of a partitioned analysis")
    else:
        if "MERGE" in args.model.upper():
            raise SystemExit(f"-m {args.model}: partition merging needs "
                             f"partitions (-p/-q/-Q)")
        if args.boot_spec.upper() in ("GENE", "GENESITE"):
            raise SystemExit(f"-bsam {args.boot_spec}: resamples partitions "
                             f"(-p/-q/-Q)")
        if args.symtest_remove_bad:
            raise SystemExit("--symtest-remove-bad: drops partitions; needs "
                             "-p/-q/-Q")


def refuse_distributed(args: argparse.Namespace,
                       parser: argparse.ArgumentParser) -> None:
    """SystemExit for a distributed search that would not run as the JAX
    package's: a rank outside 0..N-1, --dist-rank or --dist-dir without
    --dist-nranks N > 1, --dist-nranks without --dist-dir, and, under
    --dist-nranks N > 1 or torchrun's WORLD_SIZE > 1, each of
    DIST_REFUSED's flags, MF/TESTONLY (no tree) and a standalone tool."""
    from iqtree2_tpu_torch.parallel.multihost import torchrun_world
    world = torchrun_world()[1]
    if args.dist_nranks > 1:
        if not 0 <= args.dist_rank < args.dist_nranks:
            raise SystemExit(f"--dist-rank {args.dist_rank}: the ranks of "
                             f"--dist-nranks {args.dist_nranks} are 0.."
                             f"{args.dist_nranks - 1}")
        if not args.dist_dir:
            raise SystemExit("--dist-nranks > 1 requires --dist-dir (shared "
                             "gossip directory)")
        mode = "--dist-nranks"
    elif args.dist_rank or args.dist_dir:
        raise SystemExit("--dist-rank/--dist-dir: act in a distributed "
                         "search; add --dist-nranks N (N > 1)")
    elif world > 1:
        mode = f"torchrun (WORLD_SIZE={world})"
    else:
        return
    tool = tool_mode(args)
    if tool:
        raise SystemExit(f"{mode} with the standalone tool {tool}: it runs "
                         f"no search")
    if args.model.upper() in ("MF", "TESTONLY"):
        raise SystemExit(f"{mode} with -m {args.model}: builds no tree, so "
                         f"runs no search")
    for dests, why in DIST_REFUSED:
        _refuse_with(args, parser, mode, dests, why)


def tool_mode(args) -> str:
    """The function of standalone.py that runs the standalone tool the flags
    ask for, in the JAX CLI's order of dispatch ("" for an analysis)."""
    for dest, tool in (("alisim", "alisim"), ("random_tree_n", "random_tree"),
                       ("consensus_of", "consensus"),
                       ("pd_k", "phylogenetic_diversity"),
                       ("pd_budget", "phylogenetic_diversity"),
                       ("pd_sets", "phylogenetic_diversity"),
                       ("rf_tree_file", "rf_distances"),
                       ("rf_all", "rf_distances")):
        if getattr(args, dest):
            return tool
    return ""


def _refuse_with(args, parser, mode: str, dests, why: str) -> None:
    """SystemExit naming the first flag of ``dests`` given with ``mode``
    (of flags sharing a destination, the one whose constant it holds)."""
    for action in parser._actions:
        value = getattr(args, action.dest, None)
        if action.dest in dests and value != parser.get_default(
                action.dest) and action.const in (None, value):
            raise SystemExit(f"{'/'.join(action.option_strings)} with "
                             f"{mode}: {why}")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(args, parser)
    pr = params_from_args(args)
    tool = tool_mode(args)
    if tool:
        from iqtree2_tpu_torch import standalone
        return getattr(standalone, tool)(pr, args)
    if not pr.aln_file and not pr.partition_file:
        print("error: -s ALIGNMENT is required", file=sys.stderr)
        return 2
    if pr.partition_file:
        from iqtree2_tpu_torch import partition_analysis
        if pr.partition_type == "topo-unlinked":
            partition_analysis.run_unlinked_topology_analysis(
                pr, device=args.device)
        else:
            partition_analysis.run_partition_analysis(pr, device=args.device)
        return 0
    from iqtree2_tpu_torch import analysis
    if pr.standard_bootstrap > 0:
        if pr.num_runs > 1:
            print("NOTE: -b takes precedence over --runs, which is not run "
                  "(as in the JAX package)")
        analysis.run_standard_bootstrap(pr, device=args.device)
        return 0
    if pr.num_runs > 1:
        best = None
        for r in range(pr.num_runs):
            res = analysis.run_analysis(dataclasses.replace(
                pr, seed=pr.seed + r, out_prefix=f"{pr.prefix}.run{r + 1}"),
                device=args.device)
            if best is None or res["logL"] > best["logL"]:
                best = res
        print(f"Best of {pr.num_runs} runs: logL {best['logL']:.4f}")
        return 0
    analysis.run_analysis(pr, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
