"""Single-alignment analysis (counterpart of iqtree2_tpu/analysis.py's
run_analysis for what the port covers).

Flow: read the alignment; under -m MFP/TEST/MF/TESTONLY/AUTO select the
model with ModelFinder (modelfinder.py, on a parsimony tree; MF and
TESTONLY stop there and write the selection table), build the model and the
engine; then either fit the model and branch lengths on a fixed topology
(-te; under -blfix only the model parameters), or run the stochastic tree
search: a quick model fit on a stepwise-addition tree, the search
(optionally collecting UFBoot replicates by RELL), and a thorough refit on
the best tree. Outputs: .treefile (with UFBoot supports), .iqtree, .log and
.ckp.gz, and under -bb also .contree, .splits.nex and .ufboot, written
through the port's copies of io/report.py and search/ufboot.py. The search
checkpoints its state (search.* keys) and ModelFinder its fits
(ModelFinder.* keys), so an interrupted run resumes where it stopped.
-m WHTEST runs a GTR+G analysis and then the Weiss-von Haeseler test of
model homogeneity (whtest.py) on its tree, written to .whtest.

After the tree (iqtree2_tpu/analysis.py:368-485): -bnni refines the UFBoot
replicate trees, --tbe replaces their supports by transfer supports,
-alrt/-abayes add SH-aLRT and aBayes (tests_branch.py); -z evaluates a set
of user trees (treetesting.py, with -zb and -au) into .trees, .treelh and
the report; -o roots the printed trees on the first outgroup taxon (every
one must exist); -wsl, -wsr, -wspr/-wspm/-wspmr, --mlrate, -asr and
-mldist write .sitelh, .rate, .siteprob, .mlrate, .state and .mldist.

The nonreversible models (UNREST/NONREV, Lie-Markov, PoMo +P, a YAML
``reversible: false``) run on the same engine through pack["Q"]; +H runs on
the per-class model/heterotachy.MixlenEngine (the final fit alternates the
model parameters, the per-class lengths and the EM weights); +T fits a
tree mixture (model/treemix.py) over the -te trees and stops there;
--root-test (roottest.py) tests every branch of the final tree as the root
and writes .roottest.csv and .rooted.nwk.

Mixture models (model/mixture.py) run on the same engine, their classes
fused with the rate categories on one category axis; -wspm writes their
class posteriors. --pmsf (iqtree2_tpu/analysis.py:187-215) fits the
profile mixture on a guide tree (-te or -t, else a stepwise-addition
tree), writes the posterior mean site frequencies to .sitefreq and runs
the rest of the analysis on the site-specific-frequency engine
(model/pmsf.SSFEngine): its fixed-topology fit refits the branch lengths
and the Gamma shape, its search climbs with NNI1.

Under --dist-nranks N --dist-rank K --dist-dir D (N processes sharing D),
or under torchrun's environment (WORLD_SIZE > 1), the search is
parallel/multihost.DistributedSearch (iqtree2_tpu/analysis.py:261-353):
BSP rounds whose merged state does not depend on N, over FileGossip or
TorchGossip; every rank finishes the analysis on its own prefix (.rankK
for K > 0) with the same tree. The per-class (+H), nonreversible and PMSF
engines are refused there (not held to the JAX package's).

-g constrains the search to trees that contain the splits of a constraint
tree (tree/constraint.py: the parsimony start trees, the BIONJ tree, the
random NNIs and every NNI swap); --symtest writes the matched-pairs
symmetry tests of the alignment to .symtest.csv (symtest.py);
run_standard_bootstrap (-b N) repeats the analysis on N resampled
alignments and writes .boottrees, the supports on .treefile and .contree.
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np

from iqtree2_tpu_torch import tests_branch, timetree
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io import report as report_io
from iqtree2_tpu_torch.io.alignment_io import read_alignment, write_phylip
from iqtree2_tpu_torch.io.yamlmodels import load_definitions
from iqtree2_tpu_torch.io.nexus import parse_nexus
from iqtree2_tpu_torch.model import torchfit
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.heterotachy import MixlenEngine
from iqtree2_tpu_torch.model.mixture import MixtureModel
from iqtree2_tpu_torch.model.optimize import optimize_model_parameters
from iqtree2_tpu_torch.model.pmsf import SSFEngine, run_pmsf
from iqtree2_tpu_torch.model.treemix import TreeMixture
from iqtree2_tpu_torch.modelfinder import MODES, run_modelfinder
from iqtree2_tpu_torch.ops.distances import ml_distances
from iqtree2_tpu_torch.ops.pars import random_stepwise_addition
from iqtree2_tpu_torch.ops.prec import compute_dtype
from iqtree2_tpu_torch.parallel.multihost import (DistributedSearch,
                                                  FileGossip, TorchGossip,
                                                  init_distributed,
                                                  torchrun_world)
from iqtree2_tpu_torch.params import Params
from iqtree2_tpu_torch.roottest import (rooted_newick, run_root_test,
                                        write_roottest_csv)
from iqtree2_tpu_torch.search.search import SearchParams, TreeSearch
from iqtree2_tpu_torch.search.ufboot import UFBoot, greedy_consensus
from iqtree2_tpu_torch.siterates import site_rates_ml, write_mlrate
from iqtree2_tpu_torch.symtest import run_symtest, write_symtest_csv
from iqtree2_tpu_torch.tbe import tbe_supports
from iqtree2_tpu_torch.tree.constraint import TopologyConstraint
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree
from iqtree2_tpu_torch.treetesting import format_treetest_table, run_tree_tests
from iqtree2_tpu_torch.utils.checkpoint import Checkpoint
from iqtree2_tpu_torch.utils.optimize import lbfgsb_minimize
from iqtree2_tpu_torch.whtest import run_whtest

QUICK_FIT_EPS = 0.1   # the search's initial model fit (screening precision)
WHTEST_SIMULATIONS = 100  # parametric replicates of -m WHTEST's null


class Logger:
    def __init__(self, path, verbose=1, mode="w"):
        self.f = open(path, mode) if path else None
        self.verbose = verbose

    def __call__(self, msg: str) -> None:
        if self.verbose:
            print(msg)
            sys.stdout.flush()
        if self.f:
            self.f.write(msg + "\n")
            self.f.flush()

    def close(self):
        if self.f:
            self.f.close()


# destinations the JAX package's +T flow (iqtree2_tpu/analysis.py:228-250)
# never reads: it fits the tree mixture, writes .treefile and .iqtree, and
# returns
TREEMIX_IGNORED = (("alrt_replicates", "-alrt"), ("abayes", "-abayes"),
                   ("user_trees_file", "-z"), ("write_site_lh", "-wsl"),
                   ("write_site_rate", "-wsr"), ("write_site_prob", "-wsp*"),
                   ("write_ml_rate", "--mlrate"), ("do_asr", "-asr"),
                   ("write_ml_dist", "-mldist"), ("outgroup", "-o"),
                   ("root_test", "--root-test"),
                   ("fix_branch_lengths", "-blfix"), ("num_runs", "--runs"),
                   ("pmsf", "--pmsf"), ("date_file", "--date"))
# the branch tests and -bnni score NNIs with per-pattern logLs and reweighted
# views, which the JAX package's MixlenEngine does not give (it fails)
MIXLEN_REFUSED = (("alrt_replicates", "-alrt"), ("abayes", "-abayes"),
                  ("bnni", "-bnni"))


def check_model_ported(params: Params, model_str: str, extras: dict) -> None:
    """SystemExit for a flag the model's path does not run: with +T (tree
    mixtures) one that the JAX package's +T flow ignores, and -te with two
    or more trees missing; with +H (per-class lengths) the branch tests and
    -bnni."""
    defaults = Params()
    if extras.get("treemix"):
        if not params.user_tree:
            raise SystemExit("+T (tree mixture) requires -te FILE with two "
                             "or more trees")
        for dest, flag in TREEMIX_IGNORED:
            if getattr(params, dest) != getattr(defaults, dest):
                raise SystemExit(f"{flag} with -m {model_str}: the tree "
                                 f"mixture (+T) flow does not run it (the "
                                 f"JAX package ignores it)")
    if extras.get("mixlen"):
        for dest, flag in MIXLEN_REFUSED:
            if getattr(params, dest) != getattr(defaults, dest):
                raise SystemExit(f"{flag} with -m {model_str}: needs NNI "
                                 f"site log-likelihoods under per-class "
                                 f"branch lengths (+H), which the JAX "
                                 f"package's MixlenEngine does not give")


def check_partition_model(model_str: str, model, extras: dict) -> None:
    """SystemExit for a model family the JAX package's partition path does
    not run as a model (ROADMAP C19): its joint Newton forms eigenbasis
    thetas, which for a nonreversible model (UNREST, Lie-Markov, PoMo, a
    YAML ``reversible: false``) keep only a complex eigensystem's real
    parts, and it never reads the +H, +T or PoMo extras."""
    for key, what in (("mixlen", "per-class branch lengths (+H)"),
                      ("treemix", "tree mixtures (+T)"),
                      ("pomo", "PoMo (+P)")):
        if extras.get(key):
            raise SystemExit(f"-m {model_str} with -p/-q/-Q: {what} are not "
                             f"run on partitions (ROADMAP C19)")
    if not model.is_reversible():
        raise SystemExit(f"-m {model_str} with -p/-q/-Q: a nonreversible "
                         f"model is not run on partitions (ROADMAP C19: the "
                         f"JAX package's joint Newton reads a real-part "
                         f"eigensystem)")


def outgroup_root(outgroup: str, names: list[str]) -> int | None:
    """Leaf id of the first -o taxon, the one the printed trees are rooted
    on; every taxon of the comma-separated list must be in the alignment
    (the JAX package checks only the first)."""
    if not outgroup:
        return None
    taxa = outgroup.split(",")
    for name in taxa:
        if name not in names:
            raise SystemExit(f"ERROR: outgroup taxon '{name}' not found in "
                             f"alignment")
    return names.index(taxa[0])


def read_tree_set(path, names) -> list:
    """A set of Newick trees, one per line or a NEXUS trees block
    (iqtree2_tpu.analysis._read_tree_set)."""
    text = Path(path).read_text()
    if text.lstrip().upper().startswith("#NEXUS"):
        return [Tree.from_newick(nwk, names)
                for _, nwk in parse_nexus(text).trees]
    return [Tree.from_newick(ln.strip(), names)
            for ln in text.splitlines() if ln.strip()]


def merge_support(support, branch_tests) -> dict:
    """UFBoot percents combined with aLRT/aBayes into 'aLRT/aBayes/UFBoot'
    labels (iqtree2_tpu.analysis._merge_support)."""
    out = dict(support or {})
    for key, vals in branch_tests.items():
        label = "/".join(f"{v:.3g}" if isinstance(v, float) else str(v)
                         for v in vals)
        if key in out:
            out[key] = f"{label}/{out[key]:g}"
        else:
            out[key] = label
    return out


def write_asr(path, eng: LikelihoodEngine, tree: Tree, aln) -> None:
    """Marginal ancestral state posteriors, the .state file of -asr
    (iqtree2_tpu.analysis._write_asr)."""
    post, node_ids, _ = eng.ancestral_posteriors(tree)
    chars = aln.seqtype.state_chars[: aln.num_states]
    s2p = aln.site_to_pattern
    with open(path, "w") as f:
        f.write("# Ancestral state reconstruction (marginal posteriors)\n")
        f.write("Node\tSite\tState\t" +
                "\t".join(f"p_{c}" for c in chars) + "\n")
        for i, node in enumerate(node_ids):
            name = f"Node{node}"
            pp = post[i]  # [S, P]
            best = pp.argmax(axis=0)
            for s in range(aln.nsites):
                p = s2p[s]
                probs = "\t".join(f"{pp[x, p]:.5f}"
                                  for x in range(len(chars)))
                f.write(f"{name}\t{s + 1}\t{chars[best[p]]}\t{probs}\n")


def _write_site_outputs(params: Params, eng: LikelihoodEngine, tree: Tree,
                        aln, log) -> None:
    """-wsl, -wsr, -wspr/-wspm/-wspmr, --mlrate, -asr and -mldist
    (iqtree2_tpu/analysis.py:426-485)."""
    prefix = params.prefix
    if params.write_site_lh:
        _, lp = eng.site_lp(tree)
        site_lp = lp[aln.site_to_pattern]
        with open(f"{prefix}.sitelh", "w") as f:
            f.write(f"1 {aln.nsites}\n")
            f.write("Site_Lh " +
                    " ".join(f"{x:.5f}" for x in site_lp) + "\n")
    if params.write_site_rate:
        mean_rate, cat_post = eng.site_rate_posterior(tree)
        cat_best = cat_post.argmax(axis=0)
        with open(f"{prefix}.rate", "w") as f:
            f.write("# Site-specific posterior mean rates (empirical "
                    "Bayes)\nSite\tRate\tCategory\n")
            for s in range(aln.nsites):
                p = aln.site_to_pattern[s]
                f.write(f"{s + 1}\t{mean_rate[p]:.5f}\t"
                        f"{cat_best[p] + 1}\n")
    if params.write_site_prob:
        # -wspr/-wspm/-wspmr: per-site posterior probability of each
        # rate/mixture category (reference printSiteProbCategory,
        # main/phyloanalysis.cpp:2225-2226)
        _, cat_post = eng.site_rate_posterior(tree)
        post = cat_post
        if params.write_site_prob == "mixture":
            # sum the rate categories within each mixture class (one class:
            # the rate categories, as in the JAX package)
            post = class_posteriors(cat_post, eng.pack_np.cat_mix)
        with open(f"{prefix}.siteprob", "w") as f:
            f.write("Site\t" + "\t".join(f"p{c + 1}"
                                          for c in range(len(post))) + "\n")
            for s in range(aln.nsites):
                p = aln.site_to_pattern[s]
                f.write(f"{s + 1}\t" + "\t".join(
                    f"{post[c, p]:.5f}" for c in range(len(post))) + "\n")
        log(f"Site category posteriors written to {prefix}.siteprob")
    if params.write_ml_rate:
        mlr, _ = site_rates_ml(eng, tree)
        write_mlrate(f"{prefix}.mlrate", aln, mlr)
        log(f"Per-site ML rates written to {prefix}.mlrate")
    if params.do_asr:
        write_asr(f"{prefix}.state", eng, tree, aln)
        log(f"Ancestral states written to {prefix}.state")
    if params.write_ml_dist:
        D = ml_distances(aln, eng.model, dtype=eng.dtype, device=eng.device)
        with open(f"{prefix}.mldist", "w") as f:
            f.write(f"{aln.ntaxa}\n")
            for i, n in enumerate(aln.names):
                f.write(f"{n:<12}" +
                        " ".join(f"{D[i, j]:.6f}"
                                 for j in range(aln.ntaxa)) + "\n")


def class_posteriors(cat_post: np.ndarray, cat_mix) -> np.ndarray:
    """Mixture-class posteriors [M, P] from the category posteriors
    [C, P]: each class sums its rate categories
    (iqtree2_tpu/analysis.py:454-460); one class keeps the categories."""
    mix = np.asarray(cat_mix)
    n_mix = int(mix.max()) + 1
    if n_mix == 1:
        return cat_post
    agg = np.zeros((n_mix, cat_post.shape[1]))
    for c in range(len(mix)):
        agg[mix[c]] += cat_post[c]
    return agg


def fit_model(eng, tree: Tree, epsilon: float) -> float:
    """The model and branch-length refit of a fixed topology, on a
    LikelihoodEngine, on the PMSF SSFEngine, whose free parameters are
    the branch lengths and the Gamma shape, or on the MixlenEngine (+H):
    the model parameters on the mean lengths, then the per-class lengths
    and EM weights (iqtree2_tpu.analysis._fit_model). Returns the logL."""
    if isinstance(eng, SSFEngine):
        eng.optimize_branches(tree)
        eng.optimize_alpha(tree)
        return eng.optimize_branches(tree, n_rounds=4)
    if isinstance(eng, MixlenEngine):
        optimize_model_parameters(eng, tree,
                                  epsilon=max(epsilon, QUICK_FIT_EPS))
        return eng.optimize_mixlen(tree)
    return optimize_model_parameters(eng, tree, epsilon=epsilon)


def tree_mixture(params: Params, eng, aln, extras: dict,
                 log) -> tuple[TreeMixture, float]:
    """+T (iqtree2_tpu/analysis.py:228-250): the model fitted on the first
    -te tree, then the tree mixture's EM over all of them; returns the
    mixture and its logL."""
    trees = read_tree_set(params.user_tree, aln.names)
    if len(trees) < 2:
        raise SystemExit("+T (tree mixture) requires -te FILE with two or "
                         "more trees")
    log(f"Tree mixture (+T): {len(trees)} trees")
    optimize_model_parameters(eng, trees[0].copy(),
                              epsilon=max(params.model_eps, QUICK_FIT_EPS))
    tm = TreeMixture(eng, trees, weights=extras.get("treemix_weights"))
    return tm, tm.fit(log=log)


def root_test(params: Params, eng, tree: Tree, aln, search_info: dict,
              log) -> None:
    """--root-test (iqtree2_tpu/analysis.py:487-501): every branch of the
    tree as the root, under the engine's model, dtype and device; writes
    .roottest.csv and .rooted.nwk (rooted on the best branch)."""
    log("Root position test: evaluating every branch as root "
        "(doRootTest analog + RELL rootstrap)...")
    rres = run_root_test(aln, tree, eng.model, eng.rates, dtype=eng.dtype,
                         device=eng.device, log=log)
    write_roottest_csv(f"{params.prefix}.roottest.csv", rres)
    ra, rb = rres.branches[rres.best]
    with open(f"{params.prefix}.rooted.nwk", "w") as f:
        f.write(rooted_newick(tree, ra, rb) + "\n")
    search_info["Best root branch"] = rres.labels[rres.best]
    search_info["Rootstrap of best root"] = (
        f"{rres.rootstrap[rres.best]:.3f}")
    log(f"Root test -> {params.prefix}.roottest.csv; rooted tree -> "
        f"{params.prefix}.rooted.nwk")


def date_final_tree(params: Params, tree: Tree, aln, search_info: dict,
                    log) -> None:
    """--date: least-squares dating of the final tree (iqtree2_tpu/
    analysis.py:505-552): tip dates from the file or the taxon names
    (TAXNAME), the root on the -o outgroup's edge (with
    --date-no-outgroup its tips out of the fit) or at the midpoint,
    --date-rate and --date-root pinned, and with --date-ci N the
    branch-resampling intervals (--clock-sd), whose failed replicates are
    counted and reported (ROADMAP C5); writes .timetree.nwk/.nex/.lsd."""
    prefix = params.prefix
    if params.date_file == "TAXNAME":
        dates = timetree.dates_from_names(aln.names)
    else:
        dates = timetree.parse_date_file(Path(params.date_file).read_text(),
                                         aln.names)
    root_edge = None
    if params.outgroup:
        outgroup = params.outgroup.split(",")
        root_edge = timetree.outgroup_root_edge(tree, outgroup, aln.names)
        if params.date_no_outgroup:
            # LSD -G: root on the outgroup edge but keep outgroup tips out
            # of the WLS fit
            og = {aln.names.index(n) for n in outgroup}
            dates = {k: v for k, v in dates.items() if k not in og}
    fixed_rate = float(params.date_rate) if params.date_rate else None
    root_date = float(params.date_root) if params.date_root else None
    log(f"Least-squares dating with {len(dates)} tip dates "
        f"(LSD2 analog)...")
    nd, rate, parent, tt, root = timetree.date_tree(
        tree, dates, root_edge=root_edge, fixed_rate=fixed_rate,
        root_date=root_date)
    with open(f"{prefix}.timetree.nwk", "w") as f:
        f.write(timetree.timetree_newick(tt, nd, parent, root) + "\n")
    dci = rci = None
    n_failed = 0
    if params.date_ci > 0:
        log(f"Dating confidence intervals: {params.date_ci} "
            f"branch-resampling replicates (clock sd "
            f"{params.clock_sd})...")
        dci, rci, n_failed = timetree.date_tree_ci(
            tree, dates, seq_len=aln.nsites, n_reps=params.date_ci,
            clock_sd=params.clock_sd, root_edge=root_edge,
            fixed_rate=fixed_rate, root_date=root_date, seed=params.seed)
        search_info["Rate 95% CI"] = f"[{rci[0]:.6g}, {rci[1]:.6g}]"
        search_info["Failed dating replicates"] = \
            f"{n_failed} of {params.date_ci}"
        log(f"Dating replicates failed: {n_failed} of {params.date_ci}")
    with open(f"{prefix}.timetree.nex", "w") as f:
        f.write(timetree.timetree_nexus(tt.copy(), nd, parent, root,
                                        aln.names, ci=dci))
    timetree.write_lsd_report(f"{prefix}.timetree.lsd", nd, rate, root, tt,
                              aln.names, rate_ci=rci, date_ci=dci,
                              n_reps=params.date_ci, n_failed=n_failed)
    search_info["Clock rate (subst/site/time)"] = f"{rate:.6g}"
    search_info["Root date"] = f"{nd[root]:.6g}"
    log(f"Time tree -> {prefix}.timetree.nwk/.nex/.lsd  "
        f"rate {rate:.6g}  root date {nd[root]:.6g}")


def pmsf_engine(params: Params, eng: LikelihoodEngine, aln, rng,
                log) -> SSFEngine:
    """--pmsf's two passes (iqtree2_tpu/analysis.py:187-215): the profile
    mixture fitted on the guide tree (-te or -t, else a stepwise-addition
    tree drawn from ``rng``), its posterior mean site frequencies written
    to .sitefreq; returns the site-specific-frequency engine the rest of
    the analysis runs on."""
    if not isinstance(eng.model, MixtureModel):
        raise SystemExit("--pmsf requires a profile mixture model "
                         "(e.g. -m LG+C20+G)")
    gt_file = params.user_tree or params.start_tree
    if gt_file:
        guide = Tree.from_newick(Path(gt_file).read_text(), aln.names)
    else:
        guide = random_stepwise_addition(aln, rng)
    log("PMSF guide fit (full mixture)...")
    l_guide = optimize_model_parameters(
        eng, guide, epsilon=max(params.model_eps, QUICK_FIT_EPS))
    log(f"PMSF guide fit logL: {l_guide:.4f}")
    ssf_eng, _, _, prof = run_pmsf(aln, eng, guide, log=log)
    with open(f"{params.prefix}.sitefreq", "w") as f:
        for s in range(aln.nsites):
            p = aln.site_to_pattern[s]
            f.write(f"{s + 1} " + " ".join(f"{x:.6f}" for x in prof[p])
                    + "\n")
    log(f"PMSF site frequencies written to {params.prefix}.sitefreq")
    return ssf_eng


def optimize_model_only(eng: LikelihoodEngine, tree: Tree,
                        epsilon: float) -> None:
    """Fit the model parameters with the branch lengths held (-blfix): the
    joint fit with the lengths frozen, else bounded L-BFGS-B on the host
    (iqtree2_tpu.analysis._optimize_model_only)."""
    if torchfit.try_fit(eng, tree, fix_blens=True, epsilon=epsilon) \
            is not None:
        return
    model, rates = eng.model, eng.rates
    sched = build_schedule(tree)
    x_model = model.get_params()
    x_rates = rates.get_params()
    nm = len(x_model)
    x0 = np.concatenate([x_model, x_rates])
    if not len(x0):
        return
    lo_m, hi_m = model.param_bounds() if nm else (np.zeros(0), np.zeros(0))
    lo_r, hi_r = rates.param_bounds() if len(x_rates) else \
        (np.zeros(0), np.zeros(0))
    lo, hi = np.concatenate([lo_m, lo_r]), np.concatenate([hi_m, hi_r])

    def obj(x):
        if nm:
            model.set_params(x[:nm])
        if len(x) > nm:
            rates.set_params(x[nm:])
        eng.refresh_model()
        return -eng.loglik_sched(sched)

    xb, _ = lbfgsb_minimize(obj, np.clip(x0, lo, hi), lo, hi)
    obj(xb)


def dist_gossip(params: Params, eng, log) -> tuple:
    """(gossip, rank, ranks) of a distributed search: FileGossip under
    --dist-nranks N > 1 (--dist-dir required), TorchGossip over a gloo
    group under torchrun's environment, (None, 0, 1) otherwise. An engine
    whose distributed search is not held to the JAX package's stops the
    run first."""
    world = torchrun_world()[1]
    if params.dist_nranks <= 1 and world <= 1:
        return None, 0, 1
    if isinstance(eng, (SSFEngine, MixlenEngine)) or eng.nonrev:
        what = ("--pmsf" if isinstance(eng, SSFEngine) else
                f"-m {params.model}")
        mode = ("--dist-nranks" if params.dist_nranks > 1 else
                f"torchrun (WORLD_SIZE={world})")
        raise SystemExit(f"{what} with {mode}: the distributed search is "
                         f"not held to the JAX package's under "
                         f"the site-specific-frequency, per-class-length "
                         f"(+H) or nonreversible engines")
    if params.dist_nranks > 1:
        if not params.dist_dir:
            raise SystemExit("--dist-nranks > 1 requires --dist-dir "
                             "(shared gossip directory)")
        log(f"Distributed search: rank {params.dist_rank}/"
            f"{params.dist_nranks} (FileGossip at {params.dist_dir})")
        return (FileGossip(params.dist_dir, params.dist_rank,
                           params.dist_nranks),
                params.dist_rank, params.dist_nranks)
    rank, n = init_distributed("gloo")
    log(f"Distributed search: rank {rank}/{n} (torch.distributed, gloo)")
    return TorchGossip(rank, n), rank, n


def _constraint(params: Params, aln, log):
    """The -g TopologyConstraint, or None."""
    if not params.constraint_tree:
        return None
    constraint = TopologyConstraint(
        Path(params.constraint_tree).read_text(), aln.names)
    log(f"Constraint tree (-g): {len(constraint.splits)} splits over "
        f"{len(constraint.mask)} taxa will be enforced")
    return constraint


def _quick_fit(params: Params, eng, aln, log) -> float:
    """The search's quick model fit on a stepwise-addition tree (none
    under --pmsf, whose guide fit has fitted the model); returns its
    wall seconds."""
    if params.pmsf:
        return 0.0
    log("Performing quick initial model optimization...")
    t0 = time.perf_counter()
    start = random_stepwise_addition(aln, np.random.default_rng(params.seed))
    optimize_model_parameters(eng, start,
                              epsilon=max(params.model_eps, QUICK_FIT_EPS))
    return time.perf_counter() - t0


def _log_seconds(log, seconds: dict, note: str) -> None:
    log("Wall seconds: " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in seconds.items())
        + f" ({note})")


def _run_distributed(params: Params, eng, aln, ckp, ufboot, log,
                     search_info: dict, seconds: dict, gossip, rank: int,
                     nranks: int) -> tuple[Tree, float]:
    """The distributed branch of _run_search (iqtree2_tpu/analysis.py:
    313-353): quick fit, DistributedSearch in ceil(iterations / K) rounds
    of K = max(ranks, 4) iterations, its result checkpointed under
    dist_search.finished (a resume reads it and runs neither the quick
    fit nor the search), the final fit."""
    min_it = (params.min_iterations if params.n_iterations is None
              else params.n_iterations)
    round_size = max(nranks, 4)
    n_rounds = max(1, -(-min_it // round_size))
    fin = ckp.get("dist_search.finished")
    if fin and not params.redo:
        tree = Tree.from_newick(fin["tree"], aln.names)
        best_logL = fin["logL"]
        log(f"Distributed search already finished per checkpoint (logL "
            f"{best_logL:.4f})")
        if ufboot is not None and ckp.get("search.ufboot") is not None:
            ufboot.load_state_dict(ckp.get("search.ufboot"))
    else:
        seconds["quick fit"] = _quick_fit(params, eng, aln, log)
        ds = DistributedSearch(
            eng, aln, gossip, rank, nranks, seed=params.seed,
            n_init_trees=params.n_init_trees,
            n_nni_trees=params.n_nni_trees, pop_size=params.pop_size,
            round_size=round_size, n_rounds=n_rounds,
            pertub_strength=params.pertub_strength, ufboot=ufboot, log=log,
            constraint=_constraint(params, aln, log))
        t0 = time.perf_counter()
        tree, best_logL = ds.run()
        seconds["distributed search"] = time.perf_counter() - t0
        seconds.update(ds.seconds)
        ckp.put("dist_search.finished",
                {"tree": tree.to_newick(digits=17), "logL": best_logL})
        if ufboot is not None:
            ckp.put("search.ufboot", ufboot.state_dict())
        ckp.dump(force=True)
    log(f"Distributed search done: best logL {best_logL:.4f}")
    search_info["Number of iterations"] = round_size * n_rounds
    search_info["Distributed ranks"] = nranks
    t0 = time.perf_counter()
    logL = fit_model(eng, tree, params.model_eps)
    seconds["final fit"] = time.perf_counter() - t0
    _log_seconds(log, seconds, "start trees, iterations and gossip are "
                 "parts of distributed search")
    return tree, logL


def _run_search(params: Params, eng: LikelihoodEngine, aln, ckp, ufboot,
                log, search_info: dict,
                mf_seconds: float | None = None) -> tuple[Tree, float]:
    """Quick model fit, checkpointed stochastic search (under -g held to
    the constraint tree), thorough refit; the distributed search where
    dist_gossip gives a transport. Returns (best tree, its logL after the
    refit). mf_seconds: the wall of the ModelFinder run before it, the
    first entry of the split."""
    seconds = {} if mf_seconds is None else {"ModelFinder": mf_seconds}
    gossip, rank, nranks = dist_gossip(params, eng, log)
    if gossip is not None:
        seconds.update({"quick fit": 0.0, "distributed search": 0.0})
        return _run_distributed(params, eng, aln, ckp, ufboot, log,
                                search_info, seconds, gossip, rank, nranks)
    seconds.update({"quick fit": 0.0, "start trees": 0.0, "iterations": 0.0,
                    "RELL": 0.0})
    fin = ckp.get("search.finished")
    if fin and not params.redo:
        tree = Tree.from_newick(fin["tree"], aln.names)
        search_info["Number of iterations"] = fin["iterations"]
        log(f"Search already finished per checkpoint (logL "
            f"{fin['logL']:.4f})")
        if ufboot is not None and ckp.get("search.ufboot") is not None:
            ufboot.load_state_dict(ckp.get("search.ufboot"))
        # the model parameters moved during the search; refit them
        fit_model(eng, tree, max(params.model_eps, QUICK_FIT_EPS))
    else:
        seconds["quick fit"] = _quick_fit(params, eng, aln, log)
        sp = SearchParams(
            n_init_trees=params.n_init_trees,
            n_nni_trees=params.n_nni_trees,
            pop_size=params.pop_size,
            pertub_strength=params.pertub_strength,
            loglh_epsilon=params.loglh_epsilon,
            seed=params.seed,
            min_iterations=(params.min_iterations
                            if params.n_iterations is None
                            else params.n_iterations),
            max_iterations=params.max_iterations,
            unsuccess_iteration=params.unsuccess_iteration,
            fixed_iterations=params.n_iterations)
        search = TreeSearch(eng, aln, sp, ufboot=ufboot, log=log, ckp=ckp,
                            constraint=_constraint(params, aln, log))
        res = search.run()
        tree = res.best_tree
        seconds.update({"start trees": search.seconds["start_trees"],
                        "iterations": search.seconds["iterations"],
                        "RELL": search.seconds["rell"]})
        log(f"Search done: {res.n_iterations} iterations, best logL "
            f"{res.best_logL:.4f}")
        search_info["Number of iterations"] = res.n_iterations
        ckp.put("search.finished",
                {"tree": tree.to_newick(), "logL": res.best_logL,
                 "iterations": res.n_iterations})
        ckp.dump(force=True)
    t0 = time.perf_counter()
    logL = fit_model(eng, tree, params.model_eps)
    seconds["final fit"] = time.perf_counter() - t0
    _log_seconds(log, seconds, "RELL is part of start trees and iterations")
    return tree, logL


def _write_ufboot(prefix: str, ufboot: UFBoot) -> None:
    report_io.write_treefile(f"{prefix}.contree", ufboot.consensus_tree())
    ufboot.write_splits_nex(f"{prefix}.splits.nex")
    with open(f"{prefix}.ufboot", "w") as f:
        for tid in ufboot.boot_trees:
            if tid is not None:
                f.write(ufboot.trees_newick[tid] + "\n")


def write_symtests(path, results: list, log) -> None:
    """The symmetry tests to ``path`` (.symtest.csv), one log line each
    (iqtree2_tpu/analysis.py:172-185)."""
    write_symtest_csv(path, results)
    for name, r in results:
        log(f"SymTest [{name}]: Bowker={r.bowker:.3f} "
            f"(p={r.p_bowker:.4g}), Stuart p={r.p_stuart:.4g}, "
            f"internal p={r.p_internal:.4g}")
    log(f"Symmetry tests written to {path}")


def run_standard_bootstrap(params: Params, device="cuda") -> dict:
    """Classic non-parametric bootstrap (-b N): the analysis on the
    alignment, then N whole analyses on resampled alignments (seeds
    seed + 1000 + b, quiet, no checkpoint, in a temporary directory); the
    replicate trees go to .boottrees, their split frequencies onto the
    first tree in .treefile and their greedy consensus to .contree
    (iqtree2_tpu/analysis.py:575-626; reference runStandardBootstrap,
    main/phyloanalysis.cpp:3425)."""
    prefix = params.prefix
    n_boot = params.standard_bootstrap
    base = dataclasses.replace(params, standard_bootstrap=0)
    log = Logger(None, params.verbose)
    tree = run_analysis(base, device)["tree"]
    aln = read_alignment(params.aln_file, seqtype=params.seqtype)
    rng = np.random.default_rng(params.seed ^ 0xB00)
    split_counts: Counter = Counter()
    boot_trees = []
    for b in range(n_boot):
        log(f"===> START BOOTSTRAP REPLICATE {b + 1}/{n_boot}")
        baln = aln.bootstrap_alignment(rng)
        with tempfile.TemporaryDirectory() as td:
            bfile = f"{td}/boot{b}.phy"
            write_phylip(baln, bfile)
            bt = run_analysis(dataclasses.replace(
                base, aln_file=bfile, out_prefix=f"{td}/boot{b}",
                seed=params.seed + 1000 + b, verbose=0,
                no_checkpoint=True), device)["tree"]
        boot_trees.append(bt.to_newick())
        split_counts.update(bt.splits().keys())
    with open(f"{prefix}.boottrees", "w") as f:
        f.write("\n".join(boot_trees) + "\n")
    support = {Tree._key(a, b): round(100.0 * split_counts.get(s, 0)
                                      / n_boot)
               for s, (a, b) in tree.splits().items()}
    report_io.write_treefile(f"{prefix}.treefile", tree, support=support)
    report_io.write_treefile(f"{prefix}.contree", greedy_consensus(
        {s: c / n_boot for s, c in split_counts.items()}, aln.names))
    log(f"Standard bootstrap done: {n_boot} replicates -> "
        f"{prefix}.boottrees, supports on {prefix}.treefile")
    return {"tree": tree, "support": support, "boot_trees": boot_trees}


def run_whtest_analysis(params: Params, device="cuda") -> dict:
    """-m WHTEST: a GTR+G analysis (its outputs under the same prefix),
    then the WH test on its tree under its fitted model, written to .whtest
    (iqtree2_tpu/analysis.py's WHTEST branch). Returns the analysis' result
    with "whtest"."""
    res = run_analysis(dataclasses.replace(params, model="GTR+G"), device)
    log = Logger(f"{params.prefix}.log", params.verbose, mode="a")
    try:
        wh = run_whtest(res["aln"], res["tree"], res["model"], res["rates"],
                        n_sim=WHTEST_SIMULATIONS, seed=params.seed, log=log)
        with open(f"{params.prefix}.whtest", "w") as f:
            f.write(f"WH-test statistic: {wh['statistic']}\n"
                    f"p-value: {wh['p_value']}\n"
                    f"simulations: {wh.get('n_sim')}\n")
        log(f"WH-test written to {params.prefix}.whtest")
    finally:
        log.close()
    return {**res, "whtest": wh}


def run_analysis(params: Params, device="cuda") -> dict:
    """Model selection, then a fixed-topology fit (-te) or tree search;
    -m WHTEST runs run_whtest_analysis. Returns a result summary dict
    ({"model_selection": ...} alone after -m MF/TESTONLY)."""
    if params.model.upper() == "WHTEST":
        return run_whtest_analysis(params, device)
    t_start = time.time()
    prefix = params.prefix
    log = Logger(f"{prefix}.log", params.verbose)
    try:
        ckp = Checkpoint(None if params.no_checkpoint else f"{prefix}.ckp.gz")
        if not params.redo:
            ckp.load()
        if ckp.get("finished") and not params.redo:
            log("Checkpoint indicates a finished run; use redo to restart.")
        dtype = compute_dtype(params.use_f64)

        if params.mdef_file:
            dts, mds = load_definitions(params.mdef_file)
            log(f"Loaded YAML definitions: datatypes {dts or '-'}, "
                f"models {mds or '-'}")

        log(f"Reading alignment {params.aln_file} ...")
        aln = read_alignment(params.aln_file, seqtype=params.seqtype)
        log(f"Alignment: {aln.ntaxa} sequences, {aln.nsites} sites, "
            f"{aln.num_patterns} patterns ({aln.seqtype.name})")
        model_str, model_selection, mf_seconds = params.model, None, None
        if model_str.upper() in MODES:
            t0 = time.perf_counter()
            model_selection = run_modelfinder(aln, params, log=log, ckp=ckp,
                                              device=device)
            mf_seconds = time.perf_counter() - t0
            model_str = model_selection["best"]
            log(f"Best-fit model: {model_str}")
            if params.model.upper() in ("MF", "TESTONLY"):
                elapsed = time.time() - t_start
                report_io.write_modelfinder_report(
                    f"{prefix}.iqtree", params=params, aln=aln,
                    model_selection=model_selection, elapsed=elapsed)
                log(f"ModelFinder-only run finished ({elapsed:.2f}s); "
                    f"selection written to {prefix}.iqtree")
                return {"model_selection": model_selection}
        model, rates, extras = build_model(model_str, aln)
        check_model_ported(params, model_str, extras)
        if params.write_ml_dist and isinstance(model, MixtureModel):
            # the JAX package measures them under class 0 alone (ROADMAP
            # C13)
            raise SystemExit(f"-mldist with -m {model_str}: ML distances "
                             f"under a mixture model are not yet ported to "
                             f"iqtree2_tpu_torch")
        out_root = outgroup_root(params.outgroup, aln.names)
        if extras.get("mixlen"):
            eng = MixlenEngine(aln, model, rates, dtype=dtype, device=device)
        else:
            eng = LikelihoodEngine(aln, model, rates, dtype=dtype,
                                   device=device,
                                   asc=extras.get("asc", False))
        log(f"Likelihood engine: {eng.device}, {dtype}, "
            f"{eng.Pp} padded patterns")
        # the branch tests' RELL draws come from this generator, made where
        # the JAX package makes it
        rng = np.random.default_rng(params.seed)
        if params.symtest:
            write_symtests(f"{prefix}.symtest.csv",
                           [("alignment", run_symtest(aln))], log)
        if params.pmsf:
            eng = pmsf_engine(params, eng, aln, rng, log)

        search_info: dict = {}
        support = None
        ufboot = None
        if params.ufboot_replicates > 0:
            ufboot = UFBoot(aln, n_replicates=params.ufboot_replicates,
                            seed=params.seed)
        if extras.get("treemix"):
            tm, logL = tree_mixture(params, eng, aln, extras, log)
            tree = tm.trees[int(np.argmax(tm.weights))]
            with open(f"{prefix}.treefile", "w") as f:
                for t in tm.trees:
                    f.write(t.to_newick() + "\n")
            search_info["Tree mixture weights"] = \
                ", ".join(f"{w:.4f}" for w in tm.weights)
            elapsed = time.time() - t_start
            report_io.write_iqtree_report(
                f"{prefix}.iqtree", params=params, aln=aln, model=model,
                rates=rates, tree=tree, logL=logL, search_info=search_info,
                model_selection=None, support=None, elapsed=elapsed,
                tree_tests=None)
            ckp.put("finished", True)
            ckp.dump(force=True)
            log(f"Tree-mixture analysis done in {elapsed:.2f}s; mixture "
                f"logL {logL:.4f}")
            return {"logL": logL, "trees": tm.trees, "tree": tree,
                    "weights": tm.weights.tolist(), "elapsed": elapsed,
                    "model": model, "rates": rates, "aln": aln,
                    "model_selection": None}
        if params.user_tree:
            log(f"Reading fixed topology from {params.user_tree}")
            tree = Tree.from_newick(Path(params.user_tree).read_text(),
                                    aln.names)
            if params.fix_branch_lengths:
                optimize_model_only(eng, tree, params.model_eps)
                logL = eng.loglik_tree(tree)
            else:
                logL = fit_model(eng, tree, params.model_eps)
        else:
            tree, logL = _run_search(params, eng, aln, ckp, ufboot, log,
                                     search_info, mf_seconds)
        if ufboot is not None:
            if params.bnni:
                ufboot.refine_boot_trees(eng, log=log)
            if params.tbe:
                # transfer bootstrap expectation over the replicate trees
                # (reference: --tbe via booster, phyloanalysis.cpp:3668)
                reps = [ufboot.trees_newick[t] for t in ufboot.boot_trees
                        if t is not None]
                sup = tbe_supports(tree, reps, aln.names)
            else:
                sup = ufboot.supports_for(tree)
            # integer percentages, as the reference prints UFBoot supports
            support = {k: round(v) for k, v in sup.items()}
            _write_ufboot(prefix, ufboot)
            search_info["UFBoot replicates"] = params.ufboot_replicates
        if params.alrt_replicates > 0 or params.abayes:
            br = tests_branch.test_all_branches(
                eng, tree, n_rell=max(params.alrt_replicates, 1000), rng=rng,
                do_abayes=params.abayes)
            support = merge_support(support, br)

        tree_tests = None
        if params.user_trees_file:
            log(f"Evaluating user trees from {params.user_trees_file} "
                f"({params.topo_test_replicates} RELL replicates"
                f"{', AU test' if params.do_au_test else ''})...")
            res_z, opt_z = run_tree_tests(
                eng, read_tree_set(params.user_trees_file, aln.names),
                params, log=log)
            tree_tests = format_treetest_table(res_z)
            with open(f"{prefix}.trees", "w") as f:
                for t in opt_z:
                    f.write(t.to_newick() + "\n")
            with open(f"{prefix}.treelh", "w") as f:
                for v in res_z.logL:
                    f.write(f"{v:.6f}\n")

        report_io.write_treefile(f"{prefix}.treefile", tree, support=support,
                                 root=out_root)
        _write_site_outputs(params, eng, tree, aln, log)
        if params.root_test:
            root_test(params, eng, tree, aln, search_info, log)
        if params.date_file:
            date_final_tree(params, tree, aln, search_info, log)
        elapsed = time.time() - t_start
        report_io.write_iqtree_report(
            f"{prefix}.iqtree", params=params, aln=aln, model=model,
            rates=rates, tree=tree, logL=logL, search_info=search_info,
            model_selection=model_selection, support=support,
            elapsed=elapsed, tree_tests=tree_tests)
        ckp.put("finished", True)
        ckp.dump(force=True)
        log(f"Analysis finished in {elapsed:.2f} sec. Best logL: {logL:.4f}")
        log(f"Results written to {prefix}.iqtree / {prefix}.treefile")
    finally:
        log.close()
    return {"logL": logL, "tree": tree, "model": model, "rates": rates,
            "support": support, "elapsed": elapsed, "aln": aln,
            "model_selection": model_selection}
