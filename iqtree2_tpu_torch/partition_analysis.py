"""Partitioned analysis (-p/-q/-Q/-S; counterpart of
iqtree2_tpu/partition_analysis.py).

Flow: read the partition file (data/superalignment.read_partition_spec);
with --symtest or --symtest-remove-bad test each partition's symmetry (and
drop the failing ones); under -m MFP/MF/TEST/TESTONLY and their +MERGE
forms select each partition's model with ModelFinder on one parsimony tree
(its fits under a Partition_<name> checkpoint struct), optionally merging
partitions greedily or by k-means (--merge); MF, TESTONLY and MF+MERGE stop
at .best_scheme.nex. Otherwise each partition keeps the model its
charpartition names, or -m's. The PartitionEngine (partition/engine.py)
then fits the models and lengths on a -te tree, or a quick fit precedes the
stochastic search (search/search.TreeSearch, serial on this engine) with
UFBoot (-bsam SITE/GENE/GENESITE) and a thorough fit after it; -alrt and
-abayes run the branch tests on the partition engine; where a partition
lacks taxa the tree's terrace is counted (terrace.py). Outputs: .treefile,
.best_scheme.nex, .iqtree (io/report.write_partition_report), .log,
.ckp.gz, under -bb .contree, .splits.nex and .ufboot, and .terrace where
partitions lack taxa. -S runs the single-alignment analysis per locus and
writes every locus's tree to .treefile and its logL to .partlh.

Differences from the JAX package: its partition path ignores -g, -b,
--runs, -bnni, --tbe, -z, -wsl, -wsr, -wsp*, --mlrate, -asr, -mldist and
-o, which the port's CLI refuses with partitions; its -alrt/-abayes call
raises (its tests_branch builds candidate fields that do not exist), the
port's runs; the UFBoot supports are written as integer percentages with
the replicate trees (.ufboot) and .splits.nex, as the port's single
alignment writes them.

Reference analogs: runPhyloAnalysis on a SuperAlignment
(main/phyloanalysis.cpp:4103), PartitionFinder (testPartitionModel,
main/phylotesting.cpp:515,1958: per-partition best models and greedy pair
merging with the relaxed-cluster heuristic).
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from iqtree2_tpu_torch import tests_branch
from iqtree2_tpu_torch.analysis import (Logger, _write_ufboot,
                                        check_partition_model, merge_support,
                                        run_analysis)
from iqtree2_tpu_torch.data.superalignment import (SuperAlignment,
                                                   build_superalignment,
                                                   read_partition_spec)
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io import report as report_io
from iqtree2_tpu_torch.io.alignment_io import write_phylip
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.modelfinder import information_scores, run_modelfinder
from iqtree2_tpu_torch.ops.pars import random_stepwise_addition
from iqtree2_tpu_torch.ops.prec import compute_dtype
from iqtree2_tpu_torch.params import Params
from iqtree2_tpu_torch.partition.engine import PartitionEngine
from iqtree2_tpu_torch.partition.optimize import optimize_partition_parameters
from iqtree2_tpu_torch.search.search import SearchParams, TreeSearch
from iqtree2_tpu_torch.search.ufboot import UFBoot
from iqtree2_tpu_torch.symtest import run_symtest, write_symtest_csv
from iqtree2_tpu_torch.terrace import (check_terrace, count_terrace_exact,
                                       coverage_taxa_sets, enumerate_terrace,
                                       write_terrace_report)
from iqtree2_tpu_torch.tree.topology import Tree
from iqtree2_tpu_torch.utils.checkpoint import Checkpoint

SELECTION_MODES = ("MFP", "MF", "TEST", "TESTONLY", "MF+MERGE", "MFP+MERGE",
                   "TESTMERGE", "TESTNEWMERGE")
STOP_AFTER_SELECTION = ("MF", "TESTONLY", "MF+MERGE")
MAX_MERGE_PAIRS = 10      # greedy merging: closest pairs tried per round
TERRACE_CAP = 200         # enumeration cap without an exact count


def select_partition_models(sa: SuperAlignment, params: Params, log,
                            ckp=None, merge: bool = False,
                            device="cuda") -> dict:
    """Per-partition ModelFinder (and optional merging) on one parsimony
    tree. Returns {"models": [str per partition], "aln": the SuperAlignment,
    merged or not, "table": per-partition rows}."""
    rng = np.random.default_rng(params.seed)
    tree = random_stepwise_addition(sa, rng)
    mode = params.model if params.model.upper() in ("MFP", "MF", "TEST",
                                                    "TESTONLY") else "TEST"

    def best_for(aln, name):
        if ckp is not None:
            ckp.start_struct(f"Partition_{name}")
        try:
            res = run_modelfinder(aln, params, log=lambda s: None, ckp=ckp,
                                  tree=tree, mode=mode, device=device)
        finally:
            if ckp is not None:
                ckp.end_struct()
        row = res["table"][0]
        log(f"  partition {name:<20} -> {res['best']} "
            f"(BIC {row['BIC']:.2f})")
        return res["best"], row

    models, rows = [], []
    for p, name in zip(sa.partitions, sa.part_names):
        best, row = best_for(p, name)
        models.append(best)
        rows.append(dict(row, partition=name, nsites=p.nsites))

    if merge and sa.n_partitions > 1:
        if params.merge_algorithm == "kmeans":
            log("PartitionFinder: k-means partition merging "
                "(cluster by partition tree length)...")
            sa, models, rows = _kmeans_merge(sa, models, rows, params, log,
                                             best_for, tree, device)
        else:
            log("PartitionFinder: greedy partition merging...")
            sa, models, rows = _greedy_merge(sa, models, rows, params, log,
                                             best_for)
    return {"models": models, "aln": sa, "table": rows}


def _kmeans_1d(x: np.ndarray, w: np.ndarray, k: int) -> list[list[int]]:
    """Exact weighted 1-D k-means by interval DP (clusters of a sorted
    sequence are contiguous). Returns index groups."""
    order = np.argsort(x)
    xs, ws = x[order], w[order]
    cw = np.concatenate([[0.0], np.cumsum(ws)])
    cwx = np.concatenate([[0.0], np.cumsum(ws * xs)])
    cwx2 = np.concatenate([[0.0], np.cumsum(ws * xs * xs)])

    def cost(i, j):  # weighted SSE of xs[i:j]
        W = cw[j] - cw[i]
        if W <= 0:
            return 0.0
        m = (cwx[j] - cwx[i]) / W
        return cwx2[j] - cwx2[i] - W * m * m

    n = len(xs)
    D = np.full((k + 1, n + 1), np.inf)
    D[0, 0] = 0.0
    back = np.zeros((k + 1, n + 1), np.int64)
    for c in range(1, k + 1):
        for j in range(1, n + 1):
            for i in range(c - 1, j):
                v = D[c - 1, i] + cost(i, j)
                if v < D[c, j]:
                    D[c, j] = v
                    back[c, j] = i
    groups, j = [], n
    for c in range(k, 0, -1):
        i = int(back[c, j])
        if j > i:
            groups.append(sorted(order[i:j].tolist()))
        j = i
    return groups[::-1]


def _pooled_score(rows, total_sites: int, crit: str) -> float:
    """One information score from pooled logL/df over the whole supermatrix
    (reference: computeInformationScore over lhsum/dfsum,
    main/phylotesting.cpp:1793-1890). Per-partition score sums use each
    partition's own ln(n) and cannot express AIC/AICc correctly."""
    lh = sum(r["logL"] for r in rows)
    df = sum(r["df"] for r in rows)
    return information_scores(lh, df, total_sites)[crit]


def _materialize(sa: SuperAlignment, groups, part_rows):
    """(merged SuperAlignment, model per group, row per group)."""
    parts, names, mods, new_rows = [], [], [], []
    for g in groups:
        row = part_rows[tuple(sorted(g))]
        if len(g) == 1:
            parts.append(sa.partitions[g[0]])
            names.append(sa.part_names[g[0]])
        else:
            name = "+".join(sa.part_names[i] for i in g)
            parts.append(sa.merged_partition(sorted(g), name))
            names.append(name)
        mods.append(row.get("model", row["name"]))
        new_rows.append(row)
    for p, n in zip(parts, names):
        p.name = n
    sa2 = build_superalignment(parts, mods)
    sa2.part_names = names
    return sa2, mods, new_rows


def _kmeans_merge(sa, models, rows, params, log, best_for, tree, device):
    """k-means merge mode: cluster partitions by their ML tree length
    (proportional-rate proxy), try every cluster count, keep the best
    total criterion. Reference: doKmeansClustering
    (main/phylotesting.cpp:1793-1890, MERGE_KMEANS :2114)."""
    # per-partition tree length under the selected model (lenvec analog)
    lenvec = np.zeros(sa.n_partitions)
    for i, (p, m) in enumerate(zip(sa.partitions, models)):
        mo, ra, _ = build_model(m, p)
        eng = LikelihoodEngine(p, mo, ra, dtype=torch.float32,
                               device=device)
        t = tree.copy()
        eng.optimize_branches(t, n_rounds=4)
        lenvec[i] = t.total_length()
    nsites = np.array([p.nsites for p in sa.partitions], float)
    log("  partition tree lengths: " +
        ", ".join(f"{sa.part_names[i]}={lenvec[i]:.3f}"
                  for i in range(sa.n_partitions)))

    # cluster within each seqtype class (cross-type merges are invalid)
    classes: dict[str, list[int]] = {}
    for i, p in enumerate(sa.partitions):
        classes.setdefault(p.seqtype.name, []).append(i)

    part_rows = {(i,): rows[i] for i in range(sa.n_partitions)}

    def group_row(g: list[int]):
        key = tuple(sorted(g))
        if key not in part_rows:
            name = "+".join(sa.part_names[i] for i in g)
            merged = sa.merged_partition(list(key), name)
            best, row = best_for(merged, name)
            part_rows[key] = dict(row, partition=name,
                                  nsites=merged.nsites, model=best)
        return part_rows[key]

    crit = params.merit or "BIC"
    N_total = sa.nsites
    groups: list[list[int]] = []
    # global pooled score: the class being re-clustered varies while the
    # other classes keep singleton rows (they are clustered afterwards in
    # turn; logL/df are additive so the argmin per class is exact)
    other_rows: dict[str, list] = {
        c: [part_rows[(i,)] for i in ix] for c, ix in classes.items()}
    for cname, idx in classes.items():
        rest = [r for c, rs in other_rows.items() if c != cname for r in rs]
        best_groups = [[i] for i in idx]
        best_score = _pooled_score(
            rest + [part_rows[(i,)] for i in idx], N_total, crit)
        for k in range(len(idx) - 1, 0, -1):
            cl = _kmeans_1d(lenvec[idx], nsites[idx], k)
            gk = [[idx[j] for j in g] for g in cl]
            score = _pooled_score(rest + [group_row(g) for g in gk],
                                  N_total, crit)
            log(f"  [{cname}] k={k}: total {crit} {score:.2f}")
            if score < best_score:
                best_score, best_groups = score, gk
        groups.extend(best_groups)
        other_rows[cname] = [group_row(g) for g in best_groups]
    for g in groups:
        group_row(g)
    sa2, mods, new_rows = _materialize(sa, groups, part_rows)
    log(f"k-means merge: {sa.n_partitions} -> {sa2.n_partitions} "
        f"partitions")
    return sa2, mods, new_rows


def _greedy_merge(sa, models, rows, params, log, best_for):
    """Greedy pairwise merging judged by the pooled criterion (rcluster
    style: only the closest same-seqtype pairs by per-site logL are tried
    each round, at most MAX_MERGE_PAIRS). Reference: mergePartitions
    (main/phylotesting.cpp:1478)."""
    groups = [[i] for i in range(sa.n_partitions)]
    part_rows = {(i,): rows[i] for i in range(sa.n_partitions)}
    crit = params.merit or "BIC"
    N_total = sa.nsites

    def total_score(gs):
        return _pooled_score([part_rows[tuple(sorted(g))] for g in gs],
                             N_total, crit)

    def dist(ab):
        a, b = ab
        ra = part_rows[tuple(sorted(groups[a]))]
        rb = part_rows[tuple(sorted(groups[b]))]
        return abs(ra["logL"] / max(ra["nsites"], 1)
                   - rb["logL"] / max(rb["nsites"], 1))

    improved = True
    while improved and len(groups) > 1:
        improved = False
        base_bic = total_score(groups)
        cands = [(a, b) for a in range(len(groups))
                 for b in range(a + 1, len(groups))
                 if sa.partitions[groups[a][0]].seqtype.name
                 == sa.partitions[groups[b][0]].seqtype.name]
        cands.sort(key=dist)
        best_gain, best_pair, best_entry = 0.0, None, None
        for (a, b) in cands[:MAX_MERGE_PAIRS]:
            key = tuple(sorted(groups[a] + groups[b]))
            if key not in part_rows:
                name = "+".join(sa.part_names[i] for i in key)
                merged = sa.merged_partition(list(key), name)
                best, row = best_for(merged, name)
                part_rows[key] = dict(row, partition=name,
                                      nsites=merged.nsites, model=best)
            merged_groups = [gr for i, gr in enumerate(groups)
                             if i not in (a, b)] + [list(key)]
            gain = base_bic - total_score(merged_groups)
            if gain > best_gain:
                best_gain, best_pair, best_entry = gain, (a, b), key
        if best_pair is not None:
            a, b = best_pair
            groups = [gr for i, gr in enumerate(groups)
                      if i not in (a, b)] + [list(best_entry)]
            log(f"  merged -> {part_rows[best_entry]['partition']} "
                f"(d{crit} {best_gain:.2f}; "
                f"total {base_bic - best_gain:.2f})")
            improved = True
    return _materialize(sa, groups, part_rows)


def write_best_scheme(path, sa: SuperAlignment, models: list[str]) -> None:
    """Write the .best_scheme.nex partition scheme (reference analog:
    PartitionFinder output, main/phylotesting.cpp)."""
    lines = ["#nexus", "begin sets;"]
    off = 1
    for p, name in zip(sa.partitions, sa.part_names):
        lines.append(f"  charset {name} = {off}-{off + p.nsites - 1};")
        off += p.nsites
    pairs = ", ".join(f"{m}: {n}" for m, n in zip(models, sa.part_names))
    lines.append(f"  charpartition mymerge = {pairs};")
    lines.append("end;")
    Path(path).write_text("\n".join(lines) + "\n")


def run_unlinked_topology_analysis(params: Params, device="cuda") -> dict:
    """-S: topology-unlinked partitions, an independent tree inferred for
    every locus (reference: PhyloSuperTreeUnlinked,
    tree/phylosupertreeunlinked.h; SuperAlignmentUnlinked,
    alignment/superalignment.h:41). Each locus runs the whole
    single-alignment analysis under its own prefix <prefix>.<locus>; the
    loci's trees go to <prefix>.treefile and their logLs to
    <prefix>.partlh."""
    t_start = time.time()
    prefix = params.prefix
    log = Logger(f"{prefix}.log", params.verbose)
    try:
        log(f"Reading partition definition {params.partition_file} ...")
        sa = read_partition_spec(params.partition_file, params.aln_file,
                                 params.seqtype)
        log(f"Topology-unlinked analysis (-S): {sa.n_partitions} loci, "
            f"{sa.ntaxa} taxa")
        trees, rows = [], []
        total = 0.0
        for p, name, pmodel in zip(sa.partitions, sa.part_names,
                                   sa.part_models):
            with tempfile.TemporaryDirectory() as td:
                pf = f"{td}/{name}.phy"
                write_phylip(p, pf)
                sub = dataclasses.replace(
                    params, aln_file=pf, partition_file="",
                    out_prefix=f"{prefix}.{name}",
                    model=(pmodel or params.model), verbose=0,
                    no_checkpoint=True)
                log(f"===> locus {name}: {p.nsites} sites, model "
                    f"{sub.model}")
                res = run_analysis(sub, device=device)
            # as in the JAX package, a mode without one tree stops -S:
            # model selection alone, or a tree mixture (+T), whose JAX
            # result holds its trees and no "tree"
            if "tree" not in res or "trees" in res:
                raise SystemExit(
                    f"ERROR: model '{sub.model}' is not supported with -S "
                    f"(locus {name}: the analysis mode returns no single "
                    "tree)")
            total += res["logL"]
            trees.append(res["tree"])
            rows.append({"partition": name, "logL": res["logL"],
                         "nsites": p.nsites})
            log(f"  locus {name}: logL {res['logL']:.4f}")
        with open(f"{prefix}.treefile", "w") as f:
            for t in trees:
                f.write(t.to_newick() + "\n")
        with open(f"{prefix}.partlh", "w") as f:
            for r in rows:
                f.write(f"{r['partition']}\t{r['nsites']}\t"
                        f"{r['logL']:.6f}\n")
        elapsed = time.time() - t_start
        log(f"Topology-unlinked analysis done in {elapsed:.2f}s; total "
            f"logL {total:.4f}")
        log(f"Per-locus trees -> {prefix}.treefile; per-locus logL -> "
            f"{prefix}.partlh")
    finally:
        log.close()
    return {"logL": total, "trees": trees, "table": rows,
            "elapsed": elapsed}


def _symtests(sa: SuperAlignment, params: Params, log) -> SuperAlignment:
    """--symtest / --symtest-remove-bad per partition: .symtest.csv, and
    with the latter the partitions whose Bowker test rejects at
    --symtest-pval dropped (reference: main/phyloanalysis.cpp:3920)."""
    prefix = params.prefix
    results = [(name, run_symtest(p))
               for p, name in zip(sa.partitions, sa.part_names)]
    write_symtest_csv(f"{prefix}.symtest.csv", results)
    log(f"Symmetry tests written to {prefix}.symtest.csv")
    if not params.symtest_remove_bad:
        return sa
    keep = [i for i, (_, r) in enumerate(results)
            if r.p_bowker >= params.symtest_pval]
    dropped = [sa.part_names[i] for i in range(sa.n_partitions)
               if i not in set(keep)]
    if not dropped:
        return sa
    if not keep:
        raise SystemExit("--symtest-remove-bad would drop every partition")
    log(f"--symtest-remove-bad: dropping {len(dropped)} partition(s): "
        f"{', '.join(dropped)}")
    return sa.subset_partitions(keep)


def _terrace(sa: SuperAlignment, tree: Tree, prefix: str, log) -> None:
    """Where a partition lacks taxa, count (or bound) the terrace the tree
    lies on and write .terrace (reference: runterraceanalysis,
    main/terraceanalysis.cpp:18)."""
    tsets = coverage_taxa_sets(sa)
    if all(len(s) == sa.ntaxa for s in tsets):
        return
    exact = count_terrace_exact(tree, tsets)
    if exact is not None:
        write_terrace_report(f"{prefix}.terrace", exact > 1, exact, 0,
                             tsets, exact=True)
        if exact > 1:
            log(f"WARNING: the ML tree lies on a terrace of exactly "
                f"{exact} equally-scoring trees (partition coverage "
                f"gaps); see {prefix}.terrace")
        return
    on_t = check_terrace(tree, tsets)
    size_lb = enumerate_terrace(tree, tsets, cap=TERRACE_CAP) if on_t else 1
    write_terrace_report(f"{prefix}.terrace", on_t, size_lb, TERRACE_CAP,
                         tsets)
    if on_t:
        log(f"WARNING: the ML tree lies on a terrace of >= {size_lb} "
            f"equally-scoring trees (partition coverage gaps); see "
            f"{prefix}.terrace")


def run_partition_analysis(params: Params, device="cuda") -> dict:
    """The partitioned analysis of a -p/-q/-Q run (the module docstring's
    flow). Returns a result summary dict ({"models", "table"} alone after
    -m MF/TESTONLY/MF+MERGE)."""
    t_start = time.time()
    prefix = params.prefix
    log = Logger(f"{prefix}.log", params.verbose)
    try:
        ckp = Checkpoint(None if params.no_checkpoint else f"{prefix}.ckp.gz")
        if not params.redo:
            ckp.load()
        dtype = compute_dtype(params.use_f64)

        log(f"Reading partition definition {params.partition_file} ...")
        sa = read_partition_spec(params.partition_file, params.aln_file,
                                 params.seqtype)
        log(f"Supermatrix: {sa.ntaxa} taxa, {sa.nsites} sites, "
            f"{sa.n_partitions} partitions ({', '.join(sa.part_names)})")
        if params.symtest or params.symtest_remove_bad:
            sa = _symtests(sa, params, log)

        # ------------------ per-partition models --------------------------
        mup = params.model.upper()
        mf_table = None
        seconds: dict = {}
        if mup in SELECTION_MODES:
            t0 = time.perf_counter()
            sel = select_partition_models(sa, params, log, ckp=ckp,
                                          merge="MERGE" in mup,
                                          device=device)
            seconds["ModelFinder"] = time.perf_counter() - t0
            sa, model_strs, mf_table = sel["aln"], sel["models"], \
                sel["table"]
            if mup in STOP_AFTER_SELECTION:
                write_best_scheme(f"{prefix}.best_scheme.nex", sa,
                                  model_strs)
                log(f"Best partition scheme written to "
                    f"{prefix}.best_scheme.nex")
                return {"models": model_strs, "table": mf_table}
        else:
            model_strs = [m if m else params.model for m in sa.part_models]

        models, rates, asc_flags = [], [], []
        for p, m in zip(sa.partitions, model_strs):
            mo, ra, ex = build_model(m, p)
            check_partition_model(m, mo, ex)
            models.append(mo)
            rates.append(ra)
            asc_flags.append(ex.get("asc", False))
        peng = PartitionEngine(sa, models, rates,
                               partition_type=params.partition_type,
                               dtype=dtype, device=device,
                               asc_flags=asc_flags)
        log(f"Partition engine: {peng.device}, {dtype}, {peng.K} "
            f"partitions ({params.partition_type})")
        rng = np.random.default_rng(params.seed)

        ufboot = None
        if params.ufboot_replicates > 0:
            ufboot = UFBoot(sa, n_replicates=params.ufboot_replicates,
                            seed=params.seed, spec=params.boot_spec)

        search_info: dict = {}
        if params.user_tree:
            log(f"Reading fixed topology from {params.user_tree}")
            tree = Tree.from_newick(Path(params.user_tree).read_text(),
                                    sa.names)
            t0 = time.perf_counter()
            logL = optimize_partition_parameters(
                peng, tree, epsilon=params.model_eps, log=log)
            seconds["fit"] = time.perf_counter() - t0
        else:
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
            search = TreeSearch(peng, sa, sp, ufboot=ufboot, log=log)
            log("Quick initial partition-model optimization...")
            t0 = time.perf_counter()
            start = random_stepwise_addition(sa, rng)
            optimize_partition_parameters(
                peng, start, epsilon=max(params.model_eps, 1.0),
                max_rounds=2, log=log)
            seconds["quick fit"] = time.perf_counter() - t0
            res = search.run()
            seconds.update({"start trees": search.seconds["start_trees"],
                            "iterations": search.seconds["iterations"],
                            "RELL": search.seconds["rell"]})
            tree = res.best_tree
            search_info["Number of iterations"] = res.n_iterations
            log(f"Search done: {res.n_iterations} iterations, best logL "
                f"{res.best_logL:.4f}")
            t0 = time.perf_counter()
            logL = optimize_partition_parameters(
                peng, tree, epsilon=params.model_eps, log=log)
            seconds["final fit"] = time.perf_counter() - t0
        log("Wall seconds: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in seconds.items()))

        support = None
        if ufboot is not None:
            # integer percentages, as the single-alignment path writes them
            support = {k: round(v)
                       for k, v in ufboot.supports_for(tree).items()}
            _write_ufboot(prefix, ufboot)
            search_info["UFBoot replicates"] = params.ufboot_replicates
        if params.alrt_replicates > 0 or params.abayes:
            br = tests_branch.test_all_branches(
                peng, tree, n_rell=max(params.alrt_replicates, 1000),
                rng=rng, do_abayes=params.abayes)
            support = merge_support(support, br)

        report_io.write_treefile(f"{prefix}.treefile", tree,
                                 support=support)
        write_best_scheme(f"{prefix}.best_scheme.nex", sa, model_strs)
        _terrace(sa, tree, prefix, log)
        elapsed = time.time() - t_start
        report_io.write_partition_report(
            f"{prefix}.iqtree", params=params, sa=sa, peng=peng,
            model_strs=model_strs, tree=tree, logL=logL,
            search_info=search_info, mf_table=mf_table, support=support,
            elapsed=elapsed)
        ckp.put("finished", True)
        ckp.dump(force=True)
        log(f"Partitioned analysis done in {elapsed:.2f}s; logL "
            f"{logL:.4f}")
    finally:
        log.close()
    return {"logL": logL, "tree": tree, "models": model_strs,
            "part_rates": peng.part_rates.tolist(), "elapsed": elapsed,
            "peng": peng}
