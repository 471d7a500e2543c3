"""The standalone tools of the command line: --alisim, -r, -con, the -pd
family and -rf/-rf_all, each run on its own without an analysis.

Copied from iqtree2_tpu/cli.py's dispatch (main, after the parser) with
each tool a function of the run's Params and the parsed flags (the -pd
family's, which Params does not hold) that returns the exit code
(cli.tool_mode names the function); the port keeps its own host modules
and imports nothing of the JAX package.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from iqtree2_tpu_torch.params import Params


def alisim(pr: Params, args) -> int:
    from iqtree2_tpu_torch.simulator import run_alisim
    run_alisim(pr)
    return 0


def random_tree(pr: Params, args) -> int:
    from iqtree2_tpu_torch.treeutils import random_tree as make
    t = make(pr.random_tree_n, pr.random_tree_model,
             np.random.default_rng(pr.seed))
    out = (pr.out_prefix or "random") + ".treefile"
    with open(out, "w") as f:
        f.write(t.to_newick() + "\n")
    print(f"Random {pr.random_tree_model} tree with "
          f"{pr.random_tree_n} taxa -> {out}")
    return 0


def consensus(pr: Params, args) -> int:
    from iqtree2_tpu_torch.analysis import read_tree_set
    from iqtree2_tpu_torch.tree.topology import Tree
    from iqtree2_tpu_torch.treeutils import consensus_tree
    names = read_tree_set(pr.consensus_of, None)[0].taxon_names
    trees = read_tree_set(pr.consensus_of, names)
    con, freqs = consensus_tree(trees, names)
    support = {}
    for s, (a, b) in con.splits().items():
        support[Tree._key(a, b)] = round(100.0 * freqs.get(s, 0.0))
    out = (pr.out_prefix or pr.consensus_of) + ".contree"
    with open(out, "w") as f:
        f.write(con.to_newick(support=support) + "\n")
    print(f"Majority-rule consensus of {len(trees)} trees -> {out}")
    return 0


def phylogenetic_diversity(pr: Params, args) -> int:
    from iqtree2_tpu_torch.analysis import read_tree_set
    from iqtree2_tpu_torch.pd import (budget_pd, greedy_pd, greedy_pd_areas,
                                      parse_cost_file, parse_sets_file,
                                      pd_complementarity, pd_endemism,
                                      pd_user_sets, write_pda_report)
    src_t = pr.start_tree or pr.user_tree
    if not src_t:
        print("error: PD analysis requires -t TREE", file=sys.stderr)
        return 2
    t = read_tree_set(src_t, None)[0]
    out = (pr.out_prefix or src_t) + ".pda"
    if args.pd_sets:
        sets = parse_sets_file(Path(args.pd_sets).read_text(), t.taxon_names)
        scores = pd_user_sets(t, sets)
        with open(out, "w") as f:
            f.write("PD of user-defined taxon sets/areas "
                    "(pda user-set mode)\n")
            for nm, v in scores.items():
                f.write(f"  {nm}\tPD = {v:.6f}\n")
            if args.pd_k > 0:
                best, bpd = greedy_pd_areas(t, sets, args.pd_k)
                f.write(f"Best {args.pd_k} areas: "
                        f"{', '.join(best)}  PD = {bpd:.6f}\n")
            if args.pd_endem:
                f.write("PD endemism per area:\n")
                for nm, v in pd_endemism(t, sets).items():
                    f.write(f"  {nm}\t{v:.6f}\n")
            if args.pd_comp:
                given = args.pd_comp.split(",")
                f.write(f"PD complementarity given {args.pd_comp}:\n")
                for nm, v in pd_complementarity(t, sets, given).items():
                    f.write(f"  {nm}\t{v:.6f}\n")
        print(f"PD set analysis -> {out}")
        return 0
    if args.pd_budget:
        costs = {}
        if args.pd_cost:
            costs = parse_cost_file(Path(args.pd_cost).read_text(),
                                    t.taxon_names)
        taxa, pd = budget_pd(t, args.pd_budget, costs)
        with open(out, "w") as f:
            f.write(f"Budgeted phylogenetic diversity (tree "
                    f"knapsack DP)\nbudget = {args.pd_budget:g}  "
                    f"PD = {pd:.6f}\nTaxa:\n")
            for x in taxa:
                f.write(f"  {t.taxon_names[x]}\n")
        print(f"Budget PD (B={args.pd_budget:g}): {pd:.6f} -> {out}")
        return 0
    taxa, pd, steps = greedy_pd(t, args.pd_k)
    write_pda_report(out, t, taxa, pd, steps)
    print(f"Greedy PD (k={args.pd_k}): {pd:.6f} -> {out}")
    return 0


def rf_distances(pr: Params, args) -> int:
    from iqtree2_tpu_torch.analysis import read_tree_set
    from iqtree2_tpu_torch.treeutils import rf_distance, rf_matrix
    src = pr.start_tree or pr.user_tree or pr.rf_tree_file
    names = read_tree_set(src, None)[0].taxon_names
    base = read_tree_set(src, names)
    if pr.rf_all or not pr.rf_tree_file or pr.rf_tree_file == src:
        D = rf_matrix(base)
        out = (pr.out_prefix or src) + ".rfdist"
        with open(out, "w") as f:
            f.write(f"{len(base)}\n")
            for i, row in enumerate(D):
                f.write(f"t{i + 1} " + " ".join(map(str, row)) + "\n")
        print(f"All-to-all RF distances ({len(base)} trees) -> {out}")
    else:
        other = read_tree_set(pr.rf_tree_file, names)
        for i, t1 in enumerate(base):
            for j, t2 in enumerate(other):
                print(f"RF(tree{i + 1}, tree{j + 1}) = "
                      f"{rf_distance(t1, t2)}")
    return 0
