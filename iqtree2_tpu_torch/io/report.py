"""Report writers: the .iqtree human-readable report, .treefile, .log.

Reference analog: reportPhyloAnalysis (main/phyloanalysis.cpp:1082) with
sections from reportModel (:293), reportRate (:533), reportTree (:594).
The output surface follows SURVEY A1.

Copied from iqtree2_tpu/io/report.py, plus the report of a run that stops
after model selection and the codon models' kappa and omega and +E's
epsilon (MODEL_SCALARS): the port keeps its own host modules and imports
nothing of the JAX package.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

import iqtree2_tpu_torch


def write_treefile(path, tree, support=None, root=None) -> None:
    """root: leaf id to print the (unrooted) newick from — the -o
    outgroup display-rooting convention of the reference."""
    Path(path).write_text(
        tree.to_newick(support=support, root=root) + "\n")


def _fmt_matrix(Q: np.ndarray, states: str) -> str:
    lines = ["  " + "  ".join(f"{c:>8}" for c in states)]
    for i, c in enumerate(states):
        lines.append(
            f"  {c}  " + "  ".join(f"{Q[i, j]:8.4f}" for j in
                                   range(len(states))))
    return "\n".join(lines)


def _input_and_selection(a, params, aln, model_selection) -> None:
    """The report's INPUT DATA section and, after model selection, its
    MODEL SELECTION table."""
    a(f"IQ-TREE-TPU, PyTorch/CUDA port {iqtree2_tpu_torch.__version__} — "
      "maximum-likelihood phylogenomics (capability parity target: "
      "IQ-TREE 2)")
    a(f"Date: {time.strftime('%c')}")
    a("")
    a("INPUT DATA")
    a("-" * 10)
    a(f"Input file name: {params.aln_file}")
    a(f"Number of taxa: {aln.ntaxa}")
    a(f"Number of sites: {aln.nsites}")
    a(f"Number of distinct site patterns: {aln.num_patterns}")
    const, informative = aln.uninformative_site_count()
    a(f"Number of constant sites: {const} "
      f"(= {100.0 * const / max(aln.nsites, 1):.4g}% of all sites)")
    a(f"Number of parsimony informative sites: {informative}")
    a(f"Sequence type: {aln.seqtype.name}")
    a("")
    if model_selection:
        a("MODEL SELECTION")
        a("-" * 15)
        a(f"Best-fit model according to "
          f"{model_selection.get('criterion', 'BIC')}: "
          f"{model_selection['best']}")
        a("")
        tbl = model_selection.get("table")
        if tbl:
            a(f"List of models sorted by "
              f"{model_selection.get('criterion', 'BIC')} score:")
            a(f"{'Model':<20}{'LogL':>14}{'df':>5}{'AIC':>14}"
              f"{'AICc':>14}{'BIC':>14}")
            for row in tbl[:30]:
                a(f"{row['name']:<20}{row['logL']:>14.4f}{row['df']:>5}"
                  f"{row['AIC']:>14.4f}{row['AICc']:>14.4f}"
                  f"{row['BIC']:>14.4f}")
            a("")


def write_modelfinder_report(path, *, params, aln, model_selection,
                             elapsed=None) -> None:
    """The .iqtree of a run that stops after model selection (-m MF,
    TESTONLY): the input data and the selection table."""
    out = []
    _input_and_selection(out.append, params, aln, model_selection)
    if elapsed is not None:
        out.append(f"Total wall-clock time used: {elapsed:.3f} sec")
    out.append("")
    Path(path).write_text("\n".join(out))


def write_iqtree_report(path, *, params, aln, model, rates, tree, logL,
                        search_info=None, partitions=None,
                        model_selection=None, support=None,
                        elapsed=None, tree_tests=None) -> None:
    from iqtree2_tpu_torch.model.subst import build_gtr_rate_matrix

    out = []
    a = out.append
    _input_and_selection(a, params, aln, model_selection)
    a("SUBSTITUTION PROCESS")
    a("-" * 20)
    a(f"Model of substitution: {model_string(model, rates)}")
    a("")
    scalars = [(label, getattr(model, attr))
               for label, attr in MODEL_SCALARS if hasattr(model, attr)]
    if scalars:
        for label, v in scalars:
            a(f"{label}: {v:.4f}")
        a("")
    if hasattr(model, "exch_rates") and model.num_states <= 20:
        a("Rate parameter R:")
        names = {4: ["A-C", "A-G", "A-T", "C-G", "C-T", "G-T"]}.get(
            model.num_states)
        if names:
            for nm, r in zip(names, model.exch_rates):
                a(f"  {nm}: {r:.4f}")
        a("")
    if hasattr(model, "freqs"):
        a("State frequencies:")
        st = aln.seqtype.state_chars
        for i in range(min(model.num_states, len(st))):
            a(f"  pi({st[i]}) = {model.freqs[i]:.4f}")
        a("")
        if model.num_states == 4 and hasattr(model, "exch_rates"):
            Q = build_gtr_rate_matrix(model.exch_rates, model.freqs)
            a("Rate matrix Q:")
            a(_fmt_matrix(Q, "ACGT"))
            a("")
    a("RATE HETEROGENEITY")
    a("-" * 18)
    if rates.__class__.__name__ == "RateModel":
        a("Uniform rates across sites")
    else:
        a(f"Model of rate heterogeneity: {rates.name}")
        if hasattr(rates, "alpha"):
            a(f"Gamma shape alpha: {rates.alpha:.4f}")
        if rates.p_invar > 0:
            a(f"Proportion of invariable sites: {rates.p_invar:.4f}")
        if hasattr(rates, "rates") and hasattr(rates, "weights"):
            a("Site rates and weights:")
            for r, w in zip(rates.rates, rates.weights):
                a(f"  rate {r:.4f}  weight {w:.4f}")
        else:
            r = rates.category_rates()
            w = rates.category_weights()
            a(" Category  Relative_rate  Proportion")
            if rates.p_invar > 0:
                a(f"  0         0              {rates.p_invar:.4f}")
            for i, (ri, wi) in enumerate(zip(r, w)):
                a(f"  {i + 1}         {ri:<14.4f} {wi:.4f}")
    a("")
    a("MAXIMUM LIKELIHOOD TREE")
    a("-" * 23)
    a(f"Log-likelihood of the tree: {logL:.4f}")
    nfp = model.num_free_params() + rates.num_free_params() + \
        tree.num_edges()
    a(f"Number of free parameters (#branches + #model parameters): {nfp}")
    a(f"Akaike information criterion (AIC) score: "
      f"{2 * nfp - 2 * logL:.4f}")
    n = aln.nsites
    if n - nfp - 1 > 0:
        a(f"Corrected Akaike information criterion (AICc) score: "
          f"{2 * nfp - 2 * logL + 2 * nfp * (nfp + 1) / (n - nfp - 1):.4f}")
    a(f"Bayesian information criterion (BIC) score: "
      f"{np.log(n) * nfp - 2 * logL:.4f}")
    a(f"Total tree length (sum of branch lengths): "
      f"{tree.total_length():.4f}")
    a("")
    if search_info:
        for k, v in search_info.items():
            a(f"{k}: {v}")
        a("")
    a("Tree in newick format:")
    a("")
    a(tree.to_newick(support=support))
    a("")
    if tree_tests:
        a("USER TREES")
        a("-" * 10)
        a(tree_tests)
        a("")
    if elapsed is not None:
        a(f"Total wall-clock time used: {elapsed:.3f} sec")
    a("")
    Path(path).write_text("\n".join(out))



def write_partition_report(path, *, params, sa, peng, model_strs, tree,
                           logL, search_info=None, mf_table=None,
                           support=None, elapsed=None,
                           tree_tests=None) -> None:
    """.iqtree report for partitioned runs (reference analog:
    reportPhyloAnalysis partition sections, main/phyloanalysis.cpp:1082)."""
    out = []
    a = out.append
    a(f"IQ-TREE-TPU, PyTorch/CUDA port {iqtree2_tpu_torch.__version__} — "
      "partitioned analysis")
    a(f"Date: {time.strftime('%c')}")
    a("")
    a("INPUT DATA")
    a("-" * 10)
    a(f"Partition file: {params.partition_file}")
    a(f"Number of taxa: {sa.ntaxa}")
    a(f"Number of sites (supermatrix): {sa.nsites}")
    a(f"Number of partitions: {sa.n_partitions}")
    a(f"Edge linkage: {params.partition_type}")
    a("")
    a("PARTITION TABLE")
    a("-" * 15)
    a(f"{'ID':<4}{'Name':<24}{'Type':<8}{'Sites':>8}{'Patterns':>10}"
      f"{'Model':<24}{'Rate':>8}")
    for i, (p, name, m) in enumerate(zip(sa.partitions, sa.part_names,
                                         model_strs)):
        r = peng.part_rates[i] if peng is not None else 1.0
        a(f"{i + 1:<4}{name:<24}{p.seqtype.name:<8}{p.nsites:>8}"
          f"{p.num_patterns:>10}  {m:<24}{r:>8.4f}")
    a("")
    if mf_table:
        a("MODEL SELECTION (per partition)")
        a("-" * 31)
        a(f"{'Partition':<24}{'Best model':<22}{'LogL':>14}{'BIC':>14}")
        for row in mf_table:
            a(f"{row.get('partition', '?'):<24}{row['name']:<22}"
              f"{row['logL']:>14.4f}{row['BIC']:>14.4f}")
        a("")
    a("MAXIMUM LIKELIHOOD TREE")
    a("-" * 23)
    a(f"Log-likelihood of the tree: {logL:.4f}")
    nfp = tree.num_edges()
    for mo, ra in zip(peng.models, peng.rates):
        nfp += mo.num_free_params() + ra.num_free_params()
    if peng.partition_type == "edge-proportional":
        nfp += peng.K - 1
    n = sa.nsites
    a(f"Number of free parameters (#branches + #model parameters): {nfp}")
    a(f"Akaike information criterion (AIC) score: {2 * nfp - 2 * logL:.4f}")
    a(f"Bayesian information criterion (BIC) score: "
      f"{np.log(n) * nfp - 2 * logL:.4f}")
    a(f"Total tree length (sum of branch lengths): "
      f"{tree.total_length():.4f}")
    a("")
    if search_info:
        for k, v in search_info.items():
            a(f"{k}: {v}")
        a("")
    a("Tree in newick format:")
    a("")
    a(tree.to_newick(support=support))
    a("")
    if tree_tests:
        a("USER TREES")
        a("-" * 10)
        a(tree_tests)
        a("")
    if elapsed is not None:
        a(f"Total wall-clock time used: {elapsed:.3f} sec")
    a("")
    Path(path).write_text("\n".join(out))

# the scalar parameters of the codon models (kappa, omega) and of +E
# (epsilon), which the JAX package's report leaves out: (label, attribute)
MODEL_SCALARS = (("Transition/transversion ratio (kappa)", "kappa"),
                 ("Nonsynonymous/synonymous ratio (omega)", "omega"),
                 ("Sequencing error probability (epsilon)", "epsilon"))


def model_string(model, rates) -> str:
    s = model.name
    if getattr(model, "freq_type", "") in ("empirical", "estimate"):
        s += "+F"
    s += rates.name
    return s
