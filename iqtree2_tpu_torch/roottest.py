"""Root placement testing and rootstrap for (non)reversible models.

Reference analog: IQ-TREE 2's ``--root-test`` (main/phyloanalysis.cpp
``doRootTest``) and the rootstrap supports of Naser-Khdour et al. 2021:
under a nonreversible model the likelihood depends on where the root sits,
so every branch is evaluated as a candidate root position and the set of
rootings is compared with the usual topology-test machinery (AU/KH/...).

Design (differs from the reference's per-root tree loop):

* A rooting of branch (a,b) is represented by splicing a degree-3 node r
  into the branch and attaching a pseudo-taxon ``__ROOT__`` (all-missing
  data, so its message is exactly 1) as **leaf 0**. The schedule machinery
  (tree/schedule.py) always applies the root frequencies at the internal
  node adjacent to leaf 0 — so the same engine evaluates every rooting;
  only the index arrays change.
* The root's position along the branch (t1 + t2) is free: both sub-branch
  lengths are ordinary edges for the batched Newton optimizer.
* Rootstrap supports are one RELL matmul: resampled pattern-weight rows W
  [R, P] times the per-rooting site log-likelihood matrix L [B, P]^T gives
  replicate scores [R, B]; argmax per replicate, counted per branch. No
  per-replicate tree search (reference: rootstrap from bootstrap trees).

Copied from iqtree2_tpu/roottest.py: the port keeps its own host
modules and imports nothing of the JAX package. run_root_test takes the
port's engine (its device and dtype) and runs every rooting through the
three kernels; the JAX package's module-level jax import is gone.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.tree.topology import Tree

ROOT_TAXON = "__ROOT__"


def root_alignment(aln: Alignment) -> Alignment:
    """Alignment with the pseudo-taxon ``__ROOT__`` (all-unknown) as
    taxon 0. Pattern structure is unchanged."""
    unk = aln.seqtype.unknown_code
    pats = np.concatenate(
        [np.full((aln.num_patterns, 1), unk, aln.patterns.dtype),
         aln.patterns], axis=1)
    return Alignment(names=[ROOT_TAXON] + list(aln.names),
                     seqtype=aln.seqtype, patterns=pats,
                     pattern_weights=aln.pattern_weights,
                     site_to_pattern=aln.site_to_pattern,
                     name=aln.name)


def rooted_tree_on_branch(tree: Tree, a: int, b: int,
                          frac: float = 0.5) -> Tree:
    """Copy of ``tree`` (taxa shifted by +1), with a new internal node r
    splicing branch (a, b) at ``frac`` and leaf 0 = __ROOT__ attached to r
    with a zero-length pendant edge."""
    rt = Tree([ROOT_TAXON] + list(tree.taxon_names))
    for (u, v) in tree.edges():
        rt.add_edge(u + 1, v + 1, tree.get_blen(u, v))
    rt._next_id = max(max(rt.nodes()) + 1, rt.ntaxa)
    r = rt.new_node()
    t = rt.get_blen(a + 1, b + 1)
    rt.remove_edge(a + 1, b + 1)
    rt.add_edge(a + 1, r, max(t * frac, 1e-8))
    rt.add_edge(r, b + 1, max(t * (1.0 - frac), 1e-8))
    rt.add_edge(0, r, 0.0)
    return rt


def _branch_label(tree: Tree, a: int, b: int) -> str:
    """Stable human-readable id for a branch: the smaller leaf-name set on
    one side (clade notation)."""
    side = sorted(tree.taxon_names[x] for x in tree.leaves_under(a, b))
    other = sorted(set(tree.taxon_names) - set(side))
    pick = min(side, other, key=lambda s: (len(s), s))
    return "{" + ",".join(pick) + "}"


@dataclasses.dataclass
class RootTestResult:
    branches: list[tuple[int, int]]      # (a, b) in the input tree
    labels: list[str]                    # clade labels per branch
    logL: np.ndarray                     # [B]
    site_lp: np.ndarray                  # [B, P]
    rootstrap: np.ndarray                # [B] RELL rootstrap support
    tests: object                        # treetesting.TreeTestResult
    best: int                            # argmax logL


def run_root_test(aln: Alignment, tree: Tree, model, rates,
                  dtype=None, nboot: int = 1000, n_rounds: int = 8,
                  optimize: bool = True,
                  seed: int = 1, log=print, device="cuda") -> RootTestResult:
    """Evaluate every branch of ``tree`` as a root position under
    ``model`` (optimizing branch lengths per rooting), then compute
    topology tests and rootstrap supports across rootings."""
    import torch

    from iqtree2_tpu_torch.engine import LikelihoodEngine
    from iqtree2_tpu_torch.treetesting import evaluate_trees

    raln = root_alignment(aln)
    eng = LikelihoodEngine(raln, model, rates,
                           dtype=dtype if dtype is not None
                           else torch.float32, device=device)
    branches = sorted(tree.edges())
    logLs, site_lps, labels = [], [], []
    for (a, b) in branches:
        rt = rooted_tree_on_branch(tree, a, b)
        if optimize:
            eng.optimize_branches(rt, n_rounds=n_rounds)
        lL, lp = eng.site_lp(rt)
        logLs.append(lL)
        site_lps.append(lp)
        labels.append(_branch_label(tree, a, b))
    L = np.asarray(site_lps)
    logL = np.asarray(logLs)
    w = np.asarray(raln.pattern_weights, np.float64)

    rng = np.random.default_rng(seed)
    tests = evaluate_trees(L, w, nboot=max(nboot, 1000), rng=rng)

    # rootstrap: one multinomial RELL matmul over all rootings
    n = int(round(w.sum()))
    W = rng.multinomial(n, w / w.sum(),
                        size=max(nboot, 1000)).astype(np.float64)
    winner = (W @ L.T).argmax(axis=1)
    rootstrap = np.bincount(winner, minlength=L.shape[0]) / W.shape[0]

    best = int(logL.argmax())
    log(f"Root test: {len(branches)} branches; best root on "
        f"{labels[best]} (logL {logL[best]:.4f}, rootstrap "
        f"{rootstrap[best]:.3f})")
    return RootTestResult(branches=branches, labels=labels, logL=logL,
                          site_lp=L, rootstrap=rootstrap, tests=tests,
                          best=best)


def write_roottest_csv(path: str, res: RootTestResult) -> None:
    tt = res.tests
    with open(path, "w") as f:
        f.write("ID,Branch,logL,deltaL,rootstrap,bp_RELL,p_KH,p_SH,"
                "c_ELW,p_AU\n")
        order = np.argsort(-res.logL)
        for i in order:
            pau = "" if tt.p_au is None else f"{tt.p_au[i]:.4f}"
            f.write(f"{i + 1},\"{res.labels[i]}\",{res.logL[i]:.5f},"
                    f"{tt.deltaL[i]:.5f},{res.rootstrap[i]:.4f},"
                    f"{tt.bp_rell[i]:.4f},{tt.p_kh[i]:.4f},"
                    f"{tt.p_sh[i]:.4f},{tt.c_elw[i]:.4f},{pau}\n")


def rooted_newick(tree: Tree, a: int, b: int, frac: float = 0.5,
                  supports: dict | None = None) -> str:
    """Newick of ``tree`` rooted on branch (a, b) — a bifurcating root
    node replacing the branch (standard rooted-tree output)."""
    import re

    rt = rooted_tree_on_branch(tree, a, b, frac)
    # root the newick at the internal node adjacent to __ROOT__, then
    # drop the pseudo-leaf pendant textually
    r = rt.adj[0][0]
    s = rt.to_newick(root=r)
    s = re.sub(rf"{ROOT_TAXON}:[0-9.eE+\-]+,|,{ROOT_TAXON}:[0-9.eE+\-]+",
               "", s, count=1)
    return s
