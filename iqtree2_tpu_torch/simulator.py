"""AliSim-style sequence simulation along a tree.

Reference analogs: runAliSim (main/alisim.cpp:10) ->
AliSimulator::simulateSeqsForTree (simulator/alisimulator.cpp:723): root
sequence sampled from state frequencies (or a supplied root sequence /
input alignment), then recursive simulation down the tree drawing child
states from P(t) per site; rate heterogeneity draws a per-site category
(simulator/alisimulatorheterogeneity.cpp); +I assigns invariant sites.

Host-vectorized design: the site axis is fully vectorized (one [nsites]
categorical draw per edge via inverse-CDF on cumulated P rows), so the cost
is O(n_edges * nsites * S) numpy work — the reference's per-site loops are
replaced by whole-array gathers.

Copied from iqtree2_tpu/simulator.py, simulate_alignment and what it calls
(kernelcheck.py simulates its problems with it), with codon models'
states written as their sense triplets: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.model.subst import transition_matrix
from iqtree2_tpu_torch.tree.topology import Tree


def _categorical_rows(probs: np.ndarray, rng: np.random.Generator
                      ) -> np.ndarray:
    """Sample one index per row of a [n, S] probability matrix."""
    cdf = np.cumsum(probs, axis=1)
    cdf /= cdf[:, -1][:, None]
    u = rng.random(probs.shape[0])
    return (u[:, None] > cdf).sum(axis=1).astype(np.int32)


def simulate_alignment(tree: Tree, model, rates, nsites: int,
                       rng: np.random.Generator,
                       root_seq: np.ndarray | None = None,
                       pmatrix=None) -> dict[str, str]:
    """Simulate one alignment; returns {taxon name: sequence string}.

    model: SubstModel (provides eigensystem + root freqs + state chars);
    rates: RateModel (category rates/weights + p_invar); pmatrix: P(t) of
    a length t (default the eigensystem's, transition_matrix; kernelcheck
    passes expm(Q t) for a nonreversible model, whose eigensystem here
    keeps a complex one's real parts, ROADMAP C18).
    """
    eig = model.get_eigensystem()
    freqs = np.asarray(model.freqs, np.float64)
    S = model.num_states

    cat_rates = np.asarray(rates.category_rates(), np.float64)
    cat_w = np.asarray(rates.category_weights(), np.float64)
    p_inv = float(getattr(rates, "p_invar", 0.0))

    # per-site rate: invariant sites get rate 0 (reference:
    # AliSimulatorInvar), others draw a category
    site_cat = rng.choice(len(cat_rates), size=nsites,
                          p=cat_w / cat_w.sum())
    site_rate = cat_rates[site_cat]
    if p_inv > 0:
        invar = rng.random(nsites) < p_inv
        site_rate = np.where(invar, 0.0, site_rate)

    if root_seq is None:
        root_states = rng.choice(S, size=nsites, p=freqs / freqs.sum())
    else:
        root_states = np.asarray(root_seq, np.int32)

    root = tree._default_root()
    states: dict[int, np.ndarray] = {root: root_states}
    seqs: dict[str, str] = {}
    chars = model_state_chars(model)

    # cache P(t) per (branch length, category-rate) pair
    pcache: dict[tuple[float, float], np.ndarray] = {}
    uniq_rates = np.unique(site_rate)

    for v, p in reversed(list(tree.postorder(root))):  # preorder
        if p == -1:
            continue
        t = max(tree.get_blen(v, p), 0.0)
        parent_states = states[p]
        child = np.empty(nsites, np.int32)
        for r in uniq_rates:
            sel = site_rate == r
            if not sel.any():
                continue
            if r == 0.0:
                child[sel] = parent_states[sel]
                continue
            key = (t, float(r))
            if key not in pcache:
                pcache[key] = np.maximum(
                    transition_matrix(eig, t * float(r)) if pmatrix is None
                    else pmatrix(t * float(r)), 0.0)
            P = pcache[key]
            rows = P[parent_states[sel]]           # [n_sel, S]
            child[sel] = _categorical_rows(rows, rng)
        states[v] = child
        if tree.is_leaf(v):
            seqs[tree.taxon_names[v]] = "".join(chars[s] for s in child)
    if tree.is_leaf(root):
        seqs[tree.taxon_names[root]] = "".join(chars[s]
                                               for s in states[root])
    return seqs


def model_state_chars(model) -> list[str]:
    S = model.num_states
    if hasattr(model, "gid"):
        # codon models: each state's sense triplet (the JAX package reads
        # CODON1's state_chars, which are empty, and fails)
        from iqtree2_tpu_torch.model.codon import sense_codons
        return sense_codons(model.gid)
    if S == 4:
        return list("ACGT")
    if S == 20:
        return list("ARNDCQEGHILKMFPSTWYV")
    if S == 2:
        return list("01")
    return [chr(ord("0") + i) if i < 10 else chr(ord("A") + i - 10)
            for i in range(S)]
