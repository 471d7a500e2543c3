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
replaced by whole-array gathers. Indels (simulate_alignment_indel) and
input mimicking (mimic_alignment) follow alisimulator.h:241-274 and the
-s input-mimicking path.

Copied from iqtree2_tpu/simulator.py (simulate_alignment,
simulate_alignment_indel, mimic_alignment, the writers and run_alisim),
with codon models' states written as their sense triplets: the port keeps
its own host modules and imports nothing of the JAX package.
simulate_alignment keeps the JAX function's draws under a mixture (every
site from class 0, ROADMAP C11) and a nonreversible model (P from the real
parts of a complex eigensystem, C18), which the parity tests read; the
command line (run_alisim, through simulate) instead draws each site's
class by the mixture weights (simulate_mixture) and forms a nonreversible
P by expm (simulate_nonrev), and builds the model on a dummy alignment of
the model's own sequence type, where the JAX package's is always DNA
(C22), so protein and codon models run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from iqtree2_tpu_torch.model.mixture import MixtureModel
from iqtree2_tpu_torch.model.rates import RateModel
from iqtree2_tpu_torch.model.subst import transition_matrix
from iqtree2_tpu_torch.tree.topology import Tree

# the dummy alignment's sequences per sequence type, from which the factory
# resolves a model's frequencies (the JAX package's DNA dummy, "ACGT" * 2;
# a codon type's are its sense codons)
DUMMY_SEQUENCES = {"DNA": "ACGT" * 2, "AA": "ARNDCQEGHILKMFPSTWYV",
                   "BIN": "01"}
# sequence types tried in turn for a model when -st is not given: DNA
# first, so that a DNA model is built as the JAX package builds it
ALISIM_SEQTYPES = ("DNA", "AA", "CODON", "BIN")


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


def simulate_alignment_indel(tree: Tree, model, rates, nsites: int,
                             rng: np.random.Generator,
                             ins_rate: float = 0.0, del_rate: float = 0.0,
                             mean_indel_size: float = 3.0,
                             pmatrix=None) -> dict[str, str]:
    """Simulation with insertions/deletions.

    Reference analog: AliSimulator::handleInsertion/handleDeletion
    (simulator/alisimulator.h:241-274) with GenomeTree tracking inserted
    columns (tree/genometree.h:18). Events per branch are Poisson with
    mean rate * t * (L+1) (insertions) / rate * t * L (deletions); sizes
    are geometric with the given mean (the reference's default indel-size
    distributions include GEO). Alignment columns are tracked through a
    global position registry (float keys) so every lineage stays aligned
    — the Python analog of GenomeTree. pmatrix: as simulate_alignment's.
    """
    eig = model.get_eigensystem()
    freqs = np.asarray(model.freqs, np.float64)
    S = model.num_states
    cat_rates = np.asarray(rates.category_rates(), np.float64)
    cat_w = np.asarray(rates.category_weights(), np.float64)
    p_inv = float(getattr(rates, "p_invar", 0.0))

    def draw_rates(n):
        cat = rng.choice(len(cat_rates), size=n, p=cat_w / cat_w.sum())
        r = cat_rates[cat]
        if p_inv > 0:
            r = np.where(rng.random(n) < p_inv, 0.0, r)
        return r

    def geom_size(n):
        p = 1.0 / max(mean_indel_size, 1.0)
        return rng.geometric(p, size=n)

    # columns: global registry of (position key) -> column index;
    # per-node sequences: dict column position -> state (absent = gap)
    root = tree._default_root()
    pos0 = np.arange(1, nsites + 1, dtype=np.float64)
    root_states = rng.choice(S, size=nsites, p=freqs / freqs.sum())
    root_rates = draw_rates(nsites)
    all_positions: list[float] = list(pos0)

    node_seq = {root: dict(zip(pos0, zip(root_states, root_rates)))}
    pcache: dict[tuple[float, float], np.ndarray] = {}

    def P_of(t, r):
        key = (t, float(r))
        if key not in pcache:
            pcache[key] = np.maximum(
                transition_matrix(eig, t * r) if pmatrix is None
                else pmatrix(t * r), 0.0)
        return pcache[key]

    for v, p in reversed(list(tree.postorder(root))):   # preorder
        if p == -1:
            continue
        t = max(tree.get_blen(v, p), 0.0)
        seq = dict(node_seq[p])
        # substitutions (vectorized over present columns per unique rate)
        keys = np.asarray(sorted(seq.keys()))
        if keys.size:
            st = np.asarray([seq[k][0] for k in keys])
            rt = np.asarray([seq[k][1] for k in keys])
            new = st.copy()
            for r in np.unique(rt):
                sel = rt == r
                if r == 0.0:
                    continue
                rows = P_of(t, r)[st[sel]]
                new[sel] = _categorical_rows(rows, rng)
            for k, s_, r_ in zip(keys, new, rt):
                seq[k] = (int(s_), float(r_))
        # deletions
        Lcur = len(seq)
        n_del = rng.poisson(del_rate * t * max(Lcur, 1)) if del_rate > 0 \
            else 0
        for _ in range(n_del):
            if not seq:
                break
            ks = sorted(seq.keys())
            start = rng.integers(0, len(ks))
            size = int(geom_size(1)[0])
            for k in ks[start: start + size]:
                del seq[k]
        # insertions
        Lcur = len(seq)
        n_ins = rng.poisson(ins_rate * t * (Lcur + 1)) if ins_rate > 0 \
            else 0
        for _ in range(n_ins):
            ks = sorted(seq.keys())
            size = int(geom_size(1)[0])
            if ks:
                i = int(rng.integers(0, len(ks) + 1))
                lo = ks[i - 1] if i > 0 else ks[0] - 1.0
                hi = ks[i] if i < len(ks) else ks[-1] + 1.0
            else:
                lo, hi = 0.0, 1.0
            newpos = np.linspace(lo, hi, size + 2)[1:-1]
            newst = rng.choice(S, size=size, p=freqs / freqs.sum())
            newrt = draw_rates(size)
            for kpos, s_, r_ in zip(newpos, newst, newrt):
                seq[float(kpos)] = (int(s_), float(r_))
                all_positions.append(float(kpos))
        node_seq[v] = seq

    # assemble the alignment over the union of columns
    cols = sorted(set(all_positions))
    col_idx = {c: i for i, c in enumerate(cols)}
    chars = model_state_chars(model)
    out: dict[str, str] = {}
    leaves = [v for v in node_seq if tree.is_leaf(v)]
    if tree.is_leaf(root):
        leaves.append(root)
    for v in leaves:
        row = ["-"] * len(cols)
        for k, (s_, _r) in node_seq[v].items():
            row[col_idx[k]] = chars[s_]
        out[tree.taxon_names[v]] = "".join(row)
    return out


def simulate_mixture(tree: Tree, model: MixtureModel, rates, nsites: int,
                     rng: np.random.Generator,
                     site_class: np.ndarray | None = None) -> dict[str, str]:
    """{taxon: sequence} under a mixture: each site's class drawn by the
    class weights (or given, ``site_class``), then the sites of each class,
    class by class, simulated under that class alone (its
    exchangeabilities and profile and the rate model; a fused class, as in
    LG4X, with its own rate category alone) and put back in their
    columns. The JAX simulator draws every site from class 0 (ROADMAP
    C11)."""
    if site_class is None:
        site_class = rng.choice(len(model.components), size=nsites,
                                p=model.weights / model.weights.sum())
    width = len(model_state_chars(model)[0])
    cols: dict[str, np.ndarray] = {}
    r_fused = rates.category_rates()
    for m, (exch, freqs, mult) in enumerate(model.components):
        idx = np.flatnonzero(site_class == m)
        cls_rates = rates
        if model.fused_rates:
            mult, cls_rates = mult * r_fused[m], RateModel()
        one = MixtureModel([(exch, freqs, mult)], [1.0], name=model.name,
                           num_states=model.num_states)
        block = simulate_alignment(tree, one, cls_rates, len(idx), rng)
        for name, seq in block.items():
            if name not in cols:
                cols[name] = np.empty(nsites, dtype=object)
            cols[name][idx] = [seq[i:i + width]
                               for i in range(0, len(seq), width)]
    return {name: "".join(c) for name, c in cols.items()}


def nonrev_pmatrix(model):
    """P(t) = expm(Q t) of a nonreversible model in float64
    (ops/pruning.expm_ss), as a function of t."""
    import torch

    from iqtree2_tpu_torch.ops import pruning
    Q = torch.as_tensor(np.asarray(model.get_eigensystem().Q)[0],
                        dtype=torch.float64)

    def pmatrix(t: float) -> np.ndarray:
        return pruning.expm_ss(Q * t).numpy()
    return pmatrix


def simulate_nonrev(tree: Tree, model, rates, nsites: int,
                    rng: np.random.Generator) -> dict[str, str]:
    """{taxon: sequence} under a nonreversible model, P(t) = expm(Q t)
    (nonrev_pmatrix): the eigensystem's P keeps a complex one's real parts
    (ROADMAP C18)."""
    return simulate_alignment(tree, model, rates, nsites, rng,
                              pmatrix=nonrev_pmatrix(model))


def is_nonrev(model) -> bool:
    return getattr(model.get_eigensystem(), "Q", None) is not None


def simulate(tree: Tree, model, rates, nsites: int,
             rng: np.random.Generator) -> dict[str, str]:
    """One alignment under any model of the factory: a mixture class by
    site (simulate_mixture), a nonreversible model by expm
    (simulate_nonrev), any other through simulate_alignment."""
    if isinstance(model, MixtureModel):
        return simulate_mixture(tree, model, rates, nsites, rng)
    if is_nonrev(model):
        return simulate_nonrev(tree, model, rates, nsites, rng)
    return simulate_alignment(tree, model, rates, nsites, rng)


def mimic_alignment(aln, tree: Tree, model, rates,
                    rng: np.random.Generator) -> dict[str, str]:
    """Input-mimicking simulation (reference: --alisim with -s ALN,
    simulator copies the input's length and gap pattern,
    alisimulator.h input-mimicking path)."""
    seqs = simulate(tree, model, rates, aln.nsites, rng)
    # superimpose the input gap/unknown mask, a state at a time (a codon's
    # three characters)
    width = len(model_state_chars(model)[0])
    codes = aln.tip_codes()          # [L, P]
    unk = aln.seqtype.unknown_code
    out = {}
    for i, name in enumerate(aln.names):
        if name not in seqs:
            continue
        sim = [seqs[name][k:k + width]
               for k in range(0, len(seqs[name]), width)]
        pat = codes[i][aln.site_to_pattern]          # [nsites]
        for s_idx in np.nonzero(pat == unk)[0]:
            sim[s_idx] = "-" * width
        out[name] = "".join(sim)
    return out


def write_fasta(path, seqs: dict[str, str]) -> None:
    with open(path, "w") as f:
        for n, s in seqs.items():
            f.write(f">{n}\n")
            for i in range(0, len(s), 80):
                f.write(s[i:i + 80] + "\n")


def write_phylip_seqs(path, seqs: dict[str, str]) -> None:
    names = list(seqs)
    with open(path, "w") as f:
        f.write(f"{len(names)} {len(seqs[names[0]])}\n")
        for n in names:
            f.write(f"{n:<12}{seqs[n]}\n")


def dummy_alignment(names: list[str], seqtype: str):
    """An alignment of ``names`` over one copy of each state of
    ``seqtype`` (DNA, AA, BIN or CODON[n])."""
    from iqtree2_tpu_torch.data.alignment import Alignment
    st = seqtype.upper()
    if st.startswith("CODON"):
        from iqtree2_tpu_torch.model.codon import sense_codons
        seq = "".join(sense_codons(int(st[5:]) if len(st) > 5 else 1))
    elif st in DUMMY_SEQUENCES:
        seq = DUMMY_SEQUENCES[st]
    else:
        raise SystemExit(f"--alisim -st {seqtype}: simulation of this "
                         f"sequence type is not ported to "
                         f"iqtree2_tpu_torch")
    return Alignment.from_sequences(names, [seq] * len(names), seqtype=st)


def alisim_model(model_str: str, names: list[str], seqtype: str | None):
    """(model, rates) of ``model_str`` built on a dummy alignment of its
    own sequence type: -st's where given, else the first of
    ALISIM_SEQTYPES whose dummy the factory builds the model on with as
    many states (the JAX package builds every model on DNA, ROADMAP C22)."""
    from iqtree2_tpu_torch.model.factory import build_model
    last = None
    for st in ([seqtype] if seqtype else ALISIM_SEQTYPES):
        dummy = dummy_alignment(names, st)
        try:
            model, rates, extras = build_model(model_str, dummy)
        except (ValueError, AssertionError, KeyError) as exc:
            last = exc
            continue
        if model.num_states != dummy.num_states:
            continue
        for key, what in (("mixlen", "+H"), ("treemix", "+T"),
                          ("pomo", "+P"), ("asc", "+ASC")):
            if extras.get(key):
                raise SystemExit(f"--alisim -m {model_str}: simulation "
                                 f"under {what} is not ported to "
                                 f"iqtree2_tpu_torch (the JAX package "
                                 f"ignores the term)")
        return model, rates
    raise SystemExit(f"--alisim -m {model_str}: no sequence type "
                     f"({seqtype or ', '.join(ALISIM_SEQTYPES)}) takes "
                     f"this model ({last})")


def run_alisim(params) -> list[str]:
    """CLI entry (--alisim PREFIX [-t TREE] [-m MODEL] [--length N])."""
    # MPI-style replicate splitting (reference: AliSim's MPI mode splits
    # --num-alignments across ranks, simulator/alisimulator.cpp): rank r
    # of n writes replicates r, r+n, ... Per-replicate RNG streams are
    # derived from (seed, replicate), so the union of all ranks' outputs
    # is byte-identical to a single-process run.
    nprocs = max(int(getattr(params, "sim_nprocs", 1) or 1), 1)
    rank = int(getattr(params, "sim_rank", 0) or 0)
    if not (0 <= rank < nprocs):
        raise SystemExit(f"--alisim-rank {rank} out of range for "
                         f"--alisim-nprocs {nprocs}")

    def rep_rng(i: int) -> np.random.Generator:
        return np.random.default_rng([params.seed, i])

    tree_file = params.user_tree or params.start_tree
    if not tree_file:
        raise SystemExit("--alisim requires a tree via -t TREE")
    nwk = Path(tree_file).read_text()
    tree = Tree.from_newick(nwk)  # taxon names from the newick itself

    model_str = params.model if params.model.upper() not in (
        "MFP", "TEST", "MF", "TESTONLY") else "HKY"

    if params.partition_file:
        # partitioned simulation: one model per partition, concatenated
        # columns (reference: AliSim partition mode, main/alisim.cpp)
        from iqtree2_tpu_torch.data.superalignment import read_partition_spec
        from iqtree2_tpu_torch.model.factory import build_model
        sa = read_partition_spec(params.partition_file, params.aln_file,
                                 params.seqtype)
        outs = []
        for i in range(params.sim_num_alignments):
            if i % nprocs != rank:
                continue
            rng = rep_rng(i)
            seqs_all = {n: [] for n in tree.taxon_names}
            for part, mstr in zip(sa.partitions, sa.part_models):
                m_p, r_p, _ = build_model(mstr or model_str, part)
                s_p = simulate(tree, m_p, r_p, part.nsites, rng)
                for n in tree.taxon_names:
                    seqs_all[n].append(s_p[n])
            seqs = {n: "".join(v) for n, v in seqs_all.items()}
            suffix = f"_{i + 1}" if params.sim_num_alignments > 1 else ""
            out = f"{params.alisim}{suffix}.phy"
            write_phylip_seqs(out, seqs)
            outs.append(out)
            print(f"AliSim: wrote {out} ({len(seqs)} taxa x "
                  f"{len(next(iter(seqs.values())))} sites, "
                  f"{sa.n_partitions} partitions)")
        return outs

    model, rates = alisim_model(model_str, tree.taxon_names, params.seqtype)

    mimic = None
    if params.aln_file:
        # input-mimicking mode: copy length + gap pattern of a real
        # alignment (reference: --alisim ... -s aln)
        from iqtree2_tpu_torch.io.alignment_io import read_alignment
        mimic = read_alignment(params.aln_file, seqtype=params.seqtype)

    ins_rate = del_rate = 0.0
    if params.indel:
        parts = [float(x) for x in params.indel.split(",")]
        ins_rate = parts[0]
        del_rate = parts[1] if len(parts) > 1 else parts[0]
    indel = ins_rate > 0 or del_rate > 0
    if indel and isinstance(model, MixtureModel):
        raise SystemExit(f"--indel with -m {model_str}: indels under a "
                         f"mixture model are not ported to "
                         f"iqtree2_tpu_torch (the JAX package draws every "
                         f"site from class 0, ROADMAP C11)")

    outs = []
    for i in range(params.sim_num_alignments):
        if i % nprocs != rank:
            continue
        rng = rep_rng(i)
        if mimic is not None:
            seqs = mimic_alignment(mimic, tree, model, rates, rng)
        elif indel:
            seqs = simulate_alignment_indel(
                tree, model, rates, params.sim_length, rng,
                ins_rate=ins_rate, del_rate=del_rate,
                mean_indel_size=params.indel_size,
                pmatrix=nonrev_pmatrix(model) if is_nonrev(model) else None)
        else:
            seqs = simulate(tree, model, rates, params.sim_length, rng)
        suffix = f"_{i + 1}" if params.sim_num_alignments > 1 else ""
        nsites_out = len(next(iter(seqs.values())))
        if indel:
            out = f"{params.alisim}{suffix}.fa"
            write_fasta(out, seqs)
        else:
            out = f"{params.alisim}{suffix}.phy"
            write_phylip_seqs(out, seqs)
        outs.append(out)
        print(f"AliSim: wrote {out} ({len(seqs)} taxa x "
              f"{nsites_out} sites, model {model_str})")
    return outs
