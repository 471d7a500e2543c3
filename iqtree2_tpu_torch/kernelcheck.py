"""Each Hopper kernel held against its plain PyTorch version on the card.

Used by chip_smoke.py and tests/test_torch_cuda.py (the parity tests use
its ``simulate``). A problem is an alignment simulated under one of MODELS on
a random topology (a mixture class by class, a nonreversible model through
expm, simulate; the root test's shape by rooted_problem, on the engine
make_engine picks), or a supermatrix
of PARTITIONS (simulate_partitioned),
whose every partition engine is one problem; every kernel then gets exactly
the inputs its plain version gets:

- down_pass: the plain down pass with its site-logL epilogue
  (down_pass_plain) is the reference; the kernel runs the whole pass and
  the epilogue on fresh buffers;
- up_pass and theta_pass: the plain sweeps (up_pass_plain,
  theta_pass_plain) over the reference down pass are the references; each
  kernel runs the whole sweep on fresh buffers over that down pass.

Before a pass runs, every row it writes is set to a sentinel (NaN partials
and lp, scale count -1), so a row the kernel leaves unwritten fails the
comparison instead of passing as the reference's copy; the tip rows of the
unified buffer are NaN in every down pass here, so a pass that reads them
instead of the tips fails too. ``bounds`` gives each kernel's least
possible time on an H100 for the same work.

Errors are relative per (row, pattern) column: max |kernel - plain| over the
C x S values over their largest |plain|, the scale that the per-pattern
rescale also uses (theta mixes signs, so element-wise ratios of values that
cancel say nothing). Site log-likelihoods are compared absolutely in
float32 and relative to max(|lp|, 1) in float64. Scale counts must be equal.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from iqtree2_tpu_torch import simulator, timetree
from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.data.superalignment import (SuperAlignment,
                                                   build_superalignment)
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io import yamlmodels
from iqtree2_tpu_torch.io.alignment_io import read_alignment, write_phylip
from iqtree2_tpu_torch.model.codon import sense_codons
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.heterotachy import MixlenEngine, RateHeterotachy
from iqtree2_tpu_torch.model.mixture import MixtureModel
from iqtree2_tpu_torch.ops import kernels, pruning
from iqtree2_tpu_torch.ops.pruning import DownPass
from iqtree2_tpu_torch.roottest import root_alignment, rooted_tree_on_branch
from iqtree2_tpu_torch.search.perturb import random_nnis
from iqtree2_tpu_torch.simulator import model_state_chars, simulate_alignment
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree

# fixed FreeRate categories (weights, rates) and protein frequencies of the
# +R10 and +F problems below
_R10_WEIGHTS = (0.02, 0.05, 0.08, 0.1, 0.15, 0.2, 0.15, 0.12, 0.08, 0.05)
_R10_RATES = (0.01, 0.05, 0.15, 0.3, 0.5, 0.8, 1.2, 1.8, 2.8, 4.5)
_AA_FREQS = (0.08, 0.06, 0.04, 0.05, 0.02, 0.04, 0.07, 0.07, 0.02, 0.05,
             0.1, 0.06, 0.02, 0.04, 0.05, 0.07, 0.05, 0.01, 0.03, 0.07)
# fixed UNREST rates and Lie-Markov 12.12 parameters whose rate matrices
# have complex eigenvalues (the imaginary parts are the largest of 2000
# draws each)
_UNREST_RATES = (3.9, 3.3, 0.1, 0.4, 0.4, 0.9, 0.2, 0.7, 3.4, 3.5, 2.7, 1.0)
_LM_PARAMS = (-0.23, 0.24, -0.78, 0.34, 0.57, 0.48, -0.89, -0.57, 0.46,
              0.18, 0.64)

# name -> (sequence type, state alphabet, model string with every parameter
# fixed, so the problem is the same in every run)
MODELS = {
    "GTR+G4": ("DNA", "ACGT",
               "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+G{0.6}"),
    "LG+G4": ("AA", "ARNDCQEGHILKMFPSTWYV", "LG+G{0.6}"),
    "HKY+I": ("DNA", "ACGT", "HKY{3.0}+F{0.3,0.2,0.2,0.3}+I{0.2}"),
    # 8 categories: more than the DNA register column holds (kRegCats)
    "GTR+G8": ("DNA", "ACGT",
               "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+G8{0.6}"),
    # the shapes ModelFinder's candidates bring: one category (C = 1), a
    # FreeRate model's unequal weights with +I (a finite log_ptn_invar in
    # the epilogue), ten categories, and both at 20 states (C * S = 200)
    "JC": ("DNA", "ACGT", "JC"),
    "GTR+I+R3": ("DNA", "ACGT",
                 "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+I{0.2}"
                 "+R3{0.2,0.3,0.5,1.0,0.3,2.2}"),
    "GTR+R10": ("DNA", "ACGT",
                "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}+R10{"
                + ",".join(f"{w},{r}" for w, r in zip(_R10_WEIGHTS,
                                                      _R10_RATES)) + "}"),
    "LG+I": ("AA", "ARNDCQEGHILKMFPSTWYV", "LG+I{0.2}"),
    "LG+F+R10": ("AA", "ARNDCQEGHILKMFPSTWYV",
                 "LG+F{" + ",".join(str(f) for f in _AA_FREQS) + "}+R10{"
                 + ",".join(f"{w},{r}" for w, r in zip(_R10_WEIGHTS,
                                                       _R10_RATES)) + "}"),
    # mixtures: a profile mixture's classes times the Gamma categories,
    # each category with its class's eigensystem (C = 80 and 240), and
    # LG4X's four classes each fused with one FreeRate category (C = 4,
    # four eigensystems); MIX of two matrices (C = 8)
    "LG+C20+G4": ("AA", "ARNDCQEGHILKMFPSTWYV", "LG+C20+G{0.6}"),
    "LG+C60+G4": ("AA", "ARNDCQEGHILKMFPSTWYV", "LG+C60+G{0.6}"),
    "LG4X": ("AA", "ARNDCQEGHILKMFPSTWYV",
             "LG4X+R4{0.2,0.2,0.3,0.7,0.3,1.2,0.2,2.0}"),
    "MIX{LG,WAG}+G4": ("AA", "ARNDCQEGHILKMFPSTWYV", "MIX{LG,WAG}+G{0.6}"),
    # the model families of codon data (S = 61, the S <= 64 instance, an
    # odd width; the alphabet is the 61 sense triplets), +E sequencing
    # error (tip rows of 1 - eps and eps / 3, not indicators), two states
    # (binary data, the S <= 4 instance) and seven (a --mdef datatype,
    # YAML_DATATYPES, the S <= 20 instance)
    "GY+F3X4+G4": ("CODON1", "".join(sense_codons(1)),
                   "GY{2.0,0.3}+F3X4+G{0.8}"),
    "KOSI07+G4": ("CODON1", "".join(sense_codons(1)), "KOSI07+G{0.8}"),
    "HKY+E+G4": ("DNA", "ACGT",
                 "HKY{3.0}+F{0.3,0.2,0.2,0.3}+E{0.02}+G{0.6}"),
    "JC2+G4": ("BIN", "01", "JC2+G{0.6}"),
    "MK7+G4": ("STATES7", "ABCDEFG", "MK+G{0.6}"),
    # the nonreversible and per-class-length families: UNREST with a
    # complex pair of eigenvalues (-2.36 +- 0.70i) and the full Lie-Markov
    # model 12.12 with one (-1.39 +- 0.50i), both simulated by expm(Q t)
    # (simulate_nonrev); PoMo at N = 9 (52 states, the S <= 64 instance;
    # tips of k/N sampling weights, simulated as DNA, SIMULATE_UNDER); four
    # +H classes of rate 1 whose lengths spread 0.5x to 1.5x the tree's
    # (MixlenEngine.init_blens2), through make_engine
    "UNREST+G4": ("DNA", "ACGT", "UNREST{" + ",".join(
        str(r) for r in _UNREST_RATES) + "}+G{0.6}"),
    "12.12+G4": ("DNA", "ACGT", "12.12{" + ",".join(
        str(p) for p in _LM_PARAMS) + "}+G{0.6}"),
    "GTR+P+G4": ("DNA", "ACGT", "GTR{1.5,4.0,1.2,0.8,5.0}+P{0.01}+G{0.6}"),
    "GTR+H4": ("DNA", "ACGT", "GTR{1.5,4.0,1.2,0.8,5.0}+F{0.3,0.2,0.2,0.3}"
               "+H4"),
    # PoMo past 64 states, the kernels' wide instance: N = 13, 19 and 23
    # (76, 112 and 136 states), simulated as DNA as GTR+P+G4 is
    "GTR+P13+G4": ("DNA", "ACGT",
                   "GTR{1.5,4.0,1.2,0.8,5.0}+P13{0.01}+G{0.6}"),
    "GTR+P19+G4": ("DNA", "ACGT",
                   "GTR{1.5,4.0,1.2,0.8,5.0}+P19{0.01}+G{0.6}"),
    "GTR+P23+G4": ("DNA", "ACGT",
                   "GTR{1.5,4.0,1.2,0.8,5.0}+P23{0.01}+G{0.6}"),
    # N = 76 (454 states): past what a block's shared memory stages in
    # float64, where the wide passes read their columns in place
    "GTR+P76+G4": ("DNA", "ACGT",
                   "GTR{1.5,4.0,1.2,0.8,5.0}+P76{0.01}+G{0.6}"),
}
# a 65-state --mdef datatype, the wide instance's narrowest width under a
# reversible model (whose Newton runs theta_pass; PoMo's runs both passes):
# every printable ASCII character but the lower case (sequences are read
# upper-cased), ", \ and ?, which marks missing data
STATES65 = "".join(chr(c) for c in range(33, 127)
                   if not chr(c).islower() and chr(c) not in '"\\?')
MODELS["MK65+G4"] = ("STATES65", STATES65, "MK+G{0.6}")
# problems simulated under another model than the one they are fitted
# under: PoMo's polymorphic states are not the alignment's
SIMULATE_UNDER = {name: "GTR+G4" for name in ("GTR+P+G4", "GTR+P13+G4",
                                               "GTR+P19+G4", "GTR+P23+G4",
                                               "GTR+P76+G4")}
# the datatypes of MODELS that --mdef defines: name -> its definition,
# registered by simulate where it is first asked for
YAML_DATATYPES = {"STATES7": "- datatype: STATES7\n"
                             "  state: [A, B, C, D, E, F, G]\n",
                  "STATES65": "- datatype: STATES65\n  state: ["
                              + ", ".join(f'"{c}"' for c in STATES65)
                              + ']\n  missing: "?"\n'}
# the partitioned path's shapes, one supermatrix each: per partition the
# MODELS name, its sites and the share of taxa it lacks (all-gap rows on the
# union taxon set)
PARTITIONS = {
    # patterns under 512 and not a multiple of the engine's PATTERN_PAD
    "short DNA": (("GTR+G4", 300, 0.0),),
    # one partition lacks a quarter of the taxa
    "gappy supermatrix": (("GTR+G4", 500, 0.0), ("HKY+I", 400, 0.25)),
    # a protein partition beside a DNA one, as a NEXUS partition file that
    # names two alignment files gives (read_partition_spec)
    "DNA + protein": (("GTR+G4", 400, 0.0), ("LG+G4", 200, 0.0)),
}
# bytes of the plain references' largest temporary before check() runs them
# window by window (plain_window)
PLAIN_BYTES = 2 ** 33
# float64: 1e-9 relative everywhere; float32: 1e-4 relative on partials and
# theta, 1e-3 absolute on site log-likelihoods
TOLERANCE = {torch.float64: {"partials": 1e-9, "lp": 1e-9},
             torch.float32: {"partials": 1e-4, "lp": 1e-3}}


def class_sites(weights, nsites: int) -> np.ndarray:
    """Sites per mixture class, in proportion to the class weights and
    summing to nsites (largest remainders)."""
    share = np.asarray(weights, np.float64) * nsites
    n = np.floor(share).astype(np.int64)
    n[np.argsort(n - share)[: nsites - n.sum()]] += 1
    return n


def simulate_mixture(tree: Tree, model: MixtureModel, rates, nsites: int,
                     rng) -> dict[str, str]:
    """{taxon: sequence} under a mixture, one class at a time: a block of
    sites per class (class_sites) simulated under that class alone
    (simulator.simulate_mixture), the blocks concatenated. The JAX
    simulator draws every site from class 0 (ROADMAP C11)."""
    counts = class_sites(model.weights, nsites)
    return simulator.simulate_mixture(
        tree, model, rates, nsites, rng,
        site_class=np.repeat(np.arange(len(counts)), counts))


def simulate_nonrev(tree: Tree, model, rates, nsites: int,
                    rng) -> dict[str, str]:
    """{taxon: sequence} under a nonreversible model, P(t) = expm(Q t)
    (simulator.simulate_nonrev; ROADMAP C18)."""
    return simulator.simulate_nonrev(tree, model, rates, nsites, rng)


def simulate(model_name: str, ntaxa: int, nsites: int, seed: int):
    """(Alignment, true Tree, model, rates) simulated under MODELS[name]
    (a mixture class by class, simulate_mixture; a nonreversible model by
    expm, simulate_nonrev; SIMULATE_UNDER's problems under their DNA
    model), with the model and rates of MODELS[name] on the result."""
    seqtype, alphabet, model_str = MODELS[model_name]
    sim_str = MODELS[SIMULATE_UNDER.get(model_name, model_name)][2]
    if seqtype in YAML_DATATYPES and seqtype not in yamlmodels.DATATYPES:
        yamlmodels.define(YAML_DATATYPES[seqtype])
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    tree = Tree.random_topology(names, rng)
    dummy = Alignment.from_sequences(names, [alphabet] * ntaxa,
                                     seqtype=seqtype)
    model, rates, _ = build_model(sim_str, dummy)
    if isinstance(model, MixtureModel):
        seqs = simulate_mixture(tree, model, rates, nsites, rng)
    elif model.get_eigensystem().Q is not None:
        seqs = simulate_nonrev(tree, model, rates, nsites, rng)
    else:
        seqs = simulate_alignment(tree, model, rates, nsites, rng)
    chars = "".join(model_state_chars(model))
    if chars != alphabet:
        # a --mdef datatype's states, which the simulator numbers
        seqs = {k: v.translate(str.maketrans(chars, alphabet))
                for k, v in seqs.items()}
    aln = Alignment.from_sequences(list(seqs), list(seqs.values()),
                                   seqtype=seqtype)
    model, rates, _ = build_model(model_str, aln)
    return aln, Tree.from_newick(tree.to_newick(), aln.names), model, rates


def simulate_loci(loci, ntaxa: int, seed: int
                  ) -> tuple[SuperAlignment, Tree, list, list]:
    """(SuperAlignment, true Tree, models, rates) of loci simulated on one
    random topology (a mixture class by class, simulate_mixture): per
    locus (sequence type, model string with every parameter fixed, sites,
    share of taxa it lacks, rate multiplier of the tree's lengths).
    The taxa a locus lacks are drawn from the seed and left out of it (so
    absent from its presence mask and all-unknown on the union taxon
    set); a taxon every locus would lack stays in the last one."""
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    tree = Tree.random_topology(names, rng)
    drawn = []
    for seqtype, model_str, nsites, gaps, rate in loci:
        alphabet = {st: al for st, al, _ in MODELS.values()}[seqtype]
        dummy = Alignment.from_sequences(names, [alphabet] * ntaxa,
                                         seqtype=seqtype)
        model, rates, _ = build_model(model_str, dummy)
        scaled = tree.copy()
        for key in scaled.blen:
            scaled.blen[key] *= rate
        if isinstance(model, MixtureModel):
            seqs = simulate_mixture(scaled, model, rates, nsites, rng)
        else:
            seqs = simulate_alignment(scaled, model, rates, nsites, rng)
        drop = set(rng.choice(ntaxa, int(gaps * ntaxa), replace=False)
                   .tolist())
        drawn.append((seqtype, seqs, drop))
    nowhere = set.intersection(*(drop for _, _, drop in drawn))
    drawn[-1] = drawn[-1][:2] + (drawn[-1][2] - nowhere,)
    parts = []
    for k, (seqtype, seqs, drop) in enumerate(drawn):
        keep = [n for i, n in enumerate(names) if i not in drop]
        part = Alignment.from_sequences(keep, [seqs[n] for n in keep],
                                        seqtype=seqtype)
        part.name = f"part{k + 1}"
        parts.append(part)
    strs = [model_str for _, model_str, _, _, _ in loci]
    sa = build_superalignment(parts, strs)
    built = [build_model(m, p) for m, p in zip(strs, sa.partitions)]
    return (sa, Tree.from_newick(tree.to_newick(), sa.names),
            [b[0] for b in built], [b[1] for b in built])


def simulate_partitioned(name: str, ntaxa: int, seed: int
                         ) -> tuple[SuperAlignment, Tree, list, list]:
    """simulate_loci of PARTITIONS[name], each partition at rate 1."""
    return simulate_loci([(MODELS[m][0], MODELS[m][2], nsites, gaps, 1.0)
                          for m, nsites, gaps in PARTITIONS[name]],
                         ntaxa, seed)


def write_partitioned(sa: SuperAlignment, models: list[str],
                      directory) -> str:
    """A supermatrix as a NEXUS partition file naming one PHYLIP file per
    partition (its present taxa only) and the partition's model from
    ``models`` (strings without commas: a charpartition splits at them);
    returns the partition file's path."""
    directory = Path(directory)
    lines = ["#nexus", "begin sets;"]
    for p, pres, name in zip(sa.partitions, sa.part_presence,
                             sa.part_names):
        write_phylip(p.subset_taxa(list(np.nonzero(pres)[0])),
                     directory / f"{name}.phy")
        lines.append(f"  charset {name} = {name}.phy: {p.seqtype.name}, "
                     f"1-{p.nsites};")
    lines.append("  charpartition models = " + ", ".join(
        f"{m}: {n}" for m, n in zip(models, sa.part_names)) + ";")
    path = directory / "partitions.nex"
    path.write_text("\n".join(lines + ["end;"]) + "\n")
    return str(path)


def make_engine(aln, model, rates, **kw) -> LikelihoodEngine:
    """The engine a model takes: a MixlenEngine for +H (per-class lengths),
    else a LikelihoodEngine (kw: dtype, device)."""
    if isinstance(rates, RateHeterotachy):
        return MixlenEngine(aln, model, rates, **kw)
    return LikelihoodEngine(aln, model, rates, **kw)


def rooted_problem(aln: Alignment, tree: Tree) -> tuple[Alignment, Tree]:
    """The root test's shape of a problem: the all-unknown pseudo-taxon
    __ROOT__ as leaf 0 on a zero-length edge (P_0 = I, the root's
    neighbourhood without data) spliced into the tree's first edge
    (roottest.root_alignment, rooted_tree_on_branch)."""
    a, b = sorted(tree.edges())[0]
    return root_alignment(aln), rooted_tree_on_branch(tree, a, b)


def load_problem(aln_path, tree_path, model_name: str):
    """(Alignment, Tree, model, rates) of an alignment file and a Newick
    tree file under MODELS[name]'s fixed parameters."""
    aln = read_alignment(str(aln_path))
    model, rates, _ = build_model(MODELS[model_name][2], aln)
    tree = Tree.from_newick(Path(tree_path).read_text(), aln.names)
    return aln, tree, model, rates


def clock_dates(tree: Tree, rate: float, origin: float = 2000.0
                ) -> dict[str, float]:
    """{taxon: date} under a strict clock of ``rate`` on ``tree`` rooted at
    its midpoint (timetree.midpoint_root, where date_tree roots it without
    an outgroup): origin plus each tip's distance from that root over the
    rate, so that the tree fits the dates exactly."""
    a, b, frac = timetree.midpoint_root(tree)
    ln = tree.get_blen(a, b)
    dates = {}
    for start, away, d0 in ((a, b, frac * ln), (b, a, (1 - frac) * ln)):
        seen, stack = {start: d0, away: None}, [start]
        while stack:
            v = stack.pop()
            for u in tree.adj[v]:
                if u not in seen:
                    seen[u] = seen[v] + tree.get_blen(u, v)
                    stack.append(u)
        dates.update({tree.taxon_names[v]: origin + d / rate
                      for v, d in seen.items()
                      if d is not None and tree.is_leaf(v)})
    return dates


def perturbed(tree: Tree, seed: int, strength: float) -> tuple[Tree, int]:
    """A copy of ``tree`` moved by the search's random NNIs
    (search/perturb.random_nnis), and the number of moves."""
    start = tree.copy()
    return start, random_nnis(start, np.random.default_rng(seed), strength)


def write_problem(aln: Alignment, tree: Tree, prefix) -> tuple[str, str]:
    """Write a simulated problem for the command line: (PHYLIP alignment
    path, Newick tree path)."""
    aln_path, tree_path = f"{prefix}.phy", f"{prefix}.nwk"
    write_phylip(aln, aln_path)
    Path(tree_path).write_text(tree.to_newick() + "\n")
    return aln_path, tree_path


def col_rel(a, b) -> float:
    """max over columns of max|a - b| / max|b| over the trailing [C, S]."""
    num = (a - b).abs().amax(dim=(-3, -2))
    den = b.abs().amax(dim=(-3, -2)).clamp(min=torch.finfo(b.dtype).tiny)
    return float((num / den).max())


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after warm-up),
    the host launching as it goes: where a kernel is shorter than the
    host's work per launch, this is the host's launch rate ("loaded")."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# clock cycles the card spins per queued call in back_to_back_ms: 100 us
# of host time per call at 2 GHz
SLEEP_CYCLES_PER_CALL = 200_000
B2B_REPS = 50


def back_to_back_ms(fn, reps: int = B2B_REPS) -> float:
    """Mean milliseconds of fn() with its reps launches queued behind a
    kernel that spins on the card (torch.cuda._sleep), so that they run
    back to back whatever the host's launch rate: the device time of a
    launch. fn must not wait for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _pair(fk, fp, reps: int, plain_reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two runs taken in the order
    plain, kernel, kernel, plain, so drift in clocks hits both alike."""
    p1 = timed_ms(fp, plain_reps)
    k1 = timed_ms(fk, reps)
    k2 = timed_ms(fk, reps)
    p2 = timed_ms(fp, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


class ThetaBuffers(NamedTuple):
    up: torch.Tensor         # [n_int, C, S, Pp] UP per internal node
    up_scale: torch.Tensor
    theta: torch.Tensor      # [n_edges, C, S, Pp]
    scale: torch.Tensor


class Problem:
    """The tensors every kernel of one (engine, tree) problem takes."""

    def __init__(self, eng: LikelihoodEngine, tree: Tree):
        self.sched = build_schedule(tree)
        sa = eng.schedule_arrays(self.sched)
        self.pack, self.tipP = eng._pack, eng._tipP
        # per-class lengths [E, H] on a MixlenEngine (+H)
        blens = (eng._t(eng._blens2_for(tree, self.sched))
                 if isinstance(eng, MixlenEngine) else eng._blens(self.sched))
        self.P = pruning.transition_tensors(blens, self.pack)
        self.cs, self.ce = sa["child_src"], sa["child_edge"]
        self.steps = sa["step_node"]
        self.L = self.tipP.shape[0]
        self.n_int = self.sched.n_int
        cat_mix = self.pack["cat_mix"]
        self.U = self.pack["U"][cat_mix].contiguous()
        self.V = self.pack["V"][cat_mix].contiguous()

    def window(self, a: int, b: int) -> "Problem":
        """This problem on patterns [a, b) alone (tips and invariant-site
        terms cut; the patterns are independent)."""
        sub = copy.copy(self)
        sub.tipP = self.tipP[..., a:b].contiguous()
        sub.pack = {**self.pack,
                    "log_ptn_invar": self.pack["log_ptn_invar"][a:b]}
        return sub

    def down_buffers(self):
        """Down-pass buffers without tips, their tip rows NaN: no pass may
        read them."""
        dp = pruning.down_buffers(self.P, self.tipP, self.n_int, tips=False)
        dp.all[:self.L] = float("nan")
        return dp

    def up_buffers(self, dp):
        return pruning.up_buffers(self.P, dp, self.tipP,
                                  self.pack["root_freqs"])

    def lp_buffer(self):
        return torch.full(self.tipP.shape[-1:], float("nan"),
                          dtype=self.tipP.dtype, device=self.tipP.device)

    def sitelp(self, lp):
        """down_pass's epilogue operands, writing into lp."""
        return (self.pack["root_freqs"], self.pack["cat_weight"],
                self.pack["log_ptn_invar"], lp)

    def theta_buffers(self) -> ThetaBuffers:
        """theta_pass's outputs, every row a sentinel (NaN, scale -1)."""
        L, S, Pp = self.tipP.shape
        C, n_edges = self.P.shape[1], self.P.shape[0]
        kw = dict(dtype=self.tipP.dtype, device=self.tipP.device)
        ikw = dict(dtype=torch.int32, device=self.tipP.device)
        return ThetaBuffers(
            torch.full((self.n_int, C, S, Pp), float("nan"), **kw),
            torch.full((self.n_int, Pp), -1, **ikw),
            torch.full((n_edges, C, S, Pp), float("nan"), **kw),
            torch.full((n_edges, Pp), -1, **ikw))

    def down(self, fn, dp, sitelp=None):
        args = (self.P, self.tipP, dp.all, dp.scale, self.cs, self.ce,
                self.steps)
        if sitelp is None:
            fn(*args)
        else:
            fn(*args, sitelp=sitelp)
        return dp

    def up(self, fn, dp, u):
        fn(self.P, self.tipP, dp.all, dp.scale, u.up_in, u.up_scale,
           u.edge_E, u.edge_E_scale, self.cs, self.ce, self.steps)
        return u

    def theta(self, fn, dp, t: ThetaBuffers):
        fn(self.P, self.tipP, dp.all, dp.scale, t.up, t.up_scale, t.theta,
           t.scale, self.cs, self.ce, self.steps, self.U, self.V,
           self.pack["root_freqs"])
        return t


def lp_error(lp, ref, dtype) -> float:
    """Site log-likelihood error: absolute in float32, relative to
    max(|lp|, 1) in float64 (TOLERANCE["lp"])."""
    err = (lp - ref).abs()
    if dtype == torch.float64:
        err = err / ref.abs().clamp(min=1.0)
    return float(err.max())


def windows(Pp: int, window: int | None) -> list[tuple[int, int]]:
    """Pattern windows [a, b) of at most ``window`` patterns covering Pp
    (one window when window is None)."""
    w = Pp if window is None else max(1, min(window, Pp))
    return [(a, min(a + w, Pp)) for a in range(0, Pp, w)]


def plain_window(eng: LikelihoodEngine,
                 budget: float = PLAIN_BYTES) -> int | None:
    """Patterns per window of the plain references, so that their largest
    temporary (edge_theta_plain's [n_edges, C, S, S, patterns] product)
    stays within ``budget`` bytes; None where the whole problem does."""
    n_edges = 2 * len(eng.aln.names) - 3
    C, S = int(eng._pack["cat_rate"].shape[0]), eng._tipP.shape[1]
    per = n_edges * C * S * S * torch.finfo(eng.dtype).bits // 8
    w = int(budget // per)
    return None if w >= eng.Pp else max(w, 1)


def check(eng: LikelihoodEngine, tree: Tree, time_reps: int = 0,
          window: int | None = None, b2b_reps: int = B2B_REPS) -> list:
    """Compare the three kernels with their plain versions on one problem.

    Returns one dict per kernel, down_pass (with its site-logL epilogue),
    up_pass, theta_pass: name, max_abs_err, max_rel_err, scales_equal, tol,
    ok (down_pass also lp_err against lp_tol; theta_pass compares theta and
    UP), launches (the kernel's launches for its one pass; down_pass also
    sitelp_launches). The kernels run on the whole problem; the plain
    versions, whose temporaries are S times a pass's buffers, run window
    by window of ``window`` patterns (windows; the patterns are
    independent, so this is exact), the reference down pass assembled
    whole as the up and theta kernels' input. With time_reps > 0 also ms
    and plain_ms, the mean time of one pass alone, the kernel's buffers
    built outside the timed region (time_buffers times those; the plain
    version's inside it, one run over all windows where there are
    several), and b2b_ms, b2b_reps of the kernel's launches back to back
    (back_to_back_ms); down_pass's are without the epilogue, its
    sitelp_ms, sitelp_plain_ms and sitelp_b2b_ms with it."""
    pb = Problem(eng, tree)
    L = pb.L
    tol = TOLERANCE[eng.dtype]
    wins = windows(pb.tipP.shape[-1], window)

    # the reference down pass: the plain pass window by window, into whole
    # buffers whose tip rows are NaN
    dp, lp_ref = pb.down_buffers(), pb.lp_buffer()
    for a, b in wins:
        sub = pb.window(a, b)
        lp_w = sub.lp_buffer()
        d_w = sub.down(kernels.down_pass_plain, sub.down_buffers(),
                       sub.sitelp(lp_w))
        dp.all[..., a:b] = d_w.all
        dp.scale[:, a:b] = d_w.scale
        lp_ref[a:b] = lp_w
        del d_w

    # the kernels, every row they write a sentinel first: H1 down_pass
    # writes every internal row and lp; H2 up_pass E of every child edge
    # and UP of every internal child (E of edge 0 and UP of the root come
    # from up_buffers); H3 theta_pass theta of every edge and UP of every
    # internal node
    before = dict(kernels.LAUNCHES)
    got = pb.down_buffers()
    got.all[L:] = float("nan")
    got.scale[L:] = -1
    lp = pb.lp_buffer()
    pb.down(kernels.down_pass, got, pb.sitelp(lp))
    u = pb.up_buffers(dp)
    eid = pb.ce.flatten().long()
    kid = pb.cs.flatten().long()
    kid = kid[kid >= L] - L
    u.edge_E[eid] = float("nan")
    u.edge_E_scale[eid] = -1
    u.up_in[kid] = float("nan")
    u.up_scale[kid] = -1
    pb.up(kernels.up_pass, dp, u)
    t = pb.theta(kernels.theta_pass, dp, pb.theta_buffers())
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}

    # the plain up and theta passes window by window over the reference,
    # each window's outputs held against the kernels'
    errs = {k: ([], [], []) for k in ("down_pass", "up_pass", "theta_pass")}
    lp_errs = []

    def held(name, pairs):
        ab, rel, sc = errs[name]
        for g, r in pairs:
            if r.dtype == torch.int32:
                sc.append(bool(torch.equal(g, r)))
            else:
                ab.append(float((g - r).abs().max()))
                rel.append(col_rel(g, r))

    for a, b in wins:
        sub = pb.window(a, b)
        d_w = DownPass(dp.all[..., a:b].contiguous(),
                       dp.scale[:, a:b].contiguous())
        held("down_pass", ((got.all[L:, ..., a:b], d_w.all[L:]),
                           (got.scale[:, a:b], d_w.scale)))
        ab = errs["down_pass"][0]
        ab.append(float((lp[a:b] - lp_ref[a:b]).abs().max()))
        lp_errs.append(lp_error(lp[a:b], lp_ref[a:b], eng.dtype))
        up_w = sub.up(kernels.up_pass_plain, d_w, sub.up_buffers(d_w))
        held("up_pass", [(x[..., a:b], y) for x, y in zip(u, up_w)])
        del up_w
        th_w = sub.theta(kernels.theta_pass_plain, d_w, sub.theta_buffers())
        held("theta_pass", [(x[..., a:b], y) for x, y in zip(t, th_w)])
        del th_w, d_w
    if pb.tipP.is_cuda:
        torch.cuda.synchronize()

    # np.max, not max(): a NaN in either operand must carry through
    out = [dict(name=name, max_abs_err=float(np.max(ab)),
                max_rel_err=float(np.max(rel)), scales_equal=all(sc),
                tol=tol["partials"], launches=launched[name])
           for name, (ab, rel, sc) in errs.items()]
    out[0].update(lp_err=float(np.max(lp_errs)), lp_tol=tol["lp"],
                  sitelp_launches=launched["sitelp"])
    for r in out:
        r["ok"] = bool(r["max_rel_err"] <= r["tol"] and r["scales_equal"]
                       and r.get("lp_err", 0.0) <= r.get("lp_tol", 1.0))

    if time_reps:
        _time(pb, wins, got, lp, u, t, dp, time_reps, b2b_reps, out)
    return out


def _time(pb, wins, got, lp, u, t, dp, reps: int, b2b_reps: int,
          out) -> None:
    """check()'s times: the kernels rewrite their checked outputs (a pass
    rewrites every row it owns, so repeating it on the same buffers is the
    same work); the plain versions run window by window on buffers they
    build (over more than one window, once per timing)."""
    def over_windows(run):
        def fn():
            for a, b in wins:
                run(pb.window(a, b), DownPass(dp.all[..., a:b].contiguous(),
                                              dp.scale[:, a:b].contiguous()))
        return fn

    plain = {
        "down_pass": over_windows(lambda w, d: w.down(
            kernels.down_pass_plain, w.down_buffers())),
        "sitelp": over_windows(lambda w, d: w.down(
            kernels.down_pass_plain, w.down_buffers(),
            w.sitelp(w.lp_buffer()))),
        "up_pass": over_windows(lambda w, d: w.up(
            kernels.up_pass_plain, d, w.up_buffers(d))),
        "theta_pass": over_windows(lambda w, d: w.theta(
            kernels.theta_pass_plain, d, w.theta_buffers()))}
    lp_k = pb.sitelp(lp)
    kernel = {
        "down_pass": lambda: pb.down(kernels.down_pass, got),
        "sitelp": lambda: pb.down(kernels.down_pass, got, lp_k),
        "up_pass": lambda: pb.up(kernels.up_pass, dp, u),
        "theta_pass": lambda: pb.theta(kernels.theta_pass, dp, t)}
    plain_reps = reps if len(wins) == 1 else 1
    ms = {key: (*_pair(kernel[key], plain[key], reps, plain_reps),
                back_to_back_ms(kernel[key], b2b_reps)) for key in kernel}
    for r in out:
        r["ms"], r["plain_ms"], r["b2b_ms"] = ms[r["name"]]
    out[0]["sitelp_ms"], out[0]["sitelp_plain_ms"], \
        out[0]["sitelp_b2b_ms"] = ms["sitelp"]


def time_buffers(eng: LikelihoodEngine, tree: Tree, reps: int) -> dict:
    """Mean milliseconds of pruning.down_buffers with the tips copied in
    (the NNI round's), without them (a log-likelihood's, a theta pass's),
    and pruning.up_buffers (the root's rows) on the card: the set-up of a
    pass that check() leaves out of its times."""
    pb = Problem(eng, tree)
    dp = pb.down(kernels.down_pass, pb.down_buffers())
    return {"down_buffers": timed_ms(
                lambda: pruning.down_buffers(pb.P, pb.tipP, pb.n_int), reps),
            "down_buffers_no_tips": timed_ms(
                lambda: pruning.down_buffers(pb.P, pb.tipP, pb.n_int,
                                             tips=False), reps),
            "up_buffers": timed_ms(lambda: pb.up_buffers(dp), reps)}


# NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3; 67 TFLOP/s in float32
# outside the tensor cores, and 67 TFLOP/s in float64 on them (DMMA), the
# card's peak for each type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


def bounds(eng: LikelihoodEngine, tree: Tree) -> dict:
    """name -> dict(bytes, flops, bound_ms, bound_by): the least time an
    H100 could take for each kernel's work on this problem, the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its floating-point operations over the peak rate."""
    sched = build_schedule(tree)
    L, n_int, n_edges = sched.ntaxa, sched.n_int, sched.n_edges
    C = int(eng._pack["cat_rate"].shape[0])
    S, Pp = eng._tipP.shape[1], eng.Pp
    f = torch.finfo(eng.dtype).bits // 8
    col, scale = C * S * Pp * f, Pp * 4          # one row of partials, scales
    mats = n_edges * C * S * S * f
    index = 4 * (4 * n_int + sched.step_node.size)
    tips = L * S * Pp * f
    down = (mats + tips + index + n_int * (col + scale),
            n_int * Pp * C * (4 * S * S + S))
    work = {
        # read P, tips, schedule; write every internal row and its scale
        "down_pass": down,
        # ... and the epilogue: read pi, w, log_inv (P_0, tip 0 and the
        # root row are counted above); write lp
        "down_pass_sitelp": (down[0] + (C * S + C) * f + 2 * Pp * f,
                             down[1] + Pp * C * (2 * S * S + 3 * S + 2)),
        # read P, tips, down rows and scales, the root's UP; write E of
        # every child edge and UP of every internal child, with scales
        "up_pass": (mats + tips + index + n_int * (col + scale)
                    + col + scale
                    + (n_edges - 1 + n_int - 1) * (col + scale),
                    Pp * C * ((n_edges - 1) * (2 * S * S + S)
                              + (n_int - 1) * 2 * S * S)),
        # read P, tips, down rows and scales, U, V, pi; write theta of every
        # edge with its scale. E and UP are the sweep's own intermediates,
        # not its result (the kernel keeps E in registers and sends UP
        # through device memory; T8 kept UP in VMEM), so neither counts
        "theta_pass": (mats + tips + index + n_int * (col + scale)
                       + (2 * C * S * S + C * S) * f
                       + n_edges * (col + scale),
                       Pp * C * (2 * S * S
                                 + (n_edges - 1) * (2 * S * S + S)
                                 + (n_int - 1) * 2 * S * S
                                 + n_edges * (4 * S * S + S))),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[eng.dtype] * 1e3
        out[name] = dict(bytes=nbytes, flops=flops,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations")
    return out
