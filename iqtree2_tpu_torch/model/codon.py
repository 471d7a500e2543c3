"""Codon substitution models (GY94 / MG94 families).

Reference analog: ModelCodon (model/modelcodon.cpp): Q over the 61 sense
codons (standard code); substitutions only between codons differing at one
position; rate = kappa^(is transition) * omega^(is nonsynonymous) * target
factor (GY: codon frequency pi_j; MG: target-nucleotide frequency). Both are
time-reversible, so the engine's symmetrized eigendecomposition applies; the
61 states run in the kernels' widest register-column instance (S <= 64;
csrc/pruning.cu).

Codon frequency options: F (F61, counted codon frequencies), F1X4, F3X4
(products of positional nucleotide frequencies), FQ (equal).

Copied from iqtree2_tpu/model/codon.py with its data file
(model/data/codon_ecm.npz, byte for byte): the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.data import seqtypes
from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.model.subst import (Eigensystem, SubstModel,
                                           build_gtr_rate_matrix,
                                           eigen_reversible)

# triplet index is 16*b0 + 4*b1 + b2 with bases in T,C,A,G order (NCBI)
_TCAG = "TCAG"
_PURINES = {2, 3}   # A, G in TCAG order
_PYRIMID = {0, 1}   # T, C


def _triplet_bases(tri: int) -> tuple[int, int, int]:
    return tri // 16, (tri // 4) % 4, tri % 4


def sense_codons(gid: int = 1) -> list[str]:
    """The sense codons of genetic code ``gid`` as triplets, in state
    order (the port's: the simulator and the alignment writers spell
    codon states with them)."""
    _, sense, _ = seqtypes.codon_maps(gid)
    return ["".join(_TCAG[b] for b in _triplet_bases(int(t))) for t in sense]


def codon_pair_info(gid: int = 1):
    """For every sense-codon pair (i<j) differing at exactly one position:
    (pair index arrays, is_transition, is_synonymous, changed position,
    target base of j, target base of i)."""
    idx, sense, aas = seqtypes.codon_maps(gid)
    S = len(sense)
    pairs = []
    for a in range(S):
        for b in range(a + 1, S):
            ta = _triplet_bases(int(sense[a]))
            tb = _triplet_bases(int(sense[b]))
            diff = [k for k in range(3) if ta[k] != tb[k]]
            if len(diff) != 1:
                continue
            k = diff[0]
            ts = (ta[k] in _PURINES) == (tb[k] in _PURINES)
            syn = aas[a] == aas[b]
            pairs.append((a, b, ts, syn, k, tb[k], ta[k]))
    return np.asarray(pairs, dtype=np.int64)


def count_codon_freqs(aln: Alignment, mode: str) -> np.ndarray:
    """Codon equilibrium frequencies: F (counted), F1X4, F3X4, FQ."""
    S = aln.num_states
    gid = int(aln.seqtype.name[5:]) if aln.seqtype.name.startswith("CODON") \
        else 1
    idx, sense, _ = seqtypes.codon_maps(gid)
    if mode in ("equal", "FQ"):
        return np.full(S, 1.0 / S)
    counts = aln.empirical_counts()
    if mode in ("F", "empirical", "F61", "estimate"):
        f = counts + 0.1 / S
        return f / f.sum()
    # positional nucleotide frequencies from the counted codons
    pos_freq = np.zeros((3, 4))
    for k, tri in enumerate(sense):
        b = _triplet_bases(int(tri))
        for p in range(3):
            pos_freq[p, b[p]] += counts[k]
    pos_freq = (pos_freq + 0.1) / (pos_freq + 0.1).sum(axis=1,
                                                       keepdims=True)
    if mode == "F1X4":
        nt = pos_freq.mean(axis=0)
        pos_freq = np.stack([nt, nt, nt])
    f = np.ones(S)
    for k, tri in enumerate(sense):
        b = _triplet_bases(int(tri))
        f[k] = pos_freq[0, b[0]] * pos_freq[1, b[1]] * pos_freq[2, b[2]]
    return f / f.sum()


class CodonModel(SubstModel):
    """GY-style reversible codon model with (kappa, omega) parameters.

    exchangeability r_ij = kappa^ts(ij) * omega^nonsyn(ij) for single-step
    pairs (0 otherwise); Q_ij = r_ij * pi_j (GY94). MG variant divides by
    the codon frequency and multiplies the target-nucleotide frequency.
    """

    def __init__(self, aln: Alignment, name: str = "GY",
                 kappa: float = 4.0, omega: float = 1.0,
                 freq_mode: str = "F3X4",
                 fix_kappa: bool = False, fix_omega: bool = False):
        st = aln.seqtype
        assert st.name.startswith("CODON"), "codon model needs CODON data"
        self.gid = int(st.name[5:])
        self.num_states = aln.num_states
        self.name = name.upper()
        self.kappa = kappa
        self.omega = omega
        self.fix_kappa = fix_kappa
        self.fix_omega = fix_omega
        self.freq_mode = freq_mode
        self.freq_type = "empirical" if freq_mode != "FQ" else "equal"
        self.freqs = count_codon_freqs(aln, freq_mode)
        self._pairs = codon_pair_info(self.gid)
        self._mg = self.name.startswith("MG")
        if self._mg:
            # MG target factor: positional nucleotide frequency of the
            # target base / codon frequency (folded into exchangeabilities)
            counts = aln.empirical_counts()
            idx, sense, _ = seqtypes.codon_maps(self.gid)
            pos_freq = np.zeros((3, 4))
            for k, tri in enumerate(sense):
                b = _triplet_bases(int(tri))
                for p in range(3):
                    pos_freq[p, b[p]] += counts[k]
            self._pos_freq = (pos_freq + 0.1) / (pos_freq + 0.1).sum(
                axis=1, keepdims=True)

    # ---------------------------------------------------------- eigensystem
    def _exch(self) -> np.ndarray:
        S = self.num_states
        nr = S * (S - 1) // 2
        iu = np.triu_indices(S, 1)
        flat_pos = {(i, j): k for k, (i, j) in enumerate(zip(*iu))}
        r = np.zeros(nr)
        for (a, b, ts, syn, k, tb, ta) in self._pairs:
            v = (self.kappa if ts else 1.0) * \
                (1.0 if syn else self.omega)
            if self._mg:
                # MG94: q_ij = v * ntfreq(target); as a GTR exchangeability
                # r_ij = v * ntfreq(tb)/pi_j — symmetric when pi is a
                # positional product (F1X4/F3X4), i.e. it equals
                # v / (freqs of the two shared positions).
                v = v * self._pos_freq[k, tb] / max(self.freqs[b], 1e-12)
            r[flat_pos[(a, b)]] = v
        return r

    def get_eigensystem(self) -> Eigensystem:
        Q = build_gtr_rate_matrix(self._exch(), self.freqs)
        w, U, V, W = eigen_reversible(Q, self.freqs)
        return Eigensystem(eigvals=w[None], U=U[None], V=V[None],
                           freqs=self.freqs[None], mix_weights=np.ones(1),
                           W=W[None])

    # ------------------------------------------------------------ params
    def get_params(self) -> np.ndarray:
        out = []
        if not self.fix_kappa:
            out.append(self.kappa)
        if not self.fix_omega:
            out.append(self.omega)
        return np.asarray(out)

    def set_params(self, x: np.ndarray) -> None:
        i = 0
        if not self.fix_kappa:
            self.kappa = float(x[i])
            i += 1
        if not self.fix_omega:
            self.omega = float(x[i])

    def param_bounds(self):
        n = len(self.get_params())
        return np.full(n, 1e-3), np.full(n, 100.0)

    def num_free_params(self) -> int:
        return len(self.get_params())


class EmpiricalCodonModel(SubstModel):
    """Empirical codon exchangeability models: KOSI07 (ECM unrestricted,
    Kosiol et al. 2007), ECMREST (single-step restricted) and SCHN05
    (Schneider et al. 2005). Matrices extracted from the reference's
    embedded constants (model/modelcodon.cpp:16-160, readCodonModel :699)
    by tools/extract_codon_ecm.py — published scientific data.

    Q_ij = s_ij * pi_j; pi defaults to the published model frequencies
    (the reference's FREQ_USER_DEFINED) or counted codon frequencies
    with +F."""

    _DATA = None

    def __init__(self, aln: Alignment, name: str, freq_mode: str | None):
        from pathlib import Path
        st = aln.seqtype
        self.gid = int(st.name[5:])
        if self.gid != 1:
            raise ValueError(f"{name} requires the standard genetic code "
                             "(reference: modelcodon.cpp:344)")
        if EmpiricalCodonModel._DATA is None:
            EmpiricalCodonModel._DATA = np.load(
                Path(__file__).parent / "data" / "codon_ecm.npz")
        d = EmpiricalCodonModel._DATA
        key = {"ECM": "KOSI07", "ECMK07": "KOSI07", "KOSI07": "KOSI07",
               "ECMREST": "ECMREST",
               "SCHN05": "SCHN05", "ECMS05": "SCHN05"}[name.upper()]
        self.name = key
        self.num_states = aln.num_states
        # map the published codon order onto our sense-codon order
        idx, sense, _ = seqtypes.codon_maps(self.gid)
        tri_to_ours = {int(t): k for k, t in enumerate(sense)}
        perm = np.zeros(len(sense), dtype=np.int64)
        for row, cod in enumerate(d[f"{key}_codons"]):
            tri = (_TCAG.index(cod[0]) * 16 + _TCAG.index(cod[1]) * 4
                   + _TCAG.index(cod[2]))
            perm[tri_to_ours[tri]] = row
        M = np.asarray(d[f"{key}_exch"])[np.ix_(perm, perm)]
        pub_f = np.asarray(d[f"{key}_freqs"])[perm]
        self._exch_full = M
        if freq_mode in (None, "user"):
            self.freqs = pub_f / pub_f.sum()
            self.freq_type = "user"
        else:
            self.freqs = count_codon_freqs(aln, freq_mode)
            self.freq_type = "empirical"

    def get_eigensystem(self) -> Eigensystem:
        iu = np.triu_indices(self.num_states, 1)
        Q = build_gtr_rate_matrix(self._exch_full[iu], self.freqs)
        w, U, V, W = eigen_reversible(Q, self.freqs)
        return Eigensystem(eigvals=w[None], U=U[None], V=V[None],
                           freqs=self.freqs[None], mix_weights=np.ones(1),
                           W=W[None])

    def get_params(self) -> np.ndarray:
        return np.zeros(0)

    def set_params(self, x) -> None:
        pass

    def param_bounds(self):
        return np.zeros(0), np.zeros(0)

    def num_free_params(self) -> int:
        return 0


EMPIRICAL_CODON_NAMES = {"ECM", "ECMK07", "KOSI07", "ECMREST", "SCHN05",
                         "ECMS05"}


def make_codon_model(spec, aln: Alignment) -> CodonModel:
    """Factory entry: spec.base in {GY, MG, GY2K,...}; params {kappa,omega};
    frequency term +F/+F1X4/+F3X4/+FQ; empirical KOSI07/SCHN05/ECMREST."""
    base = spec.base.upper()
    if base in EMPIRICAL_CODON_NAMES:
        fmode = None if spec.freq_type in (None, "user") else \
            {"empirical": "F", "equal": "FQ"}.get(spec.freq_type,
                                                  spec.freq_type)
        return EmpiricalCodonModel(aln, base, fmode)
    if base in ("CODON", "GTR"):  # default for codon data
        base = "GY"
    kappa, omega = 4.0, 1.0
    fix_k = fix_o = False
    if spec.base_params:
        if len(spec.base_params) >= 1:
            kappa = spec.base_params[0]
            fix_k = True
        if len(spec.base_params) >= 2:
            omega = spec.base_params[1]
            fix_o = True
    fmode = {"empirical": "F", "equal": "FQ", None: "F3X4",
             "estimate": "F3X4", "user": "F", "F1X4": "F1X4",
             "F3X4": "F3X4"}.get(spec.freq_type, "F3X4")
    return CodonModel(aln, name=base, kappa=kappa, omega=omega,
                      freq_mode=fmode, fix_kappa=fix_k, fix_omega=fix_o)
