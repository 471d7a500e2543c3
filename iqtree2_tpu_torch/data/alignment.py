"""Alignment with site-pattern compression.

The core data structure of the whole framework (reference analog:
alignment/alignment.cpp buildPattern :1725): each unique alignment column is
stored once together with its frequency (number of sites showing it). All
downstream likelihood math is per *pattern*, weighted by frequency — this is
also the TPU data-parallel axis.

Copied from iqtree2_tpu/data/alignment.py, with bootstrap_alignment's
site-to-pattern map repaired and const_state_mask computed once: the port
keeps its own host modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from iqtree2_tpu_torch.data import seqtypes
from iqtree2_tpu_torch.data.seqtypes import SeqType


@dataclasses.dataclass
class Alignment:
    """A multiple sequence alignment in pattern-compressed form.

    Attributes:
      names: taxon names, length ntaxa.
      seqtype: the SeqType (states, ambiguity codes, tip table).
      patterns: int32 [num_patterns, ntaxa] codes per unique column.
      pattern_weights: float64 [num_patterns] frequency of each pattern
        (float so bootstrap-resampled alignments reuse the same structure).
      site_to_pattern: int32 [nsites] map from original site to pattern id.
      name: optional label (partition name).
    """

    names: list[str]
    seqtype: SeqType
    patterns: np.ndarray
    pattern_weights: np.ndarray
    site_to_pattern: np.ndarray
    name: str = ""

    # ---------------------------------------------------------------- basic
    @property
    def ntaxa(self) -> int:
        return len(self.names)

    @property
    def nsites(self) -> int:
        return int(self.site_to_pattern.shape[0])

    @property
    def num_patterns(self) -> int:
        return int(self.patterns.shape[0])

    @property
    def num_states(self) -> int:
        return self.seqtype.num_states

    # ------------------------------------------------------------ factories
    @classmethod
    def from_sequences(cls, names: list[str], seqs: list[str],
                       seqtype: str | SeqType | None = None,
                       name: str = "") -> "Alignment":
        if len(names) != len(seqs):
            raise ValueError("names/seqs length mismatch")
        if len(set(len(s) for s in seqs)) != 1:
            lens = {n: len(s) for n, s in zip(names, seqs)}
            raise ValueError(f"sequences have unequal lengths: {lens}")
        if seqtype is None:
            seqtype = seqtypes.detect_seqtype(seqs)
        if isinstance(seqtype, str):
            st = seqtypes.get_seqtype(seqtype)
        else:
            st = seqtype
        if st.name.startswith("CODON"):
            return cls._from_codon_sequences(names, seqs, st, name)
        mat = np.stack([st.encode(s) for s in seqs], axis=1)  # [sites, taxa]
        return cls.from_site_matrix(names, mat, st, name)

    @classmethod
    def _from_codon_sequences(cls, names, seqs, st: SeqType, name):
        gid = int(st.name[5:])
        tri_idx, _, _ = seqtypes.codon_maps(gid)
        dna = seqtypes.dna_type()
        ncol = len(seqs[0])
        if ncol % 3 != 0:
            raise ValueError("codon alignment length not divisible by 3")
        ncodons = ncol // 3
        mat = np.zeros((ncodons, len(seqs)), dtype=np.int32)
        for j, s in enumerate(seqs):
            codes = dna.encode(s)  # bitmask-1 codes
            for i in range(ncodons):
                c0, c1, c2 = codes[3 * i: 3 * i + 3] + 1  # bitmasks
                if (c0 & (c0 - 1)) or (c1 & (c1 - 1)) or (c2 & (c2 - 1)):
                    mat[i, j] = st.unknown_code  # any ambiguity -> unknown
                else:
                    # bit position -> base index in A,C,G,T order; reference
                    # codon indexing is T,C,A,G per NCBI order
                    acgt = [int(np.log2(c)) for c in (c0, c1, c2)]
                    tcag = [{0: 2, 1: 1, 2: 3, 3: 0}[b] for b in acgt]
                    tri = 16 * tcag[0] + 4 * tcag[1] + tcag[2]
                    k = tri_idx[tri]
                    mat[i, j] = st.unknown_code if k < 0 else k
        return cls.from_site_matrix(names, mat, st, name)

    @classmethod
    def from_site_matrix(cls, names: list[str], site_matrix: np.ndarray,
                         st: SeqType, name: str = "") -> "Alignment":
        """Build from an int [sites, taxa] code matrix via pattern hashing.

        Uses the native C++ compressor (native/iqtree2_native.cpp
        it2_compress_patterns, the buildPattern analog) when available —
        ~5x faster than np.unique on large supermatrices — with np.unique
        as the pure-Python fallback. Note the two orders differ (native =
        first-appearance, numpy = lexicographic); both are valid pattern
        compressions."""
        from iqtree2_tpu_torch import native
        res = native.compress_patterns(
            np.ascontiguousarray(site_matrix.T, dtype=np.int32))
        if res is not None:
            patterns, counts, site_to_pattern = res
            return cls(names=list(names), seqtype=st,
                       patterns=patterns.astype(np.int32),
                       pattern_weights=counts.astype(np.float64),
                       site_to_pattern=site_to_pattern.astype(np.int32),
                       name=name)
        patterns, site_to_pattern, counts = np.unique(
            site_matrix, axis=0, return_inverse=True, return_counts=True)
        return cls(names=list(names), seqtype=st,
                   patterns=patterns.astype(np.int32),
                   pattern_weights=counts.astype(np.float64),
                   site_to_pattern=site_to_pattern.astype(np.int32),
                   name=name)

    # ------------------------------------------------------------- queries
    def expand_to_sites(self) -> np.ndarray:
        """[sites, taxa] code matrix (decompressed)."""
        return self.patterns[self.site_to_pattern]

    def tip_codes(self) -> np.ndarray:
        """int32 [ntaxa, num_patterns] (taxon-major for kernel gathers)."""
        return np.ascontiguousarray(self.patterns.T)

    def state_frequencies(self, method: str = "empirical") -> np.ndarray:
        """Empirical state frequencies (+F counts), ambiguity split equally.

        Reference analog: alignment/alignment.cpp computeStateFreq.
        """
        tbl = self.seqtype.tip_table  # [codes, states]
        rows = tbl[self.patterns]  # [patterns, taxa, states]
        # distribute ambiguous observations equally among compatible states;
        # fully-unknown characters carry no information -> excluded
        ns = rows.sum(axis=-1, keepdims=True)
        informative = ns[..., 0] < self.num_states
        w = np.where(informative, 1.0 / ns[..., 0], 0.0)
        contrib = rows * w[..., None] * self.pattern_weights[:, None, None]
        freq = contrib.sum(axis=(0, 1))
        total = freq.sum()
        if total == 0:
            return np.full(self.num_states, 1.0 / self.num_states)
        freq = freq / total
        # avoid exact zeros (reference keeps freqs strictly positive)
        freq = np.maximum(freq, 1e-10)
        return freq / freq.sum()

    def empirical_counts(self) -> np.ndarray:
        """Unnormalized state counts (same distribution rule as above)."""
        tbl = self.seqtype.tip_table
        rows = tbl[self.patterns]
        ns = rows.sum(axis=-1, keepdims=True)
        informative = ns[..., 0] < self.num_states
        w = np.where(informative, 1.0 / ns[..., 0], 0.0)
        contrib = rows * w[..., None] * self.pattern_weights[:, None, None]
        return contrib.sum(axis=(0, 1))

    def is_constant_pattern(self) -> np.ndarray:
        """bool [num_patterns]: pattern compatible with a single-state column.

        A pattern is 'constant' if at least one state is compatible with every
        taxon's observation (reference: Pattern::computeConst,
        alignment/pattern.cpp).
        """
        tbl = self.seqtype.tip_table
        rows = tbl[self.patterns]  # [patterns, taxa, states]
        return (rows.min(axis=1) > 0).any(axis=-1)

    def const_state_mask(self) -> np.ndarray:
        """float [num_patterns, states]: 1 where the pattern is compatible
        with all taxa being in that state (for +I invariant-site likelihood
        and ascertainment-bias corrections). Computed once per alignment
        (every +I model refresh asks for it) and shared read-only."""
        mask = self.__dict__.get("_const_state_mask")
        if mask is None:
            tbl = self.seqtype.tip_table
            mask = (tbl[self.patterns].min(axis=1) > 0).astype(np.float64)
            mask.flags.writeable = False
            self.__dict__["_const_state_mask"] = mask
        return mask

    def proportion_invariant_upper(self) -> float:
        w = self.pattern_weights
        return float((w * self.is_constant_pattern()).sum() / w.sum())

    # ------------------------------------------------------------ bootstrap
    def bootstrap_pattern_weights(self, rng: np.random.Generator,
                                  nrep: int = 1,
                                  scale: float = 1.0) -> np.ndarray:
        """Resample pattern frequencies: multinomial over sites.

        Returns float [nrep, num_patterns] resampled weights (reference:
        alignment/alignment.cpp createBootstrapAlignment :3639 — resamples
        pattern frequencies rather than sites).
        """
        nsites = int(round(self.nsites * scale))
        p = self.pattern_weights / self.pattern_weights.sum()
        return rng.multinomial(nsites, p, size=nrep).astype(np.float64)

    def bootstrap_alignment(self, rng: np.random.Generator) -> "Alignment":
        w = self.bootstrap_pattern_weights(rng)[0]
        keep = w > 0
        # rebuild site_to_pattern (site order is irrelevant) over the kept
        # patterns' new indices: the JAX copy repeats their old indices,
        # which run past the kept rows, so its -b fails on expanding them
        s2p = np.repeat(np.arange(int(keep.sum())),
                        w[keep].astype(np.int64))
        return Alignment(names=self.names, seqtype=self.seqtype,
                         patterns=self.patterns[keep],
                         pattern_weights=w[keep],
                         site_to_pattern=s2p.astype(np.int32),
                         name=self.name)

    # -------------------------------------------------------------- editing
    def subset_taxa(self, idx: list[int]) -> "Alignment":
        mat = self.expand_to_sites()[:, idx]
        return Alignment.from_site_matrix(
            [self.names[i] for i in idx], mat, self.seqtype, self.name)

    def subset_sites(self, sites: np.ndarray) -> "Alignment":
        mat = self.expand_to_sites()[sites]
        return Alignment.from_site_matrix(self.names, mat, self.seqtype,
                                          self.name)

    def identical_seq_groups(self) -> list[list[int]]:
        """Groups of taxa with identical sequences (reference analog:
        removeIdenticalSeqs, main/phyloanalysis.cpp:4264)."""
        cols = self.patterns.T  # [taxa, patterns]
        seen: dict[bytes, int] = {}
        groups: list[list[int]] = []
        for i in range(self.ntaxa):
            key = cols[i].tobytes()
            if key in seen:
                groups[seen[key]].append(i)
            else:
                seen[key] = len(groups)
                groups.append([i])
        return groups

    def uninformative_site_count(self) -> tuple[int, int]:
        """(n_constant_sites, n_parsimony_informative_sites)."""
        w = self.pattern_weights
        const = int((w * self.is_constant_pattern()).sum())
        tbl = self.seqtype.tip_table
        informative = 0
        for pi in range(self.num_patterns):
            codes = self.patterns[pi]
            rows = tbl[codes]
            definite = rows.sum(-1) == 1
            states = rows[definite].argmax(-1)
            vals, counts = np.unique(states, return_counts=True)
            if (counts >= 2).sum() >= 2:
                informative += int(w[pi])
        return const, informative
