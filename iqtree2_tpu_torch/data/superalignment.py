"""Partitioned supermatrix: SuperAlignment + partition-spec readers.

Reference analogs: SuperAlignment (alignment/superalignment.h:41) holding
`vector<Alignment*> partitions` with per-partition taxa maps
(linkSubAlignment, alignment/superalignment.cpp:884) and partition-aware
bootstrap (:1294); partition files parsed from NEXUS sets blocks or
RAxML-style lists (readPartition / readPartitionRaxml).

Every partition's alignment is expanded to the *union* taxon set, with
absent taxa encoded as fully-unknown sequences. An all-unknown tip
contributes a vector of ones to the pruning recursion (row-stochastic P
maps 1 -> 1), so this is mathematically identical to pruning the missing
taxa, and every partition shares one tree schedule.

Copied from iqtree2_tpu/data/superalignment.py (without its unused
seqtypes import): the port keeps its own host modules and imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np

from iqtree2_tpu_torch.data.alignment import Alignment


@dataclasses.dataclass
class SuperAlignment:
    """Partitions over a union taxon set (each partition an Alignment whose
    taxon list equals ``names``; missing taxa hold all-unknown sequences)."""

    names: list[str]
    partitions: list[Alignment]
    part_names: list[str]
    # model string per partition ('' = unset, use global -m)
    part_models: list[str]
    # which taxa are actually present per partition (bool [K][ntaxa])
    part_presence: list[np.ndarray]

    # ---------------------------------------------------- Alignment-like API
    @property
    def ntaxa(self) -> int:
        return len(self.names)

    @property
    def nsites(self) -> int:
        return sum(p.nsites for p in self.partitions)

    @property
    def num_patterns(self) -> int:
        return sum(p.num_patterns for p in self.partitions)

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    @property
    def pattern_weights(self) -> np.ndarray:
        return np.concatenate([p.pattern_weights for p in self.partitions])

    @property
    def site_to_pattern(self) -> np.ndarray:
        """Site -> concatenated-pattern index (sites in partition order)."""
        out = []
        off = 0
        for p in self.partitions:
            out.append(p.site_to_pattern + off)
            off += p.num_patterns
        return np.concatenate(out)

    def pattern_offsets(self) -> np.ndarray:
        """[K+1] offsets of each partition in the concatenated pattern axis."""
        return np.cumsum([0] + [p.num_patterns for p in self.partitions])

    def bootstrap_pattern_weights(self, rng: np.random.Generator,
                                  nrep: int = 1,
                                  scale: float = 1.0,
                                  spec: str = "") -> np.ndarray:
        """Partition-aware resampling, concatenated over the shared
        pattern axis. Returns [nrep, sum(num_patterns)].

        spec (reference: createBootstrapAlignment spec strings,
        alignment/alignment.cpp:3709-3732; CLI -bsam):
          ""/"SITE":  sites resampled within each partition
                      (SuperAlignment::createBootstrapAlignment,
                      alignment/superalignment.cpp:1294)
          "GENE":     whole partitions resampled with replacement; a gene
                      drawn m times contributes m x its original weights
          "GENESITE": partitions resampled, then sites resampled within
                      every drawn copy
        """
        spec = (spec or "").upper().rstrip(",")
        if spec in ("", "SITE"):
            cols = [p.bootstrap_pattern_weights(rng, nrep=nrep, scale=scale)
                    for p in self.partitions]
            return np.concatenate(cols, axis=1)
        if spec not in ("GENE", "GENESITE"):
            raise ValueError(f"unknown bootstrap spec {spec!r}")
        K = self.n_partitions
        offs = self.pattern_offsets()
        out = np.zeros((nrep, int(offs[-1])), dtype=np.float64)
        for r in range(nrep):
            counts = np.bincount(rng.integers(0, K, size=K), minlength=K)
            for k, m in enumerate(counts):
                if m == 0:
                    continue
                sl = slice(int(offs[k]), int(offs[k + 1]))
                if spec == "GENE":
                    out[r, sl] = m * self.partitions[k].pattern_weights
                else:
                    for _ in range(int(m)):
                        out[r, sl] += self.partitions[
                            k].bootstrap_pattern_weights(rng,
                                                         scale=scale)[0]
        return out

    def identical_seq_groups(self) -> list[list[int]]:
        keys = []
        for i in range(self.ntaxa):
            keys.append(b"".join(p.patterns.T[i].tobytes()
                                 for p in self.partitions))
        seen: dict[bytes, int] = {}
        groups: list[list[int]] = []
        for i, k in enumerate(keys):
            if k in seen:
                groups[seen[k]].append(i)
            else:
                seen[k] = len(groups)
                groups.append([i])
        return groups

    # ------------------------------------------------------------- editing
    def bootstrap(self, rng: np.random.Generator) -> "SuperAlignment":
        parts = [p.bootstrap_alignment(rng) for p in self.partitions]
        return SuperAlignment(self.names, parts, list(self.part_names),
                              list(self.part_models),
                              [m.copy() for m in self.part_presence])

    def subset_partitions(self, idx: list[int],
                          merged_name: str | None = None) -> "SuperAlignment":
        return SuperAlignment(
            self.names,
            [self.partitions[i] for i in idx],
            [self.part_names[i] for i in idx] if merged_name is None
            else [merged_name],
            [self.part_models[i] for i in idx],
            [self.part_presence[i] for i in idx])

    def merged_partition(self, idx: list[int], name: str) -> Alignment:
        """Concatenate partitions idx (same seqtype) into one Alignment."""
        sts = {self.partitions[i].seqtype.name for i in idx}
        if len(sts) != 1:
            raise ValueError(f"cannot merge partitions of mixed types {sts}")
        mats = [self.partitions[i].expand_to_sites() for i in idx]
        mat = np.concatenate(mats, axis=0)
        return Alignment.from_site_matrix(self.names, mat,
                                          self.partitions[idx[0]].seqtype,
                                          name)


def expand_to_taxa(aln: Alignment, names: list[str]) -> tuple[Alignment,
                                                              np.ndarray]:
    """Re-index an alignment onto a (super)set taxon list; missing taxa get
    all-unknown rows. Returns (expanded alignment, presence mask)."""
    pos = {n: i for i, n in enumerate(aln.names)}
    unk = aln.seqtype.unknown_code
    P = aln.num_patterns
    pat = np.full((P, len(names)), unk, dtype=np.int32)
    present = np.zeros(len(names), dtype=bool)
    for j, n in enumerate(names):
        if n in pos:
            pat[:, j] = aln.patterns[:, pos[n]]
            present[j] = True
    out = Alignment(names=list(names), seqtype=aln.seqtype, patterns=pat,
                    pattern_weights=aln.pattern_weights.copy(),
                    site_to_pattern=aln.site_to_pattern.copy(),
                    name=aln.name)
    return out, present


def build_superalignment(parts: list[Alignment],
                         part_models: list[str] | None = None
                         ) -> SuperAlignment:
    """Union the taxon sets and expand each partition onto it."""
    names: list[str] = []
    seen = set()
    for p in parts:
        for n in p.names:
            if n not in seen:
                seen.add(n)
                names.append(n)
    expanded, presence = [], []
    for p in parts:
        e, m = expand_to_taxa(p, names)
        # re-compress: expansion cannot split patterns, so reuse directly
        expanded.append(e)
        presence.append(m)
    return SuperAlignment(names=names, partitions=expanded,
                          part_names=[p.name or f"part{i+1}"
                                      for i, p in enumerate(parts)],
                          part_models=list(part_models or
                                           [""] * len(parts)),
                          part_presence=presence)


# --------------------------------------------------------------- file input
_RAXML_LINE = re.compile(
    r"^\s*([A-Za-z0-9+*{}.,_\-]+)\s*,\s*([^=]+?)\s*=\s*(.+)$")


def read_partition_spec(partition_file: str, aln_file: str = "",
                        seqtype: str | None = None) -> SuperAlignment:
    """Read a partition definition (NEXUS sets block or RAxML-style) plus the
    alignment(s) it refers to.

    Reference analogs: readPartitionNexus / readPartitionRaxml
    (alignment/superalignment.cpp).
    """
    from iqtree2_tpu_torch.io.alignment_io import read_alignment

    text = Path(partition_file).read_text()
    base_dir = Path(partition_file).parent
    parts: list[Alignment] = []
    models: list[str] = []

    def load_sites(aln: Alignment, sites: list[int], name: str) -> Alignment:
        sub = aln.subset_sites(np.asarray(sites, dtype=np.int64))
        sub.name = name
        return sub

    if re.search(r"#NEXUS", text, re.IGNORECASE) or \
            re.search(r"begin\s+(sets|data)", text, re.IGNORECASE):
        from iqtree2_tpu_torch.io.nexus import parse_nexus
        nx = parse_nexus(text)
        main_aln = None
        if aln_file:
            main_aln = read_alignment(aln_file, seqtype=seqtype)
        elif nx.data_matrix:
            names = list(nx.data_matrix)
            main_aln = Alignment.from_sequences(
                names, [nx.data_matrix[n] for n in names], seqtype=seqtype)
        for cs in nx.charsets:
            name = cs.name
            mstr = nx.models.get(name, "")
            if cs.aln_file:
                sub = read_alignment(str(base_dir / cs.aln_file),
                                     seqtype=cs.seqtype or seqtype)
                if cs.ranges:
                    sub = load_sites(sub, cs.site_indices(sub.nsites), name)
                else:
                    sub.name = name
            else:
                if main_aln is None:
                    raise ValueError(
                        f"charset {name} needs -s ALIGNMENT (no file ref)")
                st = cs.seqtype or ""
                src = main_aln
                if st and st.upper() not in ("", src.seqtype.name):
                    # per-charset datatype override: re-read raw columns
                    src = read_alignment(aln_file, seqtype=st)
                sub = load_sites(src, cs.site_indices(src.nsites), name)
            parts.append(sub)
            models.append(mstr)
        if not parts:
            raise ValueError(f"no charsets found in {partition_file}")
    else:
        # RAxML style: "DNA, gene1 = 1-100\nGTR+G, gene2 = 101-200\3"
        main_aln = read_alignment(aln_file, seqtype=seqtype)
        from iqtree2_tpu_torch.io.nexus import parse_charset_ranges
        for ln in text.splitlines():
            ln = ln.split("#")[0].strip()
            if not ln:
                continue
            m = _RAXML_LINE.match(ln)
            if not m:
                continue
            mstr, name, spec = m.group(1), m.group(2).strip(), m.group(3)
            ranges = parse_charset_ranges(spec.replace(",", " "))
            sites: list[int] = []
            for (a, b, c) in ranges:
                end = b if b > 0 else main_aln.nsites
                sites.extend(range(a - 1, end, c))
            src = main_aln
            up = mstr.upper()
            if up in ("DNA", "AA", "BIN", "MORPH", "PROT", "PROTEIN") or \
                    up.startswith("CODON"):
                st = {"PROT": "AA", "PROTEIN": "AA"}.get(up, up)
                if st != main_aln.seqtype.name:
                    src = read_alignment(aln_file, seqtype=st)
                mstr = ""
            parts.append(load_sites(src, sites, name))
            models.append("" if mstr.upper() in
                          ("DNA", "AA", "BIN", "MORPH") else mstr)
        if not parts:
            raise ValueError(f"no partitions parsed from {partition_file}")
    return build_superalignment(parts, models)
