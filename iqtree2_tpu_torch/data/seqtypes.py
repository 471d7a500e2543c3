"""Sequence types and state encodings.

Every sequence type maps characters to small integer *codes*; a code is an
index into a ``tip_table`` of shape ``[num_codes, num_states]`` whose rows are
leaf partial-likelihood indicator vectors (1.0 for each compatible state).
Ambiguity codes are therefore handled uniformly: leaves never store full
partial vectors, only codes, and kernels gather precomputed rows
(design analog of IQ-TREE's ``tip_partial_lh``; see reference
tree/phylotreesse.cpp:243).

Reference character conversions: alignment/alignment.cpp (convertState).

Copied from iqtree2_tpu/data/seqtypes.py, with the user datatypes of --mdef
YAML files looked up in the port's io/yamlmodels.DATATYPES: the port keeps
its own host modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

# Genetic code tables (NCBI transl_table ids -> 64-char AA strings, TTT first,
# index = 16*base1 + 4*base2 + base3 with T=0,C=1,A=2,G=3 ordering used by
# NCBI). Reference: model/modelcodon.cpp genetic code handling.
GENETIC_CODES = {
    1: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    2: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
    3: "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    4: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    5: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
    6: "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    9: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    10: "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    11: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    12: "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    13: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
    14: "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    16: "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    21: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    22: "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    23: "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    24: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG",
    25: "FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
}

AA_CHARS = "ARNDCQEGHILKMFPSTWYV"  # canonical IQ-TREE/PAML amino-acid order

_DNA_BITS = {
    "A": 1, "C": 2, "G": 4, "T": 8, "U": 8,
    "R": 1 | 4, "Y": 2 | 8, "S": 2 | 4, "W": 1 | 8, "K": 4 | 8, "M": 1 | 2,
    "B": 2 | 4 | 8, "D": 1 | 4 | 8, "H": 1 | 2 | 8, "V": 1 | 2 | 4,
    "N": 15, "X": 15, "?": 15, "-": 15, ".": 15, "~": 15, "O": 15, "!": 15,
}


@dataclasses.dataclass(frozen=True)
class SeqType:
    """A sequence type: character <-> code mapping plus the tip table."""

    name: str
    num_states: int
    # code for "completely unknown" (gap); tip row of all ones
    unknown_code: int
    # [num_codes, num_states] float64 indicator rows
    tip_table: np.ndarray
    # 256-entry char (uppercased byte) -> code; -1 = invalid
    char_to_code: np.ndarray
    # representative output char per definite state
    state_chars: str

    @property
    def num_codes(self) -> int:
        return self.tip_table.shape[0]

    def encode(self, seq: str) -> np.ndarray:
        """Encode a sequence string into codes (uint8/int32 array)."""
        b = np.frombuffer(seq.upper().encode("ascii"), dtype=np.uint8)
        codes = self.char_to_code[b]
        if np.any(codes < 0):
            bad = chr(b[np.argmax(codes < 0)])
            raise ValueError(
                f"invalid character {bad!r} for sequence type {self.name}")
        return codes.astype(np.int32)

    def code_to_char(self, code: int) -> str:
        for ch in range(256):
            if self.char_to_code[ch] == code:
                return chr(ch)
        return "?"

    def is_definite(self, codes: np.ndarray) -> np.ndarray:
        """Mask of codes that denote exactly one state."""
        return self.tip_table[codes].sum(axis=-1) == 1.0

    def definite_state(self, codes: np.ndarray) -> np.ndarray:
        """For definite codes, the state index (else argmax, arbitrary)."""
        return self.tip_table[codes].argmax(axis=-1)


def _build(name, num_states, rows, chars_map, unknown_code, state_chars):
    tip = np.asarray(rows, dtype=np.float64)
    c2c = np.full(256, -1, dtype=np.int64)
    for ch, code in chars_map.items():
        c2c[ord(ch)] = code
    return SeqType(name=name, num_states=num_states, unknown_code=unknown_code,
                   tip_table=tip, char_to_code=c2c, state_chars=state_chars)


@lru_cache(maxsize=None)
def dna_type() -> SeqType:
    """DNA: codes are IUPAC bitmasks 1..15 re-indexed 0..14.

    code k (0-based) corresponds to bitmask k+1 over (A,C,G,T).
    Definite states A,C,G,T get codes 0,1,3,7 — tip rows are indicators.
    """
    rows = []
    for mask in range(1, 16):
        rows.append([float((mask >> s) & 1) for s in range(4)])
    chars = {ch: bits - 1 for ch, bits in _DNA_BITS.items()}
    return _build("DNA", 4, rows, chars, unknown_code=14, state_chars="ACGT")


# map from state index (0..3 = A,C,G,T) to DNA code
DNA_STATE_TO_CODE = np.array([0, 1, 3, 7], dtype=np.int32)


@lru_cache(maxsize=None)
def protein_type() -> SeqType:
    """Protein: codes 0..19 definite; 20=B(D/N), 21=Z(Q/E), 22=J(I/L), 23=X."""
    n = 20
    rows = [[1.0 if j == i else 0.0 for j in range(n)] for i in range(n)]
    amb = {"B": ("D", "N"), "Z": ("Q", "E"), "J": ("I", "L")}
    chars = {c: i for i, c in enumerate(AA_CHARS)}
    for k, (ch, states) in enumerate(amb.items()):
        row = [0.0] * n
        for s in states:
            row[AA_CHARS.index(s)] = 1.0
        rows.append(row)
        chars[ch] = n + k
    rows.append([1.0] * n)
    unknown = n + len(amb)
    for ch in "X?-.~*!U O":
        chars[ch] = unknown
    return _build("AA", n, rows, chars, unknown_code=unknown,
                  state_chars=AA_CHARS)


@lru_cache(maxsize=None)
def binary_type() -> SeqType:
    rows = [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]
    chars = {"0": 0, "1": 1}
    for ch in "?-.~X":
        chars[ch] = 2
    return _build("BIN", 2, rows, chars, unknown_code=2, state_chars="01")


@lru_cache(maxsize=None)
def morphology_type(num_states: int = 32) -> SeqType:
    """Morphological characters 0-9 then A-V (IQ-TREE allows up to 32)."""
    syms = "0123456789ABCDEFGHIJKLMNOPQRSTUV"[:num_states]
    rows = [[1.0 if j == i else 0.0 for j in range(num_states)]
            for i in range(num_states)]
    rows.append([1.0] * num_states)
    chars = {c: i for i, c in enumerate(syms)}
    for ch in "?-.~":
        chars[ch] = num_states
    return _build(f"MORPH{num_states}", num_states, rows, chars,
                  unknown_code=num_states, state_chars=syms)


@lru_cache(maxsize=None)
def codon_type(genetic_code_id: int = 1) -> SeqType:
    """Codon type: one code per sense codon (stop codons excluded) + unknown.

    num_states = number of sense codons (61 for the standard code).
    Codons are indexed in T,C,A,G base order like the reference
    (model/modelcodon.cpp). Encoding of triplet strings happens in the
    alignment reader; here codes == states plus an unknown code.
    """
    table = GENETIC_CODES[genetic_code_id]
    sense = [i for i, aa in enumerate(table) if aa != "*"]
    n = len(sense)
    rows = [[1.0 if j == i else 0.0 for j in range(n)] for i in range(n)]
    rows.append([1.0] * n)
    chars: dict[str, int] = {}
    st = SeqType(
        name=f"CODON{genetic_code_id}", num_states=n, unknown_code=n,
        tip_table=np.asarray(rows, dtype=np.float64),
        char_to_code=np.full(256, -1, dtype=np.int64), state_chars="")
    return st


def codon_maps(genetic_code_id: int = 1):
    """Return (codon_index_of_triplet[64] -> sense index or -1, sense list,
    aa per sense codon)."""
    table = GENETIC_CODES[genetic_code_id]
    sense = [i for i, aa in enumerate(table) if aa != "*"]
    idx = np.full(64, -1, dtype=np.int32)
    for k, i in enumerate(sense):
        idx[i] = k
    aas = [table[i] for i in sense]
    return idx, np.asarray(sense, dtype=np.int32), aas


def get_seqtype(name: str, **kw) -> SeqType:
    name = name.upper()
    if name in ("DNA", "NT"):
        return dna_type()
    if name in ("AA", "PROT", "PROTEIN"):
        return protein_type()
    if name in ("BIN", "BINARY"):
        return binary_type()
    if name in ("MORPH", "MULTI"):
        return morphology_type(kw.get("num_states", 32))
    if name.startswith("CODON"):
        gid = int(name[5:]) if len(name) > 5 else kw.get("genetic_code", 1)
        return codon_type(gid)
    # user-defined datatypes registered from --mdef YAML files
    # (reference analog: phylo-yaml/statespace.h)
    from iqtree2_tpu_torch.io.yamlmodels import DATATYPES
    if name in DATATYPES:
        return DATATYPES[name]
    raise ValueError(f"unknown sequence type {name}")


def detect_seqtype(seqs: list[str]) -> str:
    """Guess the sequence type from character content (reference analog:
    alignment/alignment.cpp detectSequenceType)."""
    counts = {"dna": 0, "aa": 0, "bin": 0, "digit": 0, "total": 0}
    dna_set = set("ACGTU")
    aa_set = set(AA_CHARS)
    for s in seqs[: min(len(seqs), 100)]:
        for ch in s.upper():
            if ch in "-?.~NX*!":
                continue
            counts["total"] += 1
            if ch in dna_set:
                counts["dna"] += 1
            if ch in aa_set:
                counts["aa"] += 1
            if ch in "01":
                counts["bin"] += 1
            if ch.isdigit():
                counts["digit"] += 1
    if counts["total"] == 0:
        return "DNA"
    if counts["bin"] == counts["total"]:
        return "BIN"
    if counts["dna"] / counts["total"] > 0.85:
        return "DNA"
    if counts["aa"] / counts["total"] > 0.5:
        return "AA"
    if counts["digit"] / counts["total"] > 0.9:
        return "MORPH"
    return "AA"
