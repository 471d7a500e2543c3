"""Alignment file readers/writers: PHYLIP, FASTA, NEXUS, CLUSTAL, MSF.

Reference format support: alignment/alignment.h:200-294 (readPhylip,
readFasta, readNexus, readClustal, readMSF). The readers here are fresh
host-side Python; they only need to produce (names, sequences).

Copied from iqtree2_tpu/io/alignment_io.py, with codon alignments written
as triplets (_code_chars): the port keeps its own host modules and imports
nothing of the JAX package.
"""

from __future__ import annotations

import gzip
import io as _io
import re
from pathlib import Path

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.io.nexus import parse_nexus


def _open_text(path) -> str:
    data = Path(path).read_bytes()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return data.decode("utf-8", errors="replace")


def detect_format(text: str) -> str:
    head = text.lstrip()[:400]
    up = head.upper()
    if up.startswith("#NEXUS"):
        return "nexus"
    if head.startswith(">"):
        return "fasta"
    if up.startswith("CLUSTAL"):
        return "clustal"
    if "!!AA_MULTIPLE_ALIGNMENT" in up or "!!NA_MULTIPLE_ALIGNMENT" in up \
            or re.search(r"MSF:.*Check:.*\.\.", head):
        return "msf"
    first = head.splitlines()[0].split()
    if len(first) >= 2 and all(tok.lstrip("-").isdigit() for tok in first[:2]):
        return "phylip"
    return "fasta"


def read_alignment(path, seqtype=None, fmt=None, name="") -> Alignment:
    text = _open_text(path)
    if fmt is None:
        fmt = detect_format(text)
    fmt = fmt.lower()
    if fmt == "phylip":
        names, seqs = parse_phylip(text)
    elif fmt == "fasta":
        names, seqs = parse_fasta(text)
    elif fmt == "nexus":
        return read_nexus_alignment(text, seqtype=seqtype, name=name)
    elif fmt == "clustal":
        names, seqs = parse_clustal(text)
    elif fmt == "msf":
        names, seqs = parse_msf(text)
    else:
        raise ValueError(f"unknown alignment format {fmt}")
    return Alignment.from_sequences(names, seqs, seqtype=seqtype, name=name)


# ------------------------------------------------------------------ PHYLIP
def parse_phylip(text: str) -> tuple[list[str], list[str]]:
    """Sequential or interleaved relaxed PHYLIP."""
    lines = [ln.rstrip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln.strip()]
    header = lines[0].split()
    ntaxa, nsites = int(header[0]), int(header[1])
    names: list[str] = []
    chunks: list[list[str]] = []
    li = 1
    # first block: lines start with a name
    while len(names) < ntaxa and li < len(lines):
        ln = lines[li]
        parts = ln.split(None, 1)
        nm = parts[0]
        seq = parts[1].replace(" ", "") if len(parts) > 1 else ""
        names.append(nm)
        chunks.append([seq])
        li += 1
    # remaining interleaved blocks
    ti = 0
    while li < len(lines):
        ln = lines[li].strip()
        li += 1
        if not ln:
            continue
        # interleaved continuation lines may or may not repeat the name
        parts = ln.split(None, 1)
        if parts[0] in names and len(parts) > 1:
            idx = names.index(parts[0])
            chunks[idx].append(parts[1].replace(" ", ""))
            ti = (idx + 1) % ntaxa
        else:
            chunks[ti].append(ln.replace(" ", ""))
            ti = (ti + 1) % ntaxa
    seqs = ["".join(c) for c in chunks]
    for nm, s in zip(names, seqs):
        if len(s) != nsites:
            raise ValueError(
                f"PHYLIP: sequence {nm} has {len(s)} sites, expected {nsites}")
    return names, seqs


def _code_chars(st) -> tuple[dict[int, str], int]:
    """(code -> the text written for it, characters per site): one
    character per code, and for codon data the sense triplet of each
    state and NNN for the unknown code (the JAX package's writers give
    codons one '?' each, which no reader takes back)."""
    if st.name.startswith("CODON"):
        from iqtree2_tpu_torch.model.codon import sense_codons
        chars = dict(enumerate(sense_codons(int(st.name[5:]))))
        chars[st.unknown_code] = "NNN"
        return chars, 3
    return {i: st.code_to_char(i) for i in range(st.num_codes)}, 1


def write_phylip(aln: Alignment, path) -> None:
    mat = aln.expand_to_sites()
    code_chars, width = _code_chars(aln.seqtype)
    with open(path, "w") as f:
        f.write(f"{aln.ntaxa} {aln.nsites * width}\n")
        for j, nm in enumerate(aln.names):
            seq = "".join(code_chars[int(c)] for c in mat[:, j])
            f.write(f"{nm:<12}{seq}\n")


# ------------------------------------------------------------------- FASTA
def parse_fasta(text: str) -> tuple[list[str], list[str]]:
    names, seqs = [], []
    cur: list[str] = []
    for ln in text.splitlines():
        if ln.startswith(">"):
            if names:
                seqs.append("".join(cur))
            names.append(ln[1:].strip().split()[0] if ln[1:].strip() else
                         f"seq{len(names) + 1}")
            cur = []
        else:
            cur.append(ln.strip())
    if names:
        seqs.append("".join(cur))
    return names, seqs


def write_fasta(aln: Alignment, path) -> None:
    mat = aln.expand_to_sites()
    code_chars, _ = _code_chars(aln.seqtype)
    with open(path, "w") as f:
        for j, nm in enumerate(aln.names):
            f.write(f">{nm}\n")
            seq = "".join(code_chars[int(c)] for c in mat[:, j])
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80] + "\n")


# ------------------------------------------------------------------ NEXUS
def read_nexus_alignment(text: str, seqtype=None, name="") -> Alignment:
    nex = parse_nexus(text)
    data = nex.data_matrix
    if data is None:
        raise ValueError("NEXUS file has no DATA/CHARACTERS block")
    names = list(data.keys())
    seqs = [data[n] for n in names]
    if seqtype is None and nex.datatype:
        dt = nex.datatype.upper()
        seqtype = {"DNA": "DNA", "NUCLEOTIDE": "DNA", "RNA": "DNA",
                   "PROTEIN": "AA", "STANDARD": "MORPH",
                   "BINARY": "BIN"}.get(dt, None)
    aln = Alignment.from_sequences(names, seqs, seqtype=seqtype, name=name)
    return aln


# ----------------------------------------------------------------- CLUSTAL
def parse_clustal(text: str) -> tuple[list[str], list[str]]:
    names: list[str] = []
    seqs: dict[str, list[str]] = {}
    for ln in text.splitlines()[1:]:
        if not ln.strip() or ln.startswith((" ", "\t")):
            continue
        parts = ln.split()
        if len(parts) < 2:
            continue
        nm, chunk = parts[0], parts[1]
        if set(chunk) <= set(".:* "):
            continue
        if nm not in seqs:
            names.append(nm)
            seqs[nm] = []
        seqs[nm].append(chunk)
    return names, ["".join(seqs[n]) for n in names]


# -------------------------------------------------------------------- MSF
def parse_msf(text: str) -> tuple[list[str], list[str]]:
    body = text.split("//", 1)
    if len(body) != 2:
        raise ValueError("MSF: missing // separator")
    names: list[str] = []
    seqs: dict[str, list[str]] = {}
    for ln in body[1].splitlines():
        parts = ln.split()
        if len(parts) < 2:
            continue
        nm = parts[0]
        chunk = "".join(parts[1:])
        if not re.fullmatch(r"[A-Za-z.~\-?*]+", chunk):
            continue
        if nm not in seqs:
            names.append(nm)
            seqs[nm] = []
        seqs[nm].append(chunk.replace(".", "-").replace("~", "-"))
    return names, ["".join(seqs[n]) for n in names]
