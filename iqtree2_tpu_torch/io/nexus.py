"""Minimal NEXUS parser: DATA/CHARACTERS, SETS (charset/charpartition),
TREES, and TAXA blocks.

Replaces the reference's vendored NEXUS Class Library (ncl/, 12k LoC) with a
small host-side parser covering what the pipeline needs: alignments, partition
definitions (reference: alignment/superalignment.cpp readPartition), and tree
lists.

Copied from iqtree2_tpu/io/nexus.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass
class CharSet:
    """A charset: name + list of (start, end, step) 1-based inclusive ranges,
    or a reference to another alignment file for partition models."""
    name: str
    ranges: list[tuple[int, int, int]]
    aln_file: str = ""
    seqtype: str = ""

    def site_indices(self, nsites: int | None = None) -> list[int]:
        out: list[int] = []
        for (a, b, c) in self.ranges:
            end = b if b > 0 else (nsites or 0)
            out.extend(range(a - 1, end, c))
        return out


@dataclasses.dataclass
class NexusFile:
    data_matrix: dict[str, str] | None = None
    datatype: str = ""
    ntax: int = 0
    nchar: int = 0
    missing: str = "?"
    gap: str = "-"
    charsets: list[CharSet] = dataclasses.field(default_factory=list)
    charpartitions: dict[str, list[tuple[str, str]]] = dataclasses.field(
        default_factory=dict)
    trees: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    taxa: list[str] = dataclasses.field(default_factory=list)
    # model assignments from a charpartition like "GTR+G:part1, HKY:part2"
    models: dict[str, str] = dataclasses.field(default_factory=dict)


def _strip_comments(text: str) -> str:
    out = []
    depth = 0
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out)


def _split_commands(block: str) -> list[str]:
    """Split block text on ';' that are not inside quotes."""
    cmds, cur, q = [], [], None
    for ch in block:
        if q:
            cur.append(ch)
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            cur.append(ch)
        elif ch == ";":
            cmds.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        cmds.append(tail)
    return cmds


def _unquote(tok: str) -> str:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1].replace("''", "'")
    return tok


def parse_nexus(text: str) -> NexusFile:
    nx = NexusFile()
    stripped = _strip_comments(text)
    for m in re.finditer(r"begin\s+(\w+)\s*;(.*?)end\s*;", stripped,
                         re.IGNORECASE | re.DOTALL):
        bname = m.group(1).lower()
        body = m.group(2)
        if bname in ("data", "characters"):
            _parse_data_block(nx, body)
        elif bname == "sets":
            _parse_sets_block(nx, body)
        elif bname == "trees":
            _parse_trees_block(nx, body)
        elif bname == "taxa":
            _parse_taxa_block(nx, body)
    return nx


def _parse_data_block(nx: NexusFile, body: str) -> None:
    for cmd in _split_commands(body):
        low = cmd.lower()
        if low.startswith("dimensions"):
            mt = re.search(r"ntax\s*=\s*(\d+)", low)
            if mt:
                nx.ntax = int(mt.group(1))
            mc = re.search(r"nchar\s*=\s*(\d+)", low)
            if mc:
                nx.nchar = int(mc.group(1))
        elif low.startswith("format"):
            md = re.search(r"datatype\s*=\s*(\w+)", low)
            if md:
                nx.datatype = md.group(1)
            mm = re.search(r"missing\s*=\s*(\S)", low)
            if mm:
                nx.missing = mm.group(1)
            mg = re.search(r"gap\s*=\s*(\S)", low)
            if mg:
                nx.gap = mg.group(1)
        elif low.startswith("matrix"):
            mat_text = cmd[len("matrix"):]
            seqs: dict[str, list[str]] = {}
            order: list[str] = []
            for ln in mat_text.splitlines():
                ln = ln.strip()
                if not ln:
                    continue
                mq = re.match(r"^('[^']*'|\"[^\"]*\"|\S+)\s+(.*)$", ln)
                if not mq:
                    continue
                nm = _unquote(mq.group(1))
                chunk = mq.group(2).replace(" ", "")
                if nm not in seqs:
                    seqs[nm] = []
                    order.append(nm)
                seqs[nm].append(chunk)
            nx.data_matrix = {nm: "".join(seqs[nm]) for nm in order}


_RANGE_RE = re.compile(r"^(\d+)(?:\s*-\s*(\d+|\.))?(?:\s*\\\s*(\d+))?$")


def parse_charset_ranges(spec: str) -> list[tuple[int, int, int]]:
    ranges = []
    for part in spec.split():
        mt = _RANGE_RE.match(part.strip())
        if not mt:
            continue
        a = int(mt.group(1))
        b = mt.group(2)
        b = a if b is None else (-1 if b == "." else int(b))
        c = int(mt.group(3)) if mt.group(3) else 1
        ranges.append((a, b, c))
    return ranges


def _parse_sets_block(nx: NexusFile, body: str) -> None:
    for cmd in _split_commands(body):
        low = cmd.lower()
        if low.startswith("charset"):
            mt = re.match(r"charset\s+('[^']*'|\S+)\s*=\s*(.*)$", cmd,
                          re.IGNORECASE | re.DOTALL)
            if not mt:
                continue
            nm = _unquote(mt.group(1))
            spec = mt.group(2).strip()
            # "charset part1 = aln.phy: 1-100" style (file reference) used by
            # IQ-TREE partition files
            fm = re.match(r"^(\S+\.\w+)\s*:\s*(.*)$", spec)
            aln_file = ""
            seqt = ""
            if fm:
                aln_file, spec = fm.group(1), fm.group(2)
            # optional "DNA," / "AA," type prefix (IQ-TREE -sp files)
            tm = re.match(
                r"^(DNA|AA|BIN|MORPH|CODON\d*|NT2AA)\s*,\s*(.*)$",
                spec, re.IGNORECASE)
            if tm:
                seqt, spec = tm.group(1), tm.group(2)
            nx.charsets.append(CharSet(
                name=nm, ranges=parse_charset_ranges(spec),
                aln_file=aln_file, seqtype=seqt))
        elif low.startswith("charpartition"):
            mt = re.match(r"charpartition\s+(\S+)\s*=\s*(.*)$", cmd,
                          re.IGNORECASE | re.DOTALL)
            if not mt:
                continue
            nm = mt.group(1)
            entries = []
            for item in mt.group(2).split(","):
                if ":" in item:
                    model, cs = item.split(":", 1)
                    entries.append((model.strip(), cs.strip()))
            nx.charpartitions[nm] = entries
            for model, cs in entries:
                nx.models[cs] = model


def _parse_trees_block(nx: NexusFile, body: str) -> None:
    translate: dict[str, str] = {}
    for cmd in _split_commands(body):
        low = cmd.lower()
        if low.startswith("translate"):
            items = cmd[len("translate"):].split(",")
            for it in items:
                parts = it.split()
                if len(parts) >= 2:
                    translate[parts[0]] = _unquote(parts[1])
        elif low.startswith("tree"):
            mt = re.match(r"tree\s+(\S+)\s*=\s*(?:\[[^\]]*\]\s*)?(.*)$", cmd,
                          re.IGNORECASE | re.DOTALL)
            if mt:
                nm, nwk = mt.group(1), mt.group(2).strip()
                if translate:
                    nwk = _apply_translate(nwk, translate)
                nx.trees.append((nm, nwk))


def _apply_translate(nwk: str, table: dict[str, str]) -> str:
    def repl(m):
        tok = m.group(0)
        return table.get(tok, tok)
    return re.sub(r"[^\s(),:;\[\]]+(?=[,():;])|[^\s(),:;\[\]]+$",
                  lambda m: table.get(m.group(0), m.group(0)), nwk)


def _parse_taxa_block(nx: NexusFile, body: str) -> None:
    for cmd in _split_commands(body):
        if cmd.lower().startswith("taxlabels"):
            toks = re.findall(r"'[^']*'|\S+", cmd[len("taxlabels"):])
            nx.taxa = [_unquote(t) for t in toks]
