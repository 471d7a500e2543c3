"""YAML model / datatype definitions (--mdef).

Reference analog: the phylo-yaml library (phylo-yaml/statespace.h, yaml-cpp
vendored lib) — user-defined state spaces with `datatype / state / equate`
keys, and custom substitution models. Schema supported here:

  - datatype: MYTYPE
    state: [A, B, C]
    missing: "?"           # optional (also '-')
    equate: {X: [A, B]}    # ambiguity codes

  - model: MYMODEL
    datatype: MYTYPE       # or DNA/AA/BIN/MORPH
    rates: [r12, r13, ..]  # upper-triangle exchangeabilities (row-major)
    frequencies: [..]      # optional; default estimate
    reversible: true       # false -> full rate matrix `matrix: [[..],..]`

Models registered here become usable in -m strings.

Copied from iqtree2_tpu/io/yamlmodels.py (load_definitions, _build_datatype,
make_yaml_model) with a reader of its own in place of PyYAML, which the
machine with the card does not have: ``parse_yaml`` reads the subset of
YAML such files are written in (a block list or a mapping of mappings,
nested block collections, plain and quoted scalars, flow lists and flow
mappings over any number of lines, ``#`` comments) and resolves plain
scalars as yaml.safe_load does; anything else (anchors, tags, block
scalars, several documents) stops with a ValueError naming the line.
A nonreversible model (``reversible: false``) is an UnrestModel of its
``matrix`` (model/nonrev.py), as in the JAX package.
The port keeps its own host modules and imports nothing of the JAX
package.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

from iqtree2_tpu_torch.data.seqtypes import SeqType, _build

# global registries consulted by the factory / alignment reader
DATATYPES: dict[str, SeqType] = {}
MODELS: dict[str, dict] = {}


# ------------------------------------------------------------- the reader
# yaml.safe_load's implicit resolvers (YAML 1.1, PyYAML resolver.py)
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_FLOW_END = ",]}"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}


def _sexagesimal(text: str, num) -> float | int:
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + num(part)
    return sign * value


def resolve_scalar(text: str):
    """A plain scalar's value, as yaml.safe_load resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        t = text.replace("_", "")
        if ":" in t:
            return _sexagesimal(t, int)
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.fullmatch(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        if ":" in t:
            return _sexagesimal(t, float)
        return float(t)
    return text


class _Line(NamedTuple):
    no: int          # line number in the file
    indent: int
    text: str        # without indentation and comment


def _is_item(text: str) -> bool:
    """A block list item ('- value' or a bare '-')."""
    return text == "-" or text.startswith("- ")


def _error(no: int, msg: str) -> ValueError:
    return ValueError(f"--mdef YAML line {no}: {msg}")


def _strip_comment(line: str) -> str:
    """The line without its comment (a # at its start or after a blank,
    outside quotes)."""
    quote, i = None, 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == quote:
                quote = None
            elif ch == "\\" and quote == '"':
                i += 1
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _lines(text: str) -> list[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t") or "\t" in body[: len(body)
                                                     - len(stripped)]:
            raise _error(no, "tab in indentation")
        indent = len(body) - len(stripped)
        if indent == 0 and stripped in ("---", "..."):
            if stripped == "..." or out:
                raise _error(no, "one document per file is supported")
            continue
        if indent == 0 and stripped.startswith("%"):
            raise _error(no, "directives are not supported")
        out.append(_Line(no, indent, stripped))
    return out


class _Flow:
    """A flow node ([...], {...}, quoted or plain scalar) read from text."""

    def __init__(self, text: str, no: int):
        self.s, self.i, self.no = text, 0, no

    def error(self, msg: str) -> ValueError:
        return _error(self.no, f"{msg} in {self.s.strip()!r}")

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def node(self, in_flow: bool):
        self.ws()
        if self.i >= len(self.s):
            raise self.error("missing value")
        ch = self.s[self.i]
        if ch == "[":
            return self.collection("]")
        if ch == "{":
            return self.collection("}")
        if ch in "'\"":
            return self.quoted(ch)
        if ch in "&*!|>%@`?":
            raise self.error(f"{ch!r} (anchors, tags and block scalars are "
                             f"not supported)")
        return self.plain(in_flow)

    def plain(self, in_flow: bool):
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            if in_flow and ch in _FLOW_END:
                break
            if ch == ":" and (self.i + 1 == len(self.s)
                              or self.s[self.i + 1] in " \t\n"
                              or (in_flow and self.s[self.i + 1]
                                  in _FLOW_END)):
                break
            if in_flow and ch in "[{":
                raise self.error(f"{ch!r} inside a plain scalar")
            self.i += 1
        # a line break inside a flow scalar folds into one space
        text = re.sub(r"[ \t]*\n[ \t]*", " ", self.s[start: self.i].strip())
        if text.startswith("- ") or text == "-":
            raise self.error("a block list inside a value")
        return resolve_scalar(text)

    def quoted(self, q: str) -> str:
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise self.error("unterminated quoted string")
            ch = self.s[self.i]
            if ch == q:
                if q == "'" and self.s[self.i + 1: self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if ch == "\n":
                raise self.error("a quoted string over several lines")
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1: self.i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.i += 2
                    continue
                width = {"x": 2, "u": 4, "U": 8}.get(esc)
                code = self.s[self.i + 2: self.i + 2 + (width or 0)]
                if not width or not re.fullmatch(r"[0-9a-fA-F]+", code) \
                        or len(code) != width:
                    raise self.error(f"escape \\{esc}")
                out.append(chr(int(code, 16)))
                self.i += 2 + width
                continue
            out.append(ch)
            self.i += 1

    def collection(self, close: str):
        self.i += 1
        is_map = close == "}"
        out: dict | list = {} if is_map else []
        while True:
            self.ws()
            if self.i >= len(self.s):
                raise self.error(f"unclosed {'{' if is_map else '['}")
            if self.s[self.i] == close:
                self.i += 1
                return out
            key = self.node(True)
            self.ws()
            at = self.s[self.i: self.i + 1]
            if is_map:
                if at != ":":
                    raise self.error("a flow mapping entry without ':'")
                self.i += 1
                self.ws()
                if self.s[self.i: self.i + 1] in (",", close):
                    value = None
                else:
                    value = self.node(True)
                if isinstance(key, (list, dict)):
                    raise self.error("a collection as a mapping key")
                out[key] = value
            else:
                if at == ":":
                    raise self.error("a mapping inside a flow list")
                out.append(key)
            self.ws()
            at = self.s[self.i: self.i + 1]
            if at == ",":
                self.i += 1
            elif at != close:
                raise self.error(f"expected ',' or {close!r}")


def _open_brackets(text: str) -> int:
    """Flow brackets left open at the end of ``text`` (quotes skipped)."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


class _Block:
    """Indentation-structured block collections over the comment-free
    lines."""

    def __init__(self, lines: list[_Line]):
        self.lines, self.k = lines, 0

    def peek(self) -> _Line | None:
        return self.lines[self.k] if self.k < len(self.lines) else None

    def node(self):
        """The node starting at the next line, at its indent."""
        ln = self.peek()
        if _is_item(ln.text):
            return self.sequence(ln.indent)
        if _key_split(ln.text, ln.no) is not None:
            return self.mapping(ln.indent)
        self.k += 1
        return self.inline(ln.text, ln.no, ln.indent)

    def inline(self, text: str, no: int, indent: int):
        """A value written after 'key: ' or '- ': a scalar or a flow
        collection, which may go on over the lines indented past
        ``indent``."""
        while _open_brackets(text) > 0:
            ln = self.peek()
            if ln is None or ln.indent <= indent:
                raise _error(no, "unclosed flow collection")
            text += "\n" + ln.text
            self.k += 1
        ln = self.peek()
        if ln is not None and ln.indent > indent and text[:1] not in "[{":
            raise _error(ln.no, "a scalar over several lines is not "
                                "supported")
        flow = _Flow(text, no)
        value = flow.node(False)
        flow.ws()
        if flow.i != len(flow.s):
            raise flow.error("text after the value")
        return value

    def child(self, indent: int, seq_same: bool):
        """The block under 'key:' or '-' (null where there is none); a
        mapping's value may be a list at the key's own indent."""
        ln = self.peek()
        if ln is not None and (ln.indent > indent or (
                seq_same and ln.indent == indent and _is_item(ln.text))):
            return self.node()
        return None

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            ln = self.peek()
            if ln is None or ln.indent < indent:
                return out
            if ln.indent > indent or not _is_item(ln.text):
                if ln.indent == indent:
                    return out
                raise _error(ln.no, "bad indentation")
            rest = ln.text[1:].lstrip(" ")
            if not rest:
                self.k += 1
                out.append(self.child(indent, False))
                continue
            # '- item' opens a node at the item's column
            col = ln.indent + len(ln.text) - len(rest)
            self.lines[self.k] = _Line(ln.no, col, rest)
            out.append(self.node())

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            ln = self.peek()
            if ln is None or ln.indent < indent:
                return out
            if ln.indent > indent:
                raise _error(ln.no, "bad indentation")
            split = _key_split(ln.text, ln.no)
            if split is None:
                if _is_item(ln.text):
                    return out
                raise _error(ln.no, "expected 'key: value'")
            key, rest = split
            self.k += 1
            if rest:
                value = self.inline(rest, ln.no, indent)
            else:
                value = self.child(indent, True)
            out[key] = value


def _key_split(text: str, no: int):
    """(key, the text after 'key:') of a block mapping entry, or None."""
    if text[:1] in "[{":
        return None
    flow = _Flow(text, no)
    if text[:1] in "'\"":
        key = flow.quoted(text[0])
    else:
        if text[:1] == "?":
            raise flow.error("complex keys are not supported")
        start = flow.i
        while flow.i < len(text) and not (
                text[flow.i] == ":" and (flow.i + 1 == len(text)
                                         or text[flow.i + 1] in " \t")):
            flow.i += 1
        if flow.i == len(text):
            return None
        key = resolve_scalar(text[start: flow.i].strip())
    flow.ws()
    if text[flow.i: flow.i + 1] != ":":
        return None
    return key, text[flow.i + 1:].strip()


def parse_yaml(text: str):
    """The document of ``text`` as yaml.safe_load reads it, for the block
    and flow subset described in the module docstring."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node()
    ln = block.peek()
    if ln is not None:
        raise _error(ln.no, "bad indentation")
    return value


# ------------------------------------------------------------- definitions
def _build_datatype(d: dict) -> SeqType:
    name = str(d["datatype"]).upper()
    states = [str(s) for s in d["state"]]
    S = len(states)
    rows = [[1.0 if i == j else 0.0 for j in range(S)] for i in range(S)]
    chars = {s: i for i, s in enumerate(states)}
    # ambiguity codes
    for ch, members in (d.get("equate") or {}).items():
        row = [1.0 if s in [str(m) for m in members] else 0.0
               for s in states]
        rows.append(row)
        chars[str(ch)] = len(rows) - 1
    # unknown code (all states)
    rows.append([1.0] * S)
    unknown = len(rows) - 1
    for ch in (d.get("missing") or "?-"):
        chars[str(ch)] = unknown
    return _build(name, S, rows, chars, unknown_code=unknown,
                  state_chars="".join(states) if
                  all(len(s) == 1 for s in states) else states)


def load_definitions(path: str) -> tuple[list[str], list[str]]:
    """Parse a --mdef YAML file into the global registries.

    Returns (new datatype names, new model names)."""
    with open(path) as f:
        return define(f.read())


def define(text: str) -> tuple[list[str], list[str]]:
    """load_definitions of YAML text."""
    docs = parse_yaml(text)
    if isinstance(docs, dict):
        docs = [docs]
    dts, mds = [], []
    for d in docs or []:
        if not isinstance(d, dict):
            continue
        if "datatype" in d and "state" in d:
            st = _build_datatype(d)
            DATATYPES[st.name] = st
            dts.append(st.name)
        elif "model" in d:
            MODELS[str(d["model"]).upper()] = d
            mds.append(str(d["model"]).upper())
    return dts, mds


def make_yaml_model(name: str, aln):
    """Instantiate a registered YAML model for an alignment."""
    from iqtree2_tpu_torch.model.nonrev import UnrestModel
    from iqtree2_tpu_torch.model.subst import GTRModel
    d = MODELS[name.upper()]
    S = aln.num_states
    freqs = d.get("frequencies")
    if freqs is not None:
        freqs = np.asarray(freqs, float)
        freqs = freqs / freqs.sum()
    if d.get("reversible", True):
        rates = d.get("rates")
        if rates is None:
            rates = np.ones(S * (S - 1) // 2)
        rates = np.asarray(rates, float)
        if rates.shape[0] != S * (S - 1) // 2:
            raise ValueError(
                f"model {name}: expected {S * (S - 1) // 2} rates for "
                f"{S} states, got {rates.shape[0]}")
        ft = "user" if freqs is not None else \
            str(d.get("freq_type", "estimate"))
        return GTRModel(S, exch_rates=rates, freqs=freqs, freq_type=ft,
                        name=name.upper(),
                        fixed_rates=bool(d.get("fix_rates", True)))
    M = np.asarray(d["matrix"], float)
    if M.shape != (S, S):
        raise ValueError(f"model {name}: matrix must be [{S},{S}]")
    off = np.asarray([M[i, j] for i in range(S) for j in range(S)
                      if i != j])
    return UnrestModel(num_states=S, rates=off, name=name.upper())
