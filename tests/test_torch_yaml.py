"""--mdef YAML definitions: the port's reader (io/yamlmodels.parse_yaml,
written because the machine with the card has no PyYAML) against
yaml.safe_load, and the datatypes and models it defines against the JAX
package's, float64 on the CPU.

The documents are the JAX package's own test document
(tests/test_aux_features.py), hand-written ones in the schema's styles,
and documents that hypothesis generates from the schema. The JAX side
loads the same files with its own load_definitions; the datatype and
model names are the JAX test's, defined the same way, so the two
packages' registries never disagree in one process.
"""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

from iqtree2_tpu.engine import LikelihoodEngine as JEngine
from iqtree2_tpu.io import yamlmodels as jyaml
from iqtree2_tpu.model.factory import build_model as jbuild_model
from iqtree2_tpu_torch import cli
from iqtree2_tpu_torch.data import seqtypes
from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io import yamlmodels
from iqtree2_tpu_torch.io.yamlmodels import parse_yaml
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.tree.topology import Tree
from tests.torch_parity import both_trees, jax_alignment

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_aux_features.py's document
JAX_DOC = """
- datatype: RY
  state: [R, Y]
  missing: "?-"
- model: MYRY
  datatype: RY
  rates: [1.0]
  frequencies: [0.6, 0.4]
- model: MYUNREST
  datatype: DNA
  reversible: false
  matrix: [[0, 1, 2, 1], [1, 0, 1, 2], [2, 1, 0, 1], [1, 2, 1, 0]]
"""

# a DNA model with every parameter fixed, as a list item
MYGTR_DOC = """\
- model: MYGTR
  datatype: DNA
  rates: [1.5, 4.0, 1.2, 0.8, 5.0, 1.0]
  frequencies: [0.3, 0.2, 0.2, 0.3]
"""

DOCS = {
    "jax test": JAX_DOC,
    "one mapping, comments, a flow list over lines": """\
# a DNA model
model: MYGTR   # six rates
datatype: DNA
rates: [1.5, 4.0, 1.2,
        0.8, 5.0, 1.0]
frequencies: [0.3, 0.2, 0.2, 0.3]
""",
    "equate, quotes and scalars": """\
---
- datatype: ABC
  state: [A, B, 'C']
  missing: '?'
  equate: {X: [A, B], "Z": [B, C], N: []}
- model: M1
  datatype: ABC
  rates: [1, 2.5, .5]
  fix_rates: no
  freq_type: estimate
  note: "tab\\tand \\"quote\\" # kept"
  other: it's plain
""",
    "block collections and resolved scalars": """\
- model: M2
  rates:
    - 1.0
    - 2
  nested:
    a: 0x1F
    b: 010
    c: 1_000
    d: 1e-3
    e: ~
    f: -.inf
    g: 2:30
    h:
  list:
  - [1, [2, 3], {k: v}]
  -
    - deep
""",
}


def test_reader_matches_safe_load_on_documents():
    for name, doc in DOCS.items():
        assert parse_yaml(doc) == yaml.safe_load(doc), name


_WORD = hs.text("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz",
                min_size=1, max_size=6)
_PLAIN = hs.one_of(
    _WORD, hs.integers(-10**6, 10**6).map(str),
    hs.floats(-1e6, 1e6, allow_nan=False).map(repr),
    hs.floats(0, 10, allow_nan=False).map(lambda x: f"{x:.3e}"),
    hs.sampled_from(["true", "False", "yes", "off", "null", "~", "-1.5",
                     ".5", "1_000", "0x1f", "017", "1e5", "3.", "-.inf"]))
_QUOTED = hs.one_of(
    hs.text("abc XYZ?-#:,[]{}'", max_size=8).map(
        lambda t: '"' + t.replace("\\", "\\\\").replace('"', '\\"') + '"'),
    hs.text("abc XYZ?-#:,[]{}\"", max_size=8).map(
        lambda t: "'" + t.replace("'", "''") + "'"))
_SCALAR = hs.one_of(_PLAIN, _QUOTED)


def _flow_list(children):
    return hs.lists(children, max_size=4).map(
        lambda xs: "[" + ", ".join(xs) + "]")


_FLOW = hs.recursive(_SCALAR, lambda inner: hs.one_of(
    _flow_list(inner),
    hs.dictionaries(_WORD, inner, max_size=3).map(
        lambda d: "{" + ", ".join(f"{k}: {v}" for k, v in d.items())
        + "}")), max_leaves=8)
_ENTRY = hs.tuples(
    hs.sampled_from(["datatype", "state", "model", "rates", "matrix",
                     "frequencies", "equate", "missing", "reversible"]),
    _FLOW, hs.booleans())


def _render(docs, wrap: bool) -> str:
    """A block list of mappings; each value on its key's line, a flow
    list optionally broken after its first comma, an optional comment."""
    lines = ["# generated"]
    for entries in docs:
        for i, (key, value, comment) in enumerate(entries):
            if wrap and value.startswith("[") and ", " in value:
                value = value.replace(", ", ",\n      ", 1)
            lines.append(("- " if i == 0 else "  ") + f"{key}: {value}"
                         + ("  # note" if comment else ""))
    return "\n".join(lines) + "\n"


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(hs.lists(hs.lists(_ENTRY, min_size=1, max_size=5), min_size=1,
                max_size=4), hs.booleans())
def test_reader_matches_safe_load_on_generated_documents(docs, wrap):
    text = _render(docs, wrap)
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("doc,what", [
    ("- a: &x 1\n- b: *x\n", "anchors"),
    ("a: |\n  text\n", "block scalars"),
    ("a: !!str 1\n", "tags"),
    ("a: 1\n---\nb: 2\n", "one document"),
    ("a:\n\t- 1\n", "tab"),
    ("a: [1, 2\n", "unclosed"),
    ("a: plain\n  continued\n", "several lines"),
])
def test_reader_refuses_what_it_does_not_read(doc, what):
    with pytest.raises(ValueError, match="--mdef YAML line"):
        parse_yaml(doc)


def _define_both(tmp_path, doc: str):
    path = tmp_path / "defs.yml"
    path.write_text(doc)
    return (yamlmodels.load_definitions(str(path)),
            jyaml.load_definitions(str(path)))


def test_definitions_match_jax(tmp_path):
    """The registries after the JAX test's document, and the RY datatype
    (get_seqtype finds it) equal to the JAX package's."""
    port, jax = _define_both(tmp_path, JAX_DOC)
    assert port == jax == (["RY"], ["MYRY", "MYUNREST"])
    st, jst = seqtypes.get_seqtype("RY"), jyaml.DATATYPES["RY"]
    assert st is yamlmodels.DATATYPES["RY"]
    assert (st.name, st.num_states, st.unknown_code, st.state_chars) == \
        (jst.name, jst.num_states, jst.unknown_code, jst.state_chars)
    np.testing.assert_array_equal(st.tip_table, jst.tip_table)
    np.testing.assert_array_equal(st.char_to_code, jst.char_to_code)
    assert yamlmodels.MODELS["MYRY"] == jyaml.MODELS["MYRY"]


def test_yaml_model_loglik_matches_jax(tmp_path):
    """MYRY+G2 on an RY alignment with missing states, and a YAML DNA
    model on DNA with gaps, against the JAX package's float64
    log-likelihoods (1e-9 relative)."""
    _define_both(tmp_path, JAX_DOC + MYGTR_DOC)
    rng = np.random.default_rng(0)
    names = ["a", "b", "c", "d", "e", "f"]
    cases = [(Alignment.from_sequences(
        names, ["".join(rng.choice(list("RY?"), 60)) for _ in names],
        seqtype="RY"), "MYRY+G2"),
        (Alignment.from_sequences(
            names, ["".join(rng.choice(list("ACGT-"), 80)) for _ in names],
            seqtype="DNA"), "MYGTR+G{0.6}")]
    for aln, model_str in cases:
        assert aln.num_states == (2 if model_str.startswith("MYRY") else 4)
        tree, jtree = both_trees(Tree.random_topology(names, rng), names)
        model, rates, _ = build_model(model_str, aln)
        jaln = jax_alignment(aln)
        jmodel, jrates, _ = jbuild_model(model_str, jaln)
        got = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                               device="cpu").loglik_tree(tree)
        want = JEngine(jaln, jmodel, jrates,
                       dtype=jnp.float64).loglik_tree(jtree)
        assert math.isclose(got, want, rel_tol=1e-9), model_str


def test_nonreversible_yaml_model_refused(tmp_path):
    """reversible: false builds an UnrestModel of its matrix, as the JAX
    package does, equal to -m UNREST{...} of the same rates; what is still
    refused is +E beside it (C16) and +H (C18)."""
    _define_both(tmp_path, JAX_DOC)
    aln = Alignment.from_sequences(["a", "b", "c"], ["ACGT"] * 3,
                                   seqtype="DNA")
    model, _, _ = build_model("MYUNREST", aln)
    jmodel, _, _ = jbuild_model("MYUNREST", jax_alignment(aln))
    np.testing.assert_array_equal(model.rates, jmodel.rates)
    assert model.name == jmodel.name == "MYUNREST"
    same, _, _ = build_model("UNREST{1,2,1,1,1,2,2,1,1,1,2,1}", aln)
    np.testing.assert_array_equal(model.get_eigensystem().Q,
                                  same.get_eigensystem().Q)
    with pytest.raises(SystemExit, match="sequencing-error"):
        build_model("MYUNREST+E", aln)
    with pytest.raises(SystemExit, match="nonreversible"):
        build_model("MYUNREST+H2", aln)


def test_mdef_through_the_cli(tmp_path):
    """--mdef, -st RY and a YAML model through the command line: the log
    line of the definitions and a finite logL; with -q (C17: the JAX
    partition path never reads --mdef) a SystemExit."""
    defs = tmp_path / "defs.yml"
    defs.write_text(JAX_DOC)
    rng = np.random.default_rng(1)
    names = [f"t{i}" for i in range(6)]
    phy = tmp_path / "ry.phy"
    phy.write_text(f"6 50\n" + "".join(
        f"{n:<10}{''.join(rng.choice(list('RY'), 50))}\n" for n in names))
    nwk = tmp_path / "ry.nwk"
    nwk.write_text(Tree.random_topology(names, rng).to_newick() + "\n")
    pre = tmp_path / "r"
    assert cli.main(["--mdef", str(defs), "-s", str(phy), "-st", "RY", "-m",
                     "MYRY+G2", "-te", str(nwk), "--device", "cpu", "-pre",
                     str(pre), "--quiet"]) == 0
    assert "Loaded YAML definitions: datatypes ['RY'], models ['MYRY', " \
        "'MYUNREST']" in Path(f"{pre}.log").read_text()
    text = Path(f"{pre}.iqtree").read_text()
    logl = float(text.split("Log-likelihood of the tree:")[1].split()[0])
    assert math.isfinite(logl) and "MYRY+G2" in text
    nex = tmp_path / "p.nex"
    nex.write_text("#nexus\nbegin sets;\n  charset a = 1-25;\n  charset b "
                   "= 26-50;\nend;\n")
    with pytest.raises(SystemExit, match="--mdef with -p/-q/-Q"):
        cli.main(["--mdef", str(defs), "-s", str(phy), "-q", str(nex),
                  "--device", "cpu", "-pre", str(pre)])
