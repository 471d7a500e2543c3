"""The port's phylogenetic diversity tools (-pd, -bud/-cost, -pdsets with
-endem and -comp) against the JAX package's, on the CPU: every .pda file
written by both command lines in this process equal byte for byte, and
the pd.py functions equal on the same trees (the tree knapsack and its
greedy fallback, user sets, endemism, complementarity, the exhaustive and
greedy area choices).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from iqtree2_tpu import pd as jpd
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import cli, pd
from iqtree2_tpu_torch.tree.topology import Tree
from tests.torch_parity import jax_cli_main

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
TREE = str(GOLDEN / "ref_tree.nwk")
NAMES = Tree.from_newick(Path(TREE).read_text()).taxon_names


def _write(d: Path, name: str, text: str) -> str:
    (d / name).write_text(text)
    return str(d / name)


def _areas(n: int, seed: int) -> str:
    """n areas of 2-6 taxa each, 'name: t1 t2 ...' lines (some taxset
    lines in the NEXUS form)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        taxa = rng.choice(NAMES, size=int(rng.integers(2, 7)), replace=False)
        lines.append(f"taxset A{i} = {' '.join(taxa)};" if i % 3 == 0
                     else f"A{i}: {' '.join(taxa)}")
    return "# areas\n" + "\n".join(lines) + "\n"


@pytest.mark.parametrize("flags", [
    ["-pd", "5"], ["-pd", "17"], ["-bud", "4"],
    ["-bud", "6.5", "-cost", "costs.txt"],
    ["-bud", "3.3", "-cost", "fractional.txt"],
    ["-pdsets", "areas.txt", "-pd", "2", "-endem", "-comp", "A1,A2"],
    ["-pdsets", "many.txt", "-pd", "3"],
], ids=["k5", "all", "budget", "costs", "greedy", "areas", "many-areas"])
def test_pda_files_match_jax(tmp_path, monkeypatch, flags):
    rng = np.random.default_rng(1)
    _write(tmp_path, "costs.txt", "".join(
        f"{n} {int(rng.integers(1, 4))}\n" for n in NAMES))
    _write(tmp_path, "fractional.txt", "".join(
        f"{n} {rng.uniform(0.3, 1.7):.4f}\n" for n in NAMES))
    _write(tmp_path, "areas.txt", _areas(6, 2))
    _write(tmp_path, "many.txt", _areas(22, 3))
    flags = [str(tmp_path / f) if f.endswith(".txt") else f for f in flags]
    assert cli.main(["-t", TREE, "-pre", str(tmp_path / "port")]
                    + flags) == 0
    assert jax_cli_main(["-t", TREE, "-pre", str(tmp_path / "jax")]
                        + flags, monkeypatch) == 0
    port = (tmp_path / "port.pda").read_bytes()
    assert port == (tmp_path / "jax.pda").read_bytes()
    assert b"PD" in port


def test_pd_functions_match_jax():
    nwk = Path(TREE).read_text()
    t, jt = Tree.from_newick(nwk), JTree.from_newick(nwk)
    for k in (2, 3, 9):
        assert pd.greedy_pd(t, k) == jpd.greedy_pd(jt, k)
    taxa = [0, 3, 5, 11, 16]
    assert pd.pd_score(t, taxa) == jpd.pd_score(jt, taxa)
    costs = {i: 1.0 + (i % 3) for i in range(17)}
    for budget in (2.0, 5.0, 11.0):
        assert pd.budget_pd(t, budget, costs) == \
            jpd.budget_pd(jt, budget, costs)
    odd = {i: 0.37 + 0.011 * i for i in range(17)}
    assert pd.budget_pd(t, 2.5, odd) == jpd.budget_pd(jt, 2.5, odd)
    sets = pd.parse_sets_file(_areas(8, 5), NAMES)
    assert sets == jpd.parse_sets_file(_areas(8, 5), NAMES)
    assert pd.pd_user_sets(t, sets) == jpd.pd_user_sets(jt, sets)
    assert pd.pd_endemism(t, sets) == jpd.pd_endemism(jt, sets)
    assert pd.pd_complementarity(t, sets, ["A0"]) == \
        jpd.pd_complementarity(jt, sets, ["A0"])
    assert pd.greedy_pd_areas(t, sets, 3) == jpd.greedy_pd_areas(jt, sets, 3)
