"""The port's likelihood mapping (ops/quartet.py) and Sankoff parsimony
(ops/pars.sankoff_score, sankoff_score_device) against the JAX package's,
on the CPU.

The JAX quartet Newton and Sankoff pass are XLA, not Pallas; the port's
are plain torch on the engine's device. Each side builds its own engine
from the same simulation (tests/torch_parity.simulate_both), in float64:
the three topology logLs of 16 quartets agree within 1e-8 relative and
the simplex regions are equal; the Sankoff scores of example.phy under a
unit and a transition/transversion cost matrix are equal on the host and
through the torch pass.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu.engine import LikelihoodEngine as JEngine
from iqtree2_tpu.io.alignment_io import read_alignment as jread_alignment
from iqtree2_tpu.ops import pars as jpars
from iqtree2_tpu.ops import quartet as jquartet
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.io.alignment_io import read_alignment
from iqtree2_tpu_torch.ops import pars, quartet
from iqtree2_tpu_torch.tree.topology import Tree
from tests.torch_parity import simulate_both

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
COSTS = {"unit": 1.0 - np.eye(4),
         "ts/tv": np.array([[0, 2, 1, 2], [2, 0, 2, 1], [1, 2, 0, 2],
                            [2, 1, 2, 0]], np.float64)}


@pytest.mark.parametrize("model_name", ["GTR+G4", "HKY+I", "LG+G4"])
def test_likelihood_mapping_matches_jax(model_name, tmp_path):
    (aln, _, model, rates), (jaln, _, jmodel, jrates) = simulate_both(
        model_name, 9, 240, seed=3)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")
    jeng = JEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    res = quartet.likelihood_mapping(eng, 16, np.random.default_rng(2))
    jres = jquartet.likelihood_mapping(jeng, 16, np.random.default_rng(2))
    np.testing.assert_array_equal(res["quartets"], jres["quartets"])
    np.testing.assert_allclose(res["logls"], jres["logls"], rtol=1e-8)
    np.testing.assert_array_equal(res["regions"], jres["regions"])
    assert res["regions"].sum() == 16
    quartet.write_lmap_svg(tmp_path / "port.svg", res["weights"])
    jquartet.write_lmap_svg(tmp_path / "jax.svg", jres["weights"])
    assert (tmp_path / "port.svg").read_text() == \
        (tmp_path / "jax.svg").read_text()


def test_quartet_newton_steps_as_jax():
    """One quartet batch with one and three Newton iterations (the ridge,
    the clipped step and the length bounds act the same way)."""
    (aln, _, model, rates), (jaln, _, jmodel, jrates) = simulate_both(
        "GTR+G4", 6, 150, seed=4)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                           device="cpu")
    jeng = JEngine(jaln, jmodel, jrates, dtype=jnp.float64)
    idx = np.array([[0, 1, 2, 3], [5, 4, 3, 2], [1, 3, 5, 0]], np.int32)
    for n_iter in (1, 3):
        out = quartet.quartet_topology_logls(idx, eng._tipP, eng._pack,
                                             eng._pw, 0.1, n_iter=n_iter)
        jout = jquartet.quartet_topology_logls(
            jnp.asarray(idx), jeng._dev_tipP, jeng._dev_pack, jeng._dev_pw,
            jnp.asarray(0.1, jnp.float64), n_iter=n_iter)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-8)


@pytest.mark.parametrize("cost", list(COSTS))
def test_sankoff_matches_jax(cost):
    aln, jaln = read_alignment(str(GOLDEN / "example.phy")), \
        jread_alignment(str(GOLDEN / "example.phy"))
    nwk = (GOLDEN / "ref_tree.nwk").read_text()
    t, jt = Tree.from_newick(nwk, aln.names), JTree.from_newick(nwk,
                                                                jaln.names)
    args = (aln.tip_codes(), aln.pattern_weights, COSTS[cost],
            aln.seqtype.tip_table)
    jargs = (jaln.tip_codes(), jaln.pattern_weights, COSTS[cost],
             jaln.seqtype.tip_table)
    want = jpars.sankoff_score(jt, *jargs)
    assert want == jpars.sankoff_score_device(jt, *jargs)
    assert pars.sankoff_score(t, *args) == want
    assert pars.sankoff_score_device(t, *args, device="cpu") == want
    assert want == int(want) and want < 2 ** 24


def test_sankoff_multifurcation_runs_on_the_host():
    """A tree with a polytomy: the schedule takes two children per node,
    so the device function scores it on the host, as the JAX one."""
    aln = read_alignment(str(GOLDEN / "example.phy"))
    jaln = jread_alignment(str(GOLDEN / "example.phy"))
    names = aln.names
    nwk = "(" + ",".join(names[:5]) + ",(" + ",".join(names[5:11]) + "),(" \
        + ",".join(names[11:]) + "));"
    t, jt = Tree.from_newick(nwk, names), JTree.from_newick(nwk, jaln.names)
    assert not t.check_binary_unrooted()
    cost = COSTS["ts/tv"]
    got = pars.sankoff_score_device(t, aln.tip_codes(), aln.pattern_weights,
                                    cost, aln.seqtype.tip_table,
                                    device="cpu")
    assert got == jpars.sankoff_score_device(
        jt, jaln.tip_codes(), jaln.pattern_weights, cost,
        jaln.seqtype.tip_table)
