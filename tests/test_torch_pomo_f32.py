"""PoMo's float32 reading at a fixed state (ROADMAP C-port 3): example.phy
on tests/golden/ref_tree.nwk under kernelcheck.MODELS["GTR+P19+G4"]'s
fixed parameters (112 states), on the CPU.

The float32 logL there read 0.214 below the float64 one, against 0.074
for the JAX package's float32 path. Casting one piece at a time from
float64 showed P carrying all of it: every matrix took the nine squarings
that the stiffest one needs (the JAX package's fixed eight never go
above eight, C20), and each squaring doubles float32's rounding error in
P. expm_ss now takes its squarings per matrix, with no floor in float32
and a scaled norm of up to 0.5 there. These tests hold the float64 P to
the JAX package's (1e-12), the float32 P at least as close to it as the
JAX package's float32 P comes, and the float32 logL to the float64 one
within 0.01 (measured 0.0014 below; the JAX package's float32 reads
0.074 below). The logLs sum float32 site log-likelihoods in float64, over
pattern windows of 128 that keep the plain down pass's [.., S, S, Pp]
products small; at 3.6e4 a float32 sum's own rounding step is 0.004.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree2_tpu import engine as jengine
from iqtree2_tpu.ops import pruning as jpruning
from iqtree2_tpu_torch import kernelcheck
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.ops import pruning
from iqtree2_tpu_torch.tree.schedule import build_schedule
from tests.torch_parity import both_trees, jax_alignment
from iqtree2_tpu.model.factory import build_model as jbuild_model

GOLDEN = "tests/golden/"
MODEL = "GTR+P19+G4"
WINDOW = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    """Both packages' engines at the fixed state, float64 and float32, with
    the port's schedule and transition tensors of each."""
    aln, tree, model, rates = kernelcheck.load_problem(
        GOLDEN + "example.phy", GOLDEN + "ref_tree.nwk", MODEL)
    tree, jtree = both_trees(tree, aln.names)
    jaln = jax_alignment(aln)
    jmodel, jrates, _ = jbuild_model(kernelcheck.MODELS[MODEL][2], jaln)
    sched = build_schedule(tree)
    out = {}
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32,
                                                    jnp.float32)):
        eng = LikelihoodEngine(aln, model, rates, dtype=dt, device="cpu")
        jeng = jengine.LikelihoodEngine(jaln, jmodel, jrates, dtype=jdt)
        blens = torch.as_tensor(sched.blens, dtype=dt)
        out[dt] = dict(
            eng=eng, sa=eng.schedule_arrays(sched),
            P=pruning.transition_tensors(blens, eng._pack),
            jP=np.asarray(jpruning.transition_tensors(
                jnp.asarray(sched.blens, jdt), jeng._dev_pack)))
    return out


def _logl(side) -> float:
    """The side's logL from its float32 or float64 site log-likelihoods,
    summed in float64 over windows of WINDOW patterns."""
    eng, P = side["eng"], side["P"]
    tip, pack, pw = eng._tipP, eng._pack, eng._pw
    total = 0.0
    for a in range(0, tip.shape[-1], WINDOW):
        win = {**pack, "log_ptn_invar": pack["log_ptn_invar"][a:a + WINDOW]}
        dp = pruning.down_pass(P, tip[..., a:a + WINDOW].contiguous(),
                               side["sa"], pack=win, tips=False)
        total += float((pw[a:a + WINDOW].double() * dp.lp.double()).sum())
    return total


def test_float32_transition_tensors_at_example_state(state):
    """float64 P equals the JAX package's; the float32 P lies at least as
    close to it as the JAX package's float32 P does (measured 7.9e-6
    against 1.8e-5 of the largest entry, 3.2e-5 with nine squarings for
    every matrix)."""
    want = state[torch.float64]["jP"]
    scale = np.abs(want).max()
    assert np.abs(state[torch.float64]["P"].numpy() - want).max() \
        <= 1e-12 * scale
    port = np.abs(state[torch.float32]["P"].numpy() - want).max() / scale
    jax32 = np.abs(state[torch.float32]["jP"] - want).max() / scale
    assert port <= jax32


def test_float32_logl_at_example_state(state):
    """The float32 logL lies within 0.01 of the float64 one (measured
    0.0014 below it; 0.216 below before the squarings went per matrix)."""
    l64 = _logl(state[torch.float64])
    l32 = _logl(state[torch.float32])
    assert abs(l32 - l64) <= 0.01, (l32, l64)
