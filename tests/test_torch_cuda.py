"""The Hopper kernels (H1-H3) against their plain PyTorch versions on a card,
also at the partitioned path's and the mixtures' shapes (C = 80, 240 and
LG4X's four eigensystems), the model families' (61-state codon
models, +E tips, 2 and 7 states) and the nonreversible and per-class
ones (UNREST and 12.12 with complex eigenvalues, PoMo's 52 states, +H's
per-class lengths, the root test's __ROOT__ leaf), the wide instance past
64 states (PoMo at 76, 112, 136 and 454, a 65-state --mdef datatype), and the
search path on
the card (fused
NNI round, NNI hill-climb, joint fit), the partition engine, a mixture's
search, the PMSF engine, the codon and partitioned-mixture fits, and the
nonreversible Newton, NNI scoring, per-class fit and root test against
the CPU's plain versions.

This file imports nothing of JAX and nothing of the JAX package, so it runs
on the machine with the card, which has no jax; the repository's
tests/conftest.py imports jax, so run it there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every test skips. Inputs are simulated problems; the
comparison and its tolerances are iqtree2_tpu_torch/kernelcheck.py's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from iqtree2_tpu_torch import kernelcheck
from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model import torchfit
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.rates import RateGamma
from iqtree2_tpu_torch.model.subst import GTRModel
from iqtree2_tpu_torch.ops import kernels, pruning
from iqtree2_tpu_torch.ops.nni import build_nni_candidates
from iqtree2_tpu_torch.search.nni import nni_optimize
from iqtree2_tpu_torch.search.perturb import random_nnis
from iqtree2_tpu_torch.tree.schedule import build_schedule
from iqtree2_tpu_torch.tree.topology import Tree


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model_name", ["GTR+G4", "LG+G4", "HKY+I",
                                        "GTR+G8", "JC", "GTR+I+R3",
                                        "GTR+R10", "LG+I", "LG+F+R10",
                                        "LG+C20+G4", "LG4X",
                                        "MIX{LG,WAG}+G4", "GY+F3X4+G4",
                                        "KOSI07+G4", "HKY+E+G4", "JC2+G4",
                                        "MK7+G4"])
def test_kernels_match_plain(cuda, model_name, dtype):
    aln, tree, model, rates = kernelcheck.simulate(model_name, 24, 700,
                                                   seed=2)
    eng = LikelihoodEngine(aln, model, rates, dtype=dtype, device=cuda)
    before = dict(kernels.LAUNCHES)
    res = kernelcheck.check(eng, tree)
    assert [r["name"] for r in res] == ["down_pass", "up_pass", "theta_pass"]
    for r in res:
        assert r["ok"], r
    assert all(kernels.LAUNCHES[k] > before[k] for k in before)


def _shaped_newick(names, shape: str, rng) -> str:
    """A caterpillar (one internal node per level step, L - 2 steps) or a
    balanced tree (a wide first step) over ``names``, leaf 0 beside the
    schedule's root, random branch lengths."""
    def bl():
        return f":{rng.uniform(0.01, 0.3):.4f}"

    if shape == "caterpillar":
        sub = f"({names[-2]}{bl()},{names[-1]}{bl()})"
        for n in reversed(names[2:-2]):
            sub = f"({n}{bl()},{sub}{bl()})"
        return f"({names[0]}{bl()},{names[1]}{bl()},{sub}{bl()});"

    def balanced(ns):
        if len(ns) == 1:
            return ns[0]
        h = len(ns) // 2
        return f"({balanced(ns[:h])}{bl()},{balanced(ns[h:])}{bl()})"

    h = 1 + (len(names) - 1) // 2
    return (f"({names[0]}{bl()},{balanced(names[1:h])}{bl()},"
            f"{balanced(names[h:])}{bl()});")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model_name", ["GTR+G4", "LG+G4"])
@pytest.mark.parametrize("shape", ["caterpillar", "balanced"])
def test_pass_kernels_on_tree_shapes(cuda, shape, model_name, dtype):
    """The whole-pass kernels on the deepest schedule (a caterpillar: one
    node per step) and on the widest first step (a balanced tree)."""
    aln, _, model, rates = kernelcheck.simulate(model_name, 64, 700, seed=7)
    tree = Tree.from_newick(
        _shaped_newick(aln.names, shape, np.random.default_rng(7)),
        aln.names)
    steps = build_schedule(tree).step_node
    busy = (steps < tree.ntaxa - 2).sum(1)
    if shape == "caterpillar":
        assert (busy[busy > 0] == 1).all() and (busy > 0).sum() == 62
    else:
        assert busy[0] == 31
    eng = LikelihoodEngine(aln, model, rates, dtype=dtype, device=cuda)
    for r in kernelcheck.check(eng, tree):
        assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_codon(cuda, dtype):
    """S = 61 runs through the widest register column (S <= 64): a
    61-state GTR with random exchangeabilities on a codon alignment."""
    rng = np.random.default_rng(3)
    names = [f"t{i}" for i in range(12)]
    codons = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
              if a + b + c not in ("TAA", "TAG", "TGA")]
    aln = Alignment.from_sequences(
        names, ["".join(rng.choice(codons, 200)) for _ in names],
        seqtype="CODON")
    assert aln.num_states == 61
    model = GTRModel(61, exch_rates=rng.uniform(0.2, 3.0, 61 * 60 // 2),
                     freq_type="equal", fixed_rates=True)
    eng = LikelihoodEngine(aln, model, RateGamma(4, alpha=0.6), dtype=dtype,
                           device=cuda)
    for r in kernelcheck.check(eng, Tree.random_topology(names, rng)):
        assert r["ok"], r


@pytest.mark.cuda
def test_engine_on_cuda_matches_cpu(cuda):
    aln, tree, model, rates = kernelcheck.simulate("GTR+G4", 20, 500, seed=4)
    out = []
    for dev in ("cpu", cuda):
        eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                               device=dev)
        t = Tree.from_newick(tree.to_newick(), aln.names)
        out.append((eng.loglik_tree(t), eng.optimize_branches(t)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-12)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model_name", ["GTR+G4", "LG+G4"])
def test_theta_and_sitelp_on_cuda_match_cpu(cuda, model_name, dtype):
    """The Newton round's theta_pass and a log-likelihood's epilogue on the
    card against the CPU's plain versions (edge_thetas of both passes, the
    plain site log-likelihoods), one launch each."""
    aln, tree, model, rates = kernelcheck.simulate(model_name, 30, 600,
                                                   seed=9)
    tol = kernelcheck.TOLERANCE[dtype]
    out = []
    for dev in ("cpu", cuda):
        eng = LikelihoodEngine(aln, model, rates, dtype=dtype, device=dev)
        pb = kernelcheck.Problem(eng, tree)
        sa = eng.schedule_arrays(pb.sched)
        before = dict(kernels.LAUNCHES)
        dp = pruning.down_pass(pb.P, pb.tipP, sa, pack=pb.pack, tips=False)
        th = pruning.theta_pass(pb.P, dp, pb.tipP, sa, pb.pack)
        if dev == "cpu":
            rdp, rup = pruning.both_passes(pb.P, pb.tipP, sa, pb.pack)
            ref = pruning.edge_thetas(rup, rdp, sa["edge_src"], pb.pack)
            assert kernelcheck.col_rel(th.theta, ref.theta) <= tol["partials"]
            assert torch.equal(th.scale, ref.scale)
        else:
            assert {k: kernels.LAUNCHES[k] - before[k] for k in before} == {
                "down_pass": 1, "sitelp": 1, "up_pass": 0, "theta_pass": 1}
        out.append((dp.lp.cpu(), th.theta.cpu(), th.scale.cpu()))
    (lp_c, th_c, sc_c), (lp_g, th_g, sc_g) = out
    assert kernelcheck.lp_error(lp_g, lp_c, dtype) <= tol["lp"]
    assert kernelcheck.col_rel(th_g, th_c) <= tol["partials"]
    assert torch.equal(sc_g, sc_c)


@pytest.mark.cuda
def test_occupancy_of_the_dna_passes(cuda):
    """Every float32 DNA pass instance, the theta pass's 55.5 KB blocks
    included, keeps 4 blocks per SM (one wave at 16384 patterns)."""
    for kind in kernels.PASS_KINDS:
        blocks, shm = kernels.pass_occupancy(kind, torch.float32, 4, 4, 16384)
        assert blocks >= 4, (kind, blocks, shm)


@pytest.mark.cuda
def test_wrapper_refuses_bad_operands(cuda):
    aln, tree, model, rates = kernelcheck.simulate("GTR+G4", 6, 100, seed=1)
    eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                           device=cuda)
    pb = kernelcheck.Problem(eng, tree)
    dp = pb.down_buffers()
    lp = pb.lp_buffer()
    with pytest.raises(ValueError, match="operand 6 .* on cpu"):
        pb.down(kernels.down_pass, dp, pb.sitelp(lp.cpu()))
    with pytest.raises(ValueError, match="operand 3 .*float64"):
        pb.down(kernels.down_pass, dp, (pb.pack["root_freqs"].double(),)
                + pb.sitelp(lp)[1:])
    with pytest.raises(ValueError, match="must hold"):
        pb.down(kernels.down_pass, dp, pb.sitelp(lp[:-1]))
    pb.down(kernels.down_pass, dp, pb.sitelp(lp))
    t = pb.theta_buffers()
    with pytest.raises(ValueError, match="operand 5 .*float64"):
        kernels.theta_pass(pb.P, pb.tipP, dp.all, dp.scale, *t, pb.cs, pb.ce,
                           pb.steps, pb.U.double(), pb.V,
                           pb.pack["root_freqs"])
    pb.theta(kernels.theta_pass, dp, t)
    torch.cuda.synchronize()
    assert torch.isfinite(lp).all() and torch.isfinite(t.theta).all()


def _cpu_and_cuda(cuda, model_name="GTR+G4", ntaxa=20, nsites=500, seed=5):
    aln, tree, model, rates = kernelcheck.simulate(model_name, ntaxa, nsites,
                                                   seed)
    random_nnis(tree, np.random.default_rng(seed), 0.3)
    return tree, [LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                                   device=dev) for dev in ("cpu", cuda)]


@pytest.mark.cuda
@pytest.mark.parametrize("model_name", ["GTR+G4", "LG+G4"])
def test_fused_nni_round_on_cuda_matches_cpu(cuda, model_name):
    tree, engs = _cpu_and_cuda(cuda, model_name)
    out = []
    for eng in engs:
        t = tree.copy()
        sched = build_schedule(t)
        cand = build_nni_candidates(t, sched)
        ca = np.stack([cand.iu, cand.iv, cand.slot_c, cand.edge_id])
        before = dict(kernels.LAUNCHES)
        res = eng.optimize_and_evaluate_nnis(t, sched, ca, n_rounds=2,
                                             nni5=True, want_lp=True)
        if eng.device.type == "cuda":
            assert all(kernels.LAUNCHES[k] > before[k] for k in before)
        out.append((res, sched.blens.copy()))
    (cres, cbl), (gres, gbl) = out
    assert gres[0] == pytest.approx(cres[0], rel=1e-10)
    np.testing.assert_allclose(gbl, cbl, rtol=1e-8, atol=1e-12)
    for g, c in zip(gres[1:], cres[1:]):     # logl, t_e, t5, site lp
        np.testing.assert_allclose(g, c, rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
def test_nni_optimize_on_cuda_matches_cpu(cuda):
    tree, engs = _cpu_and_cuda(cuda, ntaxa=24, seed=6)
    out = []
    for eng in engs:
        t = tree.copy()
        res, lp = nni_optimize(eng, t, want_lp=True)
        out.append((t.topology_id(), res.logL, lp))
    assert out[1][0] == out[0][0]
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-10)
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=1e-8)


@pytest.mark.cuda
def test_testonly_on_cuda_matches_cpu(cuda, tmp_path):
    """A tiny ModelFinder run (-m TESTONLY) on the card and on the CPU:
    the same candidates, winner and degrees of freedom, logLs within 0.05
    (float32 fits of 8 and 25 L-BFGS iterations)."""
    from iqtree2_tpu_torch.modelfinder import run_modelfinder
    from iqtree2_tpu_torch.params import Params
    aln, _, _, _ = kernelcheck.simulate("GTR+G4", 10, 300, seed=3)
    params = Params(model="TESTONLY", mset="JC,HKY,GTR", mrate="E,G")
    out = [run_modelfinder(aln, params, log=lambda s: None, device=dev)
           for dev in ("cpu", cuda)]
    assert out[1]["best"] == out[0]["best"]
    for tbl in (out[0]["table"], out[1]["table"]):
        tbl.sort(key=lambda e: e["name"])
    assert [(e["name"], e["df"]) for e in out[1]["table"]] == \
        [(e["name"], e["df"]) for e in out[0]["table"]]
    for g, c in zip(out[1]["table"], out[0]["table"]):
        assert g["logL"] == pytest.approx(c["logL"], abs=0.05), g["name"]


@pytest.mark.cuda
def test_joint_fit_on_cuda_matches_cpu(cuda):
    aln, tree, _, _ = kernelcheck.simulate("GTR+G4", 12, 400, seed=8)
    out = []
    for dev in ("cpu", cuda):
        model, rates, _ = build_model("GTR+G", aln)
        eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                               device=dev)
        t = tree.copy()
        out.append((torchfit.try_fit(eng, t, epsilon=0.01), rates.alpha))
    assert out[1][0] == pytest.approx(out[0][0], abs=1e-3)
    assert out[1][1] == pytest.approx(out[0][1], rel=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("model_name", ["GTR+G4", "LG+G4"])
def test_supports_and_site_outputs_on_cuda_match_cpu(cuda, model_name):
    """Marginal ASR, the rate-category posteriors, the branch tests (NNI1
    scores with site logLs, SH-aLRT and aBayes) and the per-site ML rates
    at 64 x 4096 in float64 on the card against the CPU's plain passes,
    with the launches each asks for: ASR a down and an up pass, the
    posteriors a down pass, the branch tests a down and an up pass,
    --mlrate 33 log-likelihoods."""
    from iqtree2_tpu_torch import siterates, tests_branch
    aln, tree, model, rates = kernelcheck.simulate(model_name, 64, 4096,
                                                   seed=3)
    want = {"asr": (1, 0, 1), "rates": (1, 0, 0), "branches": (1, 0, 1),
            "mlrate": (33, 33, 0)}
    out = []
    for dev in ("cpu", cuda):
        eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                               device=dev)
        res, used = {}, {}
        for key, call in (
                ("asr", lambda: eng.ancestral_posteriors(tree)[0]),
                ("rates", lambda: eng.site_rate_posterior(tree)),
                ("branches", lambda: tests_branch.test_all_branches(
                    eng, tree, rng=np.random.default_rng(1),
                    do_abayes=True)),
                ("mlrate", lambda: siterates.site_rates_ml(eng, tree))):
            before = dict(kernels.LAUNCHES)
            res[key] = call()
            used[key] = tuple(kernels.LAUNCHES[k] - before[k]
                              for k in ("down_pass", "sitelp", "up_pass"))
        if dev != "cpu":
            assert used == want
        out.append(res)
    cpu, gpu = out
    np.testing.assert_allclose(gpu["asr"], cpu["asr"], rtol=1e-8,
                               atol=1e-12)
    assert np.abs(gpu["asr"].sum(1) - 1.0).max() < 1e-12
    for g, c in zip(gpu["rates"] + gpu["mlrate"], cpu["rates"]
                    + cpu["mlrate"]):
        np.testing.assert_allclose(g, c, rtol=1e-8, atol=1e-12)
    assert gpu["branches"].keys() == cpu["branches"].keys()
    for k, (sh, ab) in gpu["branches"].items():
        assert sh == cpu["branches"][k][0]
        assert ab == pytest.approx(cpu["branches"][k][1], abs=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(kernelcheck.PARTITIONS))
def test_kernels_match_plain_on_partitions(cuda, name, dtype):
    """The partitioned path's shapes (kernelcheck.PARTITIONS: a partition
    under 512 patterns, one lacking a quarter of the taxa, protein beside
    DNA): every partition engine's kernels against their plain versions."""
    from iqtree2_tpu_torch.partition.engine import PartitionEngine
    sa, tree, models, rates = kernelcheck.simulate_partitioned(name, 24,
                                                               seed=2)
    peng = PartitionEngine(sa, models, rates, dtype=dtype, device=cuda)
    for eng in peng.engines:
        before = dict(kernels.LAUNCHES)
        for r in kernelcheck.check(eng, tree):
            assert r["ok"], (name, r)
        assert all(kernels.LAUNCHES[k] > before[k] for k in before)


@pytest.mark.cuda
@pytest.mark.parametrize("nni5", [False, True])
def test_partition_engine_on_cuda_matches_cpu(cuda, nni5):
    """A PartitionEngine over DNA and protein partitions, one lacking taxa
    (edge-proportional, float64): the joint branch-length Newton, the
    partition rates and the NNI scores on the card against the CPU's plain
    versions, one down_pass and one theta_pass launch per partition per
    Newton round."""
    from iqtree2_tpu_torch.partition.engine import PartitionEngine
    M = kernelcheck.MODELS
    sa, tree, models, rates = kernelcheck.simulate_loci(
        [("DNA", M["GTR+G4"][2], 300, 0.0, 1.0),
         ("AA", M["LG+G4"][2], 150, 0.2, 1.0)], 20, seed=4)
    out = []
    for dev in ("cpu", cuda):
        peng = PartitionEngine(sa, models, rates, dtype=torch.float64,
                               device=dev)
        peng.part_rates[:] = (0.7, 1.6)
        t = tree.copy()
        before = dict(kernels.LAUNCHES)
        logl = peng.optimize_branches(t, n_rounds=3)
        if dev != "cpu":
            used = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            assert used["theta_pass"] == 3 * 2 and used["up_pass"] == 0
        logl_r = peng.optimize_part_rates(t)
        sched = build_schedule(t)
        c = build_nni_candidates(t, sched)
        ca = np.stack([c.iu, c.iv, c.slot_c, c.edge_id])
        scores = peng.evaluate_nni_batch(
            sched, ca, **(dict(nni5=True) if nni5
                          else dict(return_site_lp=True)))
        out.append((logl, logl_r, peng.part_rates.copy(), scores))
    (cl, cr, crates, cs), (gl, gr, grates, gs) = out
    assert gl == pytest.approx(cl, rel=1e-10)
    assert gr == pytest.approx(cr, rel=1e-10)
    np.testing.assert_allclose(grates, crates, rtol=1e-8)
    for g, c in zip(gs, cs):
        np.testing.assert_allclose(g, c, rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
def test_partitioned_fit_through_the_cli_on_cuda(cuda, tmp_path):
    """-p example.nex -m GTR+G -te ref_tree.nwk --f64 on the card: the JAX
    package's logL on the CPU within 0.01, with every partition's passes
    on the kernels."""
    from pathlib import Path
    from iqtree2_tpu_torch import cli
    golden = Path(__file__).parent / "golden"
    kernels.reset_launch_counts()
    assert cli.main(["-s", str(golden / "example.phy"), "-p",
                     str(golden / "example.nex"), "-m", "GTR+G", "-te",
                     str(golden / "ref_tree.nwk"), "--f64", "--device",
                     "cuda", "-pre", str(tmp_path / "p"), "--quiet"]) == 0
    text = (tmp_path / "p.iqtree").read_text()
    logl = float(text.split("Log-likelihood of the tree:")[1].split()[0])
    assert logl == pytest.approx(-21784.3628, abs=0.01)
    assert kernels.LAUNCHES["sitelp"] > 0 and \
        kernels.LAUNCHES["theta_pass"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("flags,outputs", [
    (["-g", "constraint.nwk"], [".treefile"]),
    (["-b", "2"], [".boottrees", ".treefile", ".contree"]),
    (["--runs", "2"], [".run1.treefile", ".run2.treefile"]),
    (["--symtest"], [".symtest.csv", ".treefile"])])
def test_single_alignment_flags_on_cuda_match_cpu(cuda, tmp_path, flags,
                                                  outputs):
    """-g, -b, --runs and --symtest through the CLI in float64 on the card
    and on the CPU at small search settings: the same trees (topologies
    and support labels, line by line) and the same symmetry tests."""
    import re
    from pathlib import Path
    from iqtree2_tpu_torch import cli
    from iqtree2_tpu_torch.io.alignment_io import read_alignment
    golden = Path(__file__).parent / "golden"
    (tmp_path / "constraint.nwk").write_text("((Frog,Human),(Turtle,Mouse));")
    flags = [str(tmp_path / f) if f.endswith(".nwk") else f for f in flags]
    names = read_alignment(str(golden / "example.phy")).names

    def lines(path):
        text = path.read_text()
        if path.suffix == ".csv":
            return text.splitlines()
        return [(Tree.from_newick(ln, names).topology_id(),
                 re.findall(r"\)([^:,();]+)", ln))
                for ln in text.splitlines()]

    out = []
    for dev in ("cpu", "cuda"):
        assert cli.main(["-s", str(golden / "example.phy"), "-m", "GTR+G",
                         "--f64", "-n", "1", "-ninit", "5", "-ntop", "2",
                         "-nbest", "2"] + flags + [
                             "--device", dev, "-pre", str(tmp_path / dev),
                             "--quiet"]) == 0
        out.append([lines(Path(f"{tmp_path / dev}{ext}"))
                    for ext in outputs])
    assert out[1] == out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_at_240_categories(cuda, dtype):
    """LG+C60+G4 (C = 240, one eigensystem per class), the plain
    references window by window."""
    aln, tree, model, rates = kernelcheck.simulate("LG+C60+G4", 16, 600,
                                                   seed=3)
    eng = LikelihoodEngine(aln, model, rates, dtype=dtype, device=cuda)
    for r in kernelcheck.check(eng, tree, window=128):
        assert r["ok"], r


@pytest.mark.cuda
def test_mixture_search_on_cuda_matches_cpu(cuda, tmp_path):
    """-m LG+C10+G with a short search and -wspm in float64 on the card
    and on the CPU: the same tree, logL (1e-6) and class posteriors."""
    from pathlib import Path
    from iqtree2_tpu_torch import cli
    aln, tree, _, _ = kernelcheck.simulate("LG+C20+G4", 8, 200, seed=4)
    phy, _ = kernelcheck.write_problem(aln, tree, tmp_path / "p")
    out = []
    for dev in ("cpu", "cuda"):
        pre = tmp_path / dev
        assert cli.main(["-s", phy, "-m", "LG+C10+G", "-wspm", "--f64",
                         "-n", "1", "-ninit", "5", "-ntop", "2", "-nbest",
                         "1", "--device", dev, "-pre", str(pre),
                         "--quiet"]) == 0
        text = Path(f"{pre}.iqtree").read_text()
        out.append((float(text.split("Log-likelihood of the tree:")[1]
                          .split()[0]),
                    Tree.from_newick(Path(f"{pre}.treefile").read_text(),
                                     aln.names).topology_id(),
                    np.loadtxt(f"{pre}.siteprob", skiprows=1)))
    assert out[1][0] == pytest.approx(out[0][0], abs=1e-6)
    assert out[1][1] == out[0][1]
    np.testing.assert_allclose(out[1][2], out[0][2], atol=2e-5)


@pytest.mark.cuda
def test_ssf_engine_on_cuda_matches_cpu(cuda):
    """The PMSF site-specific-frequency engine (plain PyTorch) on the card
    against the CPU in float64: logL, NNI1 scores, the branch lengths'
    fit, and run_pmsf from the same mixture fit."""
    from iqtree2_tpu_torch.model import pmsf
    aln, tree, _, _ = kernelcheck.simulate("LG+C20+G4", 10, 300, seed=5)
    model, rates, _ = build_model("LG+C10+G4", aln)
    sched = build_schedule(tree)
    c = build_nni_candidates(tree, sched)
    ca = np.stack([c.iu, c.iv, c.slot_c, c.edge_id])
    out = []
    for dev in ("cpu", cuda):
        eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                               device=dev)
        t = Tree.from_newick(tree.to_newick(), aln.names)
        ssf_eng, t2, logl, prof = pmsf.run_pmsf(aln, eng, t,
                                                log=lambda m: None)
        out.append((logl, prof, ssf_eng.loglik_tree(t),
                    ssf_eng.evaluate_nni_batch(sched, ca)))
    (l0, p0, s0, n0), (l1, p1, s1, n1) = out
    np.testing.assert_allclose(p1, p0, rtol=0, atol=1e-12)
    assert s1 == pytest.approx(s0, rel=1e-12)
    assert l1 == pytest.approx(l0, rel=1e-10)
    for a, b in zip(n1, n0):
        np.testing.assert_allclose(a, b, rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["codon", "partitioned mixture"])
def test_model_family_fits_on_cuda_match_cpu(cuda, tmp_path, family):
    """-st CODON -m GY+F3X4+G -te and a -q supermatrix of an LG+C10+G
    protein locus beside a GTR+G DNA locus -te, in float64 through the
    CLI on the card and on the CPU: logLs within 1e-3, the card's passes
    on the kernels."""
    from pathlib import Path
    from iqtree2_tpu_torch import cli
    if family == "codon":
        aln, tree, _, _ = kernelcheck.simulate("GY+F3X4+G4", 10, 150, seed=3)
        phy, nwk = kernelcheck.write_problem(aln, tree, tmp_path / "cds")
        args = ["-s", phy, "-st", "CODON", "-m", "GY+F3X4+G", "-te", nwk]
    else:
        sa, tree, _, _ = kernelcheck.simulate_loci(
            [("AA", "LG+C10+G{0.6}", 120, 0.0, 1.0),
             ("DNA", kernelcheck.MODELS["GTR+G4"][2], 200, 0.0, 1.0)],
            10, seed=3)
        args = ["-q", kernelcheck.write_partitioned(
            sa, ["LG+C10+G", "GTR+G"], tmp_path), "-m", "GTR+G", "-te",
            str(tmp_path / "true.nwk")]
        (tmp_path / "true.nwk").write_text(tree.to_newick() + "\n")
    logl = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        assert cli.main(args + ["--f64", "--device", dev, "-pre",
                                str(tmp_path / dev), "--quiet"]) == 0
        text = Path(f"{tmp_path / dev}.iqtree").read_text()
        logl[dev] = float(text.split("Log-likelihood of the tree:")[1]
                          .split()[0])
    assert logl["cuda"] == pytest.approx(logl["cpu"], abs=1e-3)
    assert kernels.LAUNCHES["sitelp"] > 0 and \
        kernels.LAUNCHES["theta_pass"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["UNREST+G4", "12.12+G4", "GTR+P+G4",
                                  "GTR+H4", "UNREST+G4 rooted"])
def test_kernels_match_plain_nonrev_families(cuda, name, dtype):
    """The kernels at the nonreversible and per-class shapes: a P without
    detailed balance and the stationary vector of a nonreversible Q as
    the root's frequencies, 52 states on k/N tips, per-(edge, class) P,
    and an all-unknown leaf 0 on a zero-length edge."""
    model_name = name.removesuffix(" rooted")
    aln, tree, model, rates = kernelcheck.simulate(model_name, 24, 700,
                                                   seed=2)
    if model_name != name:
        aln, tree = kernelcheck.rooted_problem(aln, tree)
    eng = kernelcheck.make_engine(aln, model, rates, dtype=dtype,
                                  device=cuda)
    res = kernelcheck.check(eng, tree)
    for r in res:
        assert r["ok"], r
        assert r["launches"] == 1, r
    assert res[0]["sitelp_launches"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,gamma", [
    ("GTR+P13+G4", "+G{0.6}"), ("GTR+P19+G4", "+G{0.6}"),
    ("GTR+P23+G4", "+G{0.6}"), ("MK65+G4", "+G{0.6}"),
    ("GTR+P13+G4", ""), ("GTR+P19+G4", "+G10{0.6}"),
    ("GTR+P76+G4", "+G{0.6}")],
    ids=["S76", "S112", "S136", "S65", "S76-C1", "S112-C10", "S454"])
def test_kernels_match_plain_wide(cuda, name, gamma, dtype):
    """The kernels' wide instance (S > 64, a node's states split across
    the block): PoMo at 76, 112 and 136 states on k/N tips, a 65-state
    --mdef datatype under a reversible model, one category (theta_pass
    stages U and V) and ten (in float64 the output tile does not fit and
    the sweeps compute the products twice), and PoMo at 454 states, whose
    columns float64 cannot stage (the passes read them in place, theta_pass
    keeps E in its workspace); one launch per pass."""
    aln, tree, _, _ = kernelcheck.simulate(name, 24, 300, seed=2)
    model, rates, _ = build_model(
        kernelcheck.MODELS[name][2].replace("+G{0.6}", gamma), aln)
    eng = LikelihoodEngine(aln, model, rates, dtype=dtype, device=cuda)
    assert eng._tipP.shape[1] > 64
    res = kernelcheck.check(eng, tree)
    for r in res:
        assert r["ok"], r
        assert r["launches"] == 1, r
    assert res[0]["sitelp_launches"] == 1


@pytest.mark.cuda
def test_occupancy_of_the_wide_passes(cuda):
    """At 112 states and four categories every pass keeps its [C, S, 32]
    output tile in shared memory (float32 and float64) and fits a block
    on an SM. Where the staged columns do not fit (454 states in float64,
    1000 in float32) a block keeps only its reduction row, 8 warps x 32
    lanes, and still fits: no state count is refused."""
    for dtype in (torch.float32, torch.float64):
        f = torch.finfo(dtype).bits // 8
        tile = 4 * 112 * 32 * f
        for kind in kernels.PASS_KINDS:
            blocks, shm = kernels.pass_occupancy(kind, dtype, 4, 112, 16384)
            assert blocks >= 1 and shm > tile, (kind, dtype, blocks, shm)
            S = 454 if dtype == torch.float64 else 1000
            blocks, shm = kernels.pass_occupancy(kind, dtype, 4, S, 16384)
            assert blocks >= 1 and shm == 8 * 32 * f, (kind, dtype, S,
                                                       blocks, shm)


@pytest.mark.cuda
def test_nonrev_and_mixlen_on_cuda_match_cpu(cuda):
    """float64, the card against the CPU: the nonreversible Newton and its
    NNI5 scores with site logLs, the per-class (+H) fit with its EM
    weights, and the root test."""
    from iqtree2_tpu_torch import roottest
    from iqtree2_tpu_torch.model.heterotachy import MixlenEngine
    aln, tree, model, rates = kernelcheck.simulate("UNREST+G4", 12, 400,
                                                   seed=3)
    out = {}
    for dev in ("cpu", cuda):
        eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                               device=dev)
        t = Tree.from_newick(tree.to_newick(), aln.names)
        logl = eng.optimize_branches(t)
        sched = build_schedule(t)
        c = build_nni_candidates(t, sched)
        nni = eng.evaluate_nni_batch(
            sched, np.stack([c.iu, c.iv, c.slot_c, c.edge_id]), nni5=True,
            return_site_lp=True)
        h_model, h_rates, _ = build_model("GTR+H3", aln)
        heng = MixlenEngine(aln, h_model, h_rates, dtype=torch.float64,
                            device=dev)
        ht = Tree.from_newick(tree.to_newick(), aln.names)
        hl = heng.optimize_mixlen(ht, n_outer=2)
        rt = roottest.run_root_test(aln, tree, model, rates,
                                    dtype=torch.float64, device=dev,
                                    log=lambda m: None)
        out[str(dev)] = (logl, nni, hl, h_rates.weights.copy(), rt)
    (l0, n0, h0, w0, r0), (l1, n1, h1, w1, r1) = out.values()
    assert l1 == pytest.approx(l0, rel=1e-10)
    for a, b in zip(n1, n0):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)
    assert h1 == pytest.approx(h0, rel=1e-10)
    np.testing.assert_allclose(w1, w0, atol=1e-8)
    np.testing.assert_allclose(r1.logL, r0.logL, rtol=1e-10)
    assert r1.best == r0.best


@pytest.mark.cuda
def test_quartet_newton_on_cuda_matches_cpu(cuda):
    """Likelihood mapping's batched quartet Newton (plain torch on the
    engine's device), float64: the card's topology logLs within 1e-9 of
    the CPU's, the regions equal."""
    from iqtree2_tpu_torch.ops import quartet
    aln, _, model, rates = kernelcheck.simulate("GTR+G4", 12, 600, seed=3)
    out = []
    for dev in ("cpu", cuda):
        eng = LikelihoodEngine(aln, model, rates, dtype=torch.float64,
                               device=dev)
        out.append(quartet.likelihood_mapping(eng, 64,
                                              np.random.default_rng(2)))
    np.testing.assert_allclose(out[1]["logls"], out[0]["logls"], rtol=1e-9)
    np.testing.assert_array_equal(out[1]["regions"], out[0]["regions"])


@pytest.mark.cuda
def test_sankoff_on_cuda_matches_host(cuda):
    """The min-plus Sankoff pass on the card equals the host score under a
    unit and a transition/transversion cost matrix."""
    from iqtree2_tpu_torch.ops import pars
    aln, tree, _, _ = kernelcheck.simulate("GTR+G4", 40, 2000, seed=5)
    for cost in (1.0 - np.eye(4),
                 np.array([[0, 2, 1, 2], [2, 0, 2, 1], [1, 2, 0, 2],
                           [2, 1, 2, 0]], np.float64)):
        args = (aln.tip_codes(), aln.pattern_weights, cost,
                aln.seqtype.tip_table)
        assert pars.sankoff_score_device(tree, *args, device=cuda) == \
            pars.sankoff_score(tree, *args)


@pytest.mark.cuda
def test_dating_search_on_cuda_matches_cpu(cuda, tmp_path):
    """A 12-taxon search with --date and intervals, float64 through the
    CLI: the card's tree and logL as the CPU's, and its rate, root date
    and their intervals within 1e-4 (the searches' branch lengths agree to
    their Newton's tolerance, 6e-6 relative in the rate on an H100)."""
    from iqtree2_tpu_torch import cli
    aln, tree, _, _ = kernelcheck.simulate("GTR+G4", 12, 500, seed=3)
    phy, nwk = kernelcheck.write_problem(aln, tree, str(tmp_path / "p"))
    dates = tmp_path / "dates.txt"
    dates.write_text("".join(f"{n} {d}\n" for n, d in
                             kernelcheck.clock_dates(tree, 0.01).items()))
    out = {}
    for dev in ("cpu", "cuda"):
        pre = tmp_path / dev
        assert cli.main(["-s", phy, "-m", "GTR+G", "-n", "2", "-ninit", "5",
                         "-ntop", "2", "-nbest", "2", "--f64", "--date",
                         str(dates), "--date-ci", "20", "--device", dev,
                         "-pre", str(pre), "--quiet"]) == 0
        lsd = Path(f"{pre}.timetree.lsd").read_text().splitlines()
        # the rate and root date lines with their intervals
        report = Path(f"{pre}.iqtree").read_text()
        out[dev] = (Path(f"{pre}.treefile").read_text(),
                    [float(x) for x in re.findall(r"\d+\.?\d*(?:e-?\d+)?",
                                                  " ".join(lsd[1:3]))],
                    float(report.split("Log-likelihood of the tree:")[1]
                          .split()[0]))
    (tree_cpu, cpu, logl_cpu), (tree_card, card, logl_card) = out.values()
    assert Tree.from_newick(tree_card, aln.names).topology_id() == \
        Tree.from_newick(tree_cpu, aln.names).topology_id()
    assert logl_card == pytest.approx(logl_cpu, abs=1e-6)
    assert len(card) == len(cpu) == 6
    np.testing.assert_allclose(card, cpu, rtol=1e-4)


def _rank_problem(ntaxa: int, nsites: int):
    """(names, site matrix, Newick) of a random DNA problem."""
    from iqtree2_tpu_torch.data import seqtypes
    rng = np.random.default_rng(5)
    names = [f"t{i}" for i in range(ntaxa)]
    sites = seqtypes.DNA_STATE_TO_CODE[rng.integers(0, 4, (nsites, ntaxa))]
    return names, sites, Tree.random_topology(names, rng).to_newick(
        digits=17)


@pytest.mark.cuda
def test_sharded_on_cuda_matches_unsharded(cuda):
    """Two gloo ranks on the one card (parallel/shard.py, float64): the
    sharded logL, Newton step, RELL and NNI batch equal the unsharded
    engine's on the card within 1e-9 relative; the site lps of the slices
    joined are the engine's."""
    from tests.torch_ranks import (run_ranks, shard_outputs, shard_problem,
                                   shard_rank)
    model_str = kernelcheck.MODELS["GTR+G4"][2]
    names, sites, newick = _rank_problem(24, 1500)
    ranks = run_ranks(shard_rank, 2, names, sites, newick, model_str, False,
                      "cuda", timeout=300)
    eng, tree, sched = shard_problem(names, sites, newick, model_str, False,
                                     "cuda")
    want = shard_outputs(eng, tree, sched, 0, 1, None)
    for k in ("logL", "step_blens", "step_logL", "nni_logl", "nni_topt"):
        for r in ranks:
            np.testing.assert_allclose(r[k], want[k], rtol=1e-9,
                                       atol=1e-12, err_msg=k)
    lp = np.concatenate([r["lp"] for r in ranks])[:eng.Pp]
    np.testing.assert_allclose(lp, want["lp"], rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_at_a_rank_slice(cuda, dtype):
    """The kernels at the shapes of one of two ranks' slices (the
    patterns of rank 0's slice of a 64 x 4096 problem) against their
    plain versions."""
    from iqtree2_tpu_torch.parallel import shard
    aln, tree, model, rates = kernelcheck.simulate("GTR+G4", 64, 4096,
                                                   seed=3)
    Pp = LikelihoodEngine(aln, model, rates, dtype=dtype, device=cuda).Pp
    per = shard.rank_bounds(Pp, 0, 2)[1]
    sub = aln.subset_sites(np.nonzero(aln.site_to_pattern < per)[0])
    eng = LikelihoodEngine(sub, model, rates, dtype=dtype, device=cuda)
    assert eng.Pp == per
    for r in kernelcheck.check(eng, tree):
        assert r["ok"], r
