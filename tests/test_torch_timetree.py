"""The port's least-squares dating (--date, timetree.py) against the JAX
package's, float64 on the CPU.

On fixed trees, the port's analysis.date_final_tree and the JAX package's
dating block (iqtree2_tpu/analysis.py:505-552, its calls made here in its
order) write .timetree.nwk, .nex and .lsd whose numbers agree within
1e-9: midpoint rooting, an outgroup (-o) with and without its tips in the
fit (--date-no-outgroup), a fixed rate and root date, dates in the taxon
names (TAXNAME) and the branch-resampling intervals (--date-ci,
--clock-sd). The port counts the replicates whose dating fails and
reports them; the JAX function drops them silently (ROADMAP C5). A port
command line dates its final tree as its functions date its .treefile.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from iqtree2_tpu import timetree as jtimetree
from iqtree2_tpu.tree.topology import Tree as JTree
from iqtree2_tpu_torch import analysis, cli, kernelcheck, timetree
from iqtree2_tpu_torch.params import Params
from iqtree2_tpu_torch.tree.topology import Tree

torch.set_num_threads(1)

NTAXA, NSITES = 12, 500
NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _problem(taxname: bool = False):
    """(Newick with 17 digits, taxon names, {name: date}) of a simulated
    12-taxon tree, the dates a strict clock's at rate 0.01 with noise;
    with taxname the dates are the names' '|' suffixes."""
    _, tree, _, _ = kernelcheck.simulate("GTR+G4", NTAXA, 60, seed=3)
    rng = np.random.default_rng(5)
    dates = {n: round(d + rng.normal(0.0, 1.5), 1)
             for n, d in kernelcheck.clock_dates(tree, 0.01).items()}
    nwk = tree.to_newick(digits=17)
    if taxname:
        for n, d in dates.items():
            nwk = re.sub(rf"\b{n}:", f"{n}|{d:g}:", nwk)
    names = Tree.from_newick(nwk).taxon_names
    return nwk, names, dates


def _cherry(tree: Tree) -> list:
    """Two leaves with a common neighbour: a monophyletic outgroup."""
    for v in range(tree.ntaxa, len(tree.adj)):
        leaves = [u for u in tree.adj[v] if tree.is_leaf(u)]
        if len(leaves) >= 2:
            return [tree.taxon_names[u] for u in leaves[:2]]
    raise AssertionError("no cherry")


def _jax_dating(params: Params, jtree, names, nsites, prefix) -> dict:
    """The JAX package's --date block (analysis.py:505-552), its calls in
    its order, on the JAX tree."""
    if params.date_file == "TAXNAME":
        dates = jtimetree.dates_from_names(names)
    else:
        dates = jtimetree.parse_date_file(
            Path(params.date_file).read_text(), names)
    root_edge = None
    if params.outgroup:
        root_edge = jtimetree.outgroup_root_edge(
            jtree, params.outgroup.split(","), names)
        if params.date_no_outgroup:
            og = {names.index(n) for n in params.outgroup.split(",")}
            dates = {k: v for k, v in dates.items() if k not in og}
    fixed_rate = float(params.date_rate) if params.date_rate else None
    root_date = float(params.date_root) if params.date_root else None
    nd, rate, parent, tt, root = jtimetree.date_tree(
        jtree, dates, root_edge=root_edge, fixed_rate=fixed_rate,
        root_date=root_date)
    with open(f"{prefix}.timetree.nwk", "w") as f:
        f.write(jtimetree.timetree_newick(tt, nd, parent, root) + "\n")
    dci = rci = None
    if params.date_ci > 0:
        dci, rci = jtimetree.date_tree_ci(
            jtree, dates, seq_len=nsites, n_reps=params.date_ci,
            clock_sd=params.clock_sd, root_edge=root_edge,
            fixed_rate=fixed_rate, root_date=root_date, seed=params.seed)
    with open(f"{prefix}.timetree.nex", "w") as f:
        f.write(jtimetree.timetree_nexus(tt.copy(), nd, parent, root, names,
                                         ci=dci))
    jtimetree.write_lsd_report(f"{prefix}.timetree.lsd", nd, rate, root, tt,
                               names, rate_ci=rci, date_ci=dci,
                               n_reps=params.date_ci)
    return {"Clock rate (subst/site/time)": f"{rate:.6g}",
            "Root date": f"{nd[root]:.6g}"}


def _agree(port: str, jax: str, rel: float) -> None:
    """The same text around the numbers, the numbers within rel."""
    assert NUMBER.sub("#", port) == NUMBER.sub("#", jax)
    a = np.array([float(x) for x in NUMBER.findall(port)])
    b = np.array([float(x) for x in NUMBER.findall(jax)])
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel)


CASES = {
    "midpoint": {},
    "outgroup": {"outgroup": "cherry"},
    "no-outgroup": {"outgroup": "cherry", "date_no_outgroup": True},
    "rate": {"date_rate": "0.004"},
    "root-date": {"date_root": "1950"},
    "taxname": {"date_file": "TAXNAME"},
    "ci": {"date_ci": 25, "clock_sd": 0.1, "outgroup": "cherry"},
}


@pytest.mark.parametrize("case", list(CASES))
def test_dating_files_match_jax(tmp_path, case):
    nwk, names, dates = _problem(taxname=case == "taxname")
    tree, jtree = Tree.from_newick(nwk), JTree.from_newick(nwk)
    kw = dict(CASES[case])
    if kw.get("outgroup") == "cherry":
        kw["outgroup"] = ",".join(_cherry(tree))
    if "date_file" not in kw:
        kw["date_file"] = str(tmp_path / "dates.txt")
        Path(kw["date_file"]).write_text(
            f"{len(dates)}\n" + "".join(f"{n} {d}\n"
                                        for n, d in dates.items()))
    aln = types.SimpleNamespace(names=names, nsites=NSITES)
    port = Params(out_prefix=str(tmp_path / "port"), seed=4, **kw)
    info: dict = {}
    analysis.date_final_tree(port, tree, aln, info, lambda msg: None)
    jinfo = _jax_dating(Params(out_prefix=str(tmp_path / "jax"), seed=4,
                               **kw), jtree, names, NSITES,
                        tmp_path / "jax")
    for k, v in jinfo.items():
        assert float(info[k]) == pytest.approx(float(v), rel=1e-9)
    for ext in ("nwk", "nex", "lsd"):
        text = (tmp_path / f"port.timetree.{ext}").read_text()
        jtext = (tmp_path / f"jax.timetree.{ext}").read_text()
        if ext == "lsd" and kw.get("date_ci"):
            assert f"failed replicates: 0 of {kw['date_ci']}\n" in text
            assert info["Failed dating replicates"] == \
                f"0 of {kw['date_ci']}"
            text = text.replace(f"failed replicates: 0 of {kw['date_ci']}\n",
                                "")
        _agree(text, jtext, 1e-9)


def test_date_tree_and_intervals_match_jax():
    nwk, names, dates = _problem()
    tree, jtree = Tree.from_newick(nwk), JTree.from_newick(nwk)
    tips = {names.index(n): d for n, d in dates.items()}
    nd, rate, parent, _, root = timetree.date_tree(tree, tips)
    jnd, jrate, jparent, _, jroot = jtimetree.date_tree(jtree, tips)
    assert (parent, root) == (jparent, jroot) and nd.keys() == jnd.keys()
    np.testing.assert_allclose([nd[k] for k in nd], [jnd[k] for k in nd],
                               rtol=1e-9)
    assert rate == pytest.approx(jrate, rel=1e-9)
    ci, rci, failed = timetree.date_tree_ci(tree, tips, NSITES, n_reps=30,
                                            seed=9)
    jci, jrci = jtimetree.date_tree_ci(jtree, tips, NSITES, n_reps=30,
                                       seed=9)
    assert failed == 0 and ci.keys() == jci.keys()
    np.testing.assert_allclose(np.array([ci[k] for k in ci]),
                               np.array([jci[k] for k in ci]), rtol=1e-9)
    np.testing.assert_allclose(rci, jrci, rtol=1e-9)


def test_failed_replicates_are_counted(tmp_path, monkeypatch):
    """A date_tree that raises on one replicate: the intervals come from
    the others, and the count reaches the return value, the .lsd and the
    report's row (the JAX function drops the replicate silently, C5)."""
    nwk, names, dates = _problem()
    tree = Tree.from_newick(nwk)
    real = timetree.date_tree
    calls = []

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 4:      # the point estimate, then replicate 3
            raise np.linalg.LinAlgError("singular")
        return real(*args, **kw)
    monkeypatch.setattr(timetree, "date_tree", flaky)
    tips = {names.index(n): d for n, d in dates.items()}
    _, _, failed = timetree.date_tree_ci(tree, tips, NSITES, n_reps=10)
    assert failed == 1
    calls.clear()
    dfile = tmp_path / "dates.txt"
    dfile.write_text("".join(f"{n} {d}\n" for n, d in dates.items()))
    info: dict = {}
    params = Params(out_prefix=str(tmp_path / "p"), date_file=str(dfile),
                    date_ci=10)
    analysis.date_final_tree(params, tree,
                             types.SimpleNamespace(names=names, nsites=500),
                             info, lambda msg: None)
    assert "failed replicates: 1 of 10\n" in \
        (tmp_path / "p.timetree.lsd").read_text()
    assert info["Failed dating replicates"] == "1 of 10"


def test_cli_dates_its_treefile(tmp_path):
    """-te ... --date --date-ci --f64 on a 12-taxon, 500-site simulation:
    the port's .timetree files are what its functions give on its
    .treefile (the same rate, root date and time tree), and the report
    carries the rate."""
    aln, tree, _, _ = kernelcheck.simulate("GTR+G4", NTAXA, NSITES, seed=3)
    phy, nwk = kernelcheck.write_problem(aln, tree, str(tmp_path / "p"))
    dfile = tmp_path / "dates.txt"
    dfile.write_text("".join(f"{n} {d}\n" for n, d in
                             kernelcheck.clock_dates(tree, 0.01).items()))
    pre = tmp_path / "run"
    assert cli.main(["-s", phy, "-te", nwk, "-m", "GTR+G", "--f64", "--date",
                     str(dfile), "--date-ci", "20", "-o", aln.names[0],
                     "--device", "cpu", "-pre", str(pre), "--quiet"]) == 0
    final = Tree.from_newick((tmp_path / "run.treefile").read_text(),
                             aln.names)
    params = Params(out_prefix=str(tmp_path / "fn"), date_file=str(dfile),
                    date_ci=20, outgroup=aln.names[0])
    info: dict = {}
    analysis.date_final_tree(params, final, aln, info, lambda msg: None)
    for ext in ("lsd", "nex"):
        run = (tmp_path / f"run.timetree.{ext}").read_text()
        fn = (tmp_path / f"fn.timetree.{ext}").read_text()
        head = 3 if ext == "lsd" else 0
        if head:
            _agree("".join(run.splitlines(True)[:head]),
                   "".join(fn.splitlines(True)[:head]), 1e-6)
        assert run.count("date=") == fn.count("date=")
    spl = Tree.from_newick((tmp_path / "run.timetree.nwk").read_text(),
                           aln.names).splits()
    fspl = Tree.from_newick((tmp_path / "fn.timetree.nwk").read_text(),
                            aln.names).splits()
    assert spl.keys() == fspl.keys()
    rate = info["Clock rate (subst/site/time)"]
    assert f"Clock rate (subst/site/time): {rate}\n" in \
        (tmp_path / "run.iqtree").read_text()
    assert float(rate) == pytest.approx(0.01, rel=0.25)


@pytest.mark.parametrize("argv,message", [
    (["-te", "T", "-m", "GTR+G", "--date-ci", "10"],
     "--date-ci with no --date"),
    (["-te", "T", "-m", "GTR+G", "--date", "TAXNAME", "-q", "P"],
     "--date with -p/-q/-Q"),
    (["-m", "MF", "--date", "TAXNAME"], "--date: dates the analysis' tree"),
])
def test_date_refused_where_not_run(tmp_path, argv, message):
    """The dating flags stop before any work where the JAX package would
    ignore them: without --date, on partitions (its partition path never
    dates, ROADMAP C8) and with model selection alone."""
    with pytest.raises(SystemExit, match=message):
        cli.main(["-s", "A", "--device", "cpu", "-pre",
                  str(tmp_path / "x")] + argv)
    assert not list(tmp_path.iterdir())


def test_date_with_tree_mixture_refused(tmp_path):
    """+T's flow returns before the dating (as the JAX package's)."""
    aln, tree, _, _ = kernelcheck.simulate("GTR+G4", 5, 40, seed=1)
    phy, nwk = kernelcheck.write_problem(aln, tree, str(tmp_path / "p"))
    with pytest.raises(SystemExit, match="--date with -m GTR\\+G\\+T"):
        cli.main(["-s", phy, "-te", nwk, "-m", "GTR+G+T", "--date",
                  "TAXNAME", "--device", "cpu", "-pre", str(tmp_path / "x")])
