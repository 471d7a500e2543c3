"""Per-partition ModelFinder and partition merging (-m TESTONLY, MF+MERGE
with --merge greedy and kmeans) through the port's CLI against the JAX
package's partition_analysis, float64 on the CPU, on example.nex with a
small grid (-mset JC,HKY -mrate E,G): the same winners, the same merged
scheme (.best_scheme.nex) and per-partition logLs within 0.5, the bar
of tests/test_torch_modelfinder.py (ModelFinder screens in float32).
"""

from pathlib import Path

import pytest
import torch

from iqtree2_tpu import cli as jcli
from iqtree2_tpu import partition_analysis as jpa
from iqtree2_tpu_torch import cli, partition_analysis

GOLDEN = Path(__file__).parent / "golden"
ALN, NEX = str(GOLDEN / "example.phy"), str(GOLDEN / "example.nex")
GRID = ["-mset", "JC,HKY", "-mrate", "E,G", "--f64"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _selections(argv, d: Path, monkeypatch):
    """(port, JAX) results of the selection: their .best_scheme.nex texts
    and per-partition tables (the port's read from its function's
    return)."""
    port = {}
    real = partition_analysis.select_partition_models

    def keep(*a, **kw):
        port.update(real(*a, **kw))
        return port

    monkeypatch.setattr(partition_analysis, "select_partition_models", keep)
    assert cli.main(["-s", ALN, "-p", NEX] + argv + GRID + [
        "--device", "cpu", "-pre", str(d / "port"), "--quiet"]) == 0
    jres = jpa.run_partition_analysis(jcli.params_from_args(
        jcli.build_parser().parse_args(["-s", ALN, "-p", NEX] + argv + GRID
                                       + ["-pre", str(d / "jax"),
                                          "--quiet"])))
    return ((Path(f"{d}/port.best_scheme.nex").read_text(), port["table"]),
            (Path(f"{d}/jax.best_scheme.nex").read_text(), jres["table"]))


@pytest.mark.parametrize("argv", [["-m", "TESTONLY"],
                                  ["-m", "MF+MERGE"],
                                  ["-m", "MF+MERGE", "--merge", "kmeans"]],
                         ids=["testonly", "greedy", "kmeans"])
def test_selection_and_merging_match_jax(argv, tmp_path, monkeypatch):
    (scheme, table), (jscheme, jtable) = _selections(argv, tmp_path,
                                                     monkeypatch)
    assert scheme == jscheme
    assert [(r["partition"], r["name"], r["df"]) for r in table] == \
        [(r["partition"], r["name"], r["df"]) for r in jtable]
    for r, jr in zip(table, jtable):
        assert r["logL"] == pytest.approx(jr["logL"], abs=0.5)
