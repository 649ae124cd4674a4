"""The harness finds every cell's configuration, mix, system, reference
and metric by the name BENCHMARK.json gives it, and the file keeps to the
contract's shapes."""

import json
import re

import pytest

from conftest import ROOT
from portbench import bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    _, w, config, mix, sysmod = bench.load_cell(cell)
    assert (ROOT / "portbench" / "reference" /
            f"{config['system']}.py").exists()
    assert set(config["limits"]) == set(sysmod.NUMBERS)
    assert all(isinstance(v, float) and v > 0
               for v in config["limits"].values())
    assert w["chips"] == 1
    e2e = {m["name"] for m in bench.metrics_for(SPEC, cell, False)}
    assert {"setup_s", "solve_s"} <= e2e
    assert bench.metrics_for(SPEC, cell, True)


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(name):
    assert callable(bench.metric_reader(name).read)


def test_metrics_filter_by_their_cells():
    p90 = next(m for m in SPEC["end_to_end"] if m["name"] == "solve_s_p90")
    for w in SPEC["workloads"]:
        got = {m["name"] for m in bench.metrics_for(SPEC, w["name"], False)}
        assert ("solve_s_p90" in got) == (w["name"] in p90["workloads"])


def test_names_units_and_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + [
        w["name"] for w in SPEC["workloads"]] + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in e2e and m["layer"] for m in SPEC["per_layer"])
    for c in SPEC["configs"]:
        keys = json.loads((ROOT / c["file"]).read_text()).keys()
        assert isinstance(c["reduced"], list)
        assert all(isinstance(k, str) and k in keys for k in c["reduced"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
