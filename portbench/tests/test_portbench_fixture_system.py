"""A cell whose input is not a point on the sphere, added with new files
alone: the fixture system ``systems/so3_fixture.py`` (a fresh SO(3)
synchronization instance each solve, solved by the port's TNT) runs through
``bench.measure`` and ``control.readings`` from a benchmark root that
differs from the repository's only by what a new cell adds: its
configuration, its mix and its entries in ``BENCHMARK.json``."""

import json
import math
import shutil
import time

import pytest
import torch

from conftest import ROOT, write_root
from portbench import bench, control
from portbench.systems import so3_fixture

CELL = "so3_fixture.n64"
CONFIG = {"system": "so3_fixture", "storage": "float32",
          "max_iterations": 50, "gradient_tolerance": 1e-5,
          # program 6.1e-6 / 3.0e-6 at most, control 3.3e-3 / 2.2e-3 at
          # least, over six seeds on the CPU
          "limits": {"rotations": 1e-4, "cost": 1e-4}}
ENTRY = {"name": "so3_fixture",
         "source": "https://github.com/david-m-rosen/SE-Sync",
         "file": "portbench/configs/so3_fixture.json", "reduced": [],
         "why": "SO(3) synchronization, a fresh instance each solve"}


@pytest.fixture
def fixture_root(tmp_path):
    """The repository's benchmark files, unchanged, with the fixture's
    configuration, mix and cell added."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic"):
        shutil.copytree(ROOT / "portbench" / sub, tmp_path / "portbench" / sub)
    spec["configs"].append(ENTRY)
    spec["workloads"].append({"name": CELL, "config": "so3_fixture",
                              "traffic": "so3_n64", "chips": 1,
                              "why": "64 rotations, 191 edges"})
    yield write_root(tmp_path, spec, {ENTRY["file"]: CONFIG},
                     {"so3_n64": so3_fixture.TEST_MIX})
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_root_only_adds(fixture_root):
    ours = json.loads((ROOT / "BENCHMARK.json").read_text())
    theirs = json.loads((fixture_root / "BENCHMARK.json").read_text())
    for key, value in ours.items():
        got = theirs[key]
        assert got[:len(value)] == value if isinstance(value, list) \
            else got == value
    for path in (ROOT / "portbench").glob("*/*.json"):
        copy = fixture_root / path.relative_to(ROOT)
        assert copy.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("fault,trace", [(None, False), (None, True),
                                         ("answer_altered", False)])
def test_fixture_cell_runs_and_is_judged(fault, trace, fixture_root,
                                         monkeypatch):
    from optimization_tpu_torch.solvers import tnt

    if fault:
        real = tnt.solve
        c, s = math.cos(0.01), math.sin(0.01)
        turn = torch.tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])

        def altered(*args, **kwargs):
            # one rotation of the answer turned by 0.01 rad where the
            # solver states it
            res = real(*args, **kwargs)
            x = res.x.clone()
            x[1] = x[1] @ turn.to(x.dtype)
            return res._replace(x=x)
        monkeypatch.setattr(tnt, "solve", altered)
    line, compared = bench.measure(CELL, 2 ** 31 + 77, 0.5, trace,
                                   t_process=time.perf_counter(),
                                   require_card=False, device="cpu",
                                   root=fixture_root)
    assert set(compared) == {"rotations", "cost"}
    assert line["correct"] is (fault is None), compared
    assert line["attempted"] >= 2 and line["failed"] == 0
    spec = json.loads((fixture_root / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench.metrics_for(spec, CELL, trace)}
    assert set(line["metrics"]) == listed
    if trace:
        # no per-layer metric of the repository lists the fixture's cell
        assert listed == set()
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    else:
        assert listed == {"solve_s", "setup_s"}
        assert "breakdown" not in line


def test_fixture_control_beyond_program_within(fixture_root):
    rows = control.readings(CELL, [3, 2 ** 33 + 1], "cpu", root=fixture_root)
    limits = CONFIG["limits"]
    for _, prog, ctl in rows:
        assert all(prog[k] <= limits[k] for k in limits), prog
        assert any(ctl[k] > limits[k] for k in limits), ctl
