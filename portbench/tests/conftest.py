"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's
configuration at a size a test run holds (n = 4096, six outer iterations,
two solves checked), driven through ``bench.measure`` on the CPU with the
kernel's plain version."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"n": 4096, "warmup_solves": 1, "check_solves": 2, "check_within": 2,
        "sync_solves": 1}
OUTER = 6


@pytest.fixture
def tiny_root(tmp_path):
    """A benchmark root whose cells run the real configurations (their
    limits too) at n = 4096 and 6 outer iterations."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench_dir = tmp_path / "portbench"
    (bench_dir / "traffic").mkdir(parents=True)
    (bench_dir / "configs").mkdir()
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["max_iterations"] = OUTER
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        w["traffic"] = "tiny"
    (bench_dir / "traffic" / "tiny.json").write_text(json.dumps(TINY))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def measure_cpu(tiny_root):
    """``measure(cell, seed)`` on the CPU: the harness with its look for a
    card skipped, the kernel's plain version in the kernel's place."""
    import time

    from portbench import bench

    def run(cell, seed=2 ** 31 + 5, trace=False, seconds=0.2):
        return bench.measure(cell, seed, seconds, trace,
                             t_process=time.perf_counter(),
                             require_card=False, device="cpu",
                             engine="streamed_reference", root=tiny_root)
    return run
