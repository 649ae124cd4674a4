"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a size a
test run holds, driven through ``bench.measure`` on the CPU with the
kernel's plain version.  Each configuration runs at its system's
``TEST_OVERRIDES``, and each cell at its system's ``TEST_MIX`` (the sphere:
n = 4096, six outer iterations, two solves checked)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def write_root(root: Path, spec: dict, configs: dict, mixes: dict) -> Path:
    """A benchmark root: ``BENCHMARK.json`` from ``spec``, each
    configuration {file: dict} and each mix {name: dict} as a file."""
    (root / "portbench" / "traffic").mkdir(parents=True, exist_ok=True)
    for file, config in configs.items():
        (root / file).parent.mkdir(parents=True, exist_ok=True)
        (root / file).write_text(json.dumps(config))
    for name, mix in mixes.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    """A benchmark root whose cells run the real configurations (their
    limits too) at their systems' test sizes."""
    from portbench import bench

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs, mixes, mix_of = {}, {}, {}
    for c in spec["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        sysmod = bench.system_module(config)
        configs[c["file"]] = {**config, **sysmod.TEST_OVERRIDES}
        mix_of[c["name"]] = f"tiny_{config['system']}"
        mixes[mix_of[c["name"]]] = sysmod.TEST_MIX
    for w in spec["workloads"]:
        w["traffic"] = mix_of[w["config"]]
    yield write_root(tmp_path, spec, configs, mixes)
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
