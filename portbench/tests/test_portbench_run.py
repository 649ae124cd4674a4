"""``run.py`` as a check of the benchmark calls it: without a card, no
result and a non-zero exit (never a fall back to the CPU); and nothing it
imports is JAX or the JAX package, compared by whole top-level names."""

import json
import os
import subprocess
import sys

from conftest import ROOT

CELL = "rayleigh_k1e3.n2p24"


def test_run_without_a_card_fails_and_prints_nothing():
    # the machine's cards, if it has any, hidden from the run
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


def test_what_run_imports_is_free_of_jax():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import portbench.run
from portbench import bench, control, peaks, tracing, traffic
spec = bench.load_spec()
for c in spec["configs"]:
    bench.system_module(bench.load_config(c))
for m in spec["end_to_end"] + spec["per_layer"]:
    bench.metric_reader(m["name"])
from optimization_tpu_torch import headline
from optimization_tpu_torch.solvers import tnt
import torch.profiler
print(json.dumps([bench.forbidden_modules(),
                  sorted({{m.split(".")[0] for m in sys.modules}})]))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    found, tops = json.loads(proc.stdout.strip().splitlines()[-1])
    assert found == []
    assert "optimization_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "optimization_tpu"} & set(tops)
