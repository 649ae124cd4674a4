"""Each of the port's examples as a user runs it, on the CPU.

``main(["--device", "cpu"])`` of every example on its own default draws
(seeded ``torch.Generator``s), in float64: it prints the JAX example's
lines and applies the JAX example's own acceptance check, unchanged (the
certificate fleet's and the online snapshots' ``SystemExit``, the
escalation's ``|g| <= tol``, the staircase's certified escape); a failed
check fails the test.  Every number an example returns is finite.  One
example also runs as ``python -m``, in a subprocess: exit 0 with ``--device
cpu``, and without it (no card here) a non-zero exit naming the missing
device.  The parity with the JAX package on the JAX examples' inputs is
``tests/test_torch_examples.py``.
"""

import importlib
import math
import os
import subprocess
import sys

import pytest
import torch

from optimization_tpu_torch.examples import EXAMPLES

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numbers(tree):
    """Every int or float leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            yield from _numbers(leaf)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield tree


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_main_on_the_cpu_meets_its_check(name, capsys):
    module = importlib.import_module(f"optimization_tpu_torch.examples.{name}")
    out = module.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device=cpu") and len(lines) > 1
    assert all(math.isfinite(v) for v in _numbers(out))
    assert "float64" in lines[0]


def _run_module(*args):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "optimization_tpu_torch.examples.lobpcg_example",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


def test_example_runs_as_a_module():
    """``python -m optimization_tpu_torch.examples.lobpcg_example --device
    cpu`` exits 0 with its two result lines; with no ``--device`` on this
    card-less machine it exits non-zero, naming the missing device, and
    prints no result."""
    ok = _run_module("--device", "cpu")
    assert ok.returncode == 0, ok.stderr
    assert "[LOBPCG diag-500]" in ok.stdout
    assert "[LOBPCG structured-1e5]" in ok.stdout
    if torch.cuda.is_available():
        return
    bad = _run_module()
    assert bad.returncode != 0 and "no CUDA device" in bad.stderr
    assert "[LOBPCG" not in bad.stdout
