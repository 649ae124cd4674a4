"""Two-process ``parallel.initialize_distributed`` on 127.0.0.1: the port's
counterpart of ``tests/test_multihost.py::test_localhost_two_process_psum``.

Spawns two fresh CPU processes (``tests/test_torch_children/multihost_rank.py``) that
wire up ``initialize_distributed(coordinator_address="127.0.0.1:<port>",
num_processes=2, process_id=i, device_type="cpu")`` (gloo, the TCP store
on the chosen port) and check a cross-process ``pdot`` on local shards and
a sum of a ``DTensor``.  Skips only if the runtime forbids spawning; a
child that fails or outlives 180 s FAILS.
"""

import os
import socket
import subprocess
import sys

import pytest

TIMEOUT = 180


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_localhost_two_process_initialize_distributed():
    coord = f"127.0.0.1:{_free_port()}"
    child = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_torch_children", "multihost_rank.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    try:
        procs = [subprocess.Popen(
            [sys.executable, child, coord, "2", str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for rank in range(2)]
    except OSError as e:  # the runtime forbids spawning
        pytest.skip(f"cannot spawn subprocesses: {e}")
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the two processes outlived {TIMEOUT} s")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (
            f"child failed (rc={p.returncode}):\n{err[-2000:]}")
        assert any(line.startswith("OK") for line in out.splitlines()), (
            out, err[-2000:])
