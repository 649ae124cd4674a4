"""What every traffic mix shares: the draw streams, their seeds, the sample
of checked solves and the keys common to all mixes.

A mix is a file ``traffic/<name>.json``.  It drives one caller in a closed
loop (the next solve starts when the last one has returned).  Its common
keys, which :func:`load` checks: the solves a run's set-up warms up with
(``warmup_solves``), how many of the window's answers are checked
(``check_solves``, drawn among its first ``check_within`` solves), and on
how many solves after a traced window the host's blocking reads are
counted (``sync_solves``).  Every other key is the input's, and belongs to
the system the cell's configuration names.

Every draw comes from ``(seed, stream, index)`` through numpy's
``SeedSequence`` (:func:`draw_seed`), so any whole ``--seed`` (beyond 32
bits too) gives the same inputs on every run, and the window's solves, the
warm-up's and the sample for correctness never share a draw.

**The system's contract.**  A configuration's ``system`` names the module
``systems/<system>.py``, which ``bench.system_module`` imports by that
name.  The module owns the input of a solve and everything that knows its
shape; the harness reads the module through these names alone:

- ``draw(config, mix, seed, stream, index, device)``: the input of one
  solve, made on ``device`` from ``draw_seed(seed, stream, index)`` alone;
  the harness draws it before the solve's timed interval starts, and the
  judge's copy of it again after the window;
- ``check_mix(mix)``: raises ``ValueError`` where a mix lacks or misstates
  one of the system's own keys;
- ``System(config, mix, device, engine=None)``: the program, built once in
  set-up, with ``solve(input)``, ``solve_recorded(input)`` (the same solve,
  keeping what the judge reads: a tuple whose first item is the solve's
  result), ``trail(recorded)`` (that record as the judge takes it),
  ``recording_bytes(solves)`` (the device memory that many records keep),
  ``counters(result)`` (a solve's counts, left on the device until the
  window ends) and ``read_counters(counters)`` -> a dict whose ``"f"``
  (the stated objective; a solve whose ``f`` is not finite has failed) the
  harness reads, and whose other keys the cell's metric readers read
  (``"outer"``, ``"inner"``, ``"status"`` for TNT);
- ``judge(config, mix, samples, input_of, device)``: the worst reading of
  each of ``NUMBERS`` over ``samples`` [(window index, trail)], each held
  against the plain reference from ``input_of(index)``, a redraw; the
  configuration's ``limits`` bound them;
- ``control(config, mix, input)``: the control's answer to one input (the
  reference put in the program's place, one precision lower), as a trail
  the judge reads; ``control.py`` reads the program and the control
  through ``judge`` alike;
- ``KERNELS`` (the program's kernel names as ``torch.profiler`` gives
  them), ``NUMBERS``, and ``TEST_MIX`` / ``TEST_OVERRIDES``: the mix and the
  configuration keys at which the CPU tests run the system's cells.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

WINDOW, WARMUP, SYNCS, SAMPLE = 0, 1, 2, 3      # draw streams

KEYS = {"warmup_solves", "check_solves", "check_within", "sync_solves"}


def load(name: str, root: Path = HERE.parent) -> dict:
    """The mix ``traffic/<name>.json`` of the benchmark under ``root``, its
    common keys checked (the system checks its own)."""
    path = root / HERE.name / "traffic" / f"{name}.json"
    mix = json.loads(path.read_text())
    missing = KEYS - mix.keys()
    if missing:
        raise ValueError(f"traffic {name}: missing {sorted(missing)}")
    return mix


def draw_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit generator seed for draw ``index`` of ``stream``."""
    if seed < 0 or index < 0:
        raise ValueError("seeds and indices are whole numbers >= 0")
    state = np.random.SeedSequence([seed, stream, index]).generate_state(
        1, dtype=np.uint64)
    return int(state[0]) & (2 ** 63 - 1)


def sample_indices(seed: int, k: int, within: int) -> set:
    """The k solves of the window (of its first ``within``) whose answers
    are checked, drawn from the seed before the window starts, so that
    they are recorded as they run."""
    rng = np.random.Generator(np.random.PCG64(draw_seed(seed, SAMPLE, 0)))
    return {int(i) for i in rng.choice(within, size=k, replace=False)}
