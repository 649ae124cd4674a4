"""The one traffic generator: every mix is a file ``traffic/<name>.json``.

It drives one caller in a closed loop (the next solve starts when the last
one has returned), each solve from a uniform point on the sphere.  A mix
states the problem size ``n`` of each solve, the solves a run's set-up
warms up with, how many of the window's answers are checked (drawn among
its first ``check_within`` solves), and on how many solves after a traced
window the host's blocking reads are counted.

Every draw comes from ``(seed, stream, index)`` through numpy's
``SeedSequence``, so any whole ``--seed`` (beyond 32 bits too) gives the same
inputs on every run, and the window's solves, the warm-up's and the sample
for correctness never share a draw.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

WINDOW, WARMUP, SYNCS, SAMPLE = 0, 1, 2, 3      # draw streams

KEYS = {"n", "warmup_solves", "check_solves", "check_within", "sync_solves"}


def load(name: str, root: Path = HERE.parent) -> dict:
    """The mix ``traffic/<name>.json`` of the benchmark under ``root``,
    checked."""
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


def start_point(mix: dict, seed: int, stream: int, index: int, device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A uniform point on S^(n-1): n normal draws on ``device`` from their
    own generator, over their norm, in f32, cast to ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(seed, stream, index))
    x = torch.randn(mix["n"], generator=gen, dtype=torch.float32,
                    device=device)
    return (x / torch.linalg.vector_norm(x)).to(dtype)


def sample_indices(seed: int, k: int, within: int) -> set:
    """The k solves of the window (of its first ``within``) whose answers
    are checked, drawn from the seed before the window starts, so that
    they are recorded as they run."""
    rng = np.random.Generator(np.random.PCG64(draw_seed(seed, SAMPLE, 0)))
    return {int(i) for i in rng.choice(within, size=k, replace=False)}
