"""Kernel-level profiling hooks.

Counterpart of ``optimization_tpu/core/profiling.py`` on ``torch.profiler``:
``trace`` records the enclosed block (host ops and, where a card is
present, its kernels) and writes a Chrome trace into a directory;
``annotate`` names a region on that timeline; ``time_fn`` times calls.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator

import torch

from .tree import tree_leaves

__all__ = ["trace", "annotate", "time_fn"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is present) and write ``trace.json`` (Chrome
    trace format) into ``log_dir``.  Yields the profiler, whose
    ``key_averages()`` tabulates the ops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region on the profiler timeline."""
    return torch.profiler.record_function(name)


def time_fn(fn: Callable[..., Any], *args, iters: int = 10,
            warmup: int = 1, **kwargs) -> float:
    """Mean seconds per call of ``fn``.  When a tensor argument lies on a
    CUDA device the calls are timed by CUDA events on that device's
    current stream (device time, closed by a synchronize); otherwise by the
    host clock."""
    cuda = [leaf for leaf in tree_leaves((args, kwargs))
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
    for _ in range(warmup):
        fn(*args, **kwargs)
    if cuda:
        dev = cuda[0].device
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args, **kwargs)
            stop.record()
            stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.monotonic()
    for _ in range(iters):
        fn(*args, **kwargs)
    return (time.monotonic() - t0) / iters
