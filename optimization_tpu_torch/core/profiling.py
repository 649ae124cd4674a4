"""Kernel-level profiling hooks.

Counterpart of ``optimization_tpu/core/profiling.py`` on ``torch.profiler``:
``trace`` records the enclosed block (host ops and, where a card is
present, its kernels) and writes a Chrome trace into a directory;
``annotate`` names a region on that timeline (the port's span); ``time_fn``
times calls.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

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


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """The port's span: a named region of the calling thread, recorded while
    a ``torch.profiler`` runs as one CPU operation on the profiler's clock,
    nested in the spans open around it.  It is not a user annotation, so
    the profiler mirrors nothing onto the device's timeline (a
    ``record_function`` range would land there as a ``gpu_user_annotation``
    and fill the device's idle gaps).  With no profiler recording it costs
    one check in C and returns a shared no-op."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)


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
