"""Host-chunked LOBPCG drivers: wall-clock limits, verbose output, observers.

Counterpart of the LOBPCG half of ``optimization_tpu/core/driver.py``
(``drive_lobpcg``, ``drive_lobpcg_fleet`` and their shared loop): the solve
runs K iterations per call, and between calls the driver reads the clock,
prints the per-iteration lines, calls the observer and writes the
checkpoint, then resumes through the solver's ``warm_start`` seam, so a
chunked run visits the same iterates as a monolithic one.  The verbose lines
and the final report are the JAX package's, character for character.

Each chunk draws the default X0 and the norm-estimate block from the same
generator state (a copy of ``generator``'s state at the call, or the
solver's default generator, seeded 0 on the card), as the JAX driver hands
every chunk the same ``key``: that is what makes chunked equal
monolithic.  ``jax.block_until_ready`` is a synchronize on the result's
device.  ``drive``, ``drive_admm`` and the solver status tables are not
ported yet (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from .debug import pad_value
from .tree import tree_leaves

__all__ = ["drive_lobpcg", "drive_lobpcg_fleet"]


def _print_summary(name, reason, fields, elapsed, precision):
    """Final status report: one line naming the termination reason, one line
    with the final values and elapsed time."""
    print(f"{name} terminated: {reason}", flush=True)
    parts = [f"{k}: {v:.{precision}e}" for k, v in fields]
    print("  " + "  ".join(parts + [f"elapsed: {elapsed:.3f} s"]), flush=True)


def _fill_times(n_slots, counts, chunk_times, interpolate):
    """Per-iteration wall-clock vector from per-chunk end timestamps: every
    iteration of a chunk carries the chunk-end timestamp, or with
    ``interpolate=True`` a linear interpolation across the chunk between
    the previous and current chunk ends (an even-split model)."""
    times = np.full((n_slots,), pad_value(), np.float32)
    pos, prev = 0, 0.0
    for i, t in zip(counts, chunk_times):
        if interpolate and i > 0:
            times[pos:pos + i] = prev + (t - prev) * (
                np.arange(1, i + 1, dtype=np.float32) / i)
        else:
            times[pos:pos + i] = t
        pos += i
        prev = t
    return times, pos


def _synchronize(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _chunk_generators(generator: Optional[torch.Generator]):
    """A function giving, per chunk, a new generator in ``generator``'s
    state at this call.  Without one, every chunk gets ``None``: the
    solver's default, a generator seeded 0 on the card (or on X0's or the
    fleet data's device), the same draws in every chunk."""
    if generator is None:
        return lambda: None
    device, state = generator.device, generator.get_state()

    def fresh():
        g = torch.Generator(device=device)
        g.set_state(state)
        return g
    return fresh


def _drive_lobpcg_loop(run_chunk, *, iters_of, converged, verbose_line,
                       summarize, fleet, nev, max_iterations,
                       max_computation_time, verbose, precision,
                       chunk_iterations, observer, checkpoint_path,
                       time_interpolation=False):
    """Shared chunk loop / trace stitching for :func:`drive_lobpcg` and
    :func:`drive_lobpcg_fleet`."""
    if max_iterations < 1:
        raise ValueError("max_iterations must be >= 1")
    if chunk_iterations is None:
        chunk_iterations = 1 if verbose else max(1, max_iterations // 10)
    chunk_iterations = min(chunk_iterations, max(max_iterations, 1))

    start = time.monotonic()
    results, counts, chunk_times = [], [], []
    ws = None
    done = 0
    timed_out = False

    while True:
        n = min(chunk_iterations, max_iterations - done)
        if n <= 0:
            break
        r = run_chunk(n, ws)
        _synchronize(r.X)
        t = time.monotonic() - start
        i = iters_of(r) - done   # iterations completed this chunk
        results.append(r)
        counts.append(i)
        chunk_times.append(t)
        ws = r.warm_start

        if verbose:
            for j in range(i):
                print(verbose_line(r, j, done + j, t), flush=True)
        if observer is not None:
            observer(done + i, r, t)
        if checkpoint_path is not None:
            from .checkpoint import save_pytree
            save_pytree(checkpoint_path, ws)

        done += i
        if converged(r) or i < n:
            break
        if t > max_computation_time:
            timed_out = True
            break

    last = results[-1]
    shape = (max_iterations,) if fleet is None else (fleet, max_iterations)
    res_trace = np.full(shape, pad_value(), np.float32)
    nc_trace = np.full(shape, -1, np.int32)
    times, _ = _fill_times(max_iterations, counts, chunk_times,
                           time_interpolation)
    pos = 0
    for r, i in zip(results, counts):
        res_trace[..., pos:pos + i] = r.residual_trace.cpu().numpy()[..., :i]
        nc_trace[..., pos:pos + i] = r.nc_trace.cpu().numpy()[..., :i]
        pos += i

    device = last.X.device
    result = last._replace(
        residual_trace=torch.from_numpy(res_trace).to(device),
        nc_trace=torch.from_numpy(nc_trace).to(device))
    if verbose:
        name, reason, fields = summarize(result, timed_out)
        _print_summary(name, reason, fields, chunk_times[-1], precision)
    return result, torch.from_numpy(times)


def drive_lobpcg(A, B=None, T=None, *, X0=None, m=None, nx=None, nev,
                 max_iterations=100, tau=1e-6,
                 generator: Optional[torch.Generator] = None,
                 max_computation_time=float("inf"), verbose=False,
                 precision=3, chunk_iterations: Optional[int] = None,
                 observer: Optional[Callable[..., None]] = None,
                 checkpoint_path: Optional[str] = None,
                 time_interpolation: bool = False):
    """Host-chunked standalone LOBPCG: wall-clock limit, per-iteration
    verbose lines, times, and a final status report, via the solver's
    ``warm_start`` seam (chunked == monolithic iterates).

    Returns ``(result, times)``: the stitched LOBPCGResult (with
    ``residual_trace``/``nc_trace`` covering all completed iterations, f32
    and int32 as in the JAX package) and the per-iteration chunk-end
    timestamps.
    """
    from ..linalg.lobpcg import lobpcg

    chunk_generator = _chunk_generators(generator)

    def run_chunk(n, ws):
        return lobpcg(A, B, T, X0=X0, m=m, nx=nx, nev=nev, max_iterations=n,
                      tau=tau, generator=chunk_generator(), warm_start=ws)

    def verbose_line(r, j, k, t):
        return (f"Iter: {k:4d}  max|r|: "
                f"{float(r.residual_trace[j]):.{precision}e}  "
                f"nc: {int(r.nc_trace[j])}  time: {t:.3f}")

    def summarize(result, timed_out):
        nc = int(result.num_converged)
        reason = ("computation-time limit reached" if timed_out else
                  f"{nc}/{nev} wanted eigenpairs converged" if nc >= nev
                  else "iteration limit reached")
        return "LOBPCG", reason, [
            ("max residual", float(result.residual_norms.max())),
            ("theta_0", float(result.theta[0]))]

    return _drive_lobpcg_loop(
        run_chunk, iters_of=lambda r: int(r.num_iterations),
        converged=lambda r: int(r.num_converged) >= nev,
        verbose_line=verbose_line, summarize=summarize, fleet=None,
        nev=nev, max_iterations=max_iterations,
        max_computation_time=max_computation_time, verbose=verbose,
        precision=precision, chunk_iterations=chunk_iterations,
        observer=observer, checkpoint_path=checkpoint_path,
        time_interpolation=time_interpolation)


def _nanmax(t: torch.Tensor) -> float:
    """Largest non-NaN entry (NaN if there is none), as ``jnp.nanmax``."""
    kept = t[~torch.isnan(t)]
    return float(kept.max()) if kept.numel() else float("nan")


def drive_lobpcg_fleet(A, data, *, B=None, T=None, X0=None, m=None, nx=None,
                       nev, max_iterations=100, tau=1e-6,
                       generator: Optional[torch.Generator] = None,
                       rr_method="chol",
                       max_computation_time=float("inf"), verbose=False,
                       precision=3, chunk_iterations: Optional[int] = None,
                       observer: Optional[Callable[..., None]] = None,
                       checkpoint_path: Optional[str] = None,
                       time_interpolation: bool = False):
    """Host-chunked fleet LOBPCG: :func:`drive_lobpcg`'s host facilities for
    ``linalg.lobpcg.lobpcg_fleet``.  Chunking resumes through the batched
    ``warm_start`` seam (chunked == monolithic iterates).

    Verbose lines report fleet-wide aggregates (worst residual over the
    instances still recording, least-converged instance); the final summary
    counts fully-converged instances.  A chunk's length is the largest
    ``num_iterations`` of the fleet: an instance that converged early keeps
    its own count (see ``lobpcg_fleet``).  Returns ``(result, times)`` with a
    leading fleet axis on every result field and the stitched traces of
    shape ``(fleet, max_iterations)``.
    """
    from ..linalg.lobpcg import lobpcg_fleet

    fleet = tree_leaves(data)[0].shape[0]
    chunk_generator = _chunk_generators(generator)

    def run_chunk(n, ws):
        return lobpcg_fleet(A, data, B=B, T=T, X0=X0, m=m, nx=nx, nev=nev,
                            max_iterations=n, tau=tau,
                            generator=chunk_generator(), rr_method=rr_method,
                            warm_start=ws)

    def verbose_line(r, j, k, t):
        # instances that converged earlier stop recording (NaN / -1 past
        # their own count): aggregate over the still-recording ones
        worst = _nanmax(r.residual_trace[:, j])
        ncj = r.nc_trace[:, j]
        least = int(torch.where(ncj < 0, nev, ncj).min())
        return (f"Iter: {k:4d}  fleet max|r|: "
                f"{worst:.{precision}e}  min nc: {least}  time: {t:.3f}")

    def summarize(result, timed_out):
        n_done = int((result.num_converged >= nev).sum())
        reason = ("computation-time limit reached" if timed_out else
                  f"{n_done}/{fleet} instances fully converged"
                  if n_done == fleet else "iteration limit reached")
        return "LOBPCG fleet", reason, [
            ("worst residual", float(result.residual_norms.max())),
            ("min nc", float(result.num_converged.min()))]

    return _drive_lobpcg_loop(
        run_chunk,
        iters_of=lambda r: int(r.num_iterations.max()),
        converged=lambda r: bool((r.num_converged >= nev).all()),
        verbose_line=verbose_line, summarize=summarize, fleet=fleet,
        nev=nev, max_iterations=max_iterations,
        max_computation_time=max_computation_time, verbose=verbose,
        precision=precision, chunk_iterations=chunk_iterations,
        observer=observer, checkpoint_path=checkpoint_path,
        time_interpolation=time_interpolation)
