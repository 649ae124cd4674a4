"""Host-chunked solve drivers: wall-clock limits, verbose output, observers.

Counterpart of ``optimization_tpu/core/driver.py`` (``drive``,
``drive_admm``, ``drive_lobpcg``, ``drive_lobpcg_fleet`` and their shared
loops).  The
reference checks a wall clock and prints a line at the top of every solver
iteration (``TNT.h:447-471``, ``GradientDescent.h:231-253``,
``TNLS.h:491-506``, ``ProximalGradient.h:334-345``, ``ADMM.h:477-504``) and
stores per-iteration times (``Base/Concepts.h:
76-80``).  As in the JAX package, a solve runs K iterations per call, and
between calls the driver reads the clock, prints the per-iteration lines,
calls the observer and writes the checkpoint, then resumes through the
solver's warm-start seam (``Delta0`` for TNT and TNLS, plus TNT's
``warm_start`` carry of its trial-step evaluator; the ``warm_start`` tuples
of proximal gradient and ADMM; gradient descent keeps no state across
iterations), so a chunked run visits the same iterates as a
monolithic one.  (The JAX package's driver resumes TNT from x and the
radius alone, which leaves the uninterrupted trajectory in the last bits
when the problem has a ``step_eval``: ROADMAP Queue 3.)  A checkpoint
holds ``(x, radius)``, as the JAX package's does.  The port's eager loops
could read the clock themselves; the chunks are kept because they give
the JAX package's contracts unchanged (``chunk_iterations=1`` is the
reference's per-iteration behaviour).  The verbose lines and the final
"<Solver> terminated: <reason>" report are the JAX package's, character
for character.

For LOBPCG, each chunk draws the default X0 and the norm-estimate block
from the same generator state (a copy of ``generator``'s state at the call,
or the solver's default generator, seeded 0 on the card), as the JAX driver
hands every chunk the same ``key``: that is what makes chunked equal
monolithic.  ``jax.block_until_ready`` is a synchronize on the result's
device.

A terminating ``user_function`` of proximal gradient or ADMM sees the
global iteration under chunking: the driver hands each chunk the iterations
done so far (the solvers' ``iteration_offset``), and ADMM's
penalty-adaptation schedule counts from there too, so a chunked run equals
the monolithic one whatever the chunk size.  (In the JAX package both
restart at 0 in every chunk; the reference passes the global iteration.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .debug import pad_value
from .host import Stopwatch
from .tree import tree_leaves, tree_map

__all__ = ["drive", "drive_admm", "drive_lobpcg", "drive_lobpcg_fleet"]


class _Adapter(NamedTuple):
    run: Callable          # (x, carry, n_iters, previous result,
                           #  iterations done so far) -> result
    extract: Callable      # result -> (x, carry)
    pre_traces: Sequence[str]   # length n+1, recorded at top of iteration
    step_traces: Sequence[str]  # length n, recorded per attempted step
    iteration_limit: int   # status code meaning "ran out of iterations"
    elapsed_time: int      # status code for wall-clock stop
    fmt: Callable          # (result, i, k, prec) -> verbose line
    name: str = ""         # solver display name for the final report
    status_msg: dict = {}  # status code -> human explanation
    final_fields: Optional[Callable] = None  # result -> [(label, value)]


def _chunk_params(params, n: int):
    return dataclasses.replace(params, max_iterations=n)


def _print_summary(name, reason, fields, elapsed, precision):
    """Final status report: one line naming the termination reason, one line
    with the final values and elapsed time."""
    print(f"{name} terminated: {reason}", flush=True)
    parts = [f"{k}: {v:.{precision}e}" for k, v in fields]
    print("  " + "  ".join(parts + [f"elapsed: {elapsed:.3f} s"]), flush=True)


# Human explanations of the termination statuses, mirroring the reference's
# final-report branches (file:line above each dict).
_GD_STATUS_MSG = {  # GradientDescent.h:353-395
    1: "gradient norm tolerance reached",
    2: "relative decrease tolerance reached",
    3: "stepsize tolerance reached",
    4: "line search failed to find a step giving sufficient decrease",
    5: "iteration limit reached",
    6: "computation-time limit reached",
}
_TNT_STATUS_MSG = {  # TNT.h:626-686
    1: "gradient norm tolerance reached",
    2: "preconditioned gradient norm tolerance reached",
    3: "relative decrease tolerance reached",
    4: "stepsize tolerance reached",
    5: "trust-region radius collapsed below tolerance",
    6: "iteration limit reached",
    7: "computation-time limit reached",
    8: "user-supplied stopping criterion",
}
_PG_STATUS_MSG = {  # ProximalGradient.h:412-445
    1: "composite gradient tolerance reached",
    2: "iteration limit reached",
    3: "linesearch failed to find an acceptable stepsize",
    4: "computation-time limit reached",
    5: "user-supplied stopping criterion",
}
_ADMM_STATUS_MSG = {  # ADMM.h:597-620
    1: "primal and dual residual tolerances reached",
    2: "iteration limit reached",
    3: "computation-time limit reached",
    4: "user-supplied stopping criterion",
}
_TNLS_STATUS_MSG = {  # TNLS.h:669-726
    1: "root found: residual norm below tolerance",
    2: "gradient norm tolerance reached",
    3: "relative decrease tolerance reached",
    4: "stepsize tolerance reached",
    5: "trust-region radius collapsed below tolerance",
    6: "iteration limit reached",
    7: "computation-time limit reached",
    8: "user-supplied stopping criterion",
}


def _adapter_for(solver, problem, params, data, user_function):
    name = solver.__name__.rsplit(".", 1)[-1]

    if name == "gradient_descent":
        from .types import GradientDescentStatus as S

        def run(x, carry, n, prev, done):
            return solver.solve(problem, x, _chunk_params(params, n), data,
                                user_function=user_function)

        def fmt(r, i, k, p):
            return (f"Iter: {k:4d}  f: {r.objective_values[i]:+.{p}e}  "
                    f"|g|: {r.gradient_norms[i]:.{p}e}")

        return _Adapter(run, lambda r: (r.x, None),
                        ("objective_values", "gradient_norms"),
                        ("update_step_norms", "linesearch_iterations"),
                        S.ITERATION_LIMIT.value, S.ELAPSED_TIME.value, fmt,
                        "Gradient descent", _GD_STATUS_MSG,
                        lambda r: [("f", float(r.f)),
                                   ("|g|", float(r.gradfx_norm))])

    if name == "tnt":
        from .types import TNTStatus as S

        def run(x, carry, n, prev, done):
            # the previous chunk's evaluator state makes the resume exact
            # (solvers/tnt.py:solve(warm_start=))
            return solver.solve(problem, x, _chunk_params(params, n), data,
                                user_function=user_function, Delta0=carry,
                                warm_start=prev and prev.warm_start)

        def extract(r):
            return r.x, r.trust_region_radius[r.num_iterations]

        def fmt(r, i, k, p):
            return (f"Iter: {k:4d}  f: {r.objective_values[i]:+.{p}e}  "
                    f"|g|: {r.gradient_norms[i]:.{p}e}  "
                    f"Delta: {r.trust_region_radius[i]:.{p}e}")

        return _Adapter(run, extract,
                        ("objective_values", "gradient_norms",
                         "preconditioned_gradient_norms",
                         "trust_region_radius"),
                        ("inner_iterations", "update_step_norms",
                         "update_step_M_norms", "gain_ratios"),
                        S.ITERATION_LIMIT.value, S.ELAPSED_TIME.value, fmt,
                        "TNT", _TNT_STATUS_MSG,
                        lambda r: [("f", float(r.f)),
                                   ("|g|", float(r.gradfx_norm)),
                                   ("|M^-1 g|",
                                    float(r.preconditioned_grad_f_x_norm))])

    if name == "tnls":
        from .types import TNLSStatus as S

        def run(x, carry, n, prev, done):
            return solver.solve(problem, x, _chunk_params(params, n), data,
                                user_function=user_function, Delta0=carry)

        def extract(r):
            return r.x, r.trust_region_radius[r.num_iterations]

        def fmt(r, i, k, p):
            return (f"Iter: {k:4d}  |F|: {r.objective_values[i]:.{p}e}  "
                    f"|gradL|: {r.gradient_norms[i]:.{p}e}  "
                    f"Delta: {r.trust_region_radius[i]:.{p}e}")

        return _Adapter(run, extract,
                        ("objective_values", "gradient_norms",
                         "trust_region_radius"),
                        ("inner_iterations", "update_step_norms", "rho"),
                        S.ITERATION_LIMIT.value, S.ELAPSED_TIME.value, fmt,
                        "TNLS", _TNLS_STATUS_MSG,
                        lambda r: [("|F|", float(r.f)),
                                   ("|gradL|", float(r.gradfx_norm))])

    if name == "proximal_gradient":
        from .types import ProximalGradientStatus as S

        def run(x, carry, n, prev, done):
            return solver.solve(problem, x, _chunk_params(params, n), data,
                                warm_start=carry, user_function=user_function,
                                iteration_offset=done)

        def fmt(r, i, k, p):
            return (f"Iter: {k:4d}  F: {r.objective_values[i]:+.{p}e}  "
                    f"|G|: {r.composite_gradient_norms[i]:.{p}e}")

        return _Adapter(run, lambda r: (r.x, r.warm_start),
                        (),
                        ("objective_values", "composite_gradient_norms",
                         "relative_composite_gradient_norms",
                         "linesearch_iterations"),
                        S.ITERATION_LIMIT.value, S.ELAPSED_TIME.value, fmt,
                        "Proximal gradient", _PG_STATUS_MSG,
                        lambda r: [("F", float(r.f)),
                                   ("|G|", float(
                                       r.composite_gradient_norms[
                                           max(int(r.num_iterations) - 1, 0)])
                                    if int(r.num_iterations) else float("nan"))])

    raise ValueError(f"No driver adapter for solver module '{name}'")


def _stitch(results, counts, field, kind, total, final_extra):
    """One reference-shaped trace from the chunks' traces: each chunk's
    completed iterations, plus the last chunk's closing record for a
    per-iteration ("pre") trace; padding beyond."""
    parts = [getattr(r, field)[:i] for r, i in zip(results, counts)]
    if kind == "pre" and final_extra:
        parts.append(getattr(results[-1], field)
                     [counts[-1]:counts[-1] + 1])
    flat = torch.cat(parts)
    n = total + (1 if kind == "pre" else 0)
    if flat.dtype.is_floating_point:
        out = torch.full((n,), pad_value(), dtype=flat.dtype,
                         device=flat.device)
    else:
        out = torch.zeros((n,), dtype=flat.dtype, device=flat.device)
    m = min(flat.shape[0], n)
    out[:m] = flat[:m]
    return out


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


def _drive(adapter: _Adapter, params, chunk_iterations, observer,
           checkpoint_path, x0, time_interpolation=False):
    verbose = params.verbose
    if chunk_iterations is None:
        chunk_iterations = (1 if verbose
                            else max(1, params.max_iterations // 10))
    chunk_iterations = min(chunk_iterations, max(params.max_iterations, 1))

    watch = Stopwatch()
    results, counts, chunk_times = [], [], []
    x, carry = x0, None
    done = 0
    final_status = None

    while True:
        n = min(chunk_iterations, params.max_iterations - done)
        if n <= 0:
            final_status = adapter.iteration_limit
            if not results:
                # max_iterations == 0: mirror the monolithic solver (one
                # zero-iteration run records the initial trace entry)
                results.append(adapter.run(x, carry, 0, None, 0))
                counts.append(0)
                chunk_times.append(watch.tock())
            break
        r = adapter.run(x, carry, n, results[-1] if results else None, done)
        _synchronize(tree_leaves(r.x)[0])
        t = watch.tock()
        i = int(r.num_iterations)
        status = int(r.status)
        results.append(r)
        counts.append(i)
        chunk_times.append(t)
        x, carry = adapter.extract(r)

        if verbose:
            for j in range(i):
                print(adapter.fmt(r, j, done + j, params.precision)
                      + f"  time: {t:.3f}", flush=True)
        if observer is not None:
            observer(done + i, r, t)
        if checkpoint_path is not None:
            from .checkpoint import save_pytree
            save_pytree(checkpoint_path, (x, carry))

        done += i
        if status != adapter.iteration_limit:
            final_status = status
            break
        if t > params.max_computation_time:
            final_status = adapter.elapsed_time
            break
        if done >= params.max_iterations:
            final_status = adapter.iteration_limit
            break

    last = results[-1]
    updates = {}
    for f in adapter.pre_traces:
        updates[f] = _stitch(results, counts, f, "pre", params.max_iterations,
                             True)
    for f in adapter.step_traces:
        updates[f] = _stitch(results, counts, f, "step",
                             params.max_iterations, False)
    if params.log_iterates and getattr(last, "iterates", None) is not None:
        sliced = [tree_map(lambda l, n=i: l[:n], r.iterates)
                  for r, i in zip(results, counts)]
        sliced.append(tree_map(lambda l: l[counts[-1]:counts[-1] + 1],
                               last.iterates))
        updates["iterates"] = tree_map(
            lambda *xs: torch.cat(xs)[:params.max_iterations + 1], *sliced)
    times, pos = _fill_times(
        params.max_iterations + (1 if adapter.pre_traces else 0),
        counts, chunk_times, time_interpolation)
    if pos < len(times):
        times[pos] = chunk_times[-1]
    updates["times"] = torch.from_numpy(times).to(last.times.device)

    dev = last.status.device
    result = last._replace(
        num_iterations=torch.tensor(done, dtype=torch.int32, device=dev),
        status=torch.tensor(final_status, dtype=torch.int32, device=dev),
        **updates)
    if verbose and adapter.final_fields is not None:
        _print_summary(
            adapter.name,
            adapter.status_msg.get(final_status, str(final_status)),
            adapter.final_fields(result), chunk_times[-1], params.precision)
    return result


def drive(solver, problem, x0, params, data=None, *,
          user_function=None, chunk_iterations: Optional[int] = None,
          observer: Optional[Callable[..., None]] = None,
          checkpoint_path: Optional[str] = None,
          time_interpolation: bool = False):
    """Run ``solver.solve`` in host-driven chunks.

    - ``solver``: one of the solver modules ``gradient_descent`` / ``tnt`` /
      ``tnls`` / ``proximal_gradient`` (for ADMM use :func:`drive_admm`).
    - Honors ``params.max_computation_time`` (checked between chunks; the
      status becomes the solver's ElapsedTime code, reference
      ``TNT.h:447-451``), ``params.verbose`` (per-iteration lines printed
      per chunk, ``TNT.h:464-471``, and the final report), and fills
      ``result.times``.
    - ``observer(total_iters, chunk_result, elapsed)``: the host-side analog
      of the reference's void user functions (observation only).
    - ``checkpoint_path``: the warm-start state ``(x, carry)`` is written
      after every chunk (``core.checkpoint``).
    - ``chunk_iterations``: the granularity; defaults to 1 when verbose,
      else max_iterations/10.
    - ``time_interpolation``: linearly interpolate ``result.times`` across
      each chunk (an even-split model); by default every iteration of a
      chunk carries the chunk-end timestamp.

    Returns the same result type as ``solver.solve``, with stitched traces
    equal to a monolithic run's.
    """
    adapter = _adapter_for(solver, problem, params, data, user_function)
    return _drive(adapter, params, chunk_iterations, observer,
                  checkpoint_path, x0, time_interpolation)


def drive_admm(problem, c, x0, y0, params, data=None, *,
               user_function=None,
               chunk_iterations: Optional[int] = None,
               observer: Optional[Callable[..., None]] = None,
               checkpoint_path: Optional[str] = None,
               time_interpolation: bool = False):
    """Host-chunked ADMM (see :func:`drive`).  Resumes via the solver's
    ``warm_start`` seam, so acceleration/penalty state carries exactly.
    ``user_function`` is the solver's terminating predicate
    (``admm.solve``; it sees the global iteration); at
    ``chunk_iterations=1`` the chunk result seen by ``observer``
    additionally carries the reference callback's residual VECTORS
    ``r``/``s`` per iteration (``ADMM.h:71-76``).  A checkpoint holds
    ``(x, y, warm_start)``, as the JAX package's does."""
    from .types import ADMMStatus as S
    from ..solvers import admm

    verbose = params.verbose
    if chunk_iterations is None:
        chunk_iterations = (1 if verbose
                            else max(1, params.max_iterations // 10))

    watch = Stopwatch()
    results, counts, chunk_times = [], [], []
    x, y, ws = x0, y0, None
    done = 0
    final_status = None

    def run(n):
        return admm.solve(problem, c, x, y, _chunk_params(params, n), data,
                          warm_start=ws, user_function=user_function,
                          iteration_offset=done)

    while True:
        n = min(chunk_iterations, params.max_iterations - done)
        if n <= 0:
            final_status = S.ITERATION_LIMIT.value
            if not results:
                results.append(run(0))
                counts.append(0)
                chunk_times.append(watch.tock())
            break
        r = run(n)
        _synchronize(tree_leaves(r.x)[0])
        t = watch.tock()
        i = int(r.num_iterations)
        status = int(r.status)
        results.append(r)
        counts.append(i)
        chunk_times.append(t)
        x, ws = r.x, r.warm_start
        y = ws[2]["y_prev"]  # the internal (plain) y

        if verbose:
            for j in range(i):
                print(f"Iter: {done + j:4d}  "
                      f"|r|: {r.primal_residuals[j]:.{params.precision}e}  "
                      f"|s|: {r.dual_residuals[j]:.{params.precision}e}  "
                      f"rho: {r.penalty_parameters[j]:.{params.precision}e}"
                      f"  time: {t:.3f}", flush=True)
        if observer is not None:
            observer(done + i, r, t)
        if checkpoint_path is not None:
            from .checkpoint import save_pytree
            save_pytree(checkpoint_path, (x, y, ws))

        done += i
        if status != S.ITERATION_LIMIT.value:
            final_status = status
            break
        if t > params.max_computation_time:
            final_status = S.ELAPSED_TIME.value
            break
        if done >= params.max_iterations:
            final_status = S.ITERATION_LIMIT.value
            break

    last = results[-1]
    updates = {}
    for f in ("primal_residuals", "dual_residuals", "m_k",
              "penalty_parameters", "iteration_types"):
        updates[f] = _stitch(results, counts, f, "step",
                             params.max_iterations, False)
    if params.log_iterates and getattr(last, "iterates", None) is not None:
        sliced = [tree_map(lambda l, n=i: l[:n], r.iterates)
                  for r, i in zip(results, counts)]

        def cat(*xs):
            flat = torch.cat(xs)
            pad = params.max_iterations - flat.shape[0]
            if pad > 0:
                flat = torch.cat([flat, flat.new_zeros(
                    (pad,) + tuple(flat.shape[1:]))])
            return flat

        updates["iterates"] = tree_map(cat, *sliced)
    times, _ = _fill_times(params.max_iterations, counts, chunk_times,
                           time_interpolation)
    updates["times"] = torch.from_numpy(times).to(last.times.device)

    dev = last.status.device
    result = last._replace(
        num_iterations=torch.tensor(done, dtype=torch.int32, device=dev),
        status=torch.tensor(final_status, dtype=torch.int32, device=dev),
        **updates)
    if verbose:
        _print_summary(
            "ADMM", _ADMM_STATUS_MSG.get(final_status, str(final_status)),
            [("primal residual",
              float(result.primal_residuals[max(done - 1, 0)])
              if done else float("nan")),
             ("dual residual",
              float(result.dual_residuals[max(done - 1, 0)])
              if done else float("nan"))],
            chunk_times[-1], params.precision)
    return result


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

    watch = Stopwatch()
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
        t = watch.tock()
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
