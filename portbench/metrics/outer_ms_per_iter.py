"""outer_ms_per_iter (ms): the window's wall time less the device time of
the streamed CG kernel, over all outer TNT iterations in the window: what
an outer iteration costs outside the subproblem engine (the eager outer
loop, the trial-step evaluator, the host's reads and launches)."""


def read(run):
    outer = sum(s["outer"] for s in run.solves)
    if run.trace is None or outer == 0:
        return None
    kernel_s = run.trace.device_time_s(
        lambda name: any(k in name for k in run.kernels))
    if kernel_s <= 0:
        return None
    return 1e3 * (run.window_s - kernel_s) / outer
