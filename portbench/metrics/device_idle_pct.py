"""device_idle_pct (%): the share of the traced window in which no
operation ran on the card (the union of the profiler's device operations
against the window's host-clock length)."""


def read(run):
    if run.trace is None or not run.trace.device_ops or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
