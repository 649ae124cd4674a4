"""outer_idle_ms_per_iter (ms): the device's idle time (no operation of the
trace running) that lies inside the program's ``tnt.solve`` spans, over the
window's outer TNT iterations: the idle the program causes.  The rest of
``device_idle_pct`` is the harness's own time between solves; a program
without spans reads nothing."""

from portbench.spans import per_outer_iteration_ms


def read(run):
    split = per_outer_iteration_ms(run)
    return None if split is None else split[2]
