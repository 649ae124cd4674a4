"""outer_sync_wait_ms_per_iter (ms): the time inside the program's
``host_sync/*`` spans nested in its ``tnt.solve`` spans, over the window's
outer TNT iterations: the host blocked on the card (the status read once an
outer iteration, the blocking copies of a solve's start and end).  Shorter
device passes cut it; a program without spans reads nothing."""

from portbench.spans import per_outer_iteration_ms


def read(run):
    split = per_outer_iteration_ms(run)
    return None if split is None else split[1]
