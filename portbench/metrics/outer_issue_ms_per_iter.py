"""outer_issue_ms_per_iter (ms): the time inside the program's ``tnt.solve``
spans not covered by its ``host_sync/*`` spans, over the window's outer TNT
iterations: the host's cost of issuing one outer iteration (Python, torch's
dispatch, the launches).  Fewer launches and CUDA graphs cut it; a program
without spans reads nothing."""

from portbench.spans import per_outer_iteration_ms


def read(run):
    split = per_outer_iteration_ms(run)
    return None if split is None else split[0]
