"""solve_s_p90 (s): the 90th percentile of every solve's wall in the
window (host clock, closed on a synchronize).  Read only where the window
holds 100 solves or more, so that ten or more lie beyond it."""

import statistics

MIN_SOLVES = 100


def read(run):
    if len(run.walls) < MIN_SOLVES:
        return None
    return statistics.quantiles(run.walls, n=10, method="inclusive")[-1]
