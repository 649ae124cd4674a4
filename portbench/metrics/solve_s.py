"""solve_s (s): the window's wall time over the solves completed in it,
the mean time to the stated answer of one closed-loop caller."""


def read(run):
    if not run.solves:
        return None
    return run.window_s / len(run.solves)
