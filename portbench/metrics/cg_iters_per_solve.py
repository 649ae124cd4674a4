"""cg_iters_per_solve (count): CG iterations of the subproblem engine a
solve, the sum of ``TNTResult.inner_iterations`` over the window's solves
over their number."""


def read(run):
    if not run.solves:
        return None
    return sum(sum(s["inner"]) for s in run.solves) / len(run.solves)
