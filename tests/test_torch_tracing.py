"""The port's spans in a TNT solve (``core.profiling.annotate``): under a
CPU ``torch.profiler``, the headline solve through the streamed kernel's
plain version records one ``tnt.solve`` root a solve, one
``host_sync/tnt.status`` an entered outer iteration, one ``tnt.subproblem``
and one ``tnt.trial_step`` an attempted step inside the root, and returns
the same result, bit for bit, as with the profiler off.  The plain version
is not a launch: no ``streamed_cg.*`` span."""

import pytest
import torch

from optimization_tpu_torch import headline
from optimization_tpu_torch.core.types import TNTStatus
from optimization_tpu_torch.solvers import tnt

torch.set_num_threads(1)

N = 2 ** 12
OUTER = 6


def spans(prof):
    """(name, start, end) of every CPU event, in start order."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()),
                  key=lambda e: e[1])


@pytest.mark.parametrize("jacobi_power", [None, 0.25],
                         ids=["plain", "jacobi"])
def test_solve_spans_nest_and_change_nothing(jacobi_power):
    problem = headline.make_problem(N, "cpu", "streamed_reference",
                                    kappa=1e3, jacobi_power=jacobi_power)
    params = headline.tier_params(0.0, max_tpcg=20, max_iterations=OUTER)
    x0 = headline.initial_point(N, torch.float32, "cpu", seed=3)
    plain = tnt.solve(problem, x0, params)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = tnt.solve(problem, x0, params)

    for a, b in zip(plain[:-3], traced[:-3]):      # all but times, iterates,
        assert torch.equal(a, b)                   # warm_start
    for a, b in zip(plain.warm_start[:4], traced.warm_start[:4]):
        assert torch.equal(a, b)
    k = int(traced.num_iterations)
    assert k == OUTER
    assert int(traced.status) == TNTStatus.ITERATION_LIMIT

    events = spans(prof)
    roots = [e for e in events if e[0] == "tnt.solve"]
    assert len(roots) == 1
    _, r0, r1 = roots[0]

    def inside(name):
        found = [e for e in events if e[0] == name]
        assert all(r0 <= s and t <= r1 for _, s, t in found), name
        return len(found)

    assert inside("host_sync/tnt.status") == k
    assert inside("tnt.subproblem") == k
    assert inside("tnt.trial_step") == k
    assert inside("tnt.update") == k
    assert inside("tnt.seed") == inside("tnt.finish") == 1
    assert inside("headline.prec_map") == (0 if jacobi_power is None else k)
    assert not any(e[0].startswith("streamed_cg.") for e in events)
