"""Reading the program's spans: the time inside ``tnt.solve`` spans splits
into issue (outside ``host_sync/*`` spans) and wait (inside them), and the
device's idle time inside the solves is the part of them that no device
operation covers; containment by intervals, on a hand-built trace."""

from types import SimpleNamespace

import pytest

from portbench import bench
from portbench.spans import overlap, solve_split
from portbench.tracing import Trace

NAMES = ("outer_issue_ms_per_iter", "outer_sync_wait_ms_per_iter",
         "outer_idle_ms_per_iter")


def read_all(trace, outer):
    run = SimpleNamespace(trace=trace, solves=[{"outer": o} for o in outer])
    return [bench.metric_reader(n).read(run) for n in NAMES]


def two_solves():
    """Two solves of 1,000 and 600 ns.  The first holds a sync span with a
    sync span nested in it and, well after the root opened (more than any
    walk back over siblings would reach), a second one; an idle gap lies
    half inside it.  The second solve has no sync."""
    host = [("tnt.solve", 1000, 1000),
            ("host_sync/tnt.Delta0", 1050, 50),
            ("tnt.subproblem", 1100, 300)]
    host += [("aten::mul", 1110 + 2 * i, 1) for i in range(100)]
    host += [("host_sync/tnt.status", 1500, 200),          # 1500-1700
             ("host_sync/inner", 1550, 100),               # nested in it
             ("tnt.update", 1700, 250),
             ("tnt.solve", 3000, 600),
             ("tnt.subproblem", 3100, 400)]
    device = [("k", 0, 1400),          # busy to 1400: idle 1400-1500
              ("k", 1500, 400),        # busy to 1900: idle 1900-2300,
              ("k", 2300, 1000),       #   half inside the first solve
              ("k", 3300, 1000)]       # idle 3300-... none: busy to 4300
    return Trace(device, host, window_s=5e-6)


def test_split_of_nested_syncs_and_a_gap_half_inside():
    issue, wait, idle = solve_split(two_solves())
    assert wait == 50 + 200                 # the nested span counted once
    assert issue + wait == 1000 + 600       # issue + wait = the roots' time
    assert idle == 100 + 100                # 1400-1500 and 1900-2000


def test_readers_per_outer_iteration():
    outer = [30, 10]
    issue, wait, idle = read_all(two_solves(), outer)
    assert wait == pytest.approx(250 / 1e6 / 40)
    assert issue == pytest.approx(1350 / 1e6 / 40)
    assert idle == pytest.approx(200 / 1e6 / 40)
    assert (issue + wait) * 40 == pytest.approx(1600 / 1e6)


@pytest.mark.parametrize("host", [
    [],                                               # no span at all
    [("aten::mul", 0, 10), ("host_sync/x", 20, 5)],   # syncs, no root
], ids=["empty", "no-root"])
def test_a_window_without_solve_spans_reads_nothing(host):
    trace = Trace([("k", 0, 100)], host, window_s=1e-6)
    assert solve_split(trace) is None
    assert read_all(trace, [30]) == [None, None, None]
    assert read_all(None, [30]) == [None, None, None]


def test_no_outer_iterations_reads_nothing():
    assert read_all(two_solves(), [0, 0]) == [None, None, None]


def test_overlap_of_sorted_disjoint_intervals():
    assert overlap([(0, 4), (5, 10)], [(3, 6), (8, 20)]) == 1 + 1 + 2
    assert overlap([(0, 4)], []) == 0
