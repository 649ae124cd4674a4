"""The streamed CG kernel's work count against a hand count at small n."""

import pytest

from portbench import bench, peaks

R = bench.metric_reader("streamed_cg_roofline")
N = 1000
VEC = 4 * N                       # one f32 vector


def card(on_chip):
    return peaks.Card("NVIDIA H100 test", 3.35e12, 67e12, on_chip, 0, 0)


@pytest.mark.parametrize("on_chip, words", [
    (0, 6),                       # r, p read + written, x read, s every 2nd
    (VEC, 4),                     # half of r, p held: 2 words saved
    (2 * VEC, 2),                 # r and p held: x and s remain
    (3 * VEC, 1),                 # then x (or s) held too
    (4 * VEC, 0),                 # all carried state on the chip
    (10 * VEC, 0),
])
def test_iteration_bytes_by_hand(on_chip, words):
    assert R.iteration_bytes(N, on_chip) == words * VEC


def test_subproblem_work_by_hand():
    # g read and s written once, 7 iterations of 6 words, 19 ops each
    assert R.subproblem_work(N, 7, 0) == (2 * VEC + 7 * 6 * VEC, 7 * 19 * N)
    assert R.subproblem_work(N, 0, 0) == (2 * VEC, 0)


def test_least_time_takes_the_larger_bound():
    c = card(0)
    t = R.least_seconds(N, [50, 50], c)
    b = 2 * (2 * VEC + 50 * 6 * VEC) / 3.35e12
    ops = 2 * 50 * 19 * N / 67e12
    assert t == pytest.approx(max(b, ops))
    assert R.least_seconds(2 ** 24, [50], card(50 << 20)) < R.least_seconds(
        2 ** 24, [50], card(0))


def test_converged_solve_drops_its_last_entry():
    assert R.subproblems({"inner": [0, 3, 0], "status": 1}) == [0, 3]
    assert R.subproblems({"inner": [0, 3, 50], "status": 6}) == [0, 3, 50]
