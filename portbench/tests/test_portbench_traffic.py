"""The generator: the same (seed, index) gives the same start point, any
whole seed is taken, and the checked solves are drawn from the seed."""

import pytest
import torch

from portbench import traffic

MIX = {"n": 1024}
BIG = 2 ** 31 + 12345          # beyond 32 signed bits


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 62])
def test_start_point_repeats_per_seed_and_index(seed):
    a = traffic.start_point(MIX, seed, traffic.WINDOW, 3, "cpu")
    b = traffic.start_point(MIX, seed, traffic.WINDOW, 3, "cpu")
    assert torch.equal(a, b)
    assert abs(float(torch.linalg.vector_norm(a.double())) - 1.0) < 1e-6
    for other in (traffic.start_point(MIX, seed, traffic.WINDOW, 4, "cpu"),
                  traffic.start_point(MIX, seed + 1, traffic.WINDOW, 3,
                                      "cpu"),
                  traffic.start_point(MIX, seed, traffic.WARMUP, 3, "cpu")):
        assert not torch.equal(a, other)


def test_sample_indices_repeat_and_lie_within():
    s = traffic.sample_indices(BIG, 3, 16)
    assert s == traffic.sample_indices(BIG, 3, 16)
    assert len(s) == 3 and all(0 <= i < 16 for i in s)
    draws = {frozenset(traffic.sample_indices(seed, 3, 16))
             for seed in range(20)}
    assert len(draws) > 10


def test_mix_files_are_checked(tmp_path):
    (tmp_path / "portbench" / "traffic").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic" / "bad.json").write_text(
        '{"n": 8, "warmup_solves": 1, "check_solves": 1, "sync_solves": 1}')
    with pytest.raises(ValueError, match="check_within"):
        traffic.load("bad", tmp_path)
    for name in ("n2p24", "n2p26"):
        assert traffic.load(name)["n"] in (2 ** 24, 2 ** 26)
