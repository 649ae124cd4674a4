"""The draws: the same (seed, stream, index) gives the same input, any whole
seed is taken, the sphere's start points are the formula's bit for bit, and
the checked solves are drawn from the seed."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import traffic
from portbench.systems import sphere_tnt

MIX = {"n": 1024}
CONFIG = json.loads((ROOT / "portbench/configs/rayleigh_k1e3.json")
                    .read_text())
BIG = 2 ** 31 + 12345          # beyond 32 signed bits
SEEDS = [0, 7, BIG, 2 ** 62]
STREAMS = [traffic.WINDOW, traffic.WARMUP, traffic.SYNCS, traffic.SAMPLE]


def draw(seed, stream, index, mix=MIX):
    return sphere_tnt.draw(CONFIG, mix, seed, stream, index, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_start_point_repeats_per_seed_and_index(seed):
    a = draw(seed, traffic.WINDOW, 3)
    b = draw(seed, traffic.WINDOW, 3)
    assert torch.equal(a, b)
    assert a.dtype == torch.float32
    assert abs(float(torch.linalg.vector_norm(a.double())) - 1.0) < 1e-6
    for other in (draw(seed, traffic.WINDOW, 4),
                  draw(seed + 1, traffic.WINDOW, 3),
                  draw(seed, traffic.WARMUP, 3)):
        assert not torch.equal(a, other)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("seed", SEEDS)
def test_sphere_draw_is_the_formula_bit_for_bit(seed, stream):
    # the start point as the harness drew it before the systems owned
    # their inputs, written out
    for index in range(5):
        state = np.random.SeedSequence([seed, stream, index]).generate_state(
            1, dtype=np.uint64)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(state[0]) & (2 ** 63 - 1))
        x = torch.randn(1024, generator=gen, dtype=torch.float32)
        want = (x / torch.linalg.vector_norm(x)).to(torch.float32)
        assert torch.equal(draw(seed, stream, index), want)


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
    for name, n in (("n2p24", 2 ** 24), ("n2p26", 2 ** 26)):
        mix = traffic.load(name)
        sphere_tnt.check_mix(mix)
        assert mix["n"] == n
    for bad in ({}, {"n": 0}, {"n": 1.5}, {"n": True}):
        with pytest.raises(ValueError, match="size n"):
            sphere_tnt.check_mix(bad)
