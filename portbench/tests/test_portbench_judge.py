"""``correct``: the port's plain path passes the judge at the cells' own
limits, the control (the reference in bfloat16 storage) fails it, and so
does a run with its timed path broken underneath, once a fault."""

import json

import pytest
import torch

from conftest import ROOT
from portbench import control

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"] if w["traffic"] == "n2p24"]


@pytest.mark.parametrize("cell", CELLS)
def test_plain_path_within_limits_control_beyond(cell, tiny_root):
    from portbench import bench

    limits = bench.load_config(bench.find_cell(SPEC, cell)[1])["limits"]
    rows = control.readings(cell, [3, 2 ** 33 + 1], "cpu",
                            engine="streamed_reference", root=tiny_root)
    for _, prog, ctl in rows:
        assert all(prog[k] <= limits[k] for k in limits), prog
        assert any(ctl[k] > limits[k] for k in limits), ctl


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, measure_cpu):
    line, compared = measure_cpu(cell)
    assert line["correct"], compared
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "compared"
    assert {"solve_s", "setup_s"} <= set(line["metrics"])


def _zero_step(real):
    def solver(g, *args, **kwargs):
        res = real(g, *args, **kwargs)
        return res._replace(s=torch.zeros_like(res.s))
    return solver


def _scaled_decrease(real):
    # every step then reads as a poor one: rejected until the trust region
    # collapses, so the solve leaves its start unchanged
    def solver(g, *args, **kwargs):
        res = real(g, *args, **kwargs)
        return res._replace(predicted_decrease=res.predicted_decrease * 1e6)
    return solver


def _broken_step_eval(fault):
    from optimization_tpu_torch.linalg import flat_cg

    def factory(A_elem, with_init=True):
        real = flat_cg.sphere_rayleigh_step(A_elem, with_init)

        def step_eval(x, h, data):
            out = list(real(x, h, data))
            if fault == "half_batch":
                # the objective's sums over the first half, as a mean
                u = (x + h).double()
                m = u.shape[0] // 2
                au = A_elem(u).double()[:m]
                out[1] = (torch.sum(u[:m] * au) / torch.sum(u[:m] ** 2)).to(
                    out[1].dtype)
            else:
                # the answer altered where the evaluator produces it
                xp = out[0].clone()
                xp[0] += 1e-3
                out[0] = xp / torch.linalg.vector_norm(xp)
            return tuple(out)
        return step_eval
    return factory


SUBPROBLEM_FAULTS = {"state_unchanged": _zero_step,
                     "decrease_scaled": _scaled_decrease}


@pytest.mark.parametrize("fault", ["state_unchanged", "decrease_scaled",
                                   "half_batch", "answer_altered"])
def test_fault_fails_correct(fault, measure_cpu, monkeypatch):
    from optimization_tpu_torch import headline

    if fault in SUBPROBLEM_FAULTS:
        monkeypatch.setattr(headline, "stpcg_flat_streamed_reference",
                            SUBPROBLEM_FAULTS[fault](
                                headline.stpcg_flat_streamed_reference))
    else:
        monkeypatch.setattr(headline, "sphere_rayleigh_step",
                            _broken_step_eval(fault))
    line, compared = measure_cpu(CELLS[0])
    assert not line["correct"], compared
