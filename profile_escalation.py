"""Where the dtype escalation of config12 can hand over, on one CUDA card.

config12 (``benchmarks/config12_escalation.py``): TNT on the sphere
Rayleigh quotient at n = 2^24, A = diag(1 + 999 i/(n - 1)), 400 outer / 100
CG, |grad| <= 1e-3, the streamed CUDA kernel as the subproblem engine of
both stages.  For each start (``headline.initial_point`` seeds 2, 3, 5)
``tnt.solve_escalated`` runs with stage 1 (bf16) stopping at its default
(the caller's tolerance, or its floor: trust-region collapse), at its floor
alone (gradient tolerance 0), and at twice the tolerance.  Prints each
stage's outer and CG iterations, status and |grad|, the kernel's launches,
and the final |grad| re-checked through ``problem.rgrad``.

    python3 profile_escalation.py
"""
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from optimization_tpu_torch import headline as H  # noqa: E402
from optimization_tpu_torch.core.types import TNTStatus  # noqa: E402
from optimization_tpu_torch.kernels.streamed_cg import (  # noqa: E402
    stpcg_flat_streamed)
from optimization_tpu_torch.solvers import tnt  # noqa: E402

N = 1 << 24
TOL = 1e-3


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def stage(res):
    outer = int(res.num_iterations)
    return (f"{outer} outer / {int(res.inner_iterations[:outer].sum())} CG "
            f"{TNTStatus(int(res.status)).name} |grad| "
            f"{float(res.gradfx_norm):.3e}")


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_escalation.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    label = card()
    prob = H.make_problem(N, dev, "streamed")
    params = tnt.TNTParams(max_iterations=400, max_TPCG_iterations=100,
                           gradient_tolerance=TOL,
                           relative_decrease_tolerance=0.0,
                           stepsize_tolerance=0.0,
                           preconditioned_gradient_tolerance=0.0)
    floor = max(params.Delta_tolerance, 1e-6)
    handoffs = (("default", None),
                ("floor", dataclasses.replace(params, gradient_tolerance=0.0,
                                              Delta_tolerance=floor)),
                ("2x tol", dataclasses.replace(
                    params, gradient_tolerance=2 * TOL,
                    Delta_tolerance=floor)))
    for seed in (2, 3, 5):
        x0 = H.initial_point(N, torch.float32, dev, seed)
        for name, low in handoffs:
            stpcg_flat_streamed.launches = 0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            esc = tnt.solve_escalated(prob, x0, params, low_params=low)
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            g = float(torch.linalg.vector_norm(prob.rgrad(esc.x)))
            print(f"seed {seed}, stage 1 to {name}: {secs:.3f} s, kernel "
                  f"launches {stpcg_flat_streamed.launches}; bf16 "
                  f"{stage(esc.stage_low)}; f32 {stage(esc.stage_high)}; "
                  f"rgrad {g:.4e} [{label}]", flush=True)


if __name__ == "__main__":
    main()
