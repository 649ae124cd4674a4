"""bf16 -> f32 dtype escalation (``tnt.solve_escalated``; counterpart of
``examples/dtype_escalation.py``).

Runs the bf16 storage tier until its trust-region-collapse floor detector
fires (or it meets the tolerance), promotes the carry to f32 with the
zero-tangent re-retraction back onto the sphere, and finishes to the
|grad| tolerance: the Rayleigh quotient of diag(1 + b i) on S^(n-1),
n = 2^16.  The subproblems run in the flat pair engine (``flat_qm`` =
``sphere_rayleigh_flat``), eager torch; the trial step is
``kernels.sphere_step.sphere_rayleigh_step`` of the diagonal's descriptor,
so on a CUDA device both stages launch ``csrc/sphere_step.cu`` for it.
Both stages store bf16 / f32 on any device.
Run:  python -m optimization_tpu_torch.examples.dtype_escalation [--device cpu]
"""

from __future__ import annotations

import torch

from optimization_tpu_torch import RiemannianProblem
from optimization_tpu_torch.examples import _common as C
from optimization_tpu_torch.kernels.sphere_step import (DiagonalElem,
                                                        sphere_rayleigh_step)
from optimization_tpu_torch.kernels.streamed_cg import AffineDiagonal
from optimization_tpu_torch.linalg.flat_cg import sphere_rayleigh_flat
from optimization_tpu_torch.manifolds import sphere
from optimization_tpu_torch.solvers import tnt

PARAMS = tnt.TNTParams(
    max_iterations=200, max_TPCG_iterations=25, gradient_tolerance=2e-3,
    relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
    preconditioned_gradient_tolerance=0.0)


def make_problem(n, dev) -> RiemannianProblem:
    M = sphere()
    A_elem = DiagonalElem(AffineDiagonal(1.0, 999.0 / (n - 1)), n, dev)

    def f(x, dd):
        return torch.dot(x.to(torch.float32), A_elem(x))

    def grad(x, dd):
        return M.proj(x, (2.0 * A_elem(x)).to(x.dtype))

    def flat_qm(x, dd, aux=None):
        rq = aux.rq if aux is not None else None
        A0, U, B, _ = sphere_rayleigh_flat(x, A_elem, rq=rq)
        return A0, U, B, (aux.init if aux is not None else None)

    return RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm,
                             step_eval=sphere_rayleigh_step(A_elem))


def run(device, dtype=None, data=None) -> dict:
    """``data``: ``{"x0": (n,) f32 start}`` (default: n = 2^16 drawn from a
    generator seeded 0).  ``dtype`` is unused: the stages are bf16 and
    f32."""
    dev = C.device_of(device)
    x0 = C.take(data, "x0", lambda: sphere().rand(
        C.generator(dev, 0), 1 << 16, dtype=torch.float32, device=dev))
    problem = make_problem(x0.shape[0], dev)
    res, wall = C.timed(lambda: tnt.solve_escalated(
        problem, x0, PARAMS, data=None, low_dtype=torch.bfloat16,
        high_dtype=torch.float32), dev)
    lo, hi = res.stage_low, res.stage_high
    return dict(switch_iteration=int(res.switch_iteration),
                low_status=int(lo.status), low_iters=int(lo.num_iterations),
                low_f=float(lo.f), high_iters=int(hi.num_iterations),
                high_f=float(hi.f), f=float(res.f),
                grad_norm=float(res.gradfx_norm), status=int(res.status),
                tol=PARAMS.gradient_tolerance, wall=wall)


def accept(out):
    """The JAX example's check: the escalated solve met the tolerance."""
    assert out["grad_norm"] <= out["tol"]


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev, _ = C.setup(args.device)
    r = run(dev)
    print(f"escalated: {r['switch_iteration']} bf16 outer "
          f"(stage-1 status {r['low_status']}: GRADIENT=1 means bf16 "
          f"already met the tolerance, TRUST_REGION=5 is the floor "
          f"detector) + {r['high_iters']} f32 outer -> "
          f"f = {r['f']:.6f}, |g| = {r['grad_norm']:.2e} "
          f"(tol {r['tol']}), status {r['status']} [{r['wall']:.1f}s]")
    # the bf16 stage did the bulk of the march; f32 only finishes
    print(f"  stage objectives: bf16 {r['low_f']:.6f} -> "
          f"f32 {r['high_f']:.6f} (exact smallest eigenvalue 1.0)")
    accept(r)
    return r


if __name__ == "__main__":
    main()
