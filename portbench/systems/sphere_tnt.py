"""The sphere Rayleigh quotient through the port's main path, and its judge.

The system under test is ``optimization_tpu_torch.solvers.tnt.solve`` on
``optimization_tpu_torch.headline.make_problem(n, device, engine,
kappa=, jacobi_power=)``: TNT's outer loop, the trial-step evaluator
``sphere_rayleigh_step`` and, on the card, the subproblem kernel
``csrc/streamed_cg.cu`` (``engine="streamed"``; the CPU tests take the
kernel's plain version, ``"streamed_reference"``).

A solve in f32 and one in float64 part ways within a few outer iterations
at these condition numbers (a step accepted on one side is rejected on the
other), so the judge follows the program step by step from the program's
own iterates.  A sampled solve is recorded as it runs in the window: every
call of the trial-step evaluator, with the iterate x_k, the subproblem
engine's step s_k and the stated f and gradient at the retracted trial
point, the engine's stated predicted decrease dm_k, plus the solve's
radius and gain-ratio traces and its status.  The float64 reference
(``reference/sphere_tnt.py``) then reads, worst over the sample:

- ``model``: at each x_k with the program's radius, the reference's own CG
  step s_ref; |m(s_k) - m(s_ref)| / |m(s_ref)| for the quadratic model m at
  x_k in float64 (the subproblem engine's step is as good a step as the
  reference's); with, folded in, the stated decrease against the model of
  the stated step, |dm_k + m(s_k)| / |m(s_k)|, the program's gain ratio
  against the one its own stated f values and dm_k give, the radius the
  program went on with against the reference's rule applied to that gain
  ratio and step, and a status or iteration count that its rules do not
  give (1);
- ``trial``: the trial-step evaluator's stated f and gradient at x_k + s_k
  against the reference's there (relative), and the next iterate against
  the retracted trial point (or x_k, when the step was rejected), the
  start against x0 and the answer's x, f and gradient against the
  reference's, so the evaluator, the outer loop's update and the answer
  are held.

So every quantity the accept decision and the radius are made from is held
against the reference or against the program's own checked values: a
gain ratio, a stated decrease or a step that is off fails ``model``.

The system's side of the harness's contract (``traffic.py``'s docstring):

- the input of a solve is its start point, a uniform point on S^(n-1):
  ``draw`` takes n normal draws in f32 on the device from their own
  generator, seeded ``traffic.draw_seed(seed, stream, index)``, over their
  norm;
- ``check_mix`` holds the one key of the sphere's mixes, ``n``, the
  problem size of every solve;
- ``judge(config, mix, samples, input_of, device)`` reads ``model`` and
  ``trial`` as above, with the float64 reference at the mix's n;
- ``control`` is the reference in bfloat16 storage, put in the program's
  place (``control.py`` judges its solve as the program's);
- ``read_counters`` gives ``"outer"``, ``"inner"`` (CG iterations of each
  outer iteration), ``"status"`` and ``"f"``, the TNT result's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import traffic
from ..reference import sphere_tnt as ref

NUMBERS = ("model", "trial")
# the program's kernels, as torch.profiler names them
KERNELS = ("streamed_cg_kernel", "streamed_cg_any_kernel")
# the CPU tests' size: n = 4096, six outer iterations, two solves checked
TEST_MIX = {"n": 4096, "warmup_solves": 1, "check_solves": 2,
            "check_within": 2, "sync_solves": 1}
TEST_OVERRIDES = {"max_iterations": 6}


def check_mix(mix: dict) -> None:
    n = mix.get("n")
    if not isinstance(n, int) or isinstance(n, bool) or n < 2:
        raise ValueError(f"a sphere mix states its size n >= 2, not {n!r}")


def draw(config: dict, mix: dict, seed: int, stream: int, index: int,
         device) -> torch.Tensor:
    """A uniform point on S^(n-1): n normal draws on ``device`` from their
    own generator, over their norm, in f32 (the storage every sphere
    configuration states)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.draw_seed(seed, stream, index))
    x = torch.randn(mix["n"], generator=gen, dtype=torch.float32,
                    device=device)
    return x / torch.linalg.vector_norm(x)


def reference_params(config: dict) -> ref.SolveParams:
    return ref.SolveParams(
        max_iterations=config["max_iterations"],
        max_cg=config["max_TPCG_iterations"],
        gradient_tolerance=config["gradient_tolerance"],
        kappa_fgr=config["kappa_fgr"], theta=config["theta"])


def reference_problem(config: dict, n: int, device,
                      storage: torch.dtype = torch.float64):
    return ref.SphereRayleigh(n, config["kappa"], config["jacobi_power"],
                              device, storage=storage)


class System:
    """The program's solve for one configuration at the mix's n."""

    def __init__(self, config: dict, mix: dict, device, engine: str = None):
        from optimization_tpu_torch import headline
        from optimization_tpu_torch.solvers import tnt

        if config["storage"] != "float32":
            raise ValueError("sphere_tnt runs float32 storage")
        self.n = mix["n"]
        self._tnt = tnt
        self.problem = headline.make_problem(
            self.n, device, engine or config["engine"],
            kappa=config["kappa"], jacobi_power=config["jacobi_power"])
        self.params = tnt.TNTParams(
            max_iterations=config["max_iterations"],
            max_TPCG_iterations=config["max_TPCG_iterations"],
            gradient_tolerance=config["gradient_tolerance"],
            kappa_fgr=config["kappa_fgr"], theta=config["theta"],
            relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
            preconditioned_gradient_tolerance=0.0)

    def solve(self, x0: torch.Tensor):
        return self._tnt.solve(self.problem, x0, self.params)

    def solve_recorded(self, x0: torch.Tensor):
        """The same solve, keeping what each trial-step evaluation took and
        stated, and each subproblem's stated predicted decrease (references
        only: nothing is copied)."""
        calls, decreases = [], []
        step_eval, flat_solve = self.problem.step_eval, self.problem.flat_solve

        def recorded_eval(x, h, data):
            out = step_eval(x, h, data)
            calls.append((x, h, out[1], out[2]))
            return out

        def recorded_solve(*args):
            cg = flat_solve(*args)
            decreases.append(cg.predicted_decrease)
            return cg

        res = self._tnt.solve(
            dataclasses.replace(self.problem, step_eval=recorded_eval,
                                flat_solve=recorded_solve), x0, self.params)
        return res, calls, decreases

    def recording_bytes(self, solves: int) -> int:
        """Device memory that ``solves`` recorded solves keep: up to three
        vectors a trial-step evaluation (the iterate, the step, the
        gradient)."""
        return 3 * (self.params.max_iterations + 1) * self.n * 4 * solves

    @staticmethod
    def counters(res) -> tuple:
        """The solve's counts, left on the device until the window ends."""
        return (res.num_iterations, res.inner_iterations, res.status, res.f)

    @staticmethod
    def read_counters(c: tuple) -> dict:
        outer = int(c[0])
        return {"outer": outer, "inner": [int(v) for v in c[1][:outer]],
                "status": int(c[2]), "f": float(c[3])}

    @staticmethod
    def trail(recorded) -> ref.Solve:
        """A recorded solve as the reference states its own."""
        res, calls, decreases = recorded
        k = int(res.num_iterations)
        steps = len(calls) - 1
        return ref.Solve(
            x=res.x, f=float(res.f), g=res.warm_start[1],
            status=int(res.status), num_iterations=k,
            calls=[ref.Call(x, h if i else None, float(f), g)
                   for i, (x, h, f, g) in enumerate(calls)],
            radius=res.trust_region_radius[:steps + 1].double().tolist(),
            rho=res.gain_ratios[:steps].double().tolist(),
            dm=[float(d) for d in decreases[:steps]])


def control(config: dict, mix: dict, x0: torch.Tensor) -> ref.Solve:
    """The control: the reference put in the program's place, its vectors
    stored in bfloat16 (the nearest type below the configuration's f32
    for a computation with no matrix product: TF32 touches nothing here)."""
    problem = reference_problem(config, mix["n"], x0.device, torch.bfloat16)
    return ref.solve(problem, x0, reference_params(config))


def _vgap(u, v) -> float:
    d = u.to(torch.float64) - v.to(torch.float64)
    return float(torch.linalg.vector_norm(d))


def _rel(u: float, v: float) -> float:
    return abs(u - v) / abs(v) if v != 0.0 else abs(u - v)


def _vrel(u, v) -> float:
    return _vgap(u, v) / float(torch.linalg.vector_norm(v.to(torch.float64)))


def _worst(values) -> float:
    """The largest of ``values``; inf if any is not a number (``max``
    would pass a NaN over)."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def readings(trail: ref.Solve, x0: torch.Tensor,
             p64: ref.SphereRayleigh, prm: ref.SolveParams) -> dict:
    """The two numbers for one recorded solve, followed from the program's
    own iterates by the float64 reference (module docstring)."""
    calls = trail.calls
    x_cur, f0, g0 = p64.evaluate(x0.to(torch.float64))
    f_cur = calls[0].f                      # the program's f at x_cur
    model, trial = [0.0], [_rel(calls[0].f, f0), _vrel(calls[0].g, g0)]
    steps = len(calls) - 1
    for k in range(steps):
        c = calls[k + 1]
        trial.append(_vgap(c.x, x_cur))
        x, f, g = p64.evaluate(c.x.to(torch.float64))
        rq, Delta = 2.0 * f, trail.radius[k]
        s = c.h.to(torch.float64)
        s_ref = p64.stpcg(g, x, rq, Delta, prm)[0]
        m_ref, m_prog = p64.model(g, x, rq, s_ref), p64.model(g, x, rq, s)
        rho, dm = trail.rho[k], trail.dm[k]
        model_ok = dm > 0.0
        after = ref.radius_update(Delta, rho, model_ok,
                                  p64.m_norm(s, rq), prm)
        model += [_rel(m_prog, m_ref), _rel(-dm, m_prog),
                  _rel(trail.radius[k + 1], after)]
        if model_ok:
            # the gain ratio as the program's own stated values give it
            model.append(_rel(rho, (f_cur - c.f) / dm))
        xp, fp, gp = p64.evaluate(x + s)
        trial += [_rel(c.f, fp), _vrel(c.g, gp)]
        if model_ok and not math.isnan(rho) and rho > prm.eta1:
            x_cur, f_cur = xp, c.f
        else:
            x_cur = x
    _, f_end, g_end = p64.evaluate(x_cur)
    trial += [_vgap(trail.x, x_cur), _rel(trail.f, f_end),
              _vrel(trail.g, g_end)]
    if not _stops_by_rule(trail, steps, g_end, p64, prm):
        model.append(1.0)
    return {"model": _worst(model), "trial": _worst(trial)}


def _stops_by_rule(trail, steps, g_end, p64, prm) -> bool:
    """The status and the outer-iteration count are what the rules give
    after ``steps`` steps (a solve that stops on its gradient counts the
    iteration whose test fired)."""
    if trail.num_iterations != steps + (trail.status == ref.GRADIENT):
        return False
    if trail.status == ref.ITERATION_LIMIT:
        return steps == prm.max_iterations
    if trail.status == ref.GRADIENT:
        return (math.sqrt(p64.dot(g_end, g_end))
                < prm.gradient_tolerance * (1 + 1e-3))
    if trail.status == ref.TRUST_REGION:
        return trail.radius[steps] < prm.Delta_tolerance
    return False


def judge(config: dict, mix: dict, samples, input_of, device) -> dict:
    """Worst readings over ``samples`` [(index, trail)], each followed
    from its start point ``input_of(index)`` by the float64 reference."""
    p64 = reference_problem(config, mix["n"], device)
    prm = reference_params(config)
    got = [readings(trail, input_of(index), p64, prm)
           for index, trail in samples]
    return {k: _worst([0.0] + [r[k] for r in got]) for k in NUMBERS}

