#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the repository root:  python3 chip_smoke.py

Phases, each printed on its own lines; any failure ends the run with a
non-zero exit and no result line:

1. device: a CUDA device is required (there is no CPU path); prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` and
   turns TF32 off;
2. build: compiles ``optimization_tpu_torch/csrc/streamed_cg.cu`` and
   ``csrc/fused.cu`` with nvcc from this checkout, both at once, and prints
   each build's seconds;
3. kernel parity: ``stpcg_flat_streamed`` on the card against its plain
   PyTorch version on the same inputs, at n = 2^20 and a ragged n, over
   storage dtype x body x init x Delta x fixture, then its preconditioned
   variant over P (the shifted-Jacobi powers e = 1/2 and 1/4, a stored P
   unrelated to the diagonal) x storage dtype x body x Delta, each plus a
   bitwise repeat;
4. main path: the headline TNT solve (``optimization_tpu_torch/headline.py``)
   at n = 2^24 in both tiers, the f32 tier through the kernel (its launch
   count checked against the subproblems solved), then the f32 tier again
   with the plain version in the kernel's place;
5. fused kernel parity: ``cg_dots``, ``axpy_selfdot``,
   ``diag_stencil_matvec`` and ``affine_stencil_matvec`` against their
   plain versions (and the reductions against a float64 sum) at
   n = 2^24, 999,999 and 100 in f32 and bf16, plus bitwise repeats;
6. the stencil path: ``euclidean_tnt(fused_dots=True)`` on the SPD
   quadratic 1/2 <x, A x> - <c, x>, A = diag(d) + 2I - S - S', at
   n = 2^24 in f32, with A from ``diag_stencil_matvec``, then from
   ``affine_stencil_matvec``, then the plain route (generic STPCG dots,
   the stencil's plain version); launch counts, the gradient reached and
   the agreement of f checked; then each fused kernel timed against its
   plain version at n = 2^24 f32;
7. ``gram_pair`` against its plain version (and a float64 product) at
   100,000 x 48, 999 x 30, 16 x 10,000 x 48 and 5,000 x 96 (the k cap),
   with BS distinct and with BS = S (the route that reads S once),
   ``stream3_probe`` at n = 2^24, 999,999 and 100, f32 and bf16, bitwise
   repeats; gram_pair timed at 100,000 x 48 (BS distinct and BS = S, the
   LOBPCG call) and 16 x 10,000 x 48 in f32 and bf16 beside its plain
   version, the one-call library product (``torch.matmul``) and its bound;
   stream3_probe's GB/s at n = 2^24 f32 is the measured bandwidth ceiling;
8. the eigensolver path: ``lobpcg`` on config3 (m = 1e5, nx = 16, nev = 5,
   A = diag(linspace(1, m)), the exact inverse preconditioner; a converged
   f32 solve with ``rr_method`` "eigh" then "chol", gated at
   max|theta - (1..5)| < 5e-2, nev converged, pencil consistent; the f64
   matmul route as the reference), ``lobpcg_fleet`` on config10 (16 x
   m = 1e4, "chol"; every instance converged and consistent); the
   gram_pair launches checked against 1 + iterations per solve; block it/s
   of fixed-iteration runs; host syncs per iteration;
9. config13 at full width (``benchmarks/config13_streamed_prec.py``:
   n = 2^24, kappa = 1e5, P = (|2a - rq| + 1)^(-1/4), 30 outer / 100 CG):
   the eager flat engine through ``flat_prec`` and the preconditioned
   kernel through ``flat_solve``, gated on f*, inner and outer counts and
   the kernel's launches; the kernel timed on one subproblem beside its
   plain version and its bound; the kernel arm again through
   ``drive(tnt, chunk_iterations=10)``;
10. config12 at full width (``benchmarks/config12_escalation.py``: n = 2^24,
   kappa = 1000, |grad| <= 1e-3): ``solve_escalated`` (bf16 to its floor,
   then f32 to 1e-3, the kernel in both stages; its launches checked
   against both stages' subproblems) beside pure f32 with
   ``floor_acceptance``;
11. least squares on the card: ``euclidean_tnls`` on the sinusoid fit of
   tests/test_tnls.py with m = 2^24 samples in f32, noise from a seeded
   generator on the card, gated on beta and |F|; host reads counted;
12. each streaming kernel's GB/s as a fraction of the measured ceiling, the
   kernel table as one JSON line (each kernel's launches on its path, its
   error, its time, its plain version's, its bound and the library call's,
   null where no single PyTorch call computes the function), then the
   result line ``{"ok": true, "device": {...}}``.

Every time printed is labelled with the card's name and power limit.  A
bound is the least time the card could take for the same work: the larger
of the bytes the function must move (each input read once, each output
written once) over 3.35 TB/s and its operations over the peak for their
type (67 TFLOP/s f32, 495 TF32, 989 bf16; NVIDIA's H100 SXM data sheet).
"""

import collections
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

N_PARITY = (1 << 20, 999_999)       # the second is not a multiple of 1024
N_MAIN = 1 << 24
SHORT = 10                          # CG iterations: see check_parity
SOURCES = ("streamed_cg", "fused")
N_FUSED = (1 << 24, 999_999, 100)   # fused kernel parity sizes
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}


def bound(nbytes, flops, peak="f32"):
    """(ms, "bytes" or "operations"): the least time for nbytes of device
    memory traffic and flops at the data sheet's peak for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def card_label(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out, f"{torch.cuda.get_device_name(0)} @ {out.splitlines()[0]}"


PREC_FORMS = ("jacobi", "quarter", "stored")


def prec_of(torch, form, g, rq, diag):
    """(prec_chunk, prec) on the fixture's diagonal: the shifted-Jacobi
    power (|2a - rq| + 1)^(-e), e = 1/2 or 1/4, generated in the kernel, or
    a stored P unrelated to a, (1 + (i mod 13)/4)^(-1/2) (the P of
    tests/test_torch_streamed_cg.py): a kernel that generated p in place of
    reading it would disagree."""
    from optimization_tpu_torch.kernels.streamed_cg import JacobiPower

    n, dev = g.shape[0], g.device
    if form == "stored":
        i = torch.arange(n, device=dev)
        p = torch.rsqrt(1.0 + 0.25 * (i % 13).float())
        return p, (lambda v: v * p)
    desc = JacobiPower(1.0, 0.5 if form == "jacobi" else 0.25)
    return desc, desc.map(diag, rq, n, dev)


def permuted_plain(torch, args, kwargs, diag):
    """The plain version on the same subproblem with its indices permuted
    (a stored diagonal and a stored P of the same values): the same
    mathematics, its sums in another order.  Returns its iteration count
    and its step, unpermuted."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        sphere_rayleigh_streamed, stpcg_flat_streamed_reference)

    g, x, B, Delta, aux = args
    n, dev = g.shape[0], g.device
    perm = torch.randperm(n, device=dev, generator=torch.Generator(
        device=dev).manual_seed(1))
    a0c, weights, _ = sphere_rayleigh_streamed(
        diag.values(n, dev)[perm].contiguous())
    p = kwargs["prec_chunk"][perm].contiguous()
    res = stpcg_flat_streamed_reference(
        g[perm].contiguous(), x[perm].contiguous(), B, Delta, aux,
        **dict(kwargs, a0_chunk=a0c, weights=weights, prec_chunk=p,
               prec=lambda v: v * p))
    s = torch.empty_like(res.s)
    s[perm] = res.s
    return int(res.num_iterations), s


def fixture(torch, kind, n, dtype, dev):
    """(g, x, B, rq, a_diag, solver kwargs) on the card: ``neg`` is the true
    sphere Hessian at a random point with spread 200 (indefinite:
    negative-curvature exits), ``pd`` the positive-definite operator of
    rq = 0.5 and B_pd (many interior iterations); as in
    tests/test_streamed_cg.py."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        AffineDiagonal, sphere_rayleigh_streamed)

    spread = 200.0 if kind == "neg" else 25.0
    diag = AffineDiagonal(1.0, spread / (n - 1))
    gen = torch.Generator(device=dev).manual_seed(3 if kind == "neg" else 7)
    x = torch.randn(n, generator=gen, device=dev)
    x = x / torch.linalg.vector_norm(x)
    a = diag.values(n, dev)
    y = 2.0 * a * x
    rq = torch.dot(x, y)
    g = y - rq * x
    _, _, B_fn = sphere_rayleigh_streamed(diag)
    if kind == "neg":
        B = B_fn(rq)
        kw = dict(max_iterations=500, kappa_fgr=1e-8, theta=0.999)
    else:
        rq = torch.tensor(0.5, device=dev)
        B = torch.tensor([[1.0, 0.2], [0.2, 0.5]], device=dev)
        kw = dict(max_iterations=400, kappa_fgr=1e-3, theta=0.9)
    return g.to(dtype), x.to(dtype), B, rq, diag, kw


def init_group(torch, g, x, B, rq, diag):
    """The FlatCGInit dot group for (g, x, B, rq), computed by the port's
    flat engine helper (what TNT's trial-step evaluator threads)."""
    from optimization_tpu_torch.linalg.flat_cg import flat_init_dots

    a = diag.values(g.shape[0], g.device)
    A_elem = lambda v: a * v.to(torch.float32)
    A0 = lambda v: 2.0 * A_elem(v) - rq * v.to(torch.float32)
    U = (x, (x, lambda v: 2.0 * A_elem(v)))
    return flat_init_dots(g, A0, U, B)


def check_parity(torch, res, ref, dtype, label, dit=None):
    """Kernel vs plain version, at the tolerances of tests/test_streamed_cg.py
    with the step held norm to norm, |s - s_ref| <= tol |s_ref| (2-norms;
    the worst case measured on the card is 7.5e-5 in f32, 1.7e-4 in bf16).
    f32, both runs within SHORT iterations (test_matches_flat_engine): equal
    counts, s within 3e-5, M-norm rtol 2e-5, predicted decrease rtol 2e-3
    (Delta = 1e6 assembles it from ~1e12-scale cancellations).  f32, longer
    runs (test_interior_multi_iteration_parity): the M-norm and the model
    value are scalar recurrences whose f32 rounding grows with the count,
    and the two runs sum in other orders, so CG may stop one step apart at
    the truncation threshold: counts within 1 (or ``dit``), s within 2e-3,
    M-norm and predicted decrease rtol 1e-3.  bf16 storage
    (test_bf16_storage_parity): counts within 3, s within 3e-2, M-norm rtol
    3e-2.  Returns max |s - s_ref|."""
    ki, kr = int(res.num_iterations), int(ref.num_iterations)
    s, s_ref = res.s.float(), ref.s.float()
    scale = max(float(torch.linalg.vector_norm(s_ref)), 1e-9)
    err = float((s - s_ref).abs().max())
    rel = float(torch.linalg.vector_norm(s - s_ref)) / scale
    mn, mn_ref = float(res.update_step_M_norm), float(ref.update_step_M_norm)
    pd, pd_ref = float(res.predicted_decrease), float(ref.predicted_decrease)
    if dtype == torch.bfloat16:
        ok = (abs(ki - kr) <= 3 and rel <= 3e-2
              and abs(mn - mn_ref) <= 3e-2 * abs(mn_ref))
    elif max(ki, kr) <= SHORT and dit is None:
        ok = (ki == kr and rel <= 3e-5
              and abs(mn - mn_ref) <= 2e-5 * abs(mn_ref)
              and abs(pd - pd_ref) <= 2e-3 * abs(pd_ref) + 1e-8)
    else:
        ok = (abs(ki - kr) <= (dit or 1) and rel <= 2e-3
              and abs(mn - mn_ref) <= 1e-3 * abs(mn_ref)
              and abs(pd - pd_ref) <= 1e-3 * abs(pd_ref))
    ok = ok and math.isfinite(err) and math.isfinite(rel)
    print(f"  {'ok  ' if ok else 'FAIL'} {label}: it {ki}/{kr} "
          f"|ds|/|s| {rel:.2e} (max|ds|/|s| {err / scale:.2e}) M-norm "
          f"{mn:.6g}/{mn_ref:.6g} dm {pd:.6g}/{pd_ref:.6g}", flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{label}")
    return err


def parity_phase(torch, dev):
    from optimization_tpu_torch.kernels.streamed_cg import (
        sphere_rayleigh_streamed, stpcg_flat_streamed,
        stpcg_flat_streamed_reference)

    print("phase 3: kernel vs plain version on the card", flush=True)
    cases = 0
    for n, dtype, kind, body, with_init in itertools.product(
            N_PARITY, (torch.float32, torch.bfloat16), ("neg", "pd"),
            ("pair", "single"), (False, True)):
        g, x, B, rq, diag, kw = fixture(torch, kind, n, dtype, dev)
        a0c, weights, _ = sphere_rayleigh_streamed(diag)
        init = init_group(torch, g, x, B, rq, diag) if with_init else None
        # a huge Delta is a knife-edge in bf16 (test_bf16_storage_parity):
        # bf16 takes Delta = 1 in its place
        deltas = ((1e6, 0.5, 0.02) if dtype == torch.float32
                  else (1.0, 0.5, 0.02))
        for Delta in deltas:
            args = (g, x, B, Delta, (rq,))
            kwargs = dict(a0_chunk=a0c, weights=weights, body_kind=body,
                          init=init, **kw)
            res = stpcg_flat_streamed(*args, **kwargs)
            ref = stpcg_flat_streamed_reference(*args, **kwargs)
            torch.cuda.synchronize()
            check_parity(torch, res, ref, dtype,
                         f"n={n} {str(dtype)[6:]} {kind} {body} "
                         f"init={int(with_init)} Delta={Delta:g}")
            cases += 1
    # bitwise repeat: no atomics, fixed reduction order
    g, x, B, rq, diag, kw = fixture(torch, "pd", N_PARITY[0], torch.float32,
                                    dev)
    a0c, weights, _ = sphere_rayleigh_streamed(diag)
    r1 = stpcg_flat_streamed(g, x, B, 1e6, (rq,), a0_chunk=a0c,
                             weights=weights, **kw)
    r2 = stpcg_flat_streamed(g, x, B, 1e6, (rq,), a0_chunk=a0c,
                             weights=weights, **kw)
    same = (torch.equal(r1.s, r2.s)
            and all(torch.equal(u, v) for u, v in zip(r1[1:], r2[1:])))
    print(f"  {'ok  ' if same else 'FAIL'} bitwise repeat "
          f"(it {int(r1.num_iterations)})", flush=True)
    if not same:
        raise AssertionError("two runs of one subproblem differ")

    # the preconditioned variant: P folded in (ghat = p g, a0hat = p^2 a0,
    # uhat = p u), same tolerances (the kernel's round-to-nearest rsqrt and
    # torch.rsqrt may differ in the last bit of p: inside them).  The
    # stored P, unrelated to a, conditions P H P worse: CG runs ~50
    # iterations and stops where |r| creeps past the truncation target, so
    # the order of the sums alone moves the count.  The plain version on the
    # same problem with its indices permuted shows by how much (2 at
    # n = 2^20 and 999,999 on the card); the kernel's count is held within
    # 3, its step and M-norm at the long-run tolerances.
    for n, dtype, form, body in itertools.product(
            N_PARITY, (torch.float32, torch.bfloat16), PREC_FORMS,
            ("pair", "single")):
        g, x, B, rq, diag, kw = fixture(torch, "pd", n, dtype, dev)
        a0c, weights, _ = sphere_rayleigh_streamed(diag)
        pc, pmap = prec_of(torch, form, g, rq, diag)
        deltas = ((1e6, 0.5, 0.02) if dtype == torch.float32
                  else (1.0, 0.5, 0.02))
        for Delta in deltas:
            args = (g, x, B, Delta, (rq,))
            kwargs = dict(a0_chunk=a0c, weights=weights, body_kind=body,
                          prec_chunk=pc, prec=pmap, **kw)
            res = stpcg_flat_streamed(*args, **kwargs)
            ref = stpcg_flat_streamed_reference(*args, **kwargs)
            torch.cuda.synchronize()
            label = (f"prec {form} n={n} {str(dtype)[6:]} {body} "
                     f"Delta={Delta:g}")
            stored = form == "stored"
            check_parity(torch, res, ref, dtype, label,
                         dit=3 if stored else None)
            if stored and dtype == torch.float32 and Delta == 1e6:
                kp, sp = permuted_plain(torch, args, kwargs, diag)
                norm = torch.linalg.vector_norm
                print(f"       the plain version permuted: it {kp}/"
                      f"{int(ref.num_iterations)}, |ds|/|s| "
                      f"{float(norm(sp - ref.s) / norm(ref.s)):.2e}",
                      flush=True)
            cases += 1
    g, x, B, rq, diag, kw = fixture(torch, "pd", N_PARITY[0], torch.float32,
                                    dev)
    a0c, weights, _ = sphere_rayleigh_streamed(diag)
    pc, pmap = prec_of(torch, "quarter", g, rq, diag)
    r1, r2 = (stpcg_flat_streamed(g, x, B, 1e6, (rq,), a0_chunk=a0c,
                                  weights=weights, prec_chunk=pc, prec=pmap,
                                  **kw) for _ in range(2))
    same = (torch.equal(r1.s, r2.s)
            and all(torch.equal(u, v) for u, v in zip(r1[1:], r2[1:])))
    print(f"  {'ok  ' if same else 'FAIL'} bitwise repeat, preconditioned "
          f"(it {int(r1.num_iterations)})", flush=True)
    if not same:
        raise AssertionError("two runs of one preconditioned subproblem "
                             "differ")
    print(f"phase 3: {cases} cases + 2 bitwise repeats passed", flush=True)


def time_ms(torch, fn, reps):
    """Mean milliseconds per call by CUDA events (after one warm call).

    A spin kernel (``torch.cuda._sleep``) holds the card while the host
    enqueues all the calls, so the events time the device's work, not the
    host's launch overhead: a fused kernel's wrapper spends about as long
    on the host as its kernel on the card.  If the card reached the start
    event before the host had enqueued the last call, the spin is doubled
    and the timing repeated (at most three times; a function that reads
    back to the host, like the streamed kernel's plain version, is timed
    as it runs)."""
    fn()
    cycles = 20_000_000
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            break
        cycles *= 2
    return start.elapsed_time(stop) / reps


def main_path_phase(torch, dev, label):
    from optimization_tpu_torch import headline as H
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.kernels.streamed_cg import (
        AffineDiagonal, sphere_rayleigh_streamed, stpcg_flat_streamed,
        stpcg_flat_streamed_reference)

    print(f"phase 4: headline TNT at n = 2^24 [{label}]", flush=True)
    n = N_MAIN
    f32_params = H.tier_params(1e-5)
    prob = H.make_problem(n, dev, "streamed")

    # the kernel at the main path's shape: the subproblem the f32 tier
    # solves at its 11th outer iteration (the first ones exit on negative
    # curvature within a CG step or two)
    x0 = H.initial_point(n, torch.float32, dev, 3)
    k_mid = 10
    mid = H.run_tier(prob, x0, H.tier_params(1e-5, max_iterations=k_mid))
    x, _, g, _, aux = prob.step_eval(mid.result.x, torch.zeros_like(x0),
                                     None)
    Delta = mid.result.trust_region_radius[k_mid]
    a0c, weights, B_fn = sphere_rayleigh_streamed(
        AffineDiagonal(1.0, 999.0 / (n - 1)))
    kw = dict(a0_chunk=a0c, weights=weights, max_iterations=50,
              kappa_fgr=0.1, theta=0.5, init=aux.init)
    args = (g, x, B_fn(aux.rq), Delta, (aux.rq,))
    res = stpcg_flat_streamed(*args, **kw)
    ref = stpcg_flat_streamed_reference(*args, **kw)
    err = check_parity(torch, res, ref, torch.float32,
                       f"main-path subproblem n=2^24 f32 (outer "
                       f"{k_mid + 1})")
    its = int(res.num_iterations)
    ms = time_ms(torch, lambda: stpcg_flat_streamed(*args, **kw), 10)
    plain_ms = time_ms(torch,
                       lambda: stpcg_flat_streamed_reference(*args, **kw), 3)
    gbytes = 6 * its * n * 4 / 1e9
    print(f"  subproblem ({its} CG it): kernel {ms:.3f} ms "
          f"({its / ms * 1e3:.0f} CG it/s, ~{gbytes / ms * 1e3:.0f} GB/s "
          f"at 6n words an iteration), plain {plain_ms:.3f} ms "
          f"[{label}]", flush=True)

    # warm-up of the bf16 tier (the f32 tier's ran above)
    H.run_tier(H.make_problem(n, dev, "flat"),
               H.initial_point(n, torch.bfloat16, dev, 2),
               H.tier_params(0.0, max_iterations=1))

    # ---- the main path's run: counts start at 0 here ----
    stpcg_flat_streamed.launches = 0
    f32 = H.run_tier(prob, x0, f32_params)
    launches = stpcg_flat_streamed.launches
    bf16 = H.run_tier(H.make_problem(n, dev, "flat"),
                      H.initial_point(n, torch.bfloat16, dev, 3),
                      H.tier_params(0.0))
    launches_total = stpcg_flat_streamed.launches
    # ---- end of the main path's run ----

    conv = int(f32.result.status) in (TNTStatus.GRADIENT,
                                      TNTStatus.PRECONDITIONED_GRADIENT)
    subproblems = f32.outer - int(conv)
    for name, t in (("f32 (CUDA kernel)", f32), ("bf16 (flat engine)", bf16)):
        print(f"  tier {name}: {t.outer} outer / {t.inner} CG in "
              f"{t.seconds:.3f} s = {t.cg_per_s:.0f} CG it/s, "
              f"f* = {t.fstar:.6f}, status {int(t.result.status)} "
              f"[{label}]", flush=True)
    if launches != subproblems or launches_total != subproblems:
        raise AssertionError(f"kernel launches {launches} (total "
                             f"{launches_total}) != subproblems "
                             f"{subproblems} of the f32 tier")
    print(f"  kernel launches in the f32 solve: {launches} = subproblems",
          flush=True)
    for name, t in (("f32", f32), ("bf16", bf16)):
        xs = t.result.x.float()
        nx = float(torch.linalg.vector_norm(xs))
        if not (math.isfinite(t.fstar) and t.fstar < 1.1
                and xs.shape == (n,) and bool(torch.isfinite(xs).all())
                and abs(nx - 1.0) < 1e-2):
            raise AssertionError(f"{name} tier: f* = {t.fstar}, |x| = {nx}")

    ref_run = H.run_tier(H.make_problem(n, dev, "streamed_reference"),
                         x0, f32_params)
    print(f"  tier f32 (plain version): {ref_run.outer} outer / "
          f"{ref_run.inner} CG in {ref_run.seconds:.3f} s = "
          f"{ref_run.cg_per_s:.0f} CG it/s, f* = {ref_run.fstar:.6f} "
          f"(kernel run {f32.seconds:.3f} s) [{label}]", flush=True)
    if (ref_run.outer != f32.outer
            or abs(ref_run.fstar - f32.fstar) > 1e-3 * abs(ref_run.fstar)):
        raise AssertionError("f32 tier: kernel and plain version disagree")

    # 6n words an iteration; ~20 f32 FLOP an element an iteration (the
    # operator, the dots, the three updates)
    bound_ms, bound_by = bound(gbytes * 1e9, 20.0 * n * its)
    print(f"  subproblem bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.3f} of it [{label}]", flush=True)
    return {"name": "stpcg_flat_streamed", "route": "cuda",
            "source": "optimization_tpu_torch/csrc/streamed_cg.cu",
            "replaces": "optimization_tpu/kernels/streamed_cg.py:95",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, gbytes / ms * 1e3


FUSED_TOLERANCES = """\
  tolerances, kernel against plain version (and the reductions against a
  float64 sum of the same inputs on the card):
    cg_dots, and the norm of axpy_selfdot: 1e-5 sum|terms| -- f32 sums in
      other orders (the kernel runs <= 64 terms per thread then adds in
      double, the plain version takes torch's reduction tree); in bf16
      also 2^-7 |sum|: both round the result to bf16, maybe to neighbours;
      the bf16 norm 2^-5 sum(|a x| + |y|)^2, as the vectors differ (next);
    axpy_selfdot out: f32 2^-22 (|a x| + |y|) -- the same two roundings in
      the same order; bf16 2^-7 (|a x| + |y|) -- the plain version rounds
      a x to bf16 before the add (the JAX contract), the kernel rounds
      once on store;
    stencils: f32 2^-22 (|(d+2) v| + |v[i+1]| + |v[i-1]|) |scale| -- the
      same roundings in the same order; bf16 2^-5 of the same -- the plain
      version rounds after each of its five bf16 operations, the kernel
      once on store.
"""


def check_close(torch, label, got, ref, tol):
    """Elementwise |got - ref| <= tol (f64), all finite; prints and raises
    on failure; returns max |got - ref|."""
    err = (got.double() - ref.double()).abs()
    ok = bool(torch.isfinite(got.double()).all()) and bool((err <= tol).all())
    ratio = float((err / tol.clamp_min(1e-300)).max())
    print(f"  {'ok  ' if ok else 'FAIL'} {label}: max|err| "
          f"{float(err.max()):.3e}, max err/tol {ratio:.3f}", flush=True)
    if not ok:
        raise AssertionError(f"fused kernel disagrees: {label}")
    return float(err.max())


def fused_parity_phase(torch, dev):
    """Each fused kernel against its plain version on the same card inputs;
    returns {kernel name: max |err| at the path's shape (first size, f32)}."""
    from optimization_tpu_torch.kernels import fused as F
    from optimization_tpu_torch.kernels.streamed_cg import AffineDiagonal

    print("phase 5: fused kernels vs plain versions on the card", flush=True)
    print(FUSED_TOLERANCES, end="", flush=True)
    errs = {}
    cases = 0
    for n, dtype in itertools.product(N_FUSED,
                                      (torch.float32, torch.bfloat16)):
        bf16 = dtype == torch.bfloat16
        tag = f"n={n} {str(dtype)[6:]}"
        gen = torch.Generator(device=dev).manual_seed(n % 997)
        p, hp, r = (torch.randn(n, generator=gen, device=dev).to(dtype)
                    for _ in range(3))
        d = (1.0 + 999.0 * torch.rand(n, generator=gen, device=dev)).to(dtype)
        P, HP, R = p.double(), hp.double(), r.double()
        e = {}

        got = torch.stack(F.cg_dots(p, hp, r))
        ref = torch.stack(F.cg_dots_reference(p, hp, r))
        pairs = ((P, HP), (HP, HP), (P, P), (P, R))
        exact = torch.stack([torch.sum(u * v) for u, v in pairs])
        tol = 1e-5 * torch.stack([torch.sum((u * v).abs()) for u, v in pairs])
        if bf16:
            tol = tol + 2.0 ** -7 * exact.abs()
        e["cg_dots"] = check_close(torch, f"cg_dots {tag}", got, ref, tol)
        check_close(torch, f"cg_dots {tag} vs f64 sum", got, exact, tol)

        alpha = torch.tensor(0.37, device=dev)     # 0-d on the card
        out, dot = F.axpy_selfdot(alpha, hp, r)
        out_ref, dot_ref = F.axpy_selfdot_reference(alpha, hp, r)
        terms = (alpha.to(dtype).double() * HP).abs() + R.abs()
        e["axpy_selfdot"] = check_close(
            torch, f"axpy_selfdot out {tag}", out, out_ref,
            (2.0 ** -7 if bf16 else 2.0 ** -22) * terms)
        O2 = torch.sum(out.double() ** 2)
        tol = 1e-5 * O2 + (2.0 ** -5 * torch.sum(terms ** 2) if bf16 else 0)
        check_close(torch, f"axpy_selfdot norm {tag}", dot, dot_ref, tol)
        check_close(torch, f"axpy_selfdot norm {tag} vs f64 sum", dot, O2,
                    1e-5 * O2 + (2.0 ** -7 * O2 if bf16 else 0))

        b = 999.0 / (n - 1)
        z = P.new_zeros(1)
        near = torch.cat([P[1:], z]).abs() + torch.cat([z, P[:-1]]).abs()
        for name, got, ref, dd in (
                ("diag_stencil_matvec", F.diag_stencil_matvec(d, p, scale=0.5),
                 F.diag_stencil_matvec_reference(d, p, scale=0.5), d.double()),
                ("affine_stencil_matvec",
                 F.affine_stencil_matvec(p, a=1.0, b=b, scale=0.5),
                 F.affine_stencil_matvec_reference(p, a=1.0, b=b, scale=0.5),
                 AffineDiagonal(1.0, b).values(n, dev).double())):
            terms = (((dd + 2.0) * P).abs() + near) * 0.5
            e[name] = check_close(torch, f"{name} {tag}", got, ref,
                                  (2.0 ** -5 if bf16 else 2.0 ** -22) * terms)
        cases += 1
        if not errs:
            errs = e

    # bitwise repeats: fixed reduction order, no float atomics
    gen = torch.Generator(device=dev).manual_seed(1)
    p, hp, r = (torch.randn(N_FUSED[0], generator=gen, device=dev)
                for _ in range(3))
    alpha = torch.tensor(0.37, device=dev)
    same_dots = torch.equal(torch.stack(F.cg_dots(p, hp, r)),
                            torch.stack(F.cg_dots(p, hp, r)))
    (o1, d1), (o2, d2) = (F.axpy_selfdot(alpha, hp, r),
                          F.axpy_selfdot(alpha, hp, r))
    same_axpy = torch.equal(o1, o2) and torch.equal(d1, d2)
    for name, same in (("cg_dots", same_dots), ("axpy_selfdot", same_axpy)):
        print(f"  {'ok  ' if same else 'FAIL'} bitwise repeat {name} "
              f"n={N_FUSED[0]}", flush=True)
        if not same:
            raise AssertionError(f"two runs of {name} differ")
    print(f"phase 5: {cases} size x dtype cases of 4 kernels + 2 bitwise "
          f"repeats passed", flush=True)
    return errs


FUSED_REPLACES = {"cg_dots": 86, "axpy_selfdot": 130, "gram_pair": 185,
                  "diag_stencil_matvec": 279, "stream3_probe": 325,
                  "affine_stencil_matvec": 370}


def stencil_path_phase(torch, dev, label, errs):
    """``euclidean_tnt(fused_dots=True)`` on the stencil quadratic at full
    width, through the stored and the affine stencil kernels, then the
    plain route; then the fused kernels timed at the path's shape.  Returns
    the kernels' JSON entries and their GB/s."""
    from optimization_tpu_torch import euclidean_tnt
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.kernels import fused as F
    from optimization_tpu_torch.kernels.streamed_cg import AffineDiagonal
    from optimization_tpu_torch.solvers.tnt import TNTParams

    n = N_MAIN
    print(f"phase 6: euclidean_tnt(fused_dots=True), 1/2 <x, A x> - <c, x>, "
          f"n = {n} f32 [{label}]", flush=True)
    b = 999.0 / (n - 1)
    d = AffineDiagonal(1.0, b).values(n, dev)     # 1 + 999 i/(n-1) in f32
    gen = torch.Generator(device=dev).manual_seed(11)
    c = torch.randn(n, generator=gen, device=dev)
    c_norm = float(torch.linalg.vector_norm(c))   # = |grad f(x0)|, x0 = 0
    x0 = torch.zeros(n, device=dev)
    routes = (
        ("kernels, stored d", True, lambda v: F.diag_stencil_matvec(d, v)),
        ("kernels, affine d", True,
         lambda v: F.affine_stencil_matvec(v, a=1.0, b=b)),
        ("plain", False, lambda v: F.diag_stencil_matvec_reference(d, v)),
    )

    def solve(fused, A, max_iterations=30):
        params = TNTParams(max_iterations=max_iterations,
                           max_TPCG_iterations=100, fused_dots=fused,
                           gradient_tolerance=0.0,
                           preconditioned_gradient_tolerance=0.0,
                           relative_decrease_tolerance=0.0,
                           stepsize_tolerance=0.0)
        return euclidean_tnt(
            lambda x, _: 0.5 * torch.dot(x, A(x)) - torch.dot(c, x), x0,
            params, grad=lambda x, _: A(x) - c,
            hess_vec=lambda x, v, _: A(v))

    def run(name, fused, A):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = solve(fused, A)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        outer = int(res.num_iterations)
        inner = int(res.inner_iterations[:outer].sum())
        out = dict(name=name, outer=outer, inner=inner, secs=secs,
                   rate=inner / secs, f=float(res.f),
                   grad_rel=float(res.gradfx_norm) / c_norm,
                   status=TNTStatus(int(res.status)).name,
                   finite=bool(torch.isfinite(res.x).all()),
                   shape=tuple(res.x.shape))
        print(f"  {name}: {outer} outer / {inner} CG in {secs:.3f} s = "
              f"{out['rate']:.0f} CG it/s, f = {out['f']:.7g}, "
              f"|grad f|/|c| = {out['grad_rel']:.3e}, {out['status']} "
              f"[{label}]", flush=True)
        return out

    for _, fused, A in routes:      # warm-up: first launches, allocator
        solve(fused, A, max_iterations=1)

    kernels = (F.cg_dots, F.axpy_selfdot, F.diag_stencil_matvec,
               F.affine_stencil_matvec)
    # ---- the path's kernel runs: counts start at 0 here ----
    for fn in kernels:
        fn.launches = 0
    runs = [run(*routes[0])]
    after_stored = {fn.__name__: fn.launches for fn in kernels}
    runs.append(run(*routes[1]))
    counts = {fn.__name__: fn.launches for fn in kernels}
    # ---- end of the path's kernel runs ----
    runs.append(run(*routes[2]))
    after_plain = {fn.__name__: fn.launches for fn in kernels}
    print(f"  launches: stored-d run {after_stored}, both kernel runs "
          f"{counts}, after the plain run {after_plain}", flush=True)

    dots = [after_stored["cg_dots"],
            counts["cg_dots"] - after_stored["cg_dots"]]
    axpys = [after_stored["axpy_selfdot"],
             counts["axpy_selfdot"] - after_stored["axpy_selfdot"]]
    stencils = [after_stored["diag_stencil_matvec"],
                counts["affine_stencil_matvec"]]
    for i in range(2):
        if not (dots[i] == axpys[i] > 0 and dots[i] >= runs[i]["inner"]
                and stencils[i] > dots[i]):
            raise AssertionError(
                f"{runs[i]['name']}: cg_dots {dots[i]}, axpy_selfdot "
                f"{axpys[i]}, stencil {stencils[i]} launches for "
                f"{runs[i]['inner']} CG iterations")
    if (after_stored["affine_stencil_matvec"] != 0
            or counts["diag_stencil_matvec"] != stencils[0]
            or after_plain != counts):
        raise AssertionError("a route launched another route's kernel")
    for r in runs:
        if not (r["finite"] and r["shape"] == (n,)
                and math.isfinite(r["f"]) and r["grad_rel"] <= 1e-2):
            raise AssertionError(f"{r['name']}: |grad f|/|c| = "
                                 f"{r['grad_rel']}, f = {r['f']}")
        if abs(r["f"] - runs[0]["f"]) > 1e-4 * abs(runs[0]["f"]):
            raise AssertionError(f"{r['name']}: f = {r['f']} disagrees with "
                                 f"{runs[0]['f']}")
    print("  checks passed: launch counts, |grad f|/|c| <= 1e-2, f within "
          "1e-4 across the three runs", flush=True)

    # each kernel against its plain version at the path's shape
    gen = torch.Generator(device=dev).manual_seed(2)
    p, hp, r = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    alpha = torch.tensor(0.37, device=dev)
    # (kernel, plain version, words an element, f32 FLOP an element); no
    # single PyTorch call computes any of these four functions
    timing = {
        "cg_dots": (lambda: F.cg_dots(p, hp, r),
                    lambda: F.cg_dots_reference(p, hp, r), 3, 8),
        "axpy_selfdot": (lambda: F.axpy_selfdot(alpha, hp, r),
                         lambda: F.axpy_selfdot_reference(alpha, hp, r), 3,
                         4),
        "diag_stencil_matvec": (lambda: F.diag_stencil_matvec(d, p),
                                lambda: F.diag_stencil_matvec_reference(d, p),
                                3, 6),
        "affine_stencil_matvec": (
            lambda: F.affine_stencil_matvec(p, a=1.0, b=b),
            lambda: F.affine_stencil_matvec_reference(p, a=1.0, b=b), 2, 8),
    }
    entries, rates = [], {}
    for name, (kern, plain, words, flops) in timing.items():
        ms = time_ms(torch, kern, 50)
        plain_ms = time_ms(torch, plain, 20)
        gbs = words * 4 * n / ms / 1e6
        bound_ms, bound_by = bound(words * 4 * n, flops * n)
        rates[name] = gbs
        print(f"  {name}: kernel {ms:.4f} ms (~{gbs:.0f} GB/s at {words}n "
              f"words), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {bound_ms / ms:.3f} of it), n = {n} f32 "
              f"[{label}]", flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": "optimization_tpu_torch/csrc/fused.cu",
            "replaces": f"optimization_tpu/kernels/fused.py:"
                        f"{FUSED_REPLACES[name]}",
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    return entries, rates


GRAM_TOLERANCES = """\
  tolerances, kernel against plain version (and against a float64 product
  of the same inputs on the card):
    gram_pair: 1e-5 sum_r |S[r,i] X[r,j]| per entry -- f32 storage: the
      kernel's 3xTF32 tensor-core products (hi*hi + hi*lo + lo*hi) are
      within 3 2^-22 |S X| of the f32 products cuBLAS takes (no TF32 on
      its side); bf16 storage: bf16 x bf16 products, exact in f32 on both;
      both sum in f32 in other orders (the kernel per mma accumulator over
      a block's row tiles, then the blocks in double; cuBLAS in its own
      split);
    stream3_probe: f32 bit for bit (the same three roundings in the same
      order); bf16 2^-6 |(d+2) v scale| -- the plain version rounds after
      each bf16 operation, the kernel once on store.
"""
GRAM_SHAPES = ((100_000, 48), (999, 30), (16, 10_000, 48), (5_000, 96))
# the timed shapes: config3's Gram stage with BS distinct and BS = S (the
# LOBPCG call without B, the path's; its entry in the kernels line), and
# config10's fleet
GRAM_TIMED = (((100_000, 48), False), ((100_000, 48), True),
              ((16, 10_000, 48), False))
N_STREAM3 = (1 << 24, 999_999, 100)


def gram_bound(shape, same, dtype, torch):
    """(ms, bound_by) of one gram_pair call: 3mk words read (2mk when BS is
    S), 2 k^2 F written; 2 m k (2k) multiply-adds, three times over on the
    TF32 tensor cores for f32 storage (the 3xTF32 split), once in bf16."""
    rows, k = math.prod(shape[:-1]), shape[-1]
    fleet = math.prod(shape[:-2]) if len(shape) > 2 else 1
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = (2 if same else 3) * rows * k * size + fleet * 2 * k * k * 4
    flops = 2 * rows * k * 2 * k
    if dtype == torch.bfloat16:
        return bound(nbytes, flops, "bf16")
    return bound(nbytes, 3 * flops, "tf32")


def gram_stream3_phase(torch, dev, label):
    """Phase 7: gram_pair and stream3_probe against their plain versions on
    the card, bitwise repeats, times beside bounds and the library call;
    then stream3_probe's GB/s at n = 2^24 f32, the measured ceiling.
    Returns ({name: max |err| at the path's shape}, {name: times of the
    kernels line}, ceiling GB/s, stream3 launches)."""
    from optimization_tpu_torch.kernels import fused as F

    print("phase 7: gram_pair and stream3_probe vs plain versions on the "
          "card", flush=True)
    print(GRAM_TOLERANCES, end="", flush=True)
    errs, cases = {}, 0
    for shape, dtype in itertools.product(GRAM_SHAPES,
                                          (torch.float32, torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(sum(shape))
        S, AS, BS = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(3))
        ga, gb = F.gram_pair(S, AS, BS)
        ra, rb = F.gram_pair_reference(S, AS, BS)
        ga2, gb2 = F.gram_pair(S, AS, BS)
        tag = f"{'x'.join(map(str, shape))} {str(dtype)[6:]}"
        err = 0.0
        for name, got, ref, X in (("S'AS", ga, ra, AS), ("S'BS", gb, rb, BS)):
            Sd, Xd = S.double(), X.double()
            tol = 1e-5 * (Sd.abs().mT @ Xd.abs())
            err = max(err, check_close(torch, f"gram_pair {name} {tag}", got,
                                       ref, tol))
            check_close(torch, f"gram_pair {name} {tag} vs f64", got,
                        Sd.mT @ Xd, tol)
        same = torch.equal(ga, ga2) and torch.equal(gb, gb2)
        print(f"  {'ok  ' if same else 'FAIL'} bitwise repeat gram_pair "
              f"{tag}", flush=True)
        if not same:
            raise AssertionError(f"two runs of gram_pair differ: {tag}")
        errs.setdefault("gram_pair", err)
        cases += 1
        # B = None in LOBPCG passes S as BS: S is read once
        ga, gb = F.gram_pair(S, AS, S)
        ra, rb = F.gram_pair_reference(S, AS, S.clone())
        Sd = S.double()
        for name, got, ref, X in (("S'AS", ga, ra, AS), ("S'S", gb, rb, S)):
            tol = 1e-5 * (Sd.abs().mT @ X.double().abs())
            check_close(torch, f"gram_pair BS = S {name} {tag}", got, ref, tol)
            check_close(torch, f"gram_pair BS = S {name} {tag} vs f64", got,
                        Sd.mT @ X.double(), tol)
        ga2, gb2 = F.gram_pair(S, AS, S)
        same = torch.equal(ga, ga2) and torch.equal(gb, gb2)
        print(f"  {'ok  ' if same else 'FAIL'} bitwise repeat gram_pair "
              f"BS = S {tag}", flush=True)
        if not same:
            raise AssertionError(f"two runs of gram_pair differ: BS = S {tag}")
        cases += 1

    for n, dtype in itertools.product(N_STREAM3,
                                      (torch.float32, torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(n % 991)
        v = torch.randn(n, generator=gen, device=dev).to(dtype)
        d = (1.0 + 999.0 * torch.rand(n, generator=gen, device=dev)).to(dtype)
        got = F.stream3_probe(d, v, scale=0.5)
        ref = F.stream3_probe_reference(d, v, scale=0.5)
        tag = f"n={n} {str(dtype)[6:]}"
        if dtype == torch.float32:
            same = torch.equal(got, ref)
            print(f"  {'ok  ' if same else 'FAIL'} stream3_probe {tag}: "
                  f"bit for bit", flush=True)
            if not same:
                raise AssertionError(f"stream3_probe differs: {tag}")
            err = 0.0
        else:
            terms = ((d.double() + 2.0) * v.double()).abs() * 0.5
            err = check_close(torch, f"stream3_probe {tag}", got, ref,
                              2.0 ** -6 * terms)
        if not torch.equal(got, F.stream3_probe(d, v, scale=0.5)):
            raise AssertionError(f"two runs of stream3_probe differ: {tag}")
        errs.setdefault("stream3_probe", err)
        cases += 1
    print(f"phase 7: {cases} shape x dtype cases of 2 kernels + bitwise "
          f"repeats passed", flush=True)

    # kernel, plain version and the library call (one cuBLAS product of S'
    # and [AS | BS], built outside the timed region; full f32, TF32 off)
    times = {}
    for (shape, same), dtype in itertools.product(
            GRAM_TIMED, (torch.float32, torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(4)
        S, AS, BS = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(3))
        X = S if same else BS
        SX = torch.cat((AS, X), -1)
        ms = time_ms(torch, lambda: F.gram_pair(S, AS, X), 50)
        plain_ms = time_ms(torch, lambda: F.gram_pair_reference(S, AS, X),
                           50)
        lib_ms = time_ms(torch, lambda: torch.matmul(S.mT, SX), 50)
        bound_ms, bound_by = gram_bound(shape, same, dtype, torch)
        rows, k = S.numel() // shape[-1], shape[-1]
        words = 2 if same else 3
        gbs = words * rows * k * S.element_size() / ms / 1e6
        print(f"  gram_pair {'x'.join(map(str, shape))} "
              f"{'BS = S' if same else 'BS distinct'} {str(dtype)[6:]}: "
              f"kernel {ms:.4f} ms (~{gbs:.0f} GB/s at {words}mk words), "
              f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of the "
              f"bound [{label}]", flush=True)
        if same and dtype == torch.float32:
            times["gram_pair"] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=lib_ms)

    n = 1 << 24
    gen = torch.Generator(device=dev).manual_seed(8)
    v = torch.randn(n, generator=gen, device=dev)
    d = 1.0 + 999.0 * torch.rand(n, generator=gen, device=dev)
    # ---- the ceiling's run: stream3_probe's count starts at 0 here ----
    F.stream3_probe.launches = 0
    ms = time_ms(torch, lambda: F.stream3_probe(d, v), 100)
    launches = F.stream3_probe.launches
    # ---- end of the ceiling's run ----
    plain_ms = time_ms(torch, lambda: F.stream3_probe_reference(d, v), 20)
    ceiling = 3 * 4 * n / ms / 1e6
    bound_ms, bound_by = bound(3 * 4 * n, 3 * n)
    times["stream3_probe"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=None)
    print(f"  stream3_probe n = 2^24 f32: kernel {ms:.4f} ms = {ceiling:.0f} "
          f"GB/s at 3n words (the measured ceiling; "
          f"{ceiling / 3350:.3f} of the 3.35 TB/s data sheet), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
          f"[{label}]", flush=True)
    return errs, times, ceiling, launches


def lobpcg_phase(torch, dev, label):
    """Phase 8: the eigensolver path at full size (config3: m = 1e5, nx = 16,
    nev = 5; config10: a fleet of 16 at m = 1e4), the Gram stage through
    gram_pair; gates, launch counts, block it/s, host syncs per iteration.
    Returns gram_pair's launches on the path."""
    import warnings

    from optimization_tpu_torch.kernels import fused as F
    from optimization_tpu_torch.linalg import lobpcg, lobpcg_fleet

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("f32 matmuls must run in full f32 (no TF32) "
                             "for the LOBPCG pencils")
    m, nx, nev = 100_000, 16, 5
    print(f"phase 8: LOBPCG config3 (m = {m}, nx = {nx}, nev = {nev}, "
          f"A = diag(linspace(1, m)), exact-inverse preconditioner) and "
          f"config10 (16 x m = 1e4) [{label}]", flush=True)
    truth = torch.arange(1.0, nev + 1.0, dtype=torch.float64)

    def config3(dtype, rr, max_iterations, tau):
        # one X0 for both dtypes: drawn in f32, then cast
        d = torch.linspace(1.0, float(m), m, dtype=dtype, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        X0 = torch.randn((m, nx), generator=gen, device=dev).to(dtype)
        return lobpcg(lambda S: d[:, None] * S, T=lambda S: S / d[:, None],
                      X0=X0, nev=nev, max_iterations=max_iterations,
                      tau=tau, generator=gen, rr_method=rr)

    fleet, mf = 16, 10_000
    ds = (torch.arange(1.0, fleet + 1.0, device=dev)[:, None]
          * torch.linspace(1.0, mf / 10.0, mf, device=dev)[None, :])

    def config10(max_iterations, tau):
        gen = torch.Generator(device=dev).manual_seed(5)
        return lobpcg_fleet(lambda S, d: d[:, None] * S, ds,
                            T=lambda S, d: S / d[:, None], m=mf, nx=nx,
                            nev=nev, max_iterations=max_iterations, tau=tau,
                            generator=gen, rr_method="chol")

    for rr in ("eigh", "chol", "chol_warm"):      # warm-up: handles, builds
        config3(torch.float32, rr, 2, 1e-30)
    config3(torch.float64, "eigh", 2, 1e-30)
    config10(2, 1e-30)

    # ---- the path's gram_pair runs: the count starts at 0 here ----
    F.gram_pair.launches = 0
    runs, expected = {}, 0
    for rr in ("eigh", "chol"):
        res, secs = timed_solve(
            torch, dev, lambda: config3(torch.float32, rr, 100, 1e-4))
        expected += 1 + int(res.num_iterations)
        runs[rr] = res
        err = float((res.theta.double().cpu() - truth).abs().max())
        print(f"  f32 {rr}: {int(res.num_iterations)} it, nc "
              f"{int(res.num_converged)}, max|theta - (1..5)| {err:.3e}, "
              f"consistent {bool(res.pencil_consistent)}, {secs:.3f} s "
              f"[{label}]", flush=True)
        if not (err < 5e-2 and int(res.num_converged) >= nev
                and bool(res.pencil_consistent)
                and bool(torch.isfinite(res.X).all())
                and res.X.shape == (m, nev)):
            raise AssertionError(f"config3 f32 {rr}: the gate failed")
    if F.gram_pair.launches != expected:
        raise AssertionError(f"gram_pair launches {F.gram_pair.launches} != "
                             f"{expected} (1 + iterations per solve)")
    f64, secs = timed_solve(
        torch, dev, lambda: config3(torch.float64, "eigh", 100, 1e-4))
    if F.gram_pair.launches != expected:
        raise AssertionError("the f64 route launched gram_pair")
    gap = float((runs["eigh"].theta.double() - f64.theta).abs().max())
    print(f"  f64 eigh (matmul route): {int(f64.num_iterations)} it, nc "
          f"{int(f64.num_converged)}, max|theta - (1..5)| "
          f"{float((f64.theta.cpu() - truth).abs().max()):.3e}, f32 vs f64 "
          f"{gap:.3e}, {secs:.3f} s [{label}]", flush=True)
    if not (gap < 5e-2 and int(f64.num_converged) >= nev):
        raise AssertionError("config3: the f32 route disagrees with f64")

    before = F.gram_pair.launches
    fl, secs = timed_solve(torch, dev, lambda: config10(100, 1e-4))
    fleet_launches = F.gram_pair.launches - before
    launches = F.gram_pair.launches
    # ---- end of the path's gram_pair runs ----
    if launches != expected + fleet_launches:
        raise AssertionError(f"gram_pair launches {launches} != "
                             f"{expected} + {fleet_launches}")
    rel = float(((fl.theta.double() - ds[:, :nev].double()).abs()
                 / ds[:, :nev].double()).max())
    print(f"  config10 fleet f32 chol: iterations "
          f"{fl.num_iterations.tolist()}, nc {fl.num_converged.tolist()}, "
          f"max rel err {rel:.3e}, all consistent "
          f"{bool(fl.pencil_consistent.all())}, {secs:.3f} s [{label}]",
          flush=True)
    if not (bool((fl.num_converged >= nev).all())
            and bool(fl.pencil_consistent.all()) and rel < 1e-3
            and bool(torch.isfinite(fl.X).all())):
        raise AssertionError("config10 fleet: the gate failed")
    if fleet_launches != 1 + int(fl.num_iterations.max()):
        raise AssertionError(f"fleet gram_pair launches {fleet_launches} != "
                             f"1 + max iterations")
    print(f"  gram_pair launches on the path: {launches} (1 + iterations "
          f"per solve, 0 on f64)", flush=True)

    # sustained block it/s, convergence test disarmed
    K = 50
    for rr, k in (("eigh", K), ("chol", K), ("chol_warm", 10)):
        res, secs = timed_solve(
            torch, dev, lambda: config3(torch.float32, rr, k, 1e-30))
        if int(res.num_iterations) != k:
            raise AssertionError(f"config3 {rr}: {int(res.num_iterations)} "
                                 f"of {k} fixed iterations")
        print(f"  config3 f32 {rr}: {k} fixed iterations in {secs:.3f} s = "
              f"{k / secs:.1f} block it/s [{label}]", flush=True)
    res, secs = timed_solve(torch, dev, lambda: config10(K, 1e-30))
    print(f"  config10 fleet f32 chol: {K} lockstep iterations in "
          f"{secs:.3f} s = {K / secs:.1f} lockstep it/s = "
          f"{fleet * K / secs:.1f} aggregate block it/s [{label}]",
          flush=True)

    # host syncs per iteration (the sync debug mode's warnings, by the line
    # that raised them): the difference of a 20- and a 10-iteration run
    def syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return collections.Counter(
            f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message))

    for name, run in (
            ("config3 f32 eigh", lambda k: config3(torch.float32, "eigh", k,
                                                   1e-30)),
            ("config3 f32 chol", lambda k: config3(torch.float32, "chol", k,
                                                   1e-30)),
            ("config10 fleet chol", lambda k: config10(k, 1e-30))):
        per = syncs(lambda: run(20))
        per.subtract(syncs(lambda: run(10)))
        sites = ", ".join(f"{site} x{n / 10:g}"
                          for site, n in per.most_common() if n)
        print(f"  host syncs per iteration, {name}: "
              f"{sum(per.values()) / 10:g} ({sites})", flush=True)
    return launches


def timed_solve(torch, dev, fn):
    """(result, seconds) of fn(), the clock closed after the device."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def counts(res):
    """(outer, inner) iterations of a TNT result."""
    outer = int(res.num_iterations)
    return outer, int(res.inner_iterations[:outer].sum())


def config13_phase(torch, dev, label):
    """Phase 9: the preconditioned solve of config13 at full width, the
    eager flat engine (arm a) against the preconditioned kernel (arm b),
    then arm b through the host driver.  Returns the kernel's entry of the
    kernels line and its GB/s."""
    from optimization_tpu_torch import headline as H
    from optimization_tpu_torch.core.driver import drive
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.kernels.streamed_cg import (
        AffineDiagonal, JacobiPower, sphere_rayleigh_streamed,
        stpcg_flat_streamed, stpcg_flat_streamed_reference)
    from optimization_tpu_torch.solvers import tnt
    from optimization_tpu_torch.solvers.tnt import TNTParams

    n, kappa, e = N_MAIN, 1e5, 0.25
    print(f"phase 9: config13, n = 2^24, kappa = {kappa:g}, P = (|2a - rq| "
          f"+ 1)^(-1/4), 30 outer / 100 CG [{label}]", flush=True)
    params = TNTParams(max_iterations=30, max_TPCG_iterations=100,
                       gradient_tolerance=1e-6,
                       relative_decrease_tolerance=0.0,
                       stepsize_tolerance=0.0,
                       preconditioned_gradient_tolerance=0.0)
    arms = {name: H.make_problem(n, dev, engine, kappa=kappa,
                                 jacobi_power=e)
            for name, engine in (("a", "flat"), ("b", "streamed"))}
    x0 = H.initial_point(n, torch.float32, dev, 3)
    for prob in arms.values():            # warm-up: first launches
        tnt.solve(prob, H.initial_point(n, torch.float32, dev, 2),
                  dataclasses.replace(params, max_iterations=1))

    ra, secs_a = timed_solve(torch, dev,
                             lambda: tnt.solve(arms["a"], x0, params))
    # ---- the preconditioned kernel's main-path run: its count starts at
    # 0 here ----
    stpcg_flat_streamed.launches = 0
    rb, secs_b = timed_solve(torch, dev,
                             lambda: tnt.solve(arms["b"], x0, params))
    launches = stpcg_flat_streamed.launches
    # ---- end of the run ----
    (oa, ia), (ob, ib) = counts(ra), counts(rb)
    fa, fb = float(ra.f), float(rb.f)
    for name, res, outer, inner, secs in (
            ("(a) flat engine, flat_prec", ra, oa, ia, secs_a),
            ("(b) preconditioned kernel, flat_solve", rb, ob, ib, secs_b)):
        print(f"  {name}: {outer} outer / {inner} CG in {secs:.3f} s = "
              f"{inner / secs:.0f} CG it/s, f* = {float(res.f):.7f}, "
              f"|g| = {float(res.gradfx_norm):.3e}, "
              f"{TNTStatus(int(res.status)).name} [{label}]", flush=True)
    subproblems = ob - int(int(rb.status) in (
        TNTStatus.GRADIENT, TNTStatus.PRECONDITIONED_GRADIENT))
    # f* = 1 (the least a(i)) and the arms end ~3e-4 above it, so config13's
    # own 1e-3 relative gate would pass any f* in [0.999, 1.001]: the arms
    # are held to 1e-2 of their excess over the optimum (~3e-6, ~25 f32
    # ulps at 1; the card's runs differ by one ulp)
    if not (fa > 1.0 and abs(fa - fb) <= 1e-2 * (fa - 1.0)
            and abs(ia - ib) <= 0.1 * max(ia, ib) and oa == ob
            and launches == subproblems and math.isfinite(fb)
            and bool(torch.isfinite(rb.x).all())):
        raise AssertionError(f"config13: f* {fa}/{fb}, CG {ia}/{ib}, outer "
                             f"{oa}/{ob}, launches {launches} for "
                             f"{subproblems} subproblems")
    print(f"  gates passed: |fa - fb| = {abs(fa - fb):.3e} within 1e-2 of "
          f"f* - 1 = {fa - 1.0:.4e}, CG within 10%, outer equal, kernel "
          f"launches {launches} = subproblems", flush=True)

    chunked, secs_c = timed_solve(torch, dev, lambda: drive(
        tnt, arms["b"], x0, params, chunk_iterations=10))
    oc, ic = counts(chunked)
    fc = float(chunked.f)
    same = torch.equal(chunked.x, rb.x)
    print(f"  (b) through drive(chunk_iterations=10): {oc} outer / {ic} CG "
          f"in {secs_c:.3f} s, f* = {fc:.7f}, x bitwise equal to the "
          f"monolithic solve's: {same} [{label}]", flush=True)
    # the chunks resume through tnt.solve(warm_start=): the same iterates
    if not (oc == ob and ic == ib and fc == fb and same):
        raise AssertionError("config13: the chunked drive disagrees with "
                             "the monolithic solve")

    # the kernel on one subproblem of the path: the longest one of arm (b)
    k_mid = int(torch.argmax(rb.inner_iterations[:ob]))
    mid = tnt.solve(arms["b"], x0,
                    dataclasses.replace(params, max_iterations=k_mid))
    x, _, g, _, aux = arms["b"].step_eval(mid.x, torch.zeros_like(x0), None)
    Delta = mid.trust_region_radius[k_mid]
    diag = AffineDiagonal(1.0, (kappa - 1.0) / (n - 1))
    a0c, weights, B_fn = sphere_rayleigh_streamed(diag)
    desc = JacobiPower(1.0, e)
    kw = dict(a0_chunk=a0c, weights=weights, max_iterations=100,
              kappa_fgr=0.1, theta=0.5, prec_chunk=desc,
              prec=desc.map(diag, aux.rq, n, dev))
    args = (g, x, B_fn(aux.rq), Delta, (aux.rq,))
    res = stpcg_flat_streamed(*args, **kw)
    ref = stpcg_flat_streamed_reference(*args, **kw)
    err = check_parity(torch, res, ref, torch.float32,
                       f"config13 subproblem n=2^24 f32 (outer {k_mid + 1})")
    its = int(res.num_iterations)
    ms = time_ms(torch, lambda: stpcg_flat_streamed(*args, **kw), 10)
    plain_ms = time_ms(torch,
                       lambda: stpcg_flat_streamed_reference(*args, **kw), 3)
    # 6n words a CG iteration, the init pass's read of g and x and the
    # un-transform's read and write of s; ~30 f32 operations an element an
    # iteration (the operator, p, the dots, the updates)
    words = (6 * its + 4) * n
    bound_ms, bound_by = bound(words * 4, 30.0 * n * its)
    gbs = words * 4 / ms / 1e6
    print(f"  preconditioned subproblem ({its} CG it): kernel {ms:.3f} ms "
          f"= {ms / max(its, 1):.4f} ms a CG iteration ({its / ms * 1e3:.0f} "
          f"CG it/s, ~{gbs:.0f} GB/s at (6 its + 4) n words), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.3f} of it [{label}]", flush=True)
    return {"name": "stpcg_flat_streamed[prec]", "route": "cuda",
            "source": "optimization_tpu_torch/csrc/streamed_cg.cu",
            "replaces": "optimization_tpu/kernels/streamed_cg.py:125",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, gbs


ESCALATION_SEED = 2      # profile_escalation.py: why not seed 3


def config12_phase(torch, dev, label):
    """Phase 10: dtype escalation at full width, the kernel in both
    stages, beside pure f32 with floor acceptance.  From seed 2's start the
    bf16 stage stops at its floor (trust-region collapse) above the
    tolerance, so the f32 stage has to finish the solve: the zero-tangent
    retraction, floor acceptance and the f32 kernel all do work, and the
    gates check that they did.  (From seed 3's start the bf16 stage reaches
    the tolerance by itself, and the f32 stage, whose |grad| falls slowly
    here with every subproblem at its 100-CG cap, cannot finish from any
    earlier handoff ``profile_escalation.py`` tries.)"""
    from optimization_tpu_torch import headline as H
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.kernels.streamed_cg import stpcg_flat_streamed
    from optimization_tpu_torch.solvers import tnt
    from optimization_tpu_torch.solvers.tnt import TNTParams

    n, tol = N_MAIN, 1e-3
    print(f"phase 10: config12, n = 2^24, kappa = 1000, |grad| <= {tol:g}: "
          f"solve_escalated (bf16 to its floor, then f32, the kernel in both "
          f"stages) and pure f32, seed {ESCALATION_SEED} [{label}]",
          flush=True)
    prob = H.make_problem(n, dev, "streamed")
    params = TNTParams(max_iterations=400, max_TPCG_iterations=100,
                       gradient_tolerance=tol,
                       relative_decrease_tolerance=0.0,
                       stepsize_tolerance=0.0,
                       preconditioned_gradient_tolerance=0.0)
    x0 = H.initial_point(n, torch.float32, dev, ESCALATION_SEED)
    # ---- the escalation's kernel runs: the count starts at 0 here ----
    stpcg_flat_streamed.launches = 0
    esc, secs_e = timed_solve(torch, dev, lambda: tnt.solve_escalated(
        prob, x0, params))
    launches = stpcg_flat_streamed.launches
    # ---- end of the escalation's kernel runs ----
    pure, secs_p = timed_solve(torch, dev, lambda: tnt.solve(
        prob, x0, dataclasses.replace(params, floor_acceptance=True)))
    g_esc = float(torch.linalg.vector_norm(prob.rgrad(esc.x)))
    g_pure = float(torch.linalg.vector_norm(prob.rgrad(pure.x)))
    (o1, i1), (o2, i2), (op, ip) = (counts(esc.stage_low),
                                    counts(esc.stage_high), counts(pure))
    converged = (TNTStatus.GRADIENT, TNTStatus.PRECONDITIONED_GRADIENT)
    sub_low = o1 - int(int(esc.stage_low.status) in converged)
    sub_high = o2 - int(int(esc.stage_high.status) in converged)
    print(f"  escalated: {secs_e:.3f} s, switch at outer "
          f"{int(esc.switch_iteration)}; bf16 stage {o1} outer / {i1} CG "
          f"({TNTStatus(int(esc.stage_low.status)).name}, |grad| "
          f"{float(esc.stage_low.gradfx_norm):.3e}), f32 stage {o2} outer / "
          f"{i2} CG; kernel launches {launches} = {sub_low} + {sub_high} "
          f"subproblems; f* = {float(esc.f):.7f}, |grad| = {g_esc:.3e} "
          f"(problem.rgrad), {TNTStatus(int(esc.status)).name} [{label}]",
          flush=True)
    print(f"  pure f32 (floor_acceptance): {secs_p:.3f} s, {op} outer / {ip} "
          f"CG, f* = {float(pure.f):.7f}, |grad| = {g_pure:.3e}, "
          f"{TNTStatus(int(pure.status)).name}; wall ratio pure / escalated "
          f"{secs_p / secs_e:.3f} [{label}]", flush=True)
    if not (int(esc.status) == TNTStatus.GRADIENT and g_esc <= tol
            and int(esc.switch_iteration) > 0
            and esc.stage_low.x.dtype == torch.bfloat16
            and esc.x.dtype == torch.float32
            and float(esc.stage_low.gradfx_norm) > tol
            and sub_high > 0 and i2 > 0
            and launches == sub_low + sub_high):
        raise AssertionError("config12: the escalated solve failed its gate")
    print("  gates passed: GRADIENT, |grad| <= 1e-3 re-verified, switch > 0, "
          "the f32 stage took over above the tolerance and launched the "
          "kernel for each of its subproblems", flush=True)


def least_squares_phase(torch, dev, label):
    """Phase 11: TNLS (LSQR subproblems, Jacobian pair from torch.func) on
    the sinusoid fit at m = 2^24 samples, f32, on the card."""
    import warnings

    from optimization_tpu_torch import euclidean_tnls
    from optimization_tpu_torch.core.types import TNLSStatus
    from optimization_tpu_torch.solvers.tnls import TNLSParams

    m = 1 << 24
    omega, phi = math.pi / 2, math.pi / 4
    print(f"phase 11: euclidean_tnls, sin(w x + p) fit, m = 2^24 f32, noise "
          f"0.1 U(-1, 1) [{label}]", flush=True)
    xs = torch.linspace(-math.pi, math.pi, m, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    z = 0.1 * (2.0 * torch.rand(m, generator=gen, device=dev) - 1.0)
    y = torch.sin(omega * xs + phi) + z
    residual = lambda b, d: d - torch.sin(b[0] * xs + b[1])
    params = TNLSParams(max_iterations=30, relative_decrease_tolerance=0.0,
                        gradient_tolerance=1e-6, stepsize_tolerance=0.0,
                        Delta_tolerance=1e-10)
    beta0 = torch.ones(2, device=dev)
    euclidean_tnls(residual, beta0, dataclasses.replace(
        params, max_iterations=1), data=y)            # warm-up
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res, secs = timed_solve(torch, dev, lambda: euclidean_tnls(
                residual, beta0, params, data=y))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = sum("synchroniz" in str(w.message) for w in caught)
    outer = int(res.num_iterations)
    lsqr_its = int(res.inner_iterations[:outer].sum())
    err = float((res.x.double().cpu()
                 - torch.tensor([omega, phi], dtype=torch.float64))
                .abs().max())
    # the fit beats the planted signal by |z|^2 - |F|^2 ~ 7e-3 (the
    # noise's part in the two Jacobian columns): ~1.4e-5 of |F| ~ 236, the
    # size of an f32 norm's rounding, so both norms sum in f64
    F = float(torch.linalg.vector_norm(residual(res.x, y).double()))
    z_norm = float(torch.linalg.vector_norm(z.double()))
    print(f"  {outer} outer / {lsqr_its} LSQR iterations in {secs:.3f} s, "
          f"{TNLSStatus(int(res.status)).name}, |beta - (pi/2, pi/4)| "
          f"{err:.3e}, |F| {F:.6f} < |z| {z_norm:.6f}, |gradL| "
          f"{float(res.gradfx_norm):.3e}; host reads {reads} "
          f"({reads / max(outer + lsqr_its, 1):.2f} per outer + LSQR "
          f"iteration) [{label}]", flush=True)
    if not (err <= 1e-3 and F < z_norm and res.x.device.type == "cuda"):
        raise AssertionError("least squares: the gate failed")
    print("  gates passed: |beta - truth| <= 1e-3, |F| < |z|", flush=True)


def ceiling_summary(ceiling, rates, label):
    print(f"bandwidth ceiling: stream3_probe {ceiling:.0f} GB/s at n = 2^24 "
          f"f32 [{label}]", flush=True)
    for name, gbs in rates.items():
        print(f"  {name}: {gbs:.0f} GB/s = {gbs / ceiling:.3f} of the "
              f"measured ceiling", flush=True)


def main():
    import torch

    print("phase 1: device", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test has no CPU "
                         "path")
    smi, label = card_label(torch)
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    sys.path.insert(0, ROOT)
    from optimization_tpu_torch.csrc.build import build

    print("phase 2: build (one nvcc per source, started together)",
          flush=True)

    def timed_build(name):
        t0 = time.perf_counter()
        return build(name, verbose=True), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        builds = list(pool.map(timed_build, SOURCES))
    for path, secs in builds:
        print(f"  built {os.path.relpath(path, ROOT)} in {secs:.1f} s",
              flush=True)

    parity_phase(torch, dev)
    kernel, streamed_gbs = main_path_phase(torch, dev, label)
    errs = fused_parity_phase(torch, dev)
    fused_kernels, rates = stencil_path_phase(torch, dev, label, errs)
    errs7, times7, ceiling, stream3_launches = gram_stream3_phase(
        torch, dev, label)
    gram_launches = lobpcg_phase(torch, dev, label)
    prec_kernel, prec_gbs = config13_phase(torch, dev, label)
    config12_phase(torch, dev, label)
    least_squares_phase(torch, dev, label)
    ceiling_summary(ceiling, {"stpcg_flat_streamed": streamed_gbs,
                              "stpcg_flat_streamed[prec]": prec_gbs,
                              **rates}, label)

    launches = {"gram_pair": gram_launches, "stream3_probe": stream3_launches}
    new_kernels = [{
        "name": name, "route": "cuda",
        "source": "optimization_tpu_torch/csrc/fused.cu",
        "replaces": f"optimization_tpu/kernels/fused.py:{FUSED_REPLACES[name]}",
        "launches": launches[name], "max_abs_err": errs7[name],
        **times7[name]}
        for name in ("gram_pair", "stream3_probe")]
    print(json.dumps({"kernels": [kernel] + fused_kernels + new_kernels
                      + [prec_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
