#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the repository root:  python3 chip_smoke.py

Phases, each printed on its own lines; any failure ends the run with a
non-zero exit and no result line:

1. device: a CUDA device is required (there is no CPU path); prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` and
   turns TF32 off;
2. build: compiles ``optimization_tpu_torch/csrc/streamed_cg.cu`` with nvcc
   from this checkout and prints the build seconds;
3. kernel parity: ``stpcg_flat_streamed`` on the card against its plain
   PyTorch version on the same inputs, at n = 2^20 and a ragged n, over
   storage dtype x body x init x Delta x fixture, plus a bitwise repeat;
4. main path: the headline TNT solve (``optimization_tpu_torch/headline.py``)
   at n = 2^24 in both tiers, the f32 tier through the kernel (its launch
   count checked against the subproblems solved), then the f32 tier again
   with the plain version in the kernel's place;
5. the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

Every time printed is labelled with the card's name and power limit.
"""

import itertools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_PARITY = (1 << 20, 999_999)       # the second is not a multiple of 1024
N_MAIN = 1 << 24
SHORT = 10                          # CG iterations: see check_parity


def card_label(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out, f"{torch.cuda.get_device_name(0)} @ {out.splitlines()[0]}"


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


def check_parity(torch, res, ref, dtype, label):
    """Kernel vs plain version, at the tolerances of tests/test_streamed_cg.py.
    f32, both runs within SHORT iterations (test_matches_flat_engine): equal
    counts, s within 3e-5 |s|, M-norm rtol 2e-5, predicted decrease rtol
    2e-3 (Delta = 1e6 assembles it from ~1e12-scale cancellations).  f32,
    longer runs (test_interior_multi_iteration_parity): the M-norm and the
    model value are scalar recurrences whose f32 rounding grows with the
    count, and the two runs sum in other orders, so CG may stop one step
    apart at the truncation threshold: counts within 1, s within 2e-3 |s|,
    M-norm and predicted decrease rtol 1e-3.  bf16 storage
    (test_bf16_storage_parity): counts within 3, s within 3e-2 |s|, M-norm
    rtol 3e-2.  Returns max |s - s_ref|."""
    ki, kr = int(res.num_iterations), int(ref.num_iterations)
    s, s_ref = res.s.float(), ref.s.float()
    scale = max(float(torch.linalg.vector_norm(s_ref)), 1e-9)
    err = float((s - s_ref).abs().max())
    mn, mn_ref = float(res.update_step_M_norm), float(ref.update_step_M_norm)
    pd, pd_ref = float(res.predicted_decrease), float(ref.predicted_decrease)
    if dtype == torch.bfloat16:
        ok = (abs(ki - kr) <= 3 and err <= 3e-2 * scale
              and abs(mn - mn_ref) <= 3e-2 * abs(mn_ref))
    elif max(ki, kr) <= SHORT:
        ok = (ki == kr and err <= 3e-5 * scale
              and abs(mn - mn_ref) <= 2e-5 * abs(mn_ref)
              and abs(pd - pd_ref) <= 2e-3 * abs(pd_ref) + 1e-8)
    else:
        ok = (abs(ki - kr) <= 1 and err <= 2e-3 * scale
              and abs(mn - mn_ref) <= 1e-3 * abs(mn_ref)
              and abs(pd - pd_ref) <= 1e-3 * abs(pd_ref))
    ok = ok and math.isfinite(err)
    print(f"  {'ok  ' if ok else 'FAIL'} {label}: it {ki}/{kr} "
          f"|ds|max/|s| {err / scale:.2e} M-norm {mn:.6g}/{mn_ref:.6g} "
          f"dm {pd:.6g}/{pd_ref:.6g}", flush=True)
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
    print(f"phase 3: {cases} cases + bitwise repeat passed", flush=True)


def time_ms(torch, fn, reps):
    """Mean milliseconds per call by CUDA events (after one warm call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
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
    prob = H.make_problem(n, torch.float32, dev, "streamed")

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
    H.run_tier(H.make_problem(n, torch.bfloat16, dev, "flat"),
               H.initial_point(n, torch.bfloat16, dev, 2),
               H.tier_params(0.0, max_iterations=1))

    # ---- the main path's run: counts start at 0 here ----
    stpcg_flat_streamed.launches = 0
    f32 = H.run_tier(prob, x0, f32_params)
    launches = stpcg_flat_streamed.launches
    bf16 = H.run_tier(H.make_problem(n, torch.bfloat16, dev, "flat"),
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

    ref_run = H.run_tier(H.make_problem(n, torch.float32, dev,
                                        "streamed_reference"),
                         x0, f32_params)
    print(f"  tier f32 (plain version): {ref_run.outer} outer / "
          f"{ref_run.inner} CG in {ref_run.seconds:.3f} s = "
          f"{ref_run.cg_per_s:.0f} CG it/s, f* = {ref_run.fstar:.6f} "
          f"(kernel run {f32.seconds:.3f} s) [{label}]", flush=True)
    if (ref_run.outer != f32.outer
            or abs(ref_run.fstar - f32.fstar) > 1e-3 * abs(ref_run.fstar)):
        raise AssertionError("f32 tier: kernel and plain version disagree")

    return {"name": "stpcg_flat_streamed", "route": "cuda",
            "source": "optimization_tpu_torch/csrc/streamed_cg.cu",
            "replaces": "optimization_tpu/kernels/streamed_cg.py:95",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


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

    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    path = build("streamed_cg", verbose=True)
    print(f"  built {os.path.relpath(path, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    parity_phase(torch, dev)
    kernel = main_path_phase(torch, dev, label)

    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
