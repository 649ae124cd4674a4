#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the repository root:  python3 chip_smoke.py

Phases, each printed on its own lines; any failure ends the run with a
non-zero exit and no result line:

1. device: a CUDA device is required (there is no CPU path); prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` and
   turns TF32 off;
2. build: compiles ``optimization_tpu_torch/csrc/streamed_cg.cu`` (ranks
   1-4), ``csrc/streamed_cg_any.cu`` (any rank), ``csrc/fused.cu``,
   ``csrc/gram_pair.cu``, ``csrc/probes.cu`` (the two residency probes
   and the chunk reader) and ``csrc/segment_sum.cu`` with
   nvcc from this checkout, all at once, and prints each build's seconds
   and ``-Xptxas -v`` report;
3. kernel parity: ``stpcg_flat_streamed`` on the card against its plain
   PyTorch version on the same inputs, at n = 2^20 and a ragged n, over
   storage dtype x body x init x Delta x fixture, then its preconditioned
   variant over P (the shifted-Jacobi powers e = 1/2 and 1/4, a stored P
   unrelated to the diagonal) x storage dtype x body x Delta, each plus a
   bitwise repeat; then the general rank (``GEN_OPS``: K = 1, 3, 4 with
   every term form -- generated, stored, wrapped callable -- and K = 5, 8,
   16 with ``gen_weights``' distinct weights of every form) over n x
   storage dtype x body x init x Delta, and every ``prec_chunk`` form (the
   JacobiPower on A0, a stored P, a wrapped callable's P) at each K, each
   case launched twice and the two bit for bit equal; then ``GEN_MIXES``
   (a generated weight crossing zero at K = 8, all weights generated at
   K = 64, all stored at K = 32) over n (the pair body at 2^20, the single
   at the ragged n) x storage dtype x Delta and the JacobiPower, each with
   its bitwise repeat;
4. main path: the headline TNT solve (``optimization_tpu_torch/headline.py``)
   at n = 2^24 in both tiers, the f32 tier through the kernel (its launch
   count checked against the subproblems solved), then the f32 tier again
   with the plain version in the kernel's place; the 50-CG subproblem's
   time is printed beside the 7.36-7.46 ms the kernel took before it took
   any rank k;
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
7. ``gram_pair`` (``csrc/gram_pair.cu``) against its plain version (and a
   float64 product) at 100,000 x 48, 999 x 30, 16 x 10,000 x 48, 5,000 x
   96, 30,000 x 8, 16, 24 and 33 and 3,000 x 8 and 24 (the pose path's
   spectral inits and certificates at n = 10^4 and 1,000: nx = 8, then S
   of 3 nx), the fleet 3 x 777 x 17 (instances that start off 16-byte
   boundaries), and the panel route's 100,000 x 97, 120, 128, 129 and
   192, 20,000 x 256 and 16 x 10,000 x 120 (nx = 33, 40, 64), with BS
   distinct and with BS = S (the route that reads S once),
   ``stream3_probe`` at n = 2^24, 999,999 and 100, f32 and bf16, bitwise
   repeats; gram_pair timed at 100,000 x 48 (BS distinct and BS = S, the
   LOBPCG call), 16 x 10,000 x 48 and each k > 96 shape (BS distinct and
   BS = S) in f32 and bf16 beside its plain version, the one-call library
   product (``torch.matmul``) and its bound, warm and, where the inputs
   fit in the 50 MB L2, cold (the fraction of the bound on the cold
   time); stream3_probe's GB/s at n = 2^24 f32 is the measured bandwidth
   ceiling;
8. the eigensolver path: ``lobpcg`` on config3 (m = 1e5, nx = 16, nev = 5,
   A = diag(linspace(1, m)), the exact inverse preconditioner; a converged
   f32 solve with ``rr_method`` "eigh" then "chol", gated at
   max|theta - (1..5)| < 5e-2, nev converged, pencil consistent; the f64
   matmul route as the reference), then one f32 "eigh" solve at nx = 40
   (a basis of 120 columns: gram_pair's panel route) with the same gates
   against its own f64 solve, ``lobpcg_fleet`` on config10 (16 x
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
12. the two residency probe kernels against their plain versions on the
   card: ``pinned_stream`` and ``resident_body`` at n = 2^20, 999,999 and
   100, K = 3 and 10, every arm (with and without s; x held or streamed;
   r, p resident or streamed; bf16 and f32 storage), vectors norm to norm,
   acc relative, a bitwise repeat, and the two arms of a kernel bitwise
   equal;
13. the probes' timing at n = 2^24 (what ``probe_pinned_stream.py`` and
   ``probe_resident_body.py`` print): ms an iteration by the two-point
   slope over K = 40 and 400 for ``stream5``, ``stream7``, ``pin4``,
   ``pin6``, ``body_streamed`` and ``body_resident`` (also at n = 2^22,
   fully resident), GB/s over the measured ceiling, the share held on
   chip; launches counted; then both kernels against their plain versions
   at n = 2^24, K = 40, where shared memory holds a part only (and
   ``resident_body`` where x is held in part), at phase 12's limits, and
   ``resident_body``'s bound from the card's own shared memory and L2;
14. the convex path at the width of ``benchmarks/config4_lasso.py`` (LASSO,
   m = 1500, n = 5000 dense f32, B = 1), data from a seeded generator on
   the card: FISTA with config4's params, ISTA to the same F, ADMM (the
   splitting of ``examples/lasso.py``, one Cholesky factor) simple and
   accelerated, gated on their statuses and on agreeing with FISTA;
   ``drive(proximal_gradient)`` and ``drive_admm`` bitwise equal to the
   monolithic runs; host reads counted;
15. the chunk reader (``kernels.chunk_reader``, ``csrc/probes.cu``) and its
   plain version against a float64 sum of the same chunks, at v of 2^19
   rows (N = 2^26) and 1,001 rows, integer-valued (bit for bit) and normal,
   gr = 1, 8, 64, 512, 2048 rows of 128 words, contiguous and LCG-random
   offsets, n_fetch 1, 3, 2048 (past nch on the small v) and nch, a bitwise
   repeat, and the fetch whose LCG value is INT32_MIN;
16. the graph probe (what ``probe_graph_stream.py`` prints): the chunk
   reader's arms over N = 2^26 f32 words, microseconds a chunk by the
   two-point slope over nch / 4 and nch fetches (L2 evicted before every
   call), GB/s over the ceiling and 3.35 TB/s, the random arms' share of
   re-reads within the L2's reach, its launches counted; each arm's two
   calls and the kernels line's call bit for bit equal to the plain
   version and the f64 sum (v holds integers); that call timed beside its
   plain version and its bound; then
   ``connection_laplacian_op`` at n_rot = 2^21 for each scatter_method,
   ms an apply against the probe's floor, peak memory, gated within 1e-5
   of an f64 apply and of each other and on a repeat of each apply bit for
   bit the first; then the segment-sum kernel (``csrc/segment_sum.cu``, the
   graph models' edge->vertex sums and the pullback of every gather by a
   graph index) against its plain version at the models' shapes at
   config6's size (``SEGMENT_CASES``, f32 and f64, each width's instance,
   the generic one and a hub; int32 plans and the same plans widened to
   int64) and at that apply: bit for bit the plain version on the CPU,
   within ``SEGMENT_TOL`` of the card's, a repeat bit for bit; timed at
   that apply beside its plain version, ``index_add_`` and its bound; its
   launches are counted over phases 17-21 and, apart, phase 22;
17. rotation sync at config6's rotation graph (n = 10,000, odometry chain
   + 20,000 random closures, noise 0.01), f32, made on the card: spectral
   init three times, TNT through ``make_problem()``,
   ``(preconditioned=True)`` (twice) and ``(flat=True)`` from one R0,
   ``solve_staircase`` with its certificate; gated on the three spectral
   inits' LOBPCG iterations and R0 digests equal, the two preconditioned
   solves' statuses, counts and digests equal, GRADIENT, f within 1e-4
   across the routes, mean rotation error < 4 noise, certified, R on
   SO(3)^n, gram_pair launches = 1 + iterations for every LOBPCG solve;
18. a staircase lift on the card: the ring of tests/test_rotation_sync.py
   in f64 from an R0 whose level-d certificate fails; gated on p_final >
   d, certified, rank_gap < 1e-6;
19. matrix completion at config9's width (5000 x 4000, k = 10, 10 %
   observed, noise 0.01, its TNT params), f32, made on the card; gated on
   the relative error over all entries < 5 noise; its f32 gain ratios, and
   the same solve in float64 as a witness, gated on GRADIENT;
20. SE(d) pose synchronization at config6's width
   (``benchmarks/config6_pose_graph_10k.py``: 10^4 SE(3) poses, odometry
   chain + 20,000 random closures, noise 0.01, t at scale 5), the graph
   made on the host from a seed and written by ``io.g2o.save_g2o``, solved
   through the CLI in-process (``cli.main(["solve", path,
   "--marginalized", "--certify", "--json", "--out", npz])``, f32);
   gated on rc 0, certified, rotation error < 4 noise; the loader and its
   ms, each stage's wall, TNT outer / CG, LSQR and certificate iterations,
   the inner PCG iterations a solve, host reads; then the certificate at
   the solved point with the loose (60 iterations, rtol 1e-4) and the
   optimizer-grade inner operator, gated on the same decision and
   |lam_min loose - lam_min tight| < eta, with the loose operator's largest
   relative inner residual;
21. the other pose routes in f32: the chordal two-stage and the staircase
   pipelines on config6's graph (certified, rotation error < 4 noise),
   ``solve_robust_se`` on ``tests/test_pose_sync.py:TestRobustSE``'s
   fixture shape at n = 1,000 (chain + 4n closures, 20 % corrupted, half
   full SE(3), half translation-only; the test's gates, adapted to the
   larger graph: every vertex with a corrupted majority flagged, the errors
   and the translation weights on the identifiable vertices, the rotation
   weights of the full outliers that lie more than 0.25 rad from the truth),
   ``rotation_sync.solve_robust`` on its rotations, one inner Laplacian
   solve per engine (``cg``, ``flat`` at s = 2) on config6's graph, k = 3,
   edge differences within 1e-4 relative; ``gram_pair``'s launches over
   phases 20-21 join its count on the kernels line, and each of them is
   held against the plain version on its own S, AS, BS (phase 7's
   tolerance), its error joining the kernels line's;
22. range-aided pose sync (``models/range_sync.py``) in f32 at config6's
   scale, n = 10^4 SE(3) poses, made on the card: (a) a noisy chain with
   20,000 ranges (noise 0.01, range noise 0.001) solved with the ranges and
   with rho = 0, (b) a noiseless instance with 10,000 extra edges and
   10,000 ranges; each stage's wall (spectral init with its LOBPCG
   iterations, LSQR, TNT outer / CG) and host reads; gated on the JAX
   tests' contracts: the ranges tighten the translations by more than
   1.5x, bearings unit within 1e-5, t[0] == 0 exactly, and (b)'s f,
   rotation and translation errors under the f32 floors of
   ``RANGE_FLOORS``, and on ``segment_sum`` launched in the phase (its
   objective's gradient and hvp pull every gather back through it);
23. the ``parallel`` package on one card: an NCCL group of one rank
   (``initialize_distributed`` over tcp://127.0.0.1), ``pdot`` / ``pnorm``
   / ``pmean_tree`` at n = 2^24 equal to the local reductions and bitwise
   repeatable, ``sharded_gram_pair`` at 100,000 x 48 equal to
   ``gram_pair``, the row-sharded LOBPCG at config3 (theta within 1e-5 of
   the unsharded solve), the block-partitioned TNT on ``DTensor``s at n =
   2^24 (run_tier's Rayleigh quotient and caps, automatic derivatives;
   status and f* within 1e-5 of the unsharded solve), ``batch_sharded_solve``
   on a config4 LASSO fleet (B = 4, FISTA; each instance bitwise equal to
   its own solve), consensus ADMM on config4's rows in 4 scenarios
   (objective within 2% of full-data FISTA); then two ranks sharing the
   card over gloo (``chip_smoke.py --gloo-rank``; their block TNT capped
   at ``GLOO_OUTER`` outer iterations, since gloo stages each all-reduce
   through the host), held to the world-1 results where gloo takes CUDA
   tensors; every ``gram_pair`` launch of phases 22-23 held against the
   plain version on its own inputs;
24. the kernel at rank K = 1, 3, 4 and (``csrc/streamed_cg_any.cu``)
   K = 5, 8, 16, 32 f32 with ``gen_weights``' mix of generated and stored
   terms, K = 8 bf16 and K = 8 with a generated P, and ``GEN_MIXES``' three
   operators (``MIX_TIMED``): one 50-CG subproblem
   each at n = 2^24 (on a kappa ~ 1000 operator; K = 3 and 8 also the
   rank-3 and rank-8 TNT's own subproblems at their 11th outer
   iteration), held against the plain version and timed beside its bound
   (``subproblem_bound``: bytes or operations); the any-K kernel's fixed
   cost a CG iteration at K = 8, 16, 64 (n = 2^16); then the rank-3 and
   rank-8 TNT (``Quartic``: the sphere Rayleigh quotient with one quartic
   term, k = 3, or six, k = 8, three of their c_j stored and three
   generated) at n = 2^24, ``headline.tier_params``, through the kernel
   (``flat_solve``) and the eager flat engine (``flat_qm``), gated on equal
   statuses and outer counts, f* within 1e-4 relative, CG within 10% and
   kernel launches = subproblems, CG it/s printed for both;
25. the examples (``optimization_tpu_torch/examples``): every example's
   ``main()`` in process on the card at the JAX example's sizes, each
   applying the JAX example's acceptance check; its wall time, statuses
   and counts and its ``gram_pair`` launches (> 0 exactly for the examples
   whose path runs LOBPCG), every launch held against the plain version on
   its own S, AS, BS (phase 7's tolerance) and counted on the kernels line;
26. ``python -m optimization_tpu_torch.examples.lobpcg_example`` in a
   subprocess, as a user runs it: exit 0, the same iteration and converged
   counts as phase 25's run;
27. each streaming kernel's GB/s as a fraction of the measured ceiling, the
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
import contextlib
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
SOURCES = ("streamed_cg", "streamed_cg_any", "fused", "gram_pair",
           "probes", "segment_sum")
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
    from optimization_tpu_torch.kernels.streamed_cg import (JacobiPower,
                                                            stored_prec_map)

    n, dev = g.shape[0], g.device
    if form == "stored":
        i = torch.arange(n, device=dev)
        p = torch.rsqrt(1.0 + 0.25 * (i % 13).float())
        return p, stored_prec_map(p)
    desc = JacobiPower(1.0, 0.5 if form == "jacobi" else 0.25)
    return desc, desc.map(diag, rq, n, dev)


def permuted_plain(torch, args, kwargs, diag):
    """The plain version on the same subproblem with its indices permuted
    (a stored diagonal and a stored P of the same values): the same
    mathematics, its sums in another order.  Returns its iteration count
    and its step, unpermuted."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        sphere_rayleigh_streamed, stored_prec_map,
        stpcg_flat_streamed_reference)

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
               prec=stored_prec_map(p)))
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


def check_parity(torch, res, ref, dtype, label, dit=None, prec=False):
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
    3e-2.  ``prec``: f32 with a preconditioner other than the sphere's
    (phase 3's general cases) takes the tolerances of
    tests/test_streamed_cg.py::test_prec_matches_xla_prec_engine at any
    count: counts within 1 (or ``dit``), s within 3e-4, M-norm rtol 2e-4,
    predicted decrease rtol 2e-3 (the kernel's round-to-nearest rsqrt and
    CUDA's torch.rsqrt differ in the last bit of p, and a rank-3 P H P
    carries that to 5.7e-5 of |s| within 8 iterations on an H100).
    Returns max |s - s_ref|."""
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
    elif prec:
        ok = (abs(ki - kr) <= (dit or 1) and rel <= 3e-4
              and abs(mn - mn_ref) <= 2e-4 * abs(mn_ref)
              and abs(pd - pd_ref) <= 2e-3 * abs(pd_ref) + 1e-8)
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
    gcases = general_parity(torch, dev)
    mcases = mix_parity(torch, dev)
    print(f"phase 3: {cases} sphere cases + 2 bitwise repeats, {gcases} "
          f"general cases (K = 1, 3, 4, 5, 8, 16) and {mcases} of GEN_MIXES "
          f"(K = 8, 64, 32) each with a bitwise repeat passed", flush=True)



# ---- the general rank k: phase 3's cases, phase 24 ----

GEN_AUX = (0.5, 0.75)
# (a0, weights) of phase 3's general cases: every term form among them
# (the forms of tests/test_torch_streamed_cg.py); K >= 5
# (csrc/streamed_cg_any.cu) takes gen_weights (None); phase 24 times its own
GEN_OPS = {1: ("affine", ("stored",)),
           3: ("shifted", ("one", "twice", "fn")),
           4: ("fn", ("one", "twice", "stored", "fn")),
           5: ("shifted", None), 8: ("fn", None), 16: ("stored", None)}
GEN_PREC_FORMS = ("jacobi", "quarter", "stored", "fn")


def gen_term(torch, form, n, dev, spread=8.0):
    """A descriptor of one term: ``affine`` 1 + b i (b = spread / (n - 1)),
    ``twice`` / ``shifted`` its ScaledDiagonal / ShiftedDiagonal,
    ``stored`` 1 + (i mod 13)/4 as a tensor, ``fn`` 0.5 + aux[1] (i mod
    97)/8 as a wrapped callable (an ElementwiseFn), ``one`` the weight 1."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        AffineDiagonal, ElementwiseFn, ScaledDiagonal, ShiftedDiagonal)

    aff = AffineDiagonal(1.0, spread / (n - 1))
    if form == "stored":
        return 1.0 + 0.25 * (torch.arange(n, device=dev) % 13).float()
    if form == "fn":
        return ElementwiseFn(
            lambda i, aux: 0.5 + aux[1] * ((i % 97).float() / 8.0))
    return {"one": None, "affine": aff, "twice": ScaledDiagonal(aff),
            "shifted": ShiftedDiagonal(aff)}[form]


GEN_CYCLE = ("twice", "stored", "fn", "affine")


def gen_weights(torch, k, n, dev):
    """k distinct weights of order 1 for the rank K >= 5 cases: the weight
    1, then ScaledDiagonal, stored, wrapped and affine in turn, each with
    its own coefficients (values in [0.5, 2]).  Weights repeated across j
    (U with equal columns) give H outlying eigenvalues at which CG's step
    count moves by 2 when only the order of the sums changes; with these,
    the plain version on permuted indices stops within 1 of itself up to
    K = 212 (n = 2^16)."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        AffineDiagonal, ElementwiseFn, ScaledDiagonal)

    def weight(j):
        form = GEN_CYCLE[(j - 1) % 4]
        if form == "twice":
            return ScaledDiagonal(AffineDiagonal(0.25 + 0.002 * j,
                                                 0.5 / (n - 1)))
        if form == "affine":
            return AffineDiagonal(0.5 + 0.003 * j, 1.0 / (n - 1))
        if form == "stored":
            return 0.5 + ((torch.arange(n, device=dev) + 7 * j) % 13
                          ).float() / 12.0
        m = 89 + j
        return ElementwiseFn(lambda i, aux: 0.5 + aux[1] * ((i % m).float()
                                                             / m))

    return (None,) + tuple(weight(j) for j in range(1, k))


def gen_args(torch, k, n, dtype, dev, seed=3):
    """(g, x, B, aux) on the card: a unit g and x from a seeded generator,
    B = 0.3 G G' / k (positive semi-definite)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(n, generator=gen, device=dev)
    x = torch.randn(n, generator=gen, device=dev)
    G = torch.randn(k, k, generator=gen, device=dev)
    aux = tuple(torch.tensor(a, device=dev) for a in GEN_AUX)
    return ((g / torch.linalg.vector_norm(g)).to(dtype),
            (x / torch.linalg.vector_norm(x)).to(dtype), 0.3 * G @ G.T / k,
            aux)


def gen_init(torch, g, x, B, a0c, weights, aux):
    """The threaded init group of the operator (the port's flat engine
    helper on its materialized A0 and U)."""
    from optimization_tpu_torch.kernels import streamed_cg as T
    from optimization_tpu_torch.linalg.flat_cg import flat_init_dots

    n, dev = g.shape[0], g.device
    a0 = T._a0_values(a0c, n, aux, dev)
    U = tuple(x.float() if w is None
              else T._weight_values(w, n, aux, dev) * x.float()
              for w in weights)
    return flat_init_dots(g, lambda v: a0 * v.float(), U, B)


def gen_prec(torch, form, a0c, aux, n, dev):
    """(prec_chunk, prec) on the operator's A0: the JacobiPower (|a0| +
    1)^(-1/2) or ^(-1/4), a stored P unrelated to A0 (1 + (i mod 13)/4)^
    (-1/2), or a wrapped callable's (1 + aux[1] (i mod 5))^(-1/2)."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        ElementwiseFn, JacobiPower, prec_map)

    if form == "stored":
        pc = torch.rsqrt(1.0 + 0.25 * (torch.arange(n, device=dev) % 13)
                         .float())
    elif form == "fn":
        pc = ElementwiseFn(
            lambda i, a: torch.rsqrt(1.0 + a[1] * (i % 5).float()))
    else:
        pc = JacobiPower(1.0, 0.5 if form == "jacobi" else 0.25)
    return pc, prec_map(pc, a0c, aux, n, dev)


def gen_operator(torch, k, n, dev):
    """(label, a0_chunk, weights) of phase 3's rank-k operator."""
    a0_form, w_forms = GEN_OPS[k]
    a0c = gen_term(torch, a0_form, n, dev)
    if w_forms is None:
        return f"{a0_form}/gen_weights", a0c, gen_weights(torch, k, n, dev)
    return (f"{a0_form}/{','.join(w_forms)}", a0c,
            tuple(gen_term(torch, f, n, dev) for f in w_forms))


def bitwise_same(torch, r1, r2):
    return (torch.equal(r1.s, r2.s)
            and all(torch.equal(u, v) for u, v in zip(r1[1:], r2[1:])))


def general_parity(torch, dev):
    """Phase 3's general cases: the kernel at K = 1, 3, 4 (csrc/
    streamed_cg.cu) and 5, 8, 16 (csrc/streamed_cg_any.cu) against its
    plain version over n x storage x body x init x Delta, then every
    prec_chunk form; each case launched twice, the two bit for bit equal.
    Returns the number of cases."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        stpcg_flat_streamed, stpcg_flat_streamed_reference)

    cases = 0
    kw = dict(max_iterations=300, kappa_fgr=1e-3, theta=0.9)
    for k, n, dtype, body, with_init in itertools.product(
            GEN_OPS, N_PARITY, (torch.float32, torch.bfloat16),
            ("pair", "single"), (False, True)):
        g, x, B, aux = gen_args(torch, k, n, dtype, dev)
        forms, a0c, weights = gen_operator(torch, k, n, dev)
        init = (gen_init(torch, g, x, B, a0c, weights, aux) if with_init
                else None)
        # Delta 0.15 ends on the boundary after some interior iterations
        for Delta in ((1e6, 0.15) if dtype == torch.float32
                      else (1.0, 0.15)):
            args = (g, x, B, Delta, aux)
            kwargs = dict(kw, a0_chunk=a0c, weights=weights, body_kind=body,
                          init=init)
            res = stpcg_flat_streamed(*args, **kwargs)
            again = stpcg_flat_streamed(*args, **kwargs)
            ref = stpcg_flat_streamed_reference(*args, **kwargs)
            torch.cuda.synchronize()
            label = (f"K={k} {forms} n={n} {str(dtype)[6:]} {body} "
                     f"init={int(with_init)} Delta={Delta:g}")
            check_parity(torch, res, ref, dtype, label)
            if not bitwise_same(torch, res, again):
                raise AssertionError(f"two launches differ: {label}")
            cases += 1
    # every prec_chunk form; a stored or wrapped P unrelated to A0 conditions
    # P H P worse, and is held as the sphere's stored P above (counts within
    # 3, the long-run tolerances: the sums' order alone moves the count,
    # 26/25 at K = 3, n = 2^20 on an H100); the JacobiPower at the
    # preconditioned tolerances of check_parity(prec=True)
    for k, n, dtype, form in itertools.product(
            GEN_OPS, N_PARITY, (torch.float32, torch.bfloat16),
            GEN_PREC_FORMS):
        g, x, B, aux = gen_args(torch, k, n, dtype, dev, seed=5)
        _, a0c, weights = gen_operator(torch, k, n, dev)
        pc, pmap = gen_prec(torch, form, a0c, aux, n, dev)
        body = "pair" if n == N_PARITY[0] else "single"
        for Delta in ((1e6, 0.15) if dtype == torch.float32 else (0.15,)):
            args = (g, x, B, Delta, aux)
            kwargs = dict(kw, a0_chunk=a0c, weights=weights, body_kind=body,
                          prec_chunk=pc, prec=pmap)
            res = stpcg_flat_streamed(*args, **kwargs)
            again = stpcg_flat_streamed(*args, **kwargs)
            ref = stpcg_flat_streamed_reference(*args, **kwargs)
            torch.cuda.synchronize()
            label = (f"K={k} prec {form} n={n} {str(dtype)[6:]} {body} "
                     f"Delta={Delta:g}")
            unrelated = form in ("stored", "fn")
            check_parity(torch, res, ref, dtype, label,
                         dit=3 if unrelated else None, prec=not unrelated)
            if not bitwise_same(torch, res, again):
                raise AssertionError(f"two launches differ: {label}")
            cases += 1
    return cases

# phase 3's and phase 24's weight mixes beyond gen_weights (K, mix): a
# generated weight crossing zero in [0, n), every weight generated (all
# folded: no stored weight), every weight stored (two stages of them)
GEN_MIXES = ((8, "crossing"), (64, "generated"), (32, "stored"))


def mix_weights(torch, mix, k, n, dev):
    """The weights of a GEN_MIXES mix: ``crossing`` gen_weights with its
    affine weight (j = 4) replaced by -0.5 + i / (n - 1); ``generated`` k
    distinct generated weights (affine and ScaledDiagonal in turn);
    ``stored`` k distinct stored weights (tensors and wrapped callables in
    turn, each its own period)."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        AffineDiagonal, ElementwiseFn, ScaledDiagonal)

    if mix == "crossing":
        ws = list(gen_weights(torch, k, n, dev))
        ws[4] = AffineDiagonal(-0.5, 1.0 / (n - 1))
        return tuple(ws)
    if mix == "generated":
        return tuple(
            AffineDiagonal(0.5 + 0.003 * j, 1.0 / (n - 1)) if j % 2 else
            ScaledDiagonal(AffineDiagonal(0.25 + 0.002 * j, 0.5 / (n - 1)))
            for j in range(k))
    i = torch.arange(n, device=dev)
    return tuple(
        0.5 + ((i + 3 * j) % (11 + j)).float() / (11 + j) if j % 2 else
        ElementwiseFn(lambda i, aux, m=11 + j: 0.5 + aux[1] * (
            (i % m).float() / m))
        for j in range(k))


def mix_parity(torch, dev):
    """Phase 3's GEN_MIXES cases: each mix against the plain version over
    n x storage x Delta (and once with the JacobiPower), the pair body at
    n = 2^20 and the single at the ragged n, each launched twice and the
    two bit for bit equal.  Returns the number of cases."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        JacobiPower, prec_map, stpcg_flat_streamed,
        stpcg_flat_streamed_reference)

    cases = 0
    kw = dict(max_iterations=300, kappa_fgr=1e-3, theta=0.9)
    for (k, mix), n, dtype in itertools.product(
            GEN_MIXES, N_PARITY, (torch.float32, torch.bfloat16)):
        body = "pair" if n == N_PARITY[0] else "single"
        g, x, B, aux = gen_args(torch, k, n, dtype, dev)
        a0c = gen_term(torch, "shifted", n, dev)
        weights = mix_weights(torch, mix, k, n, dev)
        deltas = (1e6, 0.15) if dtype == torch.float32 else (1.0, 0.15)
        for Delta, jacobi in [(d, False) for d in deltas] + [(deltas[0],
                                                              True)]:
            kwargs = dict(kw, a0_chunk=a0c, weights=weights, body_kind=body)
            if jacobi:
                pc = JacobiPower(1.0, 0.5)
                kwargs.update(prec_chunk=pc,
                              prec=prec_map(pc, a0c, aux, n, dev))
            args = (g, x, B, Delta, aux)
            res = stpcg_flat_streamed(*args, **kwargs)
            again = stpcg_flat_streamed(*args, **kwargs)
            ref = stpcg_flat_streamed_reference(*args, **kwargs)
            torch.cuda.synchronize()
            label = (f"K={k} {mix} n={n} {str(dtype)[6:]} {body} "
                     f"Delta={Delta:g}{' P=jacobi' if jacobi else ''}")
            check_parity(torch, res, ref, dtype, label, prec=jacobi)
            if not bitwise_same(torch, res, again):
                raise AssertionError(f"two launches differ: {label}")
            cases += 1
    return cases


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
          f"at 6n words an iteration; 7.36-7.46 ms on the same card model "
          f"before the kernel took any rank k), plain {plain_ms:.3f} ms "
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


SOURCE_OF = {"gram_pair": "gram_pair.cu", "stream3_probe": "fused.cu"}
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
      both sum in f32 in other orders (the kernel a wgmma chain a row tile,
      folded into f32 sums over a block's tiles, then the blocks in double;
      cuBLAS in its own split); at the long-chain shapes (GRAM_LONG) against the float64
      product alone: there the plain version's own f32 sums can miss the
      same tolerance (its err/tol against float64 is printed, not gated);
    stream3_probe: f32 bit for bit (the same three roundings in the same
      order); bf16 2^-6 |(d+2) v scale| -- the plain version rounds after
      each bf16 operation, the kernel once on store.
"""
GRAM_SHAPES = ((100_000, 48), (999, 30), (16, 10_000, 48), (5_000, 96),
               (30_000, 8), (30_000, 16), (30_000, 24), (30_000, 33),
               (3_000, 8), (3_000, 24), (3, 777, 17))
# k > 96: LOBPCG's basis of nx = 33, 40 and 64 (3 nx columns) at config3's
# m, and config10's fleet at nx = 40; k = 128 (two full 64-column slabs,
# one chunk), 129 (three slabs, two chunks, rows not 16-byte aligned), 256
# (two full chunks of 128)
GRAM_WIDE = ((100_000, 97), (100_000, 120), (100_000, 128), (100_000, 129),
             (100_000, 192), (20_000, 256), (16, 10_000, 120))
# long row streams a block: chains the kernel folds every row tile (4
# times config3's m; a fleet of 2 at config3's m; LOBPCG's nx = 32 at
# config3's m)
GRAM_LONG = ((400_000, 48), (2, 100_000, 48), (100_000, 96))
# the timed shapes: config3's Gram stage with BS distinct and BS = S (the
# LOBPCG call without B, the path's; its entry in the kernels line), and
# config10's fleet; then each wide shape, BS distinct and BS = S
GRAM_TIMED = (((100_000, 48), False), ((100_000, 48), True),
              ((16, 10_000, 48), False)) + tuple(
    (shape, same) for shape in GRAM_WIDE for same in (False, True))
N_STREAM3 = (1 << 24, 999_999, 100)


L2_BYTES = 50 * 2**20     # the H100's L2 (data sheet)


def gram_fits_l2(shape, same, dtype, torch):
    """Whether one gram_pair call's inputs fit in the L2 (then a warm
    loop reads them from L2, and the time held to the device-memory bound
    is the cold one)."""
    size = 2 if dtype == torch.bfloat16 else 4
    return (2 if same else 3) * math.prod(shape) * size < L2_BYTES


def l2_flush_buffer(torch, dev):
    """128 MB on the card whose reading evicts the L2 (time_cold_ms)."""
    return torch.ones(32 * 2**20, dtype=torch.float32, device=dev)


def time_cold_ms(torch, fn, reps, flush):
    """Mean milliseconds per call by CUDA events with the L2 flushed
    before each call: ``flush`` (``l2_flush_buffer``, 128 MB) is read
    through outside the timed events.  It is read, not written: written, the
    L2 would hold its dirty lines, and their write-back would land inside
    the timed call.  A spin kernel before each flush holds the card while
    the host enqueues the call, so the events time the device's work."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, stop in events:
        torch.cuda._sleep(2_000_000)
        flush.sum()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def gram_bound(shape, same, dtype, torch):
    """(ms, bound_by) of one gram_pair call: 3mk words read (2mk when BS is
    S), 2 k^2 F written; m k (2k) multiply-adds, or m k (k + (k + 1) / 2)
    when BS is S (S'S is symmetric: its upper triangle), three times over
    on the TF32 tensor cores for f32 storage (the 3xTF32 split), once in
    bf16."""
    rows, k = math.prod(shape[:-1]), shape[-1]
    fleet = math.prod(shape[:-2]) if len(shape) > 2 else 1
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = (2 if same else 3) * rows * k * size + fleet * 2 * k * k * 4
    flops = 2 * rows * k * (k + (k + 1) / 2 if same else 2 * k)
    if dtype == torch.bfloat16:
        return bound(nbytes, flops, "bf16")
    return bound(nbytes, 3 * flops, "tf32")


def hold_gram(torch, tag, got, ref, S, X, long_chain):
    """One Gram of gram_pair within 1e-5 sum|S||X| of the plain version's
    (unless long_chain) and of the float64 product; returns max |err|
    against the first of them."""
    Sd, Xd = S.double(), X.double()
    tol = 1e-5 * (Sd.abs().mT @ Xd.abs())
    exact = Sd.mT @ Xd
    err = 0.0
    if long_chain:
        ratio = float(((ref.double() - exact).abs() / tol).max())
        print(f"  --   plain version {tag} vs f64 (not gated): max err/tol "
              f"{ratio:.3f}", flush=True)
    else:
        err = check_close(torch, f"gram_pair {tag}", got, ref, tol)
    f64_err = check_close(torch, f"gram_pair {tag} vs f64", got, exact, tol)
    return f64_err if long_chain else err


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
    errs, cases, wide_err = {}, 0, 0.0
    for shape, dtype in itertools.product(
            GRAM_SHAPES + GRAM_LONG + GRAM_WIDE,
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
            err = max(err, hold_gram(torch, f"{name} {tag}", got, ref, S, X,
                                     shape in GRAM_LONG))
        same = torch.equal(ga, ga2) and torch.equal(gb, gb2)
        print(f"  {'ok  ' if same else 'FAIL'} bitwise repeat gram_pair "
              f"{tag}", flush=True)
        if not same:
            raise AssertionError(f"two runs of gram_pair differ: {tag}")
        errs.setdefault("gram_pair", err)
        if shape[-1] > 96:
            wide_err = max(wide_err, err)
        cases += 1
        # B = None in LOBPCG passes S as BS: S is read once
        ga, gb = F.gram_pair(S, AS, S)
        ra, rb = F.gram_pair_reference(S, AS, S.clone())
        for name, got, ref, X in (("S'AS", ga, ra, AS), ("S'S", gb, rb, S)):
            hold_gram(torch, f"BS = S {name} {tag}", got, ref, S, X,
                      shape in GRAM_LONG)
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
    # and [AS | BS], built outside the timed region; full f32, TF32 off);
    # the kernel warm and, where its inputs fit in L2, cold too
    times, wide = {}, []
    flush = l2_flush_buffer(torch, dev)
    for (shape, same), dtype in itertools.product(
            GRAM_TIMED, (torch.float32, torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(4)
        S, AS, BS = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(3))
        X = S if same else BS
        SX = torch.cat((AS, X), -1)
        ms = time_ms(torch, lambda: F.gram_pair(S, AS, X), 50)
        cold_ms = (time_cold_ms(torch, lambda: F.gram_pair(S, AS, X), 20,
                                flush)
                   if gram_fits_l2(shape, same, dtype, torch) else None)
        plain_ms = time_ms(torch, lambda: F.gram_pair_reference(S, AS, X),
                           50)
        lib_ms = time_ms(torch, lambda: torch.matmul(S.mT, SX), 50)
        bound_ms, bound_by = gram_bound(shape, same, dtype, torch)
        held_ms = cold_ms if cold_ms is not None else ms
        rows, k = S.numel() // shape[-1], shape[-1]
        words = 2 if same else 3
        gbs = words * rows * k * S.element_size() / held_ms / 1e6
        cold = f", cold {cold_ms:.4f} ms" if cold_ms is not None else ""
        print(f"  gram_pair {'x'.join(map(str, shape))} "
              f"{'BS = S' if same else 'BS distinct'} {str(dtype)[6:]}: "
              f"kernel warm {ms:.4f} ms{cold} (~{gbs:.0f} GB/s at {words}mk "
              f"words), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / held_ms:.3f} "
              f"of the bound{' (cold)' if cold else ''} [{label}]",
              flush=True)
        if same and dtype == torch.float32 and shape == GRAM_TIMED[1][0]:
            # the path's shape fits in L2: the line's ms is the cold time
            times["gram_pair"] = dict(ms=held_ms, warm_ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, library_ms=lib_ms)
        if k > 96:
            wide.append({"shape": list(shape), "bs": "S" if same else
                         "distinct", "dtype": str(dtype)[6:], "ms": ms,
                         "cold_ms": cold_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_ms})
    # the k > 96 route's shapes ride in gram_pair's entry of the kernels line
    times["gram_pair"]["wide"] = {"max_abs_err": wide_err, "calls": wide}

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


@contextlib.contextmanager
def held_gram_pair(torch):
    """Hold every ``gram_pair`` launch of the block against its plain
    version on the same S, AS, BS, with phase 7's tolerance (1e-5 sum_r
    |S[r,i] X[r,j]| per entry).  The LOBPCG Gram stage (``linalg/lobpcg.py
    _gram``, the kernel's one caller) is wrapped through its module
    attribute; the errors stay on the card until the block ends, so the
    check adds no host read.  Yields a dict that then holds ``calls``, the
    distinct ``shapes`` (with whether BS is S), ``err`` (the largest
    |kernel - plain|), ``scale`` (the largest |plain| entry) and ``ratio``
    (the largest |kernel - plain| / tolerance, <= 1 when every entry is
    within it; an entry whose tolerance is 0 must agree exactly)."""
    import importlib

    from optimization_tpu_torch.kernels import fused as F

    L = importlib.import_module("optimization_tpu_torch.linalg.lobpcg")
    gram, errs, held = L._gram, [], {"shapes": set()}

    def checked(S, AS, BS):
        got = gram(S, AS, BS)
        if S.dtype in (torch.float32, torch.bfloat16):
            held["shapes"].add((tuple(S.shape), BS is S))
            ref = F.gram_pair_reference(S, AS, BS)
            Sd = S.double().abs().mT
            for g, r, X in zip(got, ref, (AS, BS)):
                d = (g.double() - r.double()).abs()
                tol = 1e-5 * (Sd @ X.double().abs())
                ratio = torch.where(tol > 0, d / tol,
                                    torch.where(d == 0, 0.0, math.inf))
                errs.append(torch.stack((d.max(), r.abs().max(),
                                         ratio.nan_to_num(math.inf).max())))
        return got

    L._gram = checked
    try:
        yield held
    finally:
        L._gram = gram
    e = torch.stack(errs).amax(0).tolist() if errs else [0.0] * 3
    held.update(calls=len(errs) // 2, err=e[0], scale=e[1], ratio=e[2])


def lobpcg_phase(torch, dev, label):
    """Phase 8: the eigensolver path at full size (config3: m = 1e5, nx = 16,
    and nx = 40 once, nev = 5; config10: a fleet of 16 at m = 1e4), the Gram
    stage through gram_pair; gates, launch counts, block it/s, host syncs
    per iteration.  Returns gram_pair's launches on the path."""
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

    def config3(dtype, rr, max_iterations, tau, width=nx):
        # one X0 for both dtypes: drawn in f32, then cast
        d = torch.linspace(1.0, float(m), m, dtype=dtype, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        X0 = torch.randn((m, width), generator=gen, device=dev).to(dtype)
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
    # nx = 40: a basis of 120 columns, gram_pair's panel route (k > 64)
    wide, secs = timed_solve(
        torch, dev, lambda: config3(torch.float32, "eigh", 100, 1e-4, 40))
    expected += 1 + int(wide.num_iterations)
    if F.gram_pair.launches != expected:
        raise AssertionError(f"gram_pair launches {F.gram_pair.launches} != "
                             f"{expected} (1 + iterations per solve) after "
                             f"the nx = 40 solve")
    wide64, secs64 = timed_solve(
        torch, dev, lambda: config3(torch.float64, "eigh", 100, 1e-4, 40))
    err = float((wide.theta.double().cpu() - truth).abs().max())
    gap = float((wide.theta.double() - wide64.theta).abs().max())
    print(f"  nx = 40 (k = 120): f32 eigh {int(wide.num_iterations)} it, nc "
          f"{int(wide.num_converged)}, max|theta - (1..5)| {err:.3e}, "
          f"consistent {bool(wide.pencil_consistent)}, {secs:.3f} s; f64 "
          f"{int(wide64.num_iterations)} it, {secs64:.3f} s; f32 vs f64 "
          f"{gap:.3e} [{label}]", flush=True)
    if not (err < 5e-2 and gap < 5e-2 and int(wide.num_converged) >= nev
            and int(wide64.num_converged) >= nev
            and bool(wide.pencil_consistent)
            and bool(torch.isfinite(wide.X).all())
            and wide.X.shape == (m, nev)):
        raise AssertionError("config3 nx = 40: the gate failed")
    if F.gram_pair.launches != expected:
        raise AssertionError("the f64 route launched gram_pair")

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


# ---- the residency probe kernels (csrc/probes.cu) ----

N_PROBE = (1 << 20, 999_999, 100)
N_PARTLY_X = 6_000_001              # bf16: r, p and a part of x fit on chip
PROBE_K = (40, 400)                 # the two-point slope's iteration counts
PROBE_TOLERANCES = """\
  tolerances, kernel against plain version on the card:
    pinned_stream (f32): r, p, s norm to norm 1e-5, acc 1e-5 relative (the
      probe's own gate) -- the kernel contracts multiply-adds and sums its
      f32 partials in double in a fixed order, torch.sum in its own tree;
    resident_body: f32 storage r 1e-5, acc 1e-4; bf16 storage r 1e-3 (a
      last-bit difference before a store flips a bf16 rounding, 2^-8
      relative, in a few elements an iteration; measured <= 4e-5; a
      storage rounding skipped on a region would show as ~4e-3), acc 1e-3
      (the probe's own gate; a sum with large cancellation between dots);
    both arms of a kernel (held / streamed, resident / streamed) and two
      runs of one arm: bit for bit;
    the same limits at n = 2^24, K = 40 (phase 13), where shared memory
      holds a part only and the streamed regions' code runs.
"""


def probe_vectors(torch, n, dtype, dev, seed):
    """r, p, x ~ U(0.5, 1), the probes' inputs, from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(0.5 + 0.5 * torch.rand(n, generator=gen, device=dev)).to(dtype)
            for _ in range(3)]


def _rel_norm(torch, got, ref):
    got, ref = got.double(), ref.double()
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def probe_parity_phase(torch, dev):
    """Both probe kernels against their plain versions at sizes that
    shared memory holds whole (``probe_full_width_check`` has the rest)."""
    from optimization_tpu_torch.kernels import probes as P

    print("phase 12: residency probe kernels vs plain versions on the card",
          flush=True)
    print(PROBE_TOLERANCES, end="", flush=True)
    cases = 0

    def check(label, ok, detail):
        print(f"  {'ok  ' if ok else 'FAIL'} {label}: {detail}", flush=True)
        if not ok:
            raise AssertionError(f"probe kernel disagrees: {label}")

    for n, K, with_s in itertools.product(N_PROBE, (3, 10), (False, True)):
        r, p, x = probe_vectors(torch, n, torch.float32, dev, n % 997)
        s = torch.zeros(n, device=dev) if with_s else None
        ref = P.pinned_stream_reference(r, p, x, s, iterations=K)
        arms = {name: P.pinned_stream(r, p, x, s, iterations=K, **kw)
                for name, kw in (
                    ("streamed", dict(hold_x=False)),
                    ("held", dict(hold_x=True)),
                    ("repeat", dict(hold_x=True)))}
        torch.cuda.synchronize()
        out = arms["held"]
        rels = [_rel_norm(torch, u, v) for u, v in zip(out[:3], ref[:3])
                if u is not None]
        acc_rel = abs(float(out[3]) - float(ref[3])) / abs(float(ref[3]))
        same = all(torch.equal(u, v) for arm in arms.values()
                   for u, v in zip(arm, out) if u is not None)
        tag = f"pinned_stream n={n} K={K} {'with s' if with_s else 'no s'}"
        check(tag, max(rels) <= 1e-5 and acc_rel <= 1e-5 and same
              and all(bool(torch.isfinite(u).all()) for u in out
                      if u is not None),
              f"max |dv|/|v| {max(rels):.2e}, acc rel {acc_rel:.2e}, three "
              f"runs (streamed, held, repeat) bitwise equal {same}")
        cases += 1

    for n, K, dtype in itertools.product(
            N_PROBE, (3, 10), (torch.bfloat16, torch.float32)):
        r, p, x = probe_vectors(torch, n, dtype, dev, n % 991)
        ref = P.resident_body_reference(r, p, x, iterations=K)
        arms = [P.resident_body(r, p, x, iterations=K, resident=res)
                for res in (False, True, True)]
        torch.cuda.synchronize()
        out = arms[1]
        rel = _rel_norm(torch, out[0], ref[0])
        acc_rel = abs(float(out[1]) - float(ref[1])) / abs(float(ref[1]))
        same = all(torch.equal(a[0], out[0]) and torch.equal(a[1], out[1])
                   for a in arms)
        bf16 = dtype == torch.bfloat16
        tag = f"resident_body n={n} K={K} {str(dtype)[6:]}"
        check(tag, rel <= (1e-3 if bf16 else 1e-5)
              and acc_rel <= (1e-3 if bf16 else 1e-4) and same
              and out[0].dtype == dtype
              and bool(torch.isfinite(out[0].float()).all()),
              f"|dr|/|r| {rel:.2e}, acc rel {acc_rel:.2e}, three runs "
              f"(streamed, resident, repeat) bitwise equal {same}")
        cases += 1
    print(f"phase 12: {cases} cases passed, each with its arms and a repeat "
          f"bitwise equal", flush=True)


def slope_ms(torch, call, reps=3, ks=PROBE_K):
    """Milliseconds an iteration by the two-point slope over ``ks`` (as
    the JAX probes time: the fixed cost of a call cancels), the best of
    ``reps``; each point is ``time_ms`` of one call."""
    k_lo, k_hi = ks
    best = math.inf
    for _ in range(reps):
        lo = time_ms(torch, lambda: call(k_lo), 1)
        hi = time_ms(torch, lambda: call(k_hi), 1)
        best = min(best, (hi - lo) / (k_hi - k_lo))
    return best


def stream3_ceiling(torch, dev):
    """GB/s of ``stream3_probe`` at n = 2^24 f32: the measured ceiling."""
    from optimization_tpu_torch.kernels import fused as F

    n = N_MAIN
    gen = torch.Generator(device=dev).manual_seed(8)
    v = torch.randn(n, generator=gen, device=dev)
    d = 1.0 + 999.0 * torch.rand(n, generator=gen, device=dev)
    return 3 * 4 * n / time_ms(torch, lambda: F.stream3_probe(d, v), 100) / 1e6


def pinned_stream_arms(torch, dev, label, ceiling, n=N_MAIN, window=False):
    """Time the arms of ``pinned_stream`` at n f32 elements (``window``:
    the two L2-window arms as well); prints one line an arm and returns
    {arm: (ms an iteration, held info)}."""
    from optimization_tpu_torch.kernels import probes as P

    r, p, x = probe_vectors(torch, n, torch.float32, dev, 1)
    s = torch.zeros(n, device=dev)
    out = {}
    for name, words, sv, kw in (
            ("stream5", 5, None, dict(hold_x=False)),
            ("stream7", 7, s, dict(hold_x=False)),
            ("pin4 (shared memory)", 4, None,
             dict(hold_x=True, l2_window=False)),
            ("pin4 (shared memory + L2 window)", 4, None,
             dict(hold_x=True, l2_window=True)),
            ("pin6 (shared memory)", 6, s,
             dict(hold_x=True, l2_window=False)),
            ("pin6 (shared memory + L2 window)", 6, s,
             dict(hold_x=True, l2_window=True))):
        if kw.get("l2_window") and not window:
            continue
        ms = slope_ms(torch, lambda k: P.pinned_stream(
            r, p, x, sv, iterations=k, **kw))
        held = P.pinned_stream.last_held
        # the words that have to come from device memory: x only where
        # neither shared memory nor the L2 window holds it
        real = words + (0.0 if name.startswith("stream") else
                        1.0 - held["x_shared"] - held["x_l2_window"])
        gbs = real * 4 * n / ms / 1e6
        bound_ms, _ = bound(words * 4 * n, 15 * n)
        print(f"  {name}: {ms:.4f} ms an iteration, {gbs:.0f} GB/s of "
              f"{real:.3f} n real words = {gbs / ceiling:.3f} of the measured "
              f"ceiling; bound at {words} n words {bound_ms:.4f} ms "
              f"({bound_ms / ms:.3f} of it); x held: shared memory "
              f"{held['x_shared']:.3f}, L2 window {held['x_l2_window']:.3f}; "
              f"n = {n} f32 [{label}]", flush=True)
        out[name] = (ms, held)
    return out


def resident_body_arms(torch, dev, label, ceiling, sizes=(N_MAIN, 1 << 22)):
    """Time the arms of ``resident_body`` in bf16 storage; prints one line
    an arm and returns {(arm, n): (ms an iteration, held info)}.  The GB/s
    count the words an iteration reads and writes outside shared memory;
    the kernel walks every other iteration backwards, so L2 serves the
    lines at each turn and a rate above the device-memory ceiling is
    possible."""
    from optimization_tpu_torch.kernels import probes as P

    out = {}
    for n in sizes:
        r, p, x = probe_vectors(torch, n, torch.bfloat16, dev, 2)
        for name, res in (("body_streamed", False), ("body_resident", True)):
            ms = slope_ms(torch, lambda k: P.resident_body(
                r, p, x, iterations=k, resident=res))
            held = P.resident_body.last_held
            real = (4.0 * (1.0 - held["rp_shared"])
                    + 1.0 - held["x_shared"])
            gbs = real * 2 * n / ms / 1e6
            b_bytes, _ = bound(5 * 2 * n, 0)
            b_ops, _ = bound(0, 25 * n)
            print(f"  {name}: {ms:.4f} ms an iteration, {gbs:.0f} GB/s of "
                  f"the {real:.3f} n bf16 words outside shared memory = "
                  f"{gbs / ceiling:.3f} of the measured ceiling; bounds: 5 n "
                  f"words streamed "
                  f"{b_bytes:.4f} ms, 25 flops an element {b_ops:.4f} ms; "
                  f"held in shared memory: r, p {held['rp_shared']:.3f}, x "
                  f"{held['x_shared']:.3f}; n = {n} bf16 [{label}]",
                  flush=True)
            out[(name, n)] = (ms, held)
    return out


def probe_full_width_check(torch, dev):
    """Both kernels against their plain versions where shared memory holds
    a part only, so that the streamed regions' code (``pinned_stream``'s
    grid-wide sweep, ``resident_body``'s r, p-only and streamed regions) is
    held to PROBE_TOLERANCES too: n = 2^24 at K = 40, and ``resident_body``
    in bf16 at n = N_PARTLY_X, where x is held in part.  Returns {name: max
    |err| of r at n = 2^24} (f32 without s; bf16)."""
    from optimization_tpu_torch.kernels import probes as P

    n, K = N_MAIN, PROBE_K[0]
    errs = {}

    def check(label, ok, detail):
        print(f"  {'ok  ' if ok else 'FAIL'} {label}: {detail}", flush=True)
        if not ok:
            raise AssertionError(f"probe kernel disagrees: {label}")

    r, p, x = probe_vectors(torch, n, torch.float32, dev, 1)
    for with_s in (False, True):
        s = torch.zeros(n, device=dev) if with_s else None
        ref = P.pinned_stream_reference(r, p, x, s, iterations=K)
        out = P.pinned_stream(r, p, x, s, iterations=K)
        share = P.pinned_stream.last_held["x_shared"]
        rels = [_rel_norm(torch, u, v) for u, v in zip(out[:3], ref[:3])
                if u is not None]
        acc_rel = abs(float(out[3]) - float(ref[3])) / abs(float(ref[3]))
        check(f"pinned_stream n={n} K={K} {'with s' if with_s else 'no s'}",
              max(rels) <= 1e-5 and acc_rel <= 1e-5 and 0.0 < share < 1.0,
              f"max |dv|/|v| {max(rels):.2e}, acc rel {acc_rel:.2e}, "
              f"{share:.3f} of x in shared memory")
        errs.setdefault("pinned_stream",
                        float((out[0] - ref[0]).abs().max()))
    for m, k, dtype in ((n, K, torch.bfloat16), (n, K, torch.float32),
                        (N_PARTLY_X, 10, torch.bfloat16)):
        r, p, x = probe_vectors(torch, m, dtype, dev, 2)
        ref = P.resident_body_reference(r, p, x, iterations=k)
        out = P.resident_body(r, p, x, iterations=k)
        held = P.resident_body.last_held
        rel = _rel_norm(torch, out[0], ref[0])
        acc_rel = abs(float(out[1]) - float(ref[1])) / abs(float(ref[1]))
        bf16 = dtype == torch.bfloat16
        partly = (0.0 < held["rp_shared"] < 1.0 if m == n else
                  held["rp_shared"] == 1.0 and 0.0 < held["x_shared"] < 1.0)
        check(f"resident_body n={m} K={k} {str(dtype)[6:]}",
              rel <= (1e-3 if bf16 else 1e-5)
              and acc_rel <= (1e-3 if bf16 else 1e-4) and partly,
              f"|dr|/|r| {rel:.2e}, acc rel {acc_rel:.2e}, in shared memory "
              f"{held['rp_shared']:.3f} of r, p and {held['x_shared']:.3f} "
              f"of x")
        err = float((out[0].float() - ref[0].float()).abs().max())
        if m == n and bf16:
            # one bf16 step at r's size, in the few elements whose rounding
            # a last-bit difference flipped
            print(f"       max |dr| {err:.3g} where max |r| is "
                  f"{float(ref[0].float().abs().max()):.3g}", flush=True)
        errs.setdefault("resident_body", err)
    return errs


def probe_timing_phase(torch, dev, label, ceiling):
    """Phase 13: the probes' measurement, the kernels against their plain
    versions at this size, then each kernel's entry of the kernels line
    (one K = 40 call at n = 2^24 beside its plain version and its bound)."""
    from optimization_tpu_torch.kernels import probes as P

    n, K = N_MAIN, PROBE_K[0]
    print(f"phase 13: residency probes at n = 2^24, two-point slope over K "
          f"= {PROBE_K[0]} and {PROBE_K[1]} [{label}]", flush=True)
    # ---- the probes' run: both counts start at 0 here ----
    P.pinned_stream.launches = 0
    P.resident_body.launches = 0
    pinned = pinned_stream_arms(torch, dev, label, ceiling)
    body = resident_body_arms(torch, dev, label, ceiling)
    launches = {"pinned_stream": P.pinned_stream.launches,
                "resident_body": P.resident_body.launches}
    # ---- end of the probes' run ----
    s5, p4 = pinned["stream5"][0], pinned["pin4 (shared memory)"][0]
    bs, br = (body[("body_streamed", n)][0], body[("body_resident", n)][0])
    print(f"  x held against x streamed: pin4 / stream5 = {p4 / s5:.3f} "
          f"(shared memory; probe_pinned_stream.py times the L2 window); r, p "
          f"resident against streamed: {br / bs:.3f} at n = 2^24, "
          f"{body[('body_resident', 1 << 22)][0] / body[('body_streamed', 1 << 22)][0]:.3f} "
          f"at n = 2^22; the production kernel streams everything at 0.1472 "
          f"ms a CG iteration of 6 n f32 words (7.36 ms / 50, PERF.md) "
          f"[{label}]", flush=True)
    print(f"  launches in the probes' run: {launches}", flush=True)

    full = probe_full_width_check(torch, dev)
    cap = P.card_capacity(dev)
    entries = []
    r, p, x = probe_vectors(torch, n, torch.float32, dev, 1)
    ms = time_ms(torch, lambda: P.pinned_stream(r, p, x, iterations=K), 5)
    plain_ms = time_ms(torch, lambda: P.pinned_stream_reference(
        r, p, x, iterations=K), 2)
    # x held: 4 n words an iteration, and x once
    bound_ms, bound_by = bound((4 * K + 1) * 4 * n, 15 * n * K)
    print(f"  pinned_stream, one K = {K} call (x held in shared memory as "
          f"far as it fits): kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"(4 K + 1) n words; {bound_ms / ms:.3f} of it) [{label}]",
          flush=True)
    entries.append({
        "name": "pinned_stream", "route": "cuda",
        "source": "optimization_tpu_torch/csrc/probes.cu",
        "replaces": "benchmarks/probe_pallas_stream.py:111",
        "launches": launches["pinned_stream"],
        "max_abs_err": full["pinned_stream"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

    r, p, x = probe_vectors(torch, n, torch.bfloat16, dev, 2)
    ms = time_ms(torch, lambda: P.resident_body(r, p, x, iterations=K), 5)
    held = P.resident_body.last_held
    plain_ms = time_ms(torch, lambda: P.resident_body_reference(
        r, p, x, iterations=K), 2)
    # The bound is the card's, not the kernel's: all the shared memory the
    # card has (SMs x the opt-in limit of a block) holds r and p first (four
    # accesses an iteration each element), then x; x's rest costs nothing
    # where it fits L2.  What is left streams every iteration; everything
    # is read once and r written once.
    best_rp = min(1.0, cap["shared_bytes"] / (2 * 2 * n))
    best_x = min(1.0, max(0.0, cap["shared_bytes"] - 2 * 2 * n) / (2 * n))
    x_words = 0.0 if (1.0 - best_x) * 2 * n <= cap["l2_bytes"] \
        else 1.0 - best_x
    per_it = 4.0 * (1.0 - best_rp) + x_words
    bound_ms, bound_by = bound((per_it * K + 4) * 2 * n, 25 * n * K)
    print(f"  resident_body, one K = {K} call: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"({per_it:.3f} K + 4) n bf16 words, with {cap['sms']} SMs' "
          f"{cap['shared_bytes']} bytes of shared memory holding "
          f"{best_rp:.3f} of r, p and x's rest in the {cap['l2_bytes']} "
          f"bytes of L2; {bound_ms / ms:.3f} of it); the kernel holds "
          f"{held['rp_shared']:.3f} of r, p [{label}]", flush=True)
    if held["rp_shared"] < 0.98 * best_rp:
        raise AssertionError(
            f"resident_body holds {held['rp_shared']:.3f} of r, p where the "
            f"card's shared memory can hold {best_rp:.3f}")
    entries.append({
        "name": "resident_body", "route": "cuda",
        "source": "optimization_tpu_torch/csrc/probes.cu",
        "replaces": "benchmarks/probe_resident_kernel.py:238",
        "launches": launches["resident_body"],
        "max_abs_err": full["resident_body"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    if min(launches.values()) <= 0:
        raise AssertionError(f"a probe kernel was not launched: {launches}")
    return entries


# ---- the convex path (config4's LASSO) ----


LASSO_SHAPE = (1500, 5000)          # config4's m, n


def host_reads(torch, fn):
    """(result, seconds, host reads) of fn() under the sync debug mode."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res, secs = timed_solve(torch, torch.cuda.current_device(), fn)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, secs, sum("synchroniz" in str(w.message) for w in caught)


def convex_phase(torch, dev, label):
    """Phase 14: FISTA, ISTA and ADMM on config4's LASSO at full width
    (m = 1500, n = 5000 dense f32, B = 1), and the host drivers."""
    from optimization_tpu_torch import CompositeProblem
    from optimization_tpu_torch.core.driver import drive, drive_admm
    from optimization_tpu_torch.core.types import (ADMMStatus,
                                                   ProximalGradientStatus)
    from optimization_tpu_torch.solvers import admm, prox
    from optimization_tpu_torch.solvers import proximal_gradient as pg

    (m, n), mu = LASSO_SHAPE, 0.1
    print(f"phase 14: config4 LASSO, m = {m}, n = {n} dense f32, B = 1, mu = "
          f"{mu}: FISTA, ISTA, ADMM, drive, drive_admm [{label}]", flush=True)
    # config4's law (benchmarks/config4_lasso.py:25-34) from a generator on
    # the card: A ~ N(0, 1/m), 1 % support, noise 0.01
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((m, n), generator=gen, device=dev) / math.sqrt(m)
    support = torch.rand(n, generator=gen, device=dev) < 0.01
    x_true = torch.where(support, torch.randn(n, generator=gen, device=dev),
                         torch.zeros(n, device=dev))
    b = A @ x_true + 0.01 * torch.randn(m, generator=gen, device=dev)
    data = {"A": A, "b": b}
    problem = CompositeProblem(
        f=lambda x, d: 0.5 * torch.sum((d["A"] @ x - d["b"]) ** 2),
        g=lambda x, d: mu * torch.sum(torch.abs(x)),
        prox_g=lambda x, lam, d: prox.soft_threshold(x, lam * mu))
    x0 = torch.zeros(n, device=dev)
    fista_params = pg.ProximalGradientParams(
        max_iterations=300, composite_gradient_tolerance=1e-3,
        relative_composite_gradient_tolerance=1e-6)
    ista_params = dataclasses.replace(
        fista_params, mode=pg.ProximalGradientMode.SIMPLE,
        max_iterations=5000)

    def report(name, res, secs, reads, extra=""):
        k = int(res.num_iterations)
        print(f"  {name}: {k} iterations in {secs:.3f} s = {k / secs:.0f} "
              f"it/s, host reads {reads} ({reads / max(k, 1):.2f} an "
              f"iteration){extra} [{label}]", flush=True)
        if res.x.device.type != "cuda" or not bool(
                torch.isfinite(res.x).all()) or res.x.shape != (n,):
            raise AssertionError(f"{name}: x is not a finite ({n},) tensor "
                                 f"on the card")

    pg.solve(problem, x0, dataclasses.replace(fista_params, max_iterations=2),
             data)                                             # warm-up
    fista, secs, reads = host_reads(
        torch, lambda: pg.solve(problem, x0, fista_params, data))
    kf = int(fista.num_iterations)
    report("FISTA", fista, secs, reads,
           f", F = {float(fista.f):.6f}, |G| = "
           f"{float(fista.composite_gradient_norms[kf - 1]):.3e}, line-search "
           f"steps {int(fista.linesearch_iterations[:kf].sum())}, "
           f"{ProximalGradientStatus(int(fista.status)).name}")
    ista, secs, reads = host_reads(
        torch, lambda: pg.solve(problem, x0, ista_params, data))
    report("ISTA", ista, secs, reads,
           f", F = {float(ista.f):.6f}, "
           f"{ProximalGradientStatus(int(ista.status)).name}")
    dF = abs(float(ista.f) - float(fista.f)) / abs(float(fista.f))
    support_hit = float(((fista.x != 0) == support).float().mean())
    if not (int(fista.status) == ProximalGradientStatus.PROX_GRAD_RESIDUAL
            and int(ista.status) == ProximalGradientStatus.PROX_GRAD_RESIDUAL
            and int(ista.num_iterations) > kf and dF <= 1e-3):
        raise AssertionError(f"convex: FISTA / ISTA gate failed (dF = {dF})")
    print(f"  gates passed: both PROX_GRAD_RESIDUAL, ISTA needs more "
          f"iterations, |F_ista - F_fista| / F = {dF:.2e} <= 1e-3; FISTA's "
          f"support agrees with the planted one on {support_hit:.4f} of the "
          f"entries", flush=True)

    chunked, secs_c = timed_solve(torch, dev, lambda: drive(
        pg, problem, x0, fista_params, data, chunk_iterations=25))
    same = torch.equal(chunked.x, fista.x)
    print(f"  drive(proximal_gradient, chunk_iterations=25): "
          f"{int(chunked.num_iterations)} iterations in {secs_c:.3f} s, x "
          f"bitwise equal to the monolithic solve's: {same} [{label}]",
          flush=True)
    if not (same and int(chunked.num_iterations) == kf
            and int(chunked.status) == int(fista.status)
            and chunked.x.device.type == "cuda"):
        raise AssertionError("convex: the chunked FISTA drive disagrees "
                             "with the monolithic solve")

    # ADMM on x - y = 0 (examples/lasso.py:57-64): the x-update through one
    # Cholesky factor of A'A + rho I (rho fixed; library calls, as the JAX
    # package leaves this product and solve outside any kernel)
    rho = 1.0
    (AtA, Atb, chol), secs_f = timed_solve(torch, dev, lambda: (
        A.T @ A, A.T @ b,
        torch.linalg.cholesky(A.T @ A + rho * torch.eye(n, device=dev))))
    lasso = admm.ADMMProblem(
        minLx=lambda y, lam, r, d: torch.cholesky_solve(
            (Atb + r * y - lam)[:, None], chol)[:, 0],
        minLy=lambda x, lam, r, d: prox.soft_threshold(x + lam / r, mu / r),
        A=lambda x, d: x, B=lambda y, d: -y, At=lambda r, d: r)
    base = admm.ADMMParams(max_iterations=250, rho=rho, eps_rel=1e-4,
                           eps_abs_pri=1e-2, eps_abs_dual=1e-2)
    print(f"  A'A, A'b and the Cholesky factor of A'A + I: {secs_f:.3f} s "
          f"[{label}]", flush=True)
    z = torch.zeros(n, device=dev)
    admm.solve(lasso, z, z, z, dataclasses.replace(base, max_iterations=2))
    fnorm = float(torch.linalg.vector_norm(fista.x))
    for mode in admm.ADMMMode:
        params = dataclasses.replace(base, mode=mode)
        res, secs, reads = host_reads(
            torch, lambda: admm.solve(lasso, z, z, z, params))
        k = int(res.num_iterations)
        dist = float(torch.linalg.vector_norm(res.y - fista.x)) / fnorm
        F = float(problem.value(res.y, data))
        report(f"ADMM {mode.value}", res, secs, reads,
               f", |r| = {float(res.primal_residuals[k - 1]):.3e}, |s| = "
               f"{float(res.dual_residuals[k - 1]):.3e}, F(y) = {F:.6f}, "
               f"|y - x_fista| / |x_fista| = {dist:.3e}, "
               f"{ADMMStatus(int(res.status)).name}")
        # both solvers stop at loose tolerances (|G| <= 1e-3 against |r|,
        # |s| <= 1e-2 + 1e-4 |.|): their answers are held to 5e-2 of |x|
        # and 1e-2 of F
        if not (int(res.status) == ADMMStatus.RESIDUAL_TOLERANCE
                and dist <= 5e-2
                and abs(F - float(fista.f)) <= 1e-2 * abs(float(fista.f))):
            raise AssertionError(f"convex: ADMM {mode.value} gate failed")
        chunked, secs_c = timed_solve(torch, dev, lambda: drive_admm(
            lasso, z, z, z, params, chunk_iterations=20))
        same = torch.equal(chunked.x, res.x) and torch.equal(chunked.y, res.y)
        print(f"  drive_admm({mode.value}, chunk_iterations=20): "
              f"{int(chunked.num_iterations)} iterations in {secs_c:.3f} s, "
              f"x and y bitwise equal to the monolithic solve's: {same} "
              f"[{label}]", flush=True)
        if not (same and int(chunked.num_iterations) == k
                and int(chunked.status) == int(res.status)
                and chunked.x.device.type == "cuda"):
            raise AssertionError("convex: drive_admm disagrees with the "
                                 "monolithic solve")
    print("  gates passed: RESIDUAL_TOLERANCE in both modes, y within 5e-2 "
          "of FISTA's x and F within 1e-2, the chunked drives bitwise equal",
          flush=True)

# ---- the graph probe's chunk reader (csrc/probes.cu) ----

GRAPH_N = 1 << 26                   # the graph probe's source vector, f32 words
GRAPH_GR = (1, 8, 64, 512, 2048)    # rows of 128 words a chunk: 512 B .. 1 MiB
GRAPH_N_ROT = 1 << 21               # rotations of the operator arms
CHUNK_ROWS = (1 << 19, 1001)        # parity: v of N = 2^26 and a ragged v
CHUNK_FETCHES = (1, 3, 2048, None)  # 2048 wraps past nch on the small v;
                                    # None: nch, one sweep of v
LCG_INT32_MIN_T = 2_088_216_195     # the fetch whose LCG value is INT32_MIN
ENTRY_GR = 8                        # the kernels line: 4 KiB random chunks
CHUNK_TOLERANCES = """\
  tolerances, chunk_reader and its plain version against the float64 sum of
  the same chunks: on integer-valued v (uniform in [-8, 8]) every partial
  sum is an integer below 2^24, exact in f32, so both equal the f64 sum bit
  for bit (a piece left out or read twice shows); on normal v, |sum - f64|
  <= 1e-7 * sum|values read| (both sum in f32, in other orders; the sum of
  normal data is near 0 and no scale for the error); two runs of the
  kernel bit for bit; at the fetch whose LCG value is INT32_MIN, the offset
  is the floor-mod Python's % gives.
"""


def chunk_fetches(gr):
    """(lo, hi) n_fetch of the two-point slope at gr rows a chunk: hi = nch,
    one sweep of the GRAPH_N-word vector (256 MiB), lo = hi / 4; a
    contiguous sweep then reads no chunk twice."""
    hi = GRAPH_N // 128 // gr
    return hi // 4, hi


def l2_rereads(torch, off, window):
    """The share of fetches whose chunk was fetched within the ``window``
    fetches before (the chunks the L2 can still hold)."""
    t = torch.arange(off.numel(), device=off.device)
    order = torch.argsort(off * off.numel() + t)
    o, ts = off[order], t[order]
    same = o[1:] == o[:-1]
    return float((same & (ts[1:] - ts[:-1] <= window)).sum()) / off.numel()


def integer_v(torch, rows, gen):
    """A (rows, 128) f32 tensor of integers uniform in [-8, 8], on the
    generator's device: every f32 partial sum of its chunks is exact."""
    return torch.randint(-8, 9, (rows, 128), generator=gen,
                         device=gen.device).float()


def check_chunk_reader(torch, tag, v, f64, gr, rnd, nf, start=0):
    """Hold one chunk_reader call, a repeat and the plain version against
    the float64 sum of the same chunks (``f64`` = (v, |v|) in float64):
    bit for bit when v holds integers, else within 1e-7 sum|values read|
    (CHUNK_TOLERANCES).  Returns (the kernel's |error|, that over
    sum|values read|, the kernel's result)."""
    from optimization_tpu_torch.kernels import probes as P

    got = P.chunk_reader(v, gr, rnd, nf, start=start)
    again = P.chunk_reader(v, gr, rnd, nf, start=start)
    plain = P.chunk_reader_reference(v, gr, rnd, nf, start=start)
    ref, scale = (float(P.chunk_reader_reference(x, gr, rnd, nf, start=start))
                  for x in f64)
    exact = bool((v == v.round()).all())
    e_k, e_p = abs(float(got) - ref), abs(float(plain) - ref)
    tol = 0.0 if exact else 1e-7 * scale
    ok = (e_k <= tol and e_p <= tol and torch.equal(got, again)
          and got.shape == (1, 1) and got.device == v.device
          and (not exact or abs(ref) < 2 ** 24))
    if not ok:
        print(f"  FAIL {tag}: kernel {float(got)!r}, repeat "
              f"{float(again)!r}, plain {float(plain)!r}, f64 {ref!r}, "
              f"sum|v| {scale!r}", flush=True)
        raise AssertionError(f"chunk_reader disagrees: {tag}")
    return e_k, e_k / scale, got


def chunk_parity_phase(torch, dev):
    """Phase 15: chunk_reader and its plain version against a float64 sum,
    at v of 2^19 rows (N = 2^26) and a ragged 1,001 rows, integer-valued
    and normal, every granularity, both offset modes, n_fetch 1, 3, 2048
    and nch, and at the LCG's INT32_MIN."""
    from optimization_tpu_torch.kernels import probes as P

    print("phase 15: chunk_reader vs its plain version and a float64 sum on "
          "the card", flush=True)
    print(CHUNK_TOLERANCES, end="", flush=True)
    cases = 0
    for rows, kind in itertools.product(CHUNK_ROWS, ("integer", "normal")):
        gen = torch.Generator(device=dev).manual_seed(rows % 1009)
        v = (integer_v(torch, rows, gen) if kind == "integer" else
             torch.randn((rows, 128), generator=gen, device=dev))
        f64 = (v.double(), v.double().abs())
        worst = 0.0
        for gr, rnd, nf in itertools.product(GRAPH_GR, (False, True),
                                             CHUNK_FETCHES):
            if gr > rows:
                continue
            nf = nf or rows // gr
            _, rel, _ = check_chunk_reader(
                torch, f"{kind} rows={rows} gr={gr} "
                f"{'random' if rnd else 'contiguous'} n_fetch={nf}", v, f64,
                gr, rnd, nf)
            worst = max(worst, rel)
            cases += 1
        print(f"  ok   {kind} v, rows = {rows}: max |err| / sum|v| kernel "
              f"{worst:.2e}, the plain version within the same limit; two "
              f"runs bitwise equal", flush=True)
    # the INT32_MIN fetch, reached by start= on the small v
    for gr in (1, 8):
        nch = CHUNK_ROWS[1] // gr
        start = LCG_INT32_MIN_T - 1
        off = P.chunk_offsets(torch.arange(start, start + 3, device=dev), nch)
        want = (-(1 << 31)) % nch
        check_chunk_reader(torch, f"INT32_MIN fetch, gr={gr}", v, f64, gr,
                           True, 3, start)
        if int(off[1]) != want or not bool(((off >= 0) & (off < nch)).all()):
            raise AssertionError(f"chunk_offsets at INT32_MIN: {off.tolist()}"
                                 f", want {want} in the middle")
        print(f"  ok   INT32_MIN fetch t = {LCG_INT32_MIN_T}, gr = {gr}: "
              f"offsets {off.tolist()} (floor-mod {want})", flush=True)
        cases += 1
    print(f"phase 15: {cases} cases passed", flush=True)


def chunk_reader_arms(torch, dev, label, ceiling):
    """Time chunk_reader at every GRAPH_GR, contiguous and random, over v
    of GRAPH_N f32 words (256 MiB, above the 50 MB L2): microseconds a chunk
    by the two-point slope over ``chunk_fetches``, each call after a pass
    over a 256 MiB scratch tensor that evicts v from L2 (its time cancels in
    the slope); GB/s of the chunks' bytes over the measured ceiling and
    over 3.35 TB/s, with the share of random fetches that re-read a chunk
    still within the L2's reach.  Prints one line an arm (what
    ``probe_graph_stream.py`` prints); returns (v, {(gr, random): (ms a
    chunk, GB/s)})."""
    from optimization_tpu_torch.kernels import probes as P

    v = integer_v(torch, GRAPH_N // 128,
                  torch.Generator(device=dev).manual_seed(0))
    scratch = torch.zeros(GRAPH_N, device=dev)
    l2 = P.card_capacity(dev)["l2_bytes"]
    spec = HBM_BYTES_PER_S / 1e9
    out = {}
    for gr in GRAPH_GR:
        lo, hi = chunk_fetches(gr)
        for rnd in (False, True):
            def call(k):
                scratch.add_(1.0)
                return P.chunk_reader(v, gr, rnd, k)

            ms = slope_ms(torch, call, ks=(lo, hi))
            gbs = gr * 512 / ms / 1e6
            line = (f"  {'rnd' if rnd else 'ctg'}[{gr}]: {ms * 1e3:.4f} us a "
                    f"chunk = {gbs:.0f} GB/s = {gbs / ceiling:.3f} of the "
                    f"measured ceiling, {gbs / spec:.3f} of 3.35 TB/s, at "
                    f"{gr * 512 / 1024:g} KiB chunks (slope over n_fetch {lo}"
                    f" and {hi})")
            if rnd:
                off = P.chunk_offsets(torch.arange(hi, device=dev), hi)
                line += (f"; {l2_rereads(torch, off, l2 // (gr * 512)):.3f} "
                         f"of the fetches re-read a chunk within the L2's "
                         f"reach")
            if (lo, hi) != (2048, 8192):
                t_hi = time_ms(torch, lambda: P.chunk_reader(v, gr, rnd, 8192),
                               3)
                if t_hi >= 0.05:
                    # past nch the JAX pair reads v again: L2 may serve a
                    # part of the rereads
                    ms_j = slope_ms(torch, call, ks=(2048, 8192))
                    line += (f"; over the JAX probe's 2048 and 8192 (v read "
                             f"{8192 // hi} times): {ms_j * 1e3:.4f} us = "
                             f"{gr * 512 / ms_j / 1e6:.0f} GB/s")
                else:
                    line += (f"; the JAX probe's 8192 fetches take "
                             f"{t_hi:.4f} ms, under the timing noise")
            print(f"{line} [{label}]", flush=True)
            out[(gr, rnd)] = (ms, gbs)
    print("  random / contiguous time a chunk: " + ", ".join(
        f"gr {gr}: {out[(gr, True)][0] / out[(gr, False)][0]:.3f}"
        for gr in GRAPH_GR), flush=True)
    return v, out


def random_rotations(torch, gen, E, dtype=None):
    """E Haar-random rotations from unit quaternions, on the generator's
    device: the measurement blocks of the operator arms (elementwise, where
    a batched QR of E = 6.3e6 blocks is not)."""
    q = torch.randn((E, 4), generator=gen, device=gen.device, dtype=dtype)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=1).reshape(E, 3, 3)


LAPLACIAN_METHODS = ("scatter", "gather", "sort", "adjacency")


def tensor_digest(*tensors):
    """The first 16 hex digits of a SHA-256 over the tensors' bytes: equal
    digests mean bit-for-bit equal tensors."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def laplacian_graph(torch, dev, n=GRAPH_N_ROT, d=3):
    """The operator arms' instance: n rotations, the graph probe's edge set
    (odometry chain + 2n random closures from a seeded generator,
    self-loops dropped), Haar measurement blocks, f32, on ``dev``; returns
    ``(data, V, loc)``: V an (n d, d) block to apply the operator to, loc
    the share of edges within a 1 MiB chunk window."""
    from optimization_tpu_torch.models import rotation_sync as rs

    gen = torch.Generator(device=dev).manual_seed(1)
    src = torch.cat([torch.arange(n - 1, device=dev),
                     torch.randint(0, n, (2 * n,), generator=gen, device=dev)])
    dst = torch.cat([torch.arange(1, n, device=dev),
                     torch.randint(0, n, (2 * n,), generator=gen, device=dev)])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # locality: edges within a 1 MiB chunk window (2048 x 128 f32 words /
    # d^2 = 29,127 rotation indices)
    win = (2048 * 128) // (d * d)
    loc = float(((src - dst).abs() <= win).double().mean())
    data = rs.RotationSyncData(src=src, dst=dst,
                               Rij=random_rotations(torch, gen,
                                                    int(src.numel())))
    V = torch.randn((n * d, d), generator=gen, device=dev)
    return data, V, loc


def laplacian_arms(torch, dev, label, ceiling, n=GRAPH_N_ROT):
    """The connection-Laplacian apply (``rotation_sync.connection_
    laplacian_op``) at n rotations, d = 3, f32, on :func:`laplacian_graph`,
    one arm a ``scatter_method``: ms an apply against the probe's floor
    (2 n d^2 + 3 E d^2) 4 bytes, GB/s over the ceiling, peak memory.
    Gates: every method within 1e-5 (relative Frobenius) of an f64 apply
    of the same operator and of the scatter arm, and an apply after the
    timed ones bit for bit the first.  Returns {method: (ms, GB/s)}."""
    from optimization_tpu_torch.models import rotation_sync as rs

    d = 3
    data, V, loc = laplacian_graph(torch, dev, n, d)
    E = int(data.src.numel())
    ref = rs.connection_laplacian_op(
        data._replace(Rij=data.Rij.double()), n, d)(V.double())
    ref_norm = float(torch.linalg.vector_norm(ref))
    floor = (2 * n * d * d + 3 * E * d * d) * 4
    print(f"  connection Laplacian, n = {n} rotations, E = {E} edges, "
          f"{100 * loc:.1f} % of the edges within a 1 MiB chunk window; floor "
          f"{floor / 1e6:.0f} MB an apply", flush=True)
    outs, res, repeats = {}, {}, {}
    for method in LAPLACIAN_METHODS:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        L = rs.connection_laplacian_op(data, n, d, scatter_method=method)
        outs[method] = L(V)
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        ms = time_ms(torch, lambda: L(V), 5)
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        repeats[method] = torch.equal(L(V), outs[method])
        rel = float(torch.linalg.vector_norm(outs[method].double() - ref)
                    ) / ref_norm
        gbs = floor / ms / 1e6
        print(f"  {method}: {ms:.3f} ms an apply = {gbs:.0f} GB/s of the floor "
              f"= {gbs / ceiling:.3f} of the measured ceiling; built and "
              f"applied once in {build_s:.2f} s; peak memory {peak:.2f} GiB "
              f"above the data; |L V - f64| / |f64| = {rel:.2e}; a repeat "
              f"bit for bit the first: {repeats[method]} [{label}]",
              flush=True)
        res[method] = (ms, gbs, rel)
        del L
    pair = max(float(torch.linalg.vector_norm(outs[m] - outs["scatter"]))
               / ref_norm for m in LAPLACIAN_METHODS)
    if not (max(r[2] for r in res.values()) <= 1e-5 and pair <= 1e-5):
        raise AssertionError(f"connection Laplacian arms disagree: "
                             f"{ {m: r[2] for m, r in res.items()} }, "
                             f"pairwise {pair:.2e}")
    if not all(repeats.values()):
        raise AssertionError(f"connection Laplacian arms do not repeat bit "
                             f"for bit: {repeats}")
    print(f"  gates passed: the four methods within 1e-5 of the f64 apply "
          f"and of each other (max pairwise {pair:.2e}), each repeating bit "
          f"for bit", flush=True)
    return {m: r[:2] for m, r in res.items()}


def graph_probe_phase(torch, dev, label, ceiling):
    """Phase 16: the graph probe (``probe_graph_stream.py``): the chunk
    reader's arms, then each arm's two calls and the kernels line's call
    held against the plain version and the float64 sum (v holds integers:
    bit for bit), its entry of the kernels line, the operator arms.
    Returns (the entry, {arm: GB/s})."""
    from optimization_tpu_torch.kernels import probes as P

    print(f"phase 16: graph probe, chunk_reader over N = 2^26 f32 words, "
          f"slope over n_fetch (hi reads the 256 MiB once) [{label}]",
          flush=True)
    # ---- the probe's run: the count starts at 0 here ----
    P.chunk_reader.launches = 0
    v, arms = chunk_reader_arms(torch, dev, label, ceiling)
    launches = P.chunk_reader.launches
    # ---- end of the probe's run ----
    print(f"  chunk_reader launches in the probe's run: {launches}",
          flush=True)
    if launches <= 0:
        raise AssertionError("chunk_reader was not launched")
    f64 = (v.double(), v.double().abs())
    for gr, rnd in arms:
        for nf in chunk_fetches(gr):
            check_chunk_reader(torch, f"arm gr={gr} random={rnd} n_fetch="
                               f"{nf}", v, f64, gr, rnd, nf)
    print(f"  ok   each arm's calls (n_fetch nch / 4 and nch) equal to the "
          f"plain version and the f64 sum bit for bit", flush=True)
    n_fetch = chunk_fetches(ENTRY_GR)[1]
    err, _, got = check_chunk_reader(torch, "the kernels line's call", v, f64,
                                     ENTRY_GR, True, n_fetch)
    err = max(err, float((got - P.chunk_reader_reference(
        v, ENTRY_GR, True, n_fetch)).abs()))
    del f64
    ms = time_ms(torch, lambda: P.chunk_reader(v, ENTRY_GR, True, n_fetch),
                 20)
    plain_ms = time_ms(torch, lambda: P.chunk_reader_reference(
        v, ENTRY_GR, True, n_fetch), 3)
    nch = v.shape[0] // ENTRY_GR
    distinct = int(torch.unique(P.chunk_offsets(
        torch.arange(n_fetch, device=dev), nch)).numel())
    # the distinct chunks read once each, one add a word
    bound_ms, bound_by = bound(distinct * ENTRY_GR * 512 + 4,
                               n_fetch * ENTRY_GR * 128)
    print(f"  chunk_reader, one call (gr = {ENTRY_GR}, random, n_fetch = "
          f"{n_fetch}, {distinct} distinct chunks; |error| {err!r} against "
          f"the f64 sum and the plain version): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: the "
          f"distinct chunks' bytes; {bound_ms / ms:.3f} of it); no single "
          f"PyTorch call computes it [{label}]", flush=True)
    entry = {"name": "chunk_reader", "route": "cuda",
             "source": "optimization_tpu_torch/csrc/probes.cu",
             "replaces": "benchmarks/probe_graph_stream.py:116",
             "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}
    ops = laplacian_arms(torch, dev, label, ceiling)
    rates = {f"chunk_reader ctg[{GRAPH_GR[-1]}]":
             arms[(GRAPH_GR[-1], False)][1],
             f"chunk_reader rnd[{ENTRY_GR}]": arms[(ENTRY_GR, True)][1],
             **{f"connection Laplacian {m}": ops[m][1] for m in ops}}
    return entry, rates, segment_sum_check(torch, dev, label)


# the segment sum's shapes on the graph models' paths: (n, E, trailing,
# parts, hub) at config6's size (the degree, the inner Laplacian's k = 3,
# the TNT hvp's 3 x 3, LOBPCG's blocks of 8 and 24 columns, Bt's and a
# gather pullback's one part), a width of the kernel's generic instance
# (10 words) and a hub; the timed shape is phase 16's connection-Laplacian
# apply
SEGMENT_CASES = ((10_000, 30_000, (), 2, False),
                 (10_000, 30_000, (3,), 2, False),
                 (10_000, 30_000, (3, 3), 2, False),
                 (10_000, 30_000, (3, 8), 2, False),
                 (10_000, 30_000, (3, 24), 2, False),
                 (10_000, 30_000, (3, 3), 1, False),
                 (10_000, 30_000, (2, 5), 1, False),
                 (2_000, 20_000, (3, 3), 2, True))
SEGMENT_TOL = {"f32": 1e-5, "f64": 1e-12}


def segment_bytes(plan, width, itemsize, ids=None):
    """The bytes a segment sum over ``plan`` must move: each slot's row of
    ``width`` words of ``itemsize`` bytes once, the plan's order and run
    bounds (at their own width, or ``ids`` bytes an entry), the output
    once."""
    S = plan.order.numel()
    order_b = ids or plan.order.element_size()
    starts_b = ids or plan.starts.element_size()
    return (S * width * itemsize + S * order_b + (plan.n + 1) * starts_b
            + plan.n * width * itemsize)


def segment_sum_check(torch, dev, label):
    """The segment-sum kernel (``csrc/segment_sum.cu``) against its plain
    version on the same inputs: at every ``SEGMENT_CASES`` shape in f32 and
    f64 and at phase 16's apply (2^21 rotations, 3 x 3 words a row), each
    on its int32 plan and on the same plan widened to int64, bit for bit
    the plain version on the CPU (both add each vertex's run in the plan's
    order from zero) and within ``SEGMENT_TOL`` (relative to the largest
    |word|) of the card's plain version (``index_add``: another order), a
    repeat bit for bit the first, and two parts' split sum (a pair gather's
    pullback) bit for bit the CPU's; then the timed shape beside the plain
    version, one ``index_add_`` of both parts concatenated (the library
    call) and the bound (:func:`segment_bytes`: the rows once, the plan's
    4-byte order and run bounds, the output once).  Returns the kernels
    line's numbers but the launches."""
    import importlib

    SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
    err = 0.0

    def hold(tag, index, parts, n):
        nonlocal err
        plan = SS.segment_plan(index, n)
        if plan.order.dtype != torch.int32:
            raise AssertionError(f"segment_sum {tag}: a plan of "
                                 f"{plan.order.dtype} ids below 2^31 slots")
        wide = plan._replace(order=plan.order.long(),
                             starts=plan.starts.long())
        cpu = SS.segment_sum(SS.segment_plan([i.cpu() for i in index], n),
                             [p.cpu() for p in parts])
        ref = SS.segment_sum_reference(plan, parts)
        scale = max(float(ref.abs().max()), 1e-30)
        tol = SEGMENT_TOL["f32" if ref.dtype == torch.float32 else "f64"]
        for ids, p in (("int32", plan), ("int64", wide)):
            got = SS.segment_sum(p, parts)
            e = float((got - ref).abs().max())
            if not (torch.equal(got, SS.segment_sum(p, parts))
                    and torch.equal(got.cpu(), cpu) and e <= tol * scale):
                raise AssertionError(
                    f"segment_sum {tag}, {ids} plan: |kernel - plain| "
                    f"{e:.3e} (scale {scale:.3e}), CPU bit for bit "
                    f"{torch.equal(got.cpu(), cpu)}")
            err = max(err, e)
        if len(parts) == 2:
            # the split sum, a pair gather's pullback: bit for bit the CPU's
            split = SS.segment_sum(plan, parts, split=True)
            if not (torch.equal(split, SS.segment_sum(plan, parts,
                                                      split=True))
                    and torch.equal(split.cpu(), SS.segment_sum_reference(
                        SS.segment_plan([i.cpu() for i in index], n),
                        [q.cpu() for q in parts], split=True))):
                raise AssertionError(f"segment_sum {tag}, split: not the "
                                     f"CPU's bits, or no repeat")
        return plan

    gen = torch.Generator(device=dev).manual_seed(12)
    for dtype in (torch.float32, torch.float64):
        for n, E, trailing, n_parts, hub in SEGMENT_CASES:
            index = [torch.randint(0, n, (E,), generator=gen, device=dev)
                     for _ in range(n_parts)]
            if hub:
                index[-1][: E // 2] = 0
            parts = [torch.randn((E,) + trailing, generator=gen, dtype=dtype,
                                 device=dev) for _ in range(n_parts)]
            hold(f"n {n} E {E} {trailing} {n_parts} parts {dtype}", index,
                 parts, n)
    data, _, _ = laplacian_graph(torch, dev)
    n, E = GRAPH_N_ROT, int(data.src.numel())
    parts = [torch.randn((E, 3, 3), generator=gen, device=dev)
             for _ in range(2)]
    plan = hold("phase 16's apply", [data.src, data.dst], parts, n)
    print(f"  ok   segment_sum (csrc/segment_sum.cu) against its plain "
          f"version at {len(SEGMENT_CASES)} shapes in f32 and f64 and at "
          f"phase 16's apply, int32 and int64 plans, split sums: bit for bit "
          f"the CPU's, "
          f"max |kernel - card plain| {err!r}, repeats bit for bit",
          flush=True)
    ms = time_ms(torch, lambda: SS.segment_sum(plan, parts), 20)
    plain_ms = time_ms(torch, lambda: SS.segment_sum_reference(plan, parts),
                       5)
    idx = torch.cat([data.src, data.dst])
    flat = torch.cat(parts)
    library_ms = time_ms(torch, lambda: torch.zeros(
        (n, 3, 3), device=dev).index_add_(0, idx, flat), 5)
    S = 2 * E
    bound_ms, bound_by = bound(segment_bytes(plan, 9, 4), S * 9)
    wide_ms, _ = bound(segment_bytes(plan, 9, 4, ids=8), S * 9)
    print(f"  segment_sum at phase 16's apply ({S} slots of 9 f32 words onto "
          f"{n} vertices): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}, {plan.order.element_size()}-byte ids; "
          f"{bound_ms / ms:.3f} of it; with 8-byte ids {wide_ms:.4f} ms, "
          f"{wide_ms / ms:.3f}) [{label}]", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# ---- rotation synchronization and matrix completion on the card ----

ROTSYNC = dict(n=10_000, extra=20_000, noise=0.01)   # config6's rotations
COMPLETION = dict(m=5000, n=4000, k=10, frac=0.10, noise=0.01)   # config9
RING_SEED = 3          # a CPU generator's ring instance and R0 that get stuck


@contextlib.contextmanager
def lobpcg_log():
    """Record (iterations, gram_pair launches) of every LOBPCG solve made in
    the block: the models import ``linalg.lobpcg.lobpcg`` when they call
    it, so the wrapper sees each solve."""
    import importlib

    from optimization_tpu_torch.kernels import fused as F

    # the module (the package's ``linalg.lobpcg`` is the function)
    M = importlib.import_module("optimization_tpu_torch.linalg.lobpcg")
    inner, log = M.lobpcg, []

    def wrapped(*args, **kwargs):
        before = F.gram_pair.launches
        res = inner(*args, **kwargs)
        log.append((int(res.num_iterations), F.gram_pair.launches - before))
        return res

    M.lobpcg = wrapped
    try:
        yield log
    finally:
        M.lobpcg = inner


def on_so_d(torch, R, atol):
    """Max |R_i' R_i - I| and whether every block is orthonormal within
    ``atol`` with det > 0."""
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    dev_ = float((R.mT @ R - eye).abs().max())
    return dev_, dev_ <= atol and bool((torch.linalg.det(R) > 0).all())


def rotation_graph(torch, dev):
    """Phase 17's instance: config6's rotation graph, f32, made on ``dev``
    from seed 6, self-loops dropped.  Returns ``(R_true, data)``."""
    from optimization_tpu_torch.models import rotation_sync as rs

    gen = torch.Generator(device=dev).manual_seed(6)
    R_true, full = rs.random_instance(gen, ROTSYNC["n"], 3,
                                      extra_edges=ROTSYNC["extra"],
                                      noise=ROTSYNC["noise"])
    keep = full.src != full.dst
    return R_true, rs.RotationSyncData(src=full.src[keep], dst=full.dst[keep],
                                       Rij=full.Rij[keep])


ROTSYNC_PARAMS = dict(max_iterations=100, gradient_tolerance=2e-3,
                      relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
                      preconditioned_gradient_tolerance=0.0)


def rotation_routes(rs):
    """Phase 17's three TNT routes as (name, problem)."""
    return (("plain", rs.make_problem()),
            ("preconditioned", rs.make_problem(preconditioned=True)),
            ("flat", rs.make_problem(flat=True)))


def rotation_sync_phase(torch, dev, label):
    """Phase 17: rotation sync at config6's rotation graph, f32, made on
    the card: spectral init three times (bit for bit the same each time),
    TNT on three routes from one R0 (the preconditioned route twice, bit
    for bit the same), the staircase with its certificate; gates as
    printed."""
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.models import rotation_sync as rs
    from optimization_tpu_torch.solvers import tnt

    n, extra, noise = ROTSYNC["n"], ROTSYNC["extra"], ROTSYNC["noise"]
    R_true, data = rotation_graph(torch, dev)
    print(f"phase 17: rotation sync, config6's rotation graph (n = {n}, "
          f"odometry chain + {extra} random closures, {int(data.src.numel())}"
          f" edges without self-loops, noise {noise}), f32 on the card "
          f"[{label}]", flush=True)
    params = tnt.TNTParams(**ROTSYNC_PARAMS)
    routes = rotation_routes(rs)
    init = lambda: rs.spectral_init(  # noqa: E731
        data, n, 3, generator=torch.Generator(device=dev).manual_seed(7))
    rs.spectral_init(data, n, 3, max_iterations=2)                # warm-up
    for _, prob in routes:
        tnt.solve(prob, R_true, dataclasses.replace(params, max_iterations=1),
                  data=data)
    with lobpcg_log() as log:
        inits = [timed_solve(torch, dev, init) for _ in range(3)]
    R0 = inits[0][0]
    digests = [tensor_digest(R) for R, _ in inits]
    print(f"  spectral_init (chol RR), three runs: (LOBPCG iterations, "
          f"gram_pair launches) {log}, R0 digests {digests}, "
          f"{', '.join(f'{secs:.3f}' for _, secs in inits)} s, mean rotation "
          f"error {float(rs.mean_rotation_error(R0, R_true)):.4f} [{label}]",
          flush=True)
    if len(set(log)) != 1 or len(set(digests)) != 1:
        raise AssertionError("spectral_init does not repeat bit for bit")
    init_log = log
    fs, again = {}, {}
    for name, prob in routes + (("preconditioned again", routes[1][1]),):
        res, secs, reads = host_reads(
            torch, lambda: tnt.solve(prob, R0, params, data=data))
        outer, cg = counts(res)
        err = float(rs.mean_rotation_error(res.x, R_true))
        orth, on = on_so_d(torch, res.x, 1e-4)
        print(f"  TNT {name}: {TNTStatus(int(res.status)).name}, {outer} outer"
              f" / {cg} CG iterations in {secs:.3f} s, f = {float(res.f):.6f}"
              f", |grad| = {float(res.gradfx_norm):.3e}, mean rotation error "
              f"{err:.4f}, max |R'R - I| {orth:.1e}, host reads {reads}, "
              f"digest {tensor_digest(res.x)} [{label}]", flush=True)
        if not (int(res.status) == TNTStatus.GRADIENT and err < 4 * noise
                and on and res.x.device.type == dev.type):
            raise AssertionError(f"rotation sync TNT {name}: the gate failed")
        if name.startswith("preconditioned"):
            again[name] = (int(res.status), outer, cg, tensor_digest(res.x))
        else:
            fs[name] = float(res.f)
    if len(set(again.values())) != 1:
        raise AssertionError(f"rotation sync TNT preconditioned does not "
                             f"repeat bit for bit: {again}")
    spread = (max(fs.values()) - min(fs.values())) / abs(fs["plain"])
    if spread > 1e-4:
        raise AssertionError(f"rotation sync: the routes' f differ by "
                             f"{spread:.2e} relative")
    with lobpcg_log() as log:
        st, secs = timed_solve(torch, dev, lambda: rs.solve_staircase(
            data, n, 3, R0=R0,
            generator=torch.Generator(device=dev).manual_seed(8)))
    cert = st.cert
    err = float(rs.mean_rotation_error(st.R, R_true))
    orth, on = on_so_d(torch, st.R, 1e-4)
    print(f"  solve_staircase from R0: p_final {st.p_final}, certified "
          f"{bool(st.certified)}, lam_min {float(cert.lam_min):.3e} >= -eta "
          f"= {-float(cert.eta):.3e}, stationarity "
          f"{float(cert.stationarity):.2e}, LOBPCG (iterations, gram_pair "
          f"launches) {log}, mean rotation error {err:.4f}, {secs:.3f} s "
          f"[{label}]", flush=True)
    if not (bool(st.certified) and err < 4 * noise and on
            and all(k == 1 + it for it, k in init_log + log)):
        raise AssertionError("rotation sync staircase: the gate failed")
    print(f"  gates passed: spectral_init three times and the preconditioned"
          f" route twice bit for bit the same; three routes GRADIENT with f "
          f"within {spread:.1e} (<= 1e-4) relative, mean rotation error < 4 "
          f"noise, certified, R on SO(3)^n, gram_pair launches = 1 + "
          f"iterations for every LOBPCG solve", flush=True)


def ring_instance(torch, rs, gen, n=12, d=3, noise=0.3):
    """``tests/test_rotation_sync.py``'s weakly connected ring at noise 0.3
    in f64, drawn from ``gen``: truth, then the perturbations."""
    R_true, _ = rs.random_instance(gen, n, d, extra_edges=0, noise=0.0,
                                   dtype=torch.float64)
    src = torch.cat([torch.arange(n - 1), torch.tensor([n - 1])])
    dst = torch.cat([torch.arange(1, n), torch.tensor([0])])
    w = noise * torch.randn((n, d, d), generator=gen, dtype=torch.float64)
    skew = 0.5 * (w - w.mT)
    pert = rs._orthonormalize(torch.eye(d, dtype=torch.float64) + skew
                              + 0.5 * (skew @ skew))
    return R_true, rs.RotationSyncData(
        src=src, dst=dst, Rij=pert @ (R_true[src] @ R_true[dst].mT))


def staircase_lift_phase(torch, dev, label):
    """Phase 18: the staircase climbs on the card: the ring instance in f64
    with an R0 whose level-d critical point is not certified (drawn from a
    CPU generator, so the instance is the same on any machine, then moved
    to the card); the lifted St(p, d)^n solves and ``round_lifted`` run on
    the card."""
    from optimization_tpu_torch.models import rotation_sync as rs
    from optimization_tpu_torch.solvers import tnt

    n, d = 12, 3
    gen = torch.Generator().manual_seed(RING_SEED)
    _, data = ring_instance(torch, rs, gen, n, d)
    R0 = rs.ROTATIONS.rand(gen, n, d, d, dtype=torch.float64).to(dev)
    data = rs.RotationSyncData(*(t.to(dev) for t in data[:3]))
    params = tnt.TNTParams(max_iterations=200, gradient_tolerance=1e-10,
                           relative_decrease_tolerance=0.0,
                           stepsize_tolerance=0.0,
                           preconditioned_gradient_tolerance=0.0)
    print(f"phase 18: staircase lift on the card, ring n = {n}, noise 0.3, "
          f"f64, R0 from seed {RING_SEED} [{label}]", flush=True)
    with lobpcg_log() as log:
        st, secs = timed_solve(torch, dev, lambda: rs.solve_staircase(
            data, n, d, params=params, R0=R0, cert_tau=1e-6))
    orth, on = on_so_d(torch, st.R, 1e-9)
    levels = ", ".join(f"p {p}: f {f:.6f}, lam_min {lam:.3e}, "
                       f"{'certified' if c else 'not certified'}"
                       for p, f, lam, c in st.levels)
    print(f"  levels: {levels}; p_final {st.p_final}, rank_gap "
          f"{st.rank_gap:.2e}, certified {bool(st.certified)}, final f "
          f"{float(st.result.f):.6f}, max |R'R - I| {orth:.1e}, LOBPCG "
          f"iterations {[it for it, _ in log]}, {secs:.3f} s [{label}]",
          flush=True)
    if not (st.p_final > d and bool(st.certified) and st.rank_gap < 1e-6
            and not st.levels[0][3] and on and st.R.device.type == dev.type
            and all(k == 0 for _, k in log)):
        raise AssertionError("staircase lift: the gate failed")
    print("  gates passed: p_final > d, certified, rank_gap < 1e-6, R on "
          "SO(3)^n (f64 LOBPCG takes torch.matmul: no gram_pair launch)",
          flush=True)


def completion_phase(torch, dev, label):
    """Phase 19: matrix completion at config9's width
    (``benchmarks/config9_matrix_completion.py``: 5000 x 4000, k = 10, 10 %
    observed, noise 0.01, lam = 1e-8, its TNT params), f32 on the card,
    then float64 from the same data and start: where f32 ends on
    TRUST_REGION above the tolerance (the gain ratio is round-off of f; JAX
    in f32 stops so too, ``tests/test_torch_matrix_completion.py``), float64
    reaches GRADIENT."""
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.models import matrix_completion as mc
    from optimization_tpu_torch.solvers import tnt

    m, n, k, frac, noise = (COMPLETION[key]
                            for key in ("m", "n", "k", "frac", "noise"))
    print(f"phase 19: matrix completion, config9 ({m} x {n}, k = {k}, "
          f"{frac:.0%} observed, noise {noise}), f32 on the card [{label}]",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(9)
    M_true, data = mc.random_instance(gen, m, n, k, frac=frac, noise=noise,
                                      lam=1e-8)
    params = tnt.TNTParams(
        max_iterations=60, gradient_tolerance=1e-3,
        relative_decrease_tolerance=0.0, stepsize_tolerance=0.0,
        preconditioned_gradient_tolerance=0.0, max_TPCG_iterations=100)
    problem = mc.make_problem()
    U0, secs_init = timed_solve(torch, dev, lambda: mc.spectral_init(data, k))
    tnt.solve(problem, U0, dataclasses.replace(params, max_iterations=1),
              data=data)                                      # warm-up
    res, secs, reads = host_reads(
        torch, lambda: tnt.solve(problem, U0, params, data=data))
    outer, cg = counts(res)
    M_hat = mc.predict(res.x, data)
    rel = float(torch.linalg.vector_norm(M_hat - M_true)
                / torch.linalg.vector_norm(M_true))
    print(f"  spectral_init {secs_init:.3f} s; TNT "
          f"{TNTStatus(int(res.status)).name}, {outer} outer / {cg} CG "
          f"iterations in {secs:.3f} s, f = {float(res.f):.4f}, |grad| = "
          f"{float(res.gradfx_norm):.3e}, relative error over all entries "
          f"{rel:.3e}, host reads {reads} [{label}]", flush=True)
    rho = ", ".join(f"{float(r):.3g}" for r in res.gain_ratios[:outer])
    print(f"  f32 gain ratios by outer iteration: {rho}", flush=True)
    # the f64 witness: the same data and start in float64, to the same
    # tolerance; f32 stops where the gain ratio is round-off of f
    d64 = mc.CompletionData(*(a.double() for a in data))
    res64, secs64 = timed_solve(torch, dev, lambda: tnt.solve(
        problem, U0.double(), params, data=d64))
    outer64, cg64 = counts(res64)
    rel64 = float(torch.linalg.vector_norm(mc.predict(res64.x, d64)
                                           - M_true.double())
                  / torch.linalg.vector_norm(M_true.double()))
    print(f"  float64 witness from the same data and U0: "
          f"{TNTStatus(int(res64.status)).name}, {outer64} outer / {cg64} CG"
          f" iterations in {secs64:.3f} s, f = {float(res64.f):.6f}, |grad| "
          f"= {float(res64.gradfx_norm):.3e}, relative error {rel64:.3e} "
          f"[{label}]", flush=True)
    if not (rel < 5 * noise and res.x.shape == (m, k)
            and bool(torch.isfinite(res.x).all())
            and res.x.device.type == dev.type
            and int(res64.status) == TNTStatus.GRADIENT
            and rel64 < 5 * noise):
        raise AssertionError("matrix completion: the gate failed")
    print(f"  gates passed: relative error {rel:.3e} < 5 noise; float64 "
          f"reaches GRADIENT (|grad| <= 1e-3)", flush=True)


# ---- SE(d) pose synchronization: the full SE-Sync pipeline ----

POSE = dict(n=10_000, extra=20_000, noise=0.01, t_scale=5.0)   # config6
ROBUST_SE = dict(n=1000, noise=0.01, frac=0.2)   # TestRobustSE's shape
ANGLE_FAR = 0.25   # rad: full outliers whose rotation weight is gated


def perturbed(torch, rs, gen, E, noise):
    """E small rotations exp(noise * skew) (the 2nd-order expansion,
    re-orthonormalized), drawn from ``gen`` in float64."""
    w = noise * torch.randn((E, 3, 3), generator=gen, dtype=torch.float64)
    skew = 0.5 * (w - w.mT)
    return rs._orthonormalize(torch.eye(3, dtype=torch.float64) + skew
                              + 0.5 * (skew @ skew))


def pose_graph_tensors(torch, gen, n, extra, noise, t_scale):
    """A pose graph in the g2o convention (M_e = R_i' R_j, t_e = R_i'
    (t_j - t_i)) drawn from ``gen`` on the host in float64, as
    ``benchmarks/config6_pose_graph_10k.py:39-71`` makes config6's: truth,
    an odometry chain plus ``extra`` random closures with self-loops
    dropped, rotation and translation noise.  Returns ``(R_true, t_true,
    src, dst, Mij, tij)``."""
    from optimization_tpu_torch.models import rotation_sync as rs

    f64 = torch.float64
    R_true = rs.ROTATIONS.rand(gen, n, 3, 3, dtype=f64)
    t_true = t_scale * torch.randn((n, 3), generator=gen, dtype=f64)
    src = torch.cat([torch.arange(n - 1),
                     torch.randint(0, n, (extra,), generator=gen)])
    dst = torch.cat([torch.arange(1, n),
                     torch.randint(0, n, (extra,), generator=gen)])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    Rt = R_true.mT
    Mij = perturbed(torch, rs, gen, src.numel(), noise) @ (Rt[src]
                                                          @ R_true[dst])
    tij = (Rt[src] @ (t_true[dst] - t_true[src])[..., None])[..., 0]
    tij = tij + noise * torch.randn(tij.shape, generator=gen, dtype=f64)
    return R_true, t_true, src, dst, Mij, tij


def pose_graph(torch, n, extra, noise, t_scale, seed):
    """:func:`pose_graph_tensors` from ``seed`` as ``(PoseGraph, R_true,
    t_true)``, the graph's arrays numpy as the loaders give them."""
    from optimization_tpu_torch.io import g2o

    R_true, t_true, src, dst, Mij, tij = pose_graph_tensors(
        torch, torch.Generator().manual_seed(seed), n, extra, noise, t_scale)
    graph = g2o.PoseGraph(n_vertices=n, dim=3,
                          src=src.numpy().astype("int32"),
                          dst=dst.numpy().astype("int32"),
                          Rij=Mij.numpy(), tij=tij.numpy(), kappa=None)
    return graph, R_true, t_true


@contextlib.contextmanager
def pose_stages(torch, residuals=False):
    """Record the stages of the pose pipelines run in the block: each
    ``spectral_init``, TNT solve, LSQR and certificate with its host-clock
    seconds (every stage ends in a host read) and result, and the
    iterations of every inner Laplacian solve keyed by its iteration cap
    (400: the optimizer's operator, 60: the loose certificate operator).
    With ``residuals``, each inner solve's relative residual |L z - r| /
    |r| is kept too (one more Laplacian apply a solve).  The models call
    these through their module attributes, so the wrappers see each
    call."""
    import importlib

    ps = importlib.import_module("optimization_tpu_torch.models.pose_sync")
    rs = importlib.import_module(
        "optimization_tpu_torch.models.rotation_sync")
    tnt = importlib.import_module("optimization_tpu_torch.solvers.tnt")
    log = {"stages": [], "inner": collections.defaultdict(list),
           "residuals": collections.defaultdict(list)}
    saved = []

    def timed(stage):
        def make(inner):
            def wrapped(*args, **kwargs):
                t0 = time.perf_counter()
                res = inner(*args, **kwargs)
                log["stages"].append((stage, time.perf_counter() - t0, res))
                return res
            return wrapped
        return make

    def inner_solver(inner):
        def make(src, dst, tau, n, **kwargs):
            cap = kwargs.get("max_iterations", 400)
            want = kwargs.pop("with_iters", False)
            solve = inner(src, dst, tau, n, with_iters=True, **kwargs)
            L = (ps.laplacian_apply(src, dst, tau, n) if residuals
                 else None)

            def recorded(r):
                z, it = solve(r)
                log["inner"][cap].append(it)
                if L is not None:
                    log["residuals"][cap].append(
                        torch.linalg.vector_norm(L(z) - r)
                        / torch.linalg.vector_norm(r))
                return (z, it) if want else z
            return recorded
        return make

    for mod, name, make in (
            (rs, "spectral_init", timed("spectral init")),
            (tnt, "solve", timed("TNT")),
            (ps, "lsqr", timed("translation LSQR")),
            (rs, "certify", timed("certificate")),
            (ps, "_weighted_laplacian_solver", inner_solver)):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, make(getattr(mod, name)))
    try:
        yield log
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)


def stage_lines(log, label):
    """The recorded stages, one line each, then the inner solves."""
    from optimization_tpu_torch.core.types import TNTStatus

    lines = []
    for stage, secs, res in log["stages"]:
        if stage == "TNT":
            outer, cg = counts(res)
            what = (f"{TNTStatus(int(res.status)).name}, {outer} outer / {cg}"
                    f" CG, |grad| {float(res.gradfx_norm):.3e}")
        elif stage == "translation LSQR":
            what = f"{int(res.num_iterations)} iterations"
        elif stage == "certificate":
            what = (f"{int(res.num_iterations)} LOBPCG iterations, lam_min "
                    f"{float(res.lam_min):.3e}, eta {float(res.eta):.3e}, "
                    f"certified {bool(res.certified)}")
        else:
            what = ""
        lines.append(f"    {stage}: {secs:.3f} s {what} [{label}]")
    for cap, its in sorted(log["inner"].items(), reverse=True):
        lines.append(f"    inner Laplacian PCG (cap {cap}): {len(its)} "
                     f"solves, iterations mean {sum(its) / len(its):.1f}, "
                     f"max {max(its)}")
    return "\n".join(lines)


def pose_cli_phase(torch, dev, label):
    """Phase 20: config6 through the port's CLI, f32 on the card: the g2o
    file written by ``save_g2o``, ``cli.main(["solve", path,
    "--marginalized", "--certify", "--json", "--out", npz])`` in-process,
    the poses held against the truth; then the loose and the tight
    certificate operators at the solved point.  Returns the pieces phase 21
    reuses."""
    import io
    import tempfile
    import warnings

    from optimization_tpu_torch import cli
    from optimization_tpu_torch.io import g2o
    from optimization_tpu_torch.models import pose_sync as ps
    from optimization_tpu_torch.models import rotation_sync as rs

    n, extra, noise = POSE["n"], POSE["extra"], POSE["noise"]
    graph, R_true, t_true = pose_graph(torch, n, extra, noise,
                                       POSE["t_scale"], seed=0)
    E = len(graph.src)
    print(f"phase 20: config6 through the CLI, {n} SE(3) poses, odometry "
          f"chain + {extra} random closures, {E} edges without self-loops, "
          f"noise {noise}, t at scale {POSE['t_scale']:g}, f32 on the card "
          f"[{label}]", flush=True)
    tmp = tempfile.TemporaryDirectory(prefix="pose_")
    path = os.path.join(tmp.name, "config6.g2o")
    npz = os.path.join(tmp.name, "sol.npz")
    t0 = time.perf_counter()
    g2o.save_g2o(path, graph)
    print(f"  save_g2o: {os.path.getsize(path) / 2**20:.1f} MiB in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    argv = ["solve", path, "--marginalized", "--certify", "--json",
            "--out", npz]
    out = io.StringIO()
    with pose_stages(torch) as log:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with contextlib.redirect_stdout(out):
                    t0 = time.perf_counter()
                    rc = cli.main(argv)
                    secs = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode("default")
    reads = sum("synchroniz" in str(w.message) for w in caught)
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"  python -m optimization_tpu_torch {' '.join(argv[:1])} <file> "
          f"{' '.join(argv[2:5])} ...: rc {rc}, {secs:.3f} s in-process; "
          f"summary {json.dumps(summary)}", flush=True)
    import numpy as np

    with np.load(npz) as f:
        R = torch.as_tensor(f["R"], device=dev).double()
        t = torch.as_tensor(f["t"], device=dev).double()
    tmp.cleanup()
    rot_err, t_err = ps.alignment_errors(R, t, R_true, t_true)
    rot_err, t_err = float(rot_err), float(t_err)
    print(f"  loader {summary['loader']} ({summary['load_s'] * 1e3:.0f} ms)"
          f"; solve {summary['solve_s']:.3f} s; stages:", flush=True)
    print(stage_lines(log, label), flush=True)
    print(f"  host reads in the CLI run: {reads}; rotation error "
          f"{rot_err:.5f} (gate < {4 * noise:g}), max translation error "
          f"{t_err:.4f} [{label}]", flush=True)
    if not (rc == 0 and summary.get("certified") is True
            and rot_err < 4 * noise and math.isfinite(t_err)
            and R.shape == (n, 3, 3)):
        raise AssertionError("config6 through the CLI: the gate failed")

    # the loose certificate operator against the optimizer-grade one
    X = next(res for stage, _, res in log["stages"] if stage == "TNT").x
    f32 = torch.float32
    src = torch.as_tensor(graph.src, device=dev)
    dst = torch.as_tensor(graph.dst, device=dev)
    Mij = torch.as_tensor(graph.Rij, dtype=f32, device=dev)
    tij = torch.as_tensor(graph.tij, dtype=f32, device=dev)
    kappa = torch.ones(E, dtype=f32, device=dev)      # save_g2o's kappa
    rot_data = ps._transposed_rotation_data(src, dst, Mij, kappa)
    certs, walls = {}, {}
    with pose_stages(torch, residuals=True) as clog:
        for name, kw in (("tight", {}),
                         ("loose", dict(cg_iterations=60, cg_rtol=1e-4))):
            _, Q, _ = ps.marginalized_problem(src, dst, Mij, tij,
                                              kappa=kappa, n=n, **kw)
            t0 = time.perf_counter()
            certs[name] = rs.certify(X, rot_data, operator=Q,
                                     rr_method="chol")
            walls[name] = time.perf_counter() - t0
    ct, cl = certs["tight"], certs["loose"]
    gap = abs(float(cl.lam_min) - float(ct.lam_min))
    worst = {cap: max(float(x) for x in r)
             for cap, r in clog["residuals"].items()}
    print(f"  certificate at the solved point: tight operator (cap 400, rtol"
          f" 50 eps) lam_min {float(ct.lam_min):.4e}, {int(ct.num_iterations)}"
          f" iterations, {walls['tight']:.3f} s; loose (cap 60, rtol 1e-4) "
          f"lam_min {float(cl.lam_min):.4e}, {int(cl.num_iterations)} "
          f"iterations, {walls['loose']:.3f} s; |difference| {gap:.3e} "
          f"< eta {float(ct.eta):.3e}; largest relative inner residual: "
          f"loose {worst.get(60, float('nan')):.3e}, tight "
          f"{worst.get(400, float('nan')):.3e} [{label}]", flush=True)
    print(stage_lines(clog, label), flush=True)
    if not (bool(ct.certified) and bool(cl.certified)
            and gap < float(ct.eta)):
        raise AssertionError("loose vs tight certificate: the gate failed")
    print(f"  gates passed: rc 0, certified, rotation error {rot_err:.5f} < "
          f"{4 * noise:g}; the loose and tight certificates agree "
          f"(|d lam_min| {gap:.2e} < eta)", flush=True)
    return graph, R_true, t_true


def robust_se_graph(torch, rs, n, noise, frac, seed):
    """``tests/test_pose_sync.py:TestRobustSE``'s fixture shape at n poses:
    a chain + 4n random closures (t at scale 2), then ``frac`` of the edges
    corrupted, half full SE(3) outliers (a random rotation and offset), half
    translation-only (a random offset at scale 10).  float64 on the host
    from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    R_true, t_true, src, dst, Mij, tij = pose_graph_tensors(
        torch, gen, n, 4 * n, noise, 2.0)
    E = src.numel()
    n_out = int(frac * E)
    out_idx = torch.randperm(E, generator=gen)[:n_out]
    full_out = out_idx[: n_out // 2]
    Mij[full_out] = rs.ROTATIONS.rand(gen, len(full_out), 3, 3,
                                      dtype=torch.float64)
    tij[out_idx] = 10.0 * torch.randn((n_out, 3), generator=gen,
                                      dtype=torch.float64)
    return R_true, t_true, src, dst, Mij, tij, out_idx, full_out


def pose_routes_phase(torch, dev, label, graph, R_true, t_true):
    """Phase 21: the other routes on the card in f32: the chordal two-stage
    and the staircase pipelines on config6's graph (certified, rotation
    error < 4 noise), ``solve_robust_se`` on TestRobustSE's fixture shape at
    n = 1,000 (its gates adapted to the larger graph, below),
    ``rotation_sync.solve_robust`` on its
    rotations, and one inner Laplacian solve per engine on config6's
    graph."""
    from optimization_tpu_torch.models import pose_sync as ps
    from optimization_tpu_torch.models import rotation_sync as rs

    noise = POSE["noise"]
    print(f"phase 21: the other pose routes, f32 on the card [{label}]",
          flush=True)
    for name, kw in (("chordal", {}), ("staircase", dict(staircase=True))):
        with pose_stages(torch) as log:
            res, secs, reads = host_reads(torch, lambda: ps.solve_pose_graph(
                graph, certify=True, **kw))
        rot_err, t_err = (float(x) for x in ps.alignment_errors(
            res.R.double(), res.t.double(), R_true, t_true))
        print(f"  {name}: {secs:.3f} s, host reads {reads}, certified "
              f"{bool(res.certificate.certified)}, rotation error "
              f"{rot_err:.5f}, max translation error {t_err:.4f} [{label}]",
              flush=True)
        print(stage_lines(log, label), flush=True)
        if not (bool(res.certificate.certified) and rot_err < 4 * noise
                and res.R.device.type == dev.type):
            raise AssertionError(f"pose route {name}: the gate failed")

    n, rnoise, frac = (ROBUST_SE[k] for k in ("n", "noise", "frac"))
    R_t, t_t, src, dst, Mij, tij, out_idx, full_out = robust_se_graph(
        torch, rs, n, rnoise, frac, seed=9)
    E = src.numel()
    f32 = torch.float32
    with pose_stages(torch) as log:
        rob, secs, reads = host_reads(torch, lambda: ps.solve_robust_se(
            src.to(dev), dst.to(dev), Mij.to(dev, f32), tij.to(dev, f32), n))
    # TestRobustSE's gates, adapted to n = 1,000.  At its n = 30 every
    # vertex keeps an inlier majority; here some lose it by chance (about
    # 1.5 %), sit between equal-cost robust basins, and must be flagged.
    # So: every strict corrupted-majority vertex flagged, the flag rare, and
    # the error and translation-weight gates on the identifiable vertices
    # and the edges between them.  Among ~500 full outliers a few random
    # rotations fall near the truth, where no robust cost can tell them
    # from inliers: at mu = 1 an edge's weight (c^2 / (c^2 + r))^2 reaches
    # 0.05 only at chordal residual r = 4 (1 - cos a) > 3.5 c^2 (c^2 the
    # start's median residual).  The rotation-weight gate takes the full
    # outliers more than ANGLE_FAR from the truth, all of them; the nearer
    # ones are printed with their weights.
    ones = torch.ones(E, dtype=torch.float64)
    bad = torch.zeros(E, dtype=torch.float64)
    bad[out_idx] = 1.0
    deg = torch.zeros(n, dtype=torch.float64).index_add(0, src, ones)
    deg = deg.index_add(0, dst, ones)
    nbad = torch.zeros(n, dtype=torch.float64).index_add(0, src, bad)
    nbad = nbad.index_add(0, dst, bad)
    majority_bad = nbad > deg / 2
    ident = rob.identifiable.cpu()
    rot_err, t_err = (float(x) for x in ps.alignment_errors(
        rob.R.double().cpu()[ident], rob.t.double().cpu()[ident],
        R_t[ident], t_t[ident]))
    inlier = torch.ones(E, dtype=torch.bool)
    inlier[out_idx] = False
    full = torch.zeros(E, dtype=torch.bool)
    full[full_out] = True
    between = ident[src] & ident[dst]
    w_rot, w_tr = rob.w_rot.double().cpu(), rob.w_tr.double().cpu()
    cos = ((R_t[src].mT @ R_t[dst]) * Mij).sum((-2, -1))
    angle = torch.arccos(((cos - 1) / 2).clamp(-1, 1))
    far = full & (angle > ANGLE_FAR)
    near = ", ".join(f"{float(angle[e]):.3f} rad: {float(w_rot[e]):.2e}"
                     for e in torch.nonzero(full & ~far)[:, 0].tolist())
    stats = dict(flagged=int((~ident).sum()),
                 majority_bad=int(majority_bad.sum()),
                 missed=int((majority_bad & ident).sum()),
                 w_tr_out=float(w_tr[~inlier & between].max()),
                 w_rot_full=float(w_rot[far].max()),
                 med_rot_in=float(w_rot[inlier].median()),
                 med_tr_in=float(w_tr[inlier].median()))
    print(f"  solve_robust_se, n = {n}, {E} edges, {len(out_idx)} corrupted "
          f"({len(full_out)} full SE(3), the rest translation-only): "
          f"{secs:.3f} s, host reads {reads}; {stats['flagged']} vertices "
          f"flagged, {stats['majority_bad']} with a corrupted majority "
          f"({stats['missed']} of them unflagged); on the identifiable "
          f"vertices rotation error {rot_err:.5f}, max translation error "
          f"{t_err:.4f}; between them max w_tr of corrupted edges "
          f"{stats['w_tr_out']:.2e}; max w_rot of the {int(far.sum())} full "
          f"outliers more than {ANGLE_FAR} rad from the truth "
          f"{stats['w_rot_full']:.2e} (the nearer ones, angle: w_rot: "
          f"{near or 'none'}); inlier medians w_rot "
          f"{stats['med_rot_in']:.3f} w_tr {stats['med_tr_in']:.3f} "
          f"[{label}]", flush=True)
    tnts = [r for stage, _, r in log["stages"] if stage == "TNT"]
    print(f"    GNC stages (outer / CG): {[counts(r) for r in tnts]}; "
          + stage_lines(log, label).splitlines()[-1].strip(), flush=True)
    if not (stats["missed"] == 0 and stats["flagged"] <= 0.05 * n
            and rot_err < 0.05 and t_err < 0.1
            and stats["w_tr_out"] < 0.05 and stats["w_rot_full"] < 0.05
            and stats["med_rot_in"] > 0.5 and stats["med_tr_in"] > 0.5):
        raise AssertionError("solve_robust_se: the gate failed")

    data = ps._transposed_rotation_data(src.to(dev), dst.to(dev),
                                        Mij.to(dev, f32))
    rrob, secs, reads = host_reads(torch, lambda: rs.solve_robust(data, n, 3))
    err = float(rs.mean_rotation_error(rrob.R.double(),
                                       R_t.mT.to(dev)))
    w = rrob.weights.double().cpu()
    ratio = float(w[full_out].median() / w[inlier].median())
    print(f"  rotation_sync.solve_robust on its rotations: {secs:.3f} s, "
          f"host reads {reads}, mean rotation error {err:.5f}, median weight"
          f" of the full outliers over the inliers' {ratio:.2e}, last stage "
          f"{counts(rrob.result)} (outer / CG) [{label}]", flush=True)
    if not (err < 0.05 and ratio < 0.1):
        raise AssertionError("rotation_sync.solve_robust: the gate failed")

    # one inner Laplacian solve per engine on config6's graph, k = 3
    n6 = graph.n_vertices
    src6 = torch.as_tensor(graph.src, device=dev)
    dst6 = torch.as_tensor(graph.dst, device=dev)
    tau = torch.ones(src6.numel(), dtype=f32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    r = torch.randn((n6, 3), generator=gen, device=dev)
    r = r - r.mean(dim=0, keepdim=True)
    zs = {}
    for engine, kw in (("cg", {}), ("flat", dict(s_steps=2))):
        solve = ps._weighted_laplacian_solver(src6, dst6, tau, n6,
                                              engine=engine, with_iters=True,
                                              **kw)
        solve(r)                                               # warm-up
        (z, it), secs = timed_solve(torch, dev, lambda: solve(r))
        zs[engine] = z[dst6] - z[src6]
        print(f"  inner Laplacian solve, engine {engine}{kw or ''}: {it} "
              f"iterations, {secs * 1e3:.2f} ms [{label}]", flush=True)
    rel = float(torch.linalg.vector_norm(zs["flat"] - zs["cg"])
                / torch.linalg.vector_norm(zs["cg"]))
    if not rel < 1e-4:
        raise AssertionError(f"the inner engines disagree: {rel:.2e}")
    print(f"  gates passed: chordal and staircase certified at rotation "
          f"error < {4 * noise:g}; every corrupted-majority vertex flagged "
          f"and TestRobustSE's gates adapted to n = {n}; "
          f"solve_robust's; the engines' edge differences within {rel:.1e}"
          f" (< 1e-4) relative", flush=True)


# ---- range-aided pose sync and the parallel package ----

# config6's scale (SE-Sync's city10000): 10^4 SE(3) poses, box 10
RANGE_N = 10_000
RANGE_A = dict(extra_edges=0, n_ranges=10_000, noise=0.01,
               range_noise=0.001)        # a noisy chain with ranges
RANGE_B = dict(extra_edges=10_000, n_ranges=10_000, noise=0.0)
# instance (b)'s f32 floors, calibrated on the CPU in f32 at n = 2,000
# (f 1.03e-8, rotation error 7.5e-7, translation error 4.4e-5 there) with
# a margin for n = 10^4 (PERF.md, §6)
RANGE_FLOORS = {"f": 1e-5, "rot": 1e-4, "t": 1e-3}


def range_solve(torch, dev, data, seed, label, tag):
    """One ``solve_range_aided`` in f32 on the card: its stages timed
    (``pose_stages``), its LOBPCG solves and host reads counted."""
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.models import range_sync as rg

    gen = torch.Generator(device=dev).manual_seed(seed)
    with pose_stages(torch) as log, lobpcg_log() as lob:
        out, secs, reads = host_reads(
            torch, lambda: rg.solve_range_aided(data, RANGE_N,
                                                generator=gen))
    outer, cg = counts(out.result)
    print(f"  {tag}: {secs:.3f} s, "
          f"{TNTStatus(int(out.result.status)).name}, {outer} outer / {cg} "
          f"CG, f {float(out.result.f):.4e}, |grad| "
          f"{float(out.result.gradfx_norm):.3e}, host reads {reads}, "
          f"spectral LOBPCG {[it for it, _ in lob]} iterations [{label}]",
          flush=True)
    print(stage_lines(log, label), flush=True)
    return out


def range_sync_phase(torch, dev, label):
    """Phase 22: range-aided pose sync in f32 at config6's scale, made on
    the card: (a) a noisy chain with ranges, solved with them and with
    rho = 0; (b) a noiseless instance; the JAX tests' contracts as gates."""
    from optimization_tpu_torch.models import range_sync as rg
    from optimization_tpu_torch.models.pose_sync import alignment_errors

    n = RANGE_N
    print(f"phase 22: range-aided pose sync, f32, n = {n} SE(3) poses: (a) "
          f"{RANGE_A}, with ranges and with rho = 0; (b) {RANGE_B} "
          f"[{label}]", flush=True)
    t_phase = time.perf_counter()
    errs = {}
    gen = torch.Generator(device=dev).manual_seed(22)
    R_a, t_a, data_a = rg.random_instance(gen, n, 3, **RANGE_A)
    gen = torch.Generator(device=dev).manual_seed(23)
    R_b, t_b, data_b = rg.random_instance(gen, n, 3, **RANGE_B)
    print(f"  (a) E = {data_a.src.numel()}, K = {data_a.rsrc.numel()}; (b) "
          f"E = {data_b.src.numel()}, K = {data_b.rsrc.numel()}; on "
          f"{data_a.src.device}", flush=True)
    if data_a.src.device.type != "cuda":
        raise AssertionError("random_instance did not make its data on the "
                             "card")
    rg.solve_range_aided(data_b, n, params=dataclasses.replace(
        rg.tnt.TNTParams(), max_iterations=1),
        generator=torch.Generator(device=dev))            # warm-up
    cases = (("(a) with ranges", data_a, R_a, t_a),
             ("(a) rho = 0", data_a._replace(
                 rho=torch.zeros_like(data_a.dists)), R_a, t_a),
             ("(b) noiseless", data_b, R_b, t_b))
    for tag, data, R_true, t_true in cases:
        out = range_solve(torch, dev, data, 1, label, tag)
        rot, te = alignment_errors(out.R, out.t, R_true,
                                   t_true - t_true[0][None])
        unit = float((torch.linalg.vector_norm(out.u, dim=-1) - 1.0).abs()
                     .max())
        errs[tag] = (float(rot), float(te), float(out.result.f))
        print(f"    rotation error {float(rot):.3e}, translation error "
              f"{float(te):.3e}, max||u| - 1| {unit:.2e}, t[0] "
              f"{out.t[0].tolist()}", flush=True)
        finite = all(bool(torch.isfinite(a).all())
                     for a in (out.R, out.t, out.u))
        if not (finite and out.R.device.type == "cuda" and unit <= 1e-5
                and bool((out.t[0] == 0).all())):
            raise AssertionError(f"phase 22 {tag}: not finite on the card, "
                                 f"a bearing off the unit sphere, or t[0] "
                                 f"!= 0")
    ratio = errs["(a) rho = 0"][1] / errs["(a) with ranges"][1]
    rot_b, t_b_err, f_b = errs["(b) noiseless"]
    print(f"  gates: (a) ranges tighten t by {ratio:.2f}x (> 1.5); (b) f "
          f"{f_b:.3e} < {RANGE_FLOORS['f']:g}, rotation {rot_b:.3e} < "
          f"{RANGE_FLOORS['rot']:g}, translation {t_b_err:.3e} < "
          f"{RANGE_FLOORS['t']:g}; phase {time.perf_counter() - t_phase:.1f}"
          f" s [{label}]", flush=True)
    if not (ratio > 1.5 and f_b < RANGE_FLOORS["f"]
            and rot_b < RANGE_FLOORS["rot"] and t_b_err < RANGE_FLOORS["t"]):
        raise AssertionError("phase 22: a gate failed")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


GLOO_OUTER = 6      # the two gloo ranks' block TNT: outer iterations


def block_tnt(torch, dev, mesh=None, outer=30):
    """The block-partitioned TNT of phase 23: ``bench.py:run_tier``'s
    Rayleigh quotient at n = 2^24 f32 (A = 1 + b i stored), automatic
    derivatives, run_tier's caps (30 outer, 50 CG; ``outer`` cuts the
    first); on a ``DTensor`` iterate over ``mesh``, or unsharded."""
    from optimization_tpu_torch import RiemannianProblem
    from optimization_tpu_torch import headline as H
    from optimization_tpu_torch.manifolds import sphere
    from optimization_tpu_torch.parallel.sharding import shard_model_vector
    from optimization_tpu_torch.solvers import tnt

    n = N_MAIN
    d = 1.0 + (999.0 / (n - 1)) * torch.arange(n, dtype=torch.float32,
                                               device=dev)
    x0 = H.initial_point(n, torch.float32, dev, 3)
    if mesh is not None:
        x0, d = shard_model_vector(x0, mesh), shard_model_vector(d, mesh)
    problem = RiemannianProblem(f=lambda x, dd: torch.dot(x, dd * x),
                                manifold=sphere())
    return timed_solve(torch, dev, lambda: tnt.solve(
        problem, x0, H.tier_params(1e-5, max_iterations=outer), data=d))


def parallel_phase(torch, dev, label):
    """Phase 23: the ``parallel`` package on one card: an NCCL group of one
    rank, the collectives at n = 2^24, ``sharded_gram_pair`` at config3's
    Gram shape, a row-sharded LOBPCG at config3, the block-partitioned TNT
    at n = 2^24, ``batch_sharded_solve`` on a config4 LASSO fleet,
    consensus ADMM on config4's rows; then two ranks sharing the card over
    gloo (when gloo takes CUDA tensors).  Returns the world-1 results the
    two-rank leg is held to."""
    import importlib

    import torch.distributed as dist

    from optimization_tpu_torch import CompositeProblem
    from optimization_tpu_torch.core.tree import tree_dot
    from optimization_tpu_torch.core.types import ADMMStatus, TNTStatus
    from optimization_tpu_torch.linalg import lobpcg
    from optimization_tpu_torch.parallel import (batch_mesh, collectives,
                                                 consensus,
                                                 initialize_distributed,
                                                 model_mesh)
    from optimization_tpu_torch.parallel.mesh import shard, spec
    from optimization_tpu_torch.parallel.sharding import (batch_sharded_solve,
                                                          shard_batch)
    from optimization_tpu_torch.solvers import admm, prox
    from optimization_tpu_torch.solvers import proximal_gradient as pg

    L = importlib.import_module("optimization_tpu_torch.linalg.lobpcg")
    print(f"phase 23: the parallel package on one card [{label}]",
          flush=True)
    initialize_distributed(coordinator_address=f"127.0.0.1:{free_port()}",
                           num_processes=1, process_id=0)
    world = {}
    try:
        mm, bm = model_mesh(1), batch_mesh(1)
        print(f"  group: {dist.get_backend()}, world {dist.get_world_size()}"
              f", meshes {mm} {bm}", flush=True)
        if dist.get_backend() != "nccl":
            raise AssertionError("a CUDA mesh must be served by NCCL")

        # the collectives at n = 2^24 f32: equal to the local reductions,
        # five repeats bitwise equal
        gen = torch.Generator(device=dev).manual_seed(23)
        v, w = (torch.randn(N_MAIN, generator=gen, device=dev)
                for _ in range(2))
        dots = torch.stack([collectives.pdot(v, w, mm) for _ in range(5)])
        norms = torch.stack([collectives.pnorm(v, mm) for _ in range(5)])
        mean = collectives.pmean_tree((v, w.sum()), mm)
        same = (bool((dots == tree_dot(v, w)).all())
                and bool((norms == torch.sqrt(tree_dot(v, v))).all())
                and torch.equal(mean[0], v) and torch.equal(mean[1], w.sum()))
        print(f"  pdot {float(dots[0]):.6e}, pnorm {float(norms[0]):.6e}: "
              f"five repeats and the local reductions bitwise equal: {same}",
              flush=True)
        if not same:
            raise AssertionError("phase 23: a collective left the local "
                                 "reduction or was not deterministic")
        world["pdot"] = float(dots[0])

        # sharded_gram_pair at config3's Gram shape == gram_pair alone
        S, AS, BS = (torch.randn((100_000, 48), generator=gen, device=dev)
                     for _ in range(3))
        ga, gb = collectives.sharded_gram_pair(S, AS, BS, mm)
        ra, rb = L._gram(S, AS, BS)
        eq = torch.equal(ga, ra) and torch.equal(gb, rb)
        print(f"  sharded_gram_pair 100,000 x 48 f32 == gram_pair alone: "
              f"{eq}", flush=True)
        if not eq:
            raise AssertionError("phase 23: sharded_gram_pair != gram_pair")
        world["gram"] = (S, AS, BS, ga, gb)

        # row-sharded LOBPCG at config3
        m, nx, nev = 100_000, 16, 5
        dl = torch.linspace(1.0, float(m), m, device=dev)

        def config3(axis, max_iterations=100):
            g = torch.Generator(device=dev).manual_seed(3)
            X0 = torch.randn((m, nx), generator=g, device=dev)
            return lobpcg(lambda S_: dl[:, None] * S_,
                          T=lambda S_: S_ / dl[:, None], X0=X0, nev=nev,
                          max_iterations=max_iterations, tau=1e-4,
                          generator=g, axis=axis)

        config3(None, 2)                                   # warm-up
        config3(mm, 2)
        ref, s_ref = timed_solve(torch, dev, lambda: config3(None))
        sh, s_sh = timed_solve(torch, dev, lambda: config3(mm))
        rel = float(((sh.theta - ref.theta) / ref.theta).abs().max())
        print(f"  LOBPCG config3: unsharded {int(ref.num_iterations)} it in "
              f"{s_ref:.3f} s, row-sharded {int(sh.num_iterations)} it in "
              f"{s_sh:.3f} s, nc {int(sh.num_converged)}, theta rel diff "
              f"{rel:.2e} (< 1e-5) [{label}]", flush=True)
        if not (rel < 1e-5 and int(sh.num_converged) >= nev):
            raise AssertionError("phase 23: the row-sharded LOBPCG left the "
                                 "unsharded solve")

        # the block-partitioned TNT at n = 2^24
        block_tnt(torch, dev)                      # warm-up of the jvp
        ref, s_ref = block_tnt(torch, dev)
        sh, s_sh = block_tnt(torch, dev, mm)
        rel = abs(float(sh.f) - float(ref.f)) / abs(float(ref.f))
        for tag, res, secs in (("unsharded (jvp hvp)", ref, s_ref),
                               ("DTensor (reverse hvp)", sh, s_sh)):
            outer, cg = counts(res)
            print(f"  block TNT {tag}: {TNTStatus(int(res.status)).name}, "
                  f"{outer} outer / {cg} CG, f* {float(res.f):.7f}, "
                  f"{secs:.3f} s = {cg / secs:.0f} CG it/s [{label}]",
                  flush=True)
        print(f"  block TNT: |f*_sharded - f*| / f* {rel:.2e} (<= 1e-5)",
              flush=True)
        if not (int(sh.status) == int(ref.status) and rel <= 1e-5):
            raise AssertionError("phase 23: the block TNT left the "
                                 "unsharded solve")
        # what the two gloo ranks' shorter block TNT is held to
        world["block_f"] = float(block_tnt(torch, dev, mm,
                                           GLOO_OUTER)[0].f)

        # batch_sharded_solve on a config4 LASSO fleet (FISTA)
        (mr, nc), mu, B = LASSO_SHAPE, 0.1, 4
        g4 = torch.Generator(device=dev).manual_seed(4)
        As = torch.randn((B, mr, nc), generator=g4, device=dev) / math.sqrt(mr)
        xt = torch.where(torch.rand((B, nc), generator=g4, device=dev) < 0.01,
                         torch.randn((B, nc), generator=g4, device=dev), 0.0)
        bs = (As @ xt[..., None])[..., 0] + 0.01 * torch.randn(
            (B, mr), generator=g4, device=dev)
        lasso = CompositeProblem(
            f=lambda x, d: 0.5 * torch.sum((d["A"] @ x - d["b"]) ** 2),
            g=lambda x, d: mu * torch.sum(torch.abs(x)),
            prox_g=lambda x, lam, d: prox.soft_threshold(x, lam * mu))
        params = pg.ProximalGradientParams(
            max_iterations=300, composite_gradient_tolerance=1e-3,
            relative_composite_gradient_tolerance=1e-6)
        solve = lambda x0, d: pg.solve(lasso, x0, params, d)
        x0s = torch.zeros((B, nc), device=dev)
        fleet, secs = timed_solve(torch, dev, lambda: batch_sharded_solve(
            solve, bm)(x0s, {"A": As, "b": bs}))
        alone = [solve(x0s[i], {"A": As[i], "b": bs[i]}) for i in range(B)]
        eq = all(torch.equal(fleet.x[i], r.x) and torch.equal(fleet.f[i], r.f)
                 for i, r in enumerate(alone))
        print(f"  batch_sharded_solve, config4 fleet B = {B} (FISTA): "
              f"{fleet.num_iterations.tolist()} iterations, {secs:.3f} s, "
              f"each instance bitwise equal to its own solve: {eq} "
              f"[{label}]", flush=True)
        if not eq:
            raise AssertionError("phase 23: batch_sharded_solve left an "
                                 "instance's own solve")

        # consensus ADMM: config4's rows in N = 4 scenarios, against FISTA
        N = 4
        A, b = As[0], bs[0]
        Ai, bi = A.reshape(N, mr // N, nc), b.reshape(N, mr // N)

        def local_argmin(z, lam_i, rho, data_i):
            # (Ai'Ai + rho I)^-1 v by Woodbury through the scenario's rows
            Aj, bj = data_i
            v_ = Aj.T @ bj - lam_i + rho * z
            K = Aj @ Aj.T + rho * torch.eye(Aj.shape[0], device=Aj.device)
            return (v_ - Aj.T @ torch.linalg.solve(K, Aj @ v_)) / rho

        cproblem = consensus.consensus_problem(
            local_argmin,
            prox_g=lambda v_, lam, d: prox.soft_threshold(v_, mu * lam))
        cparams = admm.ADMMParams(
            max_iterations=1000, eps_rel=1e-5, eps_abs_pri=1e-4,
            eps_abs_dual=1e-4, rho=1.0,
            penalty_adaptation_mode=admm.ADMMPenaltyAdaptation
            .RESIDUAL_BALANCE,
            penalty_adaptation_period=2, penalty_adaptation_window=200)
        zeros = shard_batch(torch.zeros((N, nc), device=dev), bm)
        cres, secs = timed_solve(torch, dev, lambda: admm.solve(
            cproblem, zeros, zeros, shard(torch.zeros(nc, device=dev), bm,
                                          spec()),
            cparams, data=shard_batch((Ai, bi), bm)))
        full = pg.solve(lasso, torch.zeros(nc, device=dev), params,
                        {"A": A, "b": b})
        obj = lambda x: float(lasso.value(x, {"A": A, "b": b}))
        y = cres.y.full_tensor()
        print(f"  consensus ADMM, N = {N} scenarios of config4's rows: "
              f"{ADMMStatus(int(cres.status)).name} in "
              f"{int(cres.num_iterations)} iterations, {secs:.3f} s; "
              f"objective {obj(y):.6f} vs full-data FISTA {obj(full.x):.6f}"
              f" (<= 1.02x) [{label}]", flush=True)
        if not obj(y) <= 1.02 * obj(full.x):
            raise AssertionError("phase 23: consensus ADMM missed FISTA's "
                                 "objective by more than 2%")
    finally:
        dist.destroy_process_group()
    gloo_two_ranks(torch, dev, label, world)


def gloo_two_ranks(torch, dev, label, world):
    """Two ranks sharing the card over gloo (NCCL refuses two ranks on one
    GPU): each a ``chip_smoke.py --gloo-rank`` process; pdot,
    sharded_gram_pair and the block TNT held to the world-1 results."""
    import tempfile

    S, AS, BS, ga, gb = world["gram"]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        torch.save({"S": S, "AS": AS, "BS": BS}, os.path.join(tmp, "in.pt"))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gloo-rank",
             str(r), "2", tmp], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (out, err) in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"a gloo rank failed (rc "
                                     f"{p.returncode}):\n{err[-3000:]}")
        res = json.loads(outs[0][0].strip().splitlines()[-1])
        if not res["gloo_cuda"]:
            print(f"  two ranks over gloo: gloo refused CUDA tensors "
                  f"({res['error']}); cross-rank behaviour rests on the CPU "
                  f"tests", flush=True)
            return
        got = torch.load(os.path.join(tmp, "out.pt"))
    tol = [1e-5 * (S.double().abs().mT @ X.double().abs())
           for X in (AS, BS)]
    gram_ok = all(bool(((g.double() - r.double()).abs() <= t).all())
                  for g, r, t in zip((got["ga"], got["gb"]), (ga, gb), tol))
    d_pdot = abs(res["pdot"] - world["pdot"]) / abs(world["pdot"])
    d_f = abs(res["block_f"] - world["block_f"]) / abs(world["block_f"])
    print(f"  two ranks sharing the card over gloo: pdot rel diff "
          f"{d_pdot:.2e} (<= 1e-5), sharded_gram_pair within the gram_pair "
          f"tolerance of world 1: {gram_ok}, block TNT capped at "
          f"{GLOO_OUTER} outer: "
          f"{res['block_status']} in {res['block_outer']} outer / "
          f"{res['block_cg']} CG, {res['block_s']:.3f} s, f* rel diff "
          f"{d_f:.2e} (<= 1e-5) [{label}]", flush=True)
    if not (d_pdot <= 1e-5 and gram_ok and d_f <= 1e-5):
        raise AssertionError("phase 23: the two gloo ranks left the world-1 "
                             "results")


def gloo_rank_main(rank, world, tmp):
    """One of phase 23's two gloo ranks on the one card (``chip_smoke.py
    --gloo-rank <rank> <world> <dir>``): rank 0 prints a JSON line and
    saves its sharded_gram_pair to <dir>/out.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.parallel import (collectives,
                                                 initialize_distributed,
                                                 make_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    initialize_distributed(init_method=f"file://{tmp}/store",
                           num_processes=world, process_id=rank,
                           device_type="cpu")
    out = {"gloo_cuda": True}
    try:
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
    except Exception as e:                  # gloo without CUDA support
        out.update(gloo_cuda=False, error=f"{type(e).__name__}: {e}")
    if out["gloo_cuda"]:
        mesh = make_mesh((world,), ("model",), devices="cuda")
        gen = torch.Generator(device=dev).manual_seed(23)
        v, w = (torch.randn(N_MAIN, generator=gen, device=dev)
                for _ in range(2))
        k = N_MAIN // world
        rows = slice(rank * k, (rank + 1) * k)
        out["pdot"] = float(collectives.pdot(v[rows], w[rows], mesh))
        inp = torch.load(os.path.join(tmp, "in.pt"))
        k = inp["S"].shape[0] // world
        rows = slice(rank * k, (rank + 1) * k)
        ga, gb = collectives.sharded_gram_pair(
            inp["S"][rows], inp["AS"][rows], inp["BS"][rows], mesh)
        res, secs = block_tnt(torch, dev, mesh, GLOO_OUTER)
        outer, cg = counts(res)
        out.update(block_f=float(res.f), block_outer=outer, block_cg=cg,
                   block_s=secs,
                   block_status=TNTStatus(int(res.status)).name)
        if rank == 0:
            torch.save({"ga": ga, "gb": gb}, os.path.join(tmp, "out.pt"))
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out), flush=True)



# ---- the rank-3 and rank-8 paths (phase 24) ----

R3_MU = 10.0
# headline.tier_params (at most 30 outer, <= 50 CG each) with |grad| <=
# 2e-2, which stops tests/test_torch_streamed_cg.py's n = 8192 solve before
# f32's floor (where the two engines' late subproblems part); at n = 2^24
# both engines run to the 30-outer cap (|grad| 0.18 on an H100)
R3_GRAD_TOL = 2e-2
# the rank-8 problem's generated c_j: c0 + spread i / (n - 1), in [0, 1]
R8_AFFINE = ((0.25, 0.5), (0.9, -0.8), (0.1, 0.3))


class Quartic:
    """The quartic sphere problems of tests/test_torch_streamed_cg.py at
    size n on the card: f(x) = <x, a x> + (mu/4) sum_j q_j^2, q_j = <x, c_j
    x>, a = 1 + 999 i / (n - 1) (kappa = 1000), mu = 10; ``stored`` c_j
    uniform in [0, 1) from a seeded generator on the card, then one
    generated c_j (an AffineDiagonal) for each (c0, spread) of ``affine``.
    Its projected Hessian is A0 + U B U' with A0 = 2a + mu sum_j q_j c_j -
    lam, U = (x, a x, c_1 x, ...): k = 2 + the number of c_j, a0 a wrapped
    callable of aux = (lam, q_1, ...), weights (None, a, c_1, ...).  One
    stored c is the rank-3 problem (``Rank3``), in its arithmetic; three
    stored and ``R8_AFFINE`` the rank-8 one (``Rank8``)."""

    def __init__(self, torch, n, dev, seed=13, stored=1, affine=()):
        from optimization_tpu_torch.kernels.streamed_cg import (
            AffineDiagonal, ElementwiseFn)

        self.torch, self.n = torch, n
        self.diag = AffineDiagonal(1.0, 999.0 / (n - 1))
        self.a = self.diag.values(n, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.stored = [torch.rand(n, generator=gen, device=dev)
                       for _ in range(stored)]
        self.generated = [AffineDiagonal(c0, sp / (n - 1))
                          for c0, sp in affine]
        self.cs = self.stored + [c.values(n, dev) for c in self.generated]
        a, cs = self.a, self.cs

        def a0(i, aux):
            d = 2.0 * a
            for j, c in enumerate(cs):
                d = d + (R3_MU * aux[1 + j]) * c
            return d - aux[0]

        self.a0fn = ElementwiseFn(a0)
        self.weights = (None, self.diag, *self.stored, *self.generated)
        self.k = len(self.weights)

    def qs(self, x):
        return [self.torch.dot(x, c * x) for c in self.cs]

    def d(self, qs):
        """2a + mu sum_j q_j c_j: grad f = d x on the sphere."""
        d = 2.0 * self.a
        for q, c in zip(qs, self.cs):
            d = d + R3_MU * q * c
        return d

    def operator(self, x):
        """(B, lam, (q_1, ...)) at the unit x."""
        torch = self.torch
        qs = self.qs(x)
        lam = torch.dot(x, self.d(qs) * x)
        z = torch.zeros_like(lam)
        b00 = 2.0 * lam
        for q in qs:
            b00 = b00 + 2.0 * R3_MU * q * q
        m = len(qs)
        rows = [torch.stack([b00, z - 2.0]
                            + [-3.0 * R3_MU * q for q in qs]),
                torch.stack([z - 2.0, z] + [z] * m)]
        for j, q in enumerate(qs):
            rows.append(torch.stack([-3.0 * R3_MU * q, z] + [
                z + 2.0 * R3_MU if t == j else z for t in range(m)]))
        return torch.stack(rows), lam, qs

    def problem(self, engine):
        """The RiemannianProblem: ``streamed`` (the kernel through
        ``flat_solve``) or ``flat`` (the eager flat engine through
        ``flat_qm``)."""
        from optimization_tpu_torch.core.problem import RiemannianProblem
        from optimization_tpu_torch.kernels.streamed_cg import (
            stpcg_flat_streamed)
        from optimization_tpu_torch.manifolds.sphere import sphere

        torch, a, M = self.torch, self.a, sphere()

        def f(x, _):
            t = torch.dot(x, a * x)
            for q in self.qs(x):
                t = t + 0.25 * R3_MU * q * q
            return t

        def grad(x, _):
            return M.proj(x, self.d(self.qs(x)) * x)

        def flat_solve(g, x, _, aux, Delta, params):
            B, lam, qs = self.operator(x)
            return stpcg_flat_streamed(
                g, x, B, Delta, (lam, *qs), a0_chunk=self.a0fn,
                weights=self.weights,
                max_iterations=params.max_TPCG_iterations,
                kappa_fgr=params.kappa_fgr, theta=params.theta)

        def flat_qm(x, _, aux=None):
            B, lam, qs = self.operator(x)
            a0 = self.d(qs) - lam
            return ((lambda v: a0 * v), (x, a * x, *(c * x for c in self.cs)),
                    B)

        if engine == "streamed":
            return RiemannianProblem(f=f, manifold=M, grad=grad,
                                     flat_solve=flat_solve)
        return RiemannianProblem(f=f, manifold=M, grad=grad, flat_qm=flat_qm)


def Rank3(torch, n, dev, seed=13):
    """The rank-3 problem: one stored c (k = 3)."""
    return Quartic(torch, n, dev, seed)


def Rank8(torch, n, dev, seed=13):
    """The rank-8 problem: three stored c_j and R8_AFFINE's three generated
    ones (k = 8), so a stored and a generated weight run at k > 4."""
    return Quartic(torch, n, dev, seed, stored=3, affine=R8_AFFINE)


# f32 operations an element a pass of all the folded weights together in
# csrc/streamed_cg_any.cu: (C + D f32(i)) p x into q2 (3) and the two sums
# y and f32(i) y (3)
FOLD_OPS = 6


def term_cost(t, a0=False, folded=False):
    """(bytes an iteration, bytes once, f32 operations an iteration) an
    element of one term of the kernel's operator (a weight, or ``a0``):
    a stored or wrapped term is read once a pass (4 B) and a wrapped one
    written once when evaluated; a generated term costs c + b i (2 ops,
    and 1 more for 2t, 2 for 2t - aux0); a weight adds u = w x (1, none
    for the weight 1) and its two multiply-adds (into q = Hp and into
    U'(A0 r), 4).  ``folded`` (csrc/streamed_cg_any.cu, k >= 5): the
    weight 1 and a generated weight cost nothing of their own (their fold,
    FOLD_OPS, is counted once by ``subproblem_bound``)."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        ElementwiseFn, ScaledDiagonal, ShiftedDiagonal)

    wrap = ScaledDiagonal if not a0 else ShiftedDiagonal
    inner = t.a if isinstance(t, wrap) else t
    extra = (2 if a0 else 1) if isinstance(t, wrap) else 0
    if t is None:
        return 0, 0, 0 if folded else 4
    if folded and not a0 and not isinstance(inner, ElementwiseFn) and \
            not hasattr(inner, "shape"):
        return 0, 0, 0
    own = 0 if a0 else 5
    if isinstance(inner, ElementwiseFn):
        return 4, 4, own + extra
    if hasattr(inner, "shape"):
        return 4, 0, own + extra
    return 0, 0, own + 2 + extra


def subproblem_bound(n, its, a0c, weights, prec_chunk=None, word=4,
                     init=False):
    """(ms, "bytes" or "operations") of one subproblem of ``its`` CG
    iterations on the card: each iteration the pair body's 6n words of the
    storage type (5 deferring, 7 applying) plus each stored term's n f32
    words, and ~20 operations an element for the body's own arithmetic
    (p, r, the four dots, s) plus each term's (``term_cost``); once, the
    init pass (g and x read, the stored terms, V'V: (k+2)(k+3) operations
    an element) unless ``init``, each wrapped term's evaluation and, with
    P, the tail's read and write of s.  A generated P adds its |a0| + c and
    rsqrt (3 operations, 4 for the quarter power) and p w per weight; a
    stored or wrapped one n words a pass.  At k >= 5
    (``csrc/streamed_cg_any.cu``) the weight 1 and the generated weights
    are folded (``term_cost(folded=True)``, FOLD_OPS once) and the init's
    Gram is of 4 + (stored weights) rows."""
    k = len(weights)
    folded = k > 4
    costs = [term_cost(a0c, a0=True)] + [term_cost(w, folded=folded)
                                         for w in weights]
    b_it = 6 * word + sum(c[0] for c in costs)
    b_once = sum(c[1] for c in costs)
    ops_it = 20 + sum(c[2] for c in costs) + (FOLD_OPS if folded else 0)
    if prec_chunk is not None:
        if hasattr(prec_chunk, "e"):
            ops_it += (3 if prec_chunk.e == 0.5 else 4) + k + 2
        else:
            pb = term_cost(prec_chunk)
            b_it, b_once, ops_it = b_it + pb[0], b_once + pb[1], ops_it + k + 2
        b_once += 2 * word
    ops_once = 0
    if not init:
        b_once += 2 * word + sum(c[0] for c in costs)
        rows = 4 + sum(1 for c in costs[1:] if c[0]) if folded else k + 2
        ops_once = rows * (rows + 1) + ops_it
    return bound((b_it * its + b_once) * n, (ops_it * its + ops_once) * n)


def timed_subproblem(torch, label, tag, args, kw, plain_reps=3):
    """One subproblem: the kernel held against its plain version, then
    both timed by CUDA events, beside ``subproblem_bound`` of its own
    iterations; (its, err, ms, plain_ms, bound_ms, bound_by)."""
    from optimization_tpu_torch.kernels.streamed_cg import (
        stpcg_flat_streamed, stpcg_flat_streamed_reference)

    n = args[0].shape[0]
    res = stpcg_flat_streamed(*args, **kw)
    ref = stpcg_flat_streamed_reference(*args, **kw)
    err = check_parity(torch, res, ref, args[0].dtype, tag)
    its = int(res.num_iterations)
    ms = time_ms(torch, lambda: stpcg_flat_streamed(*args, **kw), 10)
    plain_ms = time_ms(torch,
                       lambda: stpcg_flat_streamed_reference(*args, **kw),
                       plain_reps)
    bound_ms, bound_by = subproblem_bound(
        n, its, kw["a0_chunk"], kw["weights"], kw.get("prec_chunk"),
        args[0].element_size(), kw.get("init") is not None)
    print(f"  {tag}: {its} CG it, kernel {ms:.3f} ms = "
          f"{ms / max(its, 1):.4f} ms an iteration, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it "
          f"[{label}]", flush=True)
    return its, err, ms, plain_ms, bound_ms, bound_by


# the K >= 5 subproblems of phase 24: (K, storage, P), 50 CG at n = 2^24
GEN_TIMED = ((5, "f32", None), (8, "f32", None), (16, "f32", None),
             (32, "f32", None), (8, "bf16", None), (8, "f32", "jacobi"))
# and GEN_MIXES' (K, mix), 50 CG at n = 2^24 in f32
MIX_TIMED = GEN_MIXES


def quartic_tnt(torch, dev, label, prob, tag, x0, params):
    """A quartic problem's TNT through the kernel (``flat_solve``) and the
    eager flat engine (``flat_qm``) at n = 2^24; gated on equal statuses
    and outer counts, f* within 1e-4 relative, CG within 10% and kernel
    launches = subproblems.  Returns the kernel's launches."""
    from optimization_tpu_torch import headline as H
    from optimization_tpu_torch.core.types import TNTStatus
    from optimization_tpu_torch.kernels.streamed_cg import (
        stpcg_flat_streamed)

    probs = {name: prob.problem(name) for name in ("streamed", "flat")}
    for p in probs.values():               # warm-up: first launches
        H.run_tier(p, x0, H.tier_params(0.0, max_iterations=1))
    # ---- the path's run: the count starts at 0 here ----
    stpcg_flat_streamed.launches = 0
    kr = H.run_tier(probs["streamed"], x0, params)
    launches = stpcg_flat_streamed.launches
    # ---- end of the run ----
    fr = H.run_tier(probs["flat"], x0, params)
    for name, t in (("kernel, flat_solve", kr), ("eager flat engine, "
                                                  "flat_qm", fr)):
        print(f"  {tag} TNT ({name}): {t.outer} outer / {t.inner} CG in "
              f"{t.seconds:.3f} s = {t.cg_per_s:.0f} CG it/s, f* = "
              f"{t.fstar:.7f}, |g| = {float(t.result.gradfx_norm):.3e}, "
              f"{TNTStatus(int(t.result.status)).name} [{label}]",
              flush=True)
    subproblems = kr.outer - int(int(kr.result.status) in (
        TNTStatus.GRADIENT, TNTStatus.PRECONDITIONED_GRADIENT))
    xs = kr.result.x
    ok = (int(kr.result.status) == int(fr.result.status)
          and kr.outer == fr.outer
          and abs(kr.fstar - fr.fstar) <= 1e-4 * abs(fr.fstar)
          and abs(kr.inner - fr.inner) <= 0.1 * max(kr.inner, fr.inner)
          and launches == subproblems and math.isfinite(kr.fstar)
          and bool(torch.isfinite(xs).all())
          and abs(float(torch.linalg.vector_norm(xs)) - 1.0) < 1e-2)
    if not ok:
        for name, t in (("kernel", kr), ("flat", fr)):
            print(f"  {name}: |g| {t.result.gradient_norms[:t.outer + 1]}"
                  f", CG {t.result.inner_iterations[:t.outer]}", flush=True)
        raise AssertionError(
            f"{tag} TNT: status {int(kr.result.status)}/"
            f"{int(fr.result.status)}, outer {kr.outer}/{fr.outer}, f* "
            f"{kr.fstar}/{fr.fstar}, CG {kr.inner}/{fr.inner}, launches "
            f"{launches} for {subproblems} subproblems")
    print(f"  gates passed: statuses and outer counts equal, |df*| = "
          f"{abs(kr.fstar - fr.fstar):.3e} within 1e-4 relative, CG within "
          f"10%, kernel launches {launches} = subproblems", flush=True)
    return launches


def general_phase(torch, dev, label):
    """Phase 24: the kernel at K = 1, 3, 4 and (``csrc/streamed_cg_any.cu``)
    K = 5, 8, 16, 32, bf16 at K = 8 and a generated P at K = 8, each on one
    50-CG subproblem at n = 2^24 beside its bound; the any-K kernel's fixed
    cost an iteration at K = 8, 16, 64; then the rank-3 and the rank-8 TNT
    at n = 2^24 through the kernel and through the eager flat engine.
    Returns the rank-3 and rank-8 kernels' entries of the kernels line."""
    from optimization_tpu_torch import headline as H
    from optimization_tpu_torch.kernels.streamed_cg import (
        AffineDiagonal, stpcg_flat_streamed)

    n = N_MAIN
    print(f"phase 24: the kernel at rank K = 1, 3, 4, 5, 8, 16, 32 (50-CG "
          f"subproblems, n = 2^24) and the rank-3 and rank-8 TNT at "
          f"n = 2^24 [{label}]", flush=True)
    # K = 1 and 4: a positive-definite operator with kappa ~ 1000 at a
    # random point and no truncation (kappa_fgr = 0): 50 interior steps
    wide = AffineDiagonal(1.0, 999.0 / (n - 1))
    fixed = dict(max_iterations=50, kappa_fgr=0.0, theta=0.5)
    for k, weights in ((1, (None,)),
                       (4, tuple(gen_term(torch, f, n, dev)
                                 for f in ("one", "twice", "stored", "fn")))):
        g, x, B, aux = gen_args(torch, k, n, torch.float32, dev, seed=7)
        timed_subproblem(torch, label, f"K={k} subproblem",
                         (g, x, B, 1e6, aux),
                         dict(fixed, a0_chunk=wide, weights=weights))
    # K >= 5: gen_weights' mix (a quarter stored, a quarter wrapped, the
    # rest generated, and the weight 1); the plain version at K = 32 runs
    # ~0.8 s a call, timed over 1 call
    for k, storage, pform in GEN_TIMED:
        dtype = torch.bfloat16 if storage == "bf16" else torch.float32
        g, x, B, aux = gen_args(torch, k, n, dtype, dev, seed=7)
        weights = gen_weights(torch, k, n, dev)
        kw = dict(fixed, a0_chunk=wide, weights=weights)
        if pform:
            pc, pm = gen_prec(torch, pform, wide, aux, n, dev)
            kw.update(prec_chunk=pc, prec=pm)
        timed_subproblem(
            torch, label, f"K={k} {storage}{' P=' + pform if pform else ''}"
            f" subproblem", (g, x, B, 1e6, aux), kw,
            plain_reps=1 if k >= 16 else 3)
    # GEN_MIXES' operators at full size (the plain version timed once)
    for k, mix in MIX_TIMED:
        g, x, B, aux = gen_args(torch, k, n, torch.float32, dev, seed=7)
        kw = dict(fixed, a0_chunk=wide,
                  weights=mix_weights(torch, mix, k, n, dev))
        timed_subproblem(torch, label, f"K={k} {mix} subproblem",
                         (g, x, B, 1e6, aux), kw, plain_reps=1)
    # the fixed cost of a CG iteration (K-sized algebra, the two-barrier
    # reduction, the pass over 2^16 elements): the slope from 10 to 50 CG
    for k in (8, 16, 64):
        m = 1 << 16
        g, x, B, aux = gen_args(torch, k, m, torch.float32, dev, seed=7)
        kw = dict(fixed, a0_chunk=AffineDiagonal(1.0, 999.0 / (m - 1)),
                  weights=gen_weights(torch, k, m, dev))
        t = [time_ms(torch, lambda its=its: stpcg_flat_streamed(
            g, x, B, 1e6, aux, **dict(kw, max_iterations=its)), 10)
            for its in (10, 50)]
        print(f"  K={k}: a CG iteration at n = 2^16 (its fixed cost) "
              f"{(t[1] - t[0]) / 40 * 1e3:.2f} us [{label}]", flush=True)

    entries = []
    params = H.tier_params(R3_GRAD_TOL)
    for prob, tag, seed in ((Rank3(torch, n, dev), "rank-3", 5),
                            (Rank8(torch, n, dev), "rank-8", 5)):
        # the problem's own subproblem at its 11th outer iteration
        streamed = prob.problem("streamed")
        x0 = H.initial_point(n, torch.float32, dev, seed)
        k_mid = 10
        mid = H.run_tier(streamed, x0,
                         H.tier_params(R3_GRAD_TOL, max_iterations=k_mid))
        x = mid.result.x
        B, lam, qs = prob.operator(x)
        g = streamed.rgrad(x)
        kw = dict(a0_chunk=prob.a0fn, weights=prob.weights,
                  max_iterations=50, kappa_fgr=params.kappa_fgr,
                  theta=params.theta)
        args = (g, x, B, mid.result.trust_region_radius[k_mid], (lam, *qs))
        its, err, ms, plain, bnd, by = timed_subproblem(
            torch, label, f"K={prob.k} {tag} subproblem (outer "
            f"{k_mid + 1})", args, kw)
        launches = quartic_tnt(torch, dev, label, prob, tag, x0, params)
        entries.append({
            "name": f"stpcg_flat_streamed[k={prob.k}]", "route": "cuda",
            "source": ("optimization_tpu_torch/csrc/streamed_cg.cu"
                       if prob.k <= 4 else
                       "optimization_tpu_torch/csrc/streamed_cg_any.cu"),
            "replaces": "optimization_tpu/kernels/streamed_cg.py:95",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None})
    return entries


# ---- the examples (phases 25-26) ----

DIGEST_KEYS = ("status", "statuses", "iters", "nc", "certified", "n_cert",
               "low_status", "switch_iteration", "high_iters", "p_final")


def digest(out, path=""):
    """The statuses and counts of an example's result as ``key=value``
    items (per-instance lists for a fleet's or a stream's rows)."""
    items = []
    for key, v in out.items():
        name = f"{path}{key}"
        if isinstance(v, dict):
            items += digest(v, name + ".")
        elif key in DIGEST_KEYS:
            items.append(f"{name}={v}")
        elif key in ("instances", "rows"):
            items += [f"{name}.{k}={[r[k] for r in v]}"
                      for k in ("status", "iters", "certified")]
    return items


def examples_phase(torch, dev, label):
    """Phase 25: every example's ``main()`` in process on the card, at the
    JAX example's sizes (each applies the JAX example's acceptance check
    and raises if it fails); its wall time, statuses and counts and its
    gram_pair launches, which must be > 0 exactly for the examples whose
    path runs LOBPCG (``examples.LOBPCG_EXAMPLES``).
    Returns ``lobpcg_example``'s result for phase 26."""
    import importlib

    from optimization_tpu_torch.examples import EXAMPLES, LOBPCG_EXAMPLES
    from optimization_tpu_torch.kernels import fused as F

    print(f"phase 25: the {len(EXAMPLES)} examples, each main() in process "
          f"on the card at the JAX example's sizes [{label}]", flush=True)
    t_phase = time.perf_counter()
    results = {}
    for name in EXAMPLES:
        module = importlib.import_module(
            f"optimization_tpu_torch.examples.{name}")
        before = F.gram_pair.launches
        results[name], secs = timed_solve(torch, dev,
                                          lambda: module.main([]))
        launches = F.gram_pair.launches - before
        print(f"  [{name}] {secs:.2f} s, gram_pair launches {launches}: "
              f"{' '.join(digest(results[name]))} [{label}]", flush=True)
        if (launches > 0) != (name in LOBPCG_EXAMPLES):
            raise AssertionError(f"{name}: {launches} gram_pair launches")
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s [{label}]",
          flush=True)
    return results["lobpcg_example"]


def example_as_a_user_phase(label, inproc):
    """Phase 26: ``python -m optimization_tpu_torch.examples.lobpcg_example``
    in a subprocess, as a user runs it (on the card by default): exit 0,
    and the same iteration and convergence counts as phase 25's in-process
    run of the same seeds.  Its gram_pair launches are that process's own,
    outside the kernels line's count and the holding of phase 25."""
    print(f"phase 26: python -m optimization_tpu_torch.examples."
          f"lobpcg_example in a subprocess [{label}]", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "optimization_tpu_torch.examples."
         "lobpcg_example"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"  | {line}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr, flush=True)
        raise AssertionError(f"lobpcg_example exited {proc.returncode}")
    for tag, key in (("[LOBPCG diag-500]", "diag"),
                     ("[LOBPCG structured-1e5]", "big")):
        want = f"{tag} iters={inproc[key]['iters']} nc={inproc[key]['nc']} "
        if not any(line.startswith(want)
                   for line in proc.stdout.splitlines()):
            raise AssertionError(f"lobpcg_example as a module: no line "
                                 f"{want!r}")
    print(f"  exit 0 in {secs:.1f} s (the interpreter and the card's set-up "
          f"included); iterations and converged counts equal to phase "
          f"25's [{label}]", flush=True)


def check_held(held, launches, what):
    """Print and gate a ``held_gram_pair`` block: every launch held, each
    within its tolerance."""
    shapes = ", ".join(f"{'x'.join(map(str, shape))}{' BS = S' * same}"
                       for shape, same in sorted(held["shapes"]))
    print(f"gram_pair launches {what}: {launches}, each held against the "
          f"plain version on its inputs ({held['calls']} calls at "
          f"{shapes}): max |err| {held['err']:.3e} (entries up to "
          f"{held['scale']:.3e}), at most {held['ratio']:.3f} of the "
          f"tolerance (<= 1)", flush=True)
    if launches == 0:
        raise AssertionError(f"no gram_pair launch {what}")
    if held["calls"] != launches or not held["ratio"] <= 1:
        raise AssertionError(f"gram_pair {what}: a launch was not held, or "
                             f"disagrees with its plain version")


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
    probe_parity_phase(torch, dev)
    probe_kernels = probe_timing_phase(torch, dev, label, ceiling)
    convex_phase(torch, dev, label)
    chunk_parity_phase(torch, dev)
    chunk_kernel, graph_rates, segment_numbers = graph_probe_phase(
        torch, dev, label, ceiling)
    from optimization_tpu_torch.kernels import segment_sum
    # ---- the graph models' path (phases 17-21): the count starts at 0 ----
    segment_sum.launches = 0
    rotation_sync_phase(torch, dev, label)
    staircase_lift_phase(torch, dev, label)
    completion_phase(torch, dev, label)
    # ---- the pose path's gram_pair runs: the count starts at 0 here ----
    from optimization_tpu_torch.kernels import fused as F
    F.gram_pair.launches = 0
    with held_gram_pair(torch) as held:
        pose = pose_cli_phase(torch, dev, label)
        pose_routes_phase(torch, dev, label, *pose)
    pose_launches = F.gram_pair.launches
    # ---- end of the pose path's gram_pair runs ----
    segment_launches = segment_sum.launches
    # ---- end of the graph models' path ----
    print(f"  segment_sum launches over phases 17-21: {segment_launches}",
          flush=True)
    if segment_launches <= 0:
        raise AssertionError("segment_sum was not launched on the graph "
                             "models' path")
    check_held(held, pose_launches, "on the pose path (phases 20-21)")
    errs7["gram_pair"] = max(errs7["gram_pair"], held["err"])
    # ---- range sync's and the parallel package's gram_pair runs ----
    F.gram_pair.launches = 0
    with held_gram_pair(torch) as held:
        # ---- range sync's segment sums: the count starts at 0 here ----
        segment_sum.launches = 0
        range_sync_phase(torch, dev, label)
        range_launches = segment_sum.launches
        # ---- end of range sync's segment sums ----
        print(f"  segment_sum launches in phase 22: {range_launches}",
              flush=True)
        if range_launches <= 0:
            raise AssertionError("segment_sum was not launched on range "
                                 "sync's path")
        parallel_phase(torch, dev, label)
    last_launches = F.gram_pair.launches
    # ---- end of phases 22-23's gram_pair runs ----
    check_held(held, last_launches, "in phases 22-23")
    errs7["gram_pair"] = max(errs7["gram_pair"], held["err"])
    rank_kernels = general_phase(torch, dev, label)
    # ---- the examples' gram_pair runs: the count starts at 0 here ----
    F.gram_pair.launches = 0
    with held_gram_pair(torch) as held:
        lobpcg_example = examples_phase(torch, dev, label)
    example_launches = F.gram_pair.launches
    # ---- end of the examples' gram_pair runs ----
    check_held(held, example_launches, "in the examples (phase 25)")
    errs7["gram_pair"] = max(errs7["gram_pair"], held["err"])
    example_as_a_user_phase(label, lobpcg_example)
    ceiling_summary(ceiling, {"stpcg_flat_streamed": streamed_gbs,
                              "stpcg_flat_streamed[prec]": prec_gbs,
                              **rates, **graph_rates}, label)

    launches = {"gram_pair": gram_launches + pose_launches + last_launches
                + example_launches,
                "stream3_probe": stream3_launches}
    new_kernels = [{
        "name": name, "route": "cuda",
        "source": f"optimization_tpu_torch/csrc/{SOURCE_OF[name]}",
        "replaces": f"optimization_tpu/kernels/fused.py:{FUSED_REPLACES[name]}",
        "launches": launches[name], "max_abs_err": errs7[name],
        **times7[name]}
        for name in ("gram_pair", "stream3_probe")]
    segment_kernel = {
        "name": "segment_sum", "route": "cuda",
        "source": "optimization_tpu_torch/csrc/segment_sum.cu",
        "replaces": "optimization_tpu/models/graph.py:84",
        "launches": segment_launches + range_launches, **segment_numbers}
    print(json.dumps({"kernels": [kernel] + fused_kernels + new_kernels
                      + [prec_kernel] + probe_kernels + [chunk_kernel]
                      + rank_kernels + [segment_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
