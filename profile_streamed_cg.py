"""The streamed CG kernel's subproblem times on one CUDA card, for one or
more checkouts of the port.

For each package root given (default: this checkout), in a process of its
own, in the order given: the headline's 50-CG f32 subproblem (the one
``chip_smoke.py`` phase 4 times, at outer iteration 11 of the f32 tier,
n = 2^24; three timings by CUDA events) and the f32 tier's wall; a
positive-definite sphere subproblem at a fixed 50 CG (no truncation) in
f32 and bf16; and, where the package takes them, K = 1, 3, 4 subproblems
of 50 CG on a kappa ~ 1000 operator (``chip_smoke.gen_term`` forms), also
with each form of P and in bf16; where the package has the any-rank
kernel (``csrc/streamed_cg_any.cu``), each ``chip_smoke.GEN_TIMED`` case
(K >= 5, 50 CG on ``chip_smoke.gen_weights``' mix), the rank-8 path's own
subproblem at its 11th outer iteration (49 CG) and the rank-8 TNT (CG
it/s, with ``chip_smoke.quartic_tnt``'s gates).  Compare two versions in
one call, in turns, e.g. a parent unpacked with ``git archive`` into a
git-ignored directory:

    python3 profile_streamed_cg.py _scratch/parent . . _scratch/parent

Each run saves the SHA-256 of every subproblem's result (s, M-norm,
iterations, predicted decrease; dtype, shape and bytes) and of the f32
tier's final x and f in a temporary directory; after the last root, each
root's results are held bit for bit against the first root's, on the
cases both ran.  K >= 5 results may differ in the last bits between two
designs of the any-rank kernel: they are listed as "differ (K >= 5)";
any other difference is a failure (exit 1).  Each line carries the card's
name and power limit.  Words among the arguments:

- ``verbose``: print the kernel builds' ``-Xptxas -v`` reports
  (registers, shared memory, spills);
- ``trace``: for each root, build a copy of its ``csrc/streamed_cg_any.cu``
  with the ``kTrace`` switch on (the earlier design, which lacks it, with
  ``EARLIER_TRACE``'s trace points put in) and print, for GEN_TIMED's
  K = 8 and 32 f32 and K = 8 bf16, block 0's mean ns a CG iteration in
  each step (the K-sized algebra, the pass and its parts, the block sums,
  ``grid_sum``'s two barriers) and the init pass's steps;
- a name of ``VARIANTS`` (e.g. ``no_prefill``): the same traced cases,
  timed and traced, on a copy of this checkout's kernel with that edit.
"""
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# the trace's steps (csrc/streamed_cg_any.cu, kTrace): events 0-6 are the
# device clock at the half's start, after the K-sized algebra, after the
# pass, after the block sums, after grid_sum's first barrier, after its
# totals and after its second barrier; 7-10 the SM cycles thread 0 spent in
# the pass's parts, 11 in the whole pass (its parts are shown as shares of
# the pass's ns); where the source records them (the ring design), 12 the
# producer's first stages issued and 13 the algebra's first barrier passed
TRACE_EVENTS = {"old": 12, "ring": 14}
PASS_PARTS = {
    # the earlier design: each group of W elements in turn
    "old": ("loads, p2, s and p stores", "q2 terms", "r2 and r store",
            "dot terms"),
    # the TMA ring: each staged tile of 1,024 elements in turn
    "ring": ("waiting for the stage", "q2 terms, s and p stores",
             "r2, the scalar dots and r's store", "stored weights' dots"),
}
TRACED = ((8, "f32"), (32, "f32"), (8, "bf16"))
# The earlier design's trace points (csrc/streamed_cg_any.cu before the
# ring: it has no kTrace switch), put into its source by ``trace_lib`` so
# that a parent checkout can be traced as the ring design is: the same
# events 0-6 and the pass's parts as SM cycles.
EARLIER_TRACE = (
    ("constexpr int kVecs = 12;         // the K-vectors of a block (Vecs below)\n",
     "constexpr int kVecs = 12;         // the K-vectors of a block (Vecs below)\n"
     "constexpr bool kTrace = false;\n"
     "constexpr int kTraceIters = 64, kTraceEvents = 12;\n"
     "__device__ long long g_trace[kTraceIters * kTraceEvents];\n"
     "__device__ __forceinline__ bool tracing(int it) {\n"
     "  return kTrace && blockIdx.x == 0 && threadIdx.x == 0 && it < kTraceIters;\n"
     "}\n"
     "__device__ __forceinline__ void trace(int it, int ev) {\n"
     "  if (tracing(it)) {\n"
     "    long long t;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "    g_trace[it * kTraceEvents + ev] = t;\n"
     "  }\n"
     "}\n"
     "__device__ __forceinline__ void trace_add(int it, int ev, long long v) {\n"
     "  if (tracing(it)) g_trace[it * kTraceEvents + ev] += v;\n"
     "}\n"),
    ("                         double* tot, long long N, float* uu, int K) {\n"
     "  grid.sync();",
     "                         double* tot, long long N, float* uu, int K,\n"
     "                         int tr = kTraceIters) {\n"
     "  grid.sync();\n"
     "  trace(tr, 4);"),
    ("    }\n  }\n  grid.sync();\n}",
     "    }\n  }\n  trace(tr, 5);\n  grid.sync();\n  trace(tr, 6);\n}"),
    ("struct Carry {\n  int k;", "struct Carry {\n  int k;\n  int it;"),
    ("  const bool first = c.rv_prev == 0.f;\n",
     "  const int tr = c.it++;\n  trace(tr, 0);\n"
     "  const bool first = c.rv_prev == 0.f;\n"),
    ("  __syncthreads();\n\n  const float wr = c.ar + S.dots[0];",
     "  __syncthreads();\n  trace(tr, 1);\n\n"
     "  const float wr = c.ar + S.dots[0];"),
    ("  for (long long gi = t0; gi < ngroups; gi += stride) {\n"
     "    const long long i = gi * W;\n"
     "    float rc[W], pc[W], xc[W], a0[W], pv[W];",
     "  long long ck0 = kTrace ? clock64() : 0;\n"
     "  for (long long gi = t0; gi < ngroups; gi += stride) {\n"
     "    const long long ck_a = kTrace ? clock64() : 0;\n"
     "    const long long i = gi * W;\n"
     "    float rc[W], pc[W], xc[W], a0[W], pv[W];"),
    ("      Store<T>::store(p, i, P.n, p2);\n    }\n"
     "    for (int j = 0; j < K; ++j) {",
     "      Store<T>::store(p, i, P.n, p2);\n    }\n"
     "    const long long ck_b = kTrace ? clock64() : 0;\n"
     "    for (int j = 0; j < K; ++j) {"),
    ("    float a0r2[W];\n",
     "    const long long ck_c = kTrace ? clock64() : 0;\n    float a0r2[W];\n"),
    ("    Store<T>::store(r, i, P.n, rc);\n",
     "    Store<T>::store(r, i, P.n, rc);\n"
     "    const long long ck_d = kTrace ? clock64() : 0;\n"),
    ("      mine[(long long)j * kThreads] = t;\n    }\n  }\n",
     "      mine[(long long)j * kThreads] = t;\n    }\n"
     "    if (kTrace) {\n"
     "      const long long ck_e = clock64();\n"
     "      trace_add(tr, 7, ck_b - ck_a);\n"
     "      trace_add(tr, 8, ck_c - ck_b);\n"
     "      trace_add(tr, 9, ck_d - ck_c);\n"
     "      trace_add(tr, 10, ck_e - ck_d);\n"
     "    }\n  }\n"
     "  if (kTrace) trace_add(tr, 11, clock64() - ck0);\n"
     "  trace(tr, 2);\n"),
    ("    grid_sum(grid, S.part, S.tot, 4 + K, nullptr, K);",
     "    trace(tr, 3);\n"
     "    grid_sum(grid, S.part, S.tot, 4 + K, nullptr, K, tr);"),
    ("  c.k = 0;\n  c.rv = rv0;", "  c.k = 0;\n  c.it = 0;\n  c.rv = rv0;"),
    ("const char* streamed_cg_any_error_string(int code) {",
     "int streamed_cg_any_trace(long long* out, int n, int clear) {\n"
     "  if (clear) {\n"
     "    static const long long zeros[kTraceIters * kTraceEvents] = {};\n"
     "    return (int)cudaMemcpyToSymbol(g_trace, zeros, sizeof(zeros));\n"
     "  }\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_trace, n * sizeof(long long));\n"
     "}\n\n"
     "const char* streamed_cg_any_error_string(int code) {"),
)
# design variants of csrc/streamed_cg_any.cu (edits of its source)
VARIANTS = {
    # the producer starts a pass's stages at the pass, not before the
    # K-sized algebra
    "no_prefill": (("kPrefill = true;", "kPrefill = false;"),),
    # the init pass without its proxy fences (what they cost; a stage's
    # rewritten rows may then race the next bulk copies into it)
    "no_init_fence": (("      fence_proxy_async();\n      if (ch + 1 < L.chunks)",
                       "      if (ch + 1 < L.chunks)"),),
}


def build_all(names, verbose):
    """Build the package's sources at once (one nvcc each)."""
    from concurrent.futures import ThreadPoolExecutor

    from optimization_tpu_torch.csrc.build import build

    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(build, name, False) for name in names]:
            f.result()
    if verbose:
        for name in names:
            build(name, verbose=True)


def trace_lib(root, edits=()):
    """A copy of ROOT's streamed_cg_any.cu built with kTrace on and
    ``edits`` made (beside the source, so its headers resolve), loaded;
    the earlier design gets its trace points first (EARLIER_TRACE); None
    for a source that has neither."""
    from optimization_tpu_torch.csrc import build as B

    src = os.path.join(root, "optimization_tpu_torch", "csrc",
                       "streamed_cg_any.cu")
    text = open(src).read()
    if "kTrace = false;" not in text:
        if not all(text.count(old) == 1 for old, _ in EARLIER_TRACE):
            return None, None
        for old, new in EARLIER_TRACE:
            text = text.replace(old, new)
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"profile_streamed_cg: the source no longer "
                             f"holds {old!r}; update VARIANTS")
        text = text.replace(old, new)
    tmp = os.path.join(os.path.dirname(src), "_variant_trace.cu")
    out = os.path.join(tempfile.mkdtemp(), "libstreamed_cg_any_trace.so")
    with open(tmp, "w") as f:
        f.write(text.replace("kTrace = false;", "kTrace = true;"))
    try:
        proc = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", out, tmp],
                              capture_output=True, text=True)
    finally:
        os.remove(tmp)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the trace copy:\n{proc.stderr}")
    design = "ring" if "kRing" in text else "old"
    return ctypes.CDLL(out), design


def print_trace(torch, T, lib, design, run, label, out):
    """Run ``run`` once with the traced library and print block 0's mean
    ns a CG iteration in each step (iterations 1 .. 63: the first reads g
    and, without init=, follows the init pass)."""
    from optimization_tpu_torch.csrc import build as B

    lib.streamed_cg_any_trace.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
    load = B.load
    B.load = lambda name: lib if name == "streamed_cg_any" else load(name)
    try:
        torch.cuda.synchronize()
        lib.streamed_cg_any_trace(None, 0, 1)
        run()
        torch.cuda.synchronize()
        ev = TRACE_EVENTS[design]
        nrow = 65 if design == "ring" else 64
        buf = (ctypes.c_longlong * (nrow * ev))()
        if lib.streamed_cg_any_trace(buf, nrow * ev, 0):
            raise RuntimeError("streamed_cg_any_trace failed")
    finally:
        B.load = load
    rows = [list(buf[i * ev:(i + 1) * ev]) for i in range(1, 64)]
    rows = [r for r in rows if r[0] and r[6] and r[11]]
    if not rows:
        out.append(f"trace {label}: no complete iteration")
        return

    def mean(f):
        return sum(f(r) for r in rows) / len(rows)

    total = mean(lambda r: r[6] - r[0])
    steps = [("K-sized algebra", mean(lambda r: r[1] - r[0]))]
    if ev > 12:
        steps += [("  producer's first stages issued", mean(
                      lambda r: r[12] - r[0] if r[12] else 0)),
                  ("  algebra's first barrier passed", mean(
                      lambda r: r[13] - r[0]))]
    steps.append(("pass", mean(lambda r: r[2] - r[1])))
    for q, name in enumerate(PASS_PARTS[design]):
        steps.append((f"  {name}", mean(
            lambda r, q=q: (r[2] - r[1]) * r[7 + q] / r[11])))
    steps += [("block sums", mean(lambda r: r[3] - r[2])),
              ("first barrier", mean(lambda r: r[4] - r[3])),
              ("totals", mean(lambda r: r[5] - r[4])),
              ("second barrier", mean(lambda r: r[6] - r[5]))]
    ghz = mean(lambda r: r[11] / max(r[2] - r[1], 1))
    line = (f"trace {label} ({design} design, {len(rows)} iterations, "
            f"{total:.0f} ns an iteration, SM clock ~{ghz:.2f} GHz): "
            + ", ".join(
                f"{name.strip()} {t:.0f}" for name, t in steps))
    init = list(buf[64 * ev:65 * ev]) if nrow == 65 else []
    if init and init[0] and init[3]:
        cons = init[1] - init[0]
        parts = ", ".join(
            f"{name} {cons * init[4 + q] / max(init[8], 1):.0f}"
            for q, name in enumerate(("waiting for the stage", "rows",
                                      "pairs", "barriers")))
        line += (f"; init pass {init[3] - init[0]} ns (consumers {cons}: "
                 f"{parts}; grid sum {init[2] - init[1]}, expansion "
                 f"{init[3] - init[2]})")
    out.append(line)


def run_variant(torch, S, T, root, name, n, dev, fixed, diag, out):
    """GEN_TIMED's traced cases on the traced copy of ROOT's kernel with
    VARIANTS[name]: each timed and traced."""
    from optimization_tpu_torch.csrc import build as B

    lib, design = trace_lib(root, VARIANTS[name])
    if lib is None:
        return
    load = B.load
    for k, storage in TRACED:
        dt = torch.bfloat16 if storage == "bf16" else torch.float32
        gk, xk, Bk, auxk = S.gen_args(torch, k, n, dt, dev, seed=7)
        kws = dict(fixed, a0_chunk=diag,
                   weights=S.gen_weights(torch, k, n, dev))

        def run(gk=gk, xk=xk, Bk=Bk, auxk=auxk, kws=kws):
            return T.stpcg_flat_streamed(gk, xk, Bk, 1e6, auxk, **kws)

        B.load = lambda nm: lib if nm == "streamed_cg_any" else load(nm)
        try:
            res = run()
            t = S.time_ms(torch, run, 10)
        finally:
            B.load = load
        tag = f"{name} K={k} {storage}"
        out.append(f"{tag} {int(res.num_iterations)} CG {t:.4f} ms (traced "
                   f"build)")
        print_trace(torch, T, lib, design, run, tag, out)


def measure(root, verbose, trace, variants, out_dir, slot):
    """Time one package root (run in a process of its own); the digests of
    its results go to ``<out_dir>/<slot>.json``."""
    sys.path.insert(0, root)
    import torch

    sys.path.insert(1, HERE)
    import chip_smoke as S
    from optimization_tpu_torch import headline as H
    from optimization_tpu_torch.kernels import streamed_cg as T

    if not T.__file__.startswith(root):
        raise SystemExit(f"{T.__file__} is not under {root}")
    any_k = os.path.exists(os.path.join(root, "optimization_tpu_torch",
                                        "csrc", "streamed_cg_any.cu"))
    build_all(("streamed_cg", "streamed_cg_any") if any_k
              else ("streamed_cg",), verbose)
    dev = torch.device("cuda", 0)
    n = 1 << 24
    out = [os.path.relpath(root, HERE)]

    # the headline's subproblem at its 11th outer iteration, and the tier
    prob = H.make_problem(n, dev, "streamed")
    x0 = H.initial_point(n, torch.float32, dev, 3)
    mid = H.run_tier(prob, x0, H.tier_params(1e-5, max_iterations=10))
    x, _, g, _, aux = prob.step_eval(mid.result.x, torch.zeros_like(x0),
                                     None)
    diag = T.AffineDiagonal(1.0, 999.0 / (n - 1))
    a0c, w, B_fn = T.sphere_rayleigh_streamed(diag)
    kw = dict(a0_chunk=a0c, weights=w, max_iterations=50, kappa_fgr=0.1,
              theta=0.5, init=aux.init)
    args = (g, x, B_fn(aux.rq), mid.result.trust_region_radius[10],
            (aux.rq,))
    saved = {}

    def keep(tag, res):
        saved[tag] = [hashlib.sha256(
            f"{t.dtype} {tuple(t.shape)} ".encode()
            + t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
            .tobytes()).hexdigest() for t in res]

    keep("headline", T.stpcg_flat_streamed(*args, **kw))
    ms = [S.time_ms(torch, lambda: T.stpcg_flat_streamed(*args, **kw), 10)
          for _ in range(3)]
    tier = H.run_tier(prob, x0, H.tier_params(1e-5))
    keep("tier", (tier.result.x, torch.tensor(tier.fstar)))
    out.append(f"headline subproblem {', '.join(f'{t:.4f}' for t in ms)} "
               f"ms; f32 tier {tier.outer}/{tier.inner} in "
               f"{tier.seconds:.3f} s")

    # the sphere at a fixed 50 CG, f32 and bf16
    gen = torch.Generator(device=dev).manual_seed(7)
    xs = torch.randn(n, generator=gen, device=dev)
    xs = xs / xs.norm()
    gs = torch.randn(n, generator=gen, device=dev)
    gs = gs / gs.norm()
    B = torch.tensor([[1.0, 0.2], [0.2, 0.5]], device=dev)
    rq = torch.tensor(0.5, device=dev)
    fixed = dict(max_iterations=50, kappa_fgr=0.0, theta=0.5)
    for dt in (torch.float32, torch.bfloat16):
        args = (gs.to(dt), xs.to(dt), B, 1e6, (rq,))
        kws = dict(fixed, a0_chunk=a0c, weights=w)
        res = T.stpcg_flat_streamed(*args, **kws)
        keep(f"sphere {dt}", res)
        for form in ("jacobi", "quarter", "stored"):
            pc, pm = S.prec_of(torch, form, gs, rq, diag)
            keep(f"sphere {dt} P={form}", T.stpcg_flat_streamed(
                *args, **dict(kws, prec_chunk=pc, prec=pm)))
        t = S.time_ms(torch,
                      lambda: T.stpcg_flat_streamed(*args, **kws), 10)
        out.append(f"sphere {str(dt)[6:]} {int(res.num_iterations)} CG "
                   f"{t:.4f} ms")

    if hasattr(T, "ElementwiseFn"):
        for k, forms in ((1, ("one",)), (3, ("one", "twice", "stored")),
                         (4, ("one", "twice", "stored", "fn"))):
            gk, xk, Bk, auxk = S.gen_args(torch, k, n, torch.float32, dev,
                                          seed=7)
            kws = dict(fixed, a0_chunk=diag, weights=tuple(
                S.gen_term(torch, f, n, dev) for f in forms))
            res = T.stpcg_flat_streamed(gk, xk, Bk, 1e6, auxk, **kws)
            keep(f"K={k}", res)
            for form in S.GEN_PREC_FORMS:
                pc, pm = S.gen_prec(torch, form, diag, auxk, n, dev)
                keep(f"K={k} P={form}", T.stpcg_flat_streamed(
                    gk, xk, Bk, 1e6, auxk,
                    **dict(kws, prec_chunk=pc, prec=pm)))
            keep(f"K={k} bf16", T.stpcg_flat_streamed(
                gk.bfloat16(), xk.bfloat16(), Bk, 1.0, auxk, **kws))
            t = S.time_ms(torch, lambda: T.stpcg_flat_streamed(
                gk, xk, Bk, 1e6, auxk, **kws), 10)
            out.append(f"K={k} {int(res.num_iterations)} CG {t:.4f} ms")

    if any_k:
        lib, design = trace_lib(root) if trace else (None, None)
        for k, storage, pform in S.GEN_TIMED:
            dt = torch.bfloat16 if storage == "bf16" else torch.float32
            gk, xk, Bk, auxk = S.gen_args(torch, k, n, dt, dev, seed=7)
            kws = dict(fixed, a0_chunk=diag,
                       weights=S.gen_weights(torch, k, n, dev))
            if pform:
                pc, pm = S.gen_prec(torch, pform, diag, auxk, n, dev)
                kws.update(prec_chunk=pc, prec=pm)
            tag = f"K={k} {storage}{' P=' + pform if pform else ''}"

            def run(gk=gk, xk=xk, Bk=Bk, auxk=auxk, kws=kws):
                return T.stpcg_flat_streamed(gk, xk, Bk, 1e6, auxk, **kws)

            res = run()
            keep(tag, res)
            t = S.time_ms(torch, run, 10)
            out.append(f"{tag} {int(res.num_iterations)} CG {t:.4f} ms")
            if lib is not None and (k, storage) in TRACED and not pform:
                print_trace(torch, T, lib, design, run, tag, out)
        # the rank-8 path: its subproblem at the 11th outer iteration, then
        # its TNT against the eager flat engine
        prob = S.Rank8(torch, n, dev)
        streamed = prob.problem("streamed")
        x0 = H.initial_point(n, torch.float32, dev, 5)
        params = H.tier_params(S.R3_GRAD_TOL)
        mid = H.run_tier(streamed, x0,
                         H.tier_params(S.R3_GRAD_TOL, max_iterations=10))
        x8 = mid.result.x
        B8, lam, qs = prob.operator(x8)
        kw8 = dict(a0_chunk=prob.a0fn, weights=prob.weights,
                   max_iterations=50, kappa_fgr=params.kappa_fgr,
                   theta=params.theta)
        args8 = (streamed.rgrad(x8), x8, B8,
                 mid.result.trust_region_radius[10], (lam, *qs))
        res = T.stpcg_flat_streamed(*args8, **kw8)
        keep("K=8 rank-8 subproblem", res)
        t = S.time_ms(torch, lambda: T.stpcg_flat_streamed(*args8, **kw8),
                      10)
        out.append(f"K=8 rank-8 subproblem {int(res.num_iterations)} CG "
                   f"{t:.4f} ms")
        S.quartic_tnt(torch, dev, card(), prob, "rank-8", x0, params)
        for name in variants:
            run_variant(torch, S, T, root, name, n, dev, fixed, diag, out)
    with open(os.path.join(out_dir, f"{slot}.json"), "w") as f:
        json.dump(saved, f)
    print(" | ".join(out) + f" [{card()}]", flush=True)


def compare(roots, out_dir):
    """Each root's saved results against the first root's, bit for bit."""
    def load(slot):
        with open(os.path.join(out_dir, f"{slot}.json")) as f:
            return json.load(f)

    first = load(0)
    failed = False
    for slot, root in enumerate(roots[1:], 1):
        other = load(slot)
        tags = [t for t in first if t in other]
        differ = [t for t in tags if first[t] != other[t]]
        above = [t for t in differ if any_rank(t)]
        wrong = [t for t in differ if not any_rank(t)]
        failed = failed or bool(wrong)
        print(f"{os.path.relpath(root, HERE)} against "
              f"{os.path.relpath(roots[0], HERE)}: {len(tags)} results, "
              f"{len(tags) - len(differ)} bit for bit equal"
              + (f"; differ (K >= 5): {', '.join(above)}" if above else "")
              + (f"; DIFFER: {', '.join(wrong)}" if wrong else ""),
              flush=True)
    return failed


def any_rank(tag):
    """Whether a result came from the any-rank kernel (K >= 5)."""
    return tag.startswith("K=") and int(tag[2:].split()[0]) >= 5


def main():
    argv = sys.argv[1:]
    words = ("verbose", "trace", *VARIANTS)
    if argv[:1] == ["--one"]:
        measure(os.path.abspath(argv[1]), "verbose" in argv[4:],
                "trace" in argv[4:], [a for a in argv[4:] if a in VARIANTS],
                argv[2], int(argv[3]))
        return
    flags = [a for a in argv if a in words]
    roots = [os.path.abspath(a) for a in argv if a not in words] or [HERE]
    with tempfile.TemporaryDirectory() as out_dir:
        for slot, root in enumerate(roots):
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root,
                   out_dir, str(slot)] + flags
            subprocess.run(cmd, check=True)
        if compare(roots, out_dir):
            raise SystemExit(1)


if __name__ == "__main__":
    main()
