#!/usr/bin/env python3
"""The port's graph models on one NVIDIA GPU: does each path repeat bit for
bit, what adds in a varying order, and what each edge->vertex route costs;
this checkout alone or against other trees in turns.

Run from the repository root:

    python3 profile_graph_routes.py                    # this checkout
    python3 profile_graph_routes.py PARENT [OTHER ...] [--json FILE]

Each turn is a child process that imports ``optimization_tpu_torch`` from
its tree (a tree given, or this checkout); the measuring code is this
checkout's (``chip_smoke.py``'s phase-16, 17 and 20 instances).  A turn
prints:

1. the connection Laplacian (``rotation_sync.connection_laplacian_op``) on
   phase 16's graph (``chip_smoke.laplacian_graph``: 2^21 rotations, f32)
   for each ``scatter_method``: ms an apply (``chip_smoke.time_ms``) and
   whether two more applies equal the first bit for bit; then the
   segment-sum kernel alone (``kernels.segment_sum``, each tree's own
   plan) at that apply's sum (2 x E slots of 3 x 3 f32 words) beside
   ``chip_smoke.segment_sum_check``'s bound, and at every
   ``chip_smoke.SEGMENT_CASES`` shape in f32 and f64: ms a call and a
   digest of the result (both trees add each run in the plan's order, so
   the digests must agree);
2. phase 17's rotation sync (``chip_smoke.rotation_graph``: config6's
   rotations): ``spectral_init`` three times (LOBPCG iterations, wall, a
   digest of R0), then each TNT route twice from the first R0 (status,
   outer / CG, wall, a digest of the solution);
3. phase 20's solve (config6's 10^4 poses written by ``save_g2o``) through
   ``cli.main([... "--marginalized", "--certify", "--json", "--out",
   npz])`` three times: the wall, the summary's ``solve_s``, the TNT
   stage's wall and outer / CG (``chip_smoke.pose_stages``), a digest of
   the solution file's R and t;
4. phase 22's range sync (``chip_smoke.RANGE_A``, with ranges) once: the
   wall, the TNT stage's wall, outer / CG and ms a CG iteration, a digest
   of R, t and u;
5. the finder: every path of :func:`model_paths` once under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the mode
   is global to the process, so this is the turn's last step), with each
   warning it raises, and under :func:`census`, the operations it
   dispatched that add on the card in a varying order.

With PARENT the turns are PARENT, this, this, PARENT; with more trees,
each in turn before this checkout's two and again after, in reverse
(PARENT, OTHER, this, this, OTHER, PARENT).  With ``--json
FILE`` every number goes to FILE.  Every line is labelled with the card's
name and power limit.  Exits non-zero without a CUDA device.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# operations that add (or write duplicate indices) in an order that varies
# from run to run on a CUDA tensor (torch.use_deterministic_algorithms'
# lists); cumsum only in floating point
VARYING = frozenset({
    "aten.index_add", "aten.index_add_", "aten.scatter_add",
    "aten.scatter_add_", "aten.scatter_reduce", "aten.scatter_reduce_",
    "aten.index_reduce", "aten.index_reduce_", "aten.bincount",
    "aten.histc", "aten.put", "aten.put_", "aten.index_copy",
    "aten.index_copy_", "aten.scatter", "aten.scatter_",
    "aten.embedding_dense_backward", "aten._embedding_bag_dense_backward",
    "aten.cumsum", "aten.cumsum_"})


PATH_NAMES = (
    *(f"edge_accumulator {m}" for m in ("scatter", "gather", "sort")),
    *(f"{op} {m}" for m in ("scatter", "gather", "sort", "adjacency")
      for op in ("laplacian_apply", "connection_laplacian_op")),
    "vertex degree", "chordal gradient, hvp, precon", "spectral_init",
    "TNT plain", "TNT preconditioned", "TNT flat", "certify",
    "lifted problem hvp", "solve_robust", "inner Laplacian solve cg",
    "inner Laplacian solve flat", "recover_translations",
    "marginalized gradient, hvp cg", "marginalized gradient, hvp flat",
    "gnc_identifiability", "solve_pose_graph marginalized, certify",
    "solve_robust_se", "range sync gradient, hvp",
    "matrix completion gradient, hvp")


@contextlib.contextmanager
def census(torch):
    """Record, in the returned set, each dispatched operation of
    :data:`VARYING` (cumsum in floating point only) and each
    ``index_put`` whose integer indices repeat, as ``"op dtype"``: without
    ``accumulate`` it writes in a varying order on the card, and with it
    (the pullback of a gather ``x[idx]``) it adds with atomics on the CPU
    in f32 across threads and sorts the indices again at every call on the
    card.  Sees what ``torch.func``'s gradients and jvps run too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    found = set()

    def tensor_dtype(args):
        return next((a.dtype for a in args if isinstance(a, torch.Tensor)),
                    None)

    class Census(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func.overloadpacket)
            dtype = tensor_dtype(args)
            if name in VARYING and (not name.startswith("aten.cumsum")
                                    or dtype.is_floating_point):
                found.add(f"{name} {dtype}")
            elif name in ("aten.index_put", "aten.index_put_",
                          "aten._index_put_impl_"):
                acc = (args[3] if len(args) > 3
                       else kwargs.get("accumulate", False))
                repeats = any(
                    i is not None and not i.dtype.is_floating_point
                    and i.dtype != torch.bool
                    and torch.unique(i).numel() < i.numel()
                    for i in args[1])
                if repeats:
                    found.add(f"{name} {'with' if acc else 'without'} "
                              f"accumulate, repeated indices {dtype}")
            return func(*args, **kwargs)

    with Census():
        yield found


def model_paths(torch, dev, dtype):
    """{name: fn() -> tuple of tensors}: every path of the graph models at
    a small size, on ``dev`` in ``dtype``: each accumulator route with its
    gradient and the jvp of the gradient, each Laplacian route, the
    degree, rotation sync (the cost's gradient and hvp, spectral init, the
    three TNT routes, the certificate, the lifted problem's hvp, GNC),
    pose sync (both inner engines, the translations, the marginalized
    problem's gradient and hvp, identifiability, the CLI's solve, robust
    SE(3)), range sync's gradient and hvp and matrix completion's."""
    import numpy as np

    import chip_smoke as cs
    from optimization_tpu_torch.models import graph as G
    from optimization_tpu_torch.models import matrix_completion as mc
    from optimization_tpu_torch.models import pose_sync as ps
    from optimization_tpu_torch.models import range_sync as rg
    from optimization_tpu_torch.models import rotation_sync as rs
    from optimization_tpu_torch.solvers import tnt

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    n, d = 40, 3
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, 6 * n)
    dst = rng.integers(0, n, 6 * n)
    dst[: 2 * n] = 0                          # a hub: "gather" -> "sort"
    src_t, dst_t = (torch.as_tensor(a, device=dev) for a in (src, dst))
    E = src.size
    a = torch.randn((E, 4), generator=gen(1), dtype=dtype, device=dev)
    u = torch.randn((E, 4), generator=gen(2), dtype=dtype, device=dev)
    tau = 0.5 + torch.rand(E, generator=gen(3), dtype=dtype, device=dev)
    z = torch.randn((n, 4), generator=gen(4), dtype=dtype, device=dev)
    _, data = rs.random_instance(gen(5), n, d, extra_edges=2 * n,
                                 noise=0.05, dtype=dtype)
    kappa = 0.5 + torch.rand(data.src.shape, generator=gen(21), dtype=dtype,
                             device=dev)
    params = tnt.TNTParams(max_iterations=20, gradient_tolerance=1e-6)
    short = tnt.TNTParams(max_iterations=4)
    R0 = rs.spectral_init(data, n, d, generator=gen(6))
    V = rs.ROTATIONS.proj(R0, torch.randn(R0.shape, generator=gen(7),
                                          dtype=dtype, device=dev))
    graph, _, _ = cs.pose_graph(torch, n, 2 * n, 0.01, 5.0, seed=8)
    Mij = torch.as_tensor(graph.Rij, dtype=dtype, device=dev)
    tij = torch.as_tensor(graph.tij, dtype=dtype, device=dev)
    psrc = torch.as_tensor(graph.src, device=dev)
    pdst = torch.as_tensor(graph.dst, device=dev)
    r = z[:, :3] - z[:, :3].mean(dim=0, keepdim=True)

    def accumulator(method):
        acc = G.edge_accumulator(src, dst, n, method=method, device=dev)
        loss = lambda x: torch.sum(acc(x, 2.0 * x) ** 3)  # noqa: E731
        g, hv = torch.func.jvp(torch.func.grad(loss), (a,), (u,))
        return acc(a, u), g, hv

    def lifted():
        Y = torch.cat([R0.mT, torch.zeros((n, 1, d), dtype=dtype,
                                          device=dev)], 1)
        Y = rs.STIEFEL.retract(Y, 0.1 * torch.randn(
            Y.shape, generator=gen(9), dtype=dtype, device=dev))
        W = rs.STIEFEL.proj(Y, torch.randn(Y.shape, generator=gen(10),
                                           dtype=dtype, device=dev))
        g, hvp = rs._lifted_problem(n, d).qm(Y, data)
        return g, hvp(W)

    def chordal(problem):
        g, hvp = problem.qm(R0, data)
        return g, hvp(V), problem.apply_precon(R0, V, data)

    def route(problem):
        res = tnt.solve(problem, R0, params, data=data)
        return res.x, res.status, res.num_iterations

    def marginalized(engine):
        prob, _, _ = ps.marginalized_problem(psrc, pdst, Mij, tij, n=n,
                                             inner_engine=engine)
        Qr = rs.ROTATIONS.rand(gen(11), n, d, d, dtype=dtype)
        g, hvp = prob.qm(Qr, None)
        return g, hvp(rs.ROTATIONS.proj(Qr, torch.randn(
            Qr.shape, generator=gen(12), dtype=dtype, device=dev)))

    def range_qm():
        _, _, rdata = rg.random_instance(gen(13), 30, extra_edges=30,
                                         n_ranges=30, noise=0.01,
                                         dtype=dtype, device=dev)
        x0 = rg.initial_guess(rdata, 30, generator=gen(14), dtype=dtype)
        g, hvp = rg.make_problem(rdata).qm(x0)
        return (*g, *hvp(g))

    def completion_qm():
        _, cdata = mc.random_instance(gen(15), 30, 20, 2, frac=0.5,
                                      dtype=dtype, device=dev)
        U = mc.spectral_init(cdata, 2)
        g, hvp = mc.make_problem().qm(U, cdata)
        return g, hvp(g)

    def solve_pose(**kw):
        res = ps.solve_pose_graph(graph, dtype=dtype, device=dev,
                                  params=short, generator=gen(16), **kw)
        cert = (res.certificate.lam_min,) if res.certificate else ()
        return (res.R, res.t, *cert)

    paths = {f"edge_accumulator {m}": (lambda m=m: accumulator(m))
             for m in ("scatter", "gather", "sort")}
    for m in ("scatter", "gather", "sort", "adjacency"):
        paths[f"laplacian_apply {m}"] = (
            lambda m=m: (G.laplacian_apply(src_t, dst_t, tau, n,
                                           method=m)(z),))
        paths[f"connection_laplacian_op {m}"] = (
            lambda m=m: (rs.connection_laplacian_op(data, n, d,
                                                    scatter_method=m)(
                R0.reshape(n * d, d)),))
    paths.update({
        "vertex degree": lambda: (
            rs._degree(data, n, kappa),
            rs._degree(data._replace(src=src_t, dst=dst_t), n, tau)),
        "chordal gradient, hvp, precon": lambda: chordal(
            rs.make_problem(preconditioned=True)),
        "spectral_init": lambda: (rs.spectral_init(data, n, d,
                                                   generator=gen(6)),),
        **{f"TNT {name}": (lambda p=p: route(p))
           for name, p in cs.rotation_routes(rs)},
        "certify": lambda: tuple(rs.certify(R0, data, precondition=True,
                                            generator=gen(17)))[:5],
        "lifted problem hvp": lifted,
        "solve_robust": lambda: tuple(rs.solve_robust(
            data, n, d, params=short, gnc_steps=2, generator=gen(18)))[:2],
        **{f"inner Laplacian solve {e}": (
            lambda e=e: (ps._weighted_laplacian_solver(
                src_t, dst_t, tau, n, engine=e)(r),)) for e in ("cg", "flat")},
        "recover_translations": lambda: ps.recover_translations(
            rs.ROTATIONS.rand(gen(19), n, d, d, dtype=dtype), psrc, pdst, tij),
        **{f"marginalized gradient, hvp {e}": (lambda e=e: marginalized(e))
           for e in ("cg", "flat")},
        "gnc_identifiability": lambda: ps.gnc_identifiability(
            tau, src_t, dst_t, n),
        "solve_pose_graph marginalized, certify": lambda: solve_pose(
            marginalized=True, certify=True),
        "solve_robust_se": lambda: tuple(ps.solve_robust_se(
            psrc, pdst, Mij, tij, n, params=short, gnc_steps=2,
            generator=gen(20)))[:4],
        "range sync gradient, hvp": range_qm,
        "matrix completion gradient, hvp": completion_qm,
    })
    if len(paths) != len(PATH_NAMES):
        raise AssertionError("model_paths: PATH_NAMES lists other paths")
    return {name: paths[name] for name in PATH_NAMES}


def finder(torch, dev, dtype):
    """Every path of :func:`model_paths` once under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` and
    :func:`census`: {path: sorted distinct determinism warnings and varying
    operations}.  Leaves the mode off."""
    import warnings

    paths = model_paths(torch, dev, dtype)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, fn in paths.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with census(torch) as ops:
                    fn()
            said = {str(w.message).splitlines()[0] for w in caught
                    if "determinis" in str(w.message)}
            out[name] = sorted(said | ops)
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def chip_smoke_module():
    """This checkout's ``chip_smoke.py``, whatever tree is first on the
    path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def segment_times(torch, dev, cs, data, label):
    """Step 1's segment-sum times: {shape: {"ms", "digest"}} at phase 16's
    apply (with "bound_ms", ``chip_smoke.segment_bytes`` of the tree's own
    plan, and "bound_wide_ms", of 8-byte ids) and at every
    ``SEGMENT_CASES`` shape in f32 and f64, each on the tree's own plan."""
    import importlib

    SS = importlib.import_module("optimization_tpu_torch.kernels.segment_sum")
    gen = torch.Generator(device=dev).manual_seed(12)
    times = {}

    def timed(tag, index, parts, n):
        plan = SS.segment_plan(index, n)
        ms = cs.time_ms(torch, lambda: SS.segment_sum(plan, parts), 20)
        times[tag] = {"ms": ms, "digest": cs.tensor_digest(
            SS.segment_sum(plan, parts))}
        return times[tag]

    n, E = cs.GRAPH_N_ROT, int(data.src.numel())
    parts = [torch.randn((E, 3, 3), generator=gen, device=dev)
             for _ in range(2)]
    entry = timed("phase 16's apply", [data.src, data.dst], parts, n)
    S, plan = 2 * E, SS.segment_plan([data.src, data.dst], n)
    entry["bound_ms"], _ = cs.bound(cs.segment_bytes(plan, 9, 4), S * 9)
    entry["bound_wide_ms"], _ = cs.bound(cs.segment_bytes(plan, 9, 4, ids=8),
                                         S * 9)
    print(f"  segment_sum at phase 16's apply: {entry['ms']:.4f} ms, "
          f"{entry['bound_ms'] / entry['ms']:.3f} of its bound "
          f"{entry['bound_ms']:.4f} ms ({plan.order.element_size()}-byte "
          f"ids; {entry['bound_wide_ms'] / entry['ms']:.3f} of the 8-byte "
          f"ids' {entry['bound_wide_ms']:.4f}) [{label}]", flush=True)
    del parts
    for dtype in (torch.float32, torch.float64):
        for n, E, trailing, n_parts, hub in cs.SEGMENT_CASES:
            index = [torch.randint(0, n, (E,), generator=gen, device=dev)
                     for _ in range(n_parts)]
            if hub:
                index[-1][: E // 2] = 0
            parts = [torch.randn((E,) + trailing, generator=gen,
                                 dtype=dtype, device=dev)
                     for _ in range(n_parts)]
            tag = (f"n {n} E {E} {trailing} {n_parts} parts"
                   f"{' hub' if hub else ''} {str(dtype)[6:]}")
            ms = timed(tag, index, parts, n)["ms"]
            print(f"  segment_sum {tag}: {ms:.4f} ms [{label}]", flush=True)
    return times


def tnt_stage(cs, log):
    """The TNT stages of a ``chip_smoke.pose_stages`` log: their wall and
    their outer / CG counts."""
    runs = [(secs, cs.counts(res)) for stage, secs, res in log["stages"]
            if stage == "TNT"]
    return {"tnt_s": sum(s for s, _ in runs),
            "outer": sum(o for _, (o, _) in runs),
            "cg": sum(c for _, (_, c) in runs)}


def range_turn(torch, dev, cs):
    """Step 4: one ``solve_range_aided`` of phase 22's instance (a), after
    a one-iteration warm-up."""
    import dataclasses

    from optimization_tpu_torch.models import range_sync as rg

    gen = torch.Generator(device=dev).manual_seed(22)
    _, _, data = rg.random_instance(gen, cs.RANGE_N, 3, **cs.RANGE_A)
    rg.solve_range_aided(data, cs.RANGE_N, params=dataclasses.replace(
        rg.tnt.TNTParams(), max_iterations=1),
        generator=torch.Generator(device=dev))
    with cs.pose_stages(torch) as log:
        res, secs = cs.timed_solve(torch, dev, lambda: rg.solve_range_aided(
            data, cs.RANGE_N,
            generator=torch.Generator(device=dev).manual_seed(1)))
    stage = tnt_stage(cs, log)
    return {"s": secs, **stage,
            "ms_per_cg": 1e3 * stage["tnt_s"] / max(stage["cg"], 1),
            "digest": cs.tensor_digest(res.R, res.t, res.u)}


def turn(tree):
    """One turn on ``tree``'s package: steps 1-5 of the module docstring;
    returns every number."""
    sys.path.insert(0, tree)
    cs = chip_smoke_module()
    import torch

    import optimization_tpu_torch
    from optimization_tpu_torch import cli
    from optimization_tpu_torch.io import g2o
    from optimization_tpu_torch.models import rotation_sync as rs
    from optimization_tpu_torch.solvers import tnt

    if not torch.cuda.is_available():
        raise SystemExit("profile_graph_routes: no CUDA device")
    assert optimization_tpu_torch.__file__.startswith(tree)
    _, label = cs.card_label(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"tree": tree, "label": label}
    print(f"turn on {tree} [{label}]", flush=True)

    data, V, _ = cs.laplacian_graph(torch, dev)
    n = cs.GRAPH_N_ROT
    out["arms"] = {}
    for method in cs.LAPLACIAN_METHODS:
        L = rs.connection_laplacian_op(data, n, 3, scatter_method=method)
        first = L(V)
        ms = cs.time_ms(torch, lambda: L(V), 5)
        same = all(torch.equal(L(V), first) for _ in range(2))
        out["arms"][method] = {"ms": ms, "repeats": same}
        print(f"  connection Laplacian {method} at n = {n}: {ms:.3f} ms an "
              f"apply; two more applies bit for bit the first: {same} "
              f"[{label}]", flush=True)
        del L, first
    out["segment_sum"] = segment_times(torch, dev, cs, data, label)
    del data, V

    R_true, data = cs.rotation_graph(torch, dev)
    n = cs.ROTSYNC["n"]
    params = tnt.TNTParams(**cs.ROTSYNC_PARAMS)
    routes = cs.rotation_routes(rs)
    rs.spectral_init(data, n, 3, max_iterations=2)                # warm-up
    for _, prob in routes:
        tnt.solve(prob, R_true, tnt.TNTParams(max_iterations=1), data=data)
    init = lambda: rs.spectral_init(  # noqa: E731
        data, n, 3, generator=torch.Generator(device=dev).manual_seed(7))
    with cs.lobpcg_log() as log:
        inits = [cs.timed_solve(torch, dev, init) for _ in range(3)]
    out["spectral_init"] = [
        {"iterations": it, "s": secs, "digest": cs.tensor_digest(R)}
        for (it, _), (R, secs) in zip(log, inits)]
    print(f"  spectral_init, three runs: {out['spectral_init']} [{label}]",
          flush=True)
    R0 = inits[0][0]
    out["tnt"] = {}
    for name, prob in routes:
        runs = []
        for _ in range(2):
            res, secs = cs.timed_solve(
                torch, dev, lambda: tnt.solve(prob, R0, params, data=data))
            outer, cg = cs.counts(res)
            runs.append({"status": int(res.status), "outer": outer,
                         "cg": cg, "s": secs,
                         "digest": cs.tensor_digest(res.x)})
        out["tnt"][name] = runs
        print(f"  TNT {name}, two runs: {runs} [{label}]", flush=True)

    graph, _, _ = cs.pose_graph(torch, cs.POSE["n"], cs.POSE["extra"],
                                cs.POSE["noise"], cs.POSE["t_scale"], seed=0)
    out["cli"] = []
    with tempfile.TemporaryDirectory(prefix="pose_") as tmp:
        path = os.path.join(tmp, "config6.g2o")
        npz = os.path.join(tmp, "sol.npz")
        g2o.save_g2o(path, graph)
        import numpy as np

        for _ in range(3):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), \
                    cs.pose_stages(torch) as log:
                rc = cli.main(["solve", path, "--marginalized", "--certify",
                               "--json", "--out", npz])
            secs = time.perf_counter() - t0
            summary = json.loads(buf.getvalue().strip().splitlines()[-1])
            with np.load(npz) as f:
                dig = cs.tensor_digest(torch.from_numpy(f["R"]),
                                       torch.from_numpy(f["t"]))
            out["cli"].append({"rc": rc, "s": secs,
                               "solve_s": summary["solve_s"],
                               "certified": summary["certified"],
                               **tnt_stage(cs, log), "digest": dig})
    print(f"  CLI solve --marginalized --certify, three runs: {out['cli']} "
          f"[{label}]", flush=True)

    out["range_sync"] = range_turn(torch, dev, cs)
    print(f"  range sync {cs.RANGE_A}, n = {cs.RANGE_N}: "
          f"{out['range_sync']} [{label}]", flush=True)

    out["finder"] = finder(torch, dev, torch.float32)
    for name, said in out["finder"].items():
        print(f"  finder, {name}: {said or 'nothing'}", flush=True)
    return out


def main():
    if sys.argv[1:2] == ["--turn"]:
        out = turn(sys.argv[2])
        with open(sys.argv[3], "w") as f:
            json.dump(out, f)
        return
    args = sys.argv[1:]
    json_path = None
    if "--json" in args:
        i = args.index("--json")
        json_path = args[i + 1]
        del args[i:i + 2]
    others = [os.path.abspath(a) for a in args]
    trees = others + [ROOT, ROOT] + others[::-1] if others else [ROOT]
    turns = []
    with tempfile.TemporaryDirectory(prefix="graph_routes_") as tmp:
        for k, tree in enumerate(trees):
            path = os.path.join(tmp, f"turn{k}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--turn", tree, path], check=True, cwd=ROOT)
            with open(path) as f:
                turns.append(json.load(f))
    for t in turns:
        arms = ", ".join(
            f"{m} {v['ms']:.3f} ms "
            f"({'repeats' if v['repeats'] else 'VARIES'})"
            for m, v in t["arms"].items())
        inits = sorted({(i["iterations"], i["digest"])
                        for i in t["spectral_init"]})
        apply = t["segment_sum"]["phase 16's apply"]
        tnt = ", ".join(
            f"{name} {[(r['outer'], r['cg'], round(r['s'], 3)) for r in rs]}"
            for name, rs in t["tnt"].items())
        rng = t["range_sync"]
        print(f"{t['tree']}: {arms}; segment_sum at the apply "
              f"{apply['ms']:.4f} ms ({apply['bound_ms'] / apply['ms']:.3f} "
              f"of its bound, {apply['bound_wide_ms'] / apply['ms']:.3f} of "
              f"8-byte ids'); spectral_init (iterations, digest) {inits}; "
              f"TNT (outer, CG, s) {tnt}; CLI walls "
              f"{[round(c['s'], 3) for c in t['cli']]} s, TNT "
              f"{[round(c['tnt_s'], 3) for c in t['cli']]} s; range sync "
              f"{rng['s']:.3f} s, TNT {rng['tnt_s']:.3f} s, {rng['outer']} "
              f"outer / {rng['cg']} CG, {rng['ms_per_cg']:.2f} ms a CG "
              f"[{t['label']}]", flush=True)
    if len(turns) > 1:
        for tag in turns[0]["segment_sum"]:
            ms = [t["segment_sum"][tag]["ms"] for t in turns]
            same = len({t["segment_sum"][tag]["digest"] for t in turns}) == 1
            print(f"segment_sum {tag}: ms by turn "
                  f"{[round(m, 4) for m in ms]}; digests "
                  f"{'agree' if same else 'DIFFER'}", flush=True)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(turns, f, indent=1)


if __name__ == "__main__":
    main()
