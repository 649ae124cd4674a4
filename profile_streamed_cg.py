"""The streamed CG kernel's subproblem times on one CUDA card, for one or
more checkouts of the port.

For each package root given (default: this checkout), in a process of its
own, in the order given: the headline's 50-CG f32 subproblem (the one
``chip_smoke.py`` phase 4 times, at outer iteration 11 of the f32 tier,
n = 2^24; three timings by CUDA events) and the f32 tier's wall; a
positive-definite sphere subproblem at a fixed 50 CG (no truncation) in
f32 and bf16; and, where the package takes them, K = 1, 3, 4 subproblems
of 50 CG on a kappa ~ 1000 operator (``chip_smoke.gen_term`` forms), also
with each form of P and in bf16.  Compare two versions in one call, in
turns, e.g. a parent unpacked with ``git archive`` into a git-ignored
directory:

    python3 profile_streamed_cg.py _scratch/parent . . _scratch/parent

Each run saves the SHA-256 of every subproblem's result (s, M-norm,
iterations, predicted decrease; dtype, shape and bytes) and of the f32
tier's final x and f in a temporary directory; after the last root, each
root's results are held bit for bit against the first root's, on the
cases both ran.  Each line carries the card's name and
power limit; ``verbose`` after the roots prints the kernel build's
``-Xptxas -v`` report.
"""
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


def measure(root, verbose, out_dir, slot):
    """Time one package root (run in a process of its own); the digests of
    its results go to ``<out_dir>/<slot>.json``."""
    sys.path.insert(0, root)
    import torch

    sys.path.insert(1, HERE)
    import chip_smoke as S
    from optimization_tpu_torch import headline as H
    from optimization_tpu_torch.csrc.build import build
    from optimization_tpu_torch.kernels import streamed_cg as T

    if not T.__file__.startswith(root):
        raise SystemExit(f"{T.__file__} is not under {root}")
    build("streamed_cg", verbose=verbose)
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
    with open(os.path.join(out_dir, f"{slot}.json"), "w") as f:
        json.dump(saved, f)
    print(" | ".join(out) + f" [{card()}]", flush=True)


def compare(roots, out_dir):
    """Each root's saved results against the first root's, bit for bit."""
    def load(slot):
        with open(os.path.join(out_dir, f"{slot}.json")) as f:
            return json.load(f)

    first = load(0)
    for slot, root in enumerate(roots[1:], 1):
        other = load(slot)
        tags = [t for t in first if t in other]
        differ = [t for t in tags if first[t] != other[t]]
        print(f"{os.path.relpath(root, HERE)} against "
              f"{os.path.relpath(roots[0], HERE)}: {len(tags)} results, "
              f"{len(tags) - len(differ)} bit for bit equal"
              + (f"; differ: {', '.join(differ)}" if differ else ""),
              flush=True)


def main():
    argv = sys.argv[1:]
    if argv[:1] == ["--one"]:
        measure(os.path.abspath(argv[1]), argv[4:] == ["verbose"], argv[2],
                int(argv[3]))
        return
    verbose = "verbose" in argv
    roots = [os.path.abspath(a) for a in argv if a != "verbose"] or [HERE]
    with tempfile.TemporaryDirectory() as out_dir:
        for slot, root in enumerate(roots):
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root,
                   out_dir, str(slot)] + (["verbose"] if verbose else [])
            subprocess.run(cmd, check=True)
        compare(roots, out_dir)


if __name__ == "__main__":
    main()
