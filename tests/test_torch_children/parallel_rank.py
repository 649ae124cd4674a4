"""One rank of tests/test_torch_parallel.py's multi-rank run (gloo, CPU).

    python tests/test_torch_children/parallel_rank.py <dir> <rank> <world>

Rendezvous through a FileStore in <dir>; reads <dir>/inputs.npz (made by
the parent from the JAX package's inputs) and runs every case of the
port's ``parallel`` package on a mesh of <world> CPU ranks.  Rank 0 writes
<dir>/results.npz; any failure exits non-zero.  Imports torch and the
port only.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from optimization_tpu_torch import RiemannianProblem  # noqa: E402
from optimization_tpu_torch.linalg.lobpcg import (lobpcg,  # noqa: E402
                                                  lobpcg_fleet)
from optimization_tpu_torch.manifolds import sphere  # noqa: E402
from optimization_tpu_torch.parallel import (batch_mesh,  # noqa: E402
                                             collectives, consensus,
                                             initialize_distributed,
                                             model_mesh)
from optimization_tpu_torch.parallel.mesh import shard, spec  # noqa: E402
from optimization_tpu_torch.parallel.sharding import (  # noqa: E402
    batch_sharded_solve, shard_batch, shard_model_vector)
from optimization_tpu_torch.solvers import admm, tnt  # noqa: E402
from optimization_tpu_torch.solvers.prox import soft_threshold  # noqa: E402

PARAMS = tnt.TNTParams(
    gradient_tolerance=1e-8, relative_decrease_tolerance=0.0,
    stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0)


def f_sphere(x, data):
    d = x - data
    return torch.sum(d * d)


def rows(a, rank, world):
    """This rank's contiguous block of rows."""
    k = a.shape[0] // world
    return a[rank * k:(rank + 1) * k]


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def main():
    out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    initialize_distributed(init_method=f"file://{out_dir}/store",
                           num_processes=world, process_id=rank,
                           device_type="cpu")
    inp = {k: torch.from_numpy(v) for k, v in
           np.load(os.path.join(out_dir, "inputs.npz")).items()}
    out = {}
    bmesh = batch_mesh(world, devices="cpu")
    mmesh = model_mesh(world, devices="cpu")

    # scenario (DP) sharded TNT: the batch looped per rank, all-gathered
    problem = RiemannianProblem(f=f_sphere, manifold=sphere())
    run = batch_sharded_solve(
        lambda x, p: tnt.solve(problem, x, PARAMS, data=p), bmesh)
    res = run(inp["scen_x0s"], inp["scen_Ps"])
    out["scen_x"], out["scen_status"] = res.x, res.status

    # block-partitioned TNT on DTensors, twice (the determinism leg), and
    # the unsharded solve
    d = inp["block_d"]
    block = RiemannianProblem(f=lambda x, dd: torch.dot(x, dd * x),
                              manifold=sphere())
    bparams = tnt.TNTParams(
        gradient_tolerance=1e-8, relative_decrease_tolerance=0.0,
        stepsize_tolerance=0.0, preconditioned_gradient_tolerance=0.0,
        max_iterations=500)
    x0_sh = shard_model_vector(inp["block_x0"], mmesh)
    d_sh = shard_model_vector(d, mmesh)
    for tag in ("1", "2"):
        r = tnt.solve(block, x0_sh, bparams, data=d_sh)
        out["block_x" + tag] = full(r.x)
        for name in ("f", "status", "num_iterations", "objective_values",
                     "gradient_norms", "inner_iterations"):
            out[f"block_{name}{tag}"] = getattr(r, name)
    r = tnt.solve(block, inp["block_x0"], bparams, data=d)
    out["block_x_plain"], out["block_f_plain"] = r.x, r.f

    # consensus ADMM LASSO over the batch axis
    A, b, mu = inp["cons_A"], inp["cons_b"], float(inp["cons_mu"])
    N, _, n = A.shape

    def local_argmin(z, lam_i, rho, data_i):
        Ai, bi = data_i
        H = Ai.T @ Ai + rho * torch.eye(n)
        return torch.linalg.solve(H, Ai.T @ bi - lam_i + rho * z)

    cproblem = consensus.consensus_problem(
        local_argmin,
        prox_g=lambda v, lam, dd: soft_threshold(v, mu * N * lam))
    cparams = admm.ADMMParams(
        max_iterations=1000, eps_rel=1e-5, eps_abs_pri=1e-4,
        eps_abs_dual=1e-4, rho=1.0,
        penalty_adaptation_mode=admm.ADMMPenaltyAdaptation.RESIDUAL_BALANCE,
        penalty_adaptation_period=2, penalty_adaptation_window=200)
    zeros = shard_batch(torch.zeros(N, n), bmesh)
    cres = admm.solve(cproblem, zeros, zeros, shard(torch.zeros(n), bmesh,
                                                    spec()),
                      cparams, data=shard_batch((A, b), bmesh))
    out["cons_y"], out["cons_status"] = full(cres.y), cres.status
    out["cons_iterations"] = cres.num_iterations

    # pdot / pmean_tree on local shards (shard_map's in_specs=P("model"))
    u, v = rows(inp["coll_u"], rank, world), rows(inp["coll_v"], rank, world)
    out["coll_pdot"] = collectives.pdot(u, v, mmesh)
    out["coll_pmean"] = collectives.pmean_tree(torch.mean(u), mmesh)

    # sharded_gram / sharded_gram_pair on row shards
    S, AS, BS = (rows(inp["gram_" + k], rank, world)
                 for k in ("S", "AS", "BS"))
    out["gram"] = collectives.sharded_gram(S, AS, mmesh)
    out["gram_a"], out["gram_b"] = collectives.sharded_gram_pair(
        S, AS, BS, mmesh)

    # ring_gram on column blocks; the output column blocks all-gathered
    c = inp["ring_S"].shape[1] // world
    cols = slice(rank * c, (rank + 1) * c)
    blk = collectives.ring_gram(inp["ring_S"][:, cols],
                                inp["ring_AS"][:, cols], mmesh)
    parts = [torch.empty_like(blk) for _ in range(world)]
    dist.all_gather(parts, blk)
    out["ring"] = torch.cat(parts, dim=1)

    # LOBPCG with the basis row-sharded over the model axis, and unsharded
    dl = inp["lob_d"]
    kw = dict(nev=4, max_iterations=150, tau=1e-8)
    gen = lambda: torch.Generator().manual_seed(7)
    d_loc = rows(dl, rank, world)
    res = lobpcg(lambda S_: d_loc[:, None] * S_,
                 T=lambda S_: S_ / d_loc[:, None],
                 X0=rows(inp["lob_X0"], rank, world), generator=gen(),
                 axis=mmesh, **kw)
    out["lob_theta"], out["lob_nc"] = res.theta, res.num_converged
    ref = lobpcg(lambda S_: dl[:, None] * S_, T=lambda S_: S_ / dl[:, None],
                 X0=inp["lob_X0"], generator=gen(), **kw)
    out["lob_theta_plain"], out["lob_nc_plain"] = ref.theta, ref.num_converged

    # DP LOBPCG fleet over the batch axis, and the unsharded fleet
    ds = inp["fleet_ds"]
    fkw = dict(T=lambda S_, dd: S_ / dd[:, None], m=ds.shape[1], nx=8,
               nev=3, max_iterations=60, tau=1e-8)
    op = lambda S_, dd: dd[:, None] * S_
    fres = lobpcg_fleet(op, rows(ds, rank, world),
                        generator=torch.Generator().manual_seed(3),
                        axis=bmesh, **fkw)
    fref = lobpcg_fleet(op, ds, generator=torch.Generator().manual_seed(3),
                        **fkw)
    for name in ("theta", "X", "num_converged", "num_iterations"):
        out[f"fleet_{name}"] = getattr(fres, name)
        out[f"fleet_{name}_plain"] = getattr(fref, name)

    # determinism leg: five repeats of pdot / pnorm on local shards
    vv, ww = (rows(inp["det_" + k], rank, world) for k in ("v", "w"))
    out["det_pdot"] = torch.stack([collectives.pdot(vv, ww, mmesh)
                                   for _ in range(5)])
    out["det_pnorm"] = torch.stack([collectives.pnorm(vv, mmesh)
                                    for _ in range(5)])

    if rank == 0:
        np.savez(os.path.join(out_dir, "results.npz"),
                 **{k: torch.as_tensor(t).detach().numpy()
                    for k, t in out.items()})
    dist.barrier()
    dist.destroy_process_group()
    print("OK", rank, flush=True)


if __name__ == "__main__":
    main()
