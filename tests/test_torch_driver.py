"""The port's LOBPCG drivers and checkpoints == the JAX package's.

``optimization_tpu_torch/core/driver.py`` (``drive_lobpcg``,
``drive_lobpcg_fleet``) and ``core/checkpoint.py`` against
``optimization_tpu/core/``, on the diagonal problem of
``tests/test_lobpcg.py::TestRound2Robustness`` (m = 400, nx = 8, nev = 4,
the exact inverse preconditioner, f64) with X0 made by numpy:

- chunked == monolithic in the port, bitwise (as in JAX);
- the verbose lines and the final report equal JAX's character for
  character once the wall-clock fields are masked: this problem converges
  steeply, so the two packages take the same iterations and print the same
  residuals at 4 digits (they agree to ~1e-11 relative);
- a checkpoint the JAX driver wrote, and a JAX ``warm_start``, resume in
  the port to JAX's monolithic result: theta within 1e-10 relative and the
  iteration count within 1 (the port's own norm estimate decides the last
  iteration's convergence test; see tests/test_torch_lobpcg.py).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optimization_tpu.core import checkpoint as JC
from optimization_tpu.core import driver as JD
from optimization_tpu.linalg.lobpcg import lobpcg as j_lobpcg
from optimization_tpu_torch.core import checkpoint as TC
from optimization_tpu_torch.core.debug import pad_value
from optimization_tpu_torch.core import driver as TD
from optimization_tpu_torch.interop import lobpcg_warm_start_from_jax
from optimization_tpu_torch.linalg.lobpcg import lobpcg as t_lobpcg

torch.set_num_threads(1)

M, NX, NEV = 400, 8, 4
D = np.linspace(1.0, float(M), M)
X0 = np.random.default_rng(5).standard_normal((M, NX))


def _jax_ops():
    d = jnp.asarray(D)
    return (lambda S: d[:, None] * S), (lambda S: S / jnp.abs(d)[:, None])


def _torch_ops():
    d = torch.from_numpy(D)
    return (lambda S: d[:, None] * S), (lambda S: S / d.abs()[:, None])


def _assert_padded(trace):
    """Trace slots past the count hold the padding: NaN, or 0.0 under the
    OPTTPU_DEBUG_NANS sanitizer tier."""
    t = trace.numpy()
    np.testing.assert_array_equal(t, np.full_like(t, pad_value()))


def _mask_times(text):
    text = re.sub(r"time: \d+\.\d+", "time: T", text)
    return re.sub(r"elapsed: \d+\.\d+ s", "elapsed: T s", text)


@pytest.mark.parametrize("chunk", [1, 7])
def test_drive_lobpcg_matches_jax_and_monolithic(capsys, chunk):
    Aj, Tj = _jax_ops()
    At, Tt = _torch_ops()
    kw = dict(nev=NEV, max_iterations=100, tau=1e-8)
    jr, jt = JD.drive_lobpcg(Aj, T=Tj, X0=jnp.asarray(X0), verbose=True,
                             precision=4, chunk_iterations=chunk, **kw)
    jax_out = capsys.readouterr().out
    tr, tt = TD.drive_lobpcg(At, T=Tt, X0=torch.from_numpy(X0), verbose=True,
                             precision=4, chunk_iterations=chunk, **kw)
    port_out = capsys.readouterr().out
    mono = t_lobpcg(At, T=Tt, X0=torch.from_numpy(X0), **kw)

    k = int(tr.num_iterations)
    assert k == int(mono.num_iterations) == int(jr.num_iterations)
    assert torch.equal(tr.theta, mono.theta) and torch.equal(tr.X, mono.X)
    np.testing.assert_allclose(tr.theta.numpy(), np.asarray(jr.theta),
                               rtol=1e-10)
    assert _mask_times(port_out) == _mask_times(jax_out)
    assert port_out.count("Iter:") == k
    assert "LOBPCG terminated: 4/4 wanted eigenpairs converged" in port_out
    # stitched traces: f32 residuals / int32 counts as in the JAX driver
    assert tr.residual_trace.dtype == torch.float32
    assert tr.nc_trace.dtype == torch.int32
    np.testing.assert_allclose(tr.residual_trace[:k].numpy(),
                               np.asarray(jr.residual_trace)[:k], rtol=1e-6)
    np.testing.assert_array_equal(tr.nc_trace.numpy(),
                                  np.asarray(jr.nc_trace))
    _assert_padded(tr.residual_trace[k:])
    assert tt.shape == (100,) and np.isfinite(tt[:k].numpy()).all()
    assert (np.diff(tt[:k].numpy()) >= 0).all()


def test_drive_lobpcg_reports_limits_like_jax(capsys):
    Aj, Tj = _jax_ops()
    At, Tt = _torch_ops()
    kw = dict(nev=NEV, max_iterations=3, tau=1e-14, chunk_iterations=2,
              verbose=True)
    JD.drive_lobpcg(Aj, T=Tj, X0=jnp.asarray(X0), **kw)
    jax_out = capsys.readouterr().out
    res, _ = TD.drive_lobpcg(At, T=Tt, X0=torch.from_numpy(X0), **kw)
    port_out = capsys.readouterr().out
    assert "LOBPCG terminated: iteration limit reached" in port_out
    assert _mask_times(port_out) == _mask_times(jax_out)
    assert int(res.num_iterations) == 3
    # a wall-clock limit of 0 stops after the first chunk
    res, _ = TD.drive_lobpcg(At, T=Tt, X0=torch.from_numpy(X0), nev=NEV,
                             max_iterations=50, tau=1e-14, chunk_iterations=5,
                             max_computation_time=0.0, verbose=True)
    assert "computation-time limit reached" in capsys.readouterr().out
    assert int(res.num_iterations) == 5
    with pytest.raises(ValueError):
        TD.drive_lobpcg(At, m=M, nx=NX, nev=NEV, max_iterations=0)


def test_drive_lobpcg_observer_and_time_interpolation():
    At, Tt = _torch_ops()
    seen = []
    res, times = TD.drive_lobpcg(
        At, T=Tt, X0=torch.from_numpy(X0), nev=NEV, max_iterations=40,
        tau=1e-8, chunk_iterations=4, time_interpolation=True,
        observer=lambda k, r, t: seen.append((k, int(r.num_iterations))))
    assert [k for k, _ in seen] == [i for _, i in seen]
    assert seen[-1][0] == int(res.num_iterations)
    counts = [4] * 3 + [2]
    chunk_times = [0.5, 1.0, 2.0, 2.5]
    got = TD._fill_times(20, counts, chunk_times, True)
    want = JD._fill_times(20, counts, chunk_times, True)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_default_generator_chunks_draw_alike():
    """Without X0 each chunk draws the same default X0 and omega (a copy
    of the generator's state), so chunked == monolithic."""
    d = torch.from_numpy(D).to(torch.get_default_dtype())
    At, Tt = (lambda S: d[:, None] * S), (lambda S: S / d[:, None])
    gen = torch.Generator().manual_seed(11)
    kw = dict(m=M, nx=NX, nev=NEV, max_iterations=60, tau=1e-4)
    res, _ = TD.drive_lobpcg(At, T=Tt, generator=gen, chunk_iterations=3,
                             **kw)
    mono = t_lobpcg(At, T=Tt, generator=torch.Generator().manual_seed(11),
                    **kw)
    assert int(res.num_iterations) == int(mono.num_iterations)
    assert torch.equal(res.theta, mono.theta)
    assert res.X.dtype == torch.get_default_dtype()


def _fleet():
    fleet, m = 4, 500
    ds = (np.arange(1.0, fleet + 1.0)[:, None]
          * np.linspace(1.0, 50.0, m)[None, :])
    x0 = np.random.default_rng(2).standard_normal((fleet, m, 8))
    return ds, x0


def test_drive_lobpcg_fleet_matches_jax_and_monolithic(capsys):
    from optimization_tpu.linalg.lobpcg import lobpcg_fleet as j_fleet
    from optimization_tpu_torch.linalg.lobpcg import lobpcg_fleet as t_fleet

    ds, x0 = _fleet()
    A = lambda S, d: d[:, None] * S
    T = lambda S, d: S / d[:, None]
    kw = dict(T=T, nev=3, max_iterations=40, tau=1e-9)
    # the JAX fleet ignores X0 on a resume and draws a default X0 from
    # (m, nx) (ROADMAP Queue 3): it needs both
    jr, _ = JD.drive_lobpcg_fleet(A, jnp.asarray(ds), X0=jnp.asarray(x0),
                                  m=500, nx=8, chunk_iterations=7,
                                  verbose=True, **kw)
    jax_out = capsys.readouterr().out
    tr, times = TD.drive_lobpcg_fleet(A, torch.from_numpy(ds),
                                      X0=torch.from_numpy(x0),
                                      chunk_iterations=7, verbose=True, **kw)
    port_out = capsys.readouterr().out
    mono = t_fleet(A, torch.from_numpy(ds), X0=torch.from_numpy(x0), **kw)
    jmono = j_fleet(A, jnp.asarray(ds), X0=jnp.asarray(x0), **kw)

    assert torch.equal(tr.X, mono.X) and torch.equal(tr.theta, mono.theta)
    np.testing.assert_array_equal(tr.num_iterations.numpy(),
                                  np.asarray(jmono.num_iterations))
    assert bool((tr.num_converged >= 3).all())
    np.testing.assert_allclose(tr.theta.numpy(), np.asarray(jr.theta),
                               rtol=1e-10)
    assert _mask_times(port_out) == _mask_times(jax_out)
    assert "LOBPCG fleet terminated: 4/4 instances fully converged" \
        in port_out
    assert tr.residual_trace.shape == (4, 40) and times.shape == (40,)
    for b in range(4):
        kb = int(mono.num_iterations[b])
        assert np.isfinite(tr.residual_trace[b, :kb].numpy()).all()
        _assert_padded(tr.residual_trace[b, kb:])


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The JAX driver's checkpoint after 6 iterations loads positionally
    into the port's warm_start (the leaf order of jax.tree_util) and the
    port finishes the solve at JAX's monolithic result."""
    Aj, Tj = _jax_ops()
    At, Tt = _torch_ops()
    path = str(tmp_path / "lobpcg_ckpt.npz")
    kw = dict(nev=NEV, tau=1e-8)
    JD.drive_lobpcg(Aj, T=Tj, X0=jnp.asarray(X0), max_iterations=6,
                    chunk_iterations=3, checkpoint_path=path, **kw)
    jmono = j_lobpcg(Aj, T=Tj, X0=jnp.asarray(X0), max_iterations=100, **kw)

    like = t_lobpcg(At, T=Tt, X0=torch.from_numpy(X0), max_iterations=1,
                    **kw).warm_start
    ws = TC.load_pytree(path, like)
    assert int(ws[0]) == 6 and ws[1]["X"].dtype == torch.float64
    assert ws[1]["Useed"] == ()
    res = t_lobpcg(At, T=Tt, X0=torch.from_numpy(X0), max_iterations=94,
                   warm_start=ws, **kw)
    assert int(res.num_converged) >= NEV
    assert abs(int(res.num_iterations) - int(jmono.num_iterations)) <= 1
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jmono.theta),
                               rtol=1e-10)


def test_jax_warm_start_resumes_in_port():
    Aj, Tj = _jax_ops()
    At, Tt = _torch_ops()
    kw = dict(nev=NEV, tau=1e-8)
    part = j_lobpcg(Aj, T=Tj, X0=jnp.asarray(X0), max_iterations=5, **kw)
    jmono = j_lobpcg(Aj, T=Tj, X0=jnp.asarray(X0), max_iterations=100, **kw)
    ws = lobpcg_warm_start_from_jax(part.warm_start, device="cpu")
    assert ws[0].dtype == torch.int32 and ws[1]["ok"].dtype == torch.bool
    res = t_lobpcg(At, T=Tt, X0=torch.from_numpy(X0), max_iterations=95,
                   warm_start=ws, **kw)
    assert abs(int(res.num_iterations) - int(jmono.num_iterations)) <= 1
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(jmono.theta),
                               rtol=1e-10)


def test_port_checkpoint_round_trips_and_loads_in_jax(tmp_path):
    At, Tt = _torch_ops()
    Aj, Tj = _jax_ops()
    r = t_lobpcg(At, T=Tt, X0=torch.from_numpy(X0), nev=NEV,
                 max_iterations=4, tau=1e-8)
    path = str(tmp_path / "port.npz")
    TC.save_pytree(path, r.warm_start)
    back = TC.load_pytree(path, r.warm_start)
    assert int(back[0]) == int(r.warm_start[0])
    for key, v in r.warm_start[1].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(back[1][key], v), key
    # and the JAX loader reads it into a JAX warm_start template
    like = j_lobpcg(Aj, T=Tj, X0=jnp.asarray(X0), nev=NEV, max_iterations=1,
                    tau=1e-8).warm_start
    jws = JC.load_pytree(path, like)
    np.testing.assert_array_equal(np.asarray(jws[1]["X"]),
                                  r.warm_start[1]["X"].numpy())


def test_tree_flatten_orders_like_jax():
    import jax

    tree = (np.int32(3), {"b": 1.0, "a": (2.0, None, ()), "C": [4.0, 5.0]})
    from optimization_tpu_torch.core.tree import tree_flatten
    leaves, unflatten = tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert unflatten(leaves)[1]["a"] == (2.0, None, ())
