"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one; the kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances (those of ``chip_smoke.check_parity`` and
``tests/test_streamed_cg.py``): f32 iteration counts within 1 and s within
2e-3 |s| (the kernel sums in another order than ``torch.sum``, so CG may
stop one step apart at the truncation threshold; equal counts give ~1e-6);
bf16 storage iterations within 3 and s within 3e-2 |s|.
"""

import pytest
import torch

from optimization_tpu_torch.kernels import streamed_cg as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _pd_fixture(n, dtype, dev, seed=7):
    """The positive-definite fixture (rq = 0.5, B_pd): many CG steps.  Delta
    is 1e6 in f32 and 1 in bf16, where a huge Delta is a knife-edge: once CG
    stalls at the storage floor a rounding-sign kappa <= 0 sends either run
    to the boundary (tests/test_streamed_cg.py test_bf16_storage_parity)."""
    diag = T.AffineDiagonal(1.0, 25.0 / (n - 1))
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=dev)
    x = x / torch.linalg.vector_norm(x)
    a = diag.values(n, dev)
    y = 2.0 * a * x
    g = y - torch.dot(x, y) * x
    B = torch.tensor([[1.0, 0.2], [0.2, 0.5]], device=dev)
    rq = torch.tensor(0.5, device=dev)
    a0c, weights, _ = T.sphere_rayleigh_streamed(diag)
    kw = dict(a0_chunk=a0c, weights=weights, max_iterations=400,
              kappa_fgr=1e-3, theta=0.9)
    Delta = 1.0 if dtype == torch.bfloat16 else 1e6
    return (g.to(dtype), x.to(dtype), B, Delta, (rq,)), kw


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("body", ["pair", "single"])
@pytest.mark.parametrize("n", [1 << 18, 100_003])
def test_kernel_matches_plain_version(dev, storage, body, n):
    args, kw = _pd_fixture(n, storage, dev)
    before = T.stpcg_flat_streamed.launches
    res = T.stpcg_flat_streamed(*args, body_kind=body, **kw)
    ref = T.stpcg_flat_streamed_reference(*args, body_kind=body, **kw)
    torch.cuda.synchronize()
    assert T.stpcg_flat_streamed.launches == before + 1
    assert res.s.dtype == storage and res.s.device == args[0].device
    tol, dit = (3e-2, 3) if storage == torch.bfloat16 else (2e-3, 1)
    assert abs(int(res.num_iterations) - int(ref.num_iterations)) <= dit
    if storage == torch.float32:
        assert int(ref.num_iterations) > 3       # a multi-iteration run
    scale = float(torch.linalg.vector_norm(ref.s.float()))
    assert float((res.s.float() - ref.s.float()).abs().max()) <= tol * scale


def test_two_runs_are_bitwise_equal(dev):
    args, kw = _pd_fixture(1 << 18, torch.float32, dev)
    r1 = T.stpcg_flat_streamed(*args, **kw)
    r2 = T.stpcg_flat_streamed(*args, **kw)
    assert torch.equal(r1.s, r2.s)
    assert all(torch.equal(a, b) for a, b in zip(r1[1:], r2[1:]))


def test_stored_diagonal_matches_affine(dev):
    (g, x, B, Delta, aux), kw = _pd_fixture(1 << 16, torch.float32, dev)
    n = g.shape[0]
    a = T.AffineDiagonal(1.0, 25.0 / (n - 1)).values(n, dev)
    a0c, weights, _ = T.sphere_rayleigh_streamed(a)
    stored = T.stpcg_flat_streamed(g, x, B, Delta, aux, **dict(
        kw, a0_chunk=a0c, weights=weights))
    affine = T.stpcg_flat_streamed(g, x, B, Delta, aux, **kw)
    assert torch.equal(stored.s, affine.s)


def test_zero_gradient_and_outputs_stay_on_card(dev):
    (g, x, B, Delta, aux), kw = _pd_fixture(4099, torch.float32, dev)
    res = T.stpcg_flat_streamed(torch.zeros_like(g), x, B, Delta, aux, **kw)
    assert int(res.num_iterations) == 0
    assert not res.s.any()
    for t in res[1:]:
        assert t.device.type == "cuda"
