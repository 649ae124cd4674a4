"""The sphere trial step's routes on the CPU (``kernels.sphere_step``: the
routing evaluator ``sphere_rayleigh_step`` and the wrapper, beside the
plain evaluator ``linalg.flat_cg.sphere_rayleigh_step``).

The kernel (``csrc/sphere_step.cu``) runs only on the card, where
``tests/test_torch_cuda.py`` holds it against the plain version and a
float64 evaluation.  Here: a descriptor-carrying ``DiagonalElem`` gives bit
for bit the outputs of the opaque callable it replaces in the headline
problem (both run the plain version on the CPU); every call of the route
table reaches the wrapper or the plain evaluator, with both stubbed; the
headline and the escalation example hand the routing evaluator their
diagonal's descriptor; and the wrapper refuses what the kernel does not
take rather than falling back.
"""

import importlib
import types

import pytest
import torch

from optimization_tpu_torch import headline
from optimization_tpu_torch.kernels.streamed_cg import AffineDiagonal
from optimization_tpu_torch.linalg import flat_cg

# the module (the package's ``kernels.sphere_step`` is the function)
S = importlib.import_module("optimization_tpu_torch.kernels.sphere_step")

torch.set_num_threads(1)


def _point_and_step(n, storage, step, seed=5):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=gen)
    x = x / torch.linalg.vector_norm(x)
    h = (0.3 * torch.randn(n, generator=gen) / n ** 0.5 if step
         else torch.zeros(n))
    return x.to(storage), h.to(storage)


def _flat(out):
    """The step's outputs as a flat list of tensors (init fields included)."""
    xp, f, g, gn, aux = out
    init = [] if aux.init is None else list(aux.init)
    return [xp, f, g, gn, aux.rq] + init


@pytest.mark.parametrize("with_init", [True, False], ids=["init", "no-init"])
@pytest.mark.parametrize("step", [False, True], ids=["h0", "step"])
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_descriptor_elem_is_bitwise_the_callable(storage, step, with_init):
    """The headline's diagonal as a ``DiagonalElem`` and as the callable
    ``a * v.to(float32)`` give the same bits, through the plain and the
    routing evaluator and the wrapper's CPU route, which count no
    launch."""
    n = 1001
    diag = AffineDiagonal(1.0, 999.0 / (n - 1))
    a = diag.values(n, "cpu")
    x, h = _point_and_step(n, storage, step)
    ref = flat_cg.sphere_rayleigh_step(lambda v: a * v.to(torch.float32),
                                       with_init)(x, h, None)
    before = S.sphere_step.launches
    elem = S.DiagonalElem(diag, n, "cpu")
    for out in (flat_cg.sphere_rayleigh_step(elem, with_init)(x, h, None),
                S.sphere_rayleigh_step(elem, with_init)(x, h, None),
                S.sphere_step(x, h, elem, with_init)):
        assert (out[4].init is None) == (not with_init)
        got, want = _flat(out), _flat(ref)
        assert len(got) == len(want)
        for t, r in zip(got, want):
            assert t.dtype == r.dtype and t.shape == r.shape
            assert torch.equal(t, r)
    assert out[0].dtype == storage and out[1].dtype == torch.float32
    assert S.sphere_step.launches == before


def _stand_in(device, dtype):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
# (A_elem kind, device, x dtype, h dtype, the route): the routes of
# kernels.sphere_step.sphere_rayleigh_step's docstring
ROUTES = [
    ("descriptor", "cuda", F32, F32, "kernel"),
    ("descriptor", "cuda", BF16, BF16, "kernel"),
    ("descriptor", "cpu", F32, F32, "plain"),
    ("descriptor", "cpu", BF16, BF16, "plain"),
    ("opaque", "cuda", F32, F32, "plain"),
    ("opaque", "cuda", BF16, BF16, "plain"),
    ("descriptor", "cuda", F64, F64, "plain"),
    ("descriptor", "cuda", F32, BF16, "plain"),
]


@pytest.mark.parametrize("kind,device,xdt,hdt,route", ROUTES,
                         ids=["-".join(str(p).replace("torch.", "")
                                       for p in r) for r in ROUTES])
@pytest.mark.parametrize("with_init", [True, False], ids=["init", "no-init"])
def test_route_table(monkeypatch, kind, device, xdt, hdt, route, with_init):
    """Which calls of the routing ``sphere_rayleigh_step``'s ``step_eval``
    reach the kernel's wrapper and which the plain evaluator (both
    stubbed), with the arguments each receives."""
    calls = []

    def stub(name):
        def record(*args):
            calls.append((name, args))
            return name
        return record

    def plain_factory(A_elem, with_init):
        calls.append(("plain evaluator", (A_elem, with_init)))
        return stub("plain")

    monkeypatch.setattr(S, "sphere_step", stub("kernel"))
    monkeypatch.setattr(flat_cg, "sphere_rayleigh_step", plain_factory)
    n = 16
    elem = S.DiagonalElem(AffineDiagonal(1.0, 0.5), n, "cpu")
    A_elem = elem if kind == "descriptor" else (lambda v: elem(v))
    x, h = _stand_in(device, xdt), _stand_in(device, hdt)
    step_eval = S.sphere_rayleigh_step(A_elem, with_init)
    assert calls == [("plain evaluator", (A_elem, with_init))]
    assert step_eval(x, h, "data") == route
    assert len(calls) == 2
    name, args = calls[1]
    assert name == route
    if route == "kernel":
        assert args == (x, h, A_elem, with_init)
    else:
        assert args == (x, h, "data")


@pytest.mark.parametrize("jacobi_power", [None, 0.25], ids=["plain", "jacobi"])
@pytest.mark.parametrize("engine", ["streamed", "flat"])
def test_headline_hands_the_step_its_diagonal(monkeypatch, engine,
                                              jacobi_power):
    """``headline.make_problem``'s trial step is the routing evaluator of a
    ``DiagonalElem`` of the problem's own diagonal, so on the card each
    trial step is the kernel."""
    seen = []
    real = headline.sphere_rayleigh_step
    assert real is S.sphere_rayleigh_step

    def recorder(A_elem, with_init=True):
        seen.append((A_elem, with_init))
        return real(A_elem, with_init)

    monkeypatch.setattr(headline, "sphere_rayleigh_step", recorder)
    n, kappa = 64, 1e5
    headline.make_problem(n, "cpu", engine, kappa=kappa,
                          jacobi_power=jacobi_power)
    (elem, with_init), = seen
    assert with_init is True
    assert isinstance(elem, S.DiagonalElem)
    assert elem.diag == AffineDiagonal(1.0, (kappa - 1.0) / (n - 1))
    assert torch.equal(elem.a, elem.diag.values(n, "cpu"))
    v = torch.randn(n, dtype=torch.float64)
    assert torch.equal(elem(v), elem.a * v.to(torch.float32))


def test_escalation_example_hands_the_step_its_diagonal(monkeypatch):
    """``examples.dtype_escalation`` builds its diagonal 1 + b i as a
    ``DiagonalElem`` with the callable's bits, and hands it to the routing
    evaluator, so both stages take the kernel on the card."""
    from optimization_tpu_torch.examples import dtype_escalation as E

    seen = []
    real = E.sphere_rayleigh_step
    assert real is S.sphere_rayleigh_step

    def recorder(A_elem, with_init=True):
        seen.append(A_elem)
        return real(A_elem, with_init)

    monkeypatch.setattr(E, "sphere_rayleigh_step", recorder)
    n = 1 << 10
    problem = E.make_problem(n, "cpu")
    elem, = seen
    assert isinstance(elem, S.DiagonalElem)
    b = 999.0 / (n - 1)
    assert elem.diag == AffineDiagonal(1.0, b)
    assert torch.equal(elem.a,
                       1.0 + b * torch.arange(n, dtype=torch.float32))
    x = torch.randn(n)
    assert torch.equal(problem.f(x, None),
                       torch.dot(x, (1.0 + b * torch.arange(n)) * x))


@pytest.mark.parametrize("case", ["float64", "opaque", "meta"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Off the CPU the wrapper launches or raises: no plain fallback."""
    n = 8
    elem = S.DiagonalElem(AffineDiagonal(1.0, 0.5), n, "cpu")
    dt = torch.float64 if case == "float64" else torch.float32
    x = torch.empty(n, dtype=dt, device="meta")
    h = torch.empty(n, dtype=dt, device="meta")
    A_elem = (lambda v: elem(v)) if case == "opaque" else elem
    match = {"float64": "dtype", "opaque": "DiagonalElem",
             "meta": "CUDA tensors"}[case]
    before = S.sphere_step.launches
    with pytest.raises(ValueError, match=match):
        S.sphere_step(x, h, A_elem)
    assert S.sphere_step.launches == before
