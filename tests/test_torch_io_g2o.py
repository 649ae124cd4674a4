"""The port's g2o loader and writer == the JAX package's.

Both of the port's parsers (the native C++ loader, built into
``optimization_tpu_torch/_build/``, and the Python parser) read the same
files as JAX's Python parser: indices equal, rotations, translations and
kappa within 1e-12 (the native loader parses with the C library, Python
with ``float``).  ``save_g2o`` writes the same text as JAX's; round trips
through both parsers give the graph back (rotations within 1e-9, a
near-pi one included; translations within 1e-10; kappa rtol 1e-10).  A
missing file and negative indices raise ``ValueError`` in both parsers.
"""

import numpy as np
import pytest
import torch

from optimization_tpu.io import g2o as jg2o
from optimization_tpu_torch import interop
from optimization_tpu_torch.io import g2o

from test_io_g2o import _write_se2_file, _write_se3_file

torch.set_num_threads(1)

NATIVE = [False, True]


def _same(a, b, atol=1e-12):
    assert a.n_vertices == b.n_vertices and a.dim == b.dim
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    assert a.src.dtype == np.int32 and a.Rij.dtype == np.float64
    np.testing.assert_allclose(a.Rij, b.Rij, atol=atol)
    np.testing.assert_allclose(a.tij, b.tij, atol=atol)
    np.testing.assert_allclose(a.kappa, b.kappa, atol=atol)


def test_native_loader_builds_into_the_port():
    assert g2o.native_available()
    path = g2o._lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "optimization_tpu_torch"


@pytest.mark.parametrize("native", NATIVE, ids=["python", "native"])
@pytest.mark.parametrize("kind", ["se3", "se2"])
def test_loaders_match_jax(tmp_path, kind, native):
    p = tmp_path / "g.g2o"
    if kind == "se3":
        _write_se3_file(p, n=10, extra=12, seed=3)
    else:
        _write_se2_file(p)
    _same(g2o.load_g2o(str(p), native=native),
          jg2o.load_g2o(str(p), native=False))


def test_loaders_tolerate_blank_and_crlf_lines(tmp_path):
    p = tmp_path / "crlf.g2o"
    _write_se3_file(p, n=4, extra=2, seed=7)
    body = p.read_text().replace("\n", "\r\n")
    p.write_text("# comment\r\n   \r\n" + body + "   \n\r\n")
    ref = jg2o.load_g2o(str(p), native=False)
    for native in NATIVE:
        _same(g2o.load_g2o(str(p), native=native), ref)


def _near_pi_graph(rng, E=24, n=9):
    def rand_rot():
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        return q

    Rij = np.stack([rand_rot() for _ in range(E)])
    axis = np.array([1.0, 2.0, -1.0]) / np.sqrt(6.0)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    th = np.pi - 1e-7
    Rij[0] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    src = rng.integers(0, n, E).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, n - 1, E)) % n).astype(np.int32)
    return g2o.PoseGraph(n_vertices=n, dim=3, src=src, dst=dst, Rij=Rij,
                         tij=rng.normal(size=(E, 3)),
                         kappa=rng.uniform(0.5, 8.0, E))


def test_save_writes_the_jax_text_and_round_trips_se3(tmp_path):
    rng = np.random.default_rng(3)
    graph = _near_pi_graph(rng)
    n, E = graph.n_vertices, len(graph.src)
    tau = rng.uniform(0.1, 3.0, E)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q[..., :, 0] *= np.sign(np.linalg.det(q))[..., None]
    poses = (q, rng.normal(size=(n, 3)))
    ours, theirs = str(tmp_path / "port.g2o"), str(tmp_path / "jax.g2o")
    g2o.save_g2o(ours, graph, poses=poses, tau=tau)
    jg2o.save_g2o(theirs, jg2o.PoseGraph(*graph), poses=poses, tau=tau)
    assert open(ours).read() == open(theirs).read()
    for native in NATIVE:
        loaded = g2o.load_g2o(ours, native=native)
        assert loaded.n_vertices == n and loaded.dim == 3
        np.testing.assert_array_equal(loaded.src, graph.src)
        np.testing.assert_array_equal(loaded.dst, graph.dst)
        np.testing.assert_allclose(loaded.Rij, graph.Rij, atol=1e-9)
        np.testing.assert_allclose(loaded.tij, graph.tij, atol=1e-10)
        np.testing.assert_allclose(loaded.kappa, graph.kappa, rtol=1e-10)


def test_save_writes_the_jax_text_and_round_trips_se2(tmp_path):
    rng = np.random.default_rng(4)
    E, n = 10, 5
    th = rng.uniform(-np.pi, np.pi, E)
    Rij = np.stack([[[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
                    for a in th])
    graph = g2o.PoseGraph(
        n_vertices=n, dim=2, src=rng.integers(0, n, E).astype(np.int32),
        dst=rng.integers(0, n, E).astype(np.int32), Rij=Rij,
        tij=rng.normal(size=(E, 2)), kappa=rng.uniform(0.5, 2.0, E))
    poses = (Rij[:n], rng.normal(size=(n, 2)))
    ours, theirs = str(tmp_path / "port.g2o"), str(tmp_path / "jax.g2o")
    g2o.save_g2o(ours, graph, poses=poses)
    jg2o.save_g2o(theirs, jg2o.PoseGraph(*graph), poses=poses)
    assert open(ours).read() == open(theirs).read()
    for native in NATIVE:
        loaded = g2o.load_g2o(ours, native=native)
        np.testing.assert_allclose(loaded.Rij, graph.Rij, atol=1e-10)
        np.testing.assert_allclose(loaded.tij, graph.tij, atol=1e-10)
        np.testing.assert_allclose(loaded.kappa, graph.kappa, rtol=1e-10)


def test_rotmat_to_quat_matches_jax():
    rng = np.random.default_rng(5)
    graph = _near_pi_graph(rng)
    for R in graph.Rij:
        np.testing.assert_allclose(g2o.rotmat_to_quat(R),
                                   jg2o.rotmat_to_quat(R), rtol=0, atol=0)


@pytest.mark.parametrize("native", NATIVE, ids=["python", "native"])
def test_missing_file_raises(tmp_path, native):
    missing = str(tmp_path / "nonexistent.g2o")
    with pytest.raises((ValueError, OSError)):
        g2o.load_g2o(missing, native=native)


@pytest.mark.parametrize("native", NATIVE, ids=["python", "native"])
def test_negative_vertex_index_rejected(tmp_path, native):
    p = tmp_path / "bad.g2o"
    info = " ".join(["1.0"] * 21)
    p.write_text("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n"
                 f"EDGE_SE3:QUAT -1 0 0 0 0 0 0 0 1 {info}\n")
    with pytest.raises(ValueError, match="negative vertex index"):
        g2o.load_g2o(str(p), native=native)
    p2 = tmp_path / "bad2.g2o"
    p2.write_text("VERTEX_SE2 -3 0 0 0\n"
                  "EDGE_SE2 0 1 1.0 0.0 0.1 4.0 0.0 0.0 4.0 0.0 2.5\n")
    with pytest.raises(ValueError, match="vertex id|invalid literal"):
        g2o.load_g2o(str(p2), native=native)


def test_pose_graph_from_jax(tmp_path):
    p = tmp_path / "g.g2o"
    _write_se3_file(p, n=6, extra=4, seed=1)
    jgraph = jg2o.load_g2o(str(p), native=False)
    graph = interop.pose_graph_from_jax(jgraph)
    assert isinstance(graph, g2o.PoseGraph)
    _same(graph, jgraph, atol=0)
    assert interop.pose_graph_from_jax(jgraph._replace(kappa=None)).kappa \
        is None
