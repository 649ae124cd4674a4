"""g2o pose-graph loader and writer (counterpart of
``optimization_tpu/io/g2o.py``; the port's own copy).

The de-facto interchange format of pose-synchronization problems is g2o.
The fast path is the C++ parser ``csrc/g2o_loader.cpp`` (the port's own
copy of ``native/g2o_loader.cpp``, kept byte for byte equal to it),
compiled here with the host C++ compiler into the git-ignored
``optimization_tpu_torch/_build/libg2o_loader-<hash>.so`` at first use (the
hash covers the source and the flags, so an edited source builds anew) and
driven through ctypes.  Where no compiler or source is present, the Python
parser below produces identical arrays.  This is host-side parsing: the
arrays are numpy, and :func:`models.pose_sync.solve_pose_graph` moves them
to the device it solves on.

:class:`PoseGraph` carries the relative rotations, translations and
rotational information weights of each edge.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

__all__ = ["PoseGraph", "load_g2o", "save_g2o", "rotmat_to_quat",
           "native_available", "build_native"]

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "g2o_loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# The C++ runtime is linked in and its symbols hidden: a compiler whose own
# libstdc++ differs from the one the process (torch) has loaded would
# otherwise mix the two at run time (a crash inside the parser).
_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
              "-static-libstdc++", "-static-libgcc", "-Wl,--exclude-libs,ALL")

_lib = None


class PoseGraph(NamedTuple):
    n_vertices: int
    dim: int               # 2 or 3
    src: np.ndarray        # (E,) int32
    dst: np.ndarray        # (E,) int32
    Rij: np.ndarray        # (E, d, d) float64 relative rotations
    tij: np.ndarray        # (E, dim) float64 relative translations
    kappa: np.ndarray      # (E,) float64 rotational information weights


def _lib_path() -> Optional[Path]:
    if not _SOURCE.exists():
        return None
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return _BUILD_DIR / f"libg2o_loader-{h.hexdigest()[:16]}.so"


def build_native() -> bool:
    """Build the C++ loader with the host compiler (``$CXX``, else ``g++``
    or ``c++``) unless an up-to-date library exists; returns success."""
    out = _lib_path()
    if out is None:
        return False
    if out.exists():
        return True
    cxx = next((c for c in (os.environ.get("CXX"), shutil.which("g++"),
                            shutil.which("c++")) if c), None)
    if cxx is None:
        return False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    except (OSError, subprocess.CalledProcessError):
        return False
    return out.exists()


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():
        return None
    lib = ctypes.CDLL(str(_lib_path()))
    lib.g2o_count.argtypes = [ctypes.c_char_p] + \
        [ctypes.POINTER(ctypes.c_int32)] * 3
    lib.g2o_count.restype = ctypes.c_int
    lib.g2o_load.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    lib.g2o_load.restype = ctypes.c_int
    lib.g2o_last_error.restype = ctypes.c_char_p
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def _load_native(path: str) -> PoseGraph:
    lib = _load_lib()
    nv = ctypes.c_int32()
    ne = ctypes.c_int32()
    dim = ctypes.c_int32()
    if lib.g2o_count(path.encode(), ctypes.byref(nv), ctypes.byref(ne),
                     ctypes.byref(dim)):
        raise ValueError(
            f"g2o parse failed: {lib.g2o_last_error().decode()}: {path}")
    E, d = ne.value, dim.value
    src = np.empty(E, np.int32)
    dst = np.empty(E, np.int32)
    Rij = np.empty(E * 9, np.float64)
    tij = np.empty(E * 3, np.float64)
    kappa = np.empty(E, np.float64)
    if lib.g2o_load(path.encode(), src, dst, Rij, tij, kappa):
        raise ValueError(
            f"g2o parse failed: {lib.g2o_last_error().decode()}: {path}")
    return PoseGraph(
        n_vertices=nv.value, dim=d, src=src, dst=dst,
        Rij=Rij.reshape(E, 3, 3)[:, :d, :d].copy(),
        tij=tij.reshape(E, 3)[:, :d].copy(), kappa=kappa)


def _rot2(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s], [s, c]])


def _rot3(qx, qy, qz, qw) -> np.ndarray:
    n = math.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    if n > 0:
        qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])


def _load_python(path: str) -> PoseGraph:
    src, dst, Rij, tij, kappa = [], [], [], [], []
    dim = 0
    max_vertex = -1
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag in ("VERTEX_SE2", "VERTEX_SE3:QUAT"):
                vid = int(parts[1])
                if vid < 0:
                    raise ValueError("malformed or negative vertex id")
                max_vertex = max(max_vertex, vid)
                d = 2 if tag == "VERTEX_SE2" else 3
                if dim and dim != d:
                    raise ValueError("mixed SE2/SE3 file")
                dim = d
            elif tag == "EDGE_SE2":
                i, j = int(parts[1]), int(parts[2])
                if i < 0 or j < 0:
                    # a negative index would silently wrap downstream gathers
                    raise ValueError("negative vertex index")
                dx, dy, dth = map(float, parts[3:6])
                info = list(map(float, parts[6:12]))
                if len(info) != 6:
                    raise ValueError("malformed EDGE_SE2 line")
                src.append(i)
                dst.append(j)
                Rij.append(_rot2(dth))
                tij.append([dx, dy])
                kappa.append(info[5])
                if dim and dim != 2:
                    raise ValueError("mixed SE2/SE3 file")
                dim = 2
                max_vertex = max(max_vertex, i, j)
            elif tag == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                if i < 0 or j < 0:
                    raise ValueError("negative vertex index")
                vals = list(map(float, parts[3:10]))
                info = list(map(float, parts[10:31]))
                if len(info) != 21:
                    raise ValueError("malformed EDGE_SE3:QUAT line")
                src.append(i)
                dst.append(j)
                Rij.append(_rot3(*vals[3:7]))
                tij.append(vals[0:3])
                kappa.append((info[15] + info[18] + info[20]) / 3.0)
                if dim and dim != 3:
                    raise ValueError("mixed SE2/SE3 file")
                dim = 3
                max_vertex = max(max_vertex, i, j)
    if not src:
        raise ValueError(f"g2o parse failed: no pose-graph edges found: {path}")
    return PoseGraph(
        n_vertices=max_vertex + 1, dim=dim,
        src=np.asarray(src, np.int32), dst=np.asarray(dst, np.int32),
        Rij=np.asarray(Rij), tij=np.asarray(tij),
        kappa=np.asarray(kappa))


def rotmat_to_quat(R: np.ndarray) -> tuple:
    """Rotation matrix -> (x, y, z, w) by the largest-pivot extraction
    (branch on the largest of the trace and the three diagonal entries):
    stable for rotations arbitrarily close to pi, where the w-based formula
    degenerates."""
    t = np.trace(R)
    if t > max(R[0, 0], R[1, 1], R[2, 2]):
        s = 2.0 * math.sqrt(1.0 + t)
        return ((R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s, 0.25 * s)
    i = int(np.argmax([R[0, 0], R[1, 1], R[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * math.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
    q = [0.0, 0.0, 0.0, (R[k, j] - R[j, k]) / s]
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    return (q[0], q[1], q[2], q[3])


def save_g2o(path: str, graph: PoseGraph, poses=None, tau=None,
             precision: int = 12) -> None:
    """Write a :class:`PoseGraph` in the g2o text convention (EDGE_SE2 /
    EDGE_SE3:QUAT with diagonal information matrices, ``tau`` in the
    translational block and ``graph.kappa`` in the rotational block): the
    round-trip counterpart of :func:`load_g2o`.

    ``poses``: optional ``(R, t)`` arrays of absolute poses; when given,
    VERTEX lines are written too.  ``tau``: per-edge translational weights
    (default 1).
    """
    d = graph.dim
    E = len(graph.src)
    kappa = (np.asarray(graph.kappa, np.float64) if graph.kappa is not None
             else np.ones(E))
    tau = np.ones(E) if tau is None else np.asarray(tau, np.float64)
    p = precision
    lines = []
    if poses is not None:
        R_abs, t_abs = (np.asarray(poses[0], np.float64),
                        np.asarray(poses[1], np.float64))
        for i in range(R_abs.shape[0]):
            if d == 2:
                th = math.atan2(R_abs[i, 1, 0], R_abs[i, 0, 0])
                lines.append(f"VERTEX_SE2 {i} {t_abs[i, 0]:.{p}f} "
                             f"{t_abs[i, 1]:.{p}f} {th:.{p}f}")
            else:
                x, y, z, w = rotmat_to_quat(R_abs[i])
                lines.append(
                    f"VERTEX_SE3:QUAT {i} "
                    f"{t_abs[i, 0]:.{p}f} {t_abs[i, 1]:.{p}f} "
                    f"{t_abs[i, 2]:.{p}f} "
                    f"{x:.{p}f} {y:.{p}f} {z:.{p}f} {w:.{p}f}")
    Rij = np.asarray(graph.Rij, np.float64)
    tij = np.asarray(graph.tij, np.float64)
    for e in range(E):
        i, j = int(graph.src[e]), int(graph.dst[e])
        if d == 2:
            th = math.atan2(Rij[e, 1, 0], Rij[e, 0, 0])
            # 3x3 upper-triangular info: diag (tau, tau, kappa) at 0, 3, 5
            info = [tau[e], 0.0, 0.0, tau[e], 0.0, kappa[e]]
            info_s = " ".join(f"{v:.{p}g}" for v in info)
            lines.append(f"EDGE_SE2 {i} {j} {tij[e, 0]:.{p}f} "
                         f"{tij[e, 1]:.{p}f} {th:.{p}f} {info_s}")
        else:
            x, y, z, w = rotmat_to_quat(Rij[e])
            # 6x6 upper-triangular info: diagonal slots 0, 6, 11
            # (translation) and 15, 18, 20 (rotation), as the loaders read
            info = [0.0] * 21
            info[0] = info[6] = info[11] = tau[e]
            info[15] = info[18] = info[20] = kappa[e]
            info_s = " ".join(f"{v:.{p}g}" for v in info)
            lines.append(
                f"EDGE_SE3:QUAT {i} {j} "
                f"{tij[e, 0]:.{p}f} {tij[e, 1]:.{p}f} {tij[e, 2]:.{p}f} "
                f"{x:.{p}f} {y:.{p}f} {z:.{p}f} {w:.{p}f} {info_s}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_g2o(path: str, native: Optional[bool] = None) -> PoseGraph:
    """Load a g2o pose graph.

    ``native=None`` (default) uses the C++ loader when it is available
    (building it on first use where a compiler exists) and the Python
    parser otherwise; ``True``/``False`` force a path.
    """
    if native is None:
        native = native_available()
    if native:
        return _load_native(path)
    return _load_python(path)
