"""ctypes bindings of the host-side native library (counterpart of
``native.py``): exact kNN by KD-tree, the distance-pick patcher, voxel-grid
subsampling, the ball renderers and exact point-to-mesh distances, all on
the CPU.

The port keeps its own copy of the C++ source, ``csrc/dispu_native.cpp``,
and builds it with ``g++`` (or ``$CXX``) at first use, with the flags of
``native/Makefile`` (OpenMP where the compiler links with it), into
``dispu_tpu_torch/_build/dispu_native-<hash>.so``, the hash over the source
and the flags.  It never writes into ``native/``.  A failed build raises
with the compiler's output; :func:`available` reports whether the library
builds and loads.  No function falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "dispu_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")

_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _flags() -> tuple:
    """``native/Makefile``'s flags, with ``-fopenmp`` where the compiler
    links a program with it.  (The Makefile asks the preprocessor alone,
    which a compiler without OpenMP's runtime can pass and then fail the
    link; without the flag the source's pragmas are ignored and the
    library runs on one thread.)"""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cpp")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        try:
            probe = subprocess.run([_cxx(), "-fopenmp", src, "-o",
                                    os.path.join(tmp, "probe")],
                                   capture_output=True)
        except OSError:  # no compiler: build() says so
            return CXX_FLAGS
    return CXX_FLAGS + (("-fopenmp",) if probe.returncode == 0 else ())


def build() -> pathlib.Path:
    """Compile the library unless it is built already; returns its path.
    Raises ``RuntimeError`` with the compiler's output when the build
    fails (or no compiler is found)."""
    flags = _flags()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((_cxx(),) + flags).encode())
    target = BUILD_DIR / f"dispu_native-{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *flags, "-shared", "-o", str(tmp), str(SOURCE),
           "-lpthread"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native library cannot be built: {e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.stdout}"
                           f"{out.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builds load whole files
    return target


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    c_int = ctypes.c_int
    lib.dispu_knn_batch.argtypes = [f32p, f32p, c_int, c_int, c_int, c_int,
                                    i32p, f32p]
    lib.dispu_knn_batch.restype = None
    lib.dispu_knn.argtypes = [f32p, c_int, c_int, f32p, c_int, c_int, i32p,
                              f32p]
    lib.dispu_knn.restype = None
    lib.dispu_knn_batch_distance_pick.argtypes = [
        f32p, c_int, c_int, c_int, c_int, c_int, ctypes.c_uint64, f32p,
        i32p]
    lib.dispu_knn_batch_distance_pick.restype = None
    lib.dispu_grid_subsample.argtypes = [f32p, f32p, c_int, c_int,
                                         ctypes.c_float, f32p, f32p, c_int]
    lib.dispu_grid_subsample.restype = c_int
    lib.dispu_render_points.argtypes = [f32p, c_int, c_int, c_int, f32p]
    lib.dispu_render_points.restype = None
    lib.dispu_render_ball.argtypes = [c_int, c_int, u8p, c_int, i32p, f32p,
                                      f32p, f32p, c_int]
    lib.dispu_render_ball.restype = None
    lib.dispu_point_to_mesh.argtypes = [f32p, c_int, f32p, c_int, i32p,
                                        c_int, f32p, f32p]
    lib.dispu_point_to_mesh.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _ptr(a: Optional[np.ndarray], t=ctypes.c_float):
    """A pointer to ``a``'s data (NULL for None); the caller keeps ``a``
    alive across the call."""
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(t))
    return a.ctypes.data_as(ctypes.POINTER(t))


def _shape(a: np.ndarray, ndim: int, what: str, last: Optional[int] = None):
    if a.ndim != ndim or (last is not None and a.shape[-1] != last):
        want = f"{ndim}-d" + (f" with {last} columns" if last else "")
        raise ValueError(f"{what} must be {want}, got shape {a.shape}")


def knn_batch(support, queries, k: int, return_dist: bool = False):
    """Exact batched kNN by KD-tree: (b, n, 3) support, (b, m, 3) queries
    → idx (b, m, k) int32, ascending by distance [, squared distances
    (b, m, k) f32]."""
    lib = _load()
    support, queries = _f32(support), _f32(queries)
    _shape(support, 3, "support", 3)
    _shape(queries, 3, "queries", 3)
    b, n, _ = support.shape
    if queries.shape[0] != b or not 0 < k <= n:
        raise ValueError(f"queries {queries.shape} and k={k} do not fit "
                         f"support {support.shape}")
    m = queries.shape[1]
    idx = np.empty((b, m, k), np.int32)
    d2 = np.empty((b, m, k), np.float32) if return_dist else None
    lib.dispu_knn_batch(_ptr(support), _ptr(queries), b, n, m, k,
                        _ptr(idx, ctypes.c_int32), _ptr(d2))
    return (idx, d2) if return_dist else idx


def knn(pts, queries, k: int, return_dist: bool = False):
    """Exact kNN of one cloud in any dimension: (n, dim) points, (m, dim)
    queries → idx (m, k) int64 ascending by distance [, squared distances
    (m, k) f32]."""
    lib = _load()
    pts, queries = _f32(pts), _f32(queries)
    _shape(pts, 2, "pts")
    _shape(queries, 2, "queries", pts.shape[1])
    n, dim = pts.shape
    if not 0 < k <= n:
        raise ValueError(f"k={k} does not fit {n} points")
    m = queries.shape[0]
    idx = np.empty((m, k), np.int32)
    d2 = np.empty((m, k), np.float32) if return_dist else None
    lib.dispu_knn(_ptr(pts), n, dim, _ptr(queries), m, k,
                  _ptr(idx, ctypes.c_int32), _ptr(d2))
    idx64 = idx.astype(np.int64)
    return (idx64, d2) if return_dist else idx64


def knn_batch_distance_pick(pts, nqueries: int, k: int, seed: int = 0):
    """Coverage-balanced queries and their kNN: repeatedly the k nearest
    around a least-used point drawn from a generator seeded with ``seed``.
    (b, n, dim) points → (idx (b, nqueries, k) int64, queries (b,
    nqueries, dim) f32)."""
    lib = _load()
    pts = _f32(pts)
    _shape(pts, 3, "pts")
    b, n, dim = pts.shape
    if not 0 < k <= n:
        raise ValueError(f"k={k} does not fit {n} points")
    idx = np.empty((b, nqueries, k), np.int32)
    queries = np.empty((b, nqueries, dim), np.float32)
    lib.dispu_knn_batch_distance_pick(
        _ptr(pts), b, n, dim, nqueries, k, ctypes.c_uint64(seed),
        _ptr(queries), _ptr(idx, ctypes.c_int32))
    return idx.astype(np.int64), queries


def grid_subsample(points, cell: float, features=None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Voxel-grid barycentres of (n, 3) points (and of (n, f) features)
    → ((cells, 3), (cells, f) or None)."""
    lib = _load()
    points = _f32(points)
    _shape(points, 2, "points", 3)
    n = len(points)
    feats = None if features is None else _f32(features)
    if feats is not None and (feats.ndim != 2 or len(feats) != n):
        raise ValueError(f"features {feats.shape} do not fit {n} points")
    fdim = 0 if feats is None else feats.shape[1]
    out_p = np.empty((n, 3), np.float32)
    out_f = np.empty((n, fdim), np.float32) if fdim else None
    cnt = lib.dispu_grid_subsample(_ptr(points), _ptr(feats), n, fdim, cell,
                                   _ptr(out_p), _ptr(out_f), n)
    return out_p[:cnt].copy(), (None if out_f is None
                                else out_f[:cnt].copy())


def render_points(points, size: int = 500, radius: int = 5) -> np.ndarray:
    """Z-buffer ball render of (n, 3) points → (size, size) f32 image."""
    lib = _load()
    points = _f32(points)
    _shape(points, 2, "points", 3)
    img = np.empty((size, size), np.float32)
    lib.dispu_render_points(_ptr(points), len(points), size, radius,
                            _ptr(img))
    return img


def render_ball(h: int, w: int, xyzs, c0, c1, c2,
                radius: int = 8) -> np.ndarray:
    """The reference's colour ball renderer: (n, 3) int32 pixel-space
    coordinates (x row, y column, z depth) and (n,) colours on a 0–255
    scale → (h, w, 3) uint8, with its channel order (out[0] = b·c2,
    out[1] = g·c0, out[2] = r·c1)."""
    lib = _load()
    xyzs = np.ascontiguousarray(xyzs, np.int32)
    _shape(xyzs, 2, "xyzs", 3)
    n = len(xyzs)
    c0, c1, c2 = (_f32(c) for c in (c0, c1, c2))
    if any(c.shape != (n,) for c in (c0, c1, c2)):
        raise ValueError(f"colours must be ({n},)")
    img = np.zeros((h, w, 3), np.uint8)
    lib.dispu_render_ball(h, w, _ptr(img, ctypes.c_uint8), n,
                          _ptr(xyzs, ctypes.c_int32), _ptr(c0), _ptr(c1),
                          _ptr(c2), radius)
    return img


def point_to_mesh(points, verts, faces):
    """Exact distance of each (n, 3) point to the mesh (verts (v, 3),
    faces (f, 3)) and its nearest surface point → ((n,) f32, (n, 3)
    f32), multithreaded."""
    lib = _load()
    points, verts = _f32(points), _f32(verts)
    faces = np.ascontiguousarray(faces, np.int32)
    _shape(points, 2, "points", 3)
    _shape(verts, 2, "verts", 3)
    _shape(faces, 2, "faces", 3)
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("faces index outside the vertices")
    dist = np.empty(len(points), np.float32)
    nearest = np.empty((len(points), 3), np.float32)
    lib.dispu_point_to_mesh(_ptr(points), len(points), _ptr(verts),
                            len(verts), _ptr(faces, ctypes.c_int32),
                            len(faces), _ptr(dist), _ptr(nearest))
    return dist, nearest
