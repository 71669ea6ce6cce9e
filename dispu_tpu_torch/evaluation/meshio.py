"""Mesh and point-cloud files: OFF, xyz, PLY and PCD, and area-weighted
surface samples (counterpart of ``evaluation/meshio.py``, numpy on the
host as there).  ``sample_mesh_surface`` draws from
``np.random.RandomState(seed)`` in the same order, so its samples are
bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def read_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read an OFF mesh → (vertices (v, 3) f32, faces (f, 3) i32).

    Handles the common header variants ('OFF' on its own line or fused with
    the counts) and polygonal faces (fan-triangulated).
    """
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    if tokens[0].upper().startswith("OFF"):
        rest = tokens[0][3:]
        i = 1
        if rest:  # 'OFF3 5 0' style fused header
            tokens.insert(1, rest)
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3  # skip edge count
    verts = np.array(tokens[i : i + 3 * nv], np.float32).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[i])
        poly = [int(t) for t in tokens[i + 1 : i + 1 + k]]
        i += 1 + k
        for j in range(1, k - 1):  # fan triangulation
            faces.append((poly[0], poly[j], poly[j + 1]))
    return verts, np.asarray(faces, np.int32)


def write_off(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a triangle mesh in the standard OFF layout ``read_off``
    parses (header line, counts line, vertex rows, '3 i j k' face rows).
    The evaluation set's meshes are written this way."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(verts)} {len(faces)} 0\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def read_ply(path: str, return_attributes: bool = False):
    """Read vertex positions from an ASCII or binary_little_endian PLY.

    Self-contained (no plyfile or open3d); covers the point-cloud PLYs
    that Dis-PU's own tooling reads and writes.  With ``return_attributes`` also
    returns {'normals': (n,3) f32, 'colors': (n,3) u8} for whichever of
    nx/ny/nz and red/green/blue the file carries.
    """
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        counts = {}
        props = []
        current = None
        for l in header:
            t = l.split()
            if t and t[0] == "element":
                current = t[1]
                counts[current] = int(t[2])
                props.append((current, []))
            elif t and t[0] == "property" and current is not None:
                if t[1] == "list":
                    props[-1][1].append(("list", t[2], t[3], t[4]))
                else:
                    props[-1][1].append((t[1], t[2]))
        nv = counts.get("vertex", 0)
        vprops = dict(props).get("vertex", [])
        names = [p[-1] for p in vprops]
        np_types = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
            "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
        }
        if fmt == "ascii":
            rows = []
            for _ in range(nv):
                rows.append([float(x) for x in f.readline().split()])
            data = np.asarray(rows, np.float64)
        else:
            dtype = np.dtype(
                [(n, "<" + np_types[t]) for (t, n) in vprops]
            )
            raw = np.frombuffer(f.read(nv * dtype.itemsize), dtype=dtype)
            data = np.stack(
                [raw[n].astype(np.float64) for n in names], axis=-1
            )
        cols = [names.index(c) for c in ("x", "y", "z")]
        pts = data[:, cols].astype(np.float32)
        if not return_attributes:
            return pts
        attrs = {}
        if all(n in names for n in ("nx", "ny", "nz")):
            nc = [names.index(c) for c in ("nx", "ny", "nz")]
            attrs["normals"] = data[:, nc].astype(np.float32)
        if all(n in names for n in ("red", "green", "blue")):
            cc = [names.index(c) for c in ("red", "green", "blue")]
            attrs["colors"] = data[:, cc].astype(np.uint8)
        return pts, attrs


def write_ply(
    path: str,
    points: np.ndarray,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
) -> None:
    """Write a point cloud as ASCII PLY (vertex x y z), optionally with
    per-point normals (float nx ny nz) and colors (uchar red green blue).

    The layout of Dis-PU's ``save_ply`` with normals and colors.
    """
    points = np.asarray(points, np.float32)
    header = ["ply", "format ascii 1.0", "element vertex %d" % len(points),
              "property float x", "property float y", "property float z"]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if colors is not None:
        colors = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    with open(path, "w") as f:
        f.write("\n".join(header) + "\nend_header\n")
        for i, p in enumerate(points):
            row = "%.6f %.6f %.6f" % (p[0], p[1], p[2])
            if normals is not None:
                row += " %.6f %.6f %.6f" % tuple(normals[i])
            if colors is not None:
                row += " %d %d %d" % tuple(colors[i])
            f.write(row + "\n")


def read_pcd(path: str) -> np.ndarray:
    """Read xyz from a PCD v0.7 file (ascii or binary).

    A self-contained parser (no open3d).  Only the x/y/z fields are
    returned, as Dis-PU's ``read_pcd`` uses them.
    """
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()
        np_type = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1",
                   ("I", 2): "i2", ("I", 4): "i4", ("U", 1): "u1",
                   ("U", 2): "u2", ("U", 4): "u4"}
        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            data = np.atleast_2d(data)
            col = 0
            cols = {}
            for name, c in zip(fields, counts):
                cols[name] = col
                col += c
            xyz = data[:, [cols["x"], cols["y"], cols["z"]]]
            return xyz.astype(np.float32)
        if mode != "binary":
            raise ValueError(f"unsupported PCD data mode: {mode}")
        dt = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            base = "<" + np_type[(typ, size)]
            dt.append((name, base, (cnt,)) if cnt > 1 else (name, base))
        dtype = np.dtype(dt)
        raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        return np.stack(
            [raw["x"], raw["y"], raw["z"]], axis=-1
        ).astype(np.float32)


def save_pcd(path: str, points: np.ndarray) -> None:
    """Write xyz as ASCII PCD v0.7."""
    points = np.asarray(points, np.float32)
    with open(path, "w") as f:
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
            "COUNT 1 1 1\nWIDTH %d\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            "POINTS %d\nDATA ascii\n" % (len(points), len(points))
        )
        for p in points:
            f.write("%.6f %.6f %.6f\n" % (p[0], p[1], p[2]))


def load_points(path: str) -> np.ndarray:
    """Load a point cloud by extension (.xyz/.txt/.ply/.pcd)."""
    if path.endswith(".ply"):
        return read_ply(path)
    if path.endswith(".pcd"):
        return read_pcd(path)
    return read_xyz(path)[:, :3]


def read_xyz(path: str) -> np.ndarray:
    """Whitespace-separated point file → (n, >=3) float32."""
    return np.loadtxt(path, dtype=np.float32)


def write_xyz(path: str, points: np.ndarray, fmt: str = "%.6f") -> None:
    """One point a line, ``fmt`` a coordinate (the reference's ``%.6f``)."""
    np.savetxt(path, np.asarray(points), fmt=fmt)


def mesh_face_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(f,) area of each triangle."""
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)


def sample_mesh_surface(
    verts: np.ndarray,
    faces: np.ndarray,
    n: int,
    seed: int = 0,
    return_faces: bool = False,
):
    """Area-weighted uniform surface samples (the disk seeds of the
    uniformity metric, as the CGAL evaluation binary draws them).  With
    ``return_faces`` also returns each sample's source face index (the
    ``Face_location`` analog for geodesic disks)."""
    rng = np.random.RandomState(seed)
    areas = mesh_face_areas(verts, faces)
    probs = areas / areas.sum()
    fi = rng.choice(len(faces), size=n, p=probs)
    u = rng.rand(n, 1)
    v = rng.rand(n, 1)
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    tri = verts[faces[fi]]
    pts = (
        tri[:, 0]
        + u * (tri[:, 1] - tri[:, 0])
        + v * (tri[:, 2] - tri[:, 0])
    ).astype(np.float32)
    if return_faces:
        return pts, fi.astype(np.int32)
    return pts
