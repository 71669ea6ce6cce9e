"""Procedural mesh corpus, Poisson-disk sampling and patch-pair datasets
(counterpart of ``data/meshgen.py``, numpy on the host as there).

The PU-GAN training file holds pairs of Poisson-disk surface samplings
(256-point sparse, 1024-point dense) of patches cut from a mesh corpus.
This module builds such pairs from procedural triangle meshes: parametric
surfaces (superellipsoids, torus knots, surfaces of revolution with sharp
shoulders, twisted boxes, harmonically displaced spheres) and, in the
``'v2'`` set, convex polyhedra, CAD-style revolutions, thin plates and
thin shells, which span smooth regions, high curvature and sharp creases.
The evaluation set takes its meshes and its clouds from here too.

Per mesh: a dense Poisson-disk cloud and an independently sampled
quarter-density cloud; patch seeds by farthest-point sampling; each patch
pair is the seed's ``out_num`` nearest dense points (gt) and
``num_point`` nearest quarter-density points (input), so both cover the
same surface radius.  Patches are stored raw; the loader normalizes each.
Every draw takes ``np.random.RandomState`` streams in the JAX package's
order, so vertices, faces and samples are bit-equal to its.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# in the module's namespace, as in the JAX package's
from dispu_tpu_torch.data.dataset import normalize_point_cloud_np  # noqa: F401
from dispu_tpu_torch.evaluation.meshio import (mesh_face_areas,
                                               sample_mesh_surface)

Mesh = Tuple[np.ndarray, np.ndarray]  # (verts (v,3) f32, faces (f,3) i32)


# --------------------------------------------------------------------------
# Parametric mesh builders
# --------------------------------------------------------------------------

def _compact_mesh(verts: np.ndarray, faces: np.ndarray) -> Mesh:
    """Drop unreferenced vertices and remap ``faces`` accordingly."""
    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return verts[used], remap[faces]


def grid_mesh(
    grid: np.ndarray,
    wrap_u: bool = False,
    wrap_v: bool = False,
    compact: bool = True,
) -> Mesh:
    """Triangulate a (nu, nv, 3) parametric vertex grid.

    ``wrap_u``/``wrap_v`` close the surface along that axis (e.g. a torus
    wraps both).  Zero-area triangles (degenerate pole rows, pinched seams)
    are dropped, and unreferenced vertices compacted away.  Pass
    ``compact=False`` to keep the full vertex grid (grid index i*nv+j
    stays valid) when the caller still needs to append faces — e.g.
    :func:`revolution_surface`'s caps — and compact afterwards.
    """
    nu, nv, _ = grid.shape
    verts = grid.reshape(-1, 3).astype(np.float32)
    iu = np.arange(nu if wrap_u else nu - 1)
    jv = np.arange(nv if wrap_v else nv - 1)
    iu1 = (iu + 1) % nu
    jv1 = (jv + 1) % nv
    # vertex ids of each quad corner, (len(iu), len(jv))
    a = (iu[:, None] * nv + jv[None, :]).ravel()
    b = (iu1[:, None] * nv + jv[None, :]).ravel()
    c = (iu1[:, None] * nv + jv1[None, :]).ravel()
    d = (iu[:, None] * nv + jv1[None, :]).ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=0
    ).astype(np.int32)
    areas = mesh_face_areas(verts, faces)
    faces = faces[areas > 1e-12]
    if not compact:
        return verts, faces
    return _compact_mesh(verts, faces)


def _signed_pow(x: np.ndarray, e: float) -> np.ndarray:
    return np.sign(x) * np.abs(x) ** e


def superellipsoid(
    e1: float, e2: float, radii=(1.0, 1.0, 1.0), nu: int = 96, nv: int = 128
) -> Mesh:
    """Superellipsoid: e≈1 is an ellipsoid, e→0 boxy (sharp edges),
    e>1 pinched/octahedral."""
    u = np.linspace(-np.pi / 2, np.pi / 2, nu)
    v = np.linspace(-np.pi, np.pi, nv, endpoint=False)
    cu, su = np.cos(u)[:, None], np.sin(u)[:, None]
    cv, sv = np.cos(v)[None, :], np.sin(v)[None, :]
    x = radii[0] * _signed_pow(cu, e1) * _signed_pow(cv, e2)
    y = radii[1] * _signed_pow(cu, e1) * _signed_pow(sv, e2)
    z = radii[2] * _signed_pow(su, e1) * np.ones_like(cv)
    return grid_mesh(np.stack([x, y, z], -1), wrap_v=True)


def torus_knot_tube(
    p: int = 2,
    q: int = 3,
    tube_radius: float = 0.22,
    nu: int = 256,
    nv: int = 24,
) -> Mesh:
    """Tube of radius ``tube_radius`` swept along a (p, q) torus knot."""
    t = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    r = 0.6 + 0.35 * np.cos(q * t)
    curve = np.stack(
        [r * np.cos(p * t), r * np.sin(p * t), 0.35 * np.sin(q * t)], -1
    )
    # frame: tangent + two orthogonal vectors (Frenet-free, reference-vector
    # construction; fine because the tube never turns parallel to z+x)
    tang = np.roll(curve, -1, axis=0) - np.roll(curve, 1, axis=0)
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    ref = np.array([0.31, 0.47, 0.82])
    n1 = np.cross(tang, ref)
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    n2 = np.cross(tang, n1)
    phi = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    ring = (
        np.cos(phi)[None, :, None] * n1[:, None, :]
        + np.sin(phi)[None, :, None] * n2[:, None, :]
    )
    grid = curve[:, None, :] + tube_radius * ring
    return grid_mesh(grid, wrap_u=True, wrap_v=True)


def revolution_surface(
    profile_r: np.ndarray,
    profile_z: np.ndarray,
    nv: int = 128,
    close_caps: bool = True,
) -> Mesh:
    """Surface of revolution around z from a (r_i, z_i) polyline profile.

    Sharp shoulders in the profile (steps in r at nearly equal z) become
    circular creases — the CAD-like feature class fandisk exercises."""
    v = np.linspace(-np.pi, np.pi, nv, endpoint=False)
    x = profile_r[:, None] * np.cos(v)[None, :]
    y = profile_r[:, None] * np.sin(v)[None, :]
    z = np.broadcast_to(profile_z[:, None], x.shape)
    # Defer compaction: the cap rings below index the raw vertex grid
    # (row i vertex j = i*nv + j), which grid_mesh's compaction would
    # invalidate whenever a degenerate profile row drops faces.
    verts, faces = grid_mesh(
        np.stack([x, y, z], -1), wrap_v=True, compact=not close_caps
    )
    if close_caps:
        verts = np.concatenate(
            [verts,
             [[0.0, 0.0, profile_z[0]], [0.0, 0.0, profile_z[-1]]]],
        ).astype(np.float32)
        bot, top = len(verts) - 2, len(verts) - 1
        ring0 = np.arange(nv)
        ring1 = np.arange((len(profile_r) - 1) * nv, len(profile_r) * nv)
        cap0 = np.stack(
            [np.full(nv, bot), np.roll(ring0, -1), ring0], -1
        )
        cap1 = np.stack(
            [np.full(nv, top), ring1, np.roll(ring1, -1)], -1
        )
        faces = np.concatenate([faces, cap0, cap1]).astype(np.int32)
        areas = mesh_face_areas(verts, faces)
        faces = faces[areas > 1e-12]
        verts, faces = _compact_mesh(verts, faces)
    return verts, faces


def deformed_box(
    n: int = 48, twist: float = 0.8, taper: float = 0.5
) -> Mesh:
    """Subdivided cube surface with a z-twist and z-taper; the eight sharp
    edges survive the deformation (fandisk-like crease class)."""
    lin = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(lin, lin, indexing="ij"), -1)
    planes = []
    for axis in range(3):
        for s in (-1.0, 1.0):
            plane = np.zeros((n, n, 3))
            plane[..., axis] = s
            plane[..., (axis + 1) % 3] = g[..., 0]
            plane[..., (axis + 2) % 3] = g[..., 1] * s  # outward orientation
            planes.append(plane)
    verts_list, faces_list, off = [], [], 0
    for plane in planes:
        v, f = grid_mesh(plane)
        verts_list.append(v)
        faces_list.append(f + off)
        off += len(v)
    verts = np.concatenate(verts_list).astype(np.float32)
    faces = np.concatenate(faces_list).astype(np.int32)
    # weld duplicate seam vertices so the box is one connected surface
    key = np.round(verts / 1e-6).astype(np.int64)
    _, first, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = verts[first]
    faces = inverse[faces].astype(np.int32)
    # deform: taper then twist, both along z
    s = 1.0 + taper * 0.5 * (verts[:, 2] - 1.0) / 2.0
    x, y = verts[:, 0] * s, verts[:, 1] * s
    ang = twist * verts[:, 2]
    ca, sa = np.cos(ang), np.sin(ang)
    out = np.stack([x * ca - y * sa, x * sa + y * ca, verts[:, 2]], -1)
    out = out.astype(np.float32)
    areas = mesh_face_areas(out, faces)
    return out, faces[areas > 1e-12]


def harmonic_sphere(
    coeffs: Sequence[Tuple[int, int, float]], nu: int = 96, nv: int = 128
) -> Mesh:
    """Sphere with a radial displacement field of low-order (ku, kv)
    angular harmonics — smooth blobby shapes with varied curvature."""
    u = np.linspace(-np.pi / 2, np.pi / 2, nu)
    v = np.linspace(-np.pi, np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = np.ones_like(uu)
    for ku, kv, a in coeffs:
        r = r + a * np.sin(ku * uu) * np.cos(kv * vv)
    x = r * np.cos(uu) * np.cos(vv)
    y = r * np.cos(uu) * np.sin(vv)
    z = r * np.sin(uu)
    return grid_mesh(np.stack([x, y, z], -1), wrap_v=True)


def convex_polyhedron(
    m: int = 10, radii_low: float = 0.55, radii_high: float = 1.0,
    rng: Optional[np.random.RandomState] = None,
) -> Mesh:
    """Convex hull of ``m`` random radial points: large FLAT facets joined
    at sharp dihedral edges — the Icosahedron-like class the v1 families
    lack.  Small ``m`` (6-16) keeps the facets large like a platonic solid
    rather than sphere-like."""
    from scipy.spatial import ConvexHull

    rng = rng or np.random.RandomState(0)
    dirs = rng.randn(m, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = dirs * rng.uniform(radii_low, radii_high, (m, 1))
    hull = ConvexHull(pts)
    verts = pts[hull.vertices].astype(np.float32)
    remap = np.full(m, -1, np.int64)
    remap[hull.vertices] = np.arange(len(hull.vertices))
    faces = remap[hull.simplices].astype(np.int32)
    # orient every facet outward (Qhull simplices are unordered)
    centroid = verts.mean(axis=0)
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("fc,fc->f", n, tri.mean(axis=1) - centroid) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces


def _round_corners(
    poly: np.ndarray,
    modes: Sequence[str],
    trim: float = 0.08,
    arc_pts: int = 9,
) -> np.ndarray:
    """Replace interior corners of a 2D polyline with CAD transitions.

    ``modes[i]`` handles corner ``poly[i+1]``: 'sharp' keeps it, 'chamfer'
    cuts a straight bevel, 'fillet' inserts a tangent-continuous quadratic
    arc (the Bezier with the corner as control point — a fillet for the
    rectilinear profiles used here).  ``trim`` is the setback along each
    edge, clipped to 45% of the shorter adjacent edge so consecutive
    rounded corners never overlap."""
    out = [poly[0]]
    for i, mode in enumerate(modes):
        prev_pt, corner, next_pt = poly[i], poly[i + 1], poly[i + 2]
        e1, e2 = corner - prev_pt, next_pt - corner
        l1, l2 = np.linalg.norm(e1), np.linalg.norm(e2)
        if mode == "sharp" or min(l1, l2) < 1e-9:
            out.append(corner)
            continue
        t = min(trim, 0.45 * l1, 0.45 * l2)
        a = corner - e1 / l1 * t
        b = corner + e2 / l2 * t
        if mode == "chamfer":
            out.extend([a, b])
        else:  # fillet
            s = np.linspace(0.0, 1.0, arc_pts)[:, None]
            out.extend((1 - s) ** 2 * a + 2 * s * (1 - s) * corner + s**2 * b)
    out.append(poly[-1])
    return np.asarray(out, np.float64)


def cad_revolution(
    rng: Optional[np.random.RandomState] = None,
    n_steps: int = 4,
    nv: int = 128,
) -> Mesh:
    """Solid of revolution with CAD-style transitions: a rectilinear
    stepped (r, z) profile whose shoulders are a random mix of sharp
    corners, 45° chamfers, and fillets — the fandisk feature class
    (fillets + chamfers) the v1 families lack."""
    rng = rng or np.random.RandomState(0)
    r = rng.uniform(0.35, 0.7)
    pts = [(1e-4, 0.0), (r, 0.0)]
    z = 0.0
    for _ in range(n_steps):
        h = rng.uniform(0.25, 0.5)
        z += h
        pts.append((r, z))
        # step direction chosen away from the clip bounds so the radius
        # always moves (a saturated clip would create a zero-length edge)
        sign = 1.0 if r < 0.33 else (-1.0 if r > 0.82 else rng.choice([-1.0, 1.0]))
        r = float(np.clip(r + sign * rng.uniform(0.12, 0.3), 0.2, 0.95))
        pts.append((r, z))
    z += rng.uniform(0.2, 0.4)
    pts.extend([(r, z), (1e-4, z)])
    poly = np.asarray(pts, np.float64)
    modes = [rng.choice(["sharp", "chamfer", "fillet"])
             for _ in range(len(poly) - 2)]
    rounded = _round_corners(poly, modes, trim=rng.uniform(0.05, 0.1))
    # subdivide long straight runs so revolve faces stay well-shaped
    fine = [rounded[0]]
    for k in range(len(rounded) - 1):
        seg = rounded[k + 1] - rounded[k]
        n_sub = max(1, int(np.ceil(np.linalg.norm(seg) / 0.05)))
        for s in range(1, n_sub + 1):
            fine.append(rounded[k] + seg * (s / n_sub))
    prof = np.asarray(fine)
    return revolution_surface(
        np.maximum(prof[:, 0], 1e-4), prof[:, 1], nv=nv, close_caps=False
    )


def thin_plate(
    rng: Optional[np.random.RandomState] = None, n: int = 48
) -> Mesh:
    """Thin rectangular plate (sharp thin edges + two large flat faces) —
    the thin-feature class.  Thickness 2-6% of the span; a mild z-twist
    keeps the two big faces from being exactly parallel planes."""
    rng = rng or np.random.RandomState(0)
    scale = np.array(
        [1.0, rng.uniform(0.45, 1.0), rng.uniform(0.02, 0.06)], np.float32
    )
    verts, faces = deformed_box(n=n, twist=0.0, taper=0.0)
    verts = verts * scale
    ang = rng.uniform(0.0, 0.5) * verts[:, 0]  # twist about the long axis
    ca, sa = np.cos(ang), np.sin(ang)
    y, z = verts[:, 1], verts[:, 2]
    out = np.stack([verts[:, 0], y * ca - z * sa, y * sa + z * ca], -1)
    out = out.astype(np.float32)
    areas = mesh_face_areas(out, faces)
    return out, faces[areas > 1e-12]


def thin_shell(
    rng: Optional[np.random.RandomState] = None, nv: int = 128
) -> Mesh:
    """Thin-walled open cup/tube by revolution: outer wall up, over the
    rim, inner wall down — wall thickness 4-9% of the radius, with the
    rim corners filleted.  Opposite-side surfaces sit closer than a patch
    radius, the property that makes thin scanned parts hard."""
    rng = rng or np.random.RandomState(0)
    r_out = rng.uniform(0.55, 0.85)
    h = rng.uniform(0.8, 1.4)
    w = rng.uniform(0.04, 0.09)
    taper = rng.uniform(0.0, 0.2)  # optional conical outer wall
    r_bot = r_out + 0.15 * taper
    r_in, r_in_bot = r_out - w, r_bot - w
    pts = [
        (1e-4, 0.0), (r_bot, 0.0),          # flat outer bottom
        (r_out, h), (r_in, h),              # up the outer wall, over the rim
        (r_in_bot, w), (1e-4, w),           # down the inner wall, inner floor
    ]
    poly = np.asarray(pts, np.float64)
    modes = ["sharp"] * (len(poly) - 2)
    # fillet the two rim corners (indices of (r_out, h) and (r_in, h))
    modes[1] = modes[2] = "fillet"
    rounded = _round_corners(poly, modes, trim=min(0.45 * w, 0.05))
    fine = [rounded[0]]
    for k in range(len(rounded) - 1):
        seg = rounded[k + 1] - rounded[k]
        n_sub = max(1, int(np.ceil(np.linalg.norm(seg) / 0.04)))
        for s in range(1, n_sub + 1):
            fine.append(rounded[k] + seg * (s / n_sub))
    prof = np.asarray(fine)
    return revolution_surface(
        np.maximum(prof[:, 0], 1e-4), prof[:, 1], nv=nv, close_caps=False
    )


def normalize_mesh(verts: np.ndarray) -> np.ndarray:
    """Center + scale to the unit sphere (the per-cloud normalization
    applied at mesh level)."""
    c = verts.mean(axis=0, keepdims=True)
    v = verts - c
    return (v / np.linalg.norm(v, axis=-1).max()).astype(np.float32)


# v2 family cycle (13 slots): the five v1 families plus four classes
# they lack, at ~62% of draws — flat-faceted polyhedra ('poly'),
# CAD fillet/chamfer revolutions ('fillet'), thin plates ('plate'), and
# thin-walled shells ('shell').
_V2_CYCLE = (
    "superell", "poly", "knot", "fillet", "revolve", "plate", "box",
    "shell", "blob", "poly", "fillet", "plate", "shell",
)


def make_corpus(
    n_shapes: int, seed: int = 0, families: str = "v1"
) -> List[Tuple[str, Mesh]]:
    """Deterministic procedural corpus cycling the shape families.

    ``families='v1'`` is the five-family cycle (the evaluation set is
    drawn from it); ``'v2'`` adds the
    four new classes via :data:`_V2_CYCLE`."""
    if families not in ("v1", "v2"):
        raise ValueError(f"unknown corpus family set {families!r}")
    rng = np.random.RandomState(seed)
    out: List[Tuple[str, Mesh]] = []
    for i in range(n_shapes):
        if families == "v2":
            kind = _V2_CYCLE[i % len(_V2_CYCLE)]
            if kind == "poly":
                mesh = convex_polyhedron(m=rng.randint(6, 17), rng=rng)
                name = f"poly_{i:03d}"
            elif kind == "fillet":
                mesh = cad_revolution(rng=rng, n_steps=rng.randint(3, 6))
                name = f"fillet_{i:03d}"
            elif kind == "plate":
                mesh = thin_plate(rng=rng)
                name = f"plate_{i:03d}"
            elif kind == "shell":
                mesh = thin_shell(rng=rng)
                name = f"shell_{i:03d}"
            else:
                fam = ("superell", "knot", "revolve", "box", "blob").index(kind)
                mesh, name = _v1_shape(fam, i, rng)
            verts, faces = mesh
            out.append((name, (normalize_mesh(verts), faces)))
            continue
        fam = i % 5
        mesh, name = _v1_shape(fam, i, rng)
        verts, faces = mesh
        out.append((name, (normalize_mesh(verts), faces)))
    return out


def _v1_shape(
    fam: int, i: int, rng: np.random.RandomState
) -> Tuple[Mesh, str]:
    """One draw from the v1 five-family cycle (rng order preserved)."""
    if fam == 0:
        e1 = rng.uniform(0.2, 1.6)
        e2 = rng.uniform(0.2, 1.6)
        radii = rng.uniform(0.5, 1.0, 3)
        mesh = superellipsoid(e1, e2, radii)
        name = f"superell_{i:02d}"
    elif fam == 1:
        p, q = [(2, 3), (3, 2), (2, 5), (3, 4)][i % 4]
        mesh = torus_knot_tube(p, q, tube_radius=rng.uniform(0.12, 0.26))
        name = f"knot{p}{q}_{i:02d}"
    elif fam == 2:
        n_seg = rng.randint(4, 7)
        # piecewise profile with sharp shoulders: alternate slanted
        # segments and abrupt radius steps
        zs, rs = [0.0], [rng.uniform(0.3, 0.6)]
        for _ in range(n_seg):
            zs.append(zs[-1] + rng.uniform(0.15, 0.4))
            rs.append(np.clip(rs[-1] + rng.uniform(-0.25, 0.25), 0.15, 1.0))
            if rng.rand() < 0.5:  # sharp shoulder (crease)
                zs.append(zs[-1] + 1e-3)
                rs.append(np.clip(rs[-1] + rng.choice([-1, 1])
                                  * rng.uniform(0.1, 0.3), 0.15, 1.0))
        pr = np.array([1e-4] + rs + [1e-4])
        pz = np.array([zs[0]] + zs + [zs[-1]])
        # refine: subdivide each segment so faces stay well-shaped
        fine_r, fine_z = [], []
        for k in range(len(pr) - 1):
            t = np.linspace(0, 1, 8, endpoint=False)
            fine_r.extend(pr[k] + t * (pr[k + 1] - pr[k]))
            fine_z.extend(pz[k] + t * (pz[k + 1] - pz[k]))
        fine_r.append(pr[-1])
        fine_z.append(pz[-1])
        mesh = revolution_surface(
            np.asarray(fine_r), np.asarray(fine_z), close_caps=False
        )
        name = f"revolve_{i:02d}"
    elif fam == 3:
        mesh = deformed_box(
            twist=rng.uniform(0.3, 1.2), taper=rng.uniform(0.0, 0.8)
        )
        name = f"box_{i:02d}"
    else:
        coeffs = [
            (rng.randint(1, 4), rng.randint(0, 5), rng.uniform(0.05, 0.22))
            for _ in range(3)
        ]
        mesh = harmonic_sphere(coeffs)
        name = f"blob_{i:02d}"
    return mesh, name


# --------------------------------------------------------------------------
# Poisson-disk surface sampling
# --------------------------------------------------------------------------

def poisson_disk_sample(
    verts: np.ndarray,
    faces: np.ndarray,
    n: int,
    seed: int = 0,
    candidate_factor: int = 10,
) -> np.ndarray:
    """Blue-noise surface sampling by dart throwing with a spatial hash.

    Candidates are area-weighted uniform surface samples in random order;
    a candidate is accepted iff no earlier accepted point lies within the
    disk radius ``d``.  ``d`` starts at the packing-efficiency estimate
    for ``~1.15 n`` accepted points and shrinks (×0.85) until at least
    ``n`` darts land; a uniform-random subset of an r-disk set is still an
    r-disk set, so truncation to exactly ``n`` preserves the minimum
    spacing.  This is the CGAL/Meshlab Poisson-disk analog used to rebuild
    the PU-GAN training pairs.
    """
    rng = np.random.RandomState(seed)
    cands = sample_mesh_surface(verts, faces, candidate_factor * n, seed=seed + 1)
    rng.shuffle(cands)
    area = float(mesh_face_areas(verts, faces).sum())
    # random dart packing reaches ~0.54 of plane coverage; solve for d
    d = np.sqrt(area * 0.54 * 4 / (np.pi * 1.15 * n))
    for _ in range(8):
        accepted = _dart_throw(cands, d)
        if len(accepted) >= n:
            return accepted[rng.permutation(len(accepted))[:n]]
        d *= 0.85
    # pathological surface (heavily self-intersecting): fall back to
    # whatever spacing was reachable, topped up with leftover candidates
    extra = cands[~_member_mask(cands, accepted)][: n - len(accepted)]
    return np.concatenate([accepted, extra])[:n]


def _member_mask(cands: np.ndarray, accepted: np.ndarray) -> np.ndarray:
    view = {tuple(p) for p in accepted}
    return np.fromiter(
        (tuple(p) in view for p in cands), bool, count=len(cands)
    )


def _dart_throw(cands: np.ndarray, d: float) -> np.ndarray:
    """Sequential dart throwing over a cell-size-``d`` spatial hash."""
    inv = 1.0 / d
    d2 = d * d
    grid: Dict[Tuple[int, int, int], List[int]] = {}
    accepted: List[int] = []
    cells = np.floor(cands * inv).astype(np.int64)
    for i in range(len(cands)):
        cx, cy, cz = cells[i]
        p = cands[i]
        ok = True
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    for j in grid.get((cx + ox, cy + oy, cz + oz), ()):
                        q = cands[j]
                        dx = p[0] - q[0]
                        dy = p[1] - q[1]
                        dz = p[2] - q[2]
                        if dx * dx + dy * dy + dz * dz < d2:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            grid.setdefault((cx, cy, cz), []).append(i)
            accepted.append(i)
    return cands[accepted]


def fps_numpy(points: np.ndarray, m: int, seed_index: int = 0) -> np.ndarray:
    """Greedy farthest-point sampling (indices), numpy host version.

    Same seed-0 semantics as the FPS kernels."""
    n = len(points)
    idx = np.empty(m, np.int64)
    idx[0] = seed_index
    dist = np.sum((points - points[seed_index]) ** 2, axis=-1)
    for k in range(1, m):
        idx[k] = int(np.argmax(dist))
        dist = np.minimum(
            dist, np.sum((points - points[idx[k]]) ** 2, axis=-1)
        )
    return idx


# --------------------------------------------------------------------------
# Patch-pair dataset
# --------------------------------------------------------------------------

def mesh_patch_pairs(
    verts: np.ndarray,
    faces: np.ndarray,
    patches: int,
    num_point: int = 256,
    up_ratio: int = 4,
    coverage: float = 1.0 / 24.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Poisson-disk patch pairs from one mesh.

    Returns (inputs (p, num_point, 3), gt (p, num_point*up_ratio, 3)), raw
    coordinates.  The dense cloud has ``out_num / coverage`` points so each
    gt patch spans ``coverage`` of the surface; the input cloud is an
    INDEPENDENT Poisson sampling at exactly 1/up_ratio density, so an input
    patch covers the same radius with num_point points — the property the
    PUGAN pairs have (the 256 cloud is not a subset of the 1024 one).
    """
    out_num = num_point * up_ratio
    n_dense = int(round(out_num / coverage))
    dense_gt = poisson_disk_sample(verts, faces, n_dense, seed=seed)
    dense_in = poisson_disk_sample(
        verts, faces, n_dense // up_ratio, seed=seed + 7919
    )
    seeds = dense_gt[fps_numpy(dense_gt, patches)]
    # (patches, n_dense) squared distances — small enough to do dense
    d_gt = np.sum((seeds[:, None] - dense_gt[None]) ** 2, axis=-1)
    d_in = np.sum((seeds[:, None] - dense_in[None]) ** 2, axis=-1)
    gt_idx = np.argpartition(d_gt, out_num - 1, axis=1)[:, :out_num]
    in_idx = np.argpartition(d_in, num_point - 1, axis=1)[:, :num_point]
    return dense_in[in_idx].astype(np.float32), dense_gt[gt_idx].astype(
        np.float32
    )


def build_h5_dataset(
    out_path: str,
    meshes: Sequence[Tuple[str, Mesh]],
    patches_per_mesh: int = 100,
    num_point: int = 256,
    up_ratio: int = 4,
    coverage: float = 1.0 / 24.0,
    seed: int = 0,
    verbose: bool = True,
) -> Tuple[int, List[str]]:
    """Build the PUGAN-layout h5 (keys ``poisson_{num_point}`` and
    ``poisson_{num_point*up_ratio}``) from a mesh list.

    Returns (total patches, per-mesh names).  Deterministic in ``seed``.
    Needs ``h5py``, imported here."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("build_h5_dataset needs the h5py package") from e

    all_in, all_gt, names = [], [], []
    for k, (name, (verts, faces)) in enumerate(meshes):
        pin, pgt = mesh_patch_pairs(
            verts, faces, patches_per_mesh, num_point=num_point,
            up_ratio=up_ratio, coverage=coverage, seed=seed + 1000 * k,
        )
        all_in.append(pin)
        all_gt.append(pgt)
        names.append(name)
        if verbose:
            print(f"[{k + 1}/{len(meshes)}] {name}: "
                  f"{len(pin)} patches", flush=True)
    inputs = np.concatenate(all_in)
    gt = np.concatenate(all_gt)
    with h5py.File(out_path, "w") as f:
        f.create_dataset(f"poisson_{num_point}", data=inputs)
        f.create_dataset(f"poisson_{num_point * up_ratio}", data=gt)
        f.attrs["meshes"] = ",".join(names)
        f.attrs["seed"] = seed
        f.attrs["coverage"] = coverage
    return len(inputs), names
