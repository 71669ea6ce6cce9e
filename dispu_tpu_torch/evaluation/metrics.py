"""Evaluation metrics: CD/HD, point-to-face, uniformity (counterpart of
``evaluation/metrics.py``).

``cd_hd`` runs on the card through ``ops.chamfer.nn_distance``: each
direction's argmin is the kNN kernel at k = 1 where the other cloud has
64 to 4096 points (the JAX package's gate for its Pallas kNN), the plain
first-occurrence argmin otherwise.  The point-to-face distance is an
exact brute-force point-to-triangle minimum over all faces, plain torch
on the device as the JAX package computes it in XLA outside any kernel,
in chunks of 2048 faces (and of :data:`POINT_CHUNK` points, which bounds
device memory and changes no bit).  ``geodesic_distances`` and
``uniformity_measure`` are numpy and scipy on the host, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from dispu_tpu_torch.inference import resolve_device
from dispu_tpu_torch.ops.chamfer import nn_distance
from dispu_tpu_torch.ops.geometry import normalize_point_cloud

#: points a block of the point-to-face scan: ~30 (points × 2048)
#: intermediates of 4 bytes, about 1 GB at 4096
POINT_CHUNK = 4096


@torch.no_grad()
def cd_hd(pred: torch.Tensor, gt: torch.Tensor, impl: str = "auto"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chamfer + Hausdorff between two (n, 3) clouds, each normalized to
    the unit sphere: CD = mean(fwd) + mean(bwd) of the squared
    nearest-neighbour distances, HD = max(fwd) + max(bwd)."""
    pred_n, _, _ = normalize_point_cloud(pred[None])
    gt_n, _, _ = normalize_point_cloud(gt[None])
    fwd, _, bwd, _ = nn_distance(pred_n, gt_n, impl)
    cd = torch.mean(fwd) + torch.mean(bwd)
    hd = torch.max(fwd) + torch.max(bwd)
    return cd, hd


def _point_triangle_sq_dist(p, a, b, c):
    """Exact squared distance from points to triangles (Eberly's method),
    vectorized over a (points, faces) grid; (squared distance, nearest
    point)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    bp = p - b
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    cp = p - c
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = torch.clamp_min(va + vb + vc, 1e-30)
    v = vb / denom
    w = vc / denom
    # interior projection
    proj = a + v[..., None] * ab + w[..., None] * ac

    # edge/vertex regions
    t_ab = torch.clamp(d1 / torch.clamp_min(d1 - d3, 1e-30), 0.0, 1.0)
    p_ab = a + t_ab[..., None] * ab
    t_ac = torch.clamp(d2 / torch.clamp_min(d2 - d6, 1e-30), 0.0, 1.0)
    p_ac = a + t_ac[..., None] * ac
    t_bc = torch.clamp(
        (d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6), 1e-30), 0.0, 1.0)
    p_bc = b + t_bc[..., None] * (c - b)

    in_vertex_a = (d1 <= 0) & (d2 <= 0)
    in_vertex_b = (d3 >= 0) & (d4 <= d3)
    in_vertex_c = (d6 >= 0) & (d5 <= d6)
    in_edge_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_edge_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    nearest = proj
    nearest = torch.where(in_edge_bc[..., None], p_bc, nearest)
    nearest = torch.where(in_edge_ac[..., None], p_ac, nearest)
    nearest = torch.where(in_edge_ab[..., None], p_ab, nearest)
    nearest = torch.where(in_vertex_c[..., None], c, nearest)
    nearest = torch.where(in_vertex_b[..., None], b, nearest)
    nearest = torch.where(in_vertex_a[..., None], a, nearest)

    return torch.sum((p - nearest) ** 2, -1), nearest


def _first_argmin(d: torch.Tensor) -> torch.Tensor:
    """(rows,) index of each row's first minimum, or of its first NaN
    where it has one (``jnp.argmin``'s rule), on either device."""
    nan = torch.isnan(d)
    return torch.where(nan.any(1), nan.to(torch.uint8).argmax(1),
                       torch.argmin(d, 1))


@torch.no_grad()
def _p2f_chunked(points, tri_a, tri_b, tri_c, chunk: int = 2048,
                 point_chunk: int = POINT_CHUNK):
    """Min point-triangle distance over face chunks of ``chunk``: the
    first minimum within a chunk, a later chunk only where strictly
    nearer.  Returns (distance (n,), nearest point (n, 3), face (n,))."""
    n_faces = tri_a.shape[0]
    pad = (-n_faces) % chunk
    if pad:
        # pad with a far-away degenerate triangle
        far = torch.full((pad, 3), 1e6, dtype=tri_a.dtype,
                         device=tri_a.device)
        tri_a = torch.cat([tri_a, far])
        tri_b = torch.cat([tri_b, far])
        tri_c = torch.cat([tri_c, far])
    n = points.shape[0]
    best_d = torch.full((n,), math.inf, dtype=points.dtype,
                        device=points.device)
    best_p = torch.zeros_like(points)
    best_f = torch.zeros((n,), dtype=torch.int32, device=points.device)
    for lo in range(0, n, point_chunk):
        p = points[lo:lo + point_chunk, None, :]
        rows = torch.arange(p.shape[0], device=points.device)
        for f0 in range(0, tri_a.shape[0], chunk):
            d, nearest = _point_triangle_sq_dist(
                p, tri_a[None, f0:f0 + chunk], tri_b[None, f0:f0 + chunk],
                tri_c[None, f0:f0 + chunk])  # (points, chunk)
            idx = _first_argmin(d)
            dmin = d[rows, idx]
            better = dmin < best_d[lo:lo + point_chunk]
            best_d[lo:lo + point_chunk] = torch.where(
                better, dmin, best_d[lo:lo + point_chunk])
            best_p[lo:lo + point_chunk] = torch.where(
                better[:, None], nearest[rows, idx],
                best_p[lo:lo + point_chunk])
            best_f[lo:lo + point_chunk] = torch.where(
                better, (f0 + idx).to(torch.int32),
                best_f[lo:lo + point_chunk])
    return torch.sqrt(best_d), best_p, best_f


def point_to_mesh_distance(
    points: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    return_faces: bool = False,
    device="cuda",
):
    """Per-point distance to (and nearest point on) a triangle mesh, exact
    to f32: a brute-force scan over the faces on ``device``.

    Returns numpy (distances (n,), mapped_points (n, 3)), plus the nearest
    face index of each point when ``return_faces`` (the CGAL
    ``Face_location`` analog, needed for geodesic disks).
    """
    dev = resolve_device(device)
    points = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
    tri = torch.from_numpy(np.asarray(verts, np.float32)).to(dev)[
        torch.from_numpy(np.asarray(faces, np.int64)).to(dev)]
    d, p, f = _p2f_chunked(points, tri[:, 0], tri[:, 1], tri[:, 2])
    if return_faces:
        return d.cpu().numpy(), p.cpu().numpy(), f.cpu().numpy()
    return d.cpu().numpy(), p.cpu().numpy()


def geodesic_distances(
    verts: np.ndarray,
    faces: np.ndarray,
    seeds: np.ndarray,
    seed_faces: np.ndarray,
    points: np.ndarray,
    point_faces: np.ndarray,
) -> np.ndarray:
    """Approximate on-surface (geodesic) distances seed → point.

    Numpy and scipy on the host, a copy of the JAX package's.  The target
    is CGAL's ``Surface_mesh_shortest_path`` exact geodesics, as the
    reference evaluation binary walks them.  Approximation here:

    1. a vertex graph carrying (a) the triangulation edges and (b)
       *rhombus shortcuts* — for every pair of triangles sharing an edge,
       the two opposite vertices are connected with the straight-line
       length across the unfolded rhombus (added only when that segment
       actually crosses the shared edge, so shortcuts never undercut a
       true geodesic);
    2. per seed, a multi-source Dijkstra entering through the seed face's
       three vertices with exact euclidean lead-in lengths;
    3. per query point, barycentric interpolation of the vertex distance
       field inside the point's face — first-order accurate, which removes
       the O(edge-length) additive exit error a vertex-routed estimate
       suffers (that error is the size of the uniformity-disk radii on
       meshes of ~2.6k vertices);
    4. exact euclidean distance for same-face seed/point pairs.

    Returns (n_seeds, n_points) float32 distances.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    seeds = np.asarray(seeds, np.float64)
    points = np.asarray(points, np.float64)
    nv = verts.shape[0]
    ns = seeds.shape[0]

    # --- (1a) triangulation edges
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    w = np.linalg.norm(verts[e[:, 0]] - verts[e[:, 1]], axis=1)

    # --- (1b) rhombus shortcuts across each interior edge (vectorized:
    # the per-edge python loop cost ~11 s/mesh in tiny np.linalg.norm
    # calls; this computes all unfoldings in a handful of array ops).
    # e_all is (1a)'s edge list, ordered so row i's opposite vertex is
    # opp_all[i].
    e_all = e
    opp_all = np.concatenate([faces[:, 2], faces[:, 0], faces[:, 1]])
    ekey = (
        np.minimum(e_all[:, 0], e_all[:, 1]) * np.int64(nv)
        + np.maximum(e_all[:, 0], e_all[:, 1])
    )
    order = np.argsort(ekey, kind="stable")
    ks, opps_s, uvs = ekey[order], opp_all[order], e_all[order]
    # manifold interior edges appear exactly twice → adjacent after sort
    _, inv, cnt = np.unique(ks, return_inverse=True, return_counts=True)
    first_of_pair = np.nonzero(
        (ks[:-1] == ks[1:]) & (cnt[inv[:-1]] == 2)
    )[0]
    u = uvs[first_of_pair, 0]
    v = uvs[first_of_pair, 1]
    c = opps_s[first_of_pair]
    d = opps_s[first_of_pair + 1]
    # unfold both triangles into the plane: local x along u→v, opposite
    # vertices on ±y sides of the shared edge
    base = verts[v] - verts[u]
    blen = np.sqrt(np.sum(base * base, axis=1))
    safe = blen > 1e-12
    bx = base / np.maximum(blen, 1e-30)[:, None]
    rel_c = verts[c] - verts[u]
    rel_d = verts[d] - verts[u]
    xc = np.sum(rel_c * bx, axis=1)
    yc = np.sqrt(np.maximum(np.sum(rel_c * rel_c, 1) - xc * xc, 0.0))
    xd = np.sum(rel_d * bx, axis=1)
    yd = np.sqrt(np.maximum(np.sum(rel_d * rel_d, 1) - xd * xd, 0.0))
    denom = yc + yd
    safe &= denom > 1e-12
    cross_x = xc + (xd - xc) * yc / np.maximum(denom, 1e-30)
    # add the shortcut only when the straight segment actually crosses
    # the shared edge (it never undercuts a true geodesic then)
    hit = safe & (cross_x >= 0.0) & (cross_x <= blen)
    sc_rows = c[hit]
    sc_cols = d[hit]
    sc_w = np.hypot(xd - xc, yd + yc)[hit]

    # --- (2) augmentation: node nv+s is seed s, wired to its face verts
    sv = faces[np.asarray(seed_faces, np.int64)]          # (ns, 3)
    lead = np.linalg.norm(verts[sv] - seeds[:, None, :], axis=2)
    seed_rows = np.repeat(np.arange(ns) + nv, 3)
    aug_e = np.stack([seed_rows, sv.reshape(-1)], axis=1)

    sc_rows = np.asarray(sc_rows, np.int64)
    sc_cols = np.asarray(sc_cols, np.int64)
    sc_w = np.asarray(sc_w, np.float64)
    rows = np.concatenate(
        [e[:, 0], e[:, 1], sc_rows, sc_cols, aug_e[:, 0], aug_e[:, 1]]
    )
    cols = np.concatenate(
        [e[:, 1], e[:, 0], sc_cols, sc_rows, aug_e[:, 1], aug_e[:, 0]]
    )
    data = np.concatenate([w, w, sc_w, sc_w, lead.reshape(-1), lead.reshape(-1)])
    g = coo_matrix((data, (rows, cols)), shape=(nv + ns, nv + ns)).tocsr()

    dv = dijkstra(g, indices=np.arange(ns) + nv)[:, :nv]  # (ns, nv)

    # --- (3) barycentric interpolation inside each point's face
    pv = faces[np.asarray(point_faces, np.int64)]          # (np, 3)
    a, b, c = verts[pv[:, 0]], verts[pv[:, 1]], verts[pv[:, 2]]
    v0, v1, v2 = b - a, c - a, points - a
    d00 = np.sum(v0 * v0, 1)
    d01 = np.sum(v0 * v1, 1)
    d11 = np.sum(v1 * v1, 1)
    d20 = np.sum(v2 * v0, 1)
    d21 = np.sum(v2 * v1, 1)
    denom = np.maximum(d00 * d11 - d01 * d01, 1e-18)
    lb = np.clip((d11 * d20 - d01 * d21) / denom, 0.0, 1.0)
    lc = np.clip((d00 * d21 - d01 * d20) / denom, 0.0, 1.0)
    la = np.clip(1.0 - lb - lc, 0.0, 1.0)
    lam = np.stack([la, lb, lc], axis=1)                   # (np, 3)
    lam /= np.maximum(lam.sum(1, keepdims=True), 1e-12)
    # the (ns, np, 3) gathers dominate the tail — materialize once, in
    # f32 (the distance field is metric output, not graph weights; f32
    # keeps rel error ~1e-7 and halves ~25 large-array passes)
    dvp = dv[:, pv].astype(np.float32)                     # (ns, np, 3)
    d_interp = np.einsum(
        "snk,nk->sn", dvp, lam.astype(np.float32)
    )                                                      # (ns, np)
    # the vertex-exit route (graph + straight tail) is an upper bound; the
    # barycentric interpolation of a convex distance field also
    # overestimates — take the tighter of the two
    tail = np.linalg.norm(
        verts[pv] - points[:, None, :], axis=2
    ).astype(np.float32)                                   # (np, 3)
    d = np.minimum(d_interp, np.min(dvp + tail[None], axis=2))

    # --- (4) near-field: same-face / shared-vertex pairs use the exact
    # euclidean (= geodesic on a plane); within a couple of edge lengths
    # the surface is locally flat at the mesh's own resolution, so
    # euclidean is the better estimate than any vertex-routed path (which
    # carries an O(edge) additive error there).  The euclidean override
    # for non-adjacent pairs is gated on the graph estimate CONFIRMING
    # on-surface proximity (d < direct + 2·median-edge): on thin folded
    # geometry two sheets can sit closer through space than 2 edge lengths
    # while being far apart on-surface — there the graph distance stays
    # large and the override must not fire (the through-space shortcut
    # would report ~gap instead of the around-the-fold geodesic).
    direct = np.linalg.norm(
        seeds.astype(np.float32)[:, None, :]
        - points.astype(np.float32)[None, :, :],
        axis=2,
    )
    near = np.asarray(seed_faces)[:, None] == np.asarray(point_faces)[None]
    for i in range(3):
        sv_i = sv[:, i][:, None, None]                 # (ns, 1, 1)
        near |= np.any(pv[None] == sv_i, axis=2)
    med = 2.0 * float(np.median(w))
    near |= (direct < med) & (d < direct + med)
    return np.where(near, direct, d).astype(np.float32)


def uniformity_measure(
    mapped_points: np.ndarray,
    mesh_area: float,
    seeds: np.ndarray,
    percentages=(0.008, 0.012),
    seed_point_dists: np.ndarray | None = None,
) -> np.ndarray:
    """Disk-based uniformity χ² statistic.

    Host numpy, a copy of the JAX package's.  For each of ``len(seeds)``
    disks of radius
    √(area·p/π): coverage = (count − expected)²/expected; spacing deviation
    = mean((NN spacing − hexagon-ideal)²/ideal); measure = mean(coverage ·
    spacing) over disks.

    Disk membership uses ``seed_point_dists`` when given — pass
    :func:`geodesic_distances` output for the reference's geodesic disks
    (the default in ``evaluation.report``); otherwise euclidean disks (the
    fast approximation, exact on flat regions).
    """
    out = np.zeros((len(percentages), 1), np.float64)
    n = mapped_points.shape[0]
    if seed_point_dists is not None:
        d2_seed = np.asarray(seed_point_dists, np.float64) ** 2
    else:
        d2_seed = np.sum(
            (seeds[:, None, :] - mapped_points[None, :, :]) ** 2, -1
        )  # (s, n)
    for j, p in enumerate(percentages):
        radius = math.sqrt(mesh_area * p / math.pi)
        expected = p * n
        vals = []
        for s in range(seeds.shape[0]):
            members = np.where(d2_seed[s] < radius * radius)[0]
            density = len(members)
            coverage = (density - expected) ** 2 / expected
            if density < 5:
                continue
            disk = mapped_points[members]
            dd = np.sum((disk[:, None] - disk[None]) ** 2, -1)
            np.fill_diagonal(dd, np.inf)
            spacing = np.sqrt(dd.min(axis=1))
            disk_area = math.pi * radius**2 / density
            expect_d = math.sqrt(2 * disk_area / 1.732)  # hexagon ideal
            dev = np.mean((spacing - expect_d) ** 2 / expect_d)
            vals.append(coverage * dev)
        out[j, 0] = float(np.mean(vals)) if vals else float("nan")
    return out
