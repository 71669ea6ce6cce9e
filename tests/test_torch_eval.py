"""The port's evaluation stack against the JAX package's on the CPU: the
streaming NN distance, CD/HD, the point-to-face scan, the geodesic disks'
uniformity, the evaluation.csv report with its side files, and the
``python -m dispu_tpu_torch.evaluate`` command line.

The port runs with ``device="cpu"`` (the plain versions) and JAX on the
CPU.  Bounds, each stated where it is used:

- CD/HD: both packages pick each argmin on expansion-form distances and
  recompute the exact |p − q*|²; round-off may swap near-tied neighbours,
  which moves a mean or a max by about the expansion's round-off (~1e-7
  of the unit sphere's scale), and the means sum in other orders:
  ``CD_REL`` = 1e-5 relative.
- Point-to-face: XLA on the CPU contracts products into FMAs and torch
  does not, so distances and mapped points differ by round-off
  (``P2F_ABS`` = 1e-6 on unit-scale meshes, read ≤ 1.2e-7), and a face
  index may differ where JAX's own distances to the two faces are within
  ``P2F_ABS`` (points on shared edges); those are counted.
- The host half (geodesic distances, uniformity) is a copy of the JAX
  package's numpy: bit-equal on shared inputs.  Fed each package's own
  mapped points, the uniformity may move where a point's round-off
  crosses a disk's edge: ``UNIFORM_REL``.
"""

import csv
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dispu_tpu.evaluation import metrics as jm
from dispu_tpu.evaluation import report as jr
from dispu_tpu.ops.pallas_kernels import nn_distance_chunked as jax_chunked
from dispu_tpu_torch.data.meshgen import (normalize_mesh,
                                          poisson_disk_sample,
                                          superellipsoid, torus_knot_tube)
from dispu_tpu_torch.evaluation import metrics as tm
from dispu_tpu_torch.evaluation import report as tr
from dispu_tpu_torch.evaluation.meshio import (mesh_face_areas, read_xyz,
                                               sample_mesh_surface, write_off,
                                               write_xyz)
from dispu_tpu_torch.ops.chamfer import nn_distance_chunked
from test_geodesic import icosphere

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CD_REL = 1e-5
P2F_ABS = 1e-6
# one membership flip among ~40 members of one of 100 disks moves that
# disk's term by a few per cent and the mean by a few 1e-4; read 0
UNIFORM_REL = 1e-3


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ CD / HD


def test_nn_distance_chunked_matches_jax():
    """Chunks of 128 query rows, both directions, a ragged last chunk:
    indices equal (no near-ties in these draws), distances within 1e-6
    relative (the exact |p − q*|² summed in another order)."""
    a, b = _rand(0, 2, 1000, 3), _rand(1, 2, 700, 3)
    want = jax_chunked(jnp.asarray(a), jnp.asarray(b), chunk=128)
    got = nn_distance_chunked(torch.from_numpy(a), torch.from_numpy(b),
                              chunk=128)
    for w, g in zip(want[1::2], got[1::2]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    for w, g in zip(want[::2], got[::2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-12)


def _cd_hd_pair(pred, gt):
    want = [float(x) for x in jm.cd_hd(jnp.asarray(pred), jnp.asarray(gt))]
    got = [float(x) for x in tm.cd_hd(torch.from_numpy(pred),
                                      torch.from_numpy(gt))]
    return want, got


@pytest.mark.parametrize("n,m", [(300, 500), (2048, 512), (40, 4096)])
def test_cd_hd_matches_jax_on_random_clouds(n, m):
    want, got = _cd_hd_pair(_rand(n, n, 3) * 2.0 + 1.0, _rand(m + 1, m, 3))
    np.testing.assert_allclose(got, want, rtol=CD_REL)


@pytest.mark.parametrize("name", ["Icosahedron_X4", "Icosahedron_X16",
                                  "fandisk_X4", "fandisk_X16"])
def test_cd_hd_matches_jax_on_the_demo_outputs(name):
    pred = read_xyz(os.path.join(REPO, "demo", "outputs", name + ".xyz"))
    gt = read_xyz(os.path.join(REPO, "demo", "gt",
                               name.split("_X")[0] + ".xyz"))
    want, got = _cd_hd_pair(pred[:, :3], gt[:, :3])
    np.testing.assert_allclose(got, want, rtol=CD_REL)


# ------------------------------------------------------------ point to face


def _mesh_with_degenerate_faces():
    """icosphere(1) with three zero-area faces along edges of its first two
    faces: one with a duplicated vertex (a second vertex at the first
    vertex's place), one with a repeated index, and a sliver (its third
    vertex at the edge's f32 midpoint).  Returns (verts, faces, index of
    the sliver)."""
    verts, faces = icosphere(1)
    (a, b, c), (_, e, f) = faces[0], faces[1]
    verts = np.concatenate([verts, verts[a:a + 1],
                            0.5 * (verts[a:a + 1] + verts[b:b + 1])]).astype(
        np.float32)
    dup, mid = len(verts) - 2, len(verts) - 1
    faces = np.concatenate([faces[:10], [[a, dup, c], [e, e, f],
                                         [a, mid, b]], faces[10:]])
    return verts, faces.astype(np.int32), 12


def _probe_points(verts, faces, n, seed):
    """n points of each kind: on faces, on edges, at edge midpoints, at
    vertices, and off the surface (on-face points plus 0.02 noise)."""
    rs = np.random.RandomState(seed)
    tri = verts[faces[rs.randint(len(faces), size=n)]].astype(np.float64)
    u, v = rs.rand(n, 1), rs.rand(n, 1)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    on_face = tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (
        tri[:, 2] - tri[:, 0])
    on_edge = tri[:, 0] + rs.rand(n, 1) * (tri[:, 1] - tri[:, 0])
    mid = 0.5 * (tri[:, 1] + tri[:, 2])
    at_vertex = verts[rs.randint(len(verts), size=n)]
    off = on_face + rs.randn(n, 3) * 0.02
    return np.concatenate([on_face, on_edge, mid, at_vertex, off]).astype(
        np.float32)


def _jax_face_dist(points, verts, faces, face_idx):
    """JAX's own distance of each point to one face of the mesh."""
    tri = jnp.asarray(verts)[jnp.asarray(faces)][jnp.asarray(face_idx)]
    d, _ = jm._point_triangle_sq_dist(jnp.asarray(points), tri[:, 0],
                                      tri[:, 1], tri[:, 2])
    return np.sqrt(np.asarray(d))


def _hold_p2f(points, verts, faces, skip=None):
    """The port's point-to-face against JAX's: distances within P2F_ABS;
    face indices equal except at near-ties (JAX's own distances to both
    faces within P2F_ABS); mapped points within P2F_ABS where the faces
    are equal, and at a near-tie within dj + dt + P2F_ABS (each lies at
    its distance from the point: two faces meeting at a crease map a point
    near their bisector to points that far apart).  ``skip``: a mask of
    points left out.  Returns the number of near-tie face swaps."""
    dj, pj, fj = jm.point_to_mesh_distance(points, verts, faces,
                                           return_faces=True)
    dt, pt, ft = tm.point_to_mesh_distance(points, verts, faces,
                                           return_faces=True, device="cpu")
    assert dt.dtype == np.float32 and ft.dtype == np.int32
    assert pt.shape == points.shape and not np.isnan(dt).any()
    keep = np.ones(len(points), bool) if skip is None else ~skip
    np.testing.assert_allclose(dt[keep], dj[keep], rtol=0, atol=P2F_ABS)
    same = keep & (fj == ft)
    np.testing.assert_allclose(pt[same], pj[same], rtol=0, atol=P2F_ABS)
    swap = np.nonzero(keep & (fj != ft))[0]
    gap = np.abs(_jax_face_dist(points[swap], verts, faces, fj[swap])
                 - _jax_face_dist(points[swap], verts, faces, ft[swap]))
    assert (gap <= P2F_ABS).all(), gap.max()
    apart = np.linalg.norm(pt[swap] - pj[swap], axis=1)
    assert (apart <= dj[swap] + dt[swap] + P2F_ABS).all()
    return len(swap)


def _meshes():
    """Two meshgen shapes, unit-scale, at a quarter of the corpus's
    resolution (a superellipsoid with creases, a torus knot)."""
    shapes = {"superell": superellipsoid(0.4, 0.8, (1.0, 0.8, 0.6), nu=48,
                                         nv=64),
              "knot": torus_knot_tube(2, 3, 0.2, nu=128, nv=16)}
    return {name: (normalize_mesh(verts), faces)
            for name, (verts, faces) in shapes.items()}


@pytest.mark.parametrize("mesh", ["icosphere", "superell", "knot"])
def test_point_to_mesh_matches_jax(mesh):
    """Points on faces, edges and vertices and off the surface; the face
    swaps fall on shared edges and creases (read: 73, 33 and 48 of 1,000
    on the icosphere, the superellipsoid and the knot)."""
    verts, faces = icosphere(2) if mesh == "icosphere" else _meshes()[mesh]
    points = _probe_points(verts, faces, 200, 0)
    swaps = _hold_p2f(points, verts, faces)
    print(f"{mesh}: {swaps} near-tie face swaps of {len(points)} points")
    assert swaps < len(points) // 5


def test_point_to_mesh_on_degenerate_faces():
    """A duplicated vertex and a repeated index give exact zeros and
    denom = 1e-30: no NaN, and the port agrees with JAX at every point
    whose nearest face is neither's sliver.  The sliver's region tests
    read the signs of round-off (XLA's FMAs against torch's rounded
    products), so at a point that takes it either package's distance is
    its own (ROADMAP.md, queue 3): those points are counted, not held
    (read: 1 of 1,500, at an equal distance)."""
    verts, faces, sliver = _mesh_with_degenerate_faces()
    points = _probe_points(verts, faces, 300, 0)
    _, _, fj = jm.point_to_mesh_distance(points, verts, faces,
                                         return_faces=True)
    _, _, ft = tm.point_to_mesh_distance(points, verts, faces,
                                         return_faces=True, device="cpu")
    at_sliver = (fj == sliver) | (ft == sliver)
    assert at_sliver.sum() < len(points) // 10
    _hold_p2f(points, verts, faces, skip=at_sliver)


def test_point_to_mesh_nan_points_follow_jax():
    """A NaN point is NaN against every face: the first NaN is each
    chunk's argmin, never strictly nearer, so it keeps +inf, face 0 and a
    zero mapped point, as in JAX (``_first_argmin``'s rule)."""
    verts, faces = icosphere(2)
    points = _rand(3, 6, 3)
    points[[1, 4], 2] = np.nan
    want = jm.point_to_mesh_distance(points, verts, faces,
                                     return_faces=True)
    got = tm.point_to_mesh_distance(points, verts, faces, return_faces=True,
                                    device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=P2F_ABS)
    assert np.isinf(got[0][[1, 4]]).all() and (got[2][[1, 4]] == 0).all()


def test_point_chunks_change_no_bit():
    """The port's point blocks bound device memory only."""
    verts, faces = icosphere(2)
    points = torch.from_numpy(_probe_points(verts, faces, 60, 1))
    tri = torch.from_numpy(verts)[torch.from_numpy(faces).long()]
    whole = tm._p2f_chunked(points, tri[:, 0], tri[:, 1], tri[:, 2], 128)
    blocks = tm._p2f_chunked(points, tri[:, 0], tri[:, 1], tri[:, 2], 128,
                             point_chunk=7)
    for w, b in zip(whole, blocks):
        assert torch.equal(w, b)


# --------------------------------------------------------------- host half


def test_geodesic_and_uniformity_bit_equal_on_shared_inputs():
    verts, faces = icosphere(2)
    points = _rand(5, 400, 3)
    _, mapped, point_faces = jm.point_to_mesh_distance(points, verts, faces,
                                                       return_faces=True)
    mapped, point_faces = np.asarray(mapped), np.asarray(point_faces)
    seeds, seed_faces = sample_mesh_surface(verts, faces, 50,
                                            return_faces=True)
    want = jm.geodesic_distances(verts, faces, seeds, seed_faces, mapped,
                                 point_faces)
    got = tm.geodesic_distances(verts, faces, seeds, seed_faces, mapped,
                                point_faces)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    area = float(mesh_face_areas(verts, faces).sum())
    for dists in (want, None):
        np.testing.assert_array_equal(
            tm.uniformity_measure(mapped, area, seeds, tr.PERCENTAGES,
                                  seed_point_dists=dists),
            jm.uniformity_measure(mapped, area, seeds, jr.PERCENTAGES,
                                  seed_point_dists=dists))


# ------------------------------------------------------------------ report


N_PRED = 1024
DISK_SEEDS = 100


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """Two meshgen shapes with gt clouds made as the evaluation set's are
    (Poisson-disk sampling) and a 1,024-point prediction each (a Poisson
    sampling moved off the surface by 0.005 noise), in one prediction
    directory for each package (the side files land next to the
    predictions); each package's ``evaluate_dirs`` with 100 disk seeds and
    the side files."""
    root = tmp_path_factory.mktemp("eval")
    for sub in ("gt", "mesh", "pred_jax", "pred_torch"):
        (root / sub).mkdir()
    for k, (name, (verts, faces)) in enumerate(_meshes().items()):
        gt = poisson_disk_sample(verts, faces, 1024, seed=11)
        pred = poisson_disk_sample(verts, faces, N_PRED, seed=k) + _rand(
            k, N_PRED, 3) * 0.005
        write_xyz(str(root / "gt" / f"{name}.xyz"), gt)
        write_off(str(root / "mesh" / f"{name}.off"), verts, faces)
        for sub in ("pred_jax", "pred_torch"):
            write_xyz(str(root / sub / f"{name}_X4.xyz"), pred)
    summaries = {
        "jax": jr.evaluate_dirs(str(root / "pred_jax"), str(root / "gt"),
                                mesh_dir=str(root / "mesh"),
                                num_disk_seeds=DISK_SEEDS, dump_p2f=True),
        "torch": tr.evaluate_dirs(str(root / "pred_torch"),
                                  str(root / "gt"),
                                  mesh_dir=str(root / "mesh"),
                                  num_disk_seeds=DISK_SEEDS, dump_p2f=True,
                                  device="cpu")}
    return root, summaries


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _close(got, want, rel, what):
    assert math.isclose(got, want, rel_tol=rel, abs_tol=0.0), (what, got,
                                                               want)


def test_evaluate_dirs_matches_jax(eval_dirs):
    """The same header, names and summary row; CD, HD and the P2F
    statistics within ``CD_REL``; the uniformity within
    ``UNIFORM_REL``."""
    root, summaries = eval_dirs
    head_j, rows_j = _read_csv(root / "pred_jax" / "evaluation.csv")
    head_t, rows_t = _read_csv(root / "pred_torch" / "evaluation.csv")
    assert head_t == head_j == ["name", "CD", "hausdorff", "p2f avg",
                                "p2f std", "uniform_0", "uniform_1"]
    assert len(rows_t) == len(rows_j) == 3 and rows_t[-1][0] == "-"
    assert summaries["torch"].keys() == summaries["jax"].keys()
    for rj, rt in zip(rows_j, rows_t):
        assert rt[0] == rj[0]
        for col, (a, b) in enumerate(zip(rt[1:], rj[1:]), 1):
            rel = UNIFORM_REL if head_j[col].startswith("uniform") \
                else CD_REL
            _close(float(a), float(b), rel, (rt[0], head_j[col]))
    for key, value in summaries["torch"].items():
        assert float(rows_t[-1][head_t.index(key)]) == value


def _side(root, sub, name, kind):
    return root / sub / f"{name}_X4_{kind}.txt"


def _disk_lines(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def test_side_files_match_jax(eval_dirs):
    """The side files parse to the same numbers: the points and the seeds'
    barycentric coordinates and the radii text-equal, each P2F distance
    and mapped point within the %g format's six digits of JAX's; a disk
    membership differs only at points whose JAX geodesic distance lies
    within 1e-5 of the radius."""
    root, _ = eval_dirs
    for name, (verts, faces) in _meshes().items():
        for kind in ("radius", "sampling_seed"):
            assert (_side(root, "pred_torch", name, kind).read_text()
                    == _side(root, "pred_jax", name, kind).read_text())
        pj = np.loadtxt(_side(root, "pred_jax", name, "point2mesh_distance"))
        pt = np.loadtxt(_side(root, "pred_torch", name,
                              "point2mesh_distance"))
        assert pt.shape == pj.shape == (N_PRED, 7)
        np.testing.assert_array_equal(pt[:, :3], pj[:, :3])
        np.testing.assert_allclose(pt[:, 3:], pj[:, 3:], rtol=2e-5,
                                   atol=2 * P2F_ABS)
        # JAX's own geodesic distances, recomputed as evaluate_pair does
        pred = read_xyz(str(root / "pred_jax" / f"{name}_X4.xyz"))
        _, mapped, point_faces = jm.point_to_mesh_distance(
            pred, verts, faces, return_faces=True)
        seeds, seed_faces = sample_mesh_surface(verts, faces, DISK_SEEDS,
                                                return_faces=True)
        dists = jm.geodesic_distances(verts, faces, seeds, seed_faces,
                                      np.asarray(mapped),
                                      np.asarray(point_faces))
        radii = [float(r) for r in _side(root, "pred_jax", name,
                                         "radius").read_text().split()]
        lines_j = _disk_lines(_side(root, "pred_jax", name, "disk_idx"))
        lines_t = _disk_lines(_side(root, "pred_torch", name, "disk_idx"))
        assert len(lines_t) == len(lines_j) == DISK_SEEDS * len(radii)
        for i, (lj, lt) in enumerate(zip(lines_j, lines_t)):
            count_t, members_t = lt.split(":")
            members_j = {int(m) for m in lj.split(":")[1].split()}
            members_t = [int(m) for m in members_t.split()]
            assert int(count_t) == len(members_t)
            assert members_t == sorted(members_t)
            seed, r = divmod(i, len(radii))
            for m in members_j ^ set(members_t):
                assert abs(dists[seed, m] - radii[r]) <= 1e-5


def test_cli_twin_prints_evaluate_dirs_summary(eval_dirs, tmp_path):
    """``python -m dispu_tpu_torch.evaluate --device cpu`` exits 0, prints
    the summary JSON of its CSV's summary row, and agrees with
    ``evaluate_dirs`` run in this process to 1e-6 relative (the same code
    on the CPU; a process of its own may take other thread counts)."""
    root, summaries = eval_dirs
    out_csv = tmp_path / "cli.csv"
    args = ["--pred", str(root / "pred_torch"), "--gt", str(root / "gt"),
            "--mesh", str(root / "mesh"), "--out_csv", str(out_csv),
            "--disk_seeds", str(DISK_SEEDS), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "dispu_tpu_torch.evaluate",
                          *args], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    printed = json.loads(out.stdout)
    head, rows = _read_csv(out_csv)
    assert set(printed) == set(head[1:])
    for key, value in printed.items():
        assert float(rows[-1][head.index(key)]) == value
    assert printed.keys() == summaries["torch"].keys()
    for key, value in summaries["torch"].items():
        _close(printed[key], value, 1e-6, key)


def test_evaluation_refuses_cuda_without_a_card(eval_dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device path is moot")
    root, _ = eval_dirs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.evaluate_dirs(str(root / "pred_torch"), str(root / "gt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.point_to_mesh_distance(np.zeros((1, 3), np.float32),
                                  *icosphere(1))
