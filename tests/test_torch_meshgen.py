"""The port's mesh generator and mesh / point-cloud files against the JAX
package's on the CPU.

Both are host numpy in both packages, so the contract is bit-equality:
the same files read to the same arrays whichever package wrote them, and
every shape family, corpus, Poisson-disk sample, FPS and patch pair is
bit-equal to the JAX package's.
"""

import builtins

import numpy as np
import pytest

from dispu_tpu.data import meshgen as jmg
from dispu_tpu.evaluation import meshio as jio
from dispu_tpu_torch.data import meshgen as tmg
from dispu_tpu_torch.evaluation import meshio as tio


def _points(n=50, seed=0):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


def _assert_same_tree(a, b):
    """Arrays (or tuples / lists / dicts of them) equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _assert_same_tree(a[key], b[key])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _write_binary_ply(path, pts, normals):
    """A binary_little_endian PLY of float x y z nx ny nz and a uchar
    column, the layout scanners write (neither package writes binary)."""
    rows = np.zeros(len(pts), dtype=[("x", "<f4"), ("y", "<f4"),
                                     ("z", "<f4"), ("nx", "<f4"),
                                     ("ny", "<f4"), ("nz", "<f4"),
                                     ("quality", "u1")])
    for i, c in enumerate("xyz"):
        rows[c] = pts[:, i]
        rows["n" + c] = normals[:, i]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(pts)}\n"
              + "".join(f"property float {c}\n"
                        for c in ("x", "y", "z", "nx", "ny", "nz"))
              + "property uchar quality\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rows.tobytes())


# each format: write with one package, read with both, for either writer
FORMATS = ["off", "ply", "ply_attrs", "pcd", "xyz"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_files_round_trip_between_packages(tmp_path, fmt, writer):
    mod = jio if writer == "jax" else tio
    pts = _points()
    normals = _points(seed=1)
    colors = np.random.RandomState(2).randint(0, 256, (50, 3))
    if fmt == "off":
        verts, faces = tmg.superellipsoid(0.8, 0.8, nu=8, nv=12)
        path = str(tmp_path / "m.off")
        mod.write_off(path, verts, faces)
        read = [m.read_off(path) for m in (jio, tio)]
        np.testing.assert_allclose(read[1][0], verts, atol=1e-6)
        np.testing.assert_array_equal(read[1][1], faces)
    elif fmt == "ply":
        path = str(tmp_path / "p.ply")
        mod.write_ply(path, pts)
        read = [(m.read_ply(path), m.load_points(path)) for m in (jio, tio)]
    elif fmt == "ply_attrs":
        path = str(tmp_path / "p.ply")
        mod.write_ply(path, pts, normals=normals, colors=colors)
        read = [m.read_ply(path, return_attributes=True) for m in (jio, tio)]
        assert set(read[1][1]) == {"normals", "colors"}
    elif fmt == "pcd":
        path = str(tmp_path / "p.pcd")
        mod.save_pcd(path, pts)
        read = [(m.read_pcd(path), m.load_points(path)) for m in (jio, tio)]
    else:
        path = str(tmp_path / "p.xyz")
        mod.write_xyz(path, pts)
        read = [(m.read_xyz(path), m.load_points(path)) for m in (jio, tio)]
    if fmt != "off":  # the points the port read are the ones written
        np.testing.assert_allclose(read[1][0], pts, atol=1e-6)
    _assert_same_tree(read[0], read[1])


def test_binary_ply_and_pcd_read_the_same(tmp_path):
    """The binary forms, which neither package writes, read alike."""
    pts, normals = _points(), _points(seed=1)
    ply = str(tmp_path / "b.ply")
    _write_binary_ply(ply, pts, normals)
    _assert_same_tree(jio.read_ply(ply, return_attributes=True),
                      tio.read_ply(ply, return_attributes=True))
    np.testing.assert_array_equal(tio.read_ply(ply), pts)
    pcd = str(tmp_path / "b.pcd")
    with open(pcd, "wb") as f:
        f.write(b"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                b"COUNT 1 1 1\nWIDTH 50\nHEIGHT 1\nPOINTS 50\nDATA binary\n")
        f.write(pts.astype("<f4").tobytes())
    _assert_same_tree(jio.read_pcd(pcd), tio.read_pcd(pcd))
    np.testing.assert_array_equal(tio.read_pcd(pcd), pts)


def test_face_areas_and_surface_samples_bit_equal():
    verts, faces = tmg.harmonic_sphere([(2, 3, 0.15)], nu=24, nv=32)
    _assert_same_tree(jio.mesh_face_areas(verts, faces),
                      tio.mesh_face_areas(verts, faces))
    for seed in (0, 7):
        _assert_same_tree(
            jio.sample_mesh_surface(verts, faces, 300, seed=seed,
                                    return_faces=True),
            tio.sample_mesh_surface(verts, faces, 300, seed=seed,
                                    return_faces=True))
        _assert_same_tree(jio.sample_mesh_surface(verts, faces, 300, seed),
                          tio.sample_mesh_surface(verts, faces, 300, seed))


PROFILE = (np.array([1e-4, 0.5, 0.5, 0.8, 0.8, 0.3, 1e-4]),
           np.array([0.0, 0.0, 0.4, 0.4001, 0.8, 1.0, 1.0]))
FAMILIES = {
    "superellipsoid": lambda m: m.superellipsoid(0.3, 0.6, (1.0, 0.7, 0.5),
                                                 nu=24, nv=32),
    "torus_knot_tube": lambda m: m.torus_knot_tube(3, 2, 0.2, nu=64, nv=12),
    "revolution_caps": lambda m: m.revolution_surface(*PROFILE, nv=32),
    "revolution_open": lambda m: m.revolution_surface(*PROFILE, nv=32,
                                                      close_caps=False),
    "deformed_box": lambda m: m.deformed_box(n=12, twist=1.0, taper=0.6),
    "harmonic_sphere": lambda m: m.harmonic_sphere(
        [(2, 3, 0.15), (1, 0, 0.1)], nu=24, nv=32),
    "convex_polyhedron": lambda m: m.convex_polyhedron(
        m=12, rng=np.random.RandomState(4)),
    "cad_revolution": lambda m: m.cad_revolution(
        rng=np.random.RandomState(5), nv=32),
    "thin_plate": lambda m: m.thin_plate(rng=np.random.RandomState(6), n=12),
    "thin_shell": lambda m: m.thin_shell(rng=np.random.RandomState(7),
                                         nv=32),
    "grid_mesh_torus": lambda m: m.grid_mesh(
        np.random.RandomState(8).randn(6, 7, 3), wrap_u=True, wrap_v=True),
    "round_corners": lambda m: m._round_corners(
        np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [2.0, 1.0],
                  [2.0, 1.0], [3.0, 2.0]]),
        ["sharp", "chamfer", "fillet", "fillet"], trim=0.1),
    "normalize_mesh": lambda m: m.normalize_mesh(_points(40)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shape_families_bit_equal(family):
    _assert_same_tree(FAMILIES[family](jmg), FAMILIES[family](tmg))


@pytest.mark.parametrize("families,n", [("v1", 5), ("v2", 13)])
def test_make_corpus_bit_equal(families, n):
    jc = jmg.make_corpus(n, seed=11, families=families)
    tc = tmg.make_corpus(n, seed=11, families=families)
    assert [name for name, _ in jc] == [name for name, _ in tc]
    _assert_same_tree([mesh for _, mesh in jc], [mesh for _, mesh in tc])


def test_make_corpus_refuses_unknown_family_set():
    with pytest.raises(ValueError, match="v3"):
        tmg.make_corpus(1, families="v3")


def test_poisson_fps_and_patch_pairs_bit_equal():
    verts, faces = tmg.harmonic_sphere([(1, 2, 0.12)], nu=32, nv=48)
    verts = tmg.normalize_mesh(verts)
    for n, seed in ((256, 0), (300, 9)):
        _assert_same_tree(jmg.poisson_disk_sample(verts, faces, n, seed),
                          tmg.poisson_disk_sample(verts, faces, n, seed))
    pts = _points(128)
    for seed_index in (0, 17):
        _assert_same_tree(jmg.fps_numpy(pts, 16, seed_index),
                          tmg.fps_numpy(pts, 16, seed_index))
    kw = dict(patches=4, num_point=32, up_ratio=4, coverage=1.0 / 12.0,
              seed=3)
    _assert_same_tree(jmg.mesh_patch_pairs(verts, faces, **kw),
                      tmg.mesh_patch_pairs(verts, faces, **kw))


def test_build_h5_dataset_writes_the_same_datasets(tmp_path):
    h5py = pytest.importorskip("h5py")
    meshes = tmg.make_corpus(2, seed=1)
    kw = dict(patches_per_mesh=3, num_point=32, up_ratio=4,
              coverage=1.0 / 8.0, seed=0, verbose=False)
    paths = [str(tmp_path / f"{who}.h5") for who in ("jax", "torch")]
    assert (jmg.build_h5_dataset(paths[0], meshes, **kw)
            == tmg.build_h5_dataset(paths[1], meshes, **kw))
    with h5py.File(paths[0], "r") as fj, h5py.File(paths[1], "r") as ft:
        assert sorted(fj) == sorted(ft) == ["poisson_128", "poisson_32"]
        for key in fj:
            _assert_same_tree(fj[key][:], ft[key][:])
        assert dict(fj.attrs) == dict(ft.attrs)


def test_build_h5_dataset_names_h5py_when_it_is_missing(tmp_path,
                                                        monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        tmg.build_h5_dataset(str(tmp_path / "x.h5"), [], verbose=False)
