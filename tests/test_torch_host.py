"""The port's host-side utilities against the JAX package's, on the CPU:
the Euler-angle conversions and the renders (numpy on both sides, so
bit-equal), the PNG writer, the source backup, the trainer's
``visualize`` and ``profile`` settings, and the native library's wrapper
(its own build of its own copy of the source, against the JAX package's
build of ``native/``: indices and renders equal, distances within 1e-6).
"""

import glob
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from dispu_tpu import native as jnative
from dispu_tpu.utils import eulerangles as jeuler
from dispu_tpu.utils import visu as jvisu
from dispu_tpu_torch import native as tnative
from dispu_tpu_torch.config import (DataConfig, ExperimentConfig,
                                    GeneratorConfig, LossConfig, TrainConfig)
from dispu_tpu_torch.data.dataset import PatchDataset
from dispu_tpu_torch.train.gan_trainer import GANTrainer
from dispu_tpu_torch.train.trainer import Trainer
from dispu_tpu_torch.utils import eulerangles as teuler
from dispu_tpu_torch.utils import logging as tlogging
from dispu_tpu_torch.utils import visu as tvisu

torch.set_num_threads(1)

ANGLES = [(0.0, 0.0, 0.0), (0.3, -1.1, 2.5), (1.2, np.pi / 2, -0.4),
          (-2.0, 0.7, 0.0)]
NATIVE_ABS = 1e-6  # distances: the same C++ built by two compilers' runs


# ----------------------------------------------------------- eulerangles


@pytest.mark.parametrize("angles", ANGLES, ids=str)
def test_eulerangles_match_jax(angles):
    z, y, x = angles
    mat = jeuler.euler2mat(z, y, x)
    q = jeuler.euler2quat(z, y, x)
    theta, vec = jeuler.euler2angle_axis(z, y, x)
    pairs = [
        (teuler.euler2mat(z, y, x), mat),
        (teuler.mat2euler(mat), jeuler.mat2euler(mat)),
        (teuler.euler2quat(z, y, x), q),
        (teuler.quat2mat(q), jeuler.quat2mat(q)),
        (teuler.quat2euler(q), jeuler.quat2euler(q)),
        (teuler.quat2angle_axis(q)[1], jeuler.quat2angle_axis(q)[1]),
        (teuler.euler2angle_axis(z, y, x)[0], theta),
        (teuler.angle_axis2mat(theta, vec), jeuler.angle_axis2mat(theta, vec)),
        (teuler.angle_axis2euler(theta, vec),
         jeuler.angle_axis2euler(theta, vec)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --------------------------------------------------------------- renders


def _cloud(seed, n=300):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


@pytest.mark.parametrize("angles", ANGLES, ids=str)
def test_euler_rotation_matches_jax(angles):
    np.testing.assert_array_equal(tvisu.euler_rotation(*angles),
                                  jvisu.euler_rotation(*angles))


@pytest.mark.parametrize("kw", [dict(), dict(normalize=False, space=50.0),
                                dict(canvas_size=64, diameter=7, xrot=0.4,
                                     zrot=-1.0)], ids=str)
def test_draw_point_cloud_matches_jax(kw):
    pts = _cloud(0) * (1.0 if kw.get("normalize", True) else 0.5)
    np.testing.assert_array_equal(tvisu.draw_point_cloud(pts, **kw),
                                  jvisu.draw_point_cloud(pts, **kw))
    np.testing.assert_array_equal(
        tvisu.draw_point_cloud(np.zeros((0, 3), np.float32), **kw),
        jvisu.draw_point_cloud(np.zeros((0, 3), np.float32), **kw))


def test_point_cloud_three_views_matches_jax():
    pts = _cloud(1)
    got = tvisu.point_cloud_three_views(pts, canvas_size=96)
    assert got.shape == (96, 288)
    np.testing.assert_array_equal(
        got, jvisu.point_cloud_three_views(pts, canvas_size=96))


def _read_png(path):
    """(width, height, bit depth, colour type, pixels) of a PNG written
    unfiltered, read with the standard library."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, colour = header[:4]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert (raw[:, 0] == 0).all()  # filter type none
    return w, h, depth, colour, raw[:, 1:]


def test_write_png_round_trip(tmp_path):
    img = tvisu.point_cloud_three_views(_cloud(2), canvas_size=40)
    img[0, 0], img[0, 1] = -0.5, 1.5  # clipped
    tvisu.write_png(str(tmp_path / "v.png"), img)
    w, h, depth, colour, pixels = _read_png(tmp_path / "v.png")
    assert (w, h, depth, colour) == (120, 40, 8, 0)
    np.testing.assert_array_equal(
        pixels, np.rint(np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="image"):
        tvisu.write_png(str(tmp_path / "bad.png"), np.zeros((2, 2, 3)))


def test_plot_pcd_three_views_writes_a_figure(tmp_path):
    pytest.importorskip("matplotlib")
    path = tmp_path / "fig.png"
    tvisu.plot_pcd_three_views(str(path), [_cloud(3) * 0.1, _cloud(4) * 0.1],
                               ["a", "b"], suptitle="t")
    assert path.stat().st_size > 1000


# -------------------------------------------------------- source backup


def test_backup_sources_copy(tmp_path):
    tlogging.backup_sources(str(tmp_path))  # the default: the manifest
    assert (tmp_path / "code_manifest.txt").exists()
    tlogging.backup_sources(str(tmp_path), mode="copy")
    dst = tmp_path / "code" / "dispu_tpu_torch"
    for rel in ("__init__.py", "ops/emd.py", "native.py",
                "csrc/dispu_native.cpp", "kernels/csrc/knn.cu"):
        src = os.path.join(tlogging.PACKAGE, rel)
        assert (dst / rel).read_bytes() == open(src, "rb").read(), rel
    assert not list(dst.rglob("__pycache__")) and not (dst / "_build").exists()
    (dst / "stale.py").write_text("")
    tlogging.backup_sources(str(tmp_path), mode="copy")  # replaces the copy
    assert not (dst / "stale.py").exists()
    with pytest.raises(ValueError, match="mode"):
        tlogging.backup_sources(str(tmp_path), mode="tar")


# ------------------------------------------------ visualize and profile


def _cfg(log_dir, use_gan=False, **train):
    gen = dict(num_points=32, knn=8, refine_nsample=8)
    train = dict(dict(batch_size=4, epoch_per_save=1, steps_per_print=1),
                 **train)
    return ExperimentConfig(
        generator=GeneratorConfig(**gen), train=TrainConfig(**train),
        data=DataConfig(num_point=32), use_gan=use_gan,
        loss=LossConfig(repulsion_nsample=8, repulsion_radius=0.3),
        log_dir=str(log_dir))


def _dataset():
    return PatchDataset(h5_path="/nonexistent", synthetic_patches_count=12,
                        num_point=32)


def _events(log_dir):
    """{tag: kinds} of the TensorBoard event files in ``log_dir``."""
    from tensorboard.compat.proto import event_pb2

    tags = {}
    for path in glob.glob(os.path.join(log_dir, "events.out.tfevents.*")):
        data, pos = open(path, "rb").read(), 0
        while pos < len(data):
            n, = struct.unpack("<Q", data[pos:pos + 8])
            ev = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            for v in ev.summary.value:
                tags.setdefault(v.tag, set()).add(v.WhichOneof("value"))
            pos += 12 + n + 4
    return tags


def _state_tensors(state):
    from dispu_tpu_torch.train.trainer import state_tensors

    return state_tensors(state.state_dict())


@pytest.mark.parametrize("trainer", [Trainer, GANTrainer],
                         ids=["cd", "gan"])
def test_epoch_with_visualize_and_profile(tmp_path, trainer):
    """One epoch of 3 steps with ``visualize`` (every 2 steps) and
    ``profile``: the trace names the step's ops, the renders are a PNG and
    a TensorBoard image, and the trained state is bit-equal to the same
    epoch without either."""
    use_gan = trainer is GANTrainer
    cfg = _cfg(tmp_path / "on", use_gan, visualize=True, steps_per_visu=2,
               profile=True)
    state = trainer(cfg, dataset=_dataset(), device="cpu").train(epochs=1)
    plain = trainer(_cfg(tmp_path / "off", use_gan), dataset=_dataset(),
                    device="cpu").train(epochs=1)
    for a, b in zip(_state_tensors(state), _state_tensors(plain)):
        assert torch.equal(a, b)
    with open(tmp_path / "on" / "profile" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    for op in ("dispu_tpu_torch::knn", "KnnFunction", "NnDistance",
               "NnDistanceBackward", "aten::sort"):
        assert op in names, op
    pngs = os.listdir(tmp_path / "on" / "plots")
    assert pngs == ["epoch_0_step_2.png"]
    w, h, *_ = _read_png(tmp_path / "on" / "plots" / pngs[0])
    assert (w, h) == (750, 1000)  # 3 views of 250 by 4 clouds
    tags = _events(str(tmp_path / "on"))
    assert tags["Upsampling"] == {"image"}
    assert tags["fine_cd"] == {"simple_value"}
    assert not (tmp_path / "off" / "plots").exists()
    assert not (tmp_path / "off" / "profile").exists()


def test_visualize_renders_are_jax_renders_of_the_clouds(tmp_path):
    """The PNG holds the JAX package's three views of the step's input,
    coarse, fine and ground-truth clouds, stacked."""
    from dispu_tpu_torch.train.steps import make_eval_step

    cfg = _cfg(tmp_path, visualize=True, steps_per_visu=3)
    tr = Trainer(cfg, dataset=_dataset(), device="cpu")
    inner, seen = make_eval_step(cfg, device="cpu"), []

    def spy(model, inputs, gt, radius):
        coarse, fine, metrics = inner(model, inputs, gt, radius)
        seen.append((inputs, coarse, fine, gt))
        return coarse, fine, metrics

    tr._eval_step = spy
    tr.train(epochs=1)
    (clouds,) = seen  # step 3 of 3
    img = np.concatenate([jvisu.point_cloud_three_views(
        c[0].numpy(), canvas_size=250) for c in clouds], axis=0)
    *_, pixels = _read_png(tmp_path / "plots" / "epoch_0_step_3.png")
    np.testing.assert_array_equal(
        pixels, np.rint(np.clip(img, 0, 1) * 255).astype(np.uint8))


# ---------------------------------------------------------------- native


def _native_inputs():
    rng = np.random.RandomState(5)
    return dict(s=rng.randn(2, 500, 3).astype(np.float32),
                q=rng.randn(2, 100, 3).astype(np.float32),
                f=rng.randn(500, 4).astype(np.float32),
                xyz=(rng.rand(60, 3) * 60).astype(np.int32),
                c=[(rng.rand(60) * 255).astype(np.float32) for _ in range(3)],
                v=rng.randn(30, 3).astype(np.float32),
                faces=rng.randint(0, 30, (40, 3)).astype(np.int32))


NATIVE_CALLS = {
    "knn_batch": lambda m, a: m.knn_batch(a["s"], a["q"], 8,
                                          return_dist=True),
    "knn": lambda m, a: m.knn(a["s"][0], a["q"][0], 5, return_dist=True),
    "knn_6d": lambda m, a: m.knn(np.concatenate([a["s"][0], a["s"][1]], 1),
                                 np.concatenate([a["s"][1], a["s"][0]], 1)
                                 [:50], 4),
    "knn_batch_distance_pick": lambda m, a: m.knn_batch_distance_pick(
        a["s"], 10, 16, seed=3),
    "grid_subsample": lambda m, a: m.grid_subsample(a["s"][0], 0.3, a["f"]),
    "render_points": lambda m, a: m.render_points(a["s"][0], 100, 3),
    "render_ball": lambda m, a: m.render_ball(64, 64, a["xyz"], *a["c"]),
    "point_to_mesh": lambda m, a: m.point_to_mesh(a["s"][0], a["v"],
                                                  a["faces"]),
}


@pytest.mark.parametrize("name", sorted(NATIVE_CALLS))
def test_native_matches_jax_package(name):
    """Integer outputs (indices, renders) equal, float ones within
    ``NATIVE_ABS``."""
    assert jnative.available()
    args = _native_inputs()
    got, want = (NATIVE_CALLS[name](m, args) for m in (tnative, jnative))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating) and name not in (
                "render_points",):
            assert float(np.abs(g - w).max(initial=0.0)) <= NATIVE_ABS
        else:
            np.testing.assert_array_equal(g, w)


def test_native_builds_its_own_copy(monkeypatch, tmp_path):
    """The library is built from the port's copy into its ``_build``, and a
    build that fails raises (``available`` says False)."""
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR
    assert tnative.SOURCE.parent.parent == tnative.BUILD_DIR.parent
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot be built"):
        tnative.build()
    assert not tnative.available()
    with pytest.raises(RuntimeError):
        tnative.knn(np.zeros((4, 3)), np.zeros((1, 3)), 1)


def test_native_refuses_bad_shapes():
    with pytest.raises(ValueError):
        tnative.knn_batch(np.zeros((2, 5, 3)), np.zeros((1, 5, 3)), 2)
    with pytest.raises(ValueError):
        tnative.knn(np.zeros((5, 3)), np.zeros((2, 3)), 6)
    with pytest.raises(ValueError):
        tnative.point_to_mesh(np.zeros((2, 3)), np.zeros((3, 3)),
                              np.asarray([[0, 1, 3]]))
