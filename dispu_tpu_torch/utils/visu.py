"""Point-cloud renders and the GAN step's history pool (counterpart of
``utils/visu.py``; pure numpy, so the port keeps its own copy).

:func:`draw_point_cloud` is an orthographic z-buffer splat renderer and
:func:`point_cloud_three_views` puts three views side by side; the
trainer's ``visualize`` steps stack them for the input, coarse, fine and
ground-truth clouds and write the stack as a grayscale PNG with
:func:`write_png`, which needs only the standard library (``zlib``,
``struct``), so the renders are written where matplotlib is not
installed.  :func:`plot_pcd_three_views`, the matplotlib figure of the
JAX package's trainer, stays a library function and imports matplotlib
when it is called.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def euler_rotation(xrot: float, yrot: float, zrot: float) -> np.ndarray:
    """Rz @ Ry @ Rx rotation matrix from radians."""

    def rx(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    return rz(zrot) @ ry(yrot) @ rx(xrot)


def draw_point_cloud(
    points: np.ndarray,
    canvas_size: int = 500,
    space: float = 200.0,
    diameter: int = 25,
    xrot: float = 0.0,
    yrot: float = 0.0,
    zrot: float = 0.0,
    normalize: bool = True,
) -> np.ndarray:
    """Render one orthographic view as a (canvas, canvas) float image.

    Points nearer the camera (larger depth after rotation) draw brighter
    disks with a gaussian falloff; a z-buffer keeps the nearest splat.
    """
    img = np.zeros((canvas_size, canvas_size), np.float32)
    if points.shape[0] == 0:
        return img
    pts = np.asarray(points, np.float64)[:, :3]
    pts = pts @ euler_rotation(xrot, yrot, zrot).T
    if normalize:
        centroid = pts.mean(axis=0)
        pts = pts - centroid
        scale = np.abs(pts).max() or 1.0
        pts = pts / scale

    # draw far-to-near so near splats overwrite
    order = np.argsort(pts[:, 2])
    pts = pts[order]

    radius = diameter // 2
    dx, dy = np.meshgrid(
        np.arange(-radius, radius + 1), np.arange(-radius, radius + 1)
    )
    mask = (dx**2 + dy**2) <= radius**2
    kx, ky = dx[mask], dy[mask]
    falloff = np.exp(-((kx**2 + ky**2) / (radius**2)) * 4.0)

    cx = (pts[:, 0] * space + canvas_size / 2).astype(np.int64)
    cy = (pts[:, 1] * space + canvas_size / 2).astype(np.int64)
    depth = (pts[:, 2] + 1.0) / 2.0  # 0 far, 1 near

    px = cx[:, None] + kx[None, :]
    py = cy[:, None] + ky[None, :]
    val = depth[:, None] * falloff[None, :]
    valid = (px >= 0) & (px < canvas_size) & (py >= 0) & (py < canvas_size)
    np.maximum.at(img, (py[valid], px[valid]), val[valid].astype(np.float32))

    m = img.max()
    if m > 0:
        img /= m
    return img


def point_cloud_three_views(points: np.ndarray, canvas_size: int = 500) -> np.ndarray:
    """Three orthogonal views side by side → (canvas, 3·canvas) image."""
    views = [
        draw_point_cloud(points, canvas_size, xrot=110 / 180 * math.pi,
                         yrot=0, zrot=-45 / 180 * math.pi),
        draw_point_cloud(points, canvas_size, xrot=70 / 180 * math.pi,
                         yrot=0, zrot=135 / 180 * math.pi),
        draw_point_cloud(points, canvas_size, xrot=math.pi / 2, yrot=0,
                         zrot=math.pi / 2),
    ]
    return np.concatenate(views, axis=1)


def plot_pcd_three_views(
    filename: str,
    pcds: Sequence[np.ndarray],
    titles: Sequence[str],
    suptitle: str = "",
    sizes: Optional[Sequence[float]] = None,
    cmap: str = "Reds",
    zdir: str = "y",
    xlim=(-0.3, 0.3),
    ylim=(-0.3, 0.3),
    zlim=(-0.3, 0.3),
) -> None:
    """Matplotlib grid: one row per elevation/azim view, one column per
    cloud.  Needs matplotlib (imported here, at the call): the trainer's
    renders do not call it (:func:`write_png`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if sizes is None:
        sizes = [0.5 for _ in pcds]
    fig = plt.figure(figsize=(len(pcds) * 3, 9))
    elevations = [30, 0, 90]
    for i, elev in enumerate(elevations):
        for j, (pcd, size) in enumerate(zip(pcds, sizes)):
            color = pcd[:, 0]
            ax = fig.add_subplot(
                3, len(pcds), i * len(pcds) + j + 1, projection="3d"
            )
            ax.view_init(elev, -45)
            ax.scatter(
                pcd[:, 0], pcd[:, 1], pcd[:, 2], zdir=zdir, c=color,
                s=size, cmap=cmap, vmin=-1.0, vmax=0.5,
            )
            ax.set_title(titles[j] if i == 0 else "")
            ax.set_axis_off()
            ax.set_xlim(xlim)
            ax.set_ylim(ylim)
            ax.set_zlim(zlim)
    plt.suptitle(suptitle)
    fig.savefig(filename)
    plt.close(fig)


def write_png(filename: str, img: np.ndarray) -> None:
    """Write a (h, w) image of values in [0, 1] as an 8-bit grayscale PNG
    (each value scaled by 255 and rounded), with the standard library
    alone."""
    img = np.asarray(img, np.float64)
    if img.ndim != 2:
        raise ValueError(f"write_png takes a (h, w) image, got {img.shape}")
    h, w = img.shape
    pixels = np.rint(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    # each row starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(filename, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


class PointPool:
    """History buffer of generated point clouds (the CycleGAN image pool).

    While the pool fills, ``query`` stores its input and returns it; once
    full, with probability 0.5 it swaps the input for a stored batch
    chosen at random and returns that one, else it returns the input.  The
    draws come from a ``numpy.random.RandomState`` (seeded by the caller),
    so a seed gives the JAX package's sequence."""

    def __init__(self, pool_size: int = 20, rng=None):
        self.pool_size = pool_size
        self.points: list = []
        self.rng = rng if rng is not None else np.random.RandomState()

    def query(self, point: np.ndarray) -> np.ndarray:
        if self.pool_size == 0:
            return point
        if len(self.points) < self.pool_size:
            self.points.append(np.asarray(point).copy())
            return point
        if self.rng.rand() > 0.5:
            random_id = self.rng.randint(0, self.pool_size)
            tmp = self.points[random_id].copy()
            self.points[random_id] = np.asarray(point).copy()
            return tmp
        return point
