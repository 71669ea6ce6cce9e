"""Point files (counterpart of ``evaluation/meshio.py``: ``read_xyz`` and
``write_xyz`` only)."""

from __future__ import annotations

import numpy as np


def read_xyz(path: str) -> np.ndarray:
    """Whitespace-separated point file → (n, >=3) float32."""
    return np.loadtxt(path, dtype=np.float32)


def write_xyz(path: str, points: np.ndarray, fmt: str = "%.6f") -> None:
    """One point a line, ``fmt`` a coordinate (the reference's ``%.6f``)."""
    np.savetxt(path, np.asarray(points), fmt=fmt)
