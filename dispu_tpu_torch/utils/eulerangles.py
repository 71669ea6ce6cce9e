"""Euler-angle, quaternion and angle-axis conversions (counterpart of
``utils/eulerangles.py``; pure numpy, so the port keeps its own copy).

The z-then-y-then-x convention: ``M = Mx @ My @ Mz`` applied to column
vectors, the z rotation first.  The renders of ``utils/visu.py`` build
their own rotation (``euler_rotation``); these helpers complete the
surface the reference vendored.
"""

from __future__ import annotations

import math

import numpy as np

_FLOAT_EPS_4 = np.finfo(float).eps * 4.0


def euler2mat(z: float = 0, y: float = 0, x: float = 0) -> np.ndarray:
    """Rotation matrix for rotations about z (first), then y, then x.

    Parity: ref:Common/eulerangles.py:98-195.
    """
    mats = []
    if z:
        cz, sz = math.cos(z), math.sin(z)
        mats.append(np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
    if y:
        cy, sy = math.cos(y), math.sin(y)
        mats.append(np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]))
    if x:
        cx, sx = math.cos(x), math.sin(x)
        mats.append(np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
    if mats:
        out = mats[-1]
        for m in mats[-2::-1]:
            out = out @ m
        return out
    return np.eye(3)


def mat2euler(M, cy_thresh: float | None = None):
    """Recover (z, y, x) angles from a rotation matrix.

    Inverse of :func:`euler2mat` (up to the usual gimbal ambiguity: when
    cos(y) ≈ 0 the x angle is set to 0 and z absorbs the remaining
    rotation).  Parity: ref:Common/eulerangles.py:198-268.
    """
    M = np.asarray(M)
    if cy_thresh is None:
        try:
            cy_thresh = np.finfo(M.dtype).eps * 4
        except ValueError:
            cy_thresh = _FLOAT_EPS_4
    r11, r12, r13, r21, r22, r23, _, _, r33 = M.flat
    cy = math.sqrt(r33 * r33 + r23 * r23)
    if cy > cy_thresh:
        z = math.atan2(-r12, r11)
        y = math.atan2(r13, cy)
        x = math.atan2(-r23, r33)
    else:  # cos(y) ~ 0: gimbal lock, so x -> 0 and z takes the rest
        z = math.atan2(r21, r22)
        y = math.atan2(r13, cy)
        x = 0.0
    return z, y, x


def _quat_mult(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def euler2quat(z: float = 0, y: float = 0, x: float = 0) -> np.ndarray:
    """(w, x, y, z) unit quaternion for the same rotation as
    :func:`euler2mat`.  Parity: ref:Common/eulerangles.py:271-316."""
    qz = np.array([math.cos(z / 2), 0.0, 0.0, math.sin(z / 2)])
    qy = np.array([math.cos(y / 2), 0.0, math.sin(y / 2), 0.0])
    qx = np.array([math.cos(x / 2), math.sin(x / 2), 0.0, 0.0])
    return _quat_mult(qx, _quat_mult(qy, qz))


def quat2mat(q) -> np.ndarray:
    """(w, x, y, z) quaternion (any norm) → rotation matrix."""
    w, x, y, z = np.asarray(q, float)
    n = w * w + x * x + y * y + z * z
    if n < _FLOAT_EPS_4:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def quat2euler(q):
    """Quaternion → (z, y, x) angles.
    Parity: ref:Common/eulerangles.py:319-345."""
    return mat2euler(quat2mat(q))


def quat2angle_axis(q):
    """Quaternion → (theta, unit_vector)."""
    q = np.asarray(q, float)
    w = q[0]
    vec = q[1:]
    norm = math.sqrt(float(vec @ vec))
    theta = 2.0 * math.atan2(norm, w)
    if norm < _FLOAT_EPS_4:
        return 0.0, np.array([1.0, 0.0, 0.0])
    return theta, vec / norm


def euler2angle_axis(z: float = 0, y: float = 0, x: float = 0):
    """Angles → (theta, rotation axis).
    Parity: ref:Common/eulerangles.py:348-379."""
    return quat2angle_axis(euler2quat(z, y, x))


def angle_axis2mat(theta: float, vector, is_normalized: bool = False):
    """Rodrigues rotation: angle + axis → matrix."""
    v = np.asarray(vector, float)
    if not is_normalized:
        v = v / math.sqrt(float(v @ v))
    ux, uy, uz = v
    c, s = math.cos(theta), math.sin(theta)
    oc = 1.0 - c
    return np.array(
        [
            [c + ux * ux * oc, ux * uy * oc - uz * s, ux * uz * oc + uy * s],
            [uy * ux * oc + uz * s, c + uy * uy * oc, uy * uz * oc - ux * s],
            [uz * ux * oc - uy * s, uz * uy * oc + ux * s, c + uz * uz * oc],
        ]
    )


def angle_axis2euler(theta: float, vector, is_normalized: bool = False):
    """Angle + axis → (z, y, x) angles.
    Parity: ref:Common/eulerangles.py:382-418."""
    return mat2euler(angle_axis2mat(theta, vector, is_normalized))
