"""The port's ball query against the JAX package's, on the CPU.

The plain version (``query_ball_torch``, reached through
``ops.grouping.query_ball_point`` for CPU tensors) is held against JAX's
``query_ball_point(impl="xla")`` and against ``query_ball_pallas`` run in
interpret mode, as tests/test_pallas.py runs it.  Indices, counts and
selections must be bit-equal.  The returned distances are the hit test's
``q2 − 2·q·p + p2``: XLA and PyTorch may round the ``q·p`` product
differently, so they agree to that product's f32 round-off, 1e-6 of the
cancellation scale ``|q|² + |p|²``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.ops.grouping import query_ball_point as jquery
from dispu_tpu.ops.pallas_kernels import query_ball_pallas
from dispu_tpu_torch.kernels import query_ball as qb
from dispu_tpu_torch.ops.grouping import grouping, query_ball_point

torch.set_num_threads(1)


def _pair(radius, nsample, pts, q, **kw):
    """(JAX XLA, JAX Pallas interpret, port) outputs as numpy tuples."""
    jr = jnp.asarray(radius) if np.ndim(radius) else radius
    want = jquery(jr, nsample, jnp.asarray(pts), jnp.asarray(q), impl="xla",
                  **kw)
    pallas_kw = dict(with_dists=kw.get("return_dists", False),
                     select_smallest=kw.get("select_smallest", 0))
    pal = query_ball_pallas(jr, nsample, jnp.asarray(pts), jnp.asarray(q),
                            interpret=True, **pallas_kw)
    tr = torch.as_tensor(np.asarray(radius, np.float32))
    got = query_ball_point(tr, nsample, torch.from_numpy(pts),
                           torch.from_numpy(q), **kw)
    return ([np.asarray(a) for a in want], [np.asarray(a) for a in pal],
            [t.numpy() for t in got])


def _assert_outputs(want, pal, got, pts, q, return_dists):
    assert len(want) == len(pal) == len(got)
    for i, (w, p, g) in enumerate(zip(want, pal, got)):
        assert g.dtype == (np.float32 if return_dists and i == 2
                           else np.int32)
        if return_dists and i == 2:
            scale = float(np.max(np.sum(pts * pts, -1))
                          + np.max(np.sum(q * q, -1)))
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale)
            np.testing.assert_allclose(g, p, rtol=0, atol=1e-6 * scale)
        else:
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)


MODES = [dict(), dict(return_dists=True), dict(select_smallest=5),
         dict(return_dists=True, select_smallest=5)]


CASES = ["scalar", "per_batch", "empty", "overfull", "small_cloud",
         "duplicates"]


@pytest.mark.parametrize("kw", MODES, ids=["idx", "dists", "select",
                                           "dists+select"])
@pytest.mark.parametrize("case", CASES)
def test_ball_query_matches_jax(case, kw):
    rng = np.random.RandomState(CASES.index(case))
    b, n, m, nsample, radius = 2, 150, 40, 12, 0.8
    pts = rng.randn(b, n, 3).astype(np.float32)
    q = rng.randn(b, m, 3).astype(np.float32)
    if case == "per_batch":
        radius = np.asarray([0.3, 1.5], np.float32)
    elif case == "empty":
        radius = 1e-4                # nothing within: index 0, count 0
    elif case == "overfull":
        radius = 100.0               # all hit: the first nsample indices
    elif case == "small_cloud":
        pts, nsample, radius = pts[:, :7], 20, 1.5   # n < nsample
    elif case == "duplicates":
        pts[:, 100:130] = pts[:, 10:40]   # equal distances across slots
        q[:, :10] = pts[:, 10:20]         # queries on duplicated points
    want, pal, got = _pair(radius, nsample, pts, q, **kw)
    _assert_outputs(want, pal, got, pts, q, kw.get("return_dists", False))


def test_fifth_place_tie_boundary():
    """Exact ties at the 5th-place boundary of ``select_smallest`` (dyadic
    coordinates: every distance exact in f32), mirroring
    tests/test_losses.py::test_repulsion_tie_boundary."""
    s = 1.0 / 64.0
    pts = [[0.0, 0.0, 0.0]]
    for scale in (1.0, 2.0):
        for axis in range(3):
            for sign in (1.0, -1.0):
                p = [0.0, 0.0, 0.0]
                p[axis] = sign * scale * s
                pts.append(p)
    pts = np.asarray([pts], np.float32)  # (1, 13, 3)
    for kw in MODES[1:]:
        want, pal, got = _pair(0.07, 20, pts, pts, **kw)
        _assert_outputs(want, pal, got, pts, pts,
                        kw.get("return_dists", False))


def test_ball_grouping_matches_jax():
    """``grouping(use_knn=False)``: the ball indices gather xyz and
    features exactly."""
    from dispu_tpu.ops.grouping import grouping as jgrouping

    rng = np.random.RandomState(3)
    xyz = rng.randn(2, 64, 3).astype(np.float32)
    q = xyz[:, ::4].copy()
    feat = rng.randn(2, 64, 5).astype(np.float32)
    want = jgrouping(jnp.asarray(feat), 8, jnp.asarray(xyz), jnp.asarray(q),
                     use_knn=False, radius=0.9)
    got = grouping(torch.from_numpy(feat), 8, torch.from_numpy(xyz),
                   torch.from_numpy(q), use_knn=False, radius=0.9)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_select_smallest_beyond_nsample_raises():
    pts = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="select_smallest"):
        query_ball_point(0.5, 4, pts, pts, select_smallest=5)


def test_cpu_tensor_refused_by_kernel_and_counts_untouched():
    pts = torch.zeros(1, 8, 3)
    before = qb.LAUNCHES["query_ball"]
    with pytest.raises(ValueError, match="CUDA"):
        query_ball_point(0.5, 4, pts, pts, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        qb.query_ball_cuda(0.5, 4, pts, pts)
    query_ball_point(0.5, 4, pts, pts)
    assert qb.LAUNCHES["query_ball"] == before
