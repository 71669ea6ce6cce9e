"""The port's point-set ops (the approximate EMD, three-NN interpolation,
patch extraction, ``selection_sort`` and the dilated grouping) against the
JAX package's, on the CPU.

Inputs are seeded numpy clouds handed to both packages.  Selections (the
three nearest, the dilated kNN, the sorted rows, FPS seeds and patches)
are bit-equal, and so are the gathered points.  The EMD's values agree to
f32 round-off of contractions taken in other orders: the match to 1e-5 of
its largest entry, the costs to a relative 1e-5, their gradients to 1e-5
of the largest entry.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu import losses as JL
from dispu_tpu.ops import emd as jemd
from dispu_tpu.ops import interpolate as jinterp
from dispu_tpu.ops import patches as jpatches
from dispu_tpu_torch import losses as TL
from dispu_tpu_torch.ops import emd as temd
from dispu_tpu_torch.ops import grouping as tgrouping
from dispu_tpu_torch.ops import interpolate as tinterp
from dispu_tpu_torch.ops import patches as tpatches

# the JAX package's ``ops`` exports a function named ``grouping``
jgrouping = importlib.import_module("dispu_tpu.ops.grouping")

torch.set_num_threads(1)

EMD_REL = 1e-5


def _cloud(seed, *shape, scale=0.3):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(
        np.float32)


# -------------------------------------------------------------------- EMD


@pytest.mark.parametrize("n,m", [(64, 64), (96, 48), (40, 120)])
def test_approx_match(n, m):
    a, b = _cloud(0, 2, n, 3), _cloud(1, 2, m, 3)
    want = np.asarray(jemd.approx_match(jnp.asarray(a), jnp.asarray(b)))
    got = temd.approx_match(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == want.shape == (2, m, n)
    assert not got.requires_grad
    assert float(np.abs(got.numpy() - want).max()) <= \
        EMD_REL * float(np.abs(want).max())


@pytest.mark.parametrize("n,m", [(64, 64), (96, 48)])
def test_match_cost_and_its_gradient(n, m):
    a, b = _cloud(2, 2, n, 3), _cloud(3, 2, m, 3)
    match = np.asarray(jemd.approx_match(jnp.asarray(a), jnp.asarray(b)))

    def jcost(x, y):
        return jnp.sum(jemd.match_cost(x, y, jnp.asarray(match)))

    jv, (jga, jgb) = jax.value_and_grad(jcost, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    tm = torch.from_numpy(match.copy()).requires_grad_(True)
    tv = torch.sum(temd.match_cost(ta, tb, tm))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=EMD_REL)
    assert tm.grad is None  # the match is held fixed
    for t, g in ((ta, jga), (tb, jgb)):
        g = np.asarray(g)
        assert float(np.abs(t.grad.numpy() - g).max()) <= \
            EMD_REL * float(np.abs(g).max())


def test_match_cost_gradient_is_finite_at_coincident_points():
    a = _cloud(4, 1, 32, 3)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(a.copy()).requires_grad_(True)
    cost = temd.match_cost(ta, tb, temd.approx_match(ta, tb))
    cost.sum().backward()
    assert torch.isfinite(ta.grad).all() and torch.isfinite(tb.grad).all()


@pytest.mark.parametrize("radius", [1.0, "per_cloud"])
def test_earth_mover_cost_and_gradient(radius):
    a, b = _cloud(5, 3, 80, 3), _cloud(6, 3, 80, 3)
    r = np.asarray([1.0, 0.7, 1.3], np.float32) if radius == "per_cloud" \
        else 1.0
    jr = jnp.asarray(r) if radius == "per_cloud" else r
    tr = torch.from_numpy(r) if radius == "per_cloud" else r
    jv, (jga, jgb) = jax.value_and_grad(
        lambda x, y: JL.earth_mover(x, y, jr), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    tv = TL.earth_mover(ta, tb, tr)
    tv.backward()
    assert TL.earth_mover is temd.earth_mover_cost
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=EMD_REL)
    for t, g in ((ta, jga), (tb, jgb)):
        g = np.asarray(g)
        assert float(np.abs(t.grad.numpy() - g).max()) <= \
            EMD_REL * float(np.abs(g).max())


def test_earth_mover_cost_refuses_unequal_counts():
    with pytest.raises(ValueError, match="equal point counts"):
        temd.earth_mover_cost(torch.zeros(1, 8, 3), torch.zeros(1, 9, 3))


# ----------------------------------------------------------- interpolation


@pytest.mark.parametrize("n,m", [(100, 37), (64, 256), (20, 2), (20, 1)])
def test_three_nn(n, m):
    """Selections bit-equal (ties to the lower index: the grid of the
    second cloud makes many); distances to f32 round-off (XLA's product
    sums in another order at some shapes: 3e-8 seen at m = 2); fewer than
    three points repeat the nearest."""
    q = _cloud(7, 2, n, 3)
    rng = np.random.RandomState(8)
    d = np.round(rng.rand(2, m, 3) * 4).astype(np.float32) / 4 * 0.3
    jd, ji = jinterp.three_nn(jnp.asarray(q), jnp.asarray(d))
    td, ti = tinterp.three_nn(torch.from_numpy(q), torch.from_numpy(d))
    assert ti.dtype == torch.int32 and ti.shape == (2, n, 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd),
                               rtol=1e-5, atol=1e-7)


def test_three_interpolate_and_weights():
    pts = _cloud(9, 2, 50, 16)
    q, d = _cloud(10, 2, 70, 3), _cloud(11, 2, 50, 3)
    _, idx = jinterp.three_nn(jnp.asarray(q), jnp.asarray(d))
    dist = np.abs(np.random.RandomState(12).randn(2, 70, 3)).astype(
        np.float32)
    dist[0, 0] = 0.0  # floored at eps
    jw = jinterp.inverse_distance_weights(jnp.asarray(dist))
    tw = tinterp.inverse_distance_weights(torch.from_numpy(dist))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)

    def jf(p, w):
        return jinterp.three_interpolate(p, jnp.asarray(idx), w)

    jout, jvjp = jax.vjp(jf, jnp.asarray(pts), jw)
    tp = torch.from_numpy(pts).requires_grad_(True)
    tw = torch.from_numpy(np.array(jw)).requires_grad_(True)
    tout = tinterp.three_interpolate(tp, torch.from_numpy(np.asarray(idx)),
                                     tw)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-7)
    ct = np.random.RandomState(13).randn(*tout.shape).astype(np.float32)
    tout.backward(torch.from_numpy(ct))
    jgp, jgw = jvjp(jnp.asarray(ct))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------- sort and grouping


@pytest.mark.parametrize("k", [1, 5, 17])
def test_selection_sort(k):
    rng = np.random.RandomState(14)
    dist = np.round(rng.rand(3, 7, 40) * 8).astype(np.float32)  # ties
    jv, ji = jgrouping.selection_sort(jnp.asarray(dist), k)
    tv, ti = tgrouping.selection_sort(torch.from_numpy(dist), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dilation,use_xyz,with_points", [
    (1, False, True), (2, True, True), (3, False, False)])
def test_dilat_group(dilation, use_xyz, with_points):
    xyz = _cloud(15, 2, 120, 3)
    pts = _cloud(16, 2, 120, 6) if with_points else None
    want = jgrouping.dilat_group(
        jnp.asarray(xyz), None if pts is None else jnp.asarray(pts), 8,
        dilation, use_xyz)
    got = tgrouping.dilat_group(
        torch.from_numpy(xyz), None if pts is None else torch.from_numpy(pts),
        8, dilation, use_xyz)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- patches


def test_extract_patches_train_by_fps():
    """FPS seeds, kNN patches of the points, the features and the ground
    truth, folded patch-major: exact."""
    xyz, feats = _cloud(17, 2, 300, 3), _cloud(18, 2, 300, 5)
    gt = _cloud(19, 2, 1200, 3)
    want = jpatches.extract_patches_train(
        jnp.asarray(xyz), 32, patch_num=4, batch_features=jnp.asarray(feats),
        gt_xyz=jnp.asarray(gt), gt_k=128)
    got = tpatches.extract_patches_train(
        torch.from_numpy(xyz), 32, patch_num=4,
        batch_features=torch.from_numpy(feats), gt_xyz=torch.from_numpy(gt),
        gt_k=128)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_extract_patches_train_one_drawn_seed():
    """One seed a cloud drawn from the generator: each patch is JAX's kNN
    patch around the same seed (the draws themselves differ by package),
    and the draw repeats with the generator's seed."""
    xyz = _cloud(20, 3, 200, 3)

    def draw():
        return tpatches.extract_patches_train(
            torch.from_numpy(xyz), 16,
            generator=torch.Generator().manual_seed(3))[0].numpy()

    got = draw()
    np.testing.assert_array_equal(got, draw())
    assert got.shape == (3, 16, 3)
    # the seed is the patch's nearest point to itself: row 0
    seeds = got[:, :1]
    from dispu_tpu.ops.knn import knn as jknn
    _, idx = jknn(16, jnp.asarray(xyz), jnp.asarray(seeds))
    want = np.take_along_axis(xyz, np.asarray(idx)[:, 0, :, None], axis=1)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="generator"):
        tpatches.extract_patches_train(torch.from_numpy(xyz), 16)


@pytest.mark.parametrize("outliers", [0, 5])
def test_extract_patches_test(outliers):
    """The outlier filter, FPS seeds and kNN patches of one cloud: exact
    (``outliers`` far points that the filter drops)."""
    xyz = _cloud(21, 400, 3)
    if outliers:
        xyz[:outliers] += 50.0
    want = jpatches.extract_patches_test(xyz, 64)
    got = tpatches.extract_patches_test(xyz, 64, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].shape == (int(400 / 64 * 5), 64, 3)
    assert not np.isin(xyz[:outliers], got[0]).all(axis=-1).any()
