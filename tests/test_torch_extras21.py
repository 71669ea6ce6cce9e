"""The port's last losses, geometry helpers and augmentations against the
JAX package's, on the CPU: ``uniform_exact``, ``geometric_losses``,
``l1_loss``, ``classify_loss``, ``repulsion4``, ``perulsion_loss``,
``cd_loss2`` and ``uniform_knn``; ``gen_2d_grid``, ``gen_1d_grid``,
``covariance_matrix`` and ``exponential_distance``; ``shift_point_cloud``,
``rotate_perturbation``, ``random_point_dropout`` and ``shuffle_points``.

Inputs are seeded numpy clouds.  Loss values agree to 1e-5 of their
magnitude (1e-5 where that is below 1), and their gradients with respect
to the prediction to 1e-5 of the gradient's largest entry; the host
statistic ``uniform_exact`` is bit-equal (the same FPS seeds, the same
numpy).  The augmentations are fed the draws JAX made, captured by
wrapping its ``jax.random`` function for one call, and agree to 1e-6
(selections and permutations bit for bit); the grids to 3e-8, two f32
ulps of their largest entry (``torch.linspace`` rounds a few entries the
other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu import losses as jlosses
from dispu_tpu.data import augment as jaugment
from dispu_tpu.ops import geometry as jgeometry
from dispu_tpu_torch import losses as tlosses
from dispu_tpu_torch.data import augment as taugment
from dispu_tpu_torch.ops import geometry as tgeometry
from test_torch_pointnet import assert_outputs, cloud

torch.set_num_threads(1)

GRAD_REL = 1e-5
GRID_ATOL = 3e-8  # two f32 ulps at 0.2


def hold_loss(jfn, tfn, xs, grad_arg=0, **kw):
    """Value of ``tfn`` vs ``jfn`` on the same inputs, and (with
    ``grad_arg``, an index, or None for no gradient) the gradient of the
    sum of the outputs with respect to that input."""
    jx = [jnp.asarray(x) for x in xs]
    tx = [torch.from_numpy(x).clone() for x in xs]
    if grad_arg is not None:
        tx[grad_arg].requires_grad_(True)
    got, want = tfn(*tx, **kw), jfn(*jx, **kw)
    assert_outputs(got, want)
    if grad_arg is None:
        return

    def total(*args):
        out = jfn(*args, **kw)
        return sum(out) if isinstance(out, tuple) else out

    w = np.asarray(jax.grad(total, argnums=grad_arg)(*jx))
    got = got if isinstance(got, tuple) else (got,)
    (g,) = torch.autograd.grad(sum(got), tx[grad_arg])
    np.testing.assert_allclose(g.numpy(), w, rtol=0,
                               atol=GRAD_REL * float(np.abs(w).max()))


def dense(seed, n=64, scale=0.3):
    """A (2, n, 3) cloud dense enough that radius 0.07 balls hold
    neighbours."""
    return cloud(seed, 2, n, 3, scale=scale)


# ------------------------------------------------------------------ losses


def test_repulsion4():
    hold_loss(jlosses.repulsion4, tlosses.repulsion4, [dense(0)])


@pytest.mark.parametrize("use_knn", [False, True])
@pytest.mark.parametrize("use_l1", [False, True])
def test_perulsion_loss(use_knn, use_l1):
    hold_loss(jlosses.perulsion_loss, tlosses.perulsion_loss, [dense(1)],
              use_knn=use_knn, use_l1=use_l1)
    assert tlosses.get_perulsion_loss is tlosses.perulsion_loss


@pytest.mark.parametrize("threshold", [100.0, 1.5, None])
def test_cd_loss2(threshold):
    hold_loss(jlosses.cd_loss2, tlosses.cd_loss2,
              [dense(2), dense(3, n=96)], threshold=threshold)


def test_uniform_knn():
    hold_loss(jlosses.uniform_knn, tlosses.uniform_knn, [dense(4)])


@pytest.mark.parametrize("nnk", [8, 4])
def test_geometric_losses(nnk):
    hold_loss(jlosses.geometric_losses, tlosses.geometric_losses,
              [dense(5), dense(6, n=48)], nnk=nnk)


def test_l1_loss():
    hold_loss(jlosses.l1_loss, tlosses.l1_loss, [cloud(7, 2, 10, 3),
                                                 cloud(8, 2, 10, 3)])


def test_classify_loss():
    logits = cloud(9, 4, 6, 5, scale=4.0)
    labels = np.random.RandomState(10).randint(0, 5, (4, 6)).astype(np.int32)
    hold_loss(jlosses.classify_loss, tlosses.classify_loss, [logits, labels])


def _sphere(seed, n=1000, crammed=0):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3).astype(np.float32)
    pts = v / np.linalg.norm(v, axis=-1, keepdims=True)
    pts[:crammed] = pts[:crammed] * 1e-3 + np.float32([1.0, 0.0, 0.0])
    return pts


@pytest.mark.parametrize("cap_counts", [False, True])
def test_uniform_exact_bit_equal(cap_counts):
    """Two clouds, one with 200 points crammed into a tiny ball (disks
    there hold more than nsample, which only the uncapped count sees)."""
    pcd = np.stack([_sphere(11), _sphere(12, crammed=200)])
    for p in ((0.004, 0.012), (0.002, 0.004, 0.006, 0.008, 0.010, 0.012,
                               0.015)):
        want = jlosses.uniform_exact(pcd, percentages=p,
                                     cap_counts=cap_counts)
        assert tlosses.uniform_exact(pcd, percentages=p,
                                     cap_counts=cap_counts) == want
        assert tlosses.uniform_exact(torch.from_numpy(pcd), percentages=p,
                                     cap_counts=cap_counts) == want


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("num", [1, 2, 5, 8, 33])
def test_grids_within_two_ulps(num):
    for jfn, tfn in ((jgeometry.gen_2d_grid, tgeometry.gen_2d_grid),
                     (jgeometry.gen_1d_grid, tgeometry.gen_1d_grid)):
        got, want = tfn(num), np.asarray(jfn(num))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRID_ATOL)


def test_covariance_matrix():
    pc = cloud(13, 2, 10, 8, 3)
    assert_outputs(tgeometry.covariance_matrix(torch.from_numpy(pc)),
                   jgeometry.covariance_matrix(jnp.asarray(pc)))


def test_exponential_distance():
    q, p = cloud(14, 2, 10, 1, 3), cloud(15, 2, 10, 8, 3)
    assert_outputs(
        tgeometry.exponential_distance(torch.from_numpy(q),
                                       torch.from_numpy(p)),
        jgeometry.exponential_distance(jnp.asarray(q), jnp.asarray(p)))


# ------------------------------------------------------------ augmentation


def captured(monkeypatch, name, fn, *args, **kwargs):
    """Call ``fn`` with ``jax.random.<name>`` wrapped to record what it
    returns.  Returns (fn's result, the recorded draws)."""
    draws, orig = [], getattr(jax.random, name)

    def recording(*a, **k):
        out = orig(*a, **k)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, name, recording)
    try:
        out = fn(*args, **kwargs)
    finally:
        monkeypatch.setattr(jax.random, name, orig)
    return out, draws


def test_shift_point_cloud(monkeypatch):
    batch, gt = cloud(16, 3, 16, 3), cloud(17, 3, 32, 3)
    want, (shifts,) = captured(monkeypatch, "uniform",
                               jaugment.shift_point_cloud,
                               jax.random.PRNGKey(0), jnp.asarray(batch),
                               jnp.asarray(gt))
    got = taugment.shift_point_cloud_from(
        torch.from_numpy(batch), torch.from_numpy(shifts),
        torch.from_numpy(gt))
    assert_outputs(got, want, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    moved = taugment.shift_point_cloud(torch.from_numpy(batch), gen,
                                       shift_range=0.3)
    d = moved - torch.from_numpy(batch)
    assert torch.all(d.abs() <= 0.3 + 1e-6)
    torch.testing.assert_close(d, d[:, :1].expand_as(d), rtol=0, atol=1e-6)


def test_rotate_perturbation(monkeypatch):
    batch = cloud(18, 2, 64, 3)
    want, (normal,) = captured(monkeypatch, "normal",
                               jaugment.rotate_perturbation,
                               jax.random.PRNGKey(1), jnp.asarray(batch))
    got = taugment.rotate_perturbation_from(torch.from_numpy(batch),
                                            torch.from_numpy(normal))
    assert_outputs(got, want, atol=1e-6)
    out = taugment.rotate_perturbation(torch.from_numpy(batch),
                                       torch.Generator().manual_seed(1))
    np.testing.assert_allclose(torch.linalg.norm(out, dim=-1).numpy(),
                               np.linalg.norm(batch, axis=-1), rtol=1e-5)


def test_random_point_dropout(monkeypatch):
    batch = cloud(19, 3, 64, 3)
    want, (ratio_u, mask_u) = captured(
        monkeypatch, "uniform", jaugment.random_point_dropout,
        jax.random.PRNGKey(2), jnp.asarray(batch))
    got = taugment.random_point_dropout_from(torch.from_numpy(batch),
                                             torch.from_numpy(ratio_u),
                                             torch.from_numpy(mask_u))
    assert_outputs(got, want, atol=0)
    out = taugment.random_point_dropout(torch.from_numpy(batch),
                                        torch.Generator().manual_seed(2))
    kept = torch.all(out == torch.from_numpy(batch), dim=-1)
    first = torch.all(out == torch.from_numpy(batch)[:, :1], dim=-1)
    assert out.shape == batch.shape and torch.all(kept | first)


def test_shuffle_points(monkeypatch):
    batch = cloud(20, 2, 32, 3)
    want, (perm,) = captured(monkeypatch, "permutation",
                             jaugment.shuffle_points, jax.random.PRNGKey(3),
                             jnp.asarray(batch))
    got = taugment.shuffle_points_from(torch.from_numpy(batch),
                                       torch.from_numpy(perm))
    assert_outputs(got, want, atol=0)
    out = taugment.shuffle_points(torch.from_numpy(batch),
                                  torch.Generator().manual_seed(3))
    assert torch.equal(torch.sort(out, dim=1).values,
                       torch.sort(torch.from_numpy(batch), dim=1).values)
