"""The port's losses and schedules against the JAX package's, on the CPU.

Inputs are numpy clouds handed to both packages.  Values agree to f32
round-off of reductions taken in other orders (relative 1e-5); gradients
to 1e-5 of their largest entry.  Every selection inside (chamfer argmin,
ball query, kNN, stable top-5) is exact on both sides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.config import LossConfig as JLossConfig
from dispu_tpu_torch import losses as TL
from dispu_tpu_torch.config import LossConfig

JL = importlib.import_module("dispu_tpu.losses")

torch.set_num_threads(1)


def _clouds(seed, b=2, n=96, m=128, scale=0.3):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, n, 3).astype(np.float32) * scale,
            rng.rand(b, m, 3).astype(np.float32) * scale)


def _check(jfn, tfn, *arrays, rel=1e-5):
    """Value and gradient (w.r.t. every array) of a scalar loss."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tv = tfn(*ts)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=rel,
                               atol=1e-12)
    for t, g in zip(ts, jg):
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-30)
        assert float(np.abs(t.grad.numpy() - g).max()) <= rel * scale


@pytest.mark.parametrize("threshold", [None, 2.0])
def test_chamfer(threshold):
    pred, gt = _clouds(1)
    radius = np.asarray([1.0, 0.8], np.float32)
    _check(lambda p, g: JL.chamfer(p, g, jnp.asarray(radius), 0.5, threshold),
           lambda p, g: TL.chamfer(p, g, torch.from_numpy(radius), 0.5,
                                   threshold), pred, gt)


@pytest.mark.parametrize("threshold", [None, 0.01])
def test_hausdorff(threshold):
    pred, gt = _clouds(2)
    _check(lambda p, g: JL.hausdorff(p, g, 1.0, 1.0, threshold),
           lambda p, g: TL.hausdorff(p, g, 1.0, 1.0, threshold), pred, gt)


@pytest.mark.parametrize("use_knn,use_l1", [(False, False), (False, True),
                                            (True, False), (True, True)],
                         ids=["ball", "ball-l1", "knn", "knn-l1"])
def test_repulsion(use_knn, use_l1):
    pred, _ = _clouds(3, n=128, scale=0.3)
    pred[:, 100:110] = pred[:, 0:10] + 1e-3  # close pairs inside sqrt(h)
    _check(lambda p: JL.repulsion(p, 12, 0.07, use_knn, use_l1),
           lambda p: TL.repulsion(p, 12, 0.07, use_knn, use_l1), pred)


def test_uniform():
    _, pcd = _clouds(4, m=400, scale=1.0)
    _check(lambda p: JL.uniform(p), lambda p: TL.uniform(p), pcd, rel=1e-4)


def test_pu_losses():
    rng = np.random.RandomState(5)
    coarse, gt = _clouds(6, n=128, m=128)
    fine = coarse + rng.randn(*coarse.shape).astype(np.float32) * 0.01
    radius = np.ones(2, np.float32)
    jcfg, tcfg = JLossConfig(repulsion_nsample=8), LossConfig(
        repulsion_nsample=8)
    jtot, jm = JL.pu_losses(jnp.asarray(coarse), jnp.asarray(fine),
                            jnp.asarray(gt), jnp.asarray(radius), 0.1, jcfg)
    ttot, tm = TL.pu_losses(torch.from_numpy(coarse), torch.from_numpy(fine),
                            torch.from_numpy(gt), torch.from_numpy(radius),
                            0.1, tcfg)
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    _check(lambda c, f, g: JL.pu_losses(c, f, g, jnp.asarray(radius), 0.1,
                                        jcfg)[0],
           lambda c, f, g: TL.pu_losses(c, f, g, torch.from_numpy(radius),
                                        0.1, tcfg)[0], coarse, fine, gt)


@pytest.mark.parametrize("epoch", [0.0, 9.0, 10.0, 10.5, 20.0, 29.0, 30.0,
                                   45.0, 61.0, 400.0])
def test_schedules(epoch):
    """Equal bits: the schedules are f32 values of the epoch.  (XLA's f32
    power and PyTorch's may differ in the last bit at some exponents; at
    these, up to 13 decays, they agree.)"""
    assert TL.weight_fine_schedule(epoch) == float(
        JL.weight_fine_schedule(epoch))
    for kw in (dict(), dict(base_lr=1e-4, decay_rate=0.5, clip=1e-5)):
        assert TL.lr_schedule(epoch, **kw) == float(
            JL.lr_schedule(epoch, **kw))
