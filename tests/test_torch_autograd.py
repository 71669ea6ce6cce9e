"""The port's autograd rules against the JAX package's custom VJPs, on the
CPU.

* ``kernels.knn.KnnFunction`` (forward: the plain kNN here) against the
  VJP of ``knn_pallas_diff`` run in interpret mode;
* ``kernels.attention.AttentionFunction`` (forward: the plain bf16
  version here, backward in f32) against the VJP of
  ``attention_pallas_diff`` in interpret mode, whose backward on the CPU
  also runs in f32; and ``nn.attention.global_attention``'s CPU path
  (plain f32 under ordinary autograd) against ``attention_xla``'s;
* ``ops.chamfer.nn_distance`` against the JAX package's ``nn_distance``.

Gradients agree to f32 round-off of sums taken in other orders: each
bound is relative to the largest entry of the gradient it checks.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.ops.pallas_kernels import (attention_pallas_diff,
                                          attention_xla, knn_pallas_diff)
from dispu_tpu_torch.kernels.attention import AttentionFunction
from dispu_tpu_torch.kernels.knn import KnnFunction
from dispu_tpu_torch.nn.attention import global_attention
from dispu_tpu_torch.ops.chamfer import nn_distance

jchamfer = importlib.import_module("dispu_tpu.ops.chamfer")

torch.set_num_threads(1)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()), scale)


def _t(x):
    return torch.from_numpy(np.asarray(x)).requires_grad_(True)


@pytest.mark.parametrize("b,n,m,c,k,dup", [(2, 64, 64, 3, 1, False),
                                           (2, 96, 40, 8, 6, True)])
def test_knn_function_matches_knn_pallas_diff(b, n, m, c, k, dup):
    rng = np.random.RandomState(n)
    pts = rng.randn(b, n, c).astype(np.float32)
    qs = rng.randn(b, m, c).astype(np.float32)
    bias = np.zeros((b, n), np.float32)
    if dup:
        pts[:, -8:] = pts[:, :8]
        bias[:, -8:] = 1e30
    g = rng.randn(b, m, k).astype(np.float32)

    def f(p, q):
        return knn_pallas_diff(k, p, q, jnp.asarray(bias), True)[0]

    (jd, jidx), = [knn_pallas_diff(k, jnp.asarray(pts), jnp.asarray(qs),
                                   jnp.asarray(bias), True)]
    _, vjp = jax.vjp(f, jnp.asarray(pts), jnp.asarray(qs))
    jgp, jgq = vjp(jnp.asarray(g))

    tp, tq = _t(pts), _t(qs)
    td, tidx = KnnFunction.apply(k, tp, tq, torch.from_numpy(bias), False)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx.requires_grad is False
    td.backward(torch.from_numpy(g))
    _close(td.detach(), jd, 1e-6)
    _close(tp.grad, jgp, 1e-6)
    _close(tq.grad, jgq, 1e-6)


@pytest.mark.parametrize("c", [3, 24])
def test_knn_packed_gradient_matches_knn_pallas_diff(c):
    """The packed selection's truncated distances carry the exact rule's
    gradient at the packed selection (``_knn_diff_bwd`` for every
    variant): torch.autograd.grad of sum(w * dist) against jax.grad
    through ``knn_pallas_diff(variant='packed')`` in interpret mode."""
    from dispu_tpu_torch.kernels.knn import knn_packed

    b, n, m, k = 2, 128, 64, 8
    rng = np.random.RandomState(c)
    pts = rng.randn(b, n, c).astype(np.float32)
    qs = rng.randn(b, m, c).astype(np.float32)
    w = rng.randn(b, m, k).astype(np.float32)
    bias = jnp.zeros((b, n), jnp.float32)

    def loss(p, q):
        d = knn_pallas_diff(k, p, q, bias, True, "packed")[0]
        return jnp.sum(jnp.asarray(w) * d)

    jgp, jgq = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pts),
                                              jnp.asarray(qs))
    _, jidx = knn_pallas_diff(k, jnp.asarray(pts), jnp.asarray(qs), bias,
                              True, "packed")
    tp, tq = _t(pts), _t(qs)
    td, tidx = knn_packed(k, tp, tq)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    tgp, tgq = torch.autograd.grad(torch.sum(torch.from_numpy(w) * td),
                                   (tp, tq))
    _close(tgp, jgp, 1e-5)
    _close(tgq, jgq, 1e-5)


def test_attention_function_matches_attention_pallas_diff():
    rng = np.random.RandomState(7)
    b, nq, nk, c, cv = 2, 48, 40, 16, 12
    q, k, v = (rng.randn(b, n, w).astype(np.float32)
               for n, w in ((nq, c), (nk, c), (nk, cv)))
    do = rng.randn(b, nq, cv).astype(np.float32)
    scale = 1.0 / np.sqrt(c)

    def f(q_, k_, v_):
        return attention_pallas_diff(q_, k_, v_, scale, 256, True)

    jout, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = AttentionFunction.apply(tq, tk, tv, scale, False)
    out.backward(torch.from_numpy(do))
    # forward: both round q, k, v and p to bf16 and sum in f32
    _close(out.detach(), jout, 1e-5)
    # backward: both recompute the map in f32
    _close(tq.grad, jdq, 1e-5)
    _close(tk.grad, jdk, 1e-5)
    _close(tv.grad, jdv, 1e-5)


def test_global_attention_cpu_gradients_match_attention_xla():
    rng = np.random.RandomState(8)
    q, k, v = (rng.randn(2, 32, 8).astype(np.float32) for _ in range(3))
    w = rng.randn(2, 32, 8).astype(np.float32)

    def f(q_, k_, v_):
        return jnp.sum(attention_xla(q_, k_, v_, 0.5) * w)

    jg = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q), _t(k), _t(v)
    torch.sum(global_attention(tq, tk, tv, 0.5) * torch.from_numpy(w)
              ).backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("n,m", [(80, 64), (30, 50)])
def test_nn_distance_gradients_match_jax(n, m):
    rng = np.random.RandomState(n + m)
    x1 = rng.randn(2, n, 3).astype(np.float32)
    x2 = rng.randn(2, m, 3).astype(np.float32)
    x2[:, :5] = x1[:, :5]  # coincident points: zero distances
    w1 = rng.rand(2, n).astype(np.float32)
    w2 = rng.rand(2, m).astype(np.float32)

    def f(a, b):
        d1, _, d2, _ = jchamfer.nn_distance(a, b)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    jd1, ji1, jd2, ji2 = jchamfer.nn_distance(jnp.asarray(x1),
                                              jnp.asarray(x2))
    jg1, jg2 = jax.grad(f, argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    t1, t2 = _t(x1), _t(x2)
    d1, i1, d2, i2 = nn_distance(t1, t2)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))
    # the forward recomputes |p − q*|² from the matched pair: same bits
    np.testing.assert_array_equal(d1.detach().numpy(), np.asarray(jd1))
    np.testing.assert_array_equal(d2.detach().numpy(), np.asarray(jd2))
    (torch.sum(d1 * torch.from_numpy(w1))
     + torch.sum(d2 * torch.from_numpy(w2))).backward()
    _close(t1.grad, jg1, 1e-6)
    _close(t2.grad, jg2, 1e-6)
