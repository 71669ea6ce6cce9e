"""The gather and scatter-add kernels' plain versions, their autograd rules
and ``knn_group``'s backward rule against the JAX package, on the CPU; the
routing of ``group_point(gather_impl='pallas')``; and CD train steps with
``gather_impl='pallas'`` and with ``fused_grouping`` against the JAX
package's.

The Pallas kernels run in interpret mode, as tests/test_pallas.py runs
them.  Inputs are made with numpy and handed to both packages.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.ops.pallas_kernels import (gather_rows_pallas,
                                          gather_rows_pallas_diff,
                                          knn_group_pallas_diff,
                                          scatter_rows_pallas)
from dispu_tpu_torch import kernels
from dispu_tpu_torch.kernels.gather_rows import (GatherRowsFunction,
                                                 gather_rows,
                                                 gather_rows_torch,
                                                 scatter_rows_torch)
from dispu_tpu_torch.kernels.knn_group import knn_group, rows_at
from dispu_tpu_torch.ops import grouping as tgrouping
from dispu_tpu_torch.ops.knn import mask_duplicate_rows
from test_torch_train import check_steps_match_jax, make_step_pair

# the package's ``grouping`` function shadows its module of that name
jgrouping = importlib.import_module("dispu_tpu.ops.grouping")

torch.set_num_threads(1)

#: f32 round-off of a row sum, relative to the sum of the absolute terms:
#: the JAX kernel sums each of its three bf16 terms of g on its own and then
#: adds the three sums; the port sums g in ascending position
SUM_REL = 2e-6


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _idx(seed, b, q, n):
    """(b, q) int32 indices in [0, n) with many repeats, every row hit."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, (b, q)).astype(np.int32)
    idx[:, :n] = rng.permutation(n)
    return idx


def _assert_row_sums(got, want, g, idx, n):
    """|got − want| within SUM_REL of each row's sum of |g|."""
    b, _, c = g.shape
    abs_sum = np.zeros((b, n, c), np.float32)
    for v in range(b):
        np.add.at(abs_sum[v], idx[v], np.abs(g[v]))
    err = np.abs(got - want)
    assert np.all(err <= SUM_REL * abs_sum), float(
        (err / np.maximum(abs_sum, 1e-30)).max())


# ------------------------------------------------------------ gather, scatter


@pytest.mark.parametrize("b,n,c,q", [(2, 50, 7, 30), (3, 256, 24, 600),
                                     (1, 1024, 131, 300)])
def test_gather_plain_bit_equal_to_pallas(b, n, c, q):
    table = _rand(n + c, b, n, c) * np.float32(3.7)
    idx = _idx(q, b, q, n) if q >= n else np.random.RandomState(q).randint(
        0, n, (b, q)).astype(np.int32)
    got = gather_rows_torch(torch.from_numpy(table), torch.from_numpy(idx))
    want = gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx),
                              interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,n,c,q", [(2, 20, 7, 200), (3, 64, 24, 1100),
                                     (1, 256, 131, 700)])
def test_scatter_plain_matches_pallas(b, n, c, q):
    """``scatter_rows_torch`` against ``scatter_rows_pallas`` in interpret
    mode (several query tiles at q > 512): within ``SUM_REL`` of each row's
    sum of |g| (observed ≤ 1.9e-7)."""
    g = _rand(q, b, q, c)
    idx = _idx(n, b, q, n)
    got = scatter_rows_torch(torch.from_numpy(g), torch.from_numpy(idx), n)
    want = scatter_rows_pallas(jnp.asarray(g), jnp.asarray(idx), n,
                               interpret=True)
    _assert_row_sums(got.numpy(), np.asarray(want), g, idx, n)


def test_scatter_plain_sums_in_ascending_position():
    """The plain version adds each row's terms in ascending position (the
    kernel's order): equal bits to a sequential f32 sum."""
    g = _rand(5, 2, 300, 9) * np.float32(1e3)
    g[:, ::7] *= np.float32(1e-6)
    idx = _idx(6, 2, 300, 17)
    got = scatter_rows_torch(torch.from_numpy(g), torch.from_numpy(idx), 17)
    want = np.zeros((2, 17, 9), np.float32)
    for v in range(2):
        for r in range(300):
            want[v, idx[v, r]] = want[v, idx[v, r]] + g[v, r]
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_rows_function_matches_jax_vjp():
    """``GatherRowsFunction`` (plain versions) against ``jax.vjp`` of
    ``gather_rows_pallas_diff`` in interpret mode, whose backward is
    ``scatter_rows_pallas``: the gather bit-equal, the table's gradient
    within ``SUM_REL`` of each row's sum of |g|."""
    b, n, c, q = 2, 40, 11, 300
    table = _rand(1, b, n, c)
    idx = _idx(2, b, q, n)
    cot = _rand(3, b, q, c)
    want, vjp = jax.vjp(lambda t: gather_rows_pallas_diff(
        t, jnp.asarray(idx), 512, True), jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_(True)
    got = GatherRowsFunction.apply(t, torch.from_numpy(idx), False)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    torch.sum(got * torch.from_numpy(cot)).backward()
    _assert_row_sums(t.grad.numpy(), np.asarray(want_grad), cot, idx, n)
    # gather_rows on a CPU tensor is this Function with the plain versions
    t2 = torch.from_numpy(table).requires_grad_(True)
    torch.sum(gather_rows(t2, torch.from_numpy(idx))
              * torch.from_numpy(cot)).backward()
    np.testing.assert_array_equal(t2.grad.numpy(), t.grad.numpy())


# -------------------------------------------------------- knn_group backward


def _knn_group_grads(k, pts, q, feats, bias, cots, with_xyz, drop_first,
                     aliased):
    """(port gradients, JAX gradients) of sum(cot · output) over the
    differentiable outputs (dists, grouped xyz, grouped features)."""
    def pick(out):
        return tuple(o for o, keep in zip((out[0], out[2], out[3]),
                                          (True, with_xyz, True)) if keep)

    jb = None if bias is None else jnp.asarray(bias)
    if aliased:  # points = queries = feats, one tensor (the backbone)
        def f(x):
            return pick(knn_group_pallas_diff(k, x, x, x, jb, True, True,
                                              with_xyz, drop_first))
        args = (jnp.asarray(pts),)
    else:        # points = queries, separate feats (the refiner)
        def f(x, ft):
            return pick(knn_group_pallas_diff(k, x, x, ft, jb, True, True,
                                              with_xyz, drop_first))
        args = (jnp.asarray(pts), jnp.asarray(feats))
    _, vjp = jax.vjp(f, *args)
    want = [np.asarray(w) for w in vjp(tuple(jnp.asarray(c) for c in cots))]

    tp = torch.from_numpy(pts).requires_grad_(True)
    tf = tp if aliased else torch.from_numpy(feats).requires_grad_(True)
    out = knn_group(k, tp, tp, tf,
                    None if bias is None else torch.from_numpy(bias),
                    exact=True, with_xyz=with_xyz, drop_first=drop_first)
    loss = sum(torch.sum(o * torch.from_numpy(c))
               for o, c in zip(pick(out), cots))
    loss.backward()
    got = [tp.grad.numpy()] + ([] if aliased else [tf.grad.numpy()])
    return got, want


@pytest.mark.parametrize("with_dist", [False, True],
                         ids=["rows_only", "with_dists"])
def test_knn_group_backward_backbone_form(with_dist):
    """The backbone's call (points = queries = feats one tensor,
    drop_first, duplicate rows biased by 1e30): the three gradients summed
    into the tensor, against ``jax.vjp`` of ``knn_group_pallas_diff`` in
    interpret mode, to 1e-5 of the largest gradient (f32 sums in other
    orders; observed ≤ 6.8e-8)."""
    b, n, c, k = 2, 96, 24, 8
    x = _rand(7, b, n, c)
    x[:, -6:] = x[:, :6]
    bias = (mask_duplicate_rows(torch.from_numpy(x)).numpy()
            .astype(np.float32) * np.float32(1e30))
    g_dist = _rand(8, b, n, k) * np.float32(with_dist)
    cots = (g_dist, _rand(9, b, n, k, c))
    got, want = _knn_group_grads(k, x, x, x, bias, cots, False, True, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_knn_group_backward_refiner_form():
    """The refiner's call (3-d points that are also the queries, separate
    features, with_xyz): gradients of points and features against
    ``jax.vjp`` of ``knn_group_pallas_diff`` in interpret mode, to 1e-5 of
    the largest (observed ≤ 5.8e-8)."""
    b, n, c, k = 2, 96, 16, 8
    pts = _rand(10, b, n, 3)
    feats = _rand(11, b, n, c)
    cots = (_rand(12, b, n, k), _rand(13, b, n, k, 3), _rand(14, b, n, k, c))
    got, want = _knn_group_grads(k, pts, pts, feats, None, cots, True, False,
                                 False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_knn_group_without_grad_cotangents_gives_rows_only_gradient():
    """An unused distance output contributes nothing: the gradient of the
    features is the gather transpose alone, as autograd of the plain
    gather gives it."""
    b, n, c, k = 1, 64, 5, 6
    pts = torch.from_numpy(_rand(15, b, n, 3))
    feats = torch.from_numpy(_rand(16, b, n, c)).requires_grad_(True)
    cot = torch.from_numpy(_rand(17, b, n, k, c))
    _, idx, _, gf = knn_group(k, pts, pts, feats, with_xyz=False)
    torch.sum(gf * cot).backward()
    ref = feats.detach().clone().requires_grad_(True)
    torch.sum(rows_at(ref, idx) * cot).backward()
    np.testing.assert_allclose(feats.grad.numpy(), ref.grad.numpy(),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("shape,fits", [
    ((28, 256, 24), True), ((28, 256, 48), True),    # backbone, pass 1
    ((28, 1024, 24), True), ((28, 1024, 48), True),  # backbone, 16x pass 2
    ((28, 1024, 131), True),                         # 4x refiner [xyz|feat]
    ((28, 4096, 131), False),                        # 16x pass-2 refiner
    ((2, 4096, 128), True), ((2, 100, 257), False), ((2, 4097, 3), False),
])
def test_group_point_gate(shape, fits):
    """``gather_fits`` is the JAX package's gate: n ≤ 4096, c ≤ 256,
    n·c ≤ 524,288 (4096 · 131 = 536,576 is past it)."""
    assert tgrouping.gather_fits(torch.zeros(shape)) == fits
    assert not tgrouping.gather_fits(torch.zeros(shape, dtype=torch.float64))


def test_group_point_pallas_on_cpu_is_the_plain_gather():
    """On the CPU 'pallas' takes the plain gather and launches nothing:
    bit-equal to the JAX package's ``group_point(impl='pallas')`` and to
    its gradient; impl='cuda' raises inside the gate (no card) and outside
    it (the gate)."""
    pts = _rand(20, 2, 60, 9)
    idx = np.random.RandomState(21).randint(0, 60, (2, 30, 5)).astype(
        np.int32)
    kernels.reset_launch_counts()
    t = torch.from_numpy(pts).requires_grad_(True)
    got = tgrouping.group_point(t, torch.from_numpy(idx), "pallas")
    want = jgrouping.group_point(jnp.asarray(pts), jnp.asarray(idx),
                                 impl="pallas")
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert sum(kernels.launch_counts().values()) == 0
    cot = _rand(22, 2, 30, 5, 9)
    torch.sum(got * torch.from_numpy(cot)).backward()
    (want_grad,) = jax.vjp(lambda p: jgrouping.group_point(
        p, jnp.asarray(idx), impl="pallas"), jnp.asarray(pts))[1](
        jnp.asarray(cot))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        tgrouping.group_point(t, torch.from_numpy(idx), "pallas",
                              impl="cuda")
    with pytest.raises(ValueError, match="n <= 4096"):
        tgrouping.group_point(torch.zeros(1, 4097, 3),
                              torch.from_numpy(idx[:1]), "pallas",
                              impl="cuda")


# ------------------------------------------------------------ train steps


@pytest.mark.parametrize("generator", [dict(gather_impl="pallas"),
                                       dict(fused_grouping=True)],
                         ids=["pallas_gather", "fused_grouping"])
def test_train_step_matches_jax(generator):
    """Two CD steps with the gather kernels' setting and with the fused
    kNN + gather (its backward rule, on the CPU through ``index_add_``)
    against the JAX package's steps with the same setting (on the CPU its
    composed path), held to test_torch_train.py's bounds."""
    check_steps_match_jax(make_step_pair(generator))
