"""The port's PointNet++ modules (``nn/pointnet.py``) against the JAX
package's, on the CPU.

Inputs are seeded numpy clouds; weights a flax init with every bias and
batch-norm leaf moved off its init value, carried over by
``convert.from_flax_variables`` (which refuses a leaf left unused or a
parameter left unfilled).  FPS, the ball query, the kNN and three-NN run
on xyz that are exact gathers of the input, so every selection (the
seeds, the neighbourhoods, the three nearest) is bit-equal; the values
agree to f32 round-off of products summed in other orders: 1e-5 of the
largest entry of each output (or 1e-5 where that is below 1; batch norm
in training mode divides by the batch's spread, which magnifies the
round-off of its input).  In training mode the batch-norm running
statistics move as flax's do, to the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.nn import pointnet as jpointnet
from dispu_tpu_torch.convert import _leaves, _torch_key, from_flax_variables
from dispu_tpu_torch.nn import pointnet as tpointnet
from test_torch_generator import perturbed_numpy_tree

torch.set_num_threads(1)

ATOL = 1e-5


def cloud(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(
        np.float32)


def _as_jax(xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _as_torch(xs):
    return [None if x is None else torch.from_numpy(np.array(x)) for x in xs]


def assert_outputs(got, want, atol=ATOL):
    """Tuples (or single outputs) equal: integer leaves bit for bit, float
    leaves within ``atol`` times the largest magnitude of the expected
    leaf (``atol`` itself where that is below 1)."""
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            np.testing.assert_allclose(g, w, rtol=0, atol=atol * scale)


def flax_variables(jmod, xs, seed=0, edit=None, **init_kw):
    """A perturbed numpy tree of ``jmod``'s flax init on ``xs``; ``edit``
    may change it in place (a zero-initialised parameter made non-zero)."""
    variables = perturbed_numpy_tree(
        jmod.init(jax.random.PRNGKey(seed), *_as_jax(xs), **init_kw), seed,
        shift=0.1)
    if edit is not None:
        edit(variables)
    return variables


def compare(jmod, tmod, xs, seed=0, train=False, atol=ATOL, edit=None,
            jax_kw=None, torch_kw=None):
    """Run ``jmod`` and ``tmod`` on the same inputs and weights, in eval or
    (``train``) in training mode, and hold the outputs (and in training
    the running statistics) to each other.  Returns the flax variables."""
    variables = flax_variables(jmod, xs, seed, edit)
    from_flax_variables(tmod, variables)
    tmod.train(train)
    jax_kw, torch_kw = jax_kw or {}, torch_kw or {}
    if train:
        want, updated = jmod.apply(variables, *_as_jax(xs), train=True,
                                   mutable=["batch_stats"], **jax_kw)
    else:
        want = jmod.apply(variables, *_as_jax(xs), **jax_kw)
    with torch.no_grad():
        got = tmod(*_as_torch(xs), **torch_kw)
    assert_outputs(got, want, atol)
    if train and "batch_stats" in variables:
        state = tmod.state_dict()
        for path, leaf in _leaves(updated["batch_stats"]):
            np.testing.assert_allclose(state[_torch_key(path)[0]].numpy(),
                                       np.asarray(leaf), rtol=0, atol=atol)
    return variables


def compare_f64(make_jmod, tmod, xs, seed=0, edit=None, atol=1e-10):
    """Training mode in f64 on both sides (JAX under x64, ``make_jmod``
    called with the flax ``dtype``; the port's module in double): where
    f32 batch norm over a small batch magnifies round-off past 1e-5, the
    outputs agree to ``atol`` of their largest entry (or ``atol``), and
    the running statistics, which flax keeps in f32, to 1e-6."""
    xs = [x.astype(np.float64) if x is not None
          and np.issubdtype(x.dtype, np.floating) else x for x in xs]
    with jax.enable_x64(True):
        jmod = make_jmod(jnp.float64)
        variables = flax_variables(jmod, xs, seed, edit)
        want, updated = jmod.apply(variables, *_as_jax(xs), train=True,
                                   mutable=["batch_stats"])
        want = jax.tree_util.tree_map(np.asarray, want)
        stats = jax.tree_util.tree_map(np.asarray, updated["batch_stats"])
    from_flax_variables(tmod, variables).double().train()
    with torch.no_grad():
        got = tmod(*_as_torch(xs))
    for g in got if isinstance(got, tuple) else (got,):
        assert not g.is_floating_point() or g.dtype == torch.float64
    assert_outputs(got, want, atol)
    state = tmod.state_dict()
    for path, leaf in _leaves(stats):
        np.testing.assert_allclose(state[_torch_key(path)[0]].numpy(), leaf,
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------- grouping helpers


@pytest.mark.parametrize("use_knn", [False, True])
@pytest.mark.parametrize("with_points,use_xyz", [
    (False, True), (True, True), (True, False)])
def test_sample_and_group(use_knn, with_points, use_xyz):
    xyz = cloud(0, 2, 96, 3)
    points = cloud(1, 2, 96, 5) if with_points else None
    want = jpointnet.sample_and_group(
        24, 0.25, 8, jnp.asarray(xyz),
        None if points is None else jnp.asarray(points), use_knn, use_xyz)
    got = tpointnet.sample_and_group(
        24, 0.25, 8, torch.from_numpy(xyz),
        None if points is None else torch.from_numpy(points), use_knn,
        use_xyz)
    # the gathers and the centring are exact: bit-equal throughout
    assert_outputs(got, want, atol=0)
    if not use_knn:  # some balls hold fewer than nsample points
        idx = np.asarray(want[2])
        assert (idx == idx[..., :1]).all(-1).any()


@pytest.mark.parametrize("with_points,use_xyz", [
    (False, True), (True, True), (True, False)])
def test_sample_and_group_all(with_points, use_xyz):
    xyz = cloud(2, 2, 40, 3)
    points = cloud(3, 2, 40, 6) if with_points else None
    want = jpointnet.sample_and_group_all(
        jnp.asarray(xyz), None if points is None else jnp.asarray(points),
        use_xyz)
    got = tpointnet.sample_and_group_all(
        torch.from_numpy(xyz),
        None if points is None else torch.from_numpy(points), use_xyz)
    assert_outputs(got, want, atol=0)


# -------------------------------------------------------------------- modules


@pytest.mark.parametrize("pooling", ["max", "avg", "weighted_avg",
                                     "max_and_avg"])
@pytest.mark.parametrize("use_bn,train", [(False, False), (True, True)])
def test_sa_module_poolings(pooling, use_bn, train):
    xyz, points = cloud(4, 2, 96, 3), cloud(5, 2, 96, 7)
    kw = dict(npoint=24, radius=0.25, nsample=8, mlp=(16, 12),
              pooling=pooling, use_bn=use_bn)
    compare(jpointnet.PointNetSAModule(**kw),
            tpointnet.PointNetSAModule(7, **kw), [xyz, points], train=train)


@pytest.mark.parametrize("case", [
    dict(mlp2=(20, 10)),
    dict(mlp2=(20,), pooling="max_and_avg"),
    dict(use_knn=True),
    dict(use_xyz=False),
    dict(group_all=True),
    dict(group_all=True, pooling="weighted_avg", use_bn=True),
])
def test_sa_module_options(case):
    xyz, points = cloud(6, 2, 64, 3), cloud(7, 2, 64, 5)
    kw = dict(npoint=16, radius=0.3, nsample=8, mlp=(12, 16), **case)
    compare(jpointnet.PointNetSAModule(**kw),
            tpointnet.PointNetSAModule(5, **kw), [xyz, points],
            train=case.get("use_bn", False))


def test_sa_module_without_points():
    xyz = cloud(8, 2, 64, 3)
    kw = dict(npoint=16, radius=0.3, nsample=8, mlp=(12,))
    compare(jpointnet.PointNetSAModule(**kw),
            tpointnet.PointNetSAModule(0, **kw), [xyz, None])


def test_sa_module_refuses_unknown_pooling():
    with pytest.raises(ValueError, match="pooling"):
        tpointnet.PointNetSAModule(0, 16, 0.3, 8, (12,), pooling="median")


def test_sa_module_training_on_equal_rows_in_f64():
    """Balls that hold only their centre give equal grouped rows, where
    flax's batch variance E[x²] − E[x]² cancels: f32 reads 8.8e-4 apart
    (the cancellation's round-off), f64 agrees (``compare_f64``)."""
    kw = dict(npoint=64, radius=0.1, nsample=8, mlp=(32, 32, 64),
              use_bn=True)
    compare_f64(lambda dtype: jpointnet.PointNetSAModule(**kw, dtype=dtype),
                tpointnet.PointNetSAModule(0, **kw), [cloud(0, 2, 128, 3),
                                                      None])


@pytest.mark.parametrize("use_knn,with_points,use_bn", [
    (False, True, False), (True, True, False), (False, False, False),
    (False, True, True)])
def test_sa_module_msg(use_knn, with_points, use_bn):
    xyz = cloud(9, 2, 96, 3)
    points = cloud(10, 2, 96, 6) if with_points else None
    kw = dict(npoint=20, radius_list=(0.15, 0.3), nsample_list=(4, 8),
              mlp_list=((8, 12), (10,)), use_knn=use_knn, use_bn=use_bn)
    compare(jpointnet.PointNetSAModuleMSG(**kw),
            tpointnet.PointNetSAModuleMSG(6 if with_points else 0, **kw),
            [xyz, points], train=use_bn)


@pytest.mark.parametrize("m,with_skip,use_bn", [
    (24, True, False), (24, False, False), (2, True, False), (1, True, False),
    (24, True, True)])
def test_fp_module(m, with_skip, use_bn):
    # m < 3 source points: the nearest is repeated, as in the JAX package
    xyz1, xyz2 = cloud(11, 2, 64, 3), cloud(12, 2, m, 3)
    points1 = cloud(13, 2, 64, 5) if with_skip else None
    points2 = cloud(14, 2, m, 9)
    kw = dict(mlp=(16, 8), use_bn=use_bn)
    compare(jpointnet.PointNetFPModule(**kw),
            tpointnet.PointNetFPModule(9, 5 if with_skip else 0, **kw),
            [xyz1, xyz2, points1, points2], train=use_bn)


def test_out_features_fit_the_next_layer():
    """The widths the port computes for itself (flax infers them)."""
    sa = tpointnet.PointNetSAModule(0, 16, 0.3, 8, (12, 16),
                                    pooling="max_and_avg")
    assert sa.conv0.dense.in_features == 3 and sa.out_features == 32
    sa = tpointnet.PointNetSAModule(32, 16, 0.3, 8, (12,), mlp2=(7,))
    assert sa.conv0.dense.in_features == 35 and sa.out_features == 7
    msg = tpointnet.PointNetSAModuleMSG(4, 8, (0.1, 0.2), (4, 8),
                                        ((8,), (5, 6)), use_xyz=False)
    assert msg.conv1_0.dense.in_features == 4 and msg.out_features == 14
    fp = tpointnet.PointNetFPModule(9, 5, (16, 8))
    assert fp.conv_0.dense.in_features == 14 and fp.out_features == 8
