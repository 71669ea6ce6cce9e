"""Each ported module against its flax counterpart, on the CPU.

Weights are a random flax init with every bias and batch-norm leaf moved
off its init value, carried over by ``dispu_tpu_torch.convert``.  The
bound is f32 round-off (the sum orders of XLA and PyTorch differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.nn import attention as jattention
from dispu_tpu.nn import edgeconv as jedgeconv
from dispu_tpu.nn import layers as jlayers
from dispu_tpu.nn import refine as jrefine
from dispu_tpu.nn import upsample as jupsample
from dispu_tpu_torch.convert import from_flax_variables
from dispu_tpu_torch.nn import attention as tattention
from dispu_tpu_torch.nn import edgeconv as tedgeconv
from dispu_tpu_torch.nn import layers as tlayers
from dispu_tpu_torch.nn import refine as trefine
from dispu_tpu_torch.nn import upsample as tupsample
from test_torch_generator import perturbed_numpy_tree

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(seed, *shapes, n_dup=0):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    if n_dup:  # duplicated rows in the first input (feature-space kNN)
        xs[0][:, -n_dup:] = xs[0][:, :n_dup]
    return xs


def _compare(jmod, tmod, xs, seed=0, atol=ATOL):
    variables = perturbed_numpy_tree(
        jmod.init(jax.random.PRNGKey(seed), *map(jnp.asarray, xs)), seed,
        shift=0.1)
    from_flax_variables(tmod, variables)
    tmod.eval()
    want = jmod.apply(variables, *map(jnp.asarray, xs))
    with torch.inference_mode():
        got = tmod(*map(torch.from_numpy, xs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)
    return variables


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("linear", [False, True])
def test_point_conv(use_bn, linear):
    act = None if linear else jax.nn.relu
    _compare(jlayers.PointConv(16, activation=act, use_bn=use_bn),
             tlayers.PointConv(8, 16, activation=None if linear
                               else torch.relu, use_bn=use_bn),
             _inputs(1, (2, 10, 8)))


def test_permuted_row_dense():
    _compare(jlayers._PermutedRowDense(7, inner=(5, 4)),
             tlayers._PermutedRowDense((5, 4), 7), _inputs(2, (2, 10, 20)))


def test_point_conv_kernel_row_perm():
    _compare(jlayers.PointConv(7, kernel_row_perm=(5, 4)),
             tlayers.PointConv(20, 7, kernel_row_perm=(5, 4)),
             _inputs(3, (2, 10, 20)))


def test_point_mlp():
    _compare(jlayers.PointMLP((12, 6), use_bn=True),
             tlayers.PointMLP(5, (12, 6), use_bn=True),
             _inputs(4, (2, 9, 5)))


def test_weight_net_hidden():
    _compare(jlayers.WeightNetHidden((8,)),
             tlayers.WeightNetHidden(3, (8,)), _inputs(5, (2, 10, 6, 3)))


@pytest.mark.parametrize("use_bn", [False, True])
def test_dense_edge_block(use_bn):
    # outputs (features, idx): the kNN indices must be equal
    _compare(jedgeconv.DenseEdgeBlock(8, n=3, k=6, use_bn=use_bn),
             tedgeconv.DenseEdgeBlock(12, 8, n=3, k=6, use_bn=use_bn),
             _inputs(6, (2, 32, 12), n_dup=3))


def test_feature_extractor_gcn():
    _compare(jedgeconv.FeatureExtractorGCN(growth_rate=8, dense_block=3,
                                           dense_n=3, k=6),
             tedgeconv.FeatureExtractorGCN(3, 8, 3, 3, 6),
             _inputs(7, (2, 48, 3)))


@pytest.mark.parametrize("up_ratio", [4, 6])
def test_duplicate_up(up_ratio):
    _compare(jupsample.DuplicateUp(up_ratio=up_ratio),
             tupsample.DuplicateUp(20, up_ratio=up_ratio),
             _inputs(8, (2, 16, 20)))


@pytest.mark.parametrize("offset_range", [None, 0.5])
def test_coordinate_regressor(offset_range):
    _compare(jupsample.CoordinateRegressor(offset_range=offset_range),
             tupsample.CoordinateRegressor(12, offset_range=offset_range),
             _inputs(9, (2, 16, 12)))


def test_point_non_local_cell():
    _compare(jattention.PointNonLocalCell(bottleneck=16, out_features=24),
             tattention.PointNonLocalCell(20, 20, 16, 24),
             _inputs(10, (2, 40, 20), (2, 1, 40, 20)))


@pytest.mark.parametrize("use_nonlocal,use_local,use_bn", [
    (True, True, False), (True, False, False), (False, True, False),
    (True, True, True),
])
def test_point_shuffle2(use_nonlocal, use_local, use_bn):
    _compare(jrefine.PointShuffle2(nsample=8, mlp=(16, 16, 32),
                                   use_nonlocal=use_nonlocal,
                                   use_local=use_local, use_bn=use_bn),
             trefine.PointShuffle2(20, 8, (16, 16, 32),
                                   use_nonlocal=use_nonlocal,
                                   use_local=use_local, use_bn=use_bn),
             _inputs(11, (2, 64, 3), (2, 64, 20)))


# ----------------------------------------------------------------- convert

def _conv_tree(c_in=8, seed=0, use_bn=True):
    """A perturbed flax tree of ``PointConv(16)`` over ``c_in`` inputs."""
    jmod = jlayers.PointConv(16, use_bn=use_bn)
    x = jnp.zeros((1, 4, c_in), jnp.float32)
    return perturbed_numpy_tree(jmod.init(jax.random.PRNGKey(seed), x), seed,
                                shift=0.1)


def test_convert_rejects_missing_leaf():
    tree = _conv_tree()
    del tree["batch_stats"]["bn"]["mean"]
    with pytest.raises(ValueError, match="unfilled.*bn.mean"):
        from_flax_variables(tlayers.PointConv(8, 16, use_bn=True), tree)


def test_convert_rejects_extra_leaf():
    tree = _conv_tree()
    tree["params"]["extra"] = {"kernel": np.zeros((8, 16), np.float32)}
    with pytest.raises(ValueError, match="unused.*params/extra/kernel"):
        from_flax_variables(tlayers.PointConv(8, 16, use_bn=True), tree)


def test_convert_rejects_wrong_shape():
    tree = _conv_tree(c_in=9, use_bn=False)
    with pytest.raises(ValueError, match="shape"):
        from_flax_variables(tlayers.PointConv(8, 16), tree)


def test_convert_fills_every_leaf_exactly():
    """Round trip: the converted weights are the flax leaves, bit for bit
    (dense kernels transposed)."""
    tree = _conv_tree(seed=1)
    tmod = from_flax_variables(tlayers.PointConv(8, 16, use_bn=True), tree)
    state = tmod.state_dict()
    np.testing.assert_array_equal(state["dense.weight"].numpy(),
                                  tree["params"]["dense"]["kernel"].T)
    np.testing.assert_array_equal(state["bn.var"].numpy(),
                                  tree["batch_stats"]["bn"]["var"])
