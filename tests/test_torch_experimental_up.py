"""The port's up-shuffle family and small units of ``nn/experimental.py``
against the JAX package's, on the CPU, with the bounds and helpers of
``tests/test_torch_experimental.py`` (the ASNL set abstraction, the
downscalers, the shufflers, ``EdgeConv`` and the dense-block variants
are there): values to 1e-5 of each output's largest entry, gradients
against ``jax.grad`` to 1e-5 of the gradient's largest entry,
training-mode batch norm in f64 to 1e-10, orderings bit-equal on
integer weights and inputs.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dispu_tpu.nn import experimental as jexp
from dispu_tpu_torch.convert import from_flax_variables
from dispu_tpu_torch.nn import edgeconv as tedge
from dispu_tpu_torch.nn import experimental as texp
from dispu_tpu_torch.nn.layers import init_weights
from test_torch_experimental import (ASNL, check, integer_cloud,
                                     integer_tree)
from test_torch_pointnet import (assert_outputs, cloud, compare_f64,
                                 flax_variables)

torch.set_num_threads(1)


# --------------------------------------------------- the upsampling family


@pytest.mark.parametrize("variant", [1, 2])
def test_up_shuffle_layer_ordering_bit_equal(variant):
    """Integer weights and inputs: the conv is exact on both sides, so the
    orderings are held bit for bit; the two variants differ."""
    x = integer_cloud(23, 2, 6, 5)
    jmod = jexp.UpShuffleLayer(up_ratio=4, variant=variant)
    variables = integer_tree(flax_variables(jmod, [x]))
    tmod = from_flax_variables(texp.UpShuffleLayer(5, 4, variant), variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert_outputs(got, jmod.apply(variables, jnp.asarray(x)), atol=0)
    other = from_flax_variables(texp.UpShuffleLayer(5, 4, 3 - variant),
                                variables)
    with torch.no_grad():
        assert not torch.equal(got, other(torch.from_numpy(x)))


@pytest.mark.parametrize("variant", [1, 2])
def test_up_shuffle_layer(variant):
    check(jexp.UpShuffleLayer(up_ratio=4, variant=variant),
          texp.UpShuffleLayer(10, 4, variant), [cloud(24, 2, 16, 10)])


@pytest.mark.parametrize("use_bn", [False, True])
def test_up_shuffle_layer3(use_bn):
    tmod = texp.UpShuffleLayer3(10, up_ratio=4, k=8, use_bn=use_bn)
    check(jexp.UpShuffleLayer3(up_ratio=4, k=8, use_bn=use_bn), tmod,
          [cloud(25, 2, 32, 10)])


@pytest.mark.parametrize("up_ratio,k", [(4, 8), (2, 8)])
def test_up_shuffle_layer4(up_ratio, k):
    tmod = texp.UpShuffleLayer4(6, up_ratio=up_ratio, k=k)
    check(jexp.UpShuffleLayer4(up_ratio=up_ratio, k=k), tmod,
          [cloud(26, 2, 32, 6)])
    assert tmod.up_shuffle_layer1.dense.in_features == 2 * k * 12


def test_up_shuffle_layer4_ordering_bit_equal():
    """Exact integer features give exact distances, so the graph ties as
    JAX's does only where the index order decides: the test asserts the
    graph first, then the fold and re-split bit for bit."""
    x = integer_cloud(27, 2, 24, 3) + np.arange(24, dtype=np.float32)[
        None, :, None] * 16
    jmod = jexp.UpShuffleLayer4(up_ratio=2, k=4)
    variables = integer_tree(flax_variables(jmod, [x]))
    tmod = from_flax_variables(texp.UpShuffleLayer4(3, 2, 4), variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert_outputs(got, jmod.apply(variables, jnp.asarray(x)), atol=0)


def test_up_shuffle_layer4_refuses_a_ragged_window():
    with pytest.raises(ValueError, match="multiple"):
        texp.UpShuffleLayer4(6, up_ratio=3, k=8)


@pytest.mark.parametrize("use_bn", [False, True])
def test_up_shuffle_layer5(use_bn):
    pc, feat = cloud(28, 2, 32, 3), cloud(29, 2, 32, 6)
    tmod = texp.UpShuffleLayer5(6, k=8, use_bn=use_bn)
    check(jexp.UpShuffleLayer5(k=8, use_bn=use_bn), tmod, [pc, feat])
    assert tmod.w_pc.dense.in_features == 6


def test_up_layers_training_in_f64():
    compare_f64(lambda dtype: jexp.UpShuffleLayer3(k=8, use_bn=True,
                                                   dtype=dtype),
                texp.UpShuffleLayer3(10, k=8, use_bn=True),
                [cloud(30, 2, 32, 10)])
    compare_f64(lambda dtype: jexp.UpShuffleLayer5(k=8, use_bn=True,
                                                   dtype=dtype),
                texp.UpShuffleLayer5(6, k=8, use_bn=True),
                [cloud(31, 2, 32, 3), cloud(32, 2, 32, 6)])


@pytest.mark.parametrize("up_ratio", [4, 2])
def test_duplicate_up_edge(up_ratio):
    tmod = texp.DuplicateUpEdge(10, up_ratio=up_ratio, k=8)
    check(jexp.DuplicateUpEdge(up_ratio=up_ratio, k=8), tmod,
          [cloud(33, 2, 16, 10)])
    assert tmod.shuffle_layer_0.conv.dense.in_features == 24


def test_duplicate_up2():
    """The patch-wide grid at patch_num · r = 64 (8 × 8), cut to n·r."""
    tmod = texp.DuplicateUp2(10, up_ratio=4, patch_num=16)
    check(jexp.DuplicateUp2(up_ratio=4, patch_num=16), tmod,
          [cloud(34, 2, 12, 10)])
    with pytest.raises(ValueError, match="exceed"):
        tmod(torch.zeros(2, 20, 10))


@pytest.mark.parametrize("npoint,n", [(64, 16), (48, 16)])
def test_point_upscale(npoint, n):
    tmod = texp.PointUpscale(10, npoint, n, k=8)
    check(jexp.PointUpscale(npoint, k=8), tmod, [cloud(35, 2, n, 10)])
    assert tmod.up_shuffle_layer3.up_ratio == npoint // n
    with pytest.raises(ValueError, match="built for"):
        tmod(torch.zeros(2, n + 1, 10))


# ------------------------------------------------ extractors, small units


class _JExtractors(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return (jexp.feature_extraction_down()(x),
                jexp.feature_extraction_up(growth_rate=8, k=8)(x),
                jexp.feature_extraction_up2(growth_rate=8, k=8)(x))


class _TExtractors(nn.Module):
    def __init__(self):
        super().__init__()
        for mod in (texp.feature_extraction_down(3),
                    texp.feature_extraction_up(3, growth_rate=8, k=8),
                    texp.feature_extraction_up2(3, growth_rate=8, k=8)):
            self.add_module(mod.name, mod)

    def forward(self, x):
        return (self.feature_extraction_down(x),
                self.feature_extraction_up(x),
                self.feature_extraction_up2(x))


def test_feature_extractors_under_their_scope_names():
    check(_JExtractors(), _TExtractors(), [cloud(36, 2, 32, 3)])
    tmod = _TExtractors()
    # 24 lifted, 3·8 + 24 from block 1, 3·8 + 16 from each later block
    assert tmod.feature_extraction_up.out_features == 24 + 48 + 3 * 40
    assert tmod.feature_extraction_up2.layer1.l0.bn is None


@pytest.mark.parametrize("up_ratio", [4, 3])
def test_weight_learning_unit(up_ratio):
    tmod = texp.WeightLearningUnit(12, up_ratio)
    check(jexp.WeightLearningUnit(up_ratio=up_ratio), tmod,
          [cloud(37, 2, 10, 1, 12)])
    assert tmod.conv_3.dense.out_features == 12


def test_coordinate_reconstruction_unit():
    tmod = texp.CoordinateReconstructionUnit(12)
    check(jexp.CoordinateReconstructionUnit(), tmod, [cloud(38, 2, 10, 1, 12)])
    with pytest.raises(ValueError, match="not 1"):
        tmod(torch.zeros(2, 10, 2, 12))


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 8), (2, 6, 5, 8)])
def test_instance_norm(faithful, shape):
    tmod = texp.InstanceNorm(8, faithful=faithful)
    check(jexp.InstanceNorm(faithful=faithful), tmod, [cloud(39, *shape)])


@pytest.mark.parametrize("make", [
    lambda: texp.PointASNLSetAbstraction(12, 16, **ASNL, in_points=64),
    lambda: texp.PointASNLSetAbstraction(12, 64, **ASNL, in_points=64),
    lambda: texp.PointDownscale(12, 16, 12),
    lambda: texp.PointDownscale2(12, 16, 12),
    lambda: texp.PointDownscale3(12, 16, 12, use_bn=True, use_noise=True),
    lambda: texp.PointDownscale3_1(12, 16, **ASNL, use_bn=True),
    lambda: texp.PointDownscale4(12, 16, use_bn=True),
    lambda: texp.PointShuffleV1(12, 8),
    lambda: texp.UpShuffleLayer(10),
    lambda: texp.UpShuffleLayer3(10, use_bn=True),
    lambda: texp.UpShuffleLayer4(6, use_bn=True),
    lambda: texp.UpShuffleLayer5(6, use_bn=True),
    lambda: texp.DuplicateUpEdge(10, use_bn=True),
    lambda: texp.DuplicateUp2(10),
    lambda: texp.PointUpscale(10, 64, 16, use_bn=True),
    lambda: texp.feature_extraction_down(3),
    lambda: texp.feature_extraction_up(3, use_bn=True),
    lambda: texp.WeightLearningUnit(12),
    lambda: texp.CoordinateReconstructionUnit(12),
    lambda: texp.InstanceNorm(8),
    lambda: tedge.EdgeConv(10, 12, use_bn=True),
    lambda: tedge.DenseEdgeBlock(10, 8, variant="v0", use_bn=True,
                                 dense_impl="split"),
], ids=["asnl", "asnl_same_size", "down", "down2", "down3", "down3_1",
        "down4", "shuffle_v1", "up_shuffle", "up_shuffle3", "up_shuffle4",
        "up_shuffle5", "duplicate_up_edge", "duplicate_up2", "upscale",
        "extraction_down", "extraction_up", "weight_learning",
        "coordinate_reconstruction", "instance_norm", "edge_conv",
        "dense_v0_split"])
def test_init_weights_covers_every_experimental_module(make):
    """The seeded init sets every parameter and buffer (each starts NaN
    here), the same for the same seed."""
    mods = [make(), make()]
    for mod in mods:
        with torch.no_grad():
            for t in [*mod.parameters(), *mod.buffers()]:
                t.fill_(float("nan"))
        init_weights(mod, torch.Generator().manual_seed(3))
    a, b = (m.state_dict() for m in mods)
    for key in a:
        assert torch.isfinite(a[key]).all(), key
        assert torch.equal(a[key], b[key]), key
