"""The port's hierarchy extractors, attention units, up/down blocks and the
refiner's ball and ``refine_point`` branches against the JAX package's,
on the CPU; and the ball grouping with the fused gather names.

Weights are flax inits moved off their init values (the zero-initialised
``gamma`` of every attention unit set non-zero, or the branch would be
invisible) and carried over by ``convert.from_flax_variables``.  Inputs
are seeded numpy clouds; the selections run on exact xyz and are
bit-equal, and the values agree to 1e-5 of each output's largest entry
(1e-5 where that is below 1).  ``HierarchyUpsampler``'s gradient (of a
sum of squares, every parameter) agrees with ``jax.grad`` to 1e-4 of
each leaf's largest entry.
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dispu_tpu.nn import attention as jattention
from dispu_tpu.nn import hierarchy as jhierarchy
from dispu_tpu.nn import refine as jrefine
from dispu_tpu.nn import upsample as jupsample
from dispu_tpu_torch.convert import _leaves, _torch_key, from_flax_variables
from dispu_tpu_torch.nn import attention as tattention
from dispu_tpu_torch.nn import gcn as tgcn
from dispu_tpu_torch.nn import hierarchy as thierarchy
from dispu_tpu_torch.nn import pointnet as tpointnet
from dispu_tpu_torch.nn import refine as trefine
from dispu_tpu_torch.nn import upsample as tupsample
from dispu_tpu_torch.nn.layers import init_weights
from dispu_tpu_torch.ops import grouping as tgrouping
from test_torch_pointnet import (assert_outputs, cloud, compare, compare_f64,
                                 flax_variables)

# the JAX package's ``ops`` exports a function named ``grouping``
jgrouping = importlib.import_module("dispu_tpu.ops.grouping")

torch.set_num_threads(1)

GRAD_REL = 1e-4
REFINE = dict(nsample=8, mlp=(16, 16, 32))


def _gammas(variables, value=0.5):
    """Every attention unit's ``gamma`` (zero at init) set to ``value``."""
    def walk(tree):
        for name, leaf in tree.items():
            if hasattr(leaf, "items"):
                walk(leaf)
            elif name == "gamma":
                tree[name] = np.full(leaf.shape, value, np.float32)
    walk(variables["params"])


# --------------------------------------------------------------- hierarchy


@pytest.mark.parametrize("use_bn", [False, True])
def test_hierarchy_feature_extractor(use_bn):
    x = cloud(0, 2, 128, 3)
    kw = dict(npoints=(64, 32, 16), nsample=8, use_bn=use_bn)
    compare(jhierarchy.HierarchyFeatureExtractor(**kw),
            thierarchy.HierarchyFeatureExtractor(**kw), [x])


def test_hierarchy_feature_extractor_training_in_f64(monkeypatch):
    """Training mode.  In f32, flax's batch variance E[x²] − E[x]²
    cancels wherever rows repeat (balls that hold only their centre;
    features interpolated from the one point of the group_all level), and
    the outputs read up to 2.1e-3 apart at a largest entry of 5.4; f64 on
    both sides agrees (``compare_f64``).  The port's three-NN selects and
    weighs in f32 at any input dtype (its kNN's), so here it is JAX's
    three-NN under x64 written in torch: the expansion in f64 with the
    product rounded to f32 (``pairwise_sq_dist``'s
    ``preferred_element_type``), the three smallest, ties to the lower
    index.  The port's own three-NN is held by the tests of
    ``PointNetFPModule`` and ``tests/test_torch_ops21.py``."""
    def three_nn_f64(xyz1, xyz2, impl="auto"):
        xy = torch.matmul(xyz1, xyz2.transpose(1, 2)).float().double()
        d = torch.clamp_min(torch.sum(xyz1 ** 2, -1, keepdim=True) - 2 * xy
                            + torch.sum(xyz2 ** 2, -1)[:, None], 0.0)
        d, idx = torch.sort(d, dim=-1, stable=True)
        k = min(3, xyz2.shape[1])
        pick = list(range(k)) + [0] * (3 - k)
        return d[..., pick], idx[..., pick].to(torch.int32)

    monkeypatch.setattr(tpointnet, "three_nn", three_nn_f64)
    kw = dict(npoints=(64, 32, 16), nsample=8, use_bn=True)
    compare_f64(lambda dtype: jhierarchy.HierarchyFeatureExtractor(
        **kw, dtype=dtype), thierarchy.HierarchyFeatureExtractor(**kw),
        [cloud(0, 2, 128, 3)])


def test_hierarchy_upsampler_values_and_gradient():
    x = cloud(1, 2, 64, 3, scale=0.5)
    jmod = jhierarchy.HierarchyUpsampler()
    variables = flax_variables(jmod, [x])
    tmod = from_flax_variables(thierarchy.HierarchyUpsampler(), variables)
    assert tmod.fc_layer0_0.dense.in_features == 3 * 64 + 64 + 3

    def loss(params):
        return jnp.sum(jmod.apply({"params": params}, jnp.asarray(x)) ** 2)

    want = jmod.apply(variables, jnp.asarray(x))
    want_grads = jax.grad(loss)(variables["params"])
    out = tmod.eval()(torch.from_numpy(x))
    assert out.shape == (2, 256, 3)
    assert_outputs(out, want)
    torch.sum(out ** 2).backward()
    params = dict(tmod.named_parameters())
    seen = set()
    for path, leaf in _leaves(want_grads):
        key, transpose = _torch_key(path)
        w = np.asarray(leaf).T if transpose else np.asarray(leaf)
        g = params[key].grad.numpy()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max(), key
        seen.add(key)
    assert seen == set(params)


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("use_bn,train", [(True, False), (True, True),
                                          (False, False)])
def test_sample_weights(use_bn, train):
    feat, xyz = cloud(2, 2, 10, 6, 20), cloud(3, 2, 10, 6, 3)
    compare(jattention.SampleWeights((16, 9), use_bn=use_bn),
            tattention.SampleWeights(20, (16, 9), use_bn=use_bn),
            [feat, xyz], train=train)


class _JAdaptive(fnn.Module):
    num_neighbor: int

    @fnn.compact
    def __call__(self, xyz, feat, train=False):
        sw = jattention.SampleWeights((8, 5), name="sw")
        return jattention.adaptive_sampling(sw, xyz, feat,
                                            self.num_neighbor, train)


class _TAdaptive(nn.Module):
    def __init__(self, num_neighbor):
        super().__init__()
        self.num_neighbor = num_neighbor
        self.sw = tattention.SampleWeights(4, (8, 5))

    def forward(self, xyz, feat):
        return tattention.adaptive_sampling(self.sw, xyz, feat,
                                           self.num_neighbor)


@pytest.mark.parametrize("num_neighbor", [3, 6])
def test_adaptive_sampling(num_neighbor):
    xyz, feat = cloud(4, 2, 12, 6, 3), cloud(5, 2, 12, 6, 4)
    compare(_JAdaptive(num_neighbor), _TAdaptive(num_neighbor), [xyz, feat])


def test_adaptive_sampling_without_neighbours():
    """num_neighbor 0: each query keeps its first neighbour (no weights)."""
    xyz, feat = cloud(4, 2, 12, 6, 3), cloud(5, 2, 12, 6, 4)
    got = _TAdaptive(0)(torch.from_numpy(xyz), torch.from_numpy(feat))
    assert_outputs(got, (xyz[:, :, 0], feat[:, :, 0]), atol=0)


@pytest.mark.parametrize("shape", [(2, 40, 24), (2, 5, 8, 16)])
def test_attention_unit(shape):
    compare(jattention.AttentionUnit(),
            tattention.AttentionUnit(shape[-1]), [cloud(6, *shape)],
            edit=_gammas)


def test_init_weights_zeroes_gamma():
    mod = tupsample.UpProjectionUnit(12)
    with torch.no_grad():
        mod.up_0.attention.gamma.fill_(0.5)
    init_weights(mod, torch.Generator().manual_seed(0))
    assert mod.up_0.attention.gamma.item() == 0.0
    x = torch.from_numpy(cloud(7, 2, 30, 10))
    with torch.no_grad():
        unit = tattention.AttentionUnit(10)
        init_weights(unit, torch.Generator().manual_seed(1))
        assert torch.equal(unit(x), x)  # the identity at init


@pytest.mark.parametrize("make", [
    lambda: thierarchy.HierarchyFeatureExtractor(use_bn=True),
    lambda: thierarchy.HierarchyUpsampler(),
    lambda: tgcn.GCNBackbone(conv="gin", use_bn=True),
    lambda: tupsample.UpProjectionUnit(20),
    lambda: tupsample.ContractExpand(12),
    lambda: trefine.PointShuffle2(2, **REFINE, use_knn=False,
                                  refine_point=True),
], ids=["hierarchy", "upsampler", "gcn", "up_projection", "contract",
        "refine_point"])
def test_init_weights_covers_every_new_module(make):
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


# ---------------------------------------------------------- up/down blocks


@pytest.mark.parametrize("up_ratio", [4, 2])
def test_up_projection_unit(up_ratio):
    compare(jupsample.UpProjectionUnit(up_ratio=up_ratio),
            tupsample.UpProjectionUnit(20, up_ratio=up_ratio),
            [cloud(8, 2, 16, 20)], edit=_gammas)


def test_up_block():
    compare(jupsample.UpBlock(up_ratio=4), tupsample.UpBlock(10, 4),
            [cloud(9, 2, 16, 10)], edit=_gammas)


@pytest.mark.parametrize("up_ratio", [4, 3])
def test_down_block(up_ratio):
    compare(jupsample.DownBlock(up_ratio=up_ratio),
            tupsample.DownBlock(12, up_ratio),
            [cloud(10, 2, 16 * up_ratio, 12)])


@pytest.mark.parametrize("up_ratio", [4, 3])
def test_contract_expand(up_ratio):
    compare(jupsample.ContractExpand(up_ratio=up_ratio),
            tupsample.ContractExpand(12, up_ratio),
            [cloud(11, 2, 16 * up_ratio, 12)])


# --------------------------------------------------- the ball grouping fix


@pytest.mark.parametrize("gather_impl", ["fused", "fused_turbo"])
def test_ball_grouping_with_fused_names_is_the_exact_gather(gather_impl):
    xyz, feat = cloud(12, 2, 128, 3), cloud(13, 2, 128, 24)
    args = (8, torch.from_numpy(xyz), torch.from_numpy(xyz))
    kw = dict(use_knn=False, radius=0.3)
    got = tgrouping.grouping(torch.from_numpy(feat), *args,
                             gather_impl=gather_impl, **kw)
    plain = tgrouping.grouping(torch.from_numpy(feat), *args,
                               gather_impl="gather", **kw)
    want = jgrouping.grouping(jnp.asarray(feat), 8, jnp.asarray(xyz),
                              jnp.asarray(xyz), gather_impl=gather_impl,
                              **kw)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ refiner


@pytest.mark.parametrize("case", [
    dict(use_knn=False, radius=0.3),
    dict(use_knn=False),                      # the default radius, 0.2
    dict(use_knn=False, gather_impl="fused"),
    dict(use_knn=False, gather_impl="fused_turbo", radius=0.25),
    dict(use_knn=False, use_nonlocal=False),
])
def test_point_shuffle2_ball(case):
    xyz, feat = cloud(14, 2, 64, 3), cloud(15, 2, 64, 20)
    compare(jrefine.PointShuffle2(**REFINE, **case),
            trefine.PointShuffle2(20, **REFINE, **case), [xyz, feat])


@pytest.mark.parametrize("refine_point", [False, True])
def test_point_shuffle2_ball_use_bn_training_in_f64(refine_point):
    """Training-mode batch norm magnifies the refiner's f32 round-off
    (ROADMAP.md, queue 3): held in f64 (``compare_f64``)."""
    c = 2 if refine_point else 20
    xyz, feat = cloud(16, 2, 64, 3), cloud(17, 2, 64, c)
    kw = dict(REFINE, use_knn=False, use_bn=True, refine_point=refine_point)
    compare_f64(lambda dtype: jrefine.PointShuffle2(**kw, dtype=dtype),
                trefine.PointShuffle2(c, **kw), [xyz, feat])


@pytest.mark.parametrize("use_knn", [True, False])
@pytest.mark.parametrize("use_bn", [False, True])
def test_point_shuffle2_refine_point(use_knn, use_bn):
    """refine_point at c = 2, the one width where the JAX package runs it:
    the points come back re-positioned."""
    xyz, feat = cloud(18, 2, 64, 3), cloud(19, 2, 64, 2)
    kw = dict(REFINE, use_knn=use_knn, refine_point=True, use_bn=use_bn)
    compare(jrefine.PointShuffle2(**kw), trefine.PointShuffle2(2, **kw),
            [xyz, feat])
    tmod = trefine.PointShuffle2(2, **kw)
    assert tmod.noise_refine.mlp2.layer1.features == 2
    assert tmod.non_local.conv_query.dense.in_features == 8


def test_point_shuffle2_refine_point_refused_where_jax_fails():
    xyz, feat = cloud(20, 2, 64, 3), cloud(21, 2, 64, 24)
    jmod = jrefine.PointShuffle2(**REFINE, refine_point=True)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feat))
    with pytest.raises(ValueError, match="23 feature weight channels "
                                         "multiply the 30 grouped"):
        trefine.PointShuffle2(24, **REFINE, refine_point=True)


def test_point_shuffle2_ball_fused_local():
    """'fused' takes the ball-grouped tensor (the refine_local kernel's
    plain version here), as the JAX package's ``use_fused`` does; it
    computes what the composed path computes."""
    xyz, feat = cloud(22, 2, 128, 3), cloud(23, 2, 128, 20)
    kw = dict(REFINE, use_knn=False)
    tmod = trefine.PointShuffle2(20, **kw, local_impl="fused").eval()
    assert tmod.local_route(torch.from_numpy(feat)) == "fused"
    variables = compare(jrefine.PointShuffle2(**kw), tmod, [xyz, feat])
    # and the same against the JAX package's own 'fused' apply
    want = jrefine.PointShuffle2(**kw, local_impl="fused").apply(
        variables, jnp.asarray(xyz), jnp.asarray(feat))
    with torch.no_grad():
        assert_outputs(tmod(torch.from_numpy(xyz), torch.from_numpy(feat)),
                       want)


@pytest.mark.parametrize("kw,route", [
    (dict(use_knn=False, local_impl="megafused"), "xla"),
    (dict(refine_point=True, local_impl="megafused"), "xla"),
    (dict(local_impl="megafused"), "megafused"),
    (dict(use_knn=False, local_impl="fused"), "fused"),
])
def test_point_shuffle2_gates(kw, route):
    """'megafused' needs the kNN grouping and no refine_point (the JAX
    package's gate); 'fused' takes ball grouping too."""
    mod = trefine.PointShuffle2(2, **REFINE, **kw).eval()
    assert mod.local_route(torch.zeros(1, 128, 2)) == route
