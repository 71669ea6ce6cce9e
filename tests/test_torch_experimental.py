"""The port's ``nn/experimental.py`` (the ASNL set abstraction, the
downscalers, ``PointShuffleV1``, the shufflers; the up-shuffle family and
the small units are in ``tests/test_torch_experimental_up.py``),
``EdgeConv`` and the dense-block variants against the JAX package's, on
the CPU.

Weights are flax inits with every bias and batch-norm leaf moved off its
init value, carried over by ``convert.from_flax_variables`` (which refuses
a leaf left unused or a shape that differs, so every width the port
computes is held to the one flax inferred).  Inputs are seeded numpy
clouds; the selections (FPS seeds, kNN and ball neighbourhoods) run on
exact xyz and come back bit-equal, integer outputs bit for bit.  Values
agree to 1e-5 of each output's largest entry (1e-5 where that is below
1), gradients of a sum of squares to 1e-5 of the gradient's largest
entry (in f64 to 1e-6 where an eval-mode batch norm ahead of a softmax
over a few neighbours magnifies f32 round-off past that); training-mode batch norm, whose f32 batch variance cancels over
near-equal rows, is held in f64 to 1e-10.  Reshapes and shuffles are
bit-equal: on exact inputs, or with integer weights and inputs, whose
products are exact in f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dispu_tpu.nn import edgeconv as jedge
from dispu_tpu.nn import experimental as jexp
from dispu_tpu_torch.convert import _leaves, _torch_key, from_flax_variables
from dispu_tpu_torch.nn import edgeconv as tedge
from dispu_tpu_torch.nn import experimental as texp
from test_torch_extras21 import captured
from test_torch_generator import perturbed_numpy_tree
from test_torch_pointnet import (_as_jax, _as_torch, assert_outputs, cloud,
                                 compare, compare_f64)

torch.set_num_threads(1)

GRAD_REL = 1e-5
GRAD_REL_F64 = 1e-6
ASNL = dict(nsample=8, mlp=(16, 16, 32))


def _float_outputs(out):
    return [o for o in (out if isinstance(out, (tuple, list)) else (out,))
            if jnp.issubdtype(o.dtype, jnp.floating)]


def compare_grads(jmod, tmod, xs, variables, jax_kw=None, torch_kw=None,
                  f64=False):
    """The gradient of the sum of squares of every float output with
    respect to every parameter, eval mode, against ``jax.grad``: within
    1e-5 of the gradient's largest entry (some leaves' are zero but for
    round-off: a key bias ahead of a softmax), or with ``f64`` both sides
    in f64 (JAX under x64) within 1e-6; every parameter is covered."""
    jax_kw, torch_kw = jax_kw or {}, torch_kw or {}
    ftype = np.float64 if f64 else np.float32
    xs = [x.astype(ftype) if np.issubdtype(x.dtype, np.floating) else x
          for x in xs]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        out = jmod.apply({"params": params, **rest}, *_as_jax(xs), **jax_kw)
        return sum(jnp.sum(o ** 2) for o in _float_outputs(out))

    with jax.enable_x64(f64):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, ftype), variables["params"])
        # jitted: the eager gradient dispatches op by op, ~10× slower
        want = jax.tree_util.tree_map(np.asarray,
                                      jax.jit(jax.grad(loss))(params))
    from_flax_variables(tmod, variables).eval()
    if f64:
        tmod.double()
    tmod.zero_grad(set_to_none=True)
    out = tmod(*_as_torch(xs), **torch_kw)
    out = out if isinstance(out, tuple) else (out,)
    sum(torch.sum(o ** 2) for o in out if o.is_floating_point()).backward()
    got = dict(tmod.named_parameters())
    leaves = list(_leaves(want))
    scale = max(float(np.abs(w).max()) for _, w in leaves)
    rel = GRAD_REL_F64 if f64 else GRAD_REL
    seen = set()
    for path, leaf in leaves:
        key, transpose = _torch_key(path)
        w = leaf.T if transpose else leaf
        g = got[key].grad
        assert g is not None, key
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rel * scale,
                                   err_msg=key)
        seen.add(key)
    assert seen == set(got)


def check(jmod, tmod, xs, grads=True, jmod_f64=None, **kw):
    """Values (``compare``) and, with ``grads``, the gradients: in f64
    where ``jmod_f64``, the JAX module at flax dtype f64, is given."""
    variables = compare(jmod, tmod, xs, **kw)
    if grads:
        compare_grads(jmod_f64 or jmod, tmod, xs, variables,
                      jax_kw=kw.get("jax_kw"), torch_kw=kw.get("torch_kw"),
                      f64=jmod_f64 is not None)
    return variables


def integer_tree(variables, seed=0):
    """Every float leaf replaced by small integers (variances by 1), so
    that products and sums are exact in f32 on both sides."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if hasattr(leaf, "items"):
                out[name] = walk(leaf)
            elif name == "var":
                out[name] = np.ones(np.shape(leaf), np.float32)
            else:
                out[name] = rng.randint(-3, 4, np.shape(leaf)).astype(
                    np.float32)
        return out

    return walk(variables)


def integer_cloud(seed, *shape):
    return np.random.RandomState(seed).randint(-4, 5, shape).astype(
        np.float32)


# ------------------------------------------------------- EdgeConv, blocks


@pytest.mark.parametrize("use_bn", [False, True])
def test_edge_conv(use_bn):
    x = cloud(0, 2, 32, 10)
    tmod = tedge.EdgeConv(10, 12, k=8, use_bn=use_bn)
    check(jedge.EdgeConv(12, k=8, use_bn=use_bn), tmod, [x])
    assert tmod.conv.dense.in_features == 20


def test_edge_conv_training_in_f64():
    compare_f64(lambda dtype: jedge.EdgeConv(12, k=8, use_bn=True,
                                             dtype=dtype),
                tedge.EdgeConv(10, 12, k=8, use_bn=True),
                [cloud(1, 2, 32, 10)])


def test_edge_conv_is_exported():
    from dispu_tpu_torch import nn as tnn

    assert tnn.EdgeConv is tedge.EdgeConv and "EdgeConv" in tnn.__all__


@pytest.mark.parametrize("dense_impl", ["concat", "split"])
@pytest.mark.parametrize("variant", ["default", "v0", "v2"])
def test_dense_edge_block_variants(variant, dense_impl):
    """Values, the kNN indices bit-equal, the channel count (n·g, plus c
    but for 'v0') and the gradients."""
    x = cloud(2, 2, 32, 10)
    kw = dict(n=3, k=8, variant=variant, dense_impl=dense_impl)
    tmod = tedge.DenseEdgeBlock(10, 8, **kw)
    check(jedge.DenseEdgeBlock(8, **kw), tmod, [x])
    assert tmod.out_features == 24 + (0 if variant == "v0" else 10)


@pytest.mark.parametrize("variant", ["v0", "v2"])
def test_dense_edge_block_variants_training_in_f64(variant):
    kw = dict(n=3, k=8, variant=variant, use_bn=True)
    compare_f64(lambda dtype: jedge.DenseEdgeBlock(8, **kw, dtype=dtype),
                tedge.DenseEdgeBlock(10, 8, **kw), [cloud(3, 2, 32, 10)])


def test_dense_edge_block_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        tedge.DenseEdgeBlock(10, 8, variant="v1")


# ---------------------------------------------------------- SampleOffset


@pytest.mark.parametrize("use_bn,train", [(True, False), (False, False),
                                          (True, True)])
def test_sample_offset(use_bn, train):
    feat, xyz = cloud(4, 2, 10, 6, 20), cloud(5, 2, 10, 6, 3)
    jmod = jexp.SampleOffset((16, 3), use_bn=use_bn)
    tmod = texp.SampleOffset(20, (16, 3), use_bn=use_bn)
    variables = compare(jmod, tmod, [feat, xyz], train=train)
    if not train:
        compare_grads(jmod, tmod, [feat, xyz], variables)
    with torch.no_grad():
        out = tmod.eval()(torch.from_numpy(feat), torch.from_numpy(xyz))
    assert out.shape == (2, 10, 3) and float(out.abs().max()) <= 0.5


# ---------------------------------------------------- ASNL and downscalers


def _xyz_feat(seed, n=64, c=12):
    return cloud(seed, 2, n, 3), cloud(seed + 100, 2, n, c)


@pytest.mark.parametrize("use_knn", [True, False])
@pytest.mark.parametrize("use_nonlocal", [True, False])
def test_asnl_set_abstraction(use_knn, use_nonlocal):
    xyz, feat = _xyz_feat(6)
    kw = dict(ASNL, use_knn=use_knn, use_nonlocal=use_nonlocal)
    tmod = texp.PointASNLSetAbstraction(12, 16, **kw, in_points=64)
    check(jexp.PointASNLSetAbstraction(16, **kw), tmod, [xyz, feat])
    # the widths flax inferred: SampleWeights over 3 + c, the non-local
    # queries 3 + c wide, after_conv over mlp[-2]·32
    assert tmod.SampleWeights.mlp2.layer1.features == 16
    assert tmod.after_conv.dense.in_features == 16 * 32
    if use_nonlocal:
        assert tmod.non_local.conv_query.dense.in_features == 15


@pytest.mark.parametrize("use_knn", [True, False])
def test_asnl_same_size(use_knn):
    """A cloud of ``npoint`` points: no FPS, no adaptive sampling, no
    ``SampleWeights``; c-wide non-local queries."""
    xyz, feat = _xyz_feat(7)
    kw = dict(ASNL, use_knn=use_knn)
    tmod = texp.PointASNLSetAbstraction(12, 64, **kw, in_points=64)
    check(jexp.PointASNLSetAbstraction(64, **kw), tmod, [xyz, feat])
    assert not hasattr(tmod, "SampleWeights")
    with pytest.raises(ValueError, match="built for 16 points"):
        texp.PointASNLSetAbstraction(12, 16, **kw, in_points=16)(
            torch.from_numpy(xyz), torch.from_numpy(feat))


def test_asnl_training_in_f64():
    xyz, feat = _xyz_feat(8)
    compare_f64(lambda dtype: jexp.PointASNLSetAbstraction(
        16, **ASNL, dtype=dtype),
        texp.PointASNLSetAbstraction(12, 16, **ASNL, in_points=64),
        [xyz, feat])


def test_fps_with_features():
    xyz, feat = _xyz_feat(9)
    want = jexp._fps_with_features(16, jnp.asarray(xyz), jnp.asarray(feat))
    got = texp._fps_with_features(16, torch.from_numpy(xyz),
                                  torch.from_numpy(feat))
    assert_outputs(got, want, atol=0)


@pytest.mark.parametrize("use_knn", [True, False])
def test_point_downscale(use_knn):
    xyz, feat = _xyz_feat(10)
    check(jexp.PointDownscale(16, 12, use_knn=use_knn),
          texp.PointDownscale(12, 16, 12, use_knn=use_knn), [xyz, feat],
          jmod_f64=jexp.PointDownscale(16, 12, use_knn=use_knn,
                                       dtype=jnp.float64))


@pytest.mark.parametrize("use_knn", [True, False])
def test_point_downscale2(use_knn):
    xyz, feat = _xyz_feat(11)
    tmod = texp.PointDownscale2(12, 16, 12, use_knn=use_knn)
    check(jexp.PointDownscale2(16, 12, use_knn=use_knn), tmod, [xyz, feat])
    assert tmod.SampleOffset.conv_kv_ds.dense.in_features == 18


def test_point_downscale_same_size_and_training_in_f64():
    """At npoint = n there is no FPS; training-mode batch norm in f64."""
    xyz, feat = _xyz_feat(12)
    compare_f64(lambda dtype: jexp.PointDownscale(64, 12, dtype=dtype),
                texp.PointDownscale(12, 64, 12), [xyz, feat])
    compare_f64(lambda dtype: jexp.PointDownscale2(16, 12, dtype=dtype),
                texp.PointDownscale2(12, 16, 12), [xyz, feat])


@pytest.mark.parametrize("use_knn,use_sm,use_bn", [
    (True, True, False), (False, True, False), (True, False, True)])
def test_point_downscale3(use_knn, use_sm, use_bn):
    xyz, feat = _xyz_feat(13)
    kw = dict(use_knn=use_knn, use_sm=use_sm, use_bn=use_bn)
    tmod = texp.PointDownscale3(12, 16, 12, **kw)
    check(jexp.PointDownscale3(16, 12, **kw), tmod, [xyz, feat])
    assert tmod.mlp2.layer0.dense.in_features == 15


@pytest.mark.parametrize("cls,nsample", [("PointDownscale3", 12),
                                         ("PointDownscale4", 32)])
def test_noise_takes_jax_draw(monkeypatch, cls, nsample):
    """``use_noise`` with the noise JAX drew, captured for one apply: the
    same output; and the port's own draw comes from its generator."""
    xyz, feat = _xyz_feat(14)
    jmod = getattr(jexp, cls)(16, nsample, use_noise=True)
    tmod = getattr(texp, cls)(12, 16, nsample, use_noise=True)
    variables = perturbed_numpy_tree(jmod.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(xyz), jnp.asarray(feat)), 0, shift=0.1)
    want, (draw,) = captured(monkeypatch, "normal", jmod.apply, variables,
                             jnp.asarray(xyz), jnp.asarray(feat),
                             rngs={"noise": jax.random.PRNGKey(5)})
    assert draw.shape == (2, 16, 16)
    from_flax_variables(tmod, variables).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(xyz), torch.from_numpy(feat),
                   noise=torch.from_numpy(draw))
        assert_outputs(got, want)
        a = tmod(torch.from_numpy(xyz), torch.from_numpy(feat),
                 generator=torch.Generator().manual_seed(3))
        b = tmod(torch.from_numpy(xyz), torch.from_numpy(feat),
                 generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], got[1])
    with pytest.raises(ValueError, match="noise of shape"):
        tmod(torch.from_numpy(xyz), torch.from_numpy(feat),
             noise=torch.zeros(2, 16, 8))


@pytest.mark.parametrize("use_knn,use_nonlocal", [(True, True),
                                                  (False, True),
                                                  (True, False)])
def test_point_downscale3_1(use_knn, use_nonlocal):
    xyz, feat = _xyz_feat(15)
    kw = dict(ASNL, use_knn=use_knn, use_nonlocal=use_nonlocal)
    tmod = texp.PointDownscale3_1(12, 16, **kw)
    check(jexp.PointDownscale3_1(16, **kw), tmod, [xyz, feat])
    assert tmod.after_conv.dense.in_features == 16 * 8


@pytest.mark.parametrize("use_knn,use_bn", [(True, False), (False, False),
                                            (True, True)])
def test_point_downscale4(use_knn, use_bn):
    xyz, feat = _xyz_feat(16)
    kw = dict(use_knn=use_knn, use_bn=use_bn)
    tmod = texp.PointDownscale4(12, 16, **kw)
    assert tmod.nsample == 32
    check(jexp.PointDownscale4(16, **kw), tmod, [xyz, feat])


def test_downscalers_training_in_f64():
    xyz, feat = _xyz_feat(17)
    kw = dict(ASNL, use_bn=True)
    compare_f64(lambda dtype: jexp.PointDownscale3_1(16, **kw, dtype=dtype),
                texp.PointDownscale3_1(12, 16, **kw), [xyz, feat])
    compare_f64(lambda dtype: jexp.PointDownscale3(16, 12, use_bn=True,
                                                   dtype=dtype),
                texp.PointDownscale3(12, 16, 12, use_bn=True), [xyz, feat])
    compare_f64(lambda dtype: jexp.PointDownscale4(16, use_bn=True,
                                                   dtype=dtype),
                texp.PointDownscale4(12, 16, use_bn=True), [xyz, feat])


@pytest.mark.parametrize("use_knn", [True, False])
def test_point_shuffle_v1(use_knn):
    xyz, feat = _xyz_feat(18)
    tmod = texp.PointShuffleV1(12, 8, use_knn=use_knn)
    check(jexp.PointShuffleV1(8, use_knn=use_knn), tmod, [xyz, feat],
          jmod_f64=jexp.PointShuffleV1(8, use_knn=use_knn,
                                       dtype=jnp.float64))
    assert tmod.SampleWeights.mlp2.layer1.features == 15


def test_point_shuffle_v1_training_in_f64():
    xyz, feat = _xyz_feat(19)
    compare_f64(lambda dtype: jexp.PointShuffleV1(8, dtype=dtype),
                texp.PointShuffleV1(12, 8), [xyz, feat])


# ------------------------------------------------------------- shufflers


@pytest.mark.parametrize("scale", [2, 4])
def test_point_shuffler_bit_equal(scale):
    x = cloud(20, 2, 5, 1, 16)
    got = texp.point_shuffler(torch.from_numpy(x), scale)
    want = jexp.point_shuffler(jnp.asarray(x), scale)
    assert_outputs(got, want, atol=0)


@pytest.mark.parametrize("scale", [2, 3])
def test_shuffle_up_down_bit_equal_and_not_the_library_calls(scale):
    """The reference's pixel shuffles, bit-equal to JAX's: they are not
    ``F.pixel_shuffle`` / ``F.pixel_unshuffle``, whose sub-pixel order
    differs."""
    x = cloud(21, 2, 4 * scale * scale, 6, 5)
    up = texp.shuffle_up(torch.from_numpy(x), scale)
    assert_outputs(up, jexp.shuffle_up(jnp.asarray(x), scale), atol=0)
    assert not torch.equal(up, F.pixel_shuffle(torch.from_numpy(x), scale))
    y = cloud(22, 2, 4, 6 * scale, 5 * scale)
    down = texp.shuffle_down(torch.from_numpy(y), scale)
    assert_outputs(down, jexp.shuffle_down(jnp.asarray(y), scale), atol=0)
    assert not torch.equal(down,
                           F.pixel_unshuffle(torch.from_numpy(y), scale))
    assert torch.equal(texp.shuffle_up(down, scale), torch.from_numpy(y))
