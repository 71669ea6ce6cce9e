"""The port's DisPUGenerator against the JAX package's, on the CPU.

Weights: a random flax init whose biases and batch-norm statistics are
perturbed (so that they are not all zeros and ones), carried over by
``dispu_tpu_torch.convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.models.generator import DisPUGenerator as JDisPUGenerator
from dispu_tpu_torch.config import GeneratorConfig
from dispu_tpu_torch.convert import from_flax_variables
from dispu_tpu_torch.models.generator import DisPUGenerator

torch.set_num_threads(1)

SMALL = dict(num_points=64, knn=8, refine_nsample=8)


def perturbed_numpy_tree(variables, seed, scale=0.1, shift=0.05):
    """The flax tree as nested numpy dicts, every bias and batch-norm leaf
    moved off its init value (so that they are not all zeros and ones):
    variances drawn from U(0.5, 1.5), batch-norm scales moved by
    ``scale``·N(0, 1), biases and means by ``shift``·N(0, 1)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for name, value in tree.items():
            if hasattr(value, "items"):
                out[name] = walk(value)
                continue
            arr = np.asarray(value, np.float32)
            if name == "var":
                arr = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
            elif name == "scale":
                arr = arr + scale * rng.randn(*arr.shape).astype(np.float32)
            elif name in ("bias", "mean"):
                arr = arr + shift * rng.randn(*arr.shape).astype(np.float32)
            out[name] = arr
        return out

    return walk(jax.device_get(variables))


def _pair(cfg_kw, b, n, seed, use_bn=False):
    jcfg = JGeneratorConfig(use_bn=use_bn, **cfg_kw)
    jmodel = JDisPUGenerator(cfg=jcfg)
    x = np.random.RandomState(seed).randn(b, n, 3).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                            train=False)
    variables = perturbed_numpy_tree(variables, seed)
    tmodel = DisPUGenerator(GeneratorConfig(use_bn=use_bn, **cfg_kw))
    from_flax_variables(tmodel, variables)
    jc, jf = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        tc, tf = tmodel(torch.from_numpy(x))
    return (np.asarray(jc), np.asarray(jf)), (tc.numpy(), tf.numpy())


@pytest.mark.parametrize("use_bn", [False, True])
def test_generator_matches_flax(use_bn):
    # b=2 patches of 64 points → 256.  Bound 1e-4: f32 round-off through
    # ~20 dense layers (sum orders differ between XLA and PyTorch), while
    # the kNN selections must agree exactly for the outputs to get close.
    (jc, jf), (tc, tf) = _pair(SMALL, b=2, n=64, seed=3, use_bn=use_bn)
    assert tc.shape == jc.shape == (2, 256, 3)
    assert tf.shape == jf.shape == (2, 256, 3)
    assert np.abs(tc - jc).max() <= 1e-4
    assert np.abs(tf - jf).max() <= 1e-4


def test_generator_fine_extractor_matches_flax():
    (jc, jf), (tc, tf) = _pair(dict(SMALL, fine_extractor=True), b=2, n=64,
                               seed=4)
    assert np.abs(tc - jc).max() <= 1e-4
    assert np.abs(tf - jf).max() <= 1e-4


def test_own_init_full_width_cpu():
    """The port's own seeded init at full GeneratorConfig() width, b=1."""
    model = DisPUGenerator(GeneratorConfig(), seed=0)
    x = torch.from_numpy(
        np.random.RandomState(0).randn(1, 256, 3).astype(np.float32))
    with torch.inference_mode():
        coarse, fine = model(x)
    assert coarse.shape == fine.shape == (1, 1024, 3)
    assert torch.isfinite(coarse).all() and torch.isfinite(fine).all()
    # the same seed gives the same weights
    again = DisPUGenerator(GeneratorConfig(), seed=0)
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 again.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("value", ["fused", "megafused"])
def test_refine_local_settings_build_and_run(value):
    """Each fused refiner setting builds and runs on the CPU through its
    kernel's plain version (the refiner's n = 256 passes 'fused''s 128
    gate); against flax: tests/test_torch_refine.py."""
    model = DisPUGenerator(GeneratorConfig(refine_local_impl=value, **SMALL))
    assert model.PointShuffle.local_route(torch.zeros(1, 256, 8)) == value
    x = torch.from_numpy(
        np.random.RandomState(1).randn(1, 64, 3).astype(np.float32))
    with torch.inference_mode():
        coarse, fine = model(x)
    assert coarse.shape == fine.shape == (1, 256, 3)
    assert torch.isfinite(fine).all()


@pytest.mark.parametrize("field,value", [
    ("fast_knn", True), ("fast_gather", True),
    ("fast_gather_backbone", True), ("fused_grouping", True),
    ("dense_impl", "split"), ("gather_impl", "onehot"),
])
def test_turbo_settings_build_and_run(field, value):
    """Each turbo setting on its own builds and runs on the CPU (the whole
    turbo generator against flax: tests/test_torch_turbo.py)."""
    model = DisPUGenerator(GeneratorConfig(**SMALL, **{field: value}))
    x = torch.from_numpy(
        np.random.RandomState(1).randn(1, 64, 3).astype(np.float32))
    with torch.inference_mode():
        coarse, fine = model(x)
    assert coarse.shape == fine.shape == (1, 256, 3)
    assert torch.isfinite(fine).all()
