"""The port's TF1-checkpoint converter against the JAX package's, on the
CPU.

The reference's variable names and TF shapes come from the JAX package's
``expected_tf_names`` on a flax init; the port's converter must give the
``state_dict`` that the JAX converter's flax tree gives through
``convert.from_flax_variables``, bit for bit.  With TensorFlow installed,
a real TF1 checkpoint written by ``tf.compat.v1.train.Saver`` goes through
both readers, and the two generators' forwards on it agree to f32
round-off (``test_torch_generator.py``'s bound, 1e-4 through ~20 dense
layers).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.models.generator import DisPUGenerator as JDisPUGenerator
from dispu_tpu.utils import convert_tf_checkpoint as jconv
from dispu_tpu_torch.config import GeneratorConfig
from dispu_tpu_torch.convert import _torch_key, from_flax_variables
from dispu_tpu_torch.models.generator import DisPUGenerator
from dispu_tpu_torch.utils import convert_tf_checkpoint as tconv
from test_torch_generator import perturbed_numpy_tree

torch.set_num_threads(1)

SMALL = dict(num_points=64, knn=8, refine_nsample=8)
CONFIGS = {"small": SMALL, "default": {}}


def _flax_init(cfg_kw, shapes_only=False):
    model = JDisPUGenerator(cfg=JGeneratorConfig(**cfg_kw))
    x = jnp.zeros((1, JGeneratorConfig(**cfg_kw).num_points, 3))
    if shapes_only:
        return jax.eval_shape(
            lambda k: model.init(k, x, train=False), jax.random.PRNGKey(0))
    return perturbed_numpy_tree(model.init(jax.random.PRNGKey(0), x,
                                           train=False), 1)


def _tf_tensors(variables, refine_nsample):
    """{TF name: the flax leaf in the TF layout} of a flax tree: TF's
    kernels flatten row-major to flax's, so each is a reshape."""
    import flax.traverse_util

    names = jconv.expected_tf_names(variables, refine_nsample)
    leaves = flax.traverse_util.flatten_dict(variables, sep="/").values()
    return {name: np.asarray(leaf, np.float32).reshape(shape)
            for (name, shape), leaf in zip(names.items(), leaves)}


def _state_dict_via_jax(tree, cfg_kw):
    model = DisPUGenerator(GeneratorConfig(**cfg_kw))
    return from_flax_variables(model, tree).state_dict()


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_names_and_shapes_match_jax(config):
    """The port's ``expected_tf_names`` on its generator's ``state_dict``
    is the JAX package's on the flax tree, and each name maps onto the
    key that ``convert`` gives its flax leaf."""
    cfg_kw = CONFIGS[config]
    flax_tree = _flax_init(cfg_kw, shapes_only=True)
    want = jconv.expected_tf_names(flax_tree, GeneratorConfig(
        **cfg_kw).refine_nsample)
    sd = DisPUGenerator(GeneratorConfig(**cfg_kw)).state_dict()
    got = tconv.expected_tf_names(sd, GeneratorConfig(**cfg_kw)
                                  .refine_nsample)
    assert got == want
    for name in want:
        collection, path = jconv.map_tf_name(name)
        assert tconv.map_tf_name(name + ":0") == \
            _torch_key(tuple(path.split("/")))[0]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_convert_variables_bit_equal_to_jax_path(config):
    cfg_kw = CONFIGS[config]
    nsample = GeneratorConfig(**cfg_kw).refine_nsample
    shapes = jconv.expected_tf_names(_flax_init(cfg_kw, shapes_only=True),
                                     nsample)
    rng = np.random.RandomState(2)
    tensors = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tensors["generator/generator/Adam/beta1_power"] = np.float32(0.9)
    tensors["global_step"] = np.int64(7)
    _assert_state_dicts_equal(
        tconv.convert_variables(tensors),
        _state_dict_via_jax(jconv.convert_variables(tensors), cfg_kw))


def test_convert_variables_refuses_unknown_names():
    with pytest.raises(ValueError, match="unmapped reference variables"):
        tconv.convert_variables({"generator/other/weights": np.zeros(3)})


def test_convert_checkpoint_needs_tensorflow(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="TensorFlow is required"):
        tconv.convert_checkpoint("/nonexistent/model")


def test_tf1_checkpoint_round_trip(tmp_path):
    """A real TF1 checkpoint (``tf.compat.v1.train.Saver``, with an Adam
    slot and the global step beside the 70 variables) read by both
    converters: the port's ``state_dict`` is bit-equal to the JAX
    converter's tree carried over by ``from_flax_variables``, and the
    generators agree within 1e-4 on it."""
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    variables = _flax_init(SMALL)
    tensors = _tf_tensors(variables, SMALL["refine_nsample"])
    assert len(tensors) == 70
    graph = tf1.Graph()
    with graph.as_default():
        for name, value in tensors.items():
            tf1.get_variable(name, initializer=value)
        tf1.get_variable("generator/generator/layer0/weights/Adam",
                         initializer=np.zeros(3, np.float32))
        tf1.train.get_or_create_global_step()
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            ckpt = saver.save(sess, str(tmp_path / "model"))
    got = tconv.convert_checkpoint(ckpt)
    jtree = jconv.convert_checkpoint(ckpt)
    _assert_state_dicts_equal(got, _state_dict_via_jax(jtree, SMALL))

    model = DisPUGenerator(GeneratorConfig(**SMALL))
    model.load_state_dict(got)
    x = np.random.RandomState(3).randn(2, 64, 3).astype(np.float32)
    jc, jf = JDisPUGenerator(cfg=JGeneratorConfig(**SMALL)).apply(
        jtree, jnp.asarray(x), train=False)
    with torch.inference_mode():
        tc, tf_ = model(torch.from_numpy(x))
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-4
    assert np.abs(tf_.numpy() - np.asarray(jf)).max() <= 1e-4
