"""Where the port's generator departs from the JAX package's, the kNN
selection is the whole cause: fed the JAX package's own neighbour indices,
the port agrees to f32 round-off.

The JAX package runs eagerly here, its two kNN call sites (the dense
blocks' ``knn_unique_indices`` in ``nn/edgeconv.py`` and the refiner's
``knn_indices`` in ``ops/grouping.py``) wrapped to record the indices
they return; the port then runs with its own two call sites replaced by
those recordings, in the same order.  Without the hook the same inputs
meet feature-space near-ties (distances equal to ~1e-7) where the two
packages' distance round-off picks different neighbours (ROADMAP.md,
queue 3).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import InferenceConfig as JInferenceConfig
from dispu_tpu.inference import PatchUpsampler as JPatchUpsampler
from dispu_tpu.models.generator import DisPUGenerator as JDisPUGenerator
from dispu_tpu.ops.geometry import normalize_point_cloud as jnormalize
from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig
from dispu_tpu_torch.convert import from_flax_variables
from dispu_tpu_torch.inference import PatchUpsampler, plan_counts
from dispu_tpu_torch.models.generator import DisPUGenerator
from test_torch_generator import SMALL, perturbed_numpy_tree

torch.set_num_threads(1)

# the packages expose functions of the same names as these modules
JAX_SITES = (importlib.import_module("dispu_tpu.nn.edgeconv"),
             "knn_unique_indices",
             importlib.import_module("dispu_tpu.ops.grouping"), "knn_indices")
PORT_SITES = (importlib.import_module("dispu_tpu_torch.nn.edgeconv"),
              "knn_unique_indices",
              importlib.import_module("dispu_tpu_torch.ops.grouping"),
              "knn_indices")


def _init(module, *args):
    """flax's init under one jit: the eager init's values, sooner."""
    return jax.jit(lambda *a: module.init(*a, train=False))(*args)


def _record_jax(monkeypatch, fn):
    """Run ``fn`` with the JAX package's kNN call sites recording; returns
    (fn's result, the recorded (b, m, k) indices in call order)."""
    recorded = []
    for module, name in zip(JAX_SITES[::2], JAX_SITES[1::2]):
        def wrapped(*args, _orig=getattr(module, name), **kwargs):
            idx = _orig(*args, **kwargs)
            recorded.append(np.asarray(idx))
            return idx
        monkeypatch.setattr(module, name, wrapped)
    out = fn()
    monkeypatch.undo()
    return out, recorded


def _replay_port(monkeypatch, recorded, fn):
    """Run ``fn`` with the port's kNN call sites returning ``recorded``
    in order; every recording must be used, each at its shape."""
    queue = list(recorded)

    def replay(k, points, queries, *args, **kwargs):
        idx = queue.pop(0)
        assert idx.shape == (*queries.shape[:-1], k)
        return torch.from_numpy(np.array(idx))

    for module, name in zip(PORT_SITES[::2], PORT_SITES[1::2]):
        monkeypatch.setattr(module, name, replay)
    out = fn()
    monkeypatch.undo()
    assert not queue
    return out


@pytest.mark.parametrize("use_bn", [False, True])
def test_generator_matches_flax_on_jax_selections(monkeypatch, use_bn):
    """At the 0.1·N(0, 1) perturbation of biases and means (seed 3), where
    test_torch_generator's own selections meet a near-tie, the port fed
    the JAX package's indices agrees to f32 round-off (seen: 6.6e-7)."""
    seed = 3
    jmodel = JDisPUGenerator(cfg=JGeneratorConfig(use_bn=use_bn, **SMALL))
    x = np.random.RandomState(seed).randn(2, 64, 3).astype(np.float32)
    variables = _init(jmodel, jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = perturbed_numpy_tree(variables, seed, shift=0.1)
    (jc, jf), recorded = _record_jax(monkeypatch, lambda: jmodel.apply(
        variables, jnp.asarray(x), train=False))
    assert len(recorded) == 5  # four dense blocks and the refiner
    tmodel = DisPUGenerator(GeneratorConfig(use_bn=use_bn, **SMALL))
    from_flax_variables(tmodel, variables)
    with torch.inference_mode():
        tc, tf = _replay_port(monkeypatch, recorded,
                              lambda: tmodel(torch.from_numpy(x)))
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-5
    assert np.abs(tf.numpy() - np.asarray(jf)).max() <= 1e-5


def test_pass2_rows_match_jax_on_jax_selections(monkeypatch):
    """16× pass 2 over one chunk of the JAX package's patches: where
    test_torch_stream.test_pass2_candidates_match_jax sees ~3% of rows
    move by up to 3.8e-4, every row agrees to f32 round-off once the port
    takes the JAX package's indices (seen: 2.4e-7)."""
    inf = dict(patch_num_point=64, patch_batch=4, final_ratio=16)
    variables = _init(JDisPUGenerator(cfg=JGeneratorConfig(**SMALL)),
                      jax.random.PRNGKey(0),
                      jnp.zeros((1, 64, 3), jnp.float32))
    variables = perturbed_numpy_tree(variables, 0, scale=0.05)
    jup = JPatchUpsampler(variables, gen_cfg=JGeneratorConfig(**SMALL),
                          inf_cfg=JInferenceConfig(**inf))
    tup = PatchUpsampler(variables, gen_cfg=GeneratorConfig(**SMALL),
                         inf_cfg=InferenceConfig(**inf), device="cpu")
    pc = np.random.RandomState(128).randn(128, 3).astype(np.float32)
    seed_num, _ = plan_counts(pc.shape[0], tup.inf_cfg)
    jpc_n, _, _ = jnormalize(jnp.asarray(pc))
    patches = np.array(jup._prepare(jpc_n, seed_num=seed_num)[0])[:4]
    # the JAX package's chunk body (both passes), run eagerly
    want, recorded = _record_jax(monkeypatch, lambda: np.asarray(
        jup._upsample_batch_impl(jnp.asarray(patches))))
    assert len(recorded) == 10
    with torch.inference_mode():
        got = _replay_port(monkeypatch, recorded, lambda: tup.generate(
            torch.from_numpy(patches)).numpy())
    assert got.shape == want.shape == (4, 1024, 3)
    assert np.abs(got - want).max() <= 1e-5
