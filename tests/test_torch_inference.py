"""The port's whole-cloud PatchUpsampler against the JAX package's, on the
CPU, with the same weights (a random flax init, perturbed, converted)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import InferenceConfig as JInferenceConfig
from dispu_tpu.inference import PatchUpsampler as JPatchUpsampler
from dispu_tpu.inference import plan_counts as jplan_counts
from dispu_tpu.models.generator import DisPUGenerator as JDisPUGenerator
from dispu_tpu.ops.geometry import normalize_point_cloud as jnormalize
from dispu_tpu.ops.sampling import farthest_point_sample as jfps
from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig
from dispu_tpu_torch.inference import PatchUpsampler, plan_counts
from dispu_tpu_torch.ops.geometry import normalize_point_cloud
from test_torch_generator import perturbed_numpy_tree

torch.set_num_threads(1)

SMALL = dict(num_points=64, knn=8, refine_nsample=8)
INF = dict(patch_num_point=64, patch_batch=4)


@pytest.fixture(scope="module")
def pair():
    """(JAX upsampler, port upsampler, cloud) sharing one set of weights."""
    jcfg = JGeneratorConfig(**SMALL)
    variables = JDisPUGenerator(cfg=jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 3), jnp.float32),
        train=False)
    variables = perturbed_numpy_tree(variables, 0, scale=0.05)
    jup = JPatchUpsampler(variables, gen_cfg=jcfg,
                          inf_cfg=JInferenceConfig(**INF))
    tup = PatchUpsampler(variables, gen_cfg=GeneratorConfig(**SMALL),
                         inf_cfg=InferenceConfig(**INF), device="cpu")
    pc = np.random.RandomState(1).randn(256, 3).astype(np.float32)
    return jup, tup, pc


def test_seeds_and_patches_match(pair):
    jup, tup, pc = pair
    seed_num, _ = plan_counts(pc.shape[0], tup.inf_cfg)
    assert seed_num == 12  # 3 chunks of 4 patches
    jpc_n, _, _ = jnormalize(jnp.asarray(pc))
    jseeds = np.asarray(jfps(seed_num, jpc_n[None])[0])
    jpatches, _, _ = jup._prepare(jpc_n, seed_num=seed_num)
    pc_n, _, _ = normalize_point_cloud(torch.from_numpy(pc))
    # normalization: f32 round-off of a mean and a max
    np.testing.assert_allclose(pc_n.numpy(), np.asarray(jpc_n), atol=1e-6)
    patches, _, _, seeds = tup.prepare(pc_n[None], seed_num)
    np.testing.assert_array_equal(seeds[0].numpy(), jseeds)
    np.testing.assert_allclose(patches.numpy(), np.asarray(jpatches),
                               atol=1e-5)


def test_upsample_matches_jax(pair):
    jup, tup, pc = pair
    want = np.asarray(jup.upsample(pc))
    got = tup.upsample(pc)
    assert got.shape == want.shape == (1024, 3)
    assert np.isfinite(got).all()
    # Bound 1e-3 in the cloud's units (the cloud spans ~±3).  Fed the same
    # patches the generators agree to ~3e-7 (test_torch_generator), but
    # the patches themselves differ by f32 round-off (~2e-7), which can
    # flip a near-tied backbone kNN selection and moves the merged
    # candidates by round-off.  The merge FPS may then swap two consecutive
    # picks whose distances tie that closely, so rows agree elementwise
    # except at such swaps (seen: 2 swaps, 4 rows of 1024), and as sets
    # everywhere (seen: 9.2e-7).
    row_err = np.abs(got - want).max(axis=1)
    assert (row_err <= 1e-3).mean() >= 0.99
    d = np.sum((got[:, None, :] - want[None, :, :]) ** 2, axis=-1)
    assert np.sqrt(d.min(axis=1)).max() <= 1e-3
    assert np.sqrt(d.min(axis=0)).max() <= 1e-3


def test_merge_fps_on_jax_candidates_is_bit_equal(pair):
    """Given the same merged candidates, the port's merge takes the JAX
    package's points exactly."""
    jup, tup, pc = pair
    seed_num, out_num = plan_counts(pc.shape[0], tup.inf_cfg)
    jpc_n, _, _ = jnormalize(jnp.asarray(pc))
    patches, centroid, furthest = jup._prepare(jpc_n, seed_num=seed_num)
    merged = jup._chunked_generator(patches, 4) * furthest + centroid
    merged = merged.reshape(-1, 3)
    want = np.asarray(jup._merge(merged, out_num=out_num))
    got = tup.merge(torch.from_numpy(np.array(merged))[None], out_num)[0]
    got = got.numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 10, 85, 86, 256, 300, 2048, 5000, 10000])
@pytest.mark.parametrize("inf_kw", [{}, INF, dict(patch_num_ratio=2)])
def test_plan_counts_match(n, inf_kw):
    assert plan_counts(n, InferenceConfig(**inf_kw)) == \
        jplan_counts(n, JInferenceConfig(**inf_kw))


@pytest.mark.parametrize("inf_kw", [
    dict(compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16", final_ratio=16, merge_fps="bucketed"),
])
def test_bf16_inference_settings_run(inf_kw):
    """bf16 compute builds and runs on the CPU, f32 out (against JAX:
    tests/test_torch_bf16.py)."""
    inf = InferenceConfig(**dict(INF, **inf_kw))
    pc = np.random.RandomState(2).randn(128, 3).astype(np.float32)
    out = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf,
                         device="cpu").upsample(pc)
    assert out.shape == (128 * inf.final_ratio, 3)
    assert out.dtype == np.float32 and np.isfinite(out).all()


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL),
                       inf_cfg=InferenceConfig(compute_dtype="float16"),
                       device="cpu")


@pytest.mark.parametrize("inf_kw", [
    dict(final_ratio=16, merge_fps="bucketed"), dict(merge_fps="bucketed"),
])
def test_bucketed_merge_settings_run(inf_kw):
    """The bucketed merge at 4× and 16× builds and runs on the CPU (against
    JAX: tests/test_torch_turbo.py)."""
    inf = InferenceConfig(**dict(INF, **inf_kw))
    pc = np.random.RandomState(2).randn(128, 3).astype(np.float32)
    out = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf,
                         device="cpu").upsample(pc)
    assert out.shape == (128 * inf.final_ratio, 3)
    assert np.isfinite(out).all()
