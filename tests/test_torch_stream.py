"""The port's 16× whole-cloud path and its streaming ``upsample_many``
against the JAX package's, on the CPU, with the same weights (a random
flax init, perturbed, converted)."""

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
from dispu_tpu_torch.inference import PatchUpsampler, plan_counts
from test_torch_generator import perturbed_numpy_tree

torch.set_num_threads(1)

SMALL = dict(num_points=64, knn=8, refine_nsample=8)
INF = dict(patch_num_point=64, patch_batch=4)


@pytest.fixture(scope="module")
def variables():
    variables = JDisPUGenerator(cfg=JGeneratorConfig(**SMALL)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 3), jnp.float32),
        train=False)
    return perturbed_numpy_tree(variables, 0, scale=0.05)


def _pair(variables, final_ratio):
    """(JAX upsampler, port upsampler) at ``final_ratio``, one weight set."""
    jup = JPatchUpsampler(variables, gen_cfg=JGeneratorConfig(**SMALL),
                          inf_cfg=JInferenceConfig(final_ratio=final_ratio,
                                                   **INF))
    tup = PatchUpsampler(variables, gen_cfg=GeneratorConfig(**SMALL),
                         inf_cfg=InferenceConfig(final_ratio=final_ratio,
                                                 **INF), device="cpu")
    return jup, tup


@pytest.fixture(scope="module")
def pair16(variables):
    return _pair(variables, 16)


def _clouds(b, n):
    return np.random.RandomState(b * n).randn(b, n, 3).astype(np.float32)


def _assert_close_as_clouds(got, want):
    # 4×: bound 1e-3 in the cloud's units (the clouds span ~±3), the bound
    # of test_torch_inference.test_upsample_matches_jax and for its reason:
    # the two packages' patches differ by f32 round-off (~2e-7), which can
    # flip a near-tied backbone kNN selection and moves the merged
    # candidates by round-off; the merge FPS may then swap two consecutive
    # picks that tie that closely.  So rows agree elementwise except at such
    # swaps, and as sets everywhere.
    row_err = np.abs(got - want).max(axis=-1)
    assert (row_err <= 1e-3).mean() >= 0.99
    d = np.sum((got[:, None, :] - want[None, :, :]) ** 2, axis=-1)
    assert np.sqrt(d.min(axis=1)).max() <= 1e-3
    assert np.sqrt(d.min(axis=0)).max() <= 1e-3


def _assert_same_cloud_16x(got, want):
    # 16×: pass 2 runs on pass 1's fine points, four times denser, where
    # the backbone kNN meets many more near-ties: fed the same input, the
    # port's plain distances and XLA's differ in round-off (~2e-8) and swap
    # neighbours there, which moves ~2% of the pass-2 candidates by up to
    # ~3e-4 (test_pass2_candidates_match_jax).  The merge FPS picks a third
    # of the candidates and, once one pick differs, takes another order and
    # partly other points: rows agree only 7-42% (seen), so the outputs are
    # held as sets.  The bounds are against the outputs' own sampling: mean
    # nearest-neighbour spacing ~4.5e-3, self-Chamfer ~4e-5.  Seen: Chamfer
    # 1.1e-7 to 4.5e-7, points without a counterpart within 1e-3 at most
    # 4.9%, farthest counterpart 4.1e-3.
    d = np.sum((got[:, None, :] - want[None, :, :]) ** 2, axis=-1)
    near_got, near_want = d.min(axis=1), d.min(axis=0)
    assert near_got.mean() + near_want.mean() <= 1e-6
    assert (np.sqrt(near_got) <= 1e-3).mean() >= 0.9
    assert (np.sqrt(near_want) <= 1e-3).mean() >= 0.9
    assert np.sqrt(max(near_got.max(), near_want.max())) <= 1e-2


def test_num_passes_match(pair16):
    jup, tup = pair16
    assert tup.num_passes == jup.num_passes == 2
    for ratio in (2, 4, 8, 16, 32, 64):
        inf = dict(final_ratio=ratio, **INF)
        assert PatchUpsampler(
            gen_cfg=GeneratorConfig(**SMALL), inf_cfg=InferenceConfig(**inf),
            device="cpu").num_passes == JPatchUpsampler(
                None, gen_cfg=JGeneratorConfig(**SMALL),
                inf_cfg=JInferenceConfig(**inf)).num_passes


def test_upsample_16x_matches_jax(pair16):
    jup, tup = pair16
    pc = _clouds(1, 128)[0]
    want = np.asarray(jup.upsample(pc))
    got = tup.upsample(pc)
    assert got.shape == want.shape == (2048, 3)
    assert np.isfinite(got).all()
    _assert_same_cloud_16x(got, want)


def test_pass2_candidates_match_jax(pair16):
    """Fed the JAX package's patches, both passes of the port's generator
    give its candidates but at pass-2 kNN near-ties (see
    _assert_same_cloud_16x): seen 97.6% of rows within 1e-5, the rest
    within 3.3e-4."""
    jup, tup = pair16
    pc = _clouds(1, 128)[0]
    seed_num, _ = plan_counts(pc.shape[0], tup.inf_cfg)
    jpc_n, _, _ = jnormalize(jnp.asarray(pc))
    patches, _, _ = jup._prepare(jpc_n, seed_num=seed_num)
    want = np.asarray(jup._chunked_generator(patches, 4))
    with torch.inference_mode():
        got = tup.generate(torch.from_numpy(np.array(patches))).numpy()
    assert got.shape == want.shape == (6, 1024, 3)
    row_err = np.abs(got - want).max(axis=-1)
    assert (row_err <= 1e-5).mean() >= 0.95
    assert row_err.max() <= 1e-3


def test_merge_16x_on_jax_candidates_is_bit_equal(pair16):
    """Given the JAX package's own pass-2 candidates, the port's merge takes
    its points exactly."""
    jup, tup = pair16
    pc = _clouds(1, 128)[0]
    seed_num, out_num = plan_counts(pc.shape[0], tup.inf_cfg)
    jpc_n, _, _ = jnormalize(jnp.asarray(pc))
    patches, centroid, furthest = jup._prepare(jpc_n, seed_num=seed_num)
    merged = jup._chunked_generator(patches, 4) * furthest + centroid
    merged = merged.reshape(-1, 3)
    assert merged.shape == (6 * 64 * 16, 3)
    want = np.asarray(jup._merge(merged, out_num=out_num))
    got = tup.merge(torch.from_numpy(np.array(merged))[None], out_num)[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("final_ratio", [4, 16])
def test_upsample_many_matches_jax(variables, final_ratio):
    """Held against the JAX package's upsample_many, not its upsample:
    the two differ by design there (MULTICHIP_r05) as they do here."""
    jup, tup = _pair(variables, final_ratio)
    pcs = _clouds(2, 128)
    want = np.asarray(jup.upsample_many(pcs))
    got = tup.upsample_many(pcs)
    assert got.shape == want.shape == (2, 128 * final_ratio, 3)
    assert np.isfinite(got).all()
    check = (_assert_close_as_clouds if final_ratio == 4
             else _assert_same_cloud_16x)
    for v in range(2):
        check(got[v], want[v])


def test_upsample_is_upsample_many_of_one_cloud(pair16):
    _, tup = pair16
    pc = _clouds(1, 128)
    np.testing.assert_array_equal(tup.upsample(pc[0]),
                                  tup.upsample_many(pc)[0])
