"""The kernels' plain PyTorch versions against the JAX package, on the CPU.

kNN and FPS are selections: their indices must be equal.  Where the JAX
function reaches a Pallas kernel, it runs in interpret mode, as
tests/test_pallas.py runs it.  Inputs are made with numpy and handed to
both packages.
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.ops.pallas_kernels import (attention_pallas, attention_xla,
                                          fps_pallas, fps_pallas_chunked,
                                          fps_pallas_chunked_batch,
                                          fps_pallas_lite, knn_pallas)
from dispu_tpu.ops.sampling import _fps_xla
from dispu_tpu_torch import kernels
from dispu_tpu_torch.kernels.attention import attention, attention_torch
from dispu_tpu_torch.kernels.fps import (FPS_MAX_N, fps, fps_cuda, fps_lite,
                                         fps_torch)
from dispu_tpu_torch.kernels.fps_chunked import (MAX_CLUSTERS, Form,
                                                 _check_schedulable,
                                                 fps_chunked,
                                                 fps_chunked_cuda)
from dispu_tpu_torch.kernels.fps_bucketed import fps_bucketed
from dispu_tpu_torch.kernels.gather_rows import gather_rows, scatter_rows_cuda
from dispu_tpu_torch.kernels.knn import knn as knn_kernel
from dispu_tpu_torch.kernels.knn import knn_packed
from dispu_tpu_torch.kernels.knn_group import knn_group
from dispu_tpu_torch.kernels.query_ball import query_ball
from dispu_tpu_torch.kernels.refine_block import refine_block
from dispu_tpu_torch.kernels.refine_local import LocalParams, refine_local
from dispu_tpu_torch.nn.attention import global_attention
from dispu_tpu_torch.ops import knn as tknn
from dispu_tpu_torch.ops.grouping import group_point
from dispu_tpu_torch.ops.sampling import farthest_point_sample, fps_kernel_for

# the package's ``knn`` function shadows its module of that name
jknn = importlib.import_module("dispu_tpu.ops.knn")

torch.set_num_threads(1)


def _cloud(seed, shape, n_dup=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    if n_dup:  # copy earlier rows over later ones
        for b in range(shape[0]):
            src = rng.choice(shape[1] // 2, n_dup, replace=False)
            dst = shape[1] // 2 + rng.choice(shape[1] // 2, n_dup,
                                             replace=False)
            x[b, dst] = x[b, src]
    return x


def _assert_dists(td, jd, x):
    # distances agree to 1e-6 relative; the expansion q2 - 2qp + p2
    # cancels, so its round-off scales with |q|² + |p|², not with d
    scale = 2.0 * float(np.max(np.sum(x * x, axis=-1)))
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6 * scale)


# ----------------------------------------------------------------------- kNN

@pytest.mark.parametrize("c", [24, 48])
def test_knn_unique_backbone_shape(c):
    """Backbone: (b=2, n=256, c, k=17) self-kNN with duplicated rows."""
    x = _cloud(c, (2, 256, c), n_dup=12)
    td, ti = tknn.knn_unique(17, torch.from_numpy(x), torch.from_numpy(x))
    # XLA path (per-batch max bias on duplicates)
    jd, ji = jknn.knn_unique(17, jnp.asarray(x), jnp.asarray(x), impl="xla")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _assert_dists(td.numpy(), np.asarray(jd), x)
    # Pallas path (1e30 bias on duplicates), interpret mode
    dup = np.asarray(jknn.mask_duplicate_rows(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tknn.mask_duplicate_rows(torch.from_numpy(x)).numpy(), dup)
    assert dup.sum() == 2 * 12
    pd, pi = knn_pallas(17, jnp.asarray(x), jnp.asarray(x),
                        jnp.asarray(dup.astype(np.float32) * 1e30),
                        interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    _assert_dists(td.numpy(), np.asarray(pd), x)


@pytest.mark.parametrize("shape", [(2, 3, 40, 5), (1, 2100, 3), (3, 40, 2)])
def test_mask_duplicate_rows_matches_jax(shape):
    """Values drawn from {-1, -0.0, 0, 1} make many groups of identical
    rows; n = 2100 reaches the JAX package's per-coordinate branch."""
    rng = np.random.RandomState(len(shape))
    x = rng.choice(np.float32([-1.0, -0.0, 0.0, 1.0]), size=shape)
    want = np.asarray(jknn.mask_duplicate_rows(jnp.asarray(x)))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(
        tknn.mask_duplicate_rows(torch.from_numpy(x)).numpy(), want)


def test_knn_unique_pushes_duplicates_last():
    """Fewer distinct points than k: the biased duplicate columns come
    last, in index order, as on the Pallas path."""
    x = _cloud(5, (1, 64, 3))
    x[0, 40:] = x[0, :24]
    dup = np.asarray(jknn.mask_duplicate_rows(jnp.asarray(x)))
    _, ti = tknn.knn_unique(50, torch.from_numpy(x), torch.from_numpy(x))
    _, pi = knn_pallas(50, jnp.asarray(x), jnp.asarray(x),
                       jnp.asarray(dup.astype(np.float32) * 1e30),
                       interpret=True, variant="walk")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    assert (ti[0, :, 40:].numpy() == np.arange(40, 50)).all()


def test_knn_refiner_shape():
    """Refiner: (b=2, n=1024, c=3, k=16) self-kNN."""
    x = _cloud(7, (2, 1024, 3))
    td, ti = tknn.knn(16, torch.from_numpy(x), torch.from_numpy(x))
    jd, ji = jknn.knn(16, jnp.asarray(x), jnp.asarray(x), impl="xla")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _assert_dists(td.numpy(), np.asarray(jd), x)
    pd, pi = knn_pallas(16, jnp.asarray(x), jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    _assert_dists(td.numpy(), np.asarray(pd), x)


def test_knn_patch_shape_k256():
    """Patch extraction: 24 seed queries into (1, 2048, 3), k=256 (the JAX
    package sends k > 128 to XLA's top_k; the port to the kernel)."""
    x = _cloud(11, (1, 2048, 3))
    q = np.ascontiguousarray(x[:, ::85][:, :24])
    td, ti = tknn.knn(256, torch.from_numpy(x), torch.from_numpy(q))
    jd, ji = jknn.knn(256, jnp.asarray(x), jnp.asarray(q), impl="auto")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _assert_dists(td.numpy(), np.asarray(jd), x)
    pd, pi = knn_pallas(256, jnp.asarray(x), jnp.asarray(q), interpret=True,
                        variant="walk")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))


def test_knn_ties_go_to_lower_index():
    """Exactly equal distances order by index (lax.top_k's order)."""
    x = np.zeros((1, 8, 2), np.float32)
    x[0, :, 0] = [1, -1, 1, -1, 2, -2, 0, 2]
    q = np.zeros((1, 1, 2), np.float32)
    td, ti = knn_kernel(8, torch.from_numpy(x), torch.from_numpy(q))
    assert ti[0, 0].tolist() == [6, 0, 1, 2, 3, 4, 5, 7]
    jd, ji = jknn.knn(8, jnp.asarray(x), jnp.asarray(q), impl="xla")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ----------------------------------------------------------------------- FPS

@pytest.mark.parametrize("b,n,npoint,n_dup", [
    (2, 1500, 200, 40),   # n not a multiple of 1024, duplicated points
    (1, 300, 64, 0),
    (1, 2048, 24, 0),     # the seed FPS of a 2048-point cloud
    (1, 10, 16, 3),       # npoint > n
])
def test_fps_bit_equal(b, n, npoint, n_dup):
    x = _cloud(n + npoint, (b, n, 3), n_dup=n_dup)
    got = farthest_point_sample(npoint, torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32 and got.shape == (b, npoint)
    np.testing.assert_array_equal(got, np.asarray(_fps_xla(npoint,
                                                           jnp.asarray(x))))
    np.testing.assert_array_equal(
        got, np.asarray(fps_pallas(npoint, jnp.asarray(x), interpret=True)))


def test_fps_bit_equal_at_the_merge_shape_on_a_lattice():
    """The plain FPS the kernel is held to on the card, against
    ``_fps_xla`` at the 4× merge of a 2048-point cloud (24,576 → 8,192)
    on an integer lattice, where every round ties exactly."""
    axes = np.meshgrid(np.arange(32), np.arange(32), np.arange(24),
                       indexing="ij")
    x = np.stack(axes, -1).reshape(1, -1, 3).astype(np.float32)
    got = fps_torch(8192, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_fps_xla(8192,
                                                           jnp.asarray(x))))


@pytest.mark.parametrize("n,npoint", [(100, 16), (128, 32), (300, 64),
                                      (1500, 200)])
def test_fps_lite_bit_equal(n, npoint):
    """``fps_lite``'s plain version against ``fps_pallas_lite`` in
    interpret mode at the JAX package's own test shapes: every index
    equal."""
    x = _cloud(n + npoint, (2, n, 3))
    got = fps_lite(npoint, torch.from_numpy(x)).numpy()
    want = fps_pallas_lite(npoint, jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fps_more_samples_than_points():
    """npoint > n: once every point is taken, every min-distance is 0 and
    each later round takes index 0 (what ``_fps_xla`` gives)."""
    x = _cloud(1, (1, 5, 3))
    got = fps(9, torch.from_numpy(x))[0].tolist()
    assert sorted(got[:5]) == [0, 1, 2, 3, 4]
    assert got[5:] == [0, 0, 0, 0]


@pytest.mark.parametrize("b,n,npoint,n_dup", [
    (1, 2500, 64, 30),    # three chunks of 1024 at width 128, the last ragged
    (2, 2500, 48, 0),     # two chunks of 2048 at the batch kernel's 256
    (3, 1030, 64, 20),    # one full chunk and a ragged one
])
def test_fps_bit_equal_to_chunked_kernels(b, n, npoint, n_dup):
    """The plain FPS, which the cluster kernel is held to, against the
    chunked TPU kernels it replaces, run in interpret mode."""
    x = _cloud(n + b, (b, n, 3), n_dup=n_dup)
    got = farthest_point_sample(npoint, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        fps_pallas_chunked(npoint, jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(
        fps_pallas_chunked_batch(npoint, jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(
        got, fps_chunked(npoint, torch.from_numpy(x)).numpy())


def test_fps_chunked_ties_across_chunks():
    """40 points tiled over 2080 slots: exact ties across every chunk
    boundary go to the first occurrence, in both chunked TPU kernels."""
    base = np.random.RandomState(3).randn(40, 3).astype(np.float32)
    x = np.stack([np.tile(base, (52, 1)), np.tile(base[::-1], (52, 1))])
    got = farthest_point_sample(64, torch.from_numpy(x)).numpy()
    assert sorted(got[0, :40]) == list(range(40)) and (got[:, 40:] == 0).all()
    np.testing.assert_array_equal(got, np.asarray(
        fps_pallas_chunked(64, jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(
        fps_pallas_chunked_batch(64, jnp.asarray(x), interpret=True)))


@pytest.mark.parametrize("n,kernel", [
    (1, "fps"), (24576, "fps"), (FPS_MAX_N, "fps"),
    (FPS_MAX_N + 1, "fps_chunked"), (98304, "fps_chunked"),
    (479232, "fps_chunked"),
])
def test_fps_routes_by_cloud_size(n, kernel):
    assert FPS_MAX_N == 32768
    assert fps_kernel_for(n) == kernel


def test_fps_chunked_refuses_a_form_the_card_cannot_schedule():
    """``cudaOccupancyMaxActiveClusters`` answering 0 raises, naming the
    form; it never falls back to another form."""

    def max_clusters(n, count):
        assert n == 98304
        count._obj.value = 0
        return 0

    lib = types.SimpleNamespace(dispu_fps_chunked_max_clusters=max_clusters)
    form = Form(8, 512, 24, "registers")
    MAX_CLUSTERS.pop((7, form), None)
    with pytest.raises(RuntimeError,
                       match="0 clusters of 8 blocks x 512 threads x 24 "
                             r"points \(registers\)"):
        _check_schedulable(lib, form, 98304, torch.device("cuda", 7))
    assert MAX_CLUSTERS.pop((7, form)) == 0


def test_fps_batch_impl_routes_as_auto():
    """'batch', the JAX package's streaming-merge name, is 'auto' here:
    every cloud already gets its own block or cluster."""
    x = torch.from_numpy(_cloud(4, (3, 300, 3), n_dup=10))
    kernels.reset_launch_counts()
    got = farthest_point_sample(40, x, impl="batch")
    assert torch.equal(got, farthest_point_sample(40, x))
    big = torch.zeros((1, FPS_MAX_N + 1, 3))  # past fps.cu: the other wrapper
    assert farthest_point_sample(4, big, impl="batch").tolist() == [[0] * 4]
    assert sum(kernels.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        farthest_point_sample(4, x, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        farthest_point_sample(4, big, impl="cuda")


def test_fps_kernel_refuses_clouds_past_its_limit():
    with pytest.raises(ValueError, match=f"n <= {FPS_MAX_N}"):
        fps_cuda(8, torch.zeros((1, FPS_MAX_N + 1, 3)))


# ----------------------------------------------------------------- attention

def test_attention_plain_f32_matches_xla():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 300, 16).astype(np.float32),
               rng.randn(2, 280, 16).astype(np.float32),
               rng.randn(2, 280, 24).astype(np.float32))
    got = attention_torch(*map(torch.from_numpy, (q, k, v)), 0.25).numpy()
    want = np.asarray(attention_xla(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 0.25))
    # f32 round-off of two products and a softmax
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_plain_bf16_matches_pallas():
    """The NL cell's width (c = cv = 64, scale 1/8) at nq = nk = 512."""
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 512, 64).astype(np.float32) for _ in range(3))
    got = attention(*map(torch.from_numpy, (q, k, v)), 0.125).numpy()
    want = np.asarray(attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 0.125,
                                       interpret=True))
    # both round q, k, v and p to bf16 at the same places; what remains is
    # the f32 sum order and exp's last bit, which can move a p across a
    # bf16 rounding boundary (2^-8 relative on that one term): a few
    # elements move by up to ~2e-4 (seen 1.7e-4), the mean stays ~1e-7
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    assert np.abs(got - want).mean() < 1e-6
    # the bf16 numerics are another function than the f32 version (seen
    # 2.3e-3 apart here), which the two bounds above tell apart
    f32 = attention_torch(*map(torch.from_numpy, (q, k, v)), 0.125).numpy()
    assert np.abs(got - f32).mean() > 10 * np.abs(got - want).mean()


def test_attention_plain_bf16_matches_pallas_at_pass_2_map():
    """Pass 2's map of a 16× request (4096 × 4096, c = cv = 64) for one
    cloud: the yardstick the kernel is held to on the card, against
    ``attention_pallas`` in interpret mode."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(1, 4096, 64).astype(np.float32) for _ in range(3))
    got = attention_torch(*map(torch.from_numpy, (q, k, v)), 0.125,
                          bf16_operands=True).numpy()
    want = np.asarray(attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 0.125,
                                       interpret=True))
    # as at 512 keys: the f32 sum order and exp's last bit can move a p
    # across a bf16 rounding boundary; over 4096 keys each p weighs less
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    assert np.abs(got - want).mean() < 1e-6


# ------------------------------------------------------------------ wrappers

def _local_params(k=4, cf=9, widths=(8, 8, 8)):
    """Small random LocalParams for k neighbours of cf-wide rows."""
    rng = np.random.RandomState(0)
    c1, c2, co = widths
    shapes = [(cf, c1), (c1,), (c1, c2), (c2,), (3, k), (k,), (cf, co),
              (co,), (k, c2, co), (co,)]
    return LocalParams(*(torch.from_numpy(rng.randn(*s).astype(np.float32))
                         for s in shapes))


def test_wrappers_take_plain_version_on_cpu_without_launching():
    kernels.reset_launch_counts()
    x = torch.from_numpy(_cloud(0, (1, 64, 3)))
    knn_kernel(4, x, x)
    fps(8, x)
    fps_chunked(8, x)
    attention(x, x, x, 1.0)
    query_ball(0.5, 4, x, x, select_smallest=2)
    knn_packed(4, x, x)
    knn_group(4, x, x, x, drop_first=True)
    fps_bucketed(8, x)
    fps_lite(8, x)
    idx = torch.zeros((1, 5), dtype=torch.int32)
    torch.sum(gather_rows(x.requires_grad_(True), idx)).backward()
    group_point(x, idx[..., None], "pallas")
    grouped = torch.from_numpy(_cloud(1, (1, 128, 4, 9)))
    refine_local(grouped, _local_params())
    refine_block(x.detach(), x.detach(), _local_params())
    assert kernels.launch_counts() == {
        "knn": 0, "knn_split": 0, "knn_packed": 0, "knn_group": 0, "fps": 0,
        "fps_lite": 0, "fps_chunked": 0, "fps_bucketed": 0, "attention": 0,
        "attention_bf16": 0, "query_ball": 0, "gather_rows": 0,
        "scatter_rows": 0,
        "refine_local": 0, "refine_block": 0}


@pytest.mark.parametrize("call", [
    lambda x: knn_kernel(4, x, x, impl="cuda"),
    lambda x: fps(8, x, impl="cuda"),
    lambda x: fps_chunked(8, x, impl="cuda"),
    lambda x: fps_chunked_cuda(8, x),
    lambda x: attention(x, x, x, 1.0, impl="cuda"),
    lambda x: knn_packed(4, x, x, impl="cuda"),
    lambda x: knn_group(4, x, x, x, impl="cuda"),
    lambda x: fps_bucketed(8, x, impl="cuda"),
    lambda x: fps_lite(8, x, impl="cuda"),
    lambda x: gather_rows(x, torch.zeros((1, 5), dtype=torch.int32),
                          impl="cuda"),
    lambda x: scatter_rows_cuda(x, torch.zeros((1, 64), dtype=torch.int32),
                                8),
    lambda x: group_point(x, torch.zeros((1, 5, 2), dtype=torch.int32),
                          "pallas", impl="cuda"),
    lambda x: refine_local(torch.zeros(1, 128, 4, 9), _local_params(),
                           impl="cuda"),
    lambda x: refine_block(x, x, _local_params(), impl="cuda"),
])
def test_wrappers_refuse_cuda_impl_on_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.from_numpy(_cloud(0, (1, 64, 3))))


@pytest.mark.parametrize("call", [
    lambda x: knn_kernel(4, x, x, impl="pallas"),
    lambda x: farthest_point_sample(8, x, impl="pallas"),
    lambda x: fps_chunked(8, x, impl="chunked"),
    lambda x: attention(x, x, x, 1.0, impl="pallas"),
    lambda x: global_attention(x, x, x, 1.0, impl="pallas"),
])
def test_wrappers_reject_unknown_impl(call):
    with pytest.raises(ValueError, match="impl must be one of"):
        call(torch.from_numpy(_cloud(0, (1, 64, 3))))
