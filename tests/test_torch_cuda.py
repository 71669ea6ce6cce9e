"""The port's CUDA kernels and its serving path on the card.

Every test here needs an NVIDIA GPU with nvcc: it is marked ``cuda`` and
skips where no card is present.  This file imports neither JAX nor the
JAX package, so it runs on a machine with PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dispu_tpu_torch import GeneratorConfig, InferenceConfig, kernels
from dispu_tpu_torch.inference import PatchUpsampler, pin_f32
from dispu_tpu_torch.kernels.attention import attention_cuda, attention_torch
from dispu_tpu_torch.kernels.fps import FPS_MAX_N, fps_cuda, fps_torch
from dispu_tpu_torch.kernels.fps_chunked import fps_chunked_cuda
from dispu_tpu_torch.kernels.knn import MAX_ROW_FLOATS, knn_cuda, knn_torch
from dispu_tpu_torch.ops.knn import mask_duplicate_rows

pytestmark = pytest.mark.cuda

SMALL = dict(num_points=64, knn=8, refine_nsample=8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_f32()
    return torch.device("cuda")


def _randn(seed, *shape):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


@pytest.mark.parametrize("b,n,m,c,k,dup", [
    (2, 256, 256, 24, 17, True), (2, 1024, 1024, 3, 16, False),
    (1, 2048, 24, 3, 256, False), (3, 100, 7, 5, 100, False),
])
def test_knn_kernel_matches_plain(dev, b, n, m, c, k, dup):
    pts = _randn(n, b, n, c).to(dev)
    if dup:
        pts[:, -10:] = pts[:, :10]
    qs = pts if m == n else _randn(m, b, m, c).to(dev)
    bias = mask_duplicate_rows(pts).float() * 1e30 if dup else None
    dk, ik = knn_cuda(k, pts, qs, bias)
    dp, ip = knn_torch(k, pts, qs, bias)
    torch.cuda.synchronize()
    scale = 2.0 * float(torch.amax(torch.sum(pts * pts, -1)))
    # distances to 1e-5 relative (floor: the expansion's scale); indices
    # equal but for swaps between entries that tie to that precision
    assert float((torch.abs(dk - dp) / (dp.abs() + scale)).max()) <= 1e-5
    assert float((ik != ip).float().mean()) <= 1e-3


def test_knn_kernel_refuses_rows_beyond_shared_memory(dev):
    pts = torch.zeros((1, MAX_ROW_FLOATS, 1), device=dev)
    with pytest.raises(ValueError, match=str(MAX_ROW_FLOATS)):
        knn_cuda(1, pts, pts[:, :4])


@pytest.mark.parametrize("b,n,npoint", [
    (1, 2048, 24), (2, 5000, 700), (1, FPS_MAX_N, 64), (1, 10, 16),
])
def test_fps_kernel_bit_equal_to_plain(dev, b, n, npoint):
    xyz = _randn(n, b, n, 3).to(dev)
    xyz[:, n // 2:n // 2 + 3] = xyz[:, :3]
    assert torch.equal(fps_cuda(npoint, xyz), fps_torch(npoint, xyz))


def test_fps_kernel_refuses_clouds_past_its_limit(dev):
    with pytest.raises(ValueError, match=str(FPS_MAX_N)):
        fps_cuda(8, torch.zeros((1, FPS_MAX_N + 1, 3), device=dev))


# n across the kernel's forms: 8 blocks of ceil(n / 8) points, with 6, 12
# or 18 min-distances a thread in registers up to 49,152, 98,304 and
# 147,456 points (the cluster's on-chip capacity), device memory beyond
@pytest.mark.parametrize("b,n,npoint", [
    (1, 40000, 64), (3, 49152, 50), (1, 49153, 50), (3, 98309, 100),
    (1, 147456, 64), (3, 147457, 40), (1, 100, 100),
])
def test_fps_chunked_kernel_bit_equal_to_plain(dev, b, n, npoint):
    xyz = _randn(n, b, n, 3).to(dev)
    xyz[:, n // 2:n // 2 + 3] = xyz[:, :3]
    assert torch.equal(fps_chunked_cuda(npoint, xyz), fps_torch(npoint, xyz))


def test_fps_chunked_kernel_more_samples_than_distinct_points(dev):
    # 37 distinct points tiled over 40,003 (blocks of 5,001): exact ties
    # within and across blocks, then every min-distance 0 and index 0
    xyz = _randn(37, 1, 37, 3).repeat(1, 1082, 1)[:, :40003].to(dev)
    got = fps_chunked_cuda(64, xyz.contiguous())
    assert torch.equal(got, fps_torch(64, xyz))
    assert sorted(got[0, :37].tolist()) == list(range(37))
    assert (got[0, 37:] == 0).all()


def _chamfer(a, b):
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    d = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist") ** 2
    return float(d.min(1).values.mean() + d.min(0).values.mean())


def test_attention_kernel_matches_plain_bf16(dev):
    # ragged sizes: 700 queries, 650 keys, cv = 40
    q = _randn(0, 2, 700, 64).to(dev)
    k = _randn(1, 2, 650, 64).to(dev)
    v = _randn(2, 2, 650, 40).to(dev)
    got = attention_cuda(q, k, v, 0.125)
    want = attention_torch(q, k, v, 0.125, bf16_operands=True)
    # same rounding points; the f32 sum order differs
    assert float(torch.abs(got - want).max()) <= 1e-3


def test_attention_kernel_takes_cv_up_to_256(dev):
    # c = cv = 184 is the refiner's bottleneck with fine_extractor=True;
    # 256 is the widest the JAX package sends to its kernel
    for cv in (184, 256):
        q = _randn(cv, 2, 300, cv).to(dev)
        k = _randn(cv + 1, 2, 330, cv).to(dev)
        v = _randn(cv + 2, 2, 330, cv).to(dev)
        got = attention_cuda(q, k, v, cv ** -0.5)
        want = attention_torch(q, k, v, cv ** -0.5, bf16_operands=True)
        assert float(torch.abs(got - want).max()) <= 1e-3


def test_upsampler_goes_through_the_kernels(dev):
    inf = InferenceConfig(patch_num_point=128, patch_batch=8)
    up = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf)
    pc = _randn(0, 600, 3).numpy()
    kernels.reset_launch_counts()
    out = up.upsample(pc)
    # 14 seeds → 2 chunks of 8 patches: kNN 1 + (4 backbone + 1 refiner)
    # per chunk; attention once per chunk (its 512 × 512 map reaches the
    # kernel's threshold); FPS for the seeds and the merge
    assert kernels.launch_counts() == {"knn": 11, "fps": 2, "fps_chunked": 0,
                                       "attention": 2}
    assert out.shape == (2400, 3) and np.isfinite(out).all()
    ref = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf,
                         device="cpu").upsample(pc)
    # against the CPU path (plain versions, f32 attention): the bf16
    # attention moves points by ~1e-3 of the patch scale at most
    d = np.sum((out[:, None] - ref[None]) ** 2, axis=-1)
    assert d.min(1).mean() + d.min(0).mean() <= 1e-4


def test_upsampler_fine_extractor_attention_reaches_the_kernel(dev):
    # fine_extractor widens the refiner to 128 + 240 features: bottleneck
    # and cv 184, which the JAX package also sends to its kernel
    inf = InferenceConfig(patch_num_point=128, patch_batch=8)
    cfg = GeneratorConfig(fine_extractor=True, **SMALL)
    pc = _randn(0, 600, 3).numpy()
    kernels.reset_launch_counts()
    out = PatchUpsampler(gen_cfg=cfg, inf_cfg=inf).upsample(pc)
    # 2 chunks: kNN 1 + (4 coarse + 2 fine backbone + 1 refiner) per chunk
    assert kernels.launch_counts() == {"knn": 15, "fps": 2, "fps_chunked": 0,
                                       "attention": 2}
    assert out.shape == (2400, 3) and np.isfinite(out).all()


def test_upsampler_16x_goes_through_the_kernels(dev):
    inf = InferenceConfig(patch_num_point=128, patch_batch=8, final_ratio=16)
    up = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf)
    pc = _randn(1, 1200, 3).numpy()
    kernels.reset_launch_counts()
    out = up.upsample(pc)
    # 28 seeds → 4 chunks of 8, two passes each: kNN 1 + 5 · 4 · 2,
    # attention 4 · 2 (maps of 512² and 2048²); the merge of 28 · 2048 =
    # 57,344 candidates goes to the cluster kernel
    assert kernels.launch_counts() == {"knn": 41, "fps": 1, "fps_chunked": 1,
                                       "attention": 8}
    assert out.shape == (19200, 3) and np.isfinite(out).all()
    ref = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf,
                         impl="torch").upsample(pc)
    # against the plain versions on the card, in the kernels' numerics:
    # kNN near-tie swaps only (chip_smoke.py reads ~5e-9 at full width)
    assert _chamfer(out, ref) <= 1e-6


@pytest.mark.parametrize("final_ratio,counts", [
    # 2 · 28 seeds → 7 chunks of 8: kNN 1 + 5 · 7 per pass, attention 7 per
    # pass; merges of 28 · 512 = 14,336 (fps) or 28 · 2048 = 57,344
    # (fps_chunked, one cluster a cloud) candidates for both clouds at once
    (4, {"knn": 36, "fps": 2, "fps_chunked": 0, "attention": 7}),
    (16, {"knn": 71, "fps": 1, "fps_chunked": 1, "attention": 14}),
])
def test_upsample_many_goes_through_the_kernels(dev, final_ratio, counts):
    inf = InferenceConfig(patch_num_point=128, patch_batch=8,
                          final_ratio=final_ratio)
    up = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf)
    pcs = _randn(2, 2, 1200, 3).numpy()
    kernels.reset_launch_counts()
    out = up.upsample_many(pcs)
    assert kernels.launch_counts() == counts
    assert out.shape == (2, 1200 * final_ratio, 3)
    assert np.isfinite(out).all()
    ref = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf,
                         impl="torch").upsample_many(pcs)
    for v in range(2):
        assert _chamfer(out[v], ref[v]) <= 1e-6
