"""The port's CUDA kernels, their autograd rules, and its serving and
training paths on the card.

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
from dispu_tpu_torch.kernels.query_ball import (MAX_C, MAX_N, MAX_NSAMPLE,
                                                query_ball_cuda,
                                                query_ball_torch)
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
                                       "attention": 2, "query_ball": 0}
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
                                       "attention": 2, "query_ball": 0}
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
                                       "attention": 8, "query_ball": 0}
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
    (4, {"knn": 36, "fps": 2, "fps_chunked": 0, "attention": 7,
         "query_ball": 0}),
    (16, {"knn": 71, "fps": 1, "fps_chunked": 1, "attention": 14,
          "query_ball": 0}),
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


# ------------------------------------------------------------ training slice


@pytest.mark.parametrize("b,n,m,c,r,ns,s", [
    (3, 1024, 1024, 3, 0.15, 20, 5), (2, 300, 77, 5, 1.5, 64, 7),
    (2, 4096, 64, 3, 0.3, 128, 5), (1, 40, 9, 128, 16.0, 128, 3),
    (2, 12, 6, 3, 0.01, 20, 5),
])
def test_query_ball_kernel_matches_plain(dev, b, n, m, c, r, ns, s):
    xyz = _randn(n + c, b, n, c).to(dev)
    xyz[:, n // 2:n // 2 + 5] = xyz[:, :5]  # exact ties between slots
    qs = xyz[:, :m].contiguous()
    got = query_ball_cuda(r, ns, xyz, qs, True, s)
    want = query_ball_torch(r, ns, xyz, qs, True, s)
    torch.cuda.synchronize()
    # slots and counts differ only where a distance sits within round-off
    # of r² (chip_smoke.py checks that rule at full size): on random
    # points that is rare, so at least 99.5% of rows agree exactly
    same = torch.all(got[0] == want[0], -1) & (got[1] == want[1])
    assert float(same.float().mean()) >= 0.995
    scale = 2.0 * float(torch.amax(torch.sum(xyz * xyz, -1)))
    derr = (torch.abs(got[2] - want[2]) / (want[2].abs() + scale))
    assert float(derr[same].max()) <= 1e-5
    assert float((got[3] == want[3])[same].float().mean()) >= 0.995
    for mode in ((), (True,)):
        narrow = query_ball_cuda(r, ns, xyz, qs, *mode)
        assert all(torch.equal(a, w) for a, w in zip(narrow, got))


def test_query_ball_kernel_refuses_beyond_its_limits(dev):
    ok = torch.zeros((1, 8, 3), device=dev)
    with pytest.raises(ValueError, match="n <="):
        query_ball_cuda(0.1, 4, torch.zeros((1, MAX_N + 1, 3), device=dev),
                        ok)
    with pytest.raises(ValueError, match="c <="):
        wide = torch.zeros((1, 8, MAX_C + 1), device=dev)
        query_ball_cuda(0.1, 4, wide, wide)
    with pytest.raises(ValueError, match="nsample"):
        query_ball_cuda(0.1, MAX_NSAMPLE + 1, ok, ok)


def test_knn_function_gradients_through_the_kernel(dev):
    from dispu_tpu_torch.kernels.knn import KnnFunction

    pts, qs = _randn(3, 2, 300, 8).to(dev), _randn(4, 2, 90, 8).to(dev)
    g = _randn(5, 2, 90, 6).to(dev)
    grads = []
    for use_cuda in (True, False):
        p, q = pts.clone().requires_grad_(), qs.clone().requires_grad_()
        d, idx = KnnFunction.apply(6, p, q, None, use_cuda)
        d.backward(g)
        grads.append((idx, p.grad, q.grad))
    (ik, gpk, gqk), (ip, gpp, gqp) = grads
    assert torch.equal(ik, ip)  # random points: no near-ties
    assert torch.allclose(gpk, gpp, rtol=0, atol=1e-5)
    assert torch.allclose(gqk, gqp, rtol=0, atol=1e-5)


def test_attention_function_gradients_through_the_kernel(dev):
    from dispu_tpu_torch.kernels.attention import AttentionFunction

    q, k, v = (_randn(i, 2, 600, 32).to(dev) for i in range(3))
    do = _randn(3, 2, 600, 32).to(dev)
    outs = []
    for use_cuda in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = AttentionFunction.apply(*leaves, 0.2, use_cuda)
        out.backward(do)
        outs.append((out, [t.grad for t in leaves]))
    # the backward recomputes the map from q, k, v: the same gradients
    # whichever forward ran
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    assert float(torch.abs(outs[0][0] - outs[1][0]).max()) <= 1e-3


def test_chamfer_argmin_through_the_kernel(dev):
    from dispu_tpu_torch.ops.chamfer import nn_distance

    x1, x2 = _randn(6, 2, 500, 3).to(dev), _randn(7, 2, 300, 3).to(dev)
    res = []
    for impl in ("cuda", "torch"):
        a, b = x1.clone().requires_grad_(), x2.clone().requires_grad_()
        kernels.reset_launch_counts()
        d1, i1, d2, i2 = nn_distance(a, b, impl)
        launched = kernels.launch_counts()["knn"]
        (d1.sum() + 2 * d2.sum()).backward()
        res.append((i1, i2, d1, d2, a.grad, b.grad, launched))
    assert res[0][6] == 2 and res[1][6] == 0
    # random points: the same neighbours, so the same recomputed distances
    for x, y in zip(res[0][:4], res[1][:4]):
        assert torch.equal(x, y)
    # the backward's scatter-adds run in atomics' order outside
    # deterministic mode: f32 round-off apart
    for x, y in zip(res[0][4:6], res[1][4:6]):
        assert torch.allclose(x, y, rtol=1e-6, atol=1e-6)


def test_train_step_on_the_card_reaches_every_parameter(dev):
    from dispu_tpu_torch.config import ExperimentConfig, LossConfig
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step

    cfg = ExperimentConfig(generator=GeneratorConfig(**dict(
        SMALL, num_points=256)), loss=LossConfig(repulsion_radius=0.1))
    gt = _randn(8, 4, 1024, 3).to(dev) * 0.3
    grads = {}
    for impl in ("auto", "torch"):
        st = create_generator_state(cfg.generator, impl=impl, device=dev)
        step = make_train_step(cfg, impl=impl)
        kernels.reset_launch_counts()
        st, m = step(st, gt, torch.ones(4, device=dev),
                     torch.Generator(device=dev).manual_seed(0))
        assert np.isfinite(float(m["total"]))
        grads[impl] = {n: p.grad for n, p in st.model.named_parameters()}
        counts = kernels.launch_counts()
        if impl == "auto":
            # 4 backbone + 1 refiner + 8 chamfer argmins; the NL cell's
            # 1024² map; the repulsion ball query
            assert counts == {"knn": 13, "fps": 0, "fps_chunked": 0,
                              "attention": 1, "query_ball": 1}
        else:
            assert sum(counts.values()) == 0
    for n, g in grads["torch"].items():
        if bool(g.abs().max() > 0):
            assert bool(grads["auto"][n].abs().max() > 0), n
