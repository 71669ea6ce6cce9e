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
#: the kernels the default exact paths never launch: the turbo path's,
#: the lite FPS (no caller) and the gather pair (gather_impl='pallas')
NO_TURBO = {"knn_packed": 0, "knn_group": 0, "fps_bucketed": 0,
            "fps_lite": 0, "gather_rows": 0, "scatter_rows": 0}


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
                                       "attention": 2, "query_ball": 0,
                                       **NO_TURBO}
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
                                       "attention": 2, "query_ball": 0,
                                       **NO_TURBO}
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
                                       "attention": 8, "query_ball": 0,
                                       **NO_TURBO}
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
         "query_ball": 0, **NO_TURBO}),
    (16, {"knn": 71, "fps": 1, "fps_chunked": 1, "attention": 14,
          "query_ball": 0, **NO_TURBO}),
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
                              "attention": 1, "query_ball": 1, **NO_TURBO}
        else:
            assert sum(counts.values()) == 0
    for n, g in grads["torch"].items():
        if bool(g.abs().max() > 0):
            assert bool(grads["auto"][n].abs().max() > 0), n


# --------------------------------------------------------- turbo serving


TURBO = dict(fast_knn=True, fast_gather=True, fast_gather_backbone=True,
             fused_grouping=True, dense_impl="split")


def _trunc(d, lb):
    return (d.contiguous().view(torch.int32) & ~((1 << lb) - 1)).view(
        torch.float32)


@pytest.mark.parametrize("b,n,m,c,k,dup", [
    (2, 4096, 4096, 3, 16, False), (2, 256, 256, 24, 17, True),
    (3, 100, 30, 5, 100, False),
])
def test_knn_packed_kernel_contract(dev, b, n, m, c, k, dup):
    from dispu_tpu_torch.kernels.knn import (knn_packed_cuda,
                                             knn_packed_torch,
                                             packed_lane_bits)

    pts = _randn(n, b, n, c).to(dev)
    if dup:
        pts[:, -10:] = pts[:, :10]
    qs = pts[:, :m].contiguous()
    bias = mask_duplicate_rows(pts).float() * 1e30 if dup else None
    lb = packed_lane_bits(n)
    dk, ik = knn_packed_cuda(k, pts, qs, bias)
    ed, ei = knn_cuda(min(k + 1, n), pts, qs, bias)
    # the kernel's distances are its exact kernel's, truncated, bit for
    # bit; indices move only at a truncation tie of those
    te = _trunc(ed, lb)
    assert torch.equal(dk, te[..., :k])
    eq = te[..., 1:] == te[..., :-1]  # rank p ties with rank p + 1
    tie = torch.zeros_like(ik, dtype=torch.bool)
    j = min(k, eq.shape[-1])
    tie[..., :j] |= eq[..., :j]
    tie[..., 1:] |= eq[..., :k - 1]
    assert bool(torch.all((ik == ei[..., :k]) | tie))
    # against the plain version (cuBLAS distances): swaps are rare
    dp, ip = knn_packed_torch(k, pts, qs, bias)
    assert float((ik != ip).float().mean()) <= 1e-2
    scale = 2.0 * float(torch.amax(torch.sum(pts * pts, -1)))
    step = 2.0 ** -(23 - lb)
    assert float((torch.abs(dk - dp) / (dp.abs() * 2 * step + 1e-5 * scale)
                  ).max()) <= 1.0


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("with_xyz,drop_first,dup", [
    (True, False, False), (False, True, True), (True, True, True),
])
def test_knn_group_kernel_bit_equal_to_knn_kernel(dev, with_xyz, drop_first,
                                                  dup, exact):
    from dispu_tpu_torch.kernels.knn_group import (bf16_round,
                                                   knn_group_cuda)

    b, n, k = 2, 1024, 16
    feats = _randn(1, b, n, 40 if with_xyz else 48).to(dev)
    pts = _randn(2, b, n, 3).to(dev) if with_xyz else feats
    if dup:
        pts[:, -10:] = pts[:, :10]
    qs = pts if drop_first else pts[:, ::4].contiguous()
    bias = mask_duplicate_rows(pts).float() * 1e30 if dup else None
    d, i, gx, gf = knn_group_cuda(k, pts, qs, feats, bias, exact=exact,
                                  with_xyz=with_xyz, drop_first=drop_first)
    kd, ki = knn_cuda(k + drop_first, pts, qs, bias)
    assert torch.equal(d, kd[..., drop_first:])
    assert torch.equal(i, ki[..., drop_first:])
    flat = i.reshape(b, -1, 1).long()
    rows = torch.gather(feats, 1, flat.expand(-1, -1, feats.shape[-1]))
    rows = rows.reshape(gf.shape)
    assert torch.equal(gf, rows if exact else bf16_round(rows))
    if with_xyz:
        xyz = torch.gather(pts, 1, flat.expand(-1, -1, 3)).reshape(gx.shape)
        assert torch.equal(gx, xyz)
    else:
        assert gx is None


def test_knn_group_kernel_refuses_beyond_its_limits(dev):
    from dispu_tpu_torch.kernels.knn_group import MAX_C, knn_group_cuda

    pts = torch.zeros((1, 64, 3), device=dev)
    with pytest.raises(ValueError, match="c <="):
        knn_group_cuda(4, pts, pts, torch.zeros((1, 64, MAX_C + 1),
                                                device=dev))
    with pytest.raises(ValueError, match="3-d"):
        wide = torch.zeros((1, 64, 5), device=dev)
        knn_group_cuda(4, wide, wide, wide, with_xyz=True)


@pytest.mark.parametrize("K,nb,mb", [
    (64, 384, 128), (8, 1536, 512), (3, 2500, 40), (5, 7, 7), (2, 33, 10),
])
def test_fps_bucketed_kernel_bit_equal_to_plain(dev, K, nb, mb):
    from dispu_tpu_torch.kernels.fps_bucketed import (fps_bucketed_cuda,
                                                      fps_bucketed_torch)

    x = _randn(K * nb, K, nb, 3).to(dev)
    x[:, nb // 2:nb // 2 + 3] = x[:, :3]  # ties
    assert torch.equal(fps_bucketed_cuda(mb, x), fps_bucketed_torch(mb, x))


def _own_spacing2(a):
    d = torch.cdist(a, a, compute_mode="donot_use_mm_for_euclid_dist") ** 2
    d.fill_diagonal_(float("inf"))
    return float(d.min(1).values.mean())


@pytest.mark.parametrize("final_ratio,patch,n,counts", [
    # 14 seeds → 2 chunks of 8: knn_group 4 backbone + 1 refiner a chunk
    (4, 128, 600, {"knn": 1, "knn_group": 10, "knn_packed": 0,
                   "attention": 2, "fps": 1, "fps_bucketed": 1}),
    # 7 seeds → 1 chunk, two passes; pass 2's refiner kNN over 4096
    # points is past the fused gate (≤ 2048): the packed kernel
    (16, 256, 600, {"knn": 1, "knn_group": 9, "knn_packed": 1,
                    "attention": 2, "fps": 1, "fps_bucketed": 1}),
])
def test_turbo_upsampler_goes_through_the_kernels(dev, final_ratio, patch, n,
                                                  counts):
    inf = InferenceConfig(patch_num_point=patch, patch_batch=8,
                          final_ratio=final_ratio, merge_fps="bucketed")
    cfg = GeneratorConfig(**SMALL, **TURBO)
    pc = _randn(0, n, 3).numpy()
    up = PatchUpsampler(gen_cfg=cfg, inf_cfg=inf)
    kernels.reset_launch_counts()
    out = up.upsample(pc)
    assert kernels.launch_counts() == dict(
        counts, fps_chunked=0, query_ball=0, fps_lite=0, gather_rows=0,
        scatter_rows=0)
    assert out.shape == (n * final_ratio, 3) and np.isfinite(out).all()
    ref = PatchUpsampler(gen_cfg=cfg, inf_cfg=inf, impl="torch").upsample(pc)
    # against the plain versions on the card: the bucketed merge moves
    # picks where round-off moves a candidate across a Morton step (see
    # tests/test_torch_turbo.py), so the outputs are held as sets
    assert _chamfer(out, ref) <= 0.25 * _own_spacing2(
        torch.from_numpy(ref).cuda())


# ------------------------------------------- gather pair, knn_group backward


def _rows_idx(seed, b, q, n, lo=0, hi=None):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(lo, n if hi is None else hi,
                                        (b, q)).astype(np.int32))


@pytest.mark.parametrize("b,n,c,q", [
    (28, 256, 24, 4096), (28, 256, 48, 4096), (4, 1024, 131, 16384),
    (3, 100, 3, 77), (2, 4096, 128, 5000),
])
def test_gather_rows_kernel_bit_equal(dev, b, n, c, q):
    from dispu_tpu_torch.kernels.gather_rows import (gather_rows_cuda,
                                                     gather_rows_torch)

    table = _randn(n + c, b, n, c).to(dev)
    idx = _rows_idx(q, b, q, n).to(dev)
    got = gather_rows_cuda(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_torch(table, idx))


def test_gather_rows_kernel_zeroes_rows_outside_the_table(dev):
    from dispu_tpu_torch.kernels.gather_rows import gather_rows_cuda

    table = _randn(1, 2, 50, 7).to(dev)
    idx = _rows_idx(2, 2, 40, 50, lo=-5, hi=60).to(dev)
    got = gather_rows_cuda(table, idx)
    out = (idx < 0) | (idx >= 50)
    assert bool(out.any()) and bool((got[out] == 0).all())
    inside = torch.where(out, 0, idx)
    want = torch.gather(table, 1, inside.long()[..., None].expand(-1, -1, 7))
    assert torch.equal(got[~out], want[~out])


@pytest.mark.parametrize("b,n,c,q", [
    (28, 256, 48, 4096), (4, 1024, 131, 16384), (3, 100, 3, 77),
    (2, 20000, 5, 3000), (1, 1, 4, 16384), (2, 512, 300, 2049),
])
def test_scatter_rows_kernel_bit_equal_to_ordered_sum(dev, b, n, c, q):
    """Bit-equal run to run and to the CPU's ``index_add_``, which adds
    each row's terms in ascending position as the kernel does (tests/
    test_torch_gather.py pins that order); every row of a one-row table
    takes all q positions."""
    from dispu_tpu_torch.kernels.gather_rows import (scatter_rows_cuda,
                                                     scatter_rows_torch)

    g = (_randn(q + c, b, q, c) * 10.0 ** _randn(q, b, q, 1)).to(dev)
    idx = _rows_idx(n + q, b, q, n).to(dev)
    got = scatter_rows_cuda(g, idx, n)
    again = scatter_rows_cuda(g, idx, n)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), scatter_rows_torch(g.cpu(), idx.cpu(), n))


def test_scatter_rows_kernel_drops_indices_outside_the_table(dev):
    from dispu_tpu_torch.kernels.gather_rows import (scatter_rows_cuda,
                                                     scatter_rows_torch)

    g = _randn(3, 2, 1500, 6).to(dev)
    idx = _rows_idx(4, 2, 1500, 40, lo=-3, hi=45).to(dev)
    keep = (idx >= 0) & (idx < 40)
    got = scatter_rows_cuda(g, idx, 40)
    want = scatter_rows_torch((g * keep[..., None]).cpu(),
                              torch.where(keep, idx, 0).cpu(), 40)
    assert torch.equal(got.cpu(), want)


def test_group_point_pallas_launches_the_pair(dev):
    """Inside the gate the gather kernel runs forward and the scatter
    kernel backward; the gradient equals the CPU plain version's; outside
    the gate (16x pass-2 refiner width) nothing launches."""
    from dispu_tpu_torch.ops.grouping import group_point

    pts = _randn(5, 4, 1024, 131)
    idx = torch.from_numpy(np.random.RandomState(6).randint(
        0, 1024, (4, 1024, 16)).astype(np.int32))
    cot = _randn(7, 4, 1024, 16, 131)
    grads = []
    for device in (dev, torch.device("cpu")):
        p = pts.to(device).requires_grad_(True)
        kernels.reset_launch_counts()
        out = group_point(p, idx.to(device), "pallas")
        torch.sum(out * cot.to(device)).backward()
        counts = kernels.launch_counts()
        grads.append(p.grad.cpu())
        want = 1 if device.type == "cuda" else 0
        assert counts["gather_rows"] == counts["scatter_rows"] == want
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)
    big = _randn(8, 1, 4096, 131).to(dev)
    kernels.reset_launch_counts()
    group_point(big, idx[:1].to(dev), "pallas")
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("form", ["backbone", "refiner", "critic"])
def test_knn_group_backward_on_the_card(dev, form):
    """``KnnGroupFunction``'s gradients through the kernels (the scatter
    kernel) against autograd of the plain distance and gathers at the
    kernel's own indices (the rule holds the selection fixed), to 1e-5 of
    their largest: the backbone's aliased call (drop_first, duplicate
    bias), the refiner's (with xyz) and the critic's (seeds as queries)."""
    from dispu_tpu_torch.kernels.knn_group import knn_group, rows_at

    if form == "backbone":
        x = _randn(9, 4, 256, 48)
        x[:, -8:] = x[:, :8]
        k, pts, qs, ft = 16, x, None, None
    elif form == "refiner":
        k, pts, qs, ft = 16, _randn(10, 4, 1024, 3), None, _randn(
            11, 4, 1024, 128)
    else:
        k, pts, qs, ft = 24, _randn(12, 4, 1024, 3), _randn(13, 4, 128,
                                                            3), None
    drop, with_xyz = form == "backbone", form == "refiner"

    def leaves():
        p = pts.to(dev).requires_grad_(True)
        q = p if qs is None else qs.to(dev).requires_grad_(True)
        f = p if ft is None else ft.to(dev).requires_grad_(True)
        return p, q, f, [t for j, t in enumerate((p, q, f))
                         if all(t is not u for u in (p, q, f)[:j])]

    cg = torch.Generator().manual_seed(14)
    p, q, f, uniq = leaves()
    bias = mask_duplicate_rows(p.detach()).float() * 1e30 if drop else None
    d, idx, gx, gf = knn_group(k, p, q, f, bias, with_xyz=with_xyz,
                               drop_first=drop)
    cots = [torch.randn(t.shape, generator=cg).to(dev)
            for t in (d, gx, gf) if t is not None]
    outs = [t for t in (d, gx, gf) if t is not None]
    sum(torch.sum(o * c) for o, c in zip(outs, cots)).backward()
    got = [t.grad for t in uniq]

    p, q, f, uniq = leaves()
    nbr = rows_at(p, idx)
    ref = [torch.sum((q[:, :, None, :] - nbr) ** 2, dim=-1)]
    ref += [nbr] if with_xyz else []
    ref += [rows_at(f, idx)]
    sum(torch.sum(o * c) for o, c in zip(ref, cots)).backward()
    torch.testing.assert_close(d, ref[0].detach(), rtol=1e-5, atol=1e-4)
    for g, w in zip(got, (t.grad for t in uniq)):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_fps_lite_kernel_bit_equal_and_counted(dev):
    from dispu_tpu_torch.kernels.fps import fps_lite, fps_torch

    x = _randn(15, 2, 1500, 3).to(dev)
    kernels.reset_launch_counts()
    got = fps_lite(200, x)
    assert kernels.launch_counts()["fps_lite"] == 1
    assert kernels.launch_counts()["fps"] == 0
    assert torch.equal(got, fps_torch(200, x))


@pytest.mark.parametrize("gen_kw,disc_kw,counts", [
    # critic: FPS + 6 kNN; uniform: FPS + 5 ball queries + 5 kNN; the
    # generator's 13 kNN (4 backbone, refiner, 8 chamfer), attention,
    # repulsion's ball query; 5 gathers and their 5 scatters
    (dict(gather_impl="pallas"), dict(),
     dict(knn=24, fps=2, attention=1, query_ball=6, gather_rows=5,
          scatter_rows=5)),
    # fused generator and critic: knn_group 4 + 1 + 6; scatters: 4
    # backbone, 2 refiner (features and xyz)
    (dict(fused_grouping=True), dict(fused_grouping=True),
     dict(knn=13, knn_group=11, fps=2, attention=1, query_ball=6,
          scatter_rows=6)),
])
def test_gan_step_on_the_card(dev, gen_kw, disc_kw, counts):
    """One GAN step through the kernels against one through the plain
    versions on the card: launch counts, metrics to 1e-4 relative, every
    parameter of both networks with a gradient on the plain path has one
    through the kernels."""
    from dispu_tpu_torch.config import (DiscriminatorConfig,
                                        ExperimentConfig, LossConfig,
                                        TrainConfig)
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)

    cfg = ExperimentConfig(
        generator=GeneratorConfig(**dict(SMALL, num_points=256, **gen_kw)),
        discriminator=DiscriminatorConfig(**disc_kw),
        train=TrainConfig(d_clip=0.0, gen_update=1),
        loss=LossConfig(repulsion_radius=0.1), use_gan=True)
    gt = _randn(16, 4, 1024, 3).to(dev) * 0.3
    runs = {}
    for impl in ("auto", "torch"):
        st = create_gan_state(cfg, impl=impl, device=dev)
        step = make_gan_train_step(cfg, impl=impl)
        kernels.reset_launch_counts()
        st, m = step(st, gt, torch.ones(4, device=dev),
                     torch.Generator(device=dev).manual_seed(0))
        got = kernels.launch_counts()
        if impl == "auto":
            assert got == dict(dict.fromkeys(got, 0), **counts)
        else:
            assert sum(got.values()) == 0
        # the critic's gradients are its own update's (the generator's
        # pass runs with the critic frozen)
        grads = {f"g.{n}": p.grad for n, p in st.gen.model.named_parameters()}
        grads.update({f"d.{n}": p.grad for n, p in st.disc.named_parameters()})
        runs[impl] = (m, grads)
    (mk, gk), (mp, gp) = runs["auto"], runs["torch"]
    top = max(abs(float(v)) for v in mp.values())
    for k in mp:
        assert abs(float(mk[k]) - float(mp[k])) <= 1e-4 * max(
            abs(float(mp[k])), 1e-3 * top), k
    for n, g in gp.items():
        if g is not None and bool(g.abs().max() > 0):
            assert gk[n] is not None and bool(gk[n].abs().max() > 0), n
