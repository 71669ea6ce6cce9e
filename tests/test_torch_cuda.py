"""The port's CUDA kernels, their autograd rules, and its serving and
training paths on the card.

Every test here needs an NVIDIA GPU with nvcc: it is marked ``cuda`` and
skips where no card is present.  This file imports neither JAX nor the
JAX package, so it runs on a machine with PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from dispu_tpu_torch import GeneratorConfig, InferenceConfig, kernels
from dispu_tpu_torch.inference import PatchUpsampler, pin_f32
from dispu_tpu_torch.kernels.attention import attention_cuda, attention_torch
from dispu_tpu_torch.kernels.fps import FPS_MAX_N, fps_cuda, fps_torch
from dispu_tpu_torch.kernels import measure
from dispu_tpu_torch.kernels.fps_chunked import (fps_chunked_cuda, form_for,
                                                 forms_from)
from dispu_tpu_torch.kernels.gather_rows import (BUILD_SMEM, SCATTER_MAX_N,
                                                 build_max_n, build_warps)
from dispu_tpu_torch.kernels.knn import (MAX_ROW_FLOATS, MAX_STREAM_K,
                                         RADIX_ROW_FLOATS, knn_cuda,
                                         knn_split_cuda, knn_torch)
from dispu_tpu_torch.kernels.measure import SCATTER_CASES
from dispu_tpu_torch.kernels.query_ball import (MAX_C, MAX_N, MAX_NSAMPLE,
                                                query_ball_cuda,
                                                query_ball_torch)
from dispu_tpu_torch.ops.geometry import pairwise_sq_dist
from dispu_tpu_torch.ops.knn import mask_duplicate_rows

pytestmark = pytest.mark.cuda

SMALL = dict(num_points=64, knn=8, refine_nsample=8)
#: the kernels the default exact paths never launch: the turbo path's,
#: the lite FPS (no caller), the gather pair (gather_impl='pallas') and
#: the fused refiner's (refine_local_impl 'fused' / 'megafused')
NO_TURBO = {"knn_split": 0, "knn_packed": 0, "knn_group": 0,
            "fps_bucketed": 0, "attention_bf16": 0,
            "fps_lite": 0, "gather_rows": 0, "scatter_rows": 0,
            "refine_local": 0, "refine_block": 0}


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
    """The radix form's 'row' regime (k > MAX_STREAM_K) holds a query's
    row in shared memory and refuses what does not fit."""
    pts = torch.zeros((1, RADIX_ROW_FLOATS, 1), device=dev)
    with pytest.raises(ValueError, match=str(RADIX_ROW_FLOATS)):
        knn_cuda(MAX_STREAM_K + 1, pts, pts[:, :4].contiguous())


@pytest.mark.parametrize("k", [1, 16, MAX_STREAM_K])
def test_knn_kernel_takes_rows_beyond_shared_memory_up_to_k_32(dev, k):
    """The tiled form keeps no row in shared memory: n past the 'row' regime's
    limit runs, under the plain version's contract."""
    n = MAX_ROW_FLOATS + 1000
    pts = _randn(k, 1, n, 3).to(dev)
    qs = _randn(k + 1, 1, 40, 3).to(dev)
    _assert_knn_contract(k, pts, qs, None)


def _assert_knn_contract(k, pts, qs, bias, ik=None, dk=None):
    """The kernel against the plain version (``check_knn``'s contract):
    distances to 1e-5 relative and each chosen index's plain distance that
    of the plain index at its rank to 1e-6, both with the expansion's
    scale |q|² + |p|² as the floor; no index twice in a row.  Given
    ``ik`` without ``dk``, the indices alone."""
    if ik is None:
        dk, ik = knn_cuda(k, pts, qs, bias)
    dp, ip = knn_torch(k, pts, qs, bias)
    torch.cuda.synchronize()
    full = pairwise_sq_dist(qs, pts)
    if bias is not None:
        full = full + bias[:, None, :]
    scale = 2.0 * max(float(torch.amax(torch.sum(pts * pts, -1))),
                      float(torch.amax(torch.sum(qs * qs, -1))))
    swap = torch.abs(torch.gather(full, 2, ik.long()) - dp) / (dp.abs()
                                                               + scale)
    assert float(swap.max()) <= 1e-6
    if dk is not None:
        assert float((torch.abs(dk - dp) / (dp.abs() + scale)).max()) <= 1e-5
    uniq = torch.sort(ik, dim=-1).values
    assert bool(torch.all(uniq[..., 1:] != uniq[..., :-1]))
    return dk, ik


#: (b, n, m, c, k): n and m off the tiles' multiples (128 points, 32
#: queries), n below one tile, every c of the paths, c on both sides of
#: four tiles a load (c 15 and 16) and past one 60-coordinate chunk (61,
#: 131), k on both sides of the two selection forms
TILE_EDGES = [
    (2, 129, 33, 1, 1), (3, 100, 7, 5, 16), (2, 257, 65, 3, 17),
    (1, 1000, 31, 24, 32), (2, 300, 97, 48, 33), (1, 700, 45, 3, 100),
    (1, 2048, 24, 3, 256), (2, 40, 50, 48, 32), (1, 383, 70, 131, 16),
    (2, 1024, 1024, 48, 17), (1, 4096, 200, 3, 16), (1, 600, 40, 15, 16),
    (2, 515, 33, 16, 17), (1, 300, 20, 61, 8),
]


@pytest.mark.parametrize("b,n,m,c,k", TILE_EDGES)
def test_knn_kernel_matches_plain_at_tile_edges(dev, b, n, m, c, k):
    pts = _randn(n + c, b, n, c).to(dev)
    qs = _randn(m + k, b, m, c).to(dev)
    pts[:, -5:] = pts[:, :5]  # exact ties
    _assert_knn_contract(k, pts, qs, None)
    bias = mask_duplicate_rows(pts).float() * 1e30
    _assert_knn_contract(k, pts, qs, bias)


@pytest.mark.parametrize("b,n,m,c,k", [e for e in TILE_EDGES
                                       if e[4] <= MAX_STREAM_K])
def test_knn_tiled_form_bit_equal_to_row_form(dev, b, n, m, c, k):
    """Both forms keep one association and one order, so the tiled form's
    k (k <= 32) are the radix form's first k (k' = 33), bit for bit."""
    pts = _randn(n + c, b, n, c).to(dev)
    qs = _randn(m + k, b, m, c).to(dev)
    pts[:, -5:] = pts[:, :5]
    bias = mask_duplicate_rows(pts).float() * 1e30
    for bb in (None, bias):
        dk, ik = knn_cuda(k, pts, qs, bb)
        dr, ir = knn_cuda(MAX_STREAM_K + 1, pts, qs, bb)
        assert torch.equal(dk, dr[..., :k]) and torch.equal(ik, ir[..., :k])


@pytest.mark.parametrize("k", [1, 16, 17, 32, 33, 100])
def test_knn_kernel_ties_go_to_the_lower_index(dev, k):
    """A cloud of identical points: every distance ties, so every query's
    row is 0, 1, ..., k - 1 in both forms."""
    pts = torch.full((2, 300, 5), 0.25, device=dev)
    qs = _randn(3, 2, 45, 5).to(dev)
    dk, ik = knn_cuda(k, pts, qs)
    dp, ip = knn_torch(k, pts, qs)
    assert torch.equal(ik, torch.arange(k, dtype=torch.int32,
                                        device=dev).expand(2, 45, k))
    assert torch.equal(ik, ip)
    assert float((dk - dp).abs().max()) <= 1e-5 * float(dp.abs().max())


@pytest.mark.parametrize("k", [8, 32, 40])
def test_knn_kernel_reports_unfilled_slots(dev, k):
    """Points whose coordinates overflow have +inf distances, which are
    never selected: past the finite ones a slot reports (+inf, INT_MAX)."""
    pts = _randn(4, 2, 200, 3).to(dev)
    pts[:, 20:] = 1e30  # p2 overflows: 180 points at +inf
    qs = _randn(5, 2, 37, 3).to(dev)
    dk, ik = knn_cuda(k, pts, qs)
    dp, ip = knn_torch(k, pts, qs)
    filled = min(k, 20)
    assert torch.equal(ik[..., :filled], ip[..., :filled])
    assert float((dk[..., :filled] - dp[..., :filled]).abs().max()) <= 1e-4
    assert bool(torch.all(dk[..., filled:] == float("inf")))
    assert bool(torch.all(ik[..., filled:] == 2**31 - 1))


@pytest.mark.parametrize("k,cap", [(33, None), (256, None), (256, 64),
                                   (100, 1)])
def test_knn_split_form_bit_equal_to_row_form(dev, k, cap):
    """Where both run (n + c <= RADIX_ROW_FLOATS) the 'split' regime, its
    distances recomputed each pass, returns the 'row' regime's bits:
    repeated points (exact ties) and a column bias included; a small
    buffer forces more passes over the cloud."""
    n = 20000
    pts = _randn(7, 2, n, 3).to(dev)
    pts[:, 15000:15100] = pts[:, 100:200]
    qs = pts[:, ::170].contiguous()
    bias = torch.zeros((2, n), device=dev)
    bias[:, 7000:7300] = 1e30
    for bb in (None, bias):
        got = knn_split_cuda(k, pts, qs, bb, cap=cap)
        want = knn_cuda(k, pts, qs, bb)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_knn_split_form_past_the_row_form_matches_plain(dev):
    """The patch cut of a 60,000-point cloud (k 256) through the shape
    gate, under the plain version's contract, counted as the split form."""
    from dispu_tpu_torch.ops.knn import knn as knn_ops

    pts = _randn(8, 1, 60000, 3).to(dev)
    qs = pts[:, ::85].contiguous()
    kernels.reset_launch_counts()
    dk, ik = knn_ops(256, pts, qs)
    assert kernels.launch_counts()["knn_split"] == 1
    assert kernels.launch_counts()["knn"] == 0
    _assert_knn_contract(256, pts, qs, None, ik, dk)


def test_knn_split_form_reports_unfilled_slots(dev):
    """As the 'row' regime: past the finite distances (+inf, INT_MAX)."""
    pts = _randn(9, 1, 3000, 3).to(dev)
    pts[:, 20:] = 1e30
    qs = _randn(10, 1, 7, 3).to(dev)
    dk, ik = knn_split_cuda(40, pts, qs, cap=16)
    dr, ir = knn_cuda(40, pts, qs)
    assert torch.equal(dk, dr) and torch.equal(ik, ir)
    assert bool(torch.all(ik[..., 20:] == 2**31 - 1))


def _lattice_cloud(seed, b, n, c, span=8):
    """Integer coordinates in [-span, span]: every distance (and every sum
    with an integer bias) is exact in f32 in any association, so the
    plain version's stable sort is the kernel's contract bit for bit;
    many exact ties."""
    rs = np.random.RandomState(seed)
    return torch.from_numpy(
        rs.randint(-span, span + 1, (b, n, c)).astype(np.float32))


def _both_regimes(k, pts, qs, bias=None):
    """The 'row' and the 'split' regime's (dists, idx), held bit-equal."""
    got = knn_cuda(k, pts, qs, bias)
    split = knn_split_cuda(k, pts, qs, bias)
    assert torch.equal(got[0], split[0]) and torch.equal(got[1], split[1])
    return got


@pytest.mark.parametrize("k,n,m,c", [
    (33, 2048, 24, 3), (48, 256, 256, 24), (256, 2048, 24, 3),
    (512, 2048, 12, 3), (256, 4097, 40, 3), (33, 33, 50, 5),
])
def test_knn_radix_form_bit_equal_to_plain_contract(dev, k, n, m, c):
    """k > 32, both regimes, at the paths' k (33, the GCN graph's 48, the
    patch cut's 256, 'megafused''s 512) on lattice clouds whose distances
    are exact: the plain version's bits, ties to the lower index."""
    pts = _lattice_cloud(n + k, 2, n, c).to(dev)
    qs = _lattice_cloud(m + k, 2, m, c).to(dev)
    dk, ik = _both_regimes(k, pts, qs)
    dp, ip = knn_torch(k, pts, qs)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)


@pytest.mark.parametrize("n,k", [(3000, 256), (2048, 512), (300, 40)])
def test_knn_radix_form_ties_across_the_threshold(dev, n, k):
    """Repeated points and a block of 1e30-biased columns wider than
    n - k: the k-th distance is a tie thousands wide, broken by index."""
    pts = _lattice_cloud(n, 2, n, 3, span=3).to(dev)
    pts[:, n // 2:n // 2 + 50] = pts[:, :50]
    qs = pts[:, ::max(1, n // 30)].contiguous()
    bias = torch.zeros((2, n), device=dev)
    bias[:, 7:7 + n - k + 10] = 1e30
    dk, ik = _both_regimes(k, pts, qs, bias)
    dp, ip = knn_torch(k, pts, qs, bias)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    for cap in (1, 64):
        sd, si = knn_split_cuda(k, pts, qs, bias, cap=cap)
        assert torch.equal(sd, dk) and torch.equal(si, ik)


def test_knn_radix_form_negative_zero_negative_bias_and_inf(dev):
    """-0.0 coordinates and bias entries (-0.0 equals +0.0: the lower
    index first), negative distances from a negative bias (their bits
    sort reversed), and +inf from overflowed points, never selected."""
    n, k = 1000, 300
    pts = _lattice_cloud(3, 2, n, 3, span=2).to(dev)
    pts[pts == 0] = -0.0
    qs = pts[:, ::40].contiguous()
    bias = _lattice_cloud(4, 2, n, 1, span=3)[..., 0].to(dev)
    bias[bias == 0] = -0.0
    pts[:, 900:] = 1e30  # p2 overflows: 100 columns at +inf
    dk, ik = _both_regimes(k, pts, qs, bias)
    dp, ip = knn_torch(k, pts, qs, bias)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    assert bool(torch.all(dk[..., 0] < 0))
    assert bool(torch.all(ik < 900))


@pytest.mark.parametrize("n", [300, 20000])
def test_knn_radix_form_k_equal_n_and_unfilled_slots(dev, n):
    """k = n: every pair, sorted (at 20,000 the pairs sort in the output
    rows, past the shared memory the row leaves); with +inf columns the
    slots past the finite ones report (+inf, INT_MAX)."""
    pts = _lattice_cloud(n, 1, n, 3).to(dev)
    qs = pts[:, :7].contiguous()
    dk, ik = _both_regimes(n, pts, qs)
    dp, ip = knn_torch(n, pts, qs)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    pts[:, n // 3:] = 1e30
    dk, ik = _both_regimes(n, pts, qs)
    dp, ip = knn_torch(n, pts, qs)
    filled = n // 3
    assert torch.equal(dk[..., :filled], dp[..., :filled])
    assert torch.equal(ik[..., :filled], ip[..., :filled])
    assert bool(torch.all(dk[..., filled:] == float("inf")))
    assert bool(torch.all(ik[..., filled:] == 2**31 - 1))


def test_knn_split_form_past_the_old_cap_meets_the_contract(dev):
    """The patch cut of a 2,000,000-point cloud at k 256 (past the
    1.64 M points that the chunked split form's merge held), through the
    shape gate, under the plain version's contract."""
    from dispu_tpu_torch.ops.knn import knn as knn_ops

    pts = _randn(11, 1, 2_000_000, 3).to(dev)
    qs = pts[:, ::20000].contiguous()
    kernels.reset_launch_counts()
    dk, ik = knn_ops(256, pts, qs)
    assert kernels.launch_counts()["knn_split"] == 1
    _assert_knn_contract(256, pts, qs, None, ik, dk)


@pytest.mark.parametrize("b,n,npoint", [
    (1, 2048, 24), (2, 5000, 700), (1, FPS_MAX_N, 64), (1, 10, 16),
])
def test_fps_kernel_bit_equal_to_plain(dev, b, n, npoint):
    xyz = _randn(n, b, n, 3).to(dev)
    xyz[:, n // 2:n // 2 + 3] = xyz[:, :3]
    assert torch.equal(fps_cuda(npoint, xyz), fps_torch(npoint, xyz))


def _lattice(nx, ny, nz):
    """Integer lattice points: every round of FPS ties exactly."""
    axes = [torch.arange(float(m)) for m in (nx, ny, nz)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       -1).reshape(1, -1, 3).contiguous()


@pytest.mark.parametrize("cloud", ["lattice", "duplicated"])
def test_fps_kernel_bit_equal_at_the_merge_shape_with_ties(dev, cloud):
    # the 4x merge of a 2048-point cloud: 24,576 points -> 8,192
    if cloud == "lattice":
        xyz = _lattice(32, 32, 24)
    else:
        xyz = _randn(7, 1, 24576, 3)
        xyz[:, 12288:] = xyz[:, :12288]  # every point twice
    xyz = xyz.to(dev)
    assert torch.equal(fps_cuda(8192, xyz), fps_torch(8192, xyz))


@pytest.mark.parametrize("b,n,npoint", [
    (1, 24576, 2000), (2, 24576, 2000), (28, 1024, 128), (28, 1024, 51),
])
def test_fps_kernel_bit_equal_across_batches(dev, b, n, npoint):
    xyz = _randn(b + n, b, n, 3)
    xyz[:, n // 2:n // 2 + 50] = xyz[:, :50]
    xyz = xyz.to(dev)
    assert torch.equal(fps_cuda(npoint, xyz), fps_torch(npoint, xyz))


# n at each edge of the forms: one block of 256 threads up to 2,048
# points, one of 1024 up to 8,192, clusters of 2, 3 and 4 blocks of 1024
# up to 16,384, 24,576 and FPS_MAX_N
@pytest.mark.parametrize("n", [2048, 2049, 8192, 8193, 16384, 16385, 24576,
                               24577, FPS_MAX_N])
def test_fps_kernel_bit_equal_where_its_form_changes(dev, n):
    xyz = _randn(n, 1, n, 3)
    xyz[:, n - 64:] = xyz[:, :64]  # ties between the first and last block
    xyz = xyz.to(dev)
    assert torch.equal(fps_cuda(300, xyz), fps_torch(300, xyz))


def test_fps_kernel_refuses_clouds_past_its_limit(dev):
    with pytest.raises(ValueError, match=str(FPS_MAX_N)):
        fps_cuda(8, torch.zeros((1, FPS_MAX_N + 1, 3), device=dev))


# the forms csrc/fps_chunked.cu picks from n, and their limits
FORM_EDGES = [
    (5, 512, 16, "registers", 40960), (6, 512, 16, "registers", 49152),
    (8, 512, 16, "registers", 65536), (8, 512, 20, "registers", 81920),
    (8, 512, 24, "registers", 98304), (8, 512, 36, "shared", 147456),
]


def test_fps_chunked_forms_cover_every_cloud_past_fps_cu(dev):
    """From just past fps.cu's limit every n takes the smallest on-chip
    form that holds it, with no gap; past the last, device memory."""
    forms = forms_from(FPS_MAX_N + 1)
    assert [tuple(f) + (f.capacity,) for f in forms[:-1]] == FORM_EDGES
    assert tuple(forms[-1]) == (8, 1024, 0, "device")
    lower = FPS_MAX_N
    for form in forms[:-1]:
        for n in [*range(lower + 1, form.capacity, 997), form.capacity]:
            assert form_for(n) == form
        lower = form.capacity


# n at each edge of the kernel's forms (FORM_EDGES), a form's limit and
# one past it, and ragged chunks between
@pytest.mark.parametrize("b,n,npoint", [
    (1, FPS_MAX_N + 1, 64), (3, 40960, 50), (1, 40961, 50), (1, 40000, 64),
    (3, 49152, 50), (1, 49153, 50), (1, 57344, 40), (3, 57345, 40),
    (1, 65536, 40), (1, 65537, 40), (3, 81920, 40), (1, 81921, 40),
    (3, 98304, 100), (1, 98305, 50), (3, 98309, 100), (1, 147456, 64),
    (3, 147457, 40), (1, 479232, 30), (1, 100, 100),
])
def test_fps_chunked_kernel_bit_equal_to_plain(dev, b, n, npoint):
    xyz = _randn(n, b, n, 3)
    xyz[:, n // 2:n // 2 + 3] = xyz[:, :3]
    if n > 1100:  # ties between the first and the last block
        xyz[:, n - 50:] = xyz[:, 1000:1050]
    xyz = xyz.to(dev)
    assert torch.equal(fps_chunked_cuda(npoint, xyz), fps_torch(npoint, xyz))


@pytest.mark.parametrize("b", [1, 3])
def test_fps_chunked_kernel_more_samples_than_distinct_points(dev, b):
    # 37 distinct points tiled over 40,003 (blocks of 8,001): exact ties
    # within and across blocks, then every min-distance 0 and index 0
    xyz = _randn(37, b, 37, 3).repeat(1, 1082, 1)[:, :40003].to(dev)
    got = fps_chunked_cuda(64, xyz.contiguous())
    assert torch.equal(got, fps_torch(64, xyz))
    assert all(sorted(row[:37].tolist()) == list(range(37)) for row in got)
    assert (got[:, 37:] == 0).all()


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


@pytest.mark.parametrize("b,nq,nk,c,cv", [
    (32, 1024, 1024, 64, 64),   # a 4x request
    (32, 4096, 4096, 64, 64),   # pass 2 of a 16x request
    (2, 512, 8192, 64, 64),     # the gate's largest key count
    (2, 700, 650, 64, 40),      # ragged, cv off the tensor-core tile
    (3, 1000, 77, 48, 24),      # fewer keys than one tile
    (2, 300, 330, 184, 184),    # fine_extractor=True
    (2, 300, 330, 256, 256),    # the widest the gate sends
])
def test_attention_kernel_matches_plain_at_its_shapes(dev, b, nq, nk, c, cv):
    q = _randn(nq, b, nq, c).to(dev)
    k = _randn(nk, b, nk, c).to(dev)
    v = _randn(cv, b, nk, cv).to(dev)
    got = attention_cuda(q, k, v, c ** -0.5)
    want = attention_torch(q, k, v, c ** -0.5, bf16_operands=True)
    err = torch.abs(got - want)
    # chip_smoke.py's ATTN_MAX_ABS and ATTN_MEAN_ABS
    assert float(err.max()) <= 1e-3 and float(err.mean()) <= 1e-5


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


@pytest.mark.parametrize("b,nq,nk,c,cv,offset", [
    (4, 1024, 1024, 64, 64, 0),    # the refiner's tiles: read in place
    (3, 700, 650, 64, 40, 0),      # off the tiles: the padding copy
    (2, 512, 512, 64, 64, 1),      # misaligned: the padding copy
])
def test_attention_bf16_entry_bit_equal_to_f32_entry(dev, b, nq, nk, c, cv,
                                                     offset):
    """bf16 q, k, v through the bf16 entry give the f32 entry's bits for
    the same values, since rounding a bf16 value to bf16 is the
    identity; each entry counts its own launches."""
    ts = []
    for i, (rows, w) in enumerate(((nq, c), (nk, c), (nk, cv))):
        x = _randn(i, b, rows, w).to(dev).to(torch.bfloat16)
        buf = torch.empty(x.numel() + offset, dtype=torch.bfloat16,
                          device=dev)
        ts.append(buf[offset:].view(b, rows, w).copy_(x))
    kernels.reset_launch_counts()
    got = attention_cuda(*ts, c ** -0.5)
    want = attention_cuda(*(t.float() for t in ts), c ** -0.5)
    counts = kernels.launch_counts()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert counts["attention_bf16"] == 1 and counts["attention"] == 1


def test_bf16_upsampler_goes_through_the_kernels(dev):
    """bf16 compute: the JAX package's gates at bf16 (the attention's bf16
    entry once a chunk, the kNN kernels on upcast features, no gather or
    refiner kernel); f32 out, within the bf16 path's own precision of the
    f32 path."""
    pc = _randn(0, 600, 3).numpy()
    outs = {}
    for dtype in ("float32", "bfloat16"):
        inf = InferenceConfig(patch_num_point=128, patch_batch=8,
                              compute_dtype=dtype)
        up = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf)
        kernels.reset_launch_counts()
        outs[dtype] = up.upsample(pc)
        counts = kernels.launch_counts()
    assert counts == {"knn": 11, "fps": 2, "fps_chunked": 0, "attention": 0,
                      "query_ball": 0, **NO_TURBO, "attention_bf16": 2}
    out = outs["bfloat16"]
    assert out.dtype == np.float32 and out.shape == (2400, 3)
    assert np.isfinite(out).all()
    d = np.sum((out[:, None] - outs["float32"][None]) ** 2, axis=-1)
    assert d.min(1).mean() + d.min(0).mean() <= 1e-2


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
    (2, 12, 6, 3, 0.01, 20, 5), (2, 1000, 300, 3, 0.5, 1, 1),
    (2, 4096, 100, 3, 1.0, 128, 100), (3, 2000, 130, 3, 2.0, 128, 8),
    (1, 500, 200, 40, 30.0, 100, 9), (2, 1024, 51, 3, 0.0632455532, 4, 2),
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


@pytest.mark.parametrize("c", [3, 7])
def test_query_ball_kernel_empty_balls(dev, c):
    """No point within the radius of any query: count 0, every slot
    index 0 at distance 0, the selection index 0, as the plain version."""
    xyz = _randn(11, 2, 700, c).to(dev)
    qs = xyz[:, :90] + 100.0
    got = query_ball_cuda(0.5, 16, xyz, qs, True, 5)
    want = query_ball_torch(0.5, 16, xyz, qs, True, 5)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert int(got[1].abs().sum()) == 0 and int(got[0].abs().sum()) == 0


def test_query_ball_kernel_scalar_and_tensor_radius_agree(dev):
    """A float radius goes by value, a (b,) tensor by pointer: the same
    bits; a call with a float makes no synchronization or copy."""
    from torch.profiler import ProfilerActivity, profile

    xyz = _randn(12, 3, 1024, 3).to(dev)
    by_value = query_ball_cuda(0.2, 20, xyz, xyz, True, 5)
    by_tensor = query_ball_cuda(torch.full((3,), 0.2, device=dev), 20, xyz,
                                xyz, True, 5)
    assert all(torch.equal(a, w) for a, w in zip(by_value, by_tensor))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        query_ball_cuda(0.2, 20, xyz, xyz, False, 5)
    assert not [e.name for e in prof.events()
                if "Synchronize" in e.name or "Memcpy" in e.name]


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


def test_world_size_1_mesh_step_is_the_plain_step(dev, tmp_path):
    """A one-process NCCL group and its (1, 1) mesh: two data-parallel CD
    steps are the plain steps bit for bit (every collective an identity),
    with the plain steps' launches."""
    import torch.distributed as dist

    from dispu_tpu_torch.config import ExperimentConfig, LossConfig
    from dispu_tpu_torch.parallel.mesh import make_mesh
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step

    cfg = ExperimentConfig(generator=GeneratorConfig(**dict(
        SMALL, num_points=256)), loss=LossConfig(repulsion_radius=0.1))
    gt = _randn(8, 4, 1024, 3).to(dev) * 0.3
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cuda")
        runs = []
        for m in (None, mesh):
            st = create_generator_state(cfg.generator, device=dev)
            step = make_train_step(cfg, mesh=m)
            gen = torch.Generator(device=dev).manual_seed(0)
            kernels.reset_launch_counts()
            for _ in range(2):
                st, metrics = step(st, gt, torch.ones(4, device=dev), gen)
            runs.append((st, metrics, kernels.launch_counts()))
    finally:
        dist.destroy_process_group()
    (a, ma, ca), (b, mb, cb) = runs
    assert ca == cb and ca["knn"] == 26
    assert {k: float(v) for k, v in ma.items()} == {
        k: float(v) for k, v in mb.items()}
    for (n, x), (_, y) in zip(a.state_dict()["model"].items(),
                              b.state_dict()["model"].items()):
        assert torch.equal(x, y), n
    for n in a.mu:
        assert torch.equal(a.mu[n], b.mu[n]) and torch.equal(a.nu[n],
                                                             b.nu[n]), n


# --------------------------------------------------------- turbo serving


TURBO = dict(fast_knn=True, fast_gather=True, fast_gather_backbone=True,
             fused_grouping=True, dense_impl="split")


def _trunc(d, lb):
    return (d.contiguous().view(torch.int32) & ~((1 << lb) - 1)).view(
        torch.float32)


@pytest.mark.parametrize("b,n,m,c,k,dup", [
    (2, 4096, 4096, 3, 16, False), (2, 256, 256, 24, 17, True),
    (3, 100, 30, 5, 100, False), (2, 4096, 4096, 3, 1, False),
    (2, 4096, 4096, 3, 32, False), (2, 1024, 1024, 3, 33, False),
    (2, 300, 97, 48, 20, True), (1, 129, 33, 3, 16, False),
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


@pytest.mark.parametrize("k", [1, 16, 33])
def test_knn_packed_kernel_selects_inf_keys_by_index(dev, k):
    """Past the finite distances the packed keys of +inf distances come in
    index order, as in knn_pallas's int order and the plain version."""
    from dispu_tpu_torch.kernels.knn import (knn_packed_cuda,
                                             knn_packed_torch)

    pts = _randn(13, 2, 1024, 3).to(dev)
    bias = torch.full((2, 1024), float("inf"), device=dev)
    bias[:, ::200] = 0.0  # 6 finite columns
    dk, ik = knn_packed_cuda(k, pts, pts, bias)
    dp, ip = knn_packed_torch(k, pts, pts, bias)
    tail = min(k, 6)
    assert torch.equal(ik[..., tail:], ip[..., tail:])
    assert torch.equal(dk[..., tail:], dp[..., tail:])
    assert bool(torch.all(torch.isinf(dk[..., tail:])))


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


def _assert_group_matches_knn(k, pts, qs, feats, bias, exact, with_xyz,
                              drop_first):
    """``knn_group_cuda``'s (dists, idx) bit-equal to ``knn_cuda``'s at k
    (+1 with drop_first, the first rank dropped), its rows bit-equal to
    the gathers at its own indices (bf16-rounded unless exact, zeros at an
    unfilled slot), and against the plain version the kNN contract."""
    from dispu_tpu_torch.kernels.knn_group import (bf16_round,
                                                   knn_group_cuda)

    d, i, gx, gf = knn_group_cuda(k, pts, qs, feats, bias, exact=exact,
                                  with_xyz=with_xyz, drop_first=drop_first)
    kd, ki = knn_cuda(k + drop_first, pts, qs, bias)
    assert torch.equal(d, kd[..., drop_first:])
    assert torch.equal(i, ki[..., drop_first:])
    b, n = pts.shape[:2]
    filled = (i < n)[..., None]
    flat = torch.where(i < n, i, 0).reshape(b, -1, 1).long()
    rows = torch.gather(feats, 1, flat.expand(-1, -1, feats.shape[-1]))
    rows = torch.where(filled, rows.reshape(gf.shape), 0.0)
    assert torch.equal(gf, rows if exact else bf16_round(rows))
    if with_xyz:
        xyz = torch.gather(pts, 1, flat.expand(-1, -1, 3)).reshape(gx.shape)
        assert torch.equal(gx, torch.where(filled, xyz, 0.0))
    else:
        assert gx is None
    return d, i


@pytest.mark.parametrize("b,n,m,c,cf,k,drop_first", [
    (2, 129, 33, 3, 131, 16, False), (1, 100, 7, 3, 128, 1, False),
    (2, 257, 257, 24, 24, 16, True), (1, 300, 300, 48, 48, 31, True),
    (1, 300, 300, 48, 48, 32, True), (2, 200, 45, 5, 131, 17, False),
    (1, 700, 70, 3, 40, 33, False), (2, 1024, 1024, 48, 48, 16, True),
    (1, 90, 90, 1, 7, 16, True),
])
@pytest.mark.parametrize("exact", [True, False])
def test_knn_group_kernel_matches_plain_at_tile_edges(dev, b, n, m, c, cf,
                                                      k, drop_first, exact):
    with_xyz = c == 3
    pts = _randn(n + c, b, n, c).to(dev)
    pts[:, -5:] = pts[:, :5]
    qs = pts[:, :m].contiguous() if drop_first else _randn(m, b, m, c).to(dev)
    feats = pts if cf == c else _randn(cf, b, n, cf).to(dev)
    bias = mask_duplicate_rows(pts).float() * 1e30 if drop_first else None
    d, i = _assert_group_matches_knn(k, pts, qs, feats, bias, exact,
                                     with_xyz, drop_first)
    kd, ki = knn_cuda(k + drop_first, pts, qs, bias)
    _assert_knn_contract(k + drop_first, pts, qs, bias, ki, kd)


def test_knn_group_kernel_gathers_from_an_unaligned_table(dev):
    """feats at a 4-byte offset: the scalar copy, the same rows."""
    store = _randn(9, 2 * 300 * 48 + 1).to(dev)
    feats = store[1:].view(2, 300, 48)
    pts = feats[..., :3].contiguous()
    _assert_group_matches_knn(16, pts, pts, feats, None, False, True, False)


@pytest.mark.parametrize("k,drop_first", [(16, True), (31, True),
                                          (33, False)])
def test_knn_group_kernel_ties_and_unfilled_slots(dev, k, drop_first):
    """Identical points tie to the lower index; points whose coordinates
    overflow are never selected, and their slots report (+inf, INT_MAX)
    and gather zeros."""
    pts = torch.full((2, 200, 3), 0.25, device=dev)
    feats = _randn(2, 2, 200, 24).to(dev)
    d, i = _assert_group_matches_knn(k, pts, pts, feats, None, True, True,
                                     drop_first)
    assert torch.equal(i[0, 0], torch.arange(int(drop_first),
                                             k + int(drop_first),
                                             dtype=torch.int32, device=dev))
    pts[:, 10:] = 1e30
    qs = _randn(3, 2, 20, 3).to(dev)
    d, i = _assert_group_matches_knn(k, pts, qs, feats, None, False, True,
                                     drop_first)
    filled = 10 - int(drop_first)
    assert bool(torch.all(d[..., filled:] == float("inf")))
    assert bool(torch.all(i[..., filled:] == 2**31 - 1))
    assert bool(torch.all(i[..., :filled] < 10))


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


def _fps_bucketed_cases():
    """(label, K, n_b, m_b) at both edges of every on-chip form of the
    kernel (its capacity and one past it, the last one past the shared
    memory form: the device form), then the 60,000-point cloud's 4×
    buckets and more buckets than the card has SMs."""
    from dispu_tpu_torch.kernels.fps_bucketed import forms_from

    cases = []
    for form in forms_from(1)[:-1]:
        for nb in (form.capacity, form.capacity + 1):
            cases.append((f"{form} edge {nb}", 3, nb, min(nb, 48)))
    return cases + [("60,000-point 4x", 8, 11248, 3750),
                    ("K 300", 300, 384, 128)]


def test_fps_bucketed_kernel_bit_equal_at_its_forms_edges(dev):
    from dispu_tpu_torch.kernels.fps_bucketed import (fps_bucketed_cuda,
                                                      fps_bucketed_torch)

    for i, (label, K, nb, mb) in enumerate(_fps_bucketed_cases()):
        x = _randn(100 + i, K, nb, 3).to(dev)
        x[:, nb - 10:] = x[:, :10]  # ties between the first and last threads
        got = fps_bucketed_cuda(mb, x)
        assert torch.equal(got, fps_bucketed_torch(mb, x)), label


@pytest.mark.parametrize("nb,distinct,mb", [(384, 5, 128), (1536, 37, 512),
                                            (100, 1, 20)])
def test_fps_bucketed_kernel_more_samples_than_distinct_points(dev, nb,
                                                               distinct, mb):
    """Each bucket repeats a few points: ties in every round, and once
    every min-distance is 0 every later pick is index 0."""
    from dispu_tpu_torch.kernels.fps_bucketed import (fps_bucketed_cuda,
                                                      fps_bucketed_torch)

    pts = _randn(nb + distinct, 4, distinct, 3)
    x = pts.repeat(1, nb // distinct + 1, 1)[:, :nb].contiguous().to(dev)
    got = fps_bucketed_cuda(mb, x)
    assert torch.equal(got, fps_bucketed_torch(mb, x))
    assert bool((got[:, distinct:] == 0).all())


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
        counts, knn_split=0, fps_chunked=0, query_ball=0, fps_lite=0,
        gather_rows=0, scatter_rows=0, refine_local=0, refine_block=0,
        attention_bf16=0)
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


# the train step's three shapes; then c in {1, 3, 4, 24, 48, 128, 131},
# float4 rows where c % 4 == 0, floats else, q past a group of 32 rows
@pytest.mark.parametrize("b,n,c,q", [
    (28, 256, 24, 4096), (28, 256, 48, 4096), (4, 1024, 131, 16384),
    (3, 100, 3, 77), (2, 4096, 128, 5000), (2, 300, 1, 1000),
    (3, 300, 4, 1001), (3, 70, 24, 33), (1, 50, 48, 31), (2, 333, 131, 95),
])
def test_gather_rows_kernel_bit_equal(dev, b, n, c, q):
    from dispu_tpu_torch.kernels.gather_rows import (gather_rows_cuda,
                                                     gather_rows_torch)

    table = _randn(n + c, b, n, c).to(dev)
    idx = _rows_idx(q, b, q, n).to(dev)
    got = gather_rows_cuda(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_torch(table, idx))


@pytest.mark.parametrize("c", [7, 8])
def test_gather_rows_kernel_zeroes_rows_outside_the_table(dev, c):
    from dispu_tpu_torch.kernels.gather_rows import gather_rows_cuda

    table = _randn(1, 2, 50, c).to(dev)
    idx = _rows_idx(2, 2, 40, 50, lo=-5, hi=60).to(dev)
    got = gather_rows_cuda(table, idx)
    out = (idx < 0) | (idx >= 50)
    assert bool(out.any()) and bool((got[out] == 0).all())
    inside = torch.where(out, 0, idx)
    want = torch.gather(table, 1, inside.long()[..., None].expand(-1, -1, c))
    assert torch.equal(got[~out], want[~out])


@pytest.mark.parametrize("c", [4, 24, 48, 131])
def test_gather_rows_kernel_bit_equal_from_an_unaligned_table(dev, c):
    """A contiguous table that starts one float into its storage is not
    16-byte aligned: the kernel takes floats, not float4s, and is exact."""
    from dispu_tpu_torch.kernels.gather_rows import (gather_rows_cuda,
                                                     gather_rows_torch)

    b, n, q = 3, 200, 700
    table = _randn(c, b * n * c + 1).to(dev)[1:].view(b, n, c).contiguous()
    assert table.data_ptr() % 16 != 0
    idx = _rows_idx(c + 1, b, q, n).to(dev)
    got = gather_rows_cuda(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_torch(table, idx))


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


def _scatter_bit_equal(g, idx, n):
    """The kernel's output: bit-equal run to run and to the CPU's
    ``index_add_``."""
    from dispu_tpu_torch.kernels.gather_rows import (scatter_rows_cuda,
                                                     scatter_rows_torch)

    got = scatter_rows_cuda(g, idx, n)
    again = scatter_rows_cuda(g, idx, n)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), scatter_rows_torch(g.cpu(), idx.cpu(), n))
    return got


@pytest.mark.parametrize("case", SCATTER_CASES, ids=lambda c: c.label)
def test_scatter_rows_kernel_bit_equal_at_the_train_steps_shapes(dev, case):
    g, idx = measure.scatter_inputs(torch.Generator().manual_seed(10), case)
    _scatter_bit_equal(g.to(dev), idx.to(dev), case.n)


@pytest.mark.parametrize("c", [3, 4, 24, 131])
def test_scatter_rows_kernel_bit_equal_from_unaligned_rows(dev, c):
    """``g`` one float into its storage is not 16-byte aligned, nor then is
    the output's row width at c 3 and 131: floats, not float4s."""
    b, n, q = 3, 200, 3000
    g = _randn(c, b * q * c + 1).to(dev)[1:].view(b, q, c)
    assert g.data_ptr() % 16 != 0 and g.is_contiguous()
    _scatter_bit_equal(g, _rows_idx(c, b, q, n).to(dev), n)


def test_scatter_rows_kernel_unnamed_rows_are_positive_zeros(dev):
    """Rows that no index names, and rows whose terms are all -0.0, come
    out +0.0, as ``index_add_`` into zeros gives them."""
    b, n, q, c = 2, 500, 4000, 8
    g = _randn(5, b, q, c)
    idx = _rows_idx(6, b, q, n // 2)   # rows n/2.. never named
    idx[:, :64] = n // 2 - 1           # and row n/2 - 1 takes only -0.0s
    idx[:, 64:][idx[:, 64:] == n // 2 - 1] = 0
    g[:, :64] = -0.0
    got = _scatter_bit_equal(g.to(dev), idx.to(dev), n)
    assert not bool(torch.signbit(got[:, n // 2 - 1:]).any())
    assert bool((got[:, n // 2 - 1:] == 0).all())


@pytest.mark.parametrize("b,n,q,c", [(2, 300, 5000, 24), (1, 4, 40000, 3),
                                     (3, 1024, 40000, 48)])
def test_scatter_rows_kernel_one_row_takes_every_position(dev, b, n, q, c):
    """Every position at one row, across every warp's slice of the index
    build (q past one segment and past 32 warps' slices)."""
    g = (_randn(q, b, q, c) * 10.0 ** _randn(c, b, q, 1)).to(dev)
    idx = torch.full((b, q), n - 1, dtype=torch.int32, device=dev)
    got = _scatter_bit_equal(g, idx, n)
    assert bool((got[:, :n - 1] == 0).all())


@pytest.mark.parametrize("past", [0, 1])
def test_scatter_rows_kernel_at_the_index_builds_limit(dev, past):
    """The largest cloud the one-launch index build takes (4 warps) at q =
    30,000 and one past it, which takes the multi-pass route."""
    b, q, c = 2, 30000, 5
    n = build_max_n(q) + past
    assert (build_warps(n, q) > 0) == (past == 0)
    g = (_randn(n, b, q, c) * 10.0 ** _randn(q, b, q, 1)).to(dev)
    _scatter_bit_equal(g, _rows_idx(n + 1, b, q, n).to(dev), n)


def test_scatter_rows_build_warps_is_the_kernels_formula(dev):
    """``build_warps`` (Python) against ``dispu_scatter_build_warps`` (the
    C formula that picks the route) at every edge of its steps."""
    from dispu_tpu_torch.kernels import gather_rows

    fn = gather_rows._fn("dispu_scatter_build_warps",
                         (ctypes.c_int, ctypes.c_int))
    cases = [(256, 4096), (1024, 16384), (SCATTER_MAX_N, 1)]
    for q in (1, 4096, 16384, 30000):
        for w in (32, 16, 8, 4):
            n = (BUILD_SMEM // 4 - q) // w
            cases += [(n, q), (n + 1, q)]
    for n, q in cases:
        if n >= 1:
            assert fn(n, q) == build_warps(n, q), (n, q)


def test_scatter_rows_kernel_makes_no_host_synchronization(dev):
    from torch.profiler import ProfilerActivity, profile

    from dispu_tpu_torch.kernels.gather_rows import scatter_rows_cuda

    g = _randn(1, 4, 4096, 24).to(dev)
    idx = _rows_idx(2, 4, 4096, 256).to(dev)
    scatter_rows_cuda(g, idx, 256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scatter_rows_cuda(g, idx, 256)
    names = [evt.name for evt in prof.events()]
    assert not [m for m in names if "Synchronize" in m or "Memcpy" in m]


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
    # its shapes in chip_smoke.py: the critic's seeds and the 4x merge
    for b, n, npoint in ((28, 1024, 128), (1, 24576, 8192)):
        x = _randn(n, b, n, 3)
        x[:, n - 100:] = x[:, :100]
        x = x.to(dev)
        assert torch.equal(fps_lite(npoint, x), fps_torch(npoint, x))
    assert kernels.launch_counts()["fps_lite"] == 3


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


# ----------------------------------------------------- the fused refiner


def _local_params(seed, dev, k, cf, mlp):
    from dispu_tpu_torch.kernels.refine_local import LocalParams

    rng = np.random.RandomState(seed)
    c1, c2, co = mlp
    shapes = [(cf, c1), (c1,), (c1, c2), (c2,), (3, k), (k,), (cf, co),
              (co,), (k, c2, co), (co,)]
    return LocalParams(*(torch.from_numpy(
        (0.2 * rng.randn(*s)).astype(np.float32)).to(dev) for s in shapes))


@pytest.mark.parametrize("b,n,k,c,mlp", [
    (2, 256, 8, 32, (32, 32, 64)),    # 8 queries a block (64 rows), aligned
    (1, 200, 12, 20, (24, 40, 48)),   # 25 tiles (odd), a ragged last tile
    (2, 128, 16, 128, (128, 128, 256)),
    (1, 136, 16, 17, (20, 12, 40)),   # 17 tiles; c1, c2 off 8; odd cf;
                                      # co off 16
    (2, 128, 12, 20, (24, 16, 300)),  # two head passes, the second ragged
    (1, 128, 8, 10, (16, 16, 16)),    # one head tile: a block's slice empty
    (1, 4096, 16, 128, (128, 128, 256)),  # pass 2's n
], ids=["k8", "k12-ragged", "full", "odd-widths", "co300", "co16",
        "pass2-n"])
def test_refine_kernels_match_plain(dev, b, n, k, c, mlp):
    """Both refiner kernels against their plain versions on the card at
    f32 round-off (1e-5 of the output's scale) at the edges of their
    design: tile counts per cloud that are not a multiple of the cluster's
    two blocks, widths off the mma tiles, k 8, 12, 16, and pass 2's n =
    4096 (admitted by refine_block); refine_block's selection bit-equal to
    the kNN kernel's."""
    from dispu_tpu_torch.kernels.refine_block import (refine_block_cuda,
                                                      refine_block_torch)
    from dispu_tpu_torch.kernels.refine_local import (refine_local_cuda,
                                                      refine_local_torch)

    p = _local_params(n + k, dev, k, 6 + c, mlp)
    g = _randn(1, b, n, k, 6 + c).to(dev)
    got, want = refine_local_cuda(g, p), refine_local_torch(g, p)
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 1e-5 * scale
    xyz, feats = _randn(2, b, n, 3).to(dev), _randn(3, b, n, c).to(dev)
    got, idx = refine_block_cuda(xyz, feats, p, with_idx=True)
    assert torch.equal(idx, knn_cuda(k, xyz, xyz)[1])
    want = refine_block_torch(xyz, feats, p, idx=idx)
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("kernel", ["refine_local", "refine_block"])
def test_refine_kernels_repeat_bit_equal(dev, kernel):
    """One launch repeated gives the same bits: the weights' ring (its
    multicast copies, barriers and the two blocks' exchange of pools)
    leaves no order to chance."""
    from dispu_tpu_torch.kernels.refine_block import refine_block_cuda
    from dispu_tpu_torch.kernels.refine_local import refine_local_cuda

    p = _local_params(5, dev, 16, 134, (128, 128, 256))
    if kernel == "refine_local":
        g = _randn(6, 4, 1024, 16, 134).to(dev)
        outs = [refine_local_cuda(g, p) for _ in range(3)]
    else:
        xyz, feats = _randn(7, 4, 1024, 3).to(dev), _randn(8, 4, 1024,
                                                           128).to(dev)
        outs = [refine_block_cuda(xyz, feats, p) for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_refine_kernels_refuse_beyond_their_limits(dev):
    """refine_local refuses n % 128; refine_block takes any n since its
    selection is knn.cu's launch (5,196 points, one past what its distance
    rows held, 8,192, a patch-512 16× request's pass 2, and 60,000, past
    any row of shared memory): its indices the plain selection's but for
    near-tie swaps, its output the plain version's at them.  It refuses a width whose tile and pools do
    not fit beside the weights' ring."""
    from dispu_tpu_torch.kernels.refine_block import (block_fits,
                                                      refine_block_cuda,
                                                      refine_block_torch)
    from dispu_tpu_torch.kernels.refine_local import refine_local

    p = _local_params(0, dev, 16, 134, (128, 128, 256))
    with pytest.raises(ValueError, match="multiple of"):
        refine_local(_randn(0, 1, 200, 16, 134).to(dev), p)
    for n in (5196, 8192, 60000):
        xyz, feats = _randn(1, 1, n, 3).to(dev), _randn(2, 1, n, 128).to(dev)
        got, idx = refine_block_cuda(xyz, feats, p, with_idx=True)
        _assert_plain_selection(16, xyz, idx)
        want = refine_block_torch(xyz, feats, p, idx=idx)
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= 1e-5 * scale, n
    # c2 = 256: the tile's h1 and the pools pass 232,448 bytes
    wide = _local_params(0, dev, 16, 134, (128, 256, 256))
    assert not block_fits(16, 134, 128, 256, 256)
    with pytest.raises(ValueError, match="shared memory"):
        refine_block_cuda(_randn(1, 1, 256, 3).to(dev),
                          _randn(2, 1, 256, 128).to(dev), wide)


def test_refine_block_predicate_is_the_kernels_formula(dev):
    """``block_smem`` in Python against the library's
    ``dispu_refine_block_smem`` over k and the widths (n has left the
    formula: the kernel launches at 16 to 60,000 points at the default
    width), the widths past a block's shared memory included."""
    import ctypes

    from dispu_tpu_torch.kernels import _build
    from dispu_tpu_torch.kernels.refine_block import block_fits, block_smem

    fn = _build.load("refine_block").dispu_refine_block_smem
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_size_t
    for k, cf, c1, c2, co, t in ((16, 134, 128, 128, 256, 8),
                                 (8, 134, 128, 128, 256, 8),
                                 (4, 9, 8, 8, 8, 8),
                                 (16, 38, 32, 48, 64, 8),
                                 (64, 134, 128, 128, 256, 2),
                                 (16, 134, 128, 256, 256, 8),
                                 (16, 134, 512, 128, 256, 8),
                                 (1, 7, 1, 1, 1, 8)):
        assert fn(k, cf, c1, c2, co, t) == block_smem(k, cf, c1, c2, co, t)
    assert fn(16, 134, 128, 128, 256, 8) == 222512
    assert fn(16, 134, 128, 256, 256, 8) == 0
    assert block_fits(16, 134, 128, 128, 256)
    p = _local_params(1, dev, 16, 134, (128, 128, 256))
    for n in (16, 5195, 5196, 60000):
        xyz = _randn(n, 1, n, 3).to(dev)
        out, _ = refine_block_cuda_checked(xyz, _randn(4, 1, n, 128).to(dev),
                                           p)
        assert out.shape == (1, n, 256) and bool(torch.isfinite(out).all())


def refine_block_cuda_checked(xyz, feats, p):
    """``refine_block_cuda``'s (output, indices), the indices held to the
    plain selection's (``_assert_plain_selection``)."""
    from dispu_tpu_torch.kernels.refine_block import refine_block_cuda

    out, idx = refine_block_cuda(xyz, feats, p, with_idx=True)
    _assert_plain_selection(p.ww.shape[-1], xyz, idx)
    return out, idx


def _assert_plain_selection(k, xyz, idx):
    """``idx``, a self-kNN of ``xyz``, against ``knn_torch`` under
    ``check_knn``'s near-tie contract on at most 2,048 evenly spaced query
    rows a cloud (the plain version's rows of n distances fit at 60,000
    points)."""
    rows = slice(None, None, -(-xyz.shape[1] // 2048))
    _assert_knn_contract(k, xyz, xyz[:, rows].contiguous(), None,
                         ik=idx[:, rows])


def _selection_edge(case, dev):
    """(xyz, k) of one edge of the selection."""
    if case == "ties":  # a lattice (exact distances) with repeated points
        xyz = _lattice_cloud(5, 2, 3000, 3, span=6)
        xyz[:, 2000:] = xyz[:, :1000]
        return xyz.to(dev), 16
    if case == "inf":  # overflowed points: fewer finite distances than k
        xyz = _randn(7, 2, 40, 3)
        xyz[:, 10:] *= 1e20
        return xyz.to(dev), 16
    if case == "n=k":
        return _randn(8, 3, 16, 3).to(dev), 16
    # n past whole tiles of 128 and the block's 8 queries, k 12
    return _randn(9, 2, 2 * 1024 + 3 * 128 + 37, 3).to(dev), 12


@pytest.mark.parametrize("case", ["ties", "inf", "n=k", "ragged"])
def test_refine_block_selection_edges(dev, case):
    """refine_block at its selection's edges, its indices the plain
    selection's: exact ties and repeated points on a lattice (the plain
    stable sort's bits, the lower index first), +inf distances from
    overflowed inputs (the finite queries' 10 finite neighbours, then
    INT_MAX slots), n = k = 16, and n off whole tiles and off the block's
    8 queries, at k 12 (near-tie contract); the output within 1e-5 of the
    plain version fed those indices (an INT_MAX slot as the kernel groups
    it: [-q | 0 | 0])."""
    from dispu_tpu_torch.kernels.refine_block import (grouped_rows,
                                                      refine_block_cuda)
    from dispu_tpu_torch.kernels.refine_local import refine_local_torch

    xyz, k = _selection_edge(case, dev)
    b, n, _ = xyz.shape
    p = _local_params(3, dev, k, 6 + 24, (32, 32, 64))
    feats = _randn(10, b, n, 24).to(dev)
    out, idx = refine_block_cuda(xyz, feats, p, with_idx=True)
    miss = idx == 2 ** 31 - 1
    if case == "inf":
        assert bool(miss[:, :10, 10:].all()) and bool(
            (idx[:, :10, :10] < 10).all())
        _assert_knn_contract(10, xyz[:, :10], xyz[:, :10], None,
                             ik=idx[:, :10, :10])
    else:
        assert not bool(miss.any())
        _assert_plain_selection(k, xyz, idx)
    if case == "ties":
        assert torch.equal(idx, knn_torch(k, xyz, xyz)[1])
    g = grouped_rows(xyz, feats, torch.where(miss, 0, idx))
    empty = torch.cat([-xyz[:, :, None, :].expand(-1, -1, k, -1),
                       torch.zeros_like(g[..., 3:])], dim=-1)
    g = torch.where(miss[..., None], empty, g)
    rows = slice(0, 10) if case == "inf" else slice(None)  # finite queries
    want = refine_local_torch(g[:, rows], p)
    scale = max(float(want.abs().max()), 1.0)
    assert float((out[:, rows] - want).abs().max()) <= 1e-5 * scale


def test_upsample_of_60000_points(dev):
    """Past the 'row' regime's n: the patch cut takes the 'split' regime, the
    merge fps_chunked.cu's device-memory form; finite, the right shape,
    bit-equal on repeat."""
    pc = _randn(14, 60000, 3).numpy()
    up = PatchUpsampler(inf_cfg=InferenceConfig(patch_batch=64))
    kernels.reset_launch_counts()
    out = up.upsample(pc)
    counts = kernels.launch_counts()
    assert counts["knn_split"] == 1 and counts["fps_chunked"] == 2
    assert out.shape == (240000, 3) and np.isfinite(out).all()
    assert np.array_equal(out, up.upsample(pc))


def test_megafused_serves_past_its_kernels_limit(dev):
    """'megafused' at patch_num_point 512 and 16×: pass 2's refiner (8,192
    points, past the 5,195 that refine_block.cu's distance rows held
    before its selection became knn.cu's launch) runs in refine_block too;
    held to 'megafused''s 16× contract against the composed fast_gather
    path through the kernels."""
    inf = InferenceConfig(patch_num_point=512, final_ratio=16)
    pc = _randn(15, 2048, 3).numpy()
    up = PatchUpsampler(gen_cfg=GeneratorConfig(
        refine_local_impl="megafused"), inf_cfg=inf)
    kernels.reset_launch_counts()
    out = up.upsample(pc)
    counts = kernels.launch_counts()
    # 12 seeds, one chunk: refine_block at pass 1 and at pass 2, each
    # after knn.cu's selection
    assert counts["refine_block"] == 2 and counts["refine_local"] == 0
    assert out.shape == (32768, 3) and np.isfinite(out).all()
    ref = PatchUpsampler(gen_cfg=GeneratorConfig(fast_gather=True),
                         inf_cfg=inf).upsample(pc)
    assert _chamfer(out, ref) <= 1e-7


@pytest.mark.parametrize("setting,counts", [
    # 14 seeds → 2 chunks of 8 (refiner n = 512): 'fused' adds one
    # refine_local a chunk to the refiner's kNN, 'megafused' one
    # refine_block after the same exact kNN (its selection)
    ("fused", {"knn": 11, "refine_local": 2}),
    ("megafused", {"knn": 11, "refine_block": 2}),
])
def test_upsampler_goes_through_the_refine_kernels(dev, setting, counts):
    inf = InferenceConfig(patch_num_point=128, patch_batch=8)
    up = PatchUpsampler(gen_cfg=GeneratorConfig(
        refine_local_impl=setting, **SMALL), inf_cfg=inf)
    pc = _randn(0, 600, 3).numpy()
    kernels.reset_launch_counts()
    out = up.upsample(pc)
    assert kernels.launch_counts() == {
        "fps": 2, "fps_chunked": 0, "attention": 2, "query_ball": 0,
        **NO_TURBO, **counts}
    # 'megafused' takes the refiner's features rounded to bf16, as
    # fast_gather's composed refiner does (the backbone stays exact)
    ref_cfg = GeneratorConfig(fast_gather=setting == "megafused", **SMALL)
    ref = PatchUpsampler(gen_cfg=ref_cfg, inf_cfg=inf, impl="torch")
    assert out.shape == (2400, 3) and np.isfinite(out).all()
    assert _chamfer(out, ref.upsample(pc)) <= 1e-6
    x = torch.from_numpy(pc[None, :128]).to(dev)
    model = up.model
    for prm in model.parameters():
        prm.requires_grad_(True)
    # an eval-mode forward through a refine kernel cannot be differentiated
    with pytest.raises(RuntimeError, match="inference only"):
        model(x)[1].sum().backward()


def _surface_probe(verts, faces, n, seed):
    """n points on faces, n at vertices and n off the surface by 0.02."""
    rs = np.random.RandomState(seed)
    tri = verts[faces[rs.randint(len(faces), size=n)]].astype(np.float64)
    u, v = rs.rand(n, 1), rs.rand(n, 1)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    on_face = tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (
        tri[:, 2] - tri[:, 0])
    return np.concatenate([on_face, verts[rs.randint(len(verts), size=n)],
                           on_face + rs.randn(n, 3) * 0.02]).astype(
        np.float32)


def test_point_to_mesh_on_the_card_matches_the_cpu(dev):
    """The point-to-face scan on the card against the same code on the
    CPU (both plain torch; the sums of three products may round apart):
    distances within 1e-6, mapped points within 1e-6 where the faces are
    equal, and a face only swapped where the CPU's own distances to both
    faces are within 1e-6 (a shared edge); at a swap the mapped points lie
    within dc + dg + 1e-6 of each other.  More points than one block."""
    from dispu_tpu_torch.data.meshgen import make_corpus
    from dispu_tpu_torch.evaluation import metrics

    (_, (verts, faces)), = make_corpus(1, seed=7_777_777)
    points = _surface_probe(verts, faces, 1500, 0)
    assert len(points) > metrics.POINT_CHUNK
    dg, pg, fg = metrics.point_to_mesh_distance(points, verts, faces,
                                                return_faces=True)
    dc, pc_, fc = metrics.point_to_mesh_distance(points, verts, faces,
                                                 return_faces=True,
                                                 device="cpu")
    assert np.abs(dg - dc).max() <= 1e-6
    same = fg == fc
    assert np.abs(pg[same] - pc_[same]).max() <= 1e-6
    swap = np.nonzero(~same)[0]
    tri = torch.from_numpy(verts)[torch.from_numpy(faces).long()]
    p = torch.from_numpy(points[swap])

    def to_face(face_idx):
        t = tri[torch.from_numpy(face_idx).long()]
        return torch.sqrt(metrics._point_triangle_sq_dist(
            p, t[:, 0], t[:, 1], t[:, 2])[0]).numpy()

    assert (np.abs(to_face(fg[swap]) - to_face(fc[swap])) <= 1e-6).all()
    assert (np.linalg.norm(pg[swap] - pc_[swap], axis=1)
            <= dg[swap] + dc[swap] + 1e-6).all()


@pytest.mark.parametrize("n_pred,n_gt,launches", [
    (8192, 2048, 1), (32768, 2048, 1), (8192, 8192, 0)])
def test_cd_hd_kernel_argmin_matches_plain(dev, n_pred, n_gt, launches):
    """``cd_hd`` on the card: the pred → gt argmin is the kNN kernel at
    k = 1 where gt has 64 to 4096 points (one launch; gt → pred never,
    its dataset is past 4096), the plain argmin otherwise; CD and HD
    within 1e-5 relative of the plain argmin's (near-tie swaps move a
    mean or a max by the expansion's round-off)."""
    from dispu_tpu_torch.evaluation.metrics import cd_hd

    pred = _randn(n_pred, n_pred, 3).to(dev)
    gt = _randn(n_gt + 1, n_gt, 3).to(dev)
    kernels.reset_launch_counts()
    got = [float(x) for x in cd_hd(pred, gt)]
    assert kernels.launch_counts()["knn"] == launches
    want = [float(x) for x in cd_hd(pred, gt, impl="torch")]
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------ custom ops and serving


def _on(dev, arg):
    if isinstance(arg, torch.Tensor):
        return arg.to(dev)
    if isinstance(arg, list):
        return [t.to(dev) for t in arg]
    return arg


def _op_cases():
    from test_torch_ops import CASES

    return CASES


@pytest.mark.parametrize("name,args", [c[1:] for c in _op_cases()],
                         ids=[c[0] for c in _op_cases()])
def test_op_passes_opcheck_on_the_card(dev, name, args):
    """Every ``opcheck`` check succeeds on CUDA tensors, and the op's CUDA
    form is the hand-written kernel: it counts launches, and its result is
    bit-equal to the kernel's wrapper called directly."""
    op = getattr(torch.ops.dispu_tpu_torch, name).default
    args = [_on(dev, a) for a in args]
    kernels.reset_launch_counts()
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    if name == "duplicate_rows":  # plain torch on every device
        from dispu_tpu_torch.kernels.knn import duplicate_rows_torch

        assert torch.equal(op(*args), duplicate_rows_torch(*args))
        return
    assert kernels.launch_counts()[name] > 0
    kernels.reset_launch_counts()
    got = op(*args)
    assert kernels.launch_counts()[name] == 1
    from dispu_tpu_torch.kernels import (attention, fps, fps_bucketed,
                                         fps_chunked, knn, knn_group,
                                         refine_block, refine_local)

    direct = {"knn": knn.knn_kernel_cuda, "knn_packed": knn.knn_packed_cuda,
              "knn_group": knn_group.knn_group_op_cuda, "fps": fps.fps_cuda,
              "fps_chunked": fps_chunked.fps_chunked_cuda,
              "fps_bucketed": fps_bucketed.fps_bucketed_cuda,
              "attention": attention.attention_cuda,
              "refine_local": refine_local.refine_local_op_cuda,
              "refine_block": refine_block.refine_block_op_cuda}[name]
    want = direct(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_served_entry_on_the_card_is_bit_equal_to_live(dev, tmp_path):
    """A 4× entry exported on the card and loaded back returns the live
    ``upsample``'s bits through the same kernel launches."""
    from dispu_tpu_torch.serving import ServedUpsampler, export_upsampler

    inf = InferenceConfig(patch_num_point=128, patch_batch=8)
    up = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL), inf_cfg=inf)
    manifest = export_upsampler(up.model.state_dict(), [600], str(tmp_path),
                                gen_cfg=up.gen_cfg, inf_cfg=inf)
    assert manifest["entries"][0]["device"] == "cuda"
    assert manifest["entries"][0]["kernels"] == ["attention", "fps", "knn"]
    served = ServedUpsampler(str(tmp_path))
    served.warmup()
    pc = _randn(0, 600, 3).numpy()
    kernels.reset_launch_counts()
    want = up.upsample(pc)
    live_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    got = served.upsample(pc)
    assert kernels.launch_counts() == live_counts
    assert live_counts["knn"] == 11 and live_counts["attention"] == 2
    np.testing.assert_array_equal(got, want)
