"""The port past two kernels' limits, on the CPU: the exact kNN's radix
form (its two regimes and their launch plan) and the mega-fused refiner's
route past its shared memory, whose
decisions are made in Python from shapes alone, the scatter's choice of
its index build's route and the size of its scratch, and the ball
query's scalar radius squared on the host.  The kernels themselves run on the
card (``tests/test_torch_cuda.py``); here their wrappers are replaced by
stand-ins that record which one a call reaches.
"""

import types

import numpy as np
import pytest
import torch

from dispu_tpu_torch.kernels import knn as knn_module
from dispu_tpu_torch.kernels.gather_rows import (BUILD_SMEM, SCATTER_MAX_N,
                                                 build_max_n, build_warps,
                                                 scratch_ints)
from dispu_tpu_torch.kernels.knn import (MAX_ROW_FLOATS, MAX_STREAM_K,
                                         RADIX_CAP, RADIX_HEAD_WORDS,
                                         RADIX_ROW_FLOATS, RADIX_ROW_POINTS,
                                         RADIX_SPLIT_ROWS, KnnFunction,
                                         RadixPlan, knn_form, knn_torch,
                                         radix_plan, radix_smem,
                                         radix_threads)
from dispu_tpu_torch.kernels.query_ball import host_radius_sq, radius_sq
from dispu_tpu_torch.kernels.refine_block import (block_fits, block_smem,
                                                  refine_block_torch)
from dispu_tpu_torch.kernels.refine_local import tile_queries
from dispu_tpu_torch.nn.refine import PointShuffle2

torch.set_num_threads(1)

#: the refiner's grouped width and mlp at ``GeneratorConfig()``: 128
#: features, [p - q | p | f]
CF, MLP = 6 + 128, (128, 128, 256)
#: c2 = 256: the tile's h1 and the pools pass a block's shared memory
WIDE = (128, 256, 256)


# ------------------------------------------------- the scatter's two routes

@pytest.mark.parametrize("n,q,warps", [
    # the train step's shapes: 32 warps
    (256, 4096, 32), (1024, 16384, 32),
    # a count a (warp, row) and the perm: 4 (wn + q) <= BUILD_SMEM
    (1, 1, 32), (1, 58016, 32), (1, 58017, 16), (1537, 8864, 32),
    (1537, 8865, 16), (1, 58044, 4), (1, 58045, 0), (1813, 32, 32),
    (1814, 32, 16),
    (build_max_n(30000), 30000, 4), (build_max_n(30000) + 1, 30000, 0),
    (SCATTER_MAX_N, 1, 0),
])
def test_scatter_build_warps_steps_with_n_and_q(n, q, warps):
    """The one-launch index build keeps a count a warp and row and the
    cloud's perm in a block's shared memory: the most of 32, 16, 8 and 4
    warps that fit, else the multi-pass route."""
    assert build_warps(n, q) == warps
    assert 4 * (warps * n + q) <= BUILD_SMEM or warps == 0


def test_scatter_index_builds_largest_cloud():
    assert build_max_n(30000) == 7012
    assert build_max_n(16384) == 10416 and build_max_n(58045) == 0
    for q in (1, 4096, 16384, 30000, 58044):
        n = build_max_n(q)
        assert build_warps(n, q) == 4 and build_warps(n + 1, q) == 0


@pytest.mark.parametrize("b,n,q,ints", [
    # rowptr b(n + 1) and perm bq
    (28, 256, 4096, 28 * 257 + 28 * 4096),
    (28, 1024, 16384, 28 * 1025 + 28 * 16384),
    # past the build: and the counts, b * ceil(q / 1024) * n
    (2, 20000, 3000, 2 * 20001 + 2 * 3000 + 2 * 3 * 20000),
    (1, 7013, 30000, 7014 + 30000 + 30 * 7013),
])
def test_scatter_scratch_holds_each_routes_arrays(b, n, q, ints):
    assert scratch_ints(b, n, q) == ints


# ------------------------------------------------- the radix form's regimes

@pytest.mark.parametrize("k,n,c,form", [
    (1, 10**6, 3, "tiled"), (MAX_STREAM_K, 10**6, 3, "tiled"),
    (MAX_STREAM_K + 1, RADIX_ROW_POINTS, 3, "row"),
    (MAX_STREAM_K + 1, RADIX_ROW_POINTS + 1, 3, "split"),
    (256, 2048, 3, "row"), (512, 2048, 3, "row"), (48, 256, 24, "row"),
    (256, 60000, 3, "split"), (256, 20000, 3, "split"),
    # the row and the query must fit shared memory beside the head
    (100, 1000, RADIX_ROW_FLOATS - 1000, "row"),
    (100, 1000, RADIX_ROW_FLOATS - 999, "split"),
])
def test_knn_form_is_a_shape_gate(k, n, c, form):
    assert knn_form(k, n, c) == form


def test_radix_row_limit_leaves_the_head_beside_the_row():
    # 256 histogram bins and 16 control words ahead of the query and row
    assert RADIX_HEAD_WORDS == 272
    assert RADIX_ROW_FLOATS == 57840 == MAX_ROW_FLOATS - 272
    assert radix_smem(33, RADIX_ROW_FLOATS - 3, 3) == (232448, False)
    assert radix_smem(33, RADIX_ROW_FLOATS - 2, 3) == (0, False)


@pytest.mark.parametrize("k,n,c,rows,form,plan", [
    # the patch cut: 512 threads, the row, the query and 256 pairs
    (256, 2048, 3, 24, None, RadixPlan("row", 512,
                                       4 * (272 + 3 + 2048 + 512), True, 0)),
    # 'megafused' at patch 512
    (512, 2048, 3, 12, None, RadixPlan("row", 512,
                                       4 * (272 + 3 + 2048 + 1024), True,
                                       0)),
    # the GCN backbone's k 48 graph: two warps a row
    (48, 256, 24, 28 * 256, None, RadixPlan("row", 64,
                                            4 * (272 + 24 + 256 + 96), True,
                                            0)),
    (33, 100, 3, 7, None, RadixPlan("row", 32, 4 * (272 + 3 + 100 + 66),
                                    True, 0)),
    (100, 4096, 48, 2, None, RadixPlan("row", 1024,
                                       4 * (272 + 48 + 4096 + 200), True,
                                       0)),
    # k = n: the pairs no longer fit beside the row and sort in place in
    # the output rows
    (20000, 20000, 3, 7, "row", RadixPlan("row", 1024, 4 * (272 + 3 + 20000),
                                          False, 0)),
    # past 4,096 points: the buffer of 4,096 pairs instead, at any n; 512
    # threads where the rows fill the card
    (256, 60000, 3, 703, None, RadixPlan("split", 512,
                                         4 * (272 + 3 + 2 * 4096 + 512),
                                         True, 4096)),
    (256, 2_000_000, 3, 100, None, RadixPlan("split", 1024,
                                             4 * (272 + 3 + 2 * 4096 + 512),
                                             True, 4096)),
    (60000, 60000, 3, 7, None, RadixPlan("split", 1024,
                                         4 * (272 + 3 + 2 * 4096), False,
                                         4096)),
])
def test_radix_plan_sizes_the_block_and_its_shared_memory(k, n, c, rows,
                                                          form, plan):
    assert radix_plan(k, n, c, rows, form) == plan
    assert plan.smem <= 4 * MAX_ROW_FLOATS


@pytest.mark.parametrize("n,threads", [
    (1, 32), (128, 32), (129, 64), (256, 64), (2048, 512), (2049, 1024),
    (50000, 1024),
])
def test_radix_threads_near_a_quarter_of_the_row(n, threads):
    assert radix_threads(n, "row", 24) == threads


@pytest.mark.parametrize("rows,threads", [
    (1, 1024), (RADIX_SPLIT_ROWS - 1, 1024), (RADIX_SPLIT_ROWS, 512),
    (703, 512),
])
def test_radix_split_threads_halve_where_the_rows_fill_the_card(rows,
                                                                threads):
    assert RADIX_SPLIT_ROWS == 264
    assert radix_threads(60000, "split", rows) == threads


def test_radix_plan_forced_split_and_its_cap():
    # the 'split' regime runs where 'row' does too (the card's tests hold
    # their bits equal there); a smaller buffer forces more passes
    assert radix_plan(256, 20000, 3, 236, "split") == RadixPlan(
        "split", 1024, 4 * (272 + 3 + 2 * RADIX_CAP + 512), True, RADIX_CAP)
    assert radix_plan(100, 20000, 3, 236, "split", cap=1) == RadixPlan(
        "split", 1024, 4 * (272 + 3 + 2 + 200), True, 1)
    with pytest.raises(ValueError, match="cap"):
        radix_plan(100, 20000, 3, 236, "split", cap=0)


def test_radix_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        radix_plan(33, RADIX_ROW_FLOATS - 2, 3, 1, "row")
    # the query itself must fit beside the buffer
    with pytest.raises(ValueError, match="shared memory"):
        radix_plan(33, 100, MAX_ROW_FLOATS, 1, "split")
    with pytest.raises(ValueError, match="regime"):
        radix_plan(16, 100, 3, 1)


def _stand_ins(monkeypatch):
    """Replace both exact kernels' wrappers with recorders that return
    zeros of the right shape; returns the list of calls."""
    calls = []

    def make(name):
        def run(k, points, queries, bias=None):
            calls.append((name, k, points.shape[1]))
            b, m = queries.shape[:2]
            return (torch.zeros((b, m, k)),
                    torch.zeros((b, m, k), dtype=torch.int32))
        return run

    monkeypatch.setattr(knn_module, "knn_cuda", make("knn_cuda"))
    monkeypatch.setattr(knn_module, "knn_split_cuda", make("knn_split_cuda"))
    return calls


@pytest.mark.parametrize("k,n,wrapper", [
    (256, 2048, "knn_cuda"), (256, 4096, "knn_cuda"),
    (256, 4097, "knn_split_cuda"), (256, 60000, "knn_split_cuda"),
    (MAX_STREAM_K, 60000, "knn_cuda"),
])
def test_kernel_route_takes_the_split_form_exactly_past_the_row_form(
        monkeypatch, k, n, wrapper):
    """What ``KnnFunction`` runs for a CUDA tensor (``use_cuda``), with
    both wrappers replaced by stand-ins: the 'split' regime exactly past
    :data:`RADIX_ROW_POINTS`, the tiled form at any n for k <= 32."""
    calls = _stand_ins(monkeypatch)
    pts = torch.zeros((1, n, 3))
    dists, idx = KnnFunction.apply(k, pts, pts[:, :5], None, True)
    assert calls == [(wrapper, k, n)]
    assert dists.shape == idx.shape == (1, 5, k)


def test_packed_route_never_takes_the_split_form(monkeypatch):
    calls = _stand_ins(monkeypatch)
    seen = []
    monkeypatch.setattr(knn_module, "knn_packed_cuda",
                        lambda k, p, q, b=None: seen.append(k) or (
                            torch.zeros(1, 5, k),
                            torch.zeros(1, 5, k, dtype=torch.int32)))
    pts = torch.zeros((1, 60000, 3))
    KnnFunction.apply(16, pts, pts[:, :5], None, True, True)
    assert seen == [16] and calls == []


def test_split_form_on_cpu_tensors_is_refused():
    pts = torch.zeros((1, 300, 3))
    with pytest.raises(ValueError, match="CUDA"):
        knn_module.knn_split_cuda(40, pts, pts[:, :4])
    # on the CPU the plain version takes every n
    d, i = knn_module.knn(40, pts, pts[:, :4])
    assert torch.equal(i, knn_torch(40, pts, pts[:, :4])[1])


# ------------------------------------------- 'megafused' past its kernel

def test_block_predicate_at_the_kernels_limit():
    """The Python formula of ``dispu_refine_block_smem``: n has left it
    (the selection is knn.cu's launch), so 5,195, 5,196, 8,192 and 60,000
    points all take the kernel at the default width; a width whose tile
    and pools pass 232,448 bytes does not, nor k = 17."""
    assert tile_queries(16) == 8
    assert block_smem(16, CF, *MLP, 8) == 222512
    assert block_fits(16, CF, *MLP)
    for n in (5195, 5196, 8192, 60000):
        assert _layer().local_route(_on_card(n)) == "megafused"
    assert not block_fits(17, CF, *MLP)  # refine_block_pallas: k <= 16
    assert block_smem(16, CF, *WIDE, 8) == 0
    assert not block_fits(16, CF, *WIDE)
    # fewer neighbours shrink tile_mlp's regions, not phase A's fixed one
    assert block_smem(8, CF, *MLP, 8) == 146480
    assert block_fits(8, CF, *MLP)


def _layer(gather_impl="onehot_hp", impl="auto", local_impl="megafused",
           mlp=MLP):
    torch.manual_seed(0)
    return PointShuffle2(128, nsample=16, mlp=mlp, gather_impl=gather_impl,
                         impl=impl, local_impl=local_impl).eval()


def _on_card(n, c=128):
    """A stand-in for a CUDA feature tensor: what the route reads."""
    return types.SimpleNamespace(shape=(2, n, c), dtype=torch.float32,
                                 is_cuda=True)


@pytest.mark.parametrize("n,gather_impl,mlp,route,grouping", [
    (5196, "onehot_hp", MLP, "megafused", ("onehot_hp", "auto")),
    (8192, "onehot_hp", MLP, "megafused", ("onehot_hp", "auto")),
    (5196, "onehot_hp", WIDE, "xla", ("onehot", "auto")),
    (8192, "fused", WIDE, "fused", ("fused_turbo", "auto")),
    (8192, "onehot", WIDE, "fused", ("onehot", "auto")),
])
def test_megafused_route_past_the_kernels_limit(n, gather_impl, mlp, route,
                                                grouping):
    """'megafused' on the card at any n at the default width; past the
    kernel's shared memory in width alone, 'fused' (n % 128 == 0) or
    'xla', grouping as the kernel does."""
    layer = _layer(gather_impl, mlp=mlp)
    assert layer._routes(_on_card(n)) == (route, grouping)
    assert layer.local_route(_on_card(n)) == route


def test_megafused_route_on_the_cpu_is_unchanged():
    """The plain versions take any n, so the CPU and impl='torch' keep
    'megafused' (and JAX parity); 'fused' keeps its own gate."""
    feat = torch.zeros((1, 8192, 128))
    assert _layer().local_route(feat) == "megafused"
    assert _layer(impl="torch").local_route(_on_card(8192)) == "megafused"
    assert _layer(local_impl="fused").local_route(_on_card(8192)) == "fused"
    assert _layer(local_impl="fused").local_route(_on_card(8000)) == "xla"
    assert _layer().train().local_route(_on_card(100)) == "xla"


@pytest.mark.parametrize("route,grouping", [
    ("fused", ("onehot", "auto")), ("xla", ("onehot", "auto"))])
def test_megafused_fallback_computes_the_same_function(monkeypatch, route,
                                                       grouping):
    """The routes past the kernel's limit group as ``refine_block`` does
    (exact kNN, features rounded to bf16), so the layer's output is the
    mega-fused one: bit-equal by 'fused' (the same grouped rows into the
    same plain local branch), to f32 round-off by the composed branch."""
    layer = _layer()
    rng = np.random.RandomState(3)
    xyz = torch.from_numpy(rng.randn(2, 256, 3).astype(np.float32))
    feat = torch.from_numpy(rng.randn(2, 256, 128).astype(np.float32))
    with torch.no_grad():
        want = layer(xyz, feat)[1]
        block = refine_block_torch(xyz, feat, layer.local_params())
        monkeypatch.setattr(layer, "_routes",
                            lambda feature: (route, grouping))
        got = layer(xyz, feat)[1]
    if route == "fused":
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert block.shape == (2, 256, MLP[-1])


# ------------------------------------------- the ball query's scalar radius

RADII = [0.07, 0.2, 0.4, 1.0, 2, 3, 1e-3, 1e-20, 1e-23, 1e19, 1e20,
         np.float32(0.3), np.float64(0.0632455532), np.int64(2),
         np.array(0.5), *np.logspace(-6, 3, 97)]


@pytest.mark.parametrize("radius", RADII, ids=lambda r: repr(r)[:24])
def test_host_radius_sq_bit_equal_to_radius_sq(radius):
    """r² squared in f32 on the host and passed by value has the bits of
    the (b,) tensor the plain version and a tensor radius use."""
    got = np.float32(host_radius_sq(radius))
    want = radius_sq(radius, 3, "cpu")
    assert torch.equal(torch.from_numpy(np.full(3, got)).view(torch.int32),
                       want.view(torch.int32))


def test_host_radius_sq_leaves_tensors_and_arrays_to_the_device():
    assert host_radius_sq(torch.tensor(0.1)) is None
    assert host_radius_sq(torch.tensor([0.1, 0.2])) is None
    assert host_radius_sq(np.array([0.1, 0.2])) is None
