"""The port's turbo serving path (``dispu.py --turbo``) against the JAX
package, on the CPU: the packed kNN selection, the fused kNN + gather,
the bf16 gathers, the part-split dense block, the bucketed merge, the
whole turbo generator and upsampler, and the CLI twin of ``dispu.py``.

Where the JAX function reaches a Pallas kernel it runs in interpret mode,
as tests/test_pallas.py runs it; off the TPU its turbo modules take their
composed paths (exact kNN, bf16 one-hot gathers), which the port's plain
versions compute too.  Inputs are made with numpy and handed to both.
"""

import dataclasses
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import InferenceConfig as JInferenceConfig
from dispu_tpu.inference import PatchUpsampler as JPatchUpsampler
from dispu_tpu.models.generator import DisPUGenerator as JDisPUGenerator
from dispu_tpu.nn import edgeconv as jedgeconv
from dispu_tpu.ops.geometry import normalize_point_cloud as jnormalize
from dispu_tpu.ops.pallas_kernels import (fps_bucketed_pallas,
                                          knn_group_pallas, knn_pallas)
from dispu_tpu_torch import cli, kernels
from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig
from dispu_tpu_torch.convert import from_flax_variables
from dispu_tpu_torch.inference import PatchUpsampler, plan_counts
from dispu_tpu_torch.kernels.fps_bucketed import fps_bucketed_torch
from dispu_tpu_torch.kernels.knn import (knn_packed_torch, knn_torch,
                                         packed_lane_bits)
from dispu_tpu_torch.kernels.knn_group import knn_group_torch
from dispu_tpu_torch.models.generator import DisPUGenerator
from dispu_tpu_torch.nn import edgeconv as tedgeconv
from dispu_tpu_torch.ops import grouping as tgrouping
from dispu_tpu_torch.ops import sampling as tsampling
from test_torch_generator import perturbed_numpy_tree
from test_torch_modules import _compare, _inputs

# the package's functions shadow their modules of the same names
jknn = importlib.import_module("dispu_tpu.ops.knn")
jgrouping = importlib.import_module("dispu_tpu.ops.grouping")
jsampling = importlib.import_module("dispu_tpu.ops.sampling")

torch.set_num_threads(1)

SMALL = dict(num_points=64, knn=8, refine_nsample=8)
INF = dict(patch_num_point=64, patch_batch=4)
TURBO = dict(fast_knn=True, fast_gather=True, fast_gather_backbone=True,
             fused_grouping=True, dense_impl="split")


def _cloud(seed, shape, n_dup=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    if n_dup:  # the last rows copy the first ones
        x[:, -n_dup:] = x[:, :n_dup]
    return x


def _trunc(d, lb):
    """Distances with their low ``lb`` bits cleared (the packed keys'
    distance part)."""
    bits = np.ascontiguousarray(d, np.float32).view(np.int32)
    return (bits & np.int32(~((1 << lb) - 1))).view(np.float32)


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


# ----------------------------------------------------------- packed kNN


@pytest.mark.parametrize("b,n,m,c,k,n_dup", [
    (2, 256, 256, 3, 16, 0),     # a refiner's self-kNN
    (2, 300, 120, 3, 9, 0),      # n_pad 384: 9 lane bits
    (2, 200, 200, 24, 17, 6),    # a backbone's, duplicates biased by 1e30
    (1, 1024, 256, 3, 16, 0),    # 10 lane bits
])
def test_knn_packed_plain_matches_pallas_packed(b, n, m, c, k, n_dup):
    """The packed plain version against ``knn_pallas(variant='packed')``.
    Contract (bench.py's guard): the distances are the exact distances
    truncated, rank by rank, bit for bit; indices move only at truncation
    ties.  Where the two packages' exact distance rows are bit-equal the
    packed results are bit-equal too."""
    x = _cloud(n + k, (b, n, c), n_dup)
    q = x[:, :m] if m <= n else _cloud(m, (b, m, c))
    q = np.ascontiguousarray(q)
    bias = None
    if n_dup:
        bias = np.asarray(jknn.mask_duplicate_rows(jnp.asarray(x)),
                          np.float32) * np.float32(1e30)
    tb = None if bias is None else torch.from_numpy(bias)
    jb = None if bias is None else jnp.asarray(bias)
    lb = packed_lane_bits(n)
    assert lb == max(1, (-(-max(n, 128) // 128) * 128 - 1).bit_length())
    td, ti = (t.numpy() for t in knn_packed_torch(
        k, torch.from_numpy(x), torch.from_numpy(q), tb))
    jd, ji = (np.asarray(t) for t in knn_pallas(
        k, jnp.asarray(x), jnp.asarray(q), jb, interpret=True,
        variant="packed"))
    ed, ei = (t.numpy() for t in knn_torch(
        k + 1, torch.from_numpy(x), torch.from_numpy(q), tb))
    jed, _ = (np.asarray(t) for t in knn_pallas(
        k + 1, jnp.asarray(x), jnp.asarray(q), jb, interpret=True))
    # the port's packed against its own exact selection: bench.py:57-79
    te = _trunc(ed, lb)
    np.testing.assert_array_equal(td, te[..., :k])
    tie = te[..., :k] == te[..., 1:]
    tie[..., 1:] |= te[..., 1:k] == te[..., :k - 1]
    assert np.all((ti == ei[..., :k]) | tie)
    # against the JAX package's packed kernel: its distances are its own
    # exact ones truncated; rows whose exact distances are bit-equal in the
    # two packages (at c = 3 nearly all; at c = 24 the sum orders differ in
    # the last bit) give bit-equal packed rows
    jte = _trunc(jed, lb)
    np.testing.assert_array_equal(jte[..., :k], jd)
    same_rows = np.all(ed == jed, axis=-1)
    assert same_rows.mean() >= (0.9 if c == 3 else 0.0)
    np.testing.assert_array_equal(td[same_rows], jd[same_rows])
    np.testing.assert_array_equal(ti[same_rows], ji[same_rows])
    # elsewhere the truncated distances agree within one truncation step
    # (the expansion's cancellation scales with |q|² + |p|², as in
    # test_torch_kernels), and indices move only at a truncation tie of
    # either package
    step = 2.0 ** -(23 - lb)
    scale = 2.0 * float(np.max(np.sum(x * x, axis=-1)))
    np.testing.assert_allclose(td, jd, rtol=2 * step, atol=1e-6 * scale)
    jtie = jte[..., :k] == jte[..., 1:]
    jtie[..., 1:] |= jte[..., 1:k] == jte[..., :k - 1]
    assert np.all((ti == ji) | tie | jtie)


# ------------------------------------------------------- fused kNN + gather


# (points are the kNN keys: xyz with with_xyz, else the features
# themselves, as the backbone's self-kNN; drop_first with the duplicate
# bias is the backbone's edge gather)
MODES = {
    "refiner": dict(with_xyz=True, drop_first=False, dup=False),
    "xyz_drop_dup": dict(with_xyz=True, drop_first=True, dup=True),
    "backbone": dict(with_xyz=False, drop_first=True, dup=True),
    "feats_only": dict(with_xyz=False, drop_first=False, dup=False),
}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "turbo"])
@pytest.mark.parametrize("mode", list(MODES))
def test_knn_group_plain_matches_pallas(mode, exact):
    """``knn_group_torch`` against ``knn_group_pallas(interpret=True)``:
    indices equal, as the exact kNN's tests hold them; distances to the
    kNN tests' bound; the gathered rows bit-equal (exact, or rounded to
    bf16 in turbo mode) and bit-equal to the rows at the returned
    indices; xyz always exact."""
    cfg = MODES[mode]
    b, n, k = 2, 96, 8
    feats = _cloud(1, (b, n, 20 if cfg["with_xyz"] else 12), 5)
    pts = _cloud(2, (b, n, 3), 5) if cfg["with_xyz"] else feats
    q = pts if cfg["drop_first"] else np.ascontiguousarray(pts[:, ::3])
    bias = None
    if cfg["dup"]:
        bias = np.asarray(jknn.mask_duplicate_rows(jnp.asarray(pts)),
                          np.float32) * np.float32(1e30)
        assert (bias > 0).sum() == b * 5
    t_args = [torch.from_numpy(a) if a is not None else None
              for a in (pts, q, feats, bias)]
    td, ti, tx, tf = knn_group_torch(k, *t_args, exact=exact,
                                     with_xyz=cfg["with_xyz"],
                                     drop_first=cfg["drop_first"])
    jd, ji, jx, jf = knn_group_pallas(
        k, *(None if a is None else jnp.asarray(a) for a in
             (pts, q, feats, bias)),
        interpret=True, exact=exact, with_xyz=cfg["with_xyz"],
        drop_first=cfg["drop_first"])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    scale = 2.0 * float(np.max(np.sum(pts * pts, axis=-1)))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6 * scale)
    rows = np.stack([feats[v][ti[v].numpy()] for v in range(b)])
    want = rows if exact else _bf16(rows)
    np.testing.assert_array_equal(tf.numpy(), want)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    if cfg["with_xyz"]:
        xyz = np.stack([pts[v][ti[v].numpy()] for v in range(b)])
        np.testing.assert_array_equal(tx.numpy(), xyz)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    else:
        assert tx is None and jx is None
    # the same (dists, idx) as the kNN of k (+ 1) with the column dropped
    kd, ki = knn_torch(k + cfg["drop_first"], t_args[0], t_args[1], t_args[3])
    off = int(cfg["drop_first"])
    assert torch.equal(ti, ki[..., off:]) and torch.equal(td, kd[..., off:])


@pytest.mark.parametrize("gather_impl", ["fused", "fused_turbo"])
def test_edge_parts_fused_matches_jax_composed(gather_impl):
    """The backbone's fused edge gather (knn_group with drop_first and the
    1e30 duplicate bias) against the JAX package's CPU path for the same
    setting, its composed 'onehot_hp' / 'onehot' fallback (per-batch max
    bias): the same neighbours, the gathered rows bit-equal."""
    feat = _cloud(3, (2, 80, 24), 6)
    _, tn, ti = tedgeconv.edge_parts(torch.from_numpy(feat), 8,
                                     gather_impl=gather_impl)
    _, jn, ji = jedgeconv.edge_parts(jnp.asarray(feat), 8,
                                     gather_impl=gather_impl)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("gather_impl,knn_variant", [
    ("fused", "auto"), ("fused_turbo", "packed"), ("onehot", "auto"),
])
def test_grouping_turbo_matches_jax_composed(gather_impl, knn_variant):
    """The refiner's grouping in the turbo gathers against the JAX
    package's CPU path (composed, exact kNN): indices equal, xyz exact,
    features bit-equal (bf16-rounded in the turbo modes)."""
    xyz = _cloud(4, (2, 128, 3))
    feat = _cloud(5, (2, 128, 16))
    got = tgrouping.grouping(torch.from_numpy(feat), 8, torch.from_numpy(xyz),
                             torch.from_numpy(xyz), gather_impl=gather_impl,
                             knn_variant=knn_variant)
    want = jgrouping.grouping(jnp.asarray(feat), 8, jnp.asarray(xyz),
                              jnp.asarray(xyz), gather_impl=gather_impl,
                              knn_variant=knn_variant)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_group_point_onehot_matches_jax():
    pts = _cloud(6, (2, 50, 7)) * np.float32(3.7)
    idx = np.random.RandomState(0).randint(0, 50, (2, 30, 5)).astype(np.int32)
    got = tgrouping.group_point(torch.from_numpy(pts), torch.from_numpy(idx),
                                gather_impl="onehot").numpy()
    want = np.asarray(jgrouping.group_point(jnp.asarray(pts),
                                            jnp.asarray(idx), impl="onehot"))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.stack([pts[v][idx[v]]
                                             for v in range(2)]))


# ------------------------------------------------------------ bucketed FPS


@pytest.mark.parametrize("n", [1000, 97, 4096])
def test_morton_codes_match_jax(n):
    x = _cloud(n, (2, n, 3))
    x[0, n // 2:n // 2 + 5] = x[0, :5]  # equal codes
    x[1] = x[1] * np.float32(1e-3) + np.float32(5.0)  # a small, offset box
    got = tsampling.morton_codes(torch.from_numpy(x)).numpy()
    for v in range(2):
        np.testing.assert_array_equal(
            got[v], np.asarray(jsampling.morton_codes(jnp.asarray(x[v]))))
    assert got.dtype == np.int32 and len(np.unique(got[0])) > n // 2


@pytest.mark.parametrize("K,nb,mb", [(8, 100, 20), (4, 130, 40), (3, 7, 7)])
def test_fps_bucketed_plain_matches_pallas(K, nb, mb):
    """Per bucket the plain version is ``fps_bucketed_pallas`` (which
    edge-pads n_b to 128 lanes) bit for bit."""
    x = _cloud(K * nb, (K, nb, 3), 4)
    got = fps_bucketed_torch(mb, torch.from_numpy(x)).numpy()
    want = np.asarray(fps_bucketed_pallas(mb, jnp.asarray(x), interpret=True))
    assert got.dtype == np.int32 and got.shape == (K, mb)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,npoint,K", [
    (1000, 300, 16),   # n_b = 63, padded by the last-ranked point
    (512, 512, 64),    # every point: n_b = m_b = 8
    (2048, 500, 64),   # ceil(500 / 64) = 8 a bucket, cut to 500
])
def test_farthest_point_sample_bucketed_matches_jax(n, npoint, K):
    """B = 2 clouds in one call against the JAX package's one-cloud
    function on each: bit-equal."""
    x = _cloud(n + K, (2, n, 3), 9)
    got = tsampling.farthest_point_sample_bucketed(
        npoint, torch.from_numpy(x), n_buckets=K).numpy()
    assert got.shape == (2, npoint) and got.dtype == np.int32
    for v in range(2):
        want = np.asarray(jsampling.farthest_point_sample_bucketed(
            npoint, jnp.asarray(x[v]), n_buckets=K))
        np.testing.assert_array_equal(got[v], want)


def test_bucketed_radix_rank_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tsampling.farthest_point_sample_bucketed(
            64, torch.zeros((1, 256, 3)), rank_impl="radix")


# ------------------------------------------------- modules and generator


@pytest.mark.parametrize("use_bn", [False, True])
@pytest.mark.parametrize("gather_impl", ["gather", "fused_turbo"])
def test_dense_edge_block_split_matches_flax(gather_impl, use_bn):
    """The part-split block (``dense_impl='split'``) against flax's, to f32
    round-off (``ATOL`` of test_torch_modules): the same parameters, the
    JAX term order.  With 'fused_turbo' the port runs knn_group's plain
    version at n = 64 and the JAX package its CPU fallback."""
    _compare(jedgeconv.DenseEdgeBlock(8, n=3, k=6, use_bn=use_bn,
                                      gather_impl=gather_impl,
                                      dense_impl="split"),
             tedgeconv.DenseEdgeBlock(12, 8, n=3, k=6, use_bn=use_bn,
                                      gather_impl=gather_impl,
                                      dense_impl="split"),
             _inputs(6, (2, 64, 12), n_dup=3))


def test_split_and_concat_blocks_share_parameters():
    """One flax tree loads into both forms, which then agree to f32
    round-off; the port's seeded init gives both the same weights."""
    cat = tedgeconv.DenseEdgeBlock(12, 8, n=3, k=6)
    split = tedgeconv.DenseEdgeBlock(12, 8, n=3, k=6, dense_impl="split")
    split.load_state_dict(cat.state_dict())
    x = torch.from_numpy(_inputs(1, (2, 40, 12), n_dup=2)[0])
    with torch.inference_mode():
        a, ia = cat(x)
        b, ib = split(x)
    assert torch.equal(ia, ib)
    assert float((a - b).abs().max()) <= 1e-5
    g1 = DisPUGenerator(GeneratorConfig(**SMALL), seed=3).state_dict()
    g2 = DisPUGenerator(GeneratorConfig(**SMALL, **TURBO), seed=3).state_dict()
    assert list(g1) == list(g2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


def _gen_pair(cfg_kw, b, n, seed):
    jcfg = JGeneratorConfig(**cfg_kw)
    jmodel = JDisPUGenerator(cfg=jcfg)
    x = np.random.RandomState(seed).randn(b, n, 3).astype(np.float32)
    variables = perturbed_numpy_tree(
        jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False),
        seed)
    tmodel = DisPUGenerator(GeneratorConfig(**cfg_kw))
    from_flax_variables(tmodel, variables)
    jc, jf = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        tc, tf = tmodel(torch.from_numpy(x))
    return (np.asarray(jc), np.asarray(jf)), (tc.numpy(), tf.numpy())


def test_turbo_generator_matches_flax():
    """The tiny-width generator with every turbo flag against flax's with
    the same flags, b = 2 patches of 64 points.  Off the TPU the JAX
    package takes the composed paths (exact kNN, bf16 one-hot gathers) and
    the port the fused kernel's plain version, which gathers the same bits
    at the same indices; the packed selection is not reached (the refiner
    runs on 256 ≤ 2048 points, inside the fused gate).  What remains is
    f32 round-off, which a bf16 rounding can magnify once: a gathered
    value on a bf16 rounding boundary rounds to either side (one bf16 ulp,
    2⁻⁸ relative) when the two packages' f32 inputs differ in the last
    bit.  Bound: rows within 1e-4 as the exact generator's test holds
    them, at least 99% of them, none beyond 1e-2 (seen: every row within
    2.5e-5 for seeds 3 to 5)."""
    (jc, jf), (tc, tf) = _gen_pair(dict(SMALL, **TURBO), b=2, n=64, seed=3)
    assert tc.shape == jc.shape == tf.shape == (2, 256, 3)
    for got, want in ((tc, jc), (tf, jf)):
        row = np.abs(got - want).max(axis=-1)
        assert (row <= 1e-4).mean() >= 0.99
        assert row.max() <= 1e-2


# ------------------------------------------------------ whole-cloud turbo


@pytest.fixture(scope="module")
def variables():
    variables = JDisPUGenerator(cfg=JGeneratorConfig(**SMALL, **TURBO)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 3), jnp.float32),
        train=False)
    return perturbed_numpy_tree(variables, 0, scale=0.05)


def _turbo_pair(variables, final_ratio):
    """(JAX upsampler, port upsampler) with the turbo flags, one weight
    set."""
    inf = dict(final_ratio=final_ratio, merge_fps="bucketed", **INF)
    jup = JPatchUpsampler(variables, gen_cfg=JGeneratorConfig(**SMALL, **TURBO),
                          inf_cfg=JInferenceConfig(**inf))
    tup = PatchUpsampler(variables, gen_cfg=GeneratorConfig(**SMALL, **TURBO),
                         inf_cfg=InferenceConfig(**inf), device="cpu")
    return jup, tup


def _clouds(b, n):
    return np.random.RandomState(b * n).randn(b, n, 3).astype(np.float32)


@pytest.mark.parametrize("final_ratio", [4, 16])
def test_bucketed_merge_on_jax_candidates_is_bit_equal(variables,
                                                       final_ratio):
    """Given the JAX package's own candidates, the port's bucketed merge
    takes its points exactly: one cloud, and two clouds in one call
    against the JAX package's merge of each."""
    jup, tup = _turbo_pair(variables, final_ratio)
    merged = []
    for pc in _clouds(2, 128):
        seed_num, out_num = plan_counts(pc.shape[0], tup.inf_cfg)
        jpc_n, _, _ = jnormalize(jnp.asarray(pc))
        patches, centroid, furthest = jup._prepare(jpc_n, seed_num=seed_num)
        cand = jup._chunked_generator(patches, 4) * furthest + centroid
        merged.append(np.array(cand.reshape(-1, 3)))
    assert out_num >= tup.inf_cfg.merge_fps_buckets
    want = [np.asarray(jup._merge(jnp.asarray(m), out_num=out_num))
            for m in merged]
    one = tup.merge(torch.from_numpy(merged[0])[None], out_num)[0].numpy()
    np.testing.assert_array_equal(one, want[0])
    both = tup.merge(torch.from_numpy(np.stack(merged)), out_num).numpy()
    for v in range(2):
        np.testing.assert_array_equal(both[v], want[v])


def _assert_same_cloud_bucketed(got, want):
    """Two outputs of the bucketed merge on candidates that differ by f32
    round-off, as sets.  The merge sorts the candidates by Morton code,
    whose 1023 steps a cloud's width apart a round-off move can cross (of
    the 4× candidates here, within 1.4e-5 of JAX's, 1.4% change code);
    bucket seams then shift, and a bucket whose first-ranked point (its
    FPS seed) changes picks another set.  So the bounds are on the scale
    of the output's own spacing (mean nearest-neighbour distance s, mean
    squared s²): Chamfer ≤ s²/4 (seen up to 0.12 s² at 16×, 0.004 s² at
    4×), every point within 3 s of the other cloud (seen 1.8 s), at least
    75% within 1e-3 (seen 79% at 16×, 97% at 4×).  Given the same
    candidates the merge is bit-equal
    (test_bucketed_merge_on_jax_candidates_is_bit_equal)."""
    d = np.sum((got[:, None, :] - want[None, :, :]) ** 2, axis=-1)
    near_got, near_want = d.min(axis=1), d.min(axis=0)
    own = np.sum((want[:, None, :] - want[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(own, np.inf)
    own = own.min(axis=1)
    assert near_got.mean() + near_want.mean() <= 0.25 * own.mean()
    assert (np.sqrt(max(near_got.max(), near_want.max()))
            <= 3.0 * np.sqrt(own).mean())
    assert (np.sqrt(near_got) <= 1e-3).mean() >= 0.75
    assert (np.sqrt(near_want) <= 1e-3).mean() >= 0.75


@pytest.mark.parametrize("final_ratio", [4, 16])
@pytest.mark.parametrize("call", ["upsample", "upsample_many"])
def test_turbo_upsample_matches_jax(variables, call, final_ratio):
    """The whole turbo path against the JAX package's: the candidates as
    the exact path's (test_torch_stream's bounds, 4× as 4×, 16× as 16×),
    the outputs as sets (``_assert_same_cloud_bucketed``)."""
    jup, tup = _turbo_pair(variables, final_ratio)
    pcs = _clouds(2, 128)
    if call == "upsample":
        want, got = [np.asarray(jup.upsample(pcs[0]))], [tup.upsample(pcs[0])]
    else:
        want, got = np.asarray(jup.upsample_many(pcs)), tup.upsample_many(pcs)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (128 * final_ratio, 3)
        assert np.isfinite(g).all()
        _assert_same_cloud_bucketed(g, w)


def test_turbo_candidates_match_jax(variables):
    """Fed the JAX package's patches, the turbo generator gives its 4×
    candidates to f32 round-off (seen: max 1.4e-5, 99.9% of rows within
    1e-5) and its 16× candidates within the exact 16× path's bound
    (test_torch_stream.test_pass2_candidates_match_jax: all rows within
    1e-3; seen max 4.7e-4) but for more rows past 1e-5 (seen 92.0%
    within, against the exact path's 97.6%): pass 2's backbone meets
    near-tied kNN selections on denser points, and the bf16 gathers
    round at either side of a boundary when the inputs differ in the last
    bit."""
    for ratio, row_bound, share in ((4, 1e-4, 0.99), (16, 1e-3, 0.9)):
        jup, tup = _turbo_pair(variables, ratio)
        pc = _clouds(1, 128)[0]
        seed_num, _ = plan_counts(pc.shape[0], tup.inf_cfg)
        jpc_n, _, _ = jnormalize(jnp.asarray(pc))
        patches, _, _ = jup._prepare(jpc_n, seed_num=seed_num)
        want = np.asarray(jup._chunked_generator(patches, 4))
        with torch.inference_mode():
            got = tup.generate(torch.from_numpy(np.array(patches))).numpy()
        row = np.abs(got - want).max(axis=-1)
        assert (row <= 1e-5).mean() >= share
        assert row.max() <= row_bound


def test_turbo_upsample_launches_nothing_on_the_cpu(variables):
    _, tup = _turbo_pair(variables, 16)
    kernels.reset_launch_counts()
    tup.upsample_many(_clouds(2, 128))
    assert sum(kernels.launch_counts().values()) == 0


# ---------------------------------------------------------------- the CLI


def _load_dispu():
    """``dispu.py`` from the repository's root, as a module."""
    spec = importlib.util.spec_from_file_location(
        "dispu", pathlib.Path(__file__).resolve().parents[1] / "dispu.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("phase", ["test", "train", "export"])
@pytest.mark.parametrize("turbo", ["true", "false"])
def test_cli_build_config_matches_dispu(monkeypatch, phase, turbo):
    argv = ["--phase", phase, "--turbo", turbo, "--final_ratio", "16",
            "--patch_batch", "8", "--batch_size", "4", "--dense_impl",
            "split", "--uniform_w", "3", "--cluster_prob", "0.25"]
    monkeypatch.setattr(sys, "argv", ["dispu.py"] + argv)
    dispu = _load_dispu()
    want = dataclasses.asdict(dispu.build_config(dispu.parse_args()))
    got = dataclasses.asdict(cli.build_config(cli.parse_args(argv)))
    for part in want:
        if isinstance(want[part], dict):
            assert {k: got[part][k] for k in want[part]} == want[part], part
        else:
            assert got[part] == want[part], part
    assert got["generator"]["fused_grouping"] == (turbo == "true"
                                                  and phase != "train")
    assert got["inference"]["merge_fps"] == ("bucketed" if turbo == "true"
                                             and phase != "train"
                                             else "exact")


@pytest.mark.parametrize("stream_batch", [1, 2])
def test_cli_test_phase_writes_what_the_upsampler_returns(tmp_path,
                                                          stream_batch):
    """``--phase test --turbo true --device cpu`` restores the newest
    checkpoint and writes each cloud's output, which equals the bits of
    ``PatchUpsampler.upsample`` (one cloud a call) or ``upsample_many``
    (``--stream_batch 2``) with the same weights, written alike."""
    from dispu_tpu_torch.evaluation.meshio import read_xyz, write_xyz
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.utils.checkpoint import save_checkpoint

    argv = ["--phase", "test", "--turbo", "true", "--device", "cpu",
            "--log_dir", str(tmp_path / "log"), "--patch_num_point", "64",
            "--patch_batch", "8", "--stream_batch", str(stream_batch),
            "--test_data", str(tmp_path / "in" / "*.xyz"), "--out_folder",
            str(tmp_path / "out")]
    cfg = cli.build_config(cli.parse_args(argv))
    train_cfg = cli.build_config(cli.parse_args(
        ["--phase", "train", "--patch_num_point", "64"]))
    state = create_generator_state(train_cfg.generator, seed=7, device="cpu")
    save_checkpoint(str(tmp_path / "log"), state, 1)
    state = create_generator_state(train_cfg.generator, seed=8, device="cpu")
    save_checkpoint(str(tmp_path / "log"), state, 2)  # the newest
    (tmp_path / "in").mkdir()
    pcs = _clouds(2, 128)
    for name, pc in zip(("a", "b"), pcs):
        write_xyz(str(tmp_path / "in" / f"{name}.xyz"), pc)
    cli.main(argv)

    up = PatchUpsampler(gen_cfg=cfg.generator, inf_cfg=cfg.inference,
                        device="cpu")
    up.model.load_state_dict(state.model.state_dict())
    inputs = np.stack([read_xyz(str(tmp_path / "in" / f"{n}.xyz"))
                       for n in ("a", "b")])
    outs = (up.upsample_many(inputs) if stream_batch == 2
            else [up.upsample(pc) for pc in inputs])
    for name, out in zip(("a", "b"), outs):
        assert out.shape == (128 * 4, 3)
        write_xyz(str(tmp_path / f"{name}_want.xyz"), out)
        assert ((tmp_path / "out" / f"{name}_X4.xyz").read_bytes()
                == (tmp_path / f"{name}_want.xyz").read_bytes())


# --use_gan true is ported: with bf16 compute, which is not, both phases
# still raise
@pytest.mark.parametrize("argv,match", [
    (["--phase", "train", "--use_gan", "true", "--compute_dtype",
      "bfloat16"], "bfloat16"),
    (["--phase", "test", "--use_gan", "true", "--compute_dtype",
      "bfloat16"], "bfloat16"),
    (["--phase", "export"], "serving"),
], ids=["argv0-GAN", "argv1-GAN", "argv2-serving"])
def test_cli_unported_phases_raise(tmp_path, argv, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv + ["--device", "cpu", "--log_dir", str(tmp_path)])


def test_cli_restoring_a_gan_checkpoint_raises(tmp_path):
    """A GAN checkpoint restores its generator half (tests/test_torch_gan.py);
    one without a generator half raises."""
    torch.save({"gen": {}, "disc": {}}, tmp_path / "model-3.pt")
    (tmp_path / "in").mkdir()
    with pytest.raises(ValueError, match="GAN checkpoint"):
        cli.main(["--phase", "test", "--device", "cpu", "--log_dir",
                  str(tmp_path), "--test_data", str(tmp_path / "in/*.xyz"),
                  "--patch_num_point", "64"])
