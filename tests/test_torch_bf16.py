"""bf16 compute (``compute_dtype="bfloat16"``) against the JAX package's
``dtype=jnp.bfloat16`` modules, on the CPU.

Both packages round at flax's points: a dense layer's operands to bf16,
the bf16 product (f32 sums, one rounding), then the bias as a second bf16
op; batch norm in f32 with a bf16 result; the geometry in f32.  What
remains between them is the order of the f32 sums inside each product
(XLA's and PyTorch's) and XLA's own ``exp``: a product that lands near a
bf16 rounding edge can round one ulp apart.  Each bound below is stated
in bf16 ulps (2⁻⁸ of the magnitude, 2⁻⁷ at most) or relative to the
largest output, with the reading it was taken from.

The feature kNN runs on bf16 features in two forms: the JAX package's
CPU path (XLA's distances, the norms rounded to bf16), which the port's
CPU path keeps, and ``knn_pallas``'s (the values upcast to f32 exactly),
which the card's kernels take.  Each is held against its JAX path.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.config import ExperimentConfig as JExperimentConfig
from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import InferenceConfig as JInferenceConfig
from dispu_tpu.config import TrainConfig as JTrainConfig
from dispu_tpu.inference import PatchUpsampler as JPatchUpsampler
from dispu_tpu.models.generator import DisPUGenerator as JDisPUGenerator
from dispu_tpu.nn import attention as jattention
from dispu_tpu.nn import edgeconv as jedgeconv
from dispu_tpu.nn import layers as jlayers
from dispu_tpu.nn import refine as jrefine
from dispu_tpu.nn import upsample as jupsample
from dispu_tpu.ops.pallas_kernels import (attention_pallas, attention_xla,
                                          knn_group_pallas, knn_pallas)
from dispu_tpu_torch import kernels
from dispu_tpu_torch.config import (ExperimentConfig, GeneratorConfig,
                                    InferenceConfig, TrainConfig,
                                    check_supported, check_train_supported)
from dispu_tpu_torch.convert import from_flax_variables
from dispu_tpu_torch.inference import PatchUpsampler
from dispu_tpu_torch.kernels.attention import (AttentionFunction,
                                               attention_torch)
from dispu_tpu_torch.kernels.knn_group import knn_group
from dispu_tpu_torch.models.generator import DisPUGenerator
from dispu_tpu_torch.nn import attention as tattention
from dispu_tpu_torch.nn import edgeconv as tedgeconv
from dispu_tpu_torch.nn import layers as tlayers
from dispu_tpu_torch.nn import refine as trefine
from dispu_tpu_torch.nn import upsample as tupsample
from dispu_tpu_torch.serving import ServedUpsampler, export_upsampler
from test_torch_generator import SMALL, perturbed_numpy_tree
from test_torch_neartie import JAX_SITES, _replay_port

torch.set_num_threads(1)

# the package's ``ops`` exports a function of the module's name
jknn = importlib.import_module("dispu_tpu.ops.knn")
tknn = importlib.import_module("dispu_tpu_torch.ops.knn")

BF16 = jnp.bfloat16
#: one bf16 ulp relative to a value in [1, 2)
ULP = 2.0 ** -7


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ordered(x) -> np.ndarray:
    """bf16 values (given as any float array) as integers in their order,
    so that neighbouring bf16 values differ by 1."""
    t = torch.from_numpy(_f32(x)).to(torch.bfloat16)
    i = t.view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i).numpy()


def ulps(got, want) -> np.ndarray:
    """Elementwise distance of two bf16-valued arrays in bf16 ulps."""
    return np.abs(_ordered(got) - _ordered(want))


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _pair(jmod, tmod, xs, seed=0, train=False):
    """(flax output, port output, variables): the flax module at bf16 and
    the port's at bf16 on one perturbed flax init; with ``train`` both in
    training mode (batch norm on the batch, its statistics returned)."""
    variables = perturbed_numpy_tree(
        jmod.init(jax.random.PRNGKey(seed), *map(jnp.asarray, xs)), seed,
        shift=0.1)
    from_flax_variables(tmod, variables)
    tlayers.set_compute_dtype(tmod, "bfloat16")
    tmod.train(train)
    if train:
        want, upd = jmod.apply(variables, *map(jnp.asarray, xs), train=True,
                               mutable=["batch_stats"])
    else:
        want, upd = jmod.apply(variables, *map(jnp.asarray, xs)), None
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, xs))
    return want, got, upd


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("use_bn,train", [(False, False), (True, False),
                                          (True, True)],
                         ids=["dense", "bn_eval", "bn_train"])
@pytest.mark.parametrize("linear", [False, True])
def test_point_conv_bf16(use_bn, train, linear):
    """One layer on the same bf16 operands: the product's f32 sum order is
    all that differs, so an element is at most one rounding apart before
    the bias and one after: ≤ 2 ulps (seen bit-equal, and in training
    mode 1 ulp in 3.4e-4 of the elements, from batch norm's f32 batch
    statistics, summed in other orders, which agree to 1e-6)."""
    act = None if linear else torch.relu
    jmod = jlayers.PointConv(16, activation=None if linear else
                             jax.nn.relu, use_bn=use_bn, dtype=BF16)
    tmod = tlayers.PointConv(40, 16, activation=act, use_bn=use_bn)
    x, = _inputs(0, (4, 64, 8, 40))
    want, got, upd = _pair(jmod, tmod, [x], train=train)
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    assert ulps(got, want).max() <= 2
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    if upd is not None:
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(tmod.bn, k).numpy(),
                np.asarray(upd["batch_stats"]["bn"][k]), rtol=1e-6,
                atol=1e-6)
            assert getattr(tmod.bn, k).dtype == torch.float32


def test_permuted_row_dense_bf16():
    """The refiner's ``after_conv`` (rows permuted at apply): as a plain
    dense layer, ≤ 2 ulps (seen bit-equal)."""
    jmod = jlayers.PointConv(32, kernel_row_perm=(12, 8), dtype=BF16)
    tmod = tlayers.PointConv(96, 32, kernel_row_perm=(12, 8))
    x, = _inputs(1, (2, 50, 96))
    want, got, _ = _pair(jmod, tmod, [x])
    assert ulps(got, want).max() <= 2


@pytest.mark.parametrize("dense_impl", ["concat", "split"])
@pytest.mark.parametrize("use_bn", [False, True])
def test_dense_edge_block_bf16(dense_impl, use_bn):
    """A dense block of three layers on bf16 features, the neighbours
    given (the kNN forms are held below): a one-ulp product in one layer
    feeds the next, so the block's output is held to 4 ulps of its
    largest element (seen bit-equal at this size)."""
    x, = _inputs(2, (2, 64, 24))
    xb = np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))
    idx = np.asarray(jknn.knn_unique_indices(
        9, jnp.asarray(xb), jnp.asarray(xb), impl="xla"))[:, :, 1:]
    jmod = jedgeconv.DenseEdgeBlock(12, 3, 8, use_bn=use_bn,
                                    dense_impl=dense_impl, dtype=BF16)
    tmod = tedgeconv.DenseEdgeBlock(24, 12, 3, 8, use_bn=use_bn,
                                    dense_impl=dense_impl)
    xs = jnp.asarray(xb).astype(BF16)
    variables = perturbed_numpy_tree(
        jmod.init(jax.random.PRNGKey(0), xs, False, jnp.asarray(idx)), 0,
        shift=0.1)
    from_flax_variables(tmod, variables)
    tlayers.set_compute_dtype(tmod, "bfloat16").eval()
    want, _ = jmod.apply(variables, xs, False, jnp.asarray(idx))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(xb).to(torch.bfloat16),
                      torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    err = np.abs(_f32(got) - _f32(want)).max()
    assert err <= 4 * ULP * np.abs(_f32(want)).max()


@pytest.mark.parametrize("up_ratio", [4, 6])
def test_duplicate_up_bf16(up_ratio):
    """The grid rounded to bf16 with the features, then two layers: each
    element within 4 ulps of its own magnitude after the second layer
    (seen bit-equal)."""
    jmod = jupsample.DuplicateUp(up_ratio=up_ratio, dtype=BF16)
    tmod = tupsample.DuplicateUp(30, up_ratio=up_ratio)
    x, = _inputs(3, (2, 40, 30))
    x = np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))
    want, got, _ = _pair(jmod, tmod, [x])
    assert ulps(got, want).max() <= 4


@pytest.mark.parametrize("offset_range", [None, 0.3])
def test_coordinate_regressor_bf16(offset_range):
    """256 → 64 → 3 and the sigmoid squash at bf16 (0.3's scalars round
    to bf16 first, as JAX's weak-typed ones, and the sigmoid is XLA's
    ``1 / (1 + exp(−x))`` op by op; ``torch.sigmoid`` rounded once is
    2.7 ulps of the largest output away): 1 ulp of the largest output."""
    jmod = jupsample.CoordinateRegressor(offset_range=offset_range,
                                         dtype=BF16)
    tmod = tupsample.CoordinateRegressor(32, offset_range=offset_range)
    x, = _inputs(4, (2, 100, 32))
    want, got, _ = _pair(jmod, tmod, [x])
    assert got.dtype == torch.bfloat16
    assert np.abs(_f32(got) - _f32(want)).max() <= (
        ULP * np.abs(_f32(want)).max())


def test_point_non_local_cell_bf16():
    """Projections at bf16 and the CPU's bf16 attention (``attention_xla``
    at bf16: each op rounded as XLA rounds it), then the output
    projection: 4 ulps of the largest output (seen bit-equal)."""
    jmod = jattention.PointNonLocalCell(bottleneck=32, out_features=48,
                                        dtype=BF16)
    tmod = tattention.PointNonLocalCell(64, 64, 32, 48)
    f, p = _inputs(5, (2, 128, 64), (2, 1, 128, 64))
    want, got, _ = _pair(jmod, tmod, [f, p])
    assert np.abs(_f32(got) - _f32(want)).max() <= (
        4 * ULP * np.abs(_f32(want)).max())


@pytest.mark.parametrize("use_bn", [False, True])
def test_point_shuffle2_bf16(use_bn):
    """The refiner at bf16 (the composed route, as JAX gates its fused
    kernels to f32) on bf16 features and f32 xyz, whose kNN and grouping
    stay f32 and select bit-equal: the local, skip and non-local
    branches, summed and aggregated, within 8 ulps of the largest output
    (seen bit-equal, and 0.17 ulp with batch norm)."""
    jmod = jrefine.PointShuffle2(nsample=8, mlp=(32, 32, 64), use_bn=use_bn,
                                 dtype=BF16)
    tmod = trefine.PointShuffle2(40, nsample=8, mlp=(32, 32, 64),
                                 use_bn=use_bn)
    xyz, f = _inputs(6, (2, 96, 3), (2, 96, 40))
    f = np.asarray(jnp.asarray(f).astype(BF16).astype(jnp.float32))
    assert tmod.local_route(torch.from_numpy(f).to(torch.bfloat16)) == "xla"
    (wx, wf), (gx, gf), _ = _pair(jmod, tmod, [xyz, f])
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    assert gf.dtype == torch.bfloat16
    assert np.abs(_f32(gf) - _f32(wf)).max() <= (
        8 * ULP * np.abs(_f32(wf)).max())


# --------------------------------------------------------------------- kNN

def _hold_selection(ti, td, ji, jd, d_full, k, rtol):
    """Indices bit-equal in every row whose first k + 1 sorted distances
    (of ``d_full``) lie more than ``rtol`` of the (k+1)-th apart; in the
    other rows the port's picks are k nearest to within ``rtol`` of it (a
    near-tie swap); the distances within ``rtol`` of it everywhere."""
    d_sorted = np.sort(d_full, axis=-1)
    scale = np.maximum(d_sorted[..., k:k + 1], 1e-30)
    tie = (np.diff(d_sorted[..., :k + 1], axis=-1) / scale <= rtol).any(-1)
    assert (~tie).mean() >= 0.5
    np.testing.assert_array_equal(ti[~tie], ji[~tie])
    picked = np.take_along_axis(d_full, ti.astype(np.int64), axis=-1)
    assert (np.abs(picked - d_sorted[..., :k]) <= rtol * scale).all()
    assert (np.abs(td - np.asarray(jd)) <= rtol * scale).all()


@pytest.mark.parametrize("c,n_dup", [(24, 0), (48, 6)])
def test_knn_xla_form_bf16(c, n_dup):
    """The port's CPU kNN on bf16 features (``impl='auto'``) against the
    JAX package's CPU path (``knn_unique`` at ``impl='xla'``, jitted):
    the same bf16 norms and f32 product, so the distances agree to f32
    round-off of the product's sum order (1e-6 of the row's largest) and
    the selections bit-equal wherever no two of a row's first k + 1
    distances lie that close."""
    x, = _inputs(7, (2, 200, c))
    if n_dup:
        x[:, -n_dup:] = x[:, :n_dup]
    xb = jnp.asarray(x).astype(BF16)
    jd, ji = jax.jit(lambda a: jknn.knn_unique(17, a, a, impl="xla"))(xb)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    td, ti = tknn.knn_unique(17, tx, tx)
    d_full = np.asarray(jax.jit(
        lambda a: jknn.pairwise_sq_dist(a, a))(xb)) + 1e30 * np.asarray(
        jknn.mask_duplicate_rows(xb))[:, None, :]
    _hold_selection(ti.numpy(), td.numpy(), np.asarray(ji), np.asarray(jd),
                    d_full, 17, 1e-6)


@pytest.mark.parametrize("c,n_dup", [(24, 0), (48, 6)])
def test_knn_upcast_form_bf16(c, n_dup):
    """The kernels' form on bf16 features (the values upcast to f32
    exactly; the plain version here, ``impl='torch'``) against
    ``knn_pallas`` in interpret mode on the same bf16 array, which
    upcasts the same way: selections bit-equal where no near-tie, the
    distances to f32 round-off."""
    x, = _inputs(8, (2, 200, c))
    if n_dup:
        x[:, -n_dup:] = x[:, :n_dup]
    xb = jnp.asarray(x).astype(BF16)
    dup = np.asarray(jknn.mask_duplicate_rows(xb)).astype(np.float32) * 1e30
    jd, ji = knn_pallas(17, xb, xb, jnp.asarray(dup), interpret=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    td, ti = tknn.knn_unique(17, tx, tx, impl="torch")
    x32 = np.asarray(xb.astype(jnp.float32))
    d_full = np.sum((x32[:, :, None] - x32[:, None]) ** 2, -1) + dup[:, None]
    _hold_selection(ti.numpy(), td.numpy(), np.asarray(ji), np.asarray(jd),
                    d_full, 17, 1e-6)


@pytest.mark.parametrize("exact", [True, False], ids=["fused", "turbo"])
def test_knn_group_bf16_upcasts(exact):
    """``knn_group`` on bf16 features upcasts as ``knn_group_pallas`` does
    (interpret mode): indices bit-equal away from near-ties, and the
    gathered rows are the table's own bf16 values (turbo: their bf16
    rounding, the same), returned in the table's dtype."""
    x, = _inputs(9, (2, 128, 24))
    xb = jnp.asarray(x).astype(BF16)
    _, ji, _, jf = knn_group_pallas(8, xb, xb, xb, exact=exact,
                                    with_xyz=False, drop_first=True,
                                    interpret=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    _, ti, _, tf = knn_group(8, tx, tx, tx, exact=exact, with_xyz=False,
                             drop_first=True)
    assert tf.dtype == torch.bfloat16
    same = (ti.numpy() == np.asarray(ji)).all(axis=-1)
    assert same.mean() >= 0.95
    np.testing.assert_array_equal(_f32(tf)[same], np.asarray(jf)[same])


# --------------------------------------------------------------- attention

def _qkv(seed, b=2, nq=300, nk=280, c=32, cv=48):
    q, k, v = _inputs(seed, (b, nq, c), (b, nk, c), (b, nk, cv))
    return [np.asarray(jnp.asarray(t).astype(BF16).astype(jnp.float32))
            for t in (q, k, v)]


def test_attention_bf16_matches_xla():
    """The CPU path at bf16 (``attention_torch`` of bf16 operands) against
    ``attention_xla`` at bf16, jitted: each op rounds to bf16 at the same
    points; XLA's exp and the products' sum orders move a few elements by
    one ulp: held to one ulp of the largest output in at most 5% of the
    elements (seen one ulp, 1.7%)."""
    q, k, v = _qkv(10)
    scale = 1.0 / 32 ** 0.5
    want = jax.jit(lambda a, b, c: attention_xla(a, b, c, scale))(
        *(jnp.asarray(t).astype(BF16) for t in (q, k, v)))
    got = attention_torch(*(torch.from_numpy(t).to(torch.bfloat16)
                            for t in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    d = np.abs(_f32(got) - _f32(want))
    assert d.max() <= ULP * np.abs(_f32(want)).max()
    assert (d > 0).mean() <= 0.05


def test_attention_bf16_operands_match_pallas():
    """The kernel's plain version on bf16 operands (f32 out) against
    ``attention_pallas`` in interpret mode on the same bf16 arrays, at the
    NL cell's width: ``test_torch_kernels``' bounds for f32 operands
    (the f32 sum order and exp's last bit move a p across a bf16 edge);
    and the plain version gives the same bits for the bf16 operands as for
    their f32 upcast, as the card's two entries must."""
    q, k, v = _qkv(11, nq=512, nk=512, c=64, cv=64)
    bq, bk, bv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = attention_torch(bq, bk, bv, 0.125, bf16_operands=True)
    assert got.dtype == torch.float32
    want = np.asarray(attention_pallas(
        *(jnp.asarray(t).astype(BF16) for t in (q, k, v)), 0.125,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
    assert np.abs(got.numpy() - want).mean() < 1e-6
    assert torch.equal(got, attention_torch(
        *map(torch.from_numpy, (q, k, v)), 0.125, bf16_operands=True))


def test_attention_function_bf16_gradients_in_operand_dtype():
    """``AttentionFunction`` on bf16 operands: f32 out, each gradient in
    its operand's dtype, equal to the f32 rule's rounded to bf16."""
    q, k, v = _qkv(12, nq=64, nk=64, c=16, cv=16)
    do = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(0))
    leaves = [torch.from_numpy(t).to(torch.bfloat16).requires_grad_(True)
              for t in (q, k, v)]
    out = AttentionFunction.apply(*leaves, 0.25, False)
    assert out.dtype == torch.float32
    out.backward(do)
    f32 = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    AttentionFunction.apply(*f32, 0.25, False).backward(do)
    for a, b in zip(leaves, f32):
        assert a.grad.dtype == torch.bfloat16
        assert torch.equal(a.grad, b.grad.to(torch.bfloat16))


# --------------------------------------------------------------- generator

def _record_jax_jitted(monkeypatch, fn, *args):
    """``_record_jax`` of ``jax.jit(fn)(*args)``: the JAX package's kNN
    selections are returned from the jitted call beside its result (op
    by op, compiling each op of the apply on first use takes ~15 s)."""
    recorded = []
    for module, name in zip(JAX_SITES[::2], JAX_SITES[1::2]):
        def wrapped(*a, _orig=getattr(module, name), **kw):
            idx = _orig(*a, **kw)
            recorded.append(idx)
            return idx
        monkeypatch.setattr(module, name, wrapped)
    out, rec = jax.jit(lambda *a: (fn(*a), recorded))(*args)
    monkeypatch.undo()
    return out, [np.asarray(i) for i in rec]


@pytest.mark.parametrize("cfg_kw,n", [(SMALL, 64), ({}, 256)],
                         ids=["small", "full_width"])
def test_generator_bf16_matches_flax(monkeypatch, cfg_kw, n):
    """The generator at bf16, the JAX package's kNN selections replayed
    (``test_torch_neartie``): bf16 features meet near-ties that the two
    packages' distances break apart.  ``coarse`` and ``fine`` are f32 (the
    geometry's dtype in both); each within 2 bf16 ulps of its largest
    coordinate (seen ≤ 0.38 and ≤ 0.61 ulp at either width)."""
    x, = _inputs(13, (2, n, 3))
    jm = JDisPUGenerator(cfg=JGeneratorConfig(**cfg_kw), dtype=BF16)
    variables = perturbed_numpy_tree(jax.jit(
        lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(
        jnp.asarray(x)), 0)
    (jc, jf), rec = _record_jax_jitted(
        monkeypatch, lambda v, a: jm.apply(v, a, train=False), variables,
        jnp.asarray(x))
    tm = DisPUGenerator(GeneratorConfig(**cfg_kw), dtype="bfloat16")
    from_flax_variables(tm, variables)
    with torch.no_grad():
        tc, tf = _replay_port(monkeypatch, rec,
                              lambda: tm(torch.from_numpy(x)))
    assert tc.dtype == tf.dtype == torch.float32
    for got, want in ((tc, jc), (tf, jf)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= (
            2 * ULP * np.abs(want).max())


@pytest.fixture(scope="module")
def upsamplers():
    """(variables, {ratio: (JAX bf16 upsampler, port bf16 upsampler)})
    on one perturbed flax init of the SMALL generator."""
    jcfg = JGeneratorConfig(**SMALL)
    variables = perturbed_numpy_tree(jax.jit(
        lambda a: JDisPUGenerator(cfg=jcfg).init(jax.random.PRNGKey(0), a,
                                                 train=False))(
        jnp.zeros((1, 64, 3), jnp.float32)), 0, scale=0.05)
    pairs = {}
    for ratio in (4, 16):
        inf = dict(patch_num_point=64, patch_batch=4, final_ratio=ratio,
                   compute_dtype="bfloat16")
        pairs[ratio] = (
            JPatchUpsampler(variables, gen_cfg=jcfg,
                            inf_cfg=JInferenceConfig(**inf)),
            PatchUpsampler(variables, gen_cfg=GeneratorConfig(**SMALL),
                           inf_cfg=InferenceConfig(**inf), device="cpu"))
    return variables, pairs


def _chamfer(a, b):
    d = np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
    return d.min(axis=1).mean() + d.min(axis=0).mean()


@pytest.mark.parametrize("ratio", [4, 16])
@pytest.mark.parametrize("call", ["upsample", "upsample_many"])
def test_upsample_bf16_matches_jax(upsamplers, ratio, call):
    """Whole requests at bf16 against the JAX package's bf16 upsampler, as
    sets: the JAX package's own bf16 test takes Chamfer < 0.05 × scale
    against its f32 run; here the bound is 1e-4 × scale, with scale the
    cloud's squared extent (seen 3.2e-6 at 4×, 2.4e-7 at 16×; JAX's bf16
    run is 6.5e-6 and 4.6e-7 from its own f32 one)."""
    jup, tup = upsamplers[1][ratio]
    pcs = np.random.RandomState(14).randn(2, 200, 3).astype(np.float32)
    if call == "upsample":
        want, got = [np.asarray(jup.upsample(pcs[0]))], [tup.upsample(pcs[0])]
    else:
        want = np.asarray(jup.upsample_many(pcs))
        got = tup.upsample_many(pcs)
    for g, w, pc in zip(got, want, pcs):
        assert g.dtype == np.float32 and g.shape == (200 * ratio, 3)
        assert np.isfinite(g).all()
        scale = float(np.sum((pc.max(0) - pc.min(0)) ** 2))
        assert _chamfer(g, w) <= 1e-4 * scale


def test_upsample_bf16_launches_nothing_on_the_cpu(upsamplers):
    kernels.reset_launch_counts()
    upsamplers[1][4][1].upsample(
        np.random.RandomState(15).randn(128, 3).astype(np.float32))
    assert sum(kernels.launch_counts().values()) == 0


def test_export_bf16_round_trip(upsamplers, tmp_path):
    """A bf16 upsampler exported on the CPU and served: bit-equal to the
    live request, and the manifest records the compute dtype."""
    tup = upsamplers[1][4][1]
    pc = np.random.RandomState(16).randn(150, 3).astype(np.float32)
    manifest = export_upsampler(tup.model.state_dict(), [150],
                                str(tmp_path), gen_cfg=GeneratorConfig(
                                    **SMALL), inf_cfg=tup.inf_cfg,
                                device="cpu")
    assert manifest["inference_config"]["compute_dtype"] == "bfloat16"
    served = ServedUpsampler(str(tmp_path)).upsample(pc)
    np.testing.assert_array_equal(served, tup.upsample(pc))


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("dtype", ["float16", "bf16", "float64"])
def test_unknown_compute_dtype_raises(dtype):
    with pytest.raises(ValueError, match="compute_dtype"):
        check_supported(GeneratorConfig(), InferenceConfig(
            compute_dtype=dtype))
    with pytest.raises(ValueError, match="compute_dtype"):
        check_train_supported(ExperimentConfig(
            train=TrainConfig(compute_dtype=dtype)))
    with pytest.raises(ValueError, match="compute_dtype"):
        DisPUGenerator(GeneratorConfig(**SMALL), dtype=dtype)


def test_set_compute_dtype_keeps_parameters_f32():
    """The compute dtype is a module attribute: set and restored by
    ``computing_at``; parameters and buffers stay f32 tensors."""
    m = DisPUGenerator(GeneratorConfig(**SMALL), dtype="bfloat16")
    convs = [x for x in m.modules() if hasattr(x, "compute_dtype")]
    assert convs and all(x.compute_dtype == torch.bfloat16 for x in convs)
    with tlayers.computing_at(m, "float32"):
        assert all(x.compute_dtype == torch.float32 for x in convs)
    assert all(x.compute_dtype == torch.bfloat16 for x in convs)
    assert all(t.dtype == torch.float32 for t in m.state_dict().values())


# ------------------------------------------------------------------- steps

def _step_configs(**gen):
    """(JAX, port) experiment configs of a small bf16 CD step: curated
    input, no augmentation."""
    from dispu_tpu.config import DataConfig as JDataConfig

    from dispu_tpu_torch.config import DataConfig

    kw = dict(num_points=32, knn=8, refine_nsample=8, **gen)
    j = JExperimentConfig(
        generator=JGeneratorConfig(**kw),
        train=JTrainConfig(batch_size=4, compute_dtype="bfloat16"),
        data=JDataConfig(random_input=False, augment=False))
    t = ExperimentConfig(
        generator=GeneratorConfig(**kw),
        train=TrainConfig(batch_size=4, compute_dtype="bfloat16"),
        data=DataConfig(random_input=False, augment=False))
    return j, t


def _batch():
    rng = np.random.RandomState(17)
    gt = rng.randn(4, 128, 3).astype(np.float32) * 0.3
    return gt, gt[:, ::4].copy(), np.ones(4, np.float32)


def _l2_rel(got: dict, want: dict) -> float:
    """|got − want| / |want| over every leaf at once (L2 norms)."""
    num = sum(float(np.sum((got[k] - w) ** 2)) for k, w in want.items())
    return (num / sum(float(np.sum(w ** 2)) for w in want.values())) ** 0.5


def test_cd_step_bf16_matches_jax():
    """One CD step at bf16 from one JAX state against
    ``make_train_step(jit_compile=False)``, jitted.  The forward differs
    by bf16 ulps, and the kNN selections these move, so each metric is
    held to 5e-2 relative (seen ≤ 2.4e-2, ``offset_max``, a maximum over
    points; the JAX package's own bf16 step is 8.8e-2 from its f32 one
    there) and the whole gradient, read from the first moments, to 5e-2
    in L2 norm relative to JAX's (seen 2.1e-2; JAX's bf16 gradient is
    7.9e-2 from its own f32 one).  Both states' parameters, gradients and
    Adam moments are f32, and so are ``coarse`` and ``fine`` in the eval
    step."""
    from dispu_tpu.train.state import create_generator_state as jcreate
    from dispu_tpu.train.steps import make_train_step as jmake

    from dispu_tpu_torch.convert import from_jax_state
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_eval_step, make_train_step
    from test_torch_train import _leaf_map

    jcfg, tcfg = _step_configs()
    js = jcreate(jax.random.PRNGKey(0), jcfg.generator, jcfg.train)
    tree = perturbed_numpy_tree({"params": js.params,
                                 "batch_stats": js.batch_stats}, 5)
    js = js.replace(
        params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"]))
    gt, inputs, radius = _batch()
    js1, jm = jax.jit(jmake(jcfg, jit_compile=False))(
        js, jnp.asarray(gt), jnp.asarray(inputs), jnp.asarray(radius),
        jax.random.PRNGKey(0))
    ts = create_generator_state(tcfg.generator, device="cpu")
    from_jax_state(ts, jax.device_get(js))
    ts, tm = make_train_step(tcfg, device="cpu")(
        ts, *map(torch.from_numpy, (gt, inputs, radius)), torch.Generator())
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=5e-2,
                                   err_msg=k)
    named = dict(ts.model.named_parameters())
    assert all(p.dtype == p.grad.dtype == ts.mu[n].dtype == ts.nu[n].dtype
               == torch.float32 for n, p in named.items())
    grads = {n: p.grad.numpy() for n, p in named.items()}
    want = {k: v / np.float32(0.1)
            for k, v in _leaf_map(js1.opt_state.mu).items()}
    assert _l2_rel(grads, want) <= 5e-2
    c, f, _ = make_eval_step(tcfg, device="cpu")(
        ts.model, *map(torch.from_numpy, (inputs, gt, radius)))
    assert c.dtype == f.dtype == torch.float32


def test_gan_step_bf16_matches_jax():
    """One GAN step at bf16 from one JAX ``GANState``: the generator at
    bf16, the critic f32 in both; metrics to 2e-2 relative, with the
    critic's near-zero ones against 1e-3 of the largest metric (seen
    6.3e-3); the updates through the first Adam moments, in L2 norm
    relative to JAX's: the generator's to 5e-2 (seen 1.6e-2; JAX's bf16
    step is 0.13 from its own f32 one), the critic's to 4e-4 (seen 1.6e-4,
    its inputs the bf16 generator's output; JAX's gap 8.3e-4); every
    tensor of the state f32."""
    from dispu_tpu.train.gan_steps import create_gan_state as jcreate
    from dispu_tpu.train.gan_steps import make_gan_train_step as jmake

    from dispu_tpu_torch.convert import from_jax_gan_state
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)
    from test_torch_train import _leaf_map

    jcfg, tcfg = _step_configs()
    jcfg = dataclasses.replace(jcfg, use_gan=True)
    tcfg = dataclasses.replace(tcfg, use_gan=True)
    js = jcreate(jax.random.PRNGKey(0), jcfg)
    gt, inputs, radius = _batch()
    js1, jm = jax.jit(jmake(jcfg, jit_compile=False))(
        js, jnp.asarray(gt), jnp.asarray(inputs), jnp.asarray(radius),
        jax.random.PRNGKey(0))
    ts = create_gan_state(tcfg, device="cpu")
    from_jax_gan_state(ts, jax.device_get(js))
    ts, tm = make_gan_train_step(tcfg, device="cpu")(
        ts, *map(torch.from_numpy, (gt, inputs, radius)), torch.Generator())
    top = max(abs(float(v)) for v in jm.values())
    for k, v in jm.items():
        assert abs(float(tm[k]) - float(v)) <= 2e-2 * max(
            abs(float(v)), 1e-3 * top), k
    for mine, theirs, bound in ((ts.gen.mu, js1.gen.opt_state.mu, 5e-2),
                                (ts.d_mu, js1.d_opt_state.mu, 4e-4)):
        got = {n: t.numpy() for n, t in mine.items()}
        assert _l2_rel(got, _leaf_map(theirs)) <= bound
    tensors = [*ts.gen.model.parameters(), *ts.gen.mu.values(),
               *ts.gen.nu.values(), *ts.disc.parameters(),
               *ts.d_mu.values(), *ts.d_nu.values()]
    assert all(t.dtype == torch.float32 for t in tensors)
    assert all(p.grad is None or p.grad.dtype == torch.float32
               for p in ts.gen.model.parameters())
    assert all(x.compute_dtype == torch.float32 for x in ts.disc.modules()
               if hasattr(x, "compute_dtype"))
