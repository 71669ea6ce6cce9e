"""The fused refiner (``refine_local_impl`` 'fused' and 'megafused')
against the JAX package's, on the CPU.

* the kernels' plain versions, ``refine_local_torch`` and
  ``refine_block_torch``, against ``refine_local_pallas`` and
  ``refine_block_pallas`` run in interpret mode;
* the port's ``PointShuffle2(local_impl=…)`` against flax's on converted
  weights, with the weight net's batch-norm statistics moved so that the
  fold is exercised;
* the gates: training and unaligned n take the composed path, and the
  kernels' autograd Functions refuse a backward;
* whole 4× and 16× upsampling, and ``upsample_many``, with each setting
  against the JAX package's upsampler with the same setting;
* the CUDA kernels' precision argument: their 3xTF32 products, emulated,
  against an f64 reference (single-pass TF32 misses the bound).

Values agree to f32 round-off of sums taken in other orders: each bound
is 1e-5 of max(|output|, 1).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import InferenceConfig as JInferenceConfig
from dispu_tpu.inference import PatchUpsampler as JPatchUpsampler
from dispu_tpu.models.generator import DisPUGenerator as JDisPUGenerator
from dispu_tpu.nn import refine as jrefine
from dispu_tpu.ops.pallas_kernels import (knn_pallas, refine_block_pallas,
                                          refine_local_pallas)
from dispu_tpu_torch import kernels
from dispu_tpu_torch.config import (ExperimentConfig, GeneratorConfig,
                                    InferenceConfig, check_train_supported)
from dispu_tpu_torch.convert import from_flax_variables
from dispu_tpu_torch.inference import PatchUpsampler
from dispu_tpu_torch.kernels.knn import knn_torch
from dispu_tpu_torch.kernels.refine_block import (RefineBlockFunction,
                                                  refine_block,
                                                  refine_block_torch)
from dispu_tpu_torch.kernels.refine_local import (LocalParams,
                                                  RefineLocalFunction,
                                                  refine_local,
                                                  refine_local_torch,
                                                  tile_queries)
from dispu_tpu_torch.models.generator import DisPUGenerator
from dispu_tpu_torch.nn import refine as trefine
from test_torch_generator import perturbed_numpy_tree
from test_torch_inference import SMALL
from test_torch_stream import (_assert_close_as_clouds,
                               _assert_same_cloud_16x, _clouds)

torch.set_num_threads(1)

REL = 1e-5
SETTINGS = ("fused", "megafused")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, (err, scale)


def _params(rng, cf, c_mid=32, c_out=48, k=8):
    """``tests/test_pallas.py``'s random pre-folded parameters."""
    r = lambda *s: rng.randn(*s).astype(np.float32) * 0.2  # noqa: E731
    return dict(w0=r(cf, c_mid), b0=r(c_mid), w1=r(c_mid, c_mid),
                b1=r(c_mid), ww=r(3, k), bw=r(k), wsk=r(cf, c_out),
                bsk=r(c_out), waf=r(k, c_mid, c_out), baf=r(c_out))


def _torch_params(p):
    return LocalParams(**{k: torch.from_numpy(v) for k, v in p.items()})


def _jax_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


# ---------------------------------------------------------------- kernels


def test_refine_local_plain_matches_pallas():
    rng = np.random.RandomState(0)
    g = rng.randn(2, 256, 8, 38).astype(np.float32)
    p = _params(rng, 38)
    want = refine_local_pallas(jnp.asarray(g), **_jax_params(p),
                               interpret=True)
    got = refine_local_torch(torch.from_numpy(g), _torch_params(p))
    _close(got, want)
    # the wrapper's plain route is the same function
    _close(refine_local(torch.from_numpy(g), _torch_params(p)), want)


def test_refine_local_rejects_unaligned_n():
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randn(1, 200, 8, 38).astype(np.float32))
    with pytest.raises(ValueError, match="multiple of"):
        refine_local(g, _torch_params(_params(rng, 38)))


@pytest.mark.parametrize("n", [256, 200])
def test_refine_block_plain_matches_pallas(n):
    """The plain selection bit-equal to ``knn_pallas``'s, the output to
    ``refine_block_pallas``'s, also at an n off the 128-query tile."""
    rng = np.random.RandomState(n)
    xyz = rng.randn(2, n, 3).astype(np.float32)
    feats = rng.randn(2, n, 16).astype(np.float32)
    p = _params(rng, 22)
    _, jidx = knn_pallas(8, jnp.asarray(xyz), jnp.asarray(xyz),
                         interpret=True)
    _, idx = knn_torch(8, torch.from_numpy(xyz), torch.from_numpy(xyz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    want = refine_block_pallas(jnp.asarray(xyz), jnp.asarray(feats),
                               **_jax_params(p), interpret=True)
    got = refine_block_torch(torch.from_numpy(xyz), torch.from_numpy(feats),
                             _torch_params(p))
    _close(got, want)
    _close(refine_block(torch.from_numpy(xyz), torch.from_numpy(feats),
                        _torch_params(p)), want)


def test_refine_block_rejects_what_pallas_rejects():
    rng = np.random.RandomState(2)
    xyz = torch.from_numpy(rng.randn(1, 64, 3).astype(np.float32))
    feats = torch.from_numpy(rng.randn(1, 64, 16).astype(np.float32))
    with pytest.raises(ValueError, match="rows"):
        refine_block(xyz, feats, _torch_params(_params(rng, 23)))
    with pytest.raises(ValueError, match="k <= 16"):
        refine_block(xyz, feats, _torch_params(_params(rng, 22, k=17)))


def test_refine_functions_refuse_backward():
    rng = np.random.RandomState(3)
    p = _torch_params(_params(rng, 22))
    g = torch.from_numpy(rng.randn(1, 128, 8, 22).astype(np.float32))
    out = RefineLocalFunction.apply(g.requires_grad_(True), False, *p)
    with pytest.raises(RuntimeError, match="inference only"):
        out.sum().backward()
    xyz = torch.from_numpy(rng.randn(1, 64, 3).astype(np.float32))
    feats = torch.from_numpy(rng.randn(1, 64, 16).astype(np.float32))
    out = RefineBlockFunction.apply(xyz, feats.requires_grad_(True), False,
                                    *p)
    with pytest.raises(RuntimeError, match="inference only"):
        out.sum().backward()


# ------------------------------------------- the kernels' precision (CPU)
#
# The CUDA kernels run conv0, conv1, after_conv and skip on the tensor
# cores as three TF32 products (3xTF32), the weight net and the pooling
# in f32.  The emulation below repeats that on the CPU: a TF32 value is an
# f32 rounded to nearest on its 13 low mantissa bits (cvt.rna.tf32.f32),
# x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a product is
# a_lo b_hi + a_hi b_lo + a_hi b_hi (the products of two TF32 values are
# exact in f32).  Nothing on the main path uses it.


def _tf32(x):
    """Round an f32 tensor to TF32, to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _branches_with(grouped, p, mm):
    """``refine_local_torch``'s math with conv0, conv1, after_conv and
    skip through ``mm`` (the kernels' tensor-core products)."""
    b, n = grouped.shape[:2]
    h = torch.relu(mm(torch.relu(mm(grouped, p.w0) + p.b0), p.w1) + p.b1)
    w = torch.relu(grouped[..., :3] @ p.ww + p.bw)
    pool = torch.einsum("bnkt,bnkc->bntc", w, h).reshape(b, n, -1)
    after = torch.relu(mm(pool, p.waf.reshape(-1, p.waf.shape[-1])) + p.baf)
    skip = torch.relu(mm(torch.amax(grouped, dim=2), p.wsk) + p.bsk)
    return after + skip


def _fan_in_params(rng, k, cf, mlp):
    """``kernels/measure.py``'s scaling: each kernel by 1/sqrt(fan-in)."""
    c1, c2, co = mlp
    shapes = [(cf, c1), (c1,), (c1, c2), (c2,), (3, k), (k,), (cf, co),
              (co,), (k, c2, co), (co,)]

    def draw(shape):
        if len(shape) == 1:
            return 0.1 * rng.randn(*shape)
        fan_in = shape[-2] * (shape[0] if len(shape) == 3 else 1)
        return rng.randn(*shape) / np.sqrt(fan_in)

    return LocalParams(*(torch.from_numpy(draw(s).astype(np.float32))
                         for s in shapes))


@pytest.mark.parametrize("b,n,k,c,mlp", [
    (2, 16, 8, 16, (32, 32, 48)),        # a small width
    (1, 8, 16, 128, (128, 128, 256)),    # one tile at GeneratorConfig()'s
])
def test_3xtf32_products_hold_f32_grade(b, n, k, c, mlp):
    """3xTF32 products keep the refiner within ``REL`` of an f64
    reference; single-pass TF32 (what the kernels do not take) misses it,
    at both widths."""
    rng = np.random.RandomState(k + c)
    g = torch.from_numpy(rng.randn(b, n, k, 6 + c).astype(np.float32))
    p = _fan_in_params(rng, k, 6 + c, mlp)
    # the restated math is the plain version's
    np.testing.assert_array_equal(
        _branches_with(g, p, torch.matmul).numpy(),
        refine_local_torch(g, p).numpy())
    ref = _branches_with(g.double(), LocalParams(*(t.double() for t in p)),
                         torch.matmul).numpy()
    scale = max(float(np.abs(ref).max()), 1.0)
    err3 = float(np.abs(_branches_with(g, p, _mm_3xtf32).numpy()
                        - ref).max())
    err1 = float(np.abs(_branches_with(g, p, _mm_tf32).numpy() - ref).max())
    assert err3 <= REL * scale, (err3, scale)
    assert err1 > REL * scale, (err1, scale)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0e38])
    got = _tf32(x)
    assert got.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                -(1.0 + 2.0 ** -10)]
    assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)


def test_tile_queries_fit_the_kernels_tile():
    """Queries a block: 8 at most (the heads' n8 side), T k ≤ 128 grouped
    rows, and k past 128 refused."""
    assert [tile_queries(k) for k in (1, 8, 12, 16, 32, 100, 128)] == [
        8, 8, 8, 8, 4, 1, 1]
    with pytest.raises(ValueError, match="k <= 128"):
        tile_queries(129)


# ---------------------------------------------------------------- modules


def _jit_init(module, *args):
    """flax's init under one jit (the same values as the eager init, in a
    third of the time here)."""
    return jax.jit(lambda *a: module.init(*a, train=False))(*args)


def _module_pair(c, n, nsample, mlp, seed, b=2):
    """(flax module, its variables with the weight net's BN moved, port
    module of each setting, inputs)."""
    rng = np.random.RandomState(seed)
    xyz = rng.randn(b, n, 3).astype(np.float32)
    feat = rng.randn(b, n, c).astype(np.float32)
    jmod = jrefine.PointShuffle2(nsample=nsample, mlp=mlp)
    variables = _jit_init(jmod, jax.random.PRNGKey(seed), jnp.asarray(xyz),
                          jnp.asarray(feat))
    variables = perturbed_numpy_tree(variables, seed, shift=0.1)
    bn = variables["batch_stats"]["weight_net"]["wconv0"]["bn"]
    bn["mean"] = bn["mean"] + 0.1
    bn["var"] = bn["var"] * 1.7
    ports = {}
    for setting in ("xla",) + SETTINGS:
        tmod = trefine.PointShuffle2(c, nsample, mlp, local_impl=setting)
        from_flax_variables(tmod, variables)
        ports[setting] = tmod.eval()
    return variables, ports, xyz, feat


def _flax(variables, nsample, mlp, xyz, feat, **kw):
    _, out = jrefine.PointShuffle2(nsample=nsample, mlp=mlp, **kw).apply(
        variables, jnp.asarray(xyz), jnp.asarray(feat), train=False)
    return np.asarray(out)


def _port(tmod, xyz, feat):
    with torch.inference_mode():
        return tmod(torch.from_numpy(xyz), torch.from_numpy(feat))[1].numpy()


def test_module_settings_match_flax():
    """'fused' against flax's composed ('xla') module, 'megafused' against
    flax's composed module with the bf16 'onehot' feature gather (the
    values the mega-fused kernel takes)."""
    kw = dict(nsample=8, mlp=(32, 32, 64))
    variables, ports, xyz, feat = _module_pair(16, 128, seed=0, **kw)
    assert ports["fused"].local_route(torch.from_numpy(feat)) == "fused"
    assert ports["megafused"].local_route(
        torch.from_numpy(feat)) == "megafused"
    want = _flax(variables, xyz=xyz, feat=feat, **kw)
    _close(_port(ports["fused"], xyz, feat), want)
    want = _flax(variables, xyz=xyz, feat=feat, gather_impl="onehot", **kw)
    _close(_port(ports["megafused"], xyz, feat), want)


def test_module_full_width_matches_flax():
    """At GeneratorConfig()'s refiner width, each setting against flax
    with the same setting (its Pallas kernel in interpret mode)."""
    kw = dict(nsample=16, mlp=(128, 128, 256))
    variables, ports, xyz, feat = _module_pair(128, 1024, seed=1, b=1, **kw)
    for setting in SETTINGS:
        want = _flax(variables, xyz=xyz, feat=feat, local_impl=setting, **kw)
        _close(_port(ports[setting], xyz, feat), want)


def _forbid_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the composed path was expected")

    monkeypatch.setattr(trefine, "refine_local", refuse)
    monkeypatch.setattr(trefine, "refine_block", refuse)


@pytest.mark.parametrize("setting", SETTINGS)
def test_training_takes_the_composed_path(setting, monkeypatch):
    """In .train() both settings give the composed path's output and
    gradients bit for bit, and no refine kernel runs."""
    kw = dict(nsample=8, mlp=(32, 32, 64))
    _, ports, xyz, feat = _module_pair(16, 128, seed=2, **kw)
    _forbid_kernels(monkeypatch)
    before = dict(kernels.LAUNCHES)
    results = []
    for tmod in (ports["xla"], ports[setting]):
        tmod = copy.deepcopy(tmod).train()
        out = tmod(torch.from_numpy(xyz), torch.from_numpy(feat))[1]
        grads = torch.autograd.grad(torch.sum(out ** 2),
                                    list(tmod.parameters()))
        results.append((out.detach(), grads))
    assert torch.equal(results[0][0], results[1][0])
    assert all(torch.equal(a, b) for a, b in zip(results[0][1],
                                                 results[1][1]))
    assert kernels.LAUNCHES == before


def test_fused_at_unaligned_n_takes_the_composed_path(monkeypatch):
    kw = dict(nsample=8, mlp=(32, 32, 64))
    _, ports, xyz, feat = _module_pair(16, 200, seed=3, **kw)
    assert ports["fused"].local_route(torch.from_numpy(feat)) == "xla"
    want = _port(ports["xla"], xyz, feat)
    _forbid_kernels(monkeypatch)
    np.testing.assert_array_equal(_port(ports["fused"], xyz, feat), want)


def test_eval_forward_through_a_kernel_cannot_be_differentiated():
    kw = dict(nsample=8, mlp=(32, 32, 64))
    _, ports, xyz, feat = _module_pair(16, 128, seed=4, **kw)
    for setting in SETTINGS:
        out = ports[setting](torch.from_numpy(xyz), torch.from_numpy(feat))[1]
        with pytest.raises(RuntimeError, match="inference only"):
            out.sum().backward()


# ------------------------------------------------------------ whole paths


@pytest.mark.parametrize("setting", SETTINGS)
def test_settings_build_and_train_config(setting):
    model = DisPUGenerator(GeneratorConfig(refine_local_impl=setting))
    assert model.PointShuffle.local_impl == setting
    check_train_supported(ExperimentConfig(
        generator=GeneratorConfig(refine_local_impl=setting)))
    with pytest.raises(ValueError, match="refine_local_impl"):
        DisPUGenerator(GeneratorConfig(refine_local_impl="pallas"))


@pytest.fixture(scope="module")
def small_variables():
    variables = _jit_init(JDisPUGenerator(cfg=JGeneratorConfig(**SMALL)),
                          jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 3), jnp.float32))
    return perturbed_numpy_tree(variables, 0, scale=0.05)


def _upsamplers(variables, setting, final_ratio):
    inf = dict(patch_num_point=64, patch_batch=4, final_ratio=final_ratio)
    jup = JPatchUpsampler(
        variables, gen_cfg=JGeneratorConfig(refine_local_impl=setting,
                                            **SMALL),
        inf_cfg=JInferenceConfig(**inf))
    tup = PatchUpsampler(
        variables, gen_cfg=GeneratorConfig(refine_local_impl=setting,
                                           **SMALL),
        inf_cfg=InferenceConfig(**inf), device="cpu")
    return jup, tup


@pytest.mark.parametrize("setting", SETTINGS)
def test_upsample_4x_matches_jax(small_variables, setting):
    """The refiner's n = 256 passes the 128 gate; the bounds of
    test_torch_inference.test_upsample_matches_jax, for its reasons."""
    jup, tup = _upsamplers(small_variables, setting, 4)
    pc = np.random.RandomState(1).randn(256, 3).astype(np.float32)
    got, want = tup.upsample(pc), np.asarray(jup.upsample(pc))
    assert got.shape == want.shape == (1024, 3)
    assert np.isfinite(got).all()
    _assert_close_as_clouds(got, want)


@pytest.mark.parametrize("setting", SETTINGS)
def test_upsample_16x_and_many_match_jax(small_variables, setting):
    """Pass 2's refiner takes n = 1024; the set bounds of
    tests/test_torch_stream.py, for its reasons."""
    jup, tup = _upsamplers(small_variables, setting, 16)
    pc = _clouds(1, 128)[0]
    got, want = tup.upsample(pc), np.asarray(jup.upsample(pc))
    assert got.shape == want.shape == (2048, 3)
    assert np.isfinite(got).all()
    _assert_same_cloud_16x(got, want)
    pcs = _clouds(2, 128)
    got, want = tup.upsample_many(pcs), np.asarray(jup.upsample_many(pcs))
    assert got.shape == want.shape == (2, 2048, 3)
    for v in range(2):
        _assert_same_cloud_16x(got[v], want[v])
