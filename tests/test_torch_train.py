"""The port's CD training against the JAX package's, on the CPU.

Batch norm in training mode against flax, Adam against
``optax.scale_by_adam``, the data and its draws (the JAX package's own
random draws injected into the port's inner functions), one full train
step and a second one from a JAX state carried over by
``convert.from_jax_state``, the eval step, and the trainer's loop, logs
and checkpoints on a tiny configuration.
"""

import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dispu_tpu.config import DataConfig as JDataConfig
from dispu_tpu.config import ExperimentConfig as JExperimentConfig
from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import LossConfig as JLossConfig
from dispu_tpu.config import TrainConfig as JTrainConfig
from dispu_tpu.data import augment as jaug
from dispu_tpu.data.dataset import synthetic_patches as jsynthetic
from dispu_tpu.train.state import create_generator_state as jcreate_state
from dispu_tpu.train.steps import make_eval_step as jmake_eval
from dispu_tpu.train.steps import make_train_step as jmake_step
from dispu_tpu_torch.config import (DataConfig, ExperimentConfig,
                                    GeneratorConfig, LossConfig, TrainConfig,
                                    check_train_supported)
from dispu_tpu_torch.convert import _leaves, _torch_key, from_jax_state
from dispu_tpu_torch.data import augment as taug
from dispu_tpu_torch.data.dataset import PatchDataset, synthetic_patches
from dispu_tpu_torch.nn.layers import BatchNorm
from dispu_tpu_torch.train.state import (GeneratorState, adam_update,
                                         create_generator_state)
from dispu_tpu_torch.train.steps import make_eval_step, make_train_step
from dispu_tpu_torch.train.trainer import Trainer
from dispu_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                              restore_checkpoint,
                                              save_checkpoint)
from test_torch_generator import perturbed_numpy_tree

torch.set_num_threads(1)

TINY = dict(num_points=32, knn=8, refine_nsample=8)


def _cfgs(generator=None, **data):
    """(JAX, port) experiment configs of one tiny setting; ``generator``
    holds further GeneratorConfig fields."""
    data = dict(dict(num_point=32), **data)
    gen = dict(TINY, **(generator or {}))
    loss = dict(repulsion_nsample=8, repulsion_radius=0.3)
    j = JExperimentConfig(generator=JGeneratorConfig(**gen),
                          train=JTrainConfig(batch_size=4),
                          data=JDataConfig(**data), loss=JLossConfig(**loss))
    t = ExperimentConfig(generator=GeneratorConfig(**gen),
                         train=TrainConfig(batch_size=4),
                         data=DataConfig(**data), loss=LossConfig(**loss))
    return j, t


# ---------------------------------------------------------------- layers


def test_batchnorm_training_matches_flax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 10, 6, 5) * 2 + 1).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
              "bias": rng.randn(5).astype(np.float32)}
    stats = {"mean": rng.randn(5).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.95,
                       epsilon=1e-3)

    def f(p, xx):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    tbn = BatchNorm(5, momentum=0.95)
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(tbn, k).copy_(torch.from_numpy(v))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tbn.train()(tx)
    torch.sum(ty * torch.from_numpy(w)).backward()
    # f32 sums over 180 rows in another order: 1e-6 relative
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(),
                                   np.asarray(jstats[k]), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(tbn, k).grad.numpy(),
                                   np.asarray(jgp[k]), rtol=1e-5, atol=1e-4)
    # eval mode normalizes with the running statistics, which moved
    y_eval = tbn.eval()(torch.from_numpy(x))
    assert not torch.allclose(y_eval, ty.detach())


def test_adam_matches_optax_bit_equal():
    """Three updates of ``optax.scale_by_adam`` then ``p − lr·u`` on the
    same gradients: every moment and parameter bit-equal."""
    rng = np.random.RandomState(1)
    model = torch.nn.Linear(6, 9)
    names = [n for n, _ in model.named_parameters()]
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    state = GeneratorState(model=model,
                           mu={n: torch.zeros_like(p) for n, p in
                               model.named_parameters()},
                           nu={n: torch.zeros_like(p) for n, p in
                               model.named_parameters()})
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jopt = tx.init(jparams)
    lr = 1e-3
    for i in range(3):
        grads = {n: (rng.randn(*params[n].shape)
                     * 10.0 ** rng.uniform(-8, 1, params[n].shape)
                     ).astype(np.float32) for n in names}
        grads["bias"][0] = 0.0
        u, jopt = tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                            jopt)
        jparams = {n: jparams[n] - jnp.float32(lr) * u[n] for n in names}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        adam_update(state, lr, TrainConfig())
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(state.mu[n].numpy(),
                                          np.asarray(jopt.mu[n]))
            np.testing.assert_array_equal(state.nu[n].numpy(),
                                          np.asarray(jopt.nu[n]))
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(jparams[n]))
    assert state.count == int(jopt.count) == 3


# ------------------------------------------------------------------ data


def test_synthetic_patches_bit_equal():
    for got, want in zip(synthetic_patches(3, 200, seed=4),
                         jsynthetic(3, 200, seed=4)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_nonuniform_sampling_with_jax_draws():
    gt = np.random.RandomState(2).randn(3, 128, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jaug.sample_nonuniform_inputs(key, jnp.asarray(gt), 32)
    loc_u, noise = [], []
    for k in jax.random.split(key, 3):  # as the JAX function splits
        k_loc, k_gumbel = jax.random.split(k)
        loc_u.append(np.asarray(jax.random.uniform(k_loc)))
        noise.append(np.asarray(jax.random.gumbel(k_gumbel, (128,))))
    got = taug.sample_nonuniform_inputs_from(
        torch.from_numpy(gt), 32, torch.from_numpy(np.stack(loc_u)),
        torch.from_numpy(np.stack(noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cluster_sampling_with_jax_draws():
    gt = np.random.RandomState(3).randn(2, 96, 3).astype(np.float32)
    gt[:, 50:60] = gt[:, :10]  # tied distances inside the clusters
    key = jax.random.PRNGKey(6)
    want = jaug.sample_cluster_inputs(key, jnp.asarray(gt), 32, 4)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (96,)))
                      for k in jax.random.split(key, 2)])
    got = taug.sample_cluster_inputs_from(torch.from_numpy(gt), 32, 4,
                                          torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_with_jax_draws():
    rng = np.random.RandomState(4)
    inputs = rng.randn(3, 32, 3).astype(np.float32)
    gt = rng.randn(3, 128, 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want_in, want_gt = jaug.augment_batch(key, jnp.asarray(inputs),
                                          jnp.asarray(gt))
    kj, kr, ks = jax.random.split(key, 3)  # as the JAX function splits
    normal = np.array(jax.random.normal(kj, inputs.shape))
    angle = np.array(jax.random.uniform(kr, (3,)) * 2.0 * jnp.pi)
    scale = np.array(jax.random.uniform(ks, (3, 1, 1), minval=0.8,
                                        maxval=1.2))
    got_in, got_gt = taug.augment_batch_from(
        torch.from_numpy(inputs), torch.from_numpy(gt),
        torch.from_numpy(normal), torch.from_numpy(angle),
        torch.from_numpy(scale))
    # the 3-term rotation products may round differently in XLA and
    # PyTorch: 2 f32 ulps of the coordinates' scale
    for got, want in ((got_in, want_in), (got_gt, want_gt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2.5e-7 * float(np.abs(want).max()))


# ------------------------------------------------------------ train step


def _leaf_map(tree):
    """A params-shaped JAX tree as {port parameter name: array}."""
    out = {}
    for path, leaf in _leaves(jax.device_get(tree)):
        key, transpose = _torch_key(path)
        out[key] = np.asarray(leaf).T if transpose else np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def step_pair():
    return make_step_pair()


def make_step_pair(generator=None):
    """A perturbed JAX state, two JAX steps from it (the raw step,
    jitted), and the port's state carried over from it; ``generator``
    holds further GeneratorConfig fields of both packages."""
    jcfg, tcfg = _cfgs(generator, random_input=False, augment=False)
    js = jcreate_state(jax.random.PRNGKey(0), jcfg.generator, jcfg.train)
    tree = perturbed_numpy_tree({"params": js.params,
                                 "batch_stats": js.batch_stats}, 5)
    js = js.replace(
        params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"]))
    rng = np.random.RandomState(1)
    gt = rng.randn(4, 128, 3).astype(np.float32) * 0.3
    inputs = gt[:, ::4].copy()
    radius = np.ones(4, np.float32)
    jstep = jax.jit(jmake_step(jcfg, jit_compile=False))
    batch = (jnp.asarray(gt), jnp.asarray(inputs), jnp.asarray(radius))
    js1, jm1 = jstep(js, *batch, jax.random.PRNGKey(0))
    js2, jm2 = jstep(js1, *batch, jax.random.PRNGKey(0))
    ts = create_generator_state(tcfg.generator, device="cpu")
    from_jax_state(ts, jax.device_get(js))
    return dict(tcfg=tcfg, ts=ts, js=(js1, js2), jm=(jm1, jm2),
                batch=tuple(map(torch.from_numpy, (gt, inputs, radius))))


def _assert_leaves(got: dict, want: dict, rel: float, what: str):
    """Each leaf within ``rel`` of its own largest entry, with a floor at
    ``rel`` of the largest entry of all (a dense bias ahead of batch norm
    has a gradient that vanishes in exact arithmetic: round-off only)."""
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        bound = rel * max(float(np.abs(w).max()), 1e-3 * top)
        err = float(np.abs(got[k] - w).max())
        assert err <= bound, f"{what} {k}: {err} > {bound}"


def test_train_step_matches_jax(step_pair):
    """Two steps from the same state on the same batch.  Metrics to 1e-5
    relative (observed ≤ 2.5e-6: f32 sums in other orders); gradients,
    read from the JAX step's first moments (mu = 0.1·g after one step),
    and both moments to 1e-4 of each leaf's largest entry; the batch-norm
    statistics to 1e-6 after step 1 and 1e-3 after step 2 (step 2's
    forward runs on parameters that moved by ±lr where |g| was round-off,
    see below).  Adam's update is about ``sign(g)·lr``, so where
    |g| is at round-off level its sign is noise: parameters are held to
    lr·3e-3 a step where both moments agreed to 1e-3 relative at every
    step so far (u = mu/sqrt(nu) then agrees to ~2e-3 of |u| ≲ 1), which
    must be ≥ 99% of them."""
    check_steps_match_jax(step_pair)


def check_steps_match_jax(step_pair):
    """The assertions of :func:`test_train_step_matches_jax` on a
    :func:`make_step_pair`."""
    tcfg, ts, batch = step_pair["tcfg"], step_pair["ts"], step_pair["batch"]
    step = make_train_step(tcfg, device="cpu")
    model = ts.model
    sure_before = {}
    for i, (js, jm) in enumerate(zip(step_pair["js"], step_pair["jm"])):
        ts, tm = step(ts, *batch, torch.Generator())
        assert ts.step == i + 1 and ts.count == i + 1
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        jmu, jnu = _leaf_map(js.opt_state.mu), _leaf_map(js.opt_state.nu)
        grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
        if i == 0:
            _assert_leaves(grads, {k: v / np.float32(0.1)
                                   for k, v in jmu.items()}, 1e-4, "grad")
        _assert_leaves({k: v.numpy() for k, v in ts.mu.items()}, jmu, 1e-4,
                       "mu")
        _assert_leaves({k: v.numpy() for k, v in ts.nu.items()}, jnu, 2e-4,
                       "nu")
        buffers = dict(model.named_buffers())
        bn_tol = 1e-6 if i == 0 else 1e-3
        for path, leaf in _leaves(jax.device_get(js.batch_stats)):
            np.testing.assert_allclose(buffers[".".join(path)].numpy(),
                                       np.asarray(leaf), rtol=bn_tol,
                                       atol=bn_tol)
        jparams = _leaf_map(js.params)
        n_sure = n_all = 0
        for n, p in model.named_parameters():
            sure = ((np.abs(ts.mu[n].numpy() - jmu[n])
                     <= 1e-3 * np.abs(jmu[n]))
                    & (np.abs(ts.nu[n].numpy() - jnu[n])
                       <= 1e-3 * np.abs(jnu[n]))
                    & sure_before.get(n, True))
            sure_before[n] = sure
            err = np.abs(p.detach().numpy() - jparams[n])[sure]
            assert err.size == 0 or float(err.max()) <= 3e-6 * (i + 1), n
            n_sure, n_all = n_sure + int(sure.sum()), n_all + sure.size
        assert n_sure >= 0.99 * n_all


def test_eval_step_matches_jax(step_pair):
    jcfg, tcfg = _cfgs(random_input=False, augment=False)
    js1 = step_pair["js"][0]
    gt, inputs, radius = step_pair["batch"]
    jc, jf, jm = jmake_eval(jcfg)(js1.variables(), jnp.asarray(inputs.numpy()),
                                  jnp.asarray(gt.numpy()),
                                  jnp.asarray(radius.numpy()))
    ts = create_generator_state(tcfg.generator, device="cpu")
    from_jax_state(ts, jax.device_get(js1))
    tc, tf, tm = make_eval_step(tcfg, device="cpu")(ts.model, inputs, gt,
                                                     radius)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


def test_from_jax_state_raises_on_leftover_or_missing_leaf(step_pair):
    js1 = jax.device_get(step_pair["js"][0])
    ts = create_generator_state(step_pair["tcfg"].generator, device="cpu")
    opt = js1.opt_state
    extra = dict(opt.mu, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        from_jax_state(ts, dict(params=js1.params,
                                batch_stats=js1.batch_stats,
                                opt_state=dict(mu=extra, nu=opt.nu,
                                               count=opt.count),
                                epoch=js1.epoch, step=js1.step))
    fewer = {k: v for k, v in opt.nu.items() if k != "PointShuffle"}
    with pytest.raises(ValueError, match="unfilled"):
        from_jax_state(ts, dict(params=js1.params,
                                batch_stats=js1.batch_stats,
                                opt_state=dict(mu=opt.mu, nu=fewer,
                                               count=opt.count),
                                epoch=js1.epoch, step=js1.step))


def test_random_input_step_runs_and_learns():
    """The default input mode (a nonuniform draw, augmentation on) on a
    fixed batch: the loss falls over 8 steps."""
    _, tcfg = _cfgs()
    ts = create_generator_state(tcfg.generator, device="cpu")
    step = make_train_step(tcfg, device="cpu")
    gt = torch.from_numpy(synthetic_patches(4, 128, seed=1)[1])
    gen = torch.Generator().manual_seed(0)
    totals = [float(step(ts, gt, torch.ones(4), gen)[1]["total"])
              for _ in range(8)]
    assert np.isfinite(totals).all() and totals[-1] < totals[0]


# --------------------------------------------------------------- trainer


def _trainer_cfg(log_dir, **train):
    _, tcfg = _cfgs()
    train = dict(dict(batch_size=4, epoch_per_save=1, steps_per_print=2),
                 **train)
    return dataclasses.replace(tcfg, train=TrainConfig(**train),
                               log_dir=str(log_dir))


def _dataset():
    return PatchDataset(h5_path="/nonexistent", synthetic_patches_count=12,
                        num_point=32)


def test_trainer_runs_logs_and_checkpoints(tmp_path):
    cfg = _trainer_cfg(tmp_path)
    state = Trainer(cfg, dataset=_dataset(), device="cpu").train(epochs=2)
    assert state.epoch == 2.0 and state.step == 6  # 3 batches an epoch
    names = set(os.listdir(tmp_path))
    assert {"args.txt", "scalars.jsonl", "log_train.txt",
            "code_manifest.txt", "model-2.pt"} <= names
    lines = open(tmp_path / "log_train.txt").read().splitlines()
    assert [ln.split()[1] for ln in lines] == ["0001", "0002"]
    assert len(open(tmp_path / "scalars.jsonl").readlines()) == 3
    # restore: parameters, statistics and moments bit-equal
    epoch, path = latest_checkpoint(str(tmp_path))
    assert epoch == 2
    fresh = create_generator_state(cfg.generator, seed=9, device="cpu")
    restore_checkpoint(path, fresh)
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n in state.mu:
        assert torch.equal(state.mu[n], fresh.mu[n])
        assert torch.equal(state.nu[n], fresh.nu[n])
    assert (fresh.count, fresh.epoch, fresh.step) == (6, 2.0, 6)
    # train(restore=True) resumes at epoch 2 and runs one more epoch
    resumed = Trainer(cfg, dataset=_dataset(), device="cpu").train(
        restore=True, epochs=3)
    assert resumed.epoch == 3.0 and resumed.step == 9
    assert latest_checkpoint(str(tmp_path))[0] == 3


def test_checkpoint_round_trip_bit_equal(tmp_path):
    _, tcfg = _cfgs()
    a = create_generator_state(tcfg.generator, seed=1, device="cpu")
    for v in a.mu.values():
        v.normal_()
    a.count, a.epoch, a.step = 5, 3.0, 17
    path = save_checkpoint(str(tmp_path), a, 3)
    b = restore_checkpoint(path, create_generator_state(
        tcfg.generator, seed=2, device="cpu"))
    for n, p in a.model.state_dict().items():
        assert torch.equal(p, b.model.state_dict()[n])
    assert all(torch.equal(a.mu[n], b.mu[n]) for n in a.mu)
    assert (b.count, b.epoch, b.step) == (5, 3.0, 17)


@pytest.mark.parametrize("change", [
    # GAN training and the fake pool are ported; with a turbo flag they
    # still raise
    dict(use_gan=True, generator=dict(fast_gather=True)),
    dict(train=dict(fake_pool_size=4), generator=dict(dense_impl="split")),
    dict(train=dict(remat=True)), dict(train=dict(compute_dtype="bfloat16")),
    dict(train=dict(visualize=True)), dict(train=dict(profile=True)),
    dict(mesh=dict(num_devices=2)), dict(generator=dict(fast_knn=True)),
    dict(generator=dict(fused_grouping=True, fast_gather_backbone=True)),
], ids=["use_gan", "fake_pool", "remat", "bf16", "visualize", "profile",
        "mesh", "turbo", "fused_with_turbo"])
def test_unported_training_settings_raise(change):
    _, cfg = _cfgs()
    fields = {}
    for name, value in change.items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, name), **value)
        fields[name] = value
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_train_supported(dataclasses.replace(cfg, **fields))


@pytest.mark.parametrize("change", [
    dict(use_gan=True), dict(train=dict(fake_pool_size=4)),
    dict(generator=dict(fused_grouping=True)),
    dict(generator=dict(gather_impl="pallas")),
    dict(use_gan=True, generator=dict(fused_grouping=True),
         discriminator=dict(fused_grouping=True)),
], ids=["use_gan", "fake_pool", "fused_grouping", "pallas_gather",
        "gan_fused"])
def test_ported_training_settings_pass(change):
    _, cfg = _cfgs()
    fields = {}
    for name, value in change.items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, name), **value)
        fields[name] = value
    check_train_supported(dataclasses.replace(cfg, **fields))


def test_training_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device path is moot")
    cfg = _trainer_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, dataset=_dataset())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        Trainer(cfg, dataset=_dataset(), device="cpu", mesh=object())
