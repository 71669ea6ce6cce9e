"""The port's GAN training against the JAX package's, on the CPU.

The critic (forward and its paired neighbourhoods) on parameters
converted from flax, the LSGAN losses, one and two GAN steps from a JAX
``GANState`` carried over by ``convert.from_jax_gan_state``, the clip and
the ``gen_update`` game, the fake pool's draws, the GAN trainer with a
resume, and the CLI's ``--use_gan true`` train and test phases, on tiny
configurations.  Inputs are made with numpy and handed to both packages.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu import losses as JL
from dispu_tpu.config import DataConfig as JDataConfig
from dispu_tpu.config import DiscriminatorConfig as JDiscriminatorConfig
from dispu_tpu.config import ExperimentConfig as JExperimentConfig
from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import LossConfig as JLossConfig
from dispu_tpu.config import TrainConfig as JTrainConfig
from dispu_tpu.models.discriminator import PairedMSGModule as JPaired
from dispu_tpu.models.discriminator import PatchDiscriminator as JDisc
from dispu_tpu.models.discriminator import (
    paired_neighborhoods_with_pred_indices as jpaired)
from dispu_tpu.train.gan_steps import create_gan_state as jcreate_gan
from dispu_tpu.train.gan_steps import make_gan_train_step as jmake_gan
from dispu_tpu.utils.visu import PointPool as JPointPool
from dispu_tpu_torch import cli
from dispu_tpu_torch import losses as L
from dispu_tpu_torch.config import (DataConfig, DiscriminatorConfig,
                                    ExperimentConfig, GeneratorConfig,
                                    LossConfig, TrainConfig)
from dispu_tpu_torch.convert import from_flax_variables, from_jax_gan_state
from dispu_tpu_torch.data.dataset import PatchDataset
from dispu_tpu_torch.models.discriminator import (
    PairedMSGModule, PatchDiscriminator,
    paired_neighborhoods_with_pred_indices)
from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                             make_gan_train_step)
from dispu_tpu_torch.train.gan_trainer import GANTrainer
from dispu_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                              restore_checkpoint)
from dispu_tpu_torch.utils.visu import PointPool
from test_torch_generator import perturbed_numpy_tree
from test_torch_train import TINY, _assert_leaves, _leaf_map

torch.set_num_threads(1)


def _clouds(seed, b=2, n=128):
    """(gt, pred): a cloud and a displaced copy of it."""
    rng = np.random.RandomState(seed)
    gt = (rng.rand(b, n, 3).astype(np.float32) - 0.5)
    pred = gt + np.float32(0.03) * rng.randn(b, n, 3).astype(np.float32)
    return gt, pred


def _critic_variables(module, seed, n=128):
    dummy = jnp.zeros((1, n, 3), jnp.float32)
    variables = module.init(jax.random.PRNGKey(seed), dummy, dummy)
    return perturbed_numpy_tree(variables, seed)


# --------------------------------------------------------------- the critic


@pytest.mark.parametrize("knn,fused", [(True, False), (False, False),
                                       (True, True)],
                         ids=["knn", "ball", "fused_grouping"])
def test_critic_forward_matches_flax(knn, fused):
    """Patch values of the converted critic against flax's, to 1e-5 of
    their largest (f32 sums in other orders; observed ≤ 2.3e-7).  With
    ``fused_grouping`` the port takes the ``knn_group`` path, the JAX
    package on the CPU its composed one."""
    jcfg = JDiscriminatorConfig(knn=knn)
    variables = _critic_variables(JDisc(cfg=jcfg), 1)
    gt, pred = _clouds(2)
    want = np.asarray(JDisc(cfg=jcfg).apply(variables, jnp.asarray(pred),
                                            jnp.asarray(gt)))
    disc = from_flax_variables(PatchDiscriminator(DiscriminatorConfig(
        knn=knn, fused_grouping=fused)), variables)
    got = disc(torch.from_numpy(pred), torch.from_numpy(gt)).detach().numpy()
    assert got.shape == want.shape == (2, 16, 2, 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_paired_msg_fused_form_matches_flax():
    """The msg2 form (a fusion layer per scale) of the paired module."""
    jcfg = JDiscriminatorConfig()
    variables = _critic_variables(JPaired(cfg=jcfg, fused=True), 3)
    gt, pred = _clouds(4)
    jseeds, want = JPaired(cfg=jcfg, fused=True).apply(
        variables, jnp.asarray(gt), jnp.asarray(pred))
    module = from_flax_variables(
        PairedMSGModule(DiscriminatorConfig(), fused=True), variables)
    seeds, got = module(torch.from_numpy(gt), torch.from_numpy(pred))
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(jseeds))
    assert got.shape == (2, 16, 160)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_from_flax_variables_refuses_a_leftover_critic_leaf():
    variables = _critic_variables(JDisc(cfg=JDiscriminatorConfig()), 5)
    variables["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        from_flax_variables(PatchDiscriminator(), variables)


@pytest.mark.parametrize("knn,fused", [(True, False), (False, False),
                                       (True, True)],
                         ids=["knn", "ball", "fused_grouping"])
def test_paired_neighborhoods_bit_equal(knn, fused):
    """Seeds, every scale's pred indices and both halves' centred
    neighbourhoods bit-equal to the JAX package's."""
    gt, pred = _clouds(6)
    (jseeds, jscales), jidx = jpaired(JDiscriminatorConfig(knn=knn),
                                      jnp.asarray(gt), jnp.asarray(pred))
    (seeds, scales), idx = paired_neighborhoods_with_pred_indices(
        DiscriminatorConfig(knn=knn, fused_grouping=fused),
        torch.from_numpy(gt), torch.from_numpy(pred))
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(jseeds))
    for got, want in zip(idx, jidx):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for (g_gt, g_pred), (w_gt, w_pred) in zip(scales, jscales):
        np.testing.assert_array_equal(g_gt.numpy(), np.asarray(w_gt))
        np.testing.assert_array_equal(g_pred.numpy(), np.asarray(w_pred))


def test_lsgan_losses_match_jax():
    rng = np.random.RandomState(7)
    real, fake = (rng.randn(3, 16, 1).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(L.discriminator_loss(torch.from_numpy(real),
                                   torch.from_numpy(fake))),
        float(JL.discriminator_loss(jnp.asarray(real), jnp.asarray(fake))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(L.generator_loss(torch.from_numpy(fake))),
        float(JL.generator_loss(jnp.asarray(fake))), rtol=1e-6)


# ---------------------------------------------------------------- GAN steps


def _gan_cfgs(**train):
    """(JAX, port) GAN experiment configs of one tiny setting, the sparse
    inputs fed in and no augmentation (no random draws in a step)."""
    data = dict(num_point=32, random_input=False, augment=False)
    loss = dict(repulsion_nsample=8, repulsion_radius=0.3)
    train = dict(dict(batch_size=4), **train)
    j = JExperimentConfig(generator=JGeneratorConfig(**TINY),
                          train=JTrainConfig(**train),
                          data=JDataConfig(**data), loss=JLossConfig(**loss),
                          use_gan=True)
    t = ExperimentConfig(generator=GeneratorConfig(**TINY),
                         train=TrainConfig(**train), data=DataConfig(**data),
                         loss=LossConfig(**loss), use_gan=True)
    return j, t


@pytest.fixture(scope="module", params=[
    dict(), dict(d_clip=0.0, gen_update=2)], ids=["clip", "gen_update"])
def gan_pair(request):
    return make_gan_pair(**request.param)


def make_gan_pair(**train):
    """A perturbed JAX GANState, two JAX GAN steps from it (the raw step,
    jitted), and the port's state carried over from it."""
    jcfg, tcfg = _gan_cfgs(**train)
    js = jcreate_gan(jax.random.PRNGKey(0), jcfg)
    gen = perturbed_numpy_tree({"params": js.gen.params,
                                "batch_stats": js.gen.batch_stats}, 5)
    crit = perturbed_numpy_tree({"params": js.d_params}, 6)
    js = js.replace(
        gen=js.gen.replace(
            params=jax.tree_util.tree_map(jnp.asarray, gen["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               gen["batch_stats"])),
        d_params=jax.tree_util.tree_map(jnp.asarray, crit["params"]))
    rng = np.random.RandomState(1)
    gt = rng.randn(4, 128, 3).astype(np.float32) * 0.3
    inputs = gt[:, ::4].copy()
    radius = np.ones(4, np.float32)
    jstep = jax.jit(jmake_gan(jcfg, jit_compile=False))
    batch = (jnp.asarray(gt), jnp.asarray(inputs), jnp.asarray(radius))
    js1, jm1 = jstep(js, *batch, jax.random.PRNGKey(0))
    js2, jm2 = jstep(js1, *batch, jax.random.PRNGKey(0))
    ts = create_gan_state(tcfg, device="cpu")
    from_jax_gan_state(ts, jax.device_get(js))
    return dict(tcfg=tcfg, ts=ts, js=(js1, js2), jm=(jm1, jm2),
                batch=tuple(map(torch.from_numpy, (gt, inputs, radius))))


def _assert_adam_half(model, mu, nu, jparams, jmu, jnu, lr, i, sure_before,
                      what):
    """Moments to test_torch_train.py's bounds after step 1 (1e-4 and 2e-4
    of each leaf's largest) and five times them after step 2, whose
    gradient is taken at parameters that moved by ±lr where |g| was
    round-off, and passes through the updated critic (observed 1.1e-4);
    parameters to lr·3e-3 a step where both moments agreed to 1e-3
    relative at every step so far (Adam's update is about sign(g)·lr,
    noise where |g| is round-off), which must be ≥ 99% of them."""
    grow = 1 if i == 0 else 5
    _assert_leaves({k: v.numpy() for k, v in mu.items()}, jmu, 1e-4 * grow,
                   f"{what} mu")
    _assert_leaves({k: v.numpy() for k, v in nu.items()}, jnu, 2e-4 * grow,
                   f"{what} nu")
    n_sure = n_all = 0
    for n, p in model.named_parameters():
        sure = ((np.abs(mu[n].numpy() - jmu[n]) <= 1e-3 * np.abs(jmu[n]))
                & (np.abs(nu[n].numpy() - jnu[n]) <= 1e-3 * np.abs(jnu[n]))
                & sure_before.get(n, True))
        sure_before[n] = sure
        err = np.abs(p.detach().numpy() - jparams[n])[sure]
        assert err.size == 0 or float(err.max()) <= 3e-3 * lr * (i + 1), \
            f"{what} {n}"
        n_sure, n_all = n_sure + int(sure.sum()), n_all + sure.size
    assert n_sure >= 0.99 * n_all, what


def test_gan_steps_match_jax(gan_pair):
    """Two GAN steps from the same state on the same batch, against the
    JAX package's: every metric to 1e-5 relative or 2e-6 of the largest
    metric (the critic's gap and the repulsion term lie near zero;
    observed ≤ 2e-7 of the largest); both networks' moments
    and parameters as the CD test holds them.  With ``d_clip`` the
    critic's parameters stay within ±clip and the share at the boundary
    matches; in the ``gen_update`` game the critic trains at step 0 and
    holds at step 1."""
    tcfg, ts, batch = gan_pair["tcfg"], gan_pair["ts"], gan_pair["batch"]
    step = make_gan_train_step(tcfg, device="cpu")
    sure_g, sure_d = {}, {}
    for i, (js, jm) in enumerate(zip(gan_pair["js"], gan_pair["jm"])):
        d_before = {n: p.detach().clone()
                    for n, p in ts.disc.named_parameters()}
        ts, tm = step(ts, *batch, torch.Generator())
        assert ts.step == i + 1 and ts.gen.count == i + 1
        assert set(tm) == set(jm)
        top = max(abs(float(v)) for v in jm.values())
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=2e-6 * top, err_msg=k)
        _assert_adam_half(ts.gen.model, ts.gen.mu, ts.gen.nu,
                          _leaf_map(js.gen.params),
                          _leaf_map(js.gen.opt_state.mu),
                          _leaf_map(js.gen.opt_state.nu),
                          float(tm["lr"]), i, sure_g, "generator")
        _assert_adam_half(ts.disc, ts.d_mu, ts.d_nu, _leaf_map(js.d_params),
                          _leaf_map(js.d_opt_state.mu),
                          _leaf_map(js.d_opt_state.nu),
                          tcfg.train.base_lr_d, i, sure_d, "critic")
        assert ts.d_count == int(js.d_opt_state.count)
        moved = any(not torch.equal(d_before[n], p)
                    for n, p in ts.disc.named_parameters())
        clip = tcfg.train.d_clip
        if clip > 0:
            assert moved
            assert all(float(p.detach().abs().max()) <= clip
                       for p in ts.disc.parameters())
            n_at = sum(int((p.abs() >= clip * (1 - 1e-6)).sum())
                       for p in ts.disc.parameters())
            n_d = sum(p.numel() for p in ts.disc.parameters())
            assert float(tm["d_clip_frac"]) == np.float32(n_at) / n_d > 0.1
        else:
            assert moved == (i == 0) and ts.d_count == 1
            assert float(tm["d_clip_frac"]) == 0.0


def test_clip_leaves_the_critic_moments_alone():
    """``d_clip`` clips the critic's parameters, not its Adam moments: the
    moments equal an unclipped update's on the same gradients."""
    _, tcfg = _gan_cfgs()
    gt = torch.from_numpy(_clouds(8, 4)[0])
    runs = {}
    for clip in (0.01, 1e9):
        cfg = dataclasses.replace(
            tcfg, train=dataclasses.replace(tcfg.train, d_clip=clip),
            data=dataclasses.replace(tcfg.data, random_input=True))
        st = create_gan_state(cfg, device="cpu")
        make_gan_train_step(cfg, device="cpu")(
            st, gt, torch.ones(4), torch.Generator().manual_seed(0))
        runs[clip] = st
    for n in runs[0.01].d_mu:
        assert torch.equal(runs[0.01].d_mu[n], runs[1e9].d_mu[n])
        assert torch.equal(runs[0.01].d_nu[n], runs[1e9].d_nu[n])
    assert max(float(v.abs().max()) for v in runs[0.01].d_mu.values()) > 0
    assert any(not torch.equal(p, q) for p, q in zip(
        runs[0.01].disc.parameters(), runs[1e9].disc.parameters()))


def test_generator_loss_never_moves_the_critic():
    """After a step the critic's gradients are its own loss's: the
    generator's backward ran with the critic frozen."""
    _, tcfg = _gan_cfgs(d_clip=0.0, gen_update=1)
    gt, _ = _clouds(9, 4)
    st = create_gan_state(tcfg, device="cpu")
    inputs = torch.from_numpy(gt[:, ::4].copy())
    disc_grads = []
    real_backward = torch.Tensor.backward

    def spy(self, *a, **kw):
        real_backward(self, *a, **kw)
        disc_grads.append({n: None if p.grad is None else p.grad.clone()
                           for n, p in st.disc.named_parameters()})

    torch.Tensor.backward = spy
    try:
        make_gan_train_step(tcfg, device="cpu")(
            st, torch.from_numpy(gt), inputs, torch.ones(4),
            torch.Generator())
    finally:
        torch.Tensor.backward = real_backward
    assert len(disc_grads) == 2  # the critic's backward, the generator's
    for n in disc_grads[0]:
        assert disc_grads[0][n] is not None
        assert torch.equal(disc_grads[0][n], disc_grads[1][n]), n


def test_point_pool_sequence_matches_jax():
    jpool = JPointPool(3, rng=np.random.RandomState(5))
    pool = PointPool(3, rng=np.random.RandomState(5))
    rng = np.random.RandomState(6)
    for _ in range(12):
        x = rng.randn(2, 8, 3).astype(np.float32)
        np.testing.assert_array_equal(pool.query(x), jpool.query(x))
    for a, b in zip(pool.points, jpool.points):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- trainer and CLI


def _trainer_cfg(log_dir, **train):
    _, tcfg = _gan_cfgs()
    train = dict(dict(batch_size=4, epoch_per_save=1, steps_per_print=2),
                 **train)
    return dataclasses.replace(
        tcfg, train=TrainConfig(**train),
        data=dataclasses.replace(tcfg.data, random_input=True, augment=True),
        log_dir=str(log_dir))


@pytest.mark.parametrize("train,warning", [
    (dict(), "WARNING: d_clip=0.01"),
    (dict(d_clip=0.0, fake_pool_size=2), "balanced game"),
], ids=["clip", "pool"])
def test_gan_trainer_runs_and_resumes(tmp_path, train, warning):
    """One epoch, then a resume for a second; the checkpoint restores both
    networks and both sets of moments bit-equal."""
    cfg = _trainer_cfg(tmp_path, **train)
    ds = PatchDataset(h5_path="/nonexistent", synthetic_patches_count=8,
                      num_point=32)
    state = GANTrainer(cfg, dataset=ds, device="cpu").train(epochs=1)
    assert state.epoch == 1.0 and state.step == 2
    epoch, path = latest_checkpoint(str(tmp_path))
    assert epoch == 1
    back = restore_checkpoint(path, create_gan_state(cfg, seed=9,
                                                     device="cpu"))
    for mine, theirs in ((state.gen.model, back.gen.model),
                         (state.disc, back.disc)):
        for (n, a), (_, b) in zip(mine.state_dict().items(),
                                  theirs.state_dict().items()):
            assert torch.equal(a, b), n
    for n in state.d_mu:
        assert torch.equal(state.d_mu[n], back.d_mu[n])
        assert torch.equal(state.d_nu[n], back.d_nu[n])
    assert (back.d_count, back.gen.count, back.step) == (
        state.d_count, state.gen.count, 2)
    resumed = GANTrainer(cfg, dataset=ds, device="cpu").train(restore=True,
                                                              epochs=2)
    assert resumed.epoch == 2.0 and resumed.step == 4
    lines = open(tmp_path / "log_train.txt").read().splitlines()
    assert sum(warning in ln for ln in lines) == 2  # one a trainer
    epochs = [ln.split()[1] for ln in lines if ln.startswith("epoch")]
    assert epochs == ["0001", "0002"]
    assert all(k in lines[-1] for k in ("d_loss=", "g_gan=", "d_gap=",
                                         "d_clip_frac="))


def test_gan_trainer_rejects_the_pool_with_a_mesh(tmp_path):
    cfg = _trainer_cfg(tmp_path, fake_pool_size=2)
    with pytest.raises(ValueError, match="single-device"):
        GANTrainer(cfg, device="cpu", mesh=object())


def test_cli_gan_train_then_test_restores_the_generator_half(tmp_path):
    """``--phase train --use_gan true`` on synthetic patches writes a GAN
    checkpoint; ``--phase test`` on that log dir restores its generator
    half and writes what ``PatchUpsampler.upsample`` gives with it."""
    from dispu_tpu_torch.evaluation.meshio import read_xyz, write_xyz
    from dispu_tpu_torch.inference import PatchUpsampler

    log = str(tmp_path / "log")
    common = ["--use_gan", "true", "--device", "cpu", "--log_dir", log,
              "--patch_num_point", "32"]
    cli.main(["--phase", "train", "--synthetic", "8", "--batch_size", "4",
              "--epochs", "1", "--d_clip", "0"] + common)
    epoch, path = latest_checkpoint(log)
    assert epoch == 1
    saved = torch.load(path, weights_only=True)
    assert {"gen", "disc", "d_mu", "d_nu", "d_count"} <= set(saved)
    (tmp_path / "in").mkdir()
    pc = np.random.RandomState(3).randn(128, 3).astype(np.float32)
    write_xyz(str(tmp_path / "in" / "a.xyz"), pc)
    argv = ["--phase", "test", "--test_data", str(tmp_path / "in" / "*.xyz"),
            "--out_folder", str(tmp_path / "out"), "--patch_batch",
            "8"] + common
    cli.main(argv)
    cfg = cli.build_config(cli.parse_args(argv))
    up = PatchUpsampler(gen_cfg=cfg.generator, inf_cfg=cfg.inference,
                        device="cpu")
    up.model.load_state_dict(saved["gen"]["model"])
    out = up.upsample(read_xyz(str(tmp_path / "in" / "a.xyz")))
    assert out.shape == (128 * 4, 3)
    write_xyz(str(tmp_path / "want.xyz"), out)
    assert ((tmp_path / "out" / "a_X4.xyz").read_bytes()
            == (tmp_path / "want.xyz").read_bytes())
    assert os.path.exists(os.path.join(log, "log_train.txt"))
