"""GAN-variant training: the LSGAN critic and the generator in one step
(counterpart of ``train/gan_steps.py``).

One step, in this order, as the JAX package runs it:

* the input draw and augmentation, then ONE generator forward in training
  mode; its output, detached, feeds the critic's update, and the same
  graph carries the generator's loss back;
* the critic's geometry (FPS seeds, per-scale neighbour indices, the gt
  gathers) computed once, without a gradient; the generator's pass
  gathers only the pred neighbourhoods again, from the differentiable
  ``fine`` at the same indices (``regather_pred``);
* the critic's update first: LSGAN loss on its paired real/fake values,
  Adam at the constant rate ``base_lr_d``, then with ``d_clip`` > 0 its
  parameters (never its Adam moments) clipped to ±``d_clip``, reporting
  ``d_clip_frac``, the share of parameters at ``|p| ≥ clip·(1 − 1e-6)``.
  With ``d_clip == 0`` and ``gen_update`` > 1 the critic trains only on
  steps where ``step % gen_update == 0``; on the others its loss and
  metrics come from a forward without an update;
* then the generator, scored by the UPDATED critic: ``pu_losses`` plus the
  LSGAN generator loss; its backward runs with the critic's parameters
  frozen, so the generator's loss never reaches the critic's gradients,
  parameters or moments.  ``uniform`` (×10) is logged, not added.

With ``fake_pool_size`` > 0 the critic trains on a batch from a
:class:`~dispu_tpu_torch.utils.visu.PointPool` history of generator
outputs (a host round trip: the detached output goes to the host, the
pooled batch comes back), with its own geometry; the generator is scored
against the current output.  On the card the step runs under
deterministic algorithms (``train.steps.deterministic``).  The state is
updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from dispu_tpu_torch import losses as L
from dispu_tpu_torch.config import ExperimentConfig, check_train_supported
from dispu_tpu_torch.data.augment import augment_batch, sample_training_inputs
from dispu_tpu_torch.inference import pin_f32, resolve_device
from dispu_tpu_torch.models.discriminator import (
    PatchDiscriminator, paired_neighborhoods,
    paired_neighborhoods_with_pred_indices, regather_pred, split_real_fake)
from dispu_tpu_torch.train.state import (GeneratorState, adam_step,
                                         adam_update, create_generator_state)
from dispu_tpu_torch.train.steps import deterministic


@dataclasses.dataclass
class GANState:
    gen: GeneratorState
    disc: PatchDiscriminator
    d_mu: Dict[str, torch.Tensor]   # the critic's Adam moments
    d_nu: Dict[str, torch.Tensor]
    d_count: int = 0                # the critic's Adam updates so far

    @property
    def model(self):
        """The generator (what a test phase restores)."""
        return self.gen.model

    @property
    def epoch(self) -> float:
        return self.gen.epoch

    @property
    def step(self) -> int:
        return self.gen.step

    def next_epoch(self) -> "GANState":
        self.gen.next_epoch()
        return self

    def state_dict(self) -> dict:
        return {"gen": self.gen.state_dict(), "disc": self.disc.state_dict(),
                "d_mu": dict(self.d_mu), "d_nu": dict(self.d_nu),
                "d_count": self.d_count}

    def load_state_dict(self, saved: dict) -> "GANState":
        if "gen" not in saved:
            raise ValueError("not a GAN checkpoint: no generator half")
        self.gen.load_state_dict(saved["gen"])
        self.disc.load_state_dict(saved["disc"])
        with torch.no_grad():
            for mine, theirs in ((self.d_mu, saved["d_mu"]),
                                 (self.d_nu, saved["d_nu"])):
                if set(mine) != set(theirs):
                    raise ValueError("saved critic moments do not match the "
                                     "critic's parameters")
                for name, value in theirs.items():
                    mine[name].copy_(value)
        self.d_count = int(saved["d_count"])
        return self


def create_gan_state(cfg: ExperimentConfig, seed: int = 0,
                     impl: str = "auto", device="cuda") -> GANState:
    """The port's seeded init of the generator (``seed``) and the critic
    (``seed`` + 1) on ``device``, zero moments, epoch and step 0."""
    gen = create_generator_state(cfg.generator, seed=seed, impl=impl,
                                 device=device)
    disc = PatchDiscriminator(cfg.discriminator, impl=impl,
                              seed=seed + 1).to(device)
    zeros = {n: torch.zeros_like(p) for n, p in disc.named_parameters()}
    return GANState(gen=gen, disc=disc, d_mu=zeros,
                    d_nu={n: torch.zeros_like(v) for n, v in zeros.items()})


def make_gan_train_step(cfg: ExperimentConfig, device="cuda",
                        impl: str = "auto", fake_pool=None):
    """The GAN train step on ``device`` ('cuda' by default; 'cpu' runs the
    kernels' plain versions).  ``impl`` routes the kernels of the losses
    and of the critic's geometry.  The signature follows the input mode as
    the CD step's does (``train.steps.make_train_step``):
    ``step(state, gt, radius, generator)`` with ``random_input``, else
    ``step(state, gt, inputs, radius, generator)``.  ``fake_pool``: an
    optional :class:`~dispu_tpu_torch.utils.visu.PointPool`.  Returns
    ``(state, metrics)``."""
    check_train_supported(cfg)
    dev = resolve_device(device)
    pin_f32()
    n_in = cfg.generator.num_points
    dcfg, clip = cfg.discriminator, cfg.train.d_clip
    gen_update = cfg.train.gen_update

    def critic(state, fake, gt, groups):
        values = state.disc(fake, gt, groups=groups)
        real, fake_v = split_real_fake(values)
        aux = (torch.mean(real), torch.mean(fake_v),
               torch.var(values, unbiased=False))
        return L.discriminator_loss(real, fake_v), aux

    def critic_update(state, lr_d, fake, gt, groups):
        """The critic's loss and metrics, and its update unless this is a
        hold step of the ``gen_update`` game; returns (loss, aux,
        d_clip_frac)."""
        disc = state.disc
        disc.zero_grad(set_to_none=True)
        no_clip_frac = torch.zeros((), dtype=torch.float32, device=dev)
        if (clip == 0 and gen_update > 1
                and state.gen.step % gen_update != 0):
            with torch.no_grad():
                d_loss, aux = critic(state, fake, gt, groups)
            return d_loss, aux, no_clip_frac
        d_loss, aux = critic(state, fake, gt, groups)
        d_loss.backward()
        state.d_count += 1
        adam_step(disc.named_parameters(), state.d_mu, state.d_nu,
                  state.d_count, lr_d, cfg.train.beta1, clip=clip)
        if clip <= 0:
            return d_loss, aux, no_clip_frac
        with torch.no_grad():
            at = sum(torch.sum(torch.abs(p) >= clip * (1 - 1e-6))
                     for p in disc.parameters())
            n_d = sum(p.numel() for p in disc.parameters())
            return d_loss, aux, at.to(torch.float32) / n_d

    def step_core(state: GANState, gt, inputs, radius, generator):
        if cfg.data.augment:
            inputs, gt_aug = augment_batch(
                inputs, gt, generator, jitter_sigma=cfg.data.jitter_sigma,
                jitter_max=cfg.data.jitter_max,
                scale_low=cfg.data.scale_low,
                scale_high=cfg.data.scale_high)
        else:
            gt_aug = gt
        gen = state.gen
        weight_fine = L.weight_fine_schedule(
            gen.epoch, cfg.loss.weight_fine_boundaries,
            cfg.loss.weight_fine_values)
        lr_g = L.lr_schedule(
            gen.epoch, base_lr=cfg.train.base_lr_g,
            decay_step_epochs=cfg.train.decay_step_epochs,
            decay_rate=cfg.train.lr_decay_rate, clip=cfg.train.lr_clip)
        lr_d = cfg.train.base_lr_d  # constant, as the JAX package's
        model = gen.model.train()
        with deterministic(dev):
            model.zero_grad(set_to_none=True)
            coarse, fine = model(inputs)  # the one generator forward
            fine0 = fine.detach()
            with torch.no_grad():
                d_groups, pred_idx = paired_neighborhoods_with_pred_indices(
                    dcfg, gt_aug, fine0, impl)
                d_fake, d_fake_groups = fine0, d_groups
                if fake_pool is not None:
                    pooled = fake_pool.query(fine0.cpu().numpy())
                    d_fake = torch.from_numpy(
                        np.asarray(pooled, np.float32)).to(dev)
                    d_fake_groups = paired_neighborhoods(dcfg, gt_aug, d_fake,
                                                         impl)
            d_loss, (d_real, d_fake_mean, d_var), d_clip_frac = critic_update(
                state, lr_d, d_fake, gt_aug, d_fake_groups)

            # the generator against the updated critic, frozen
            frozen = [p for p in state.disc.parameters()]
            for p in frozen:
                p.requires_grad_(False)
            try:
                pu_total, metrics = L.pu_losses(coarse, fine, gt_aug, radius,
                                                weight_fine, cfg.loss,
                                                impl=impl)
                values = state.disc(fine, gt_aug, groups=regather_pred(
                    d_groups, pred_idx, fine))
                g_gan = L.generator_loss(split_real_fake(values)[1])
                total = pu_total + g_gan
                total.backward()
            finally:
                for p in frozen:
                    p.requires_grad_(True)
            with torch.no_grad():
                uniform = 10.0 * L.uniform(fine0, impl=impl)
            adam_update(gen, lr_g, cfg.train)
        gen.step += 1
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return state, dict(
            metrics, g_gan=g_gan.detach(), uniform=uniform,
            total=total.detach(), d_loss=d_loss.detach(), lr=lr_g,
            d_real_mean=d_real.detach(), d_fake_mean=d_fake_mean.detach(),
            d_gap=(d_real - d_fake_mean).detach(), d_var=d_var.detach(),
            d_clip_frac=d_clip_frac)

    if cfg.data.random_input:
        def step(state: GANState, gt, radius, generator):
            inputs = sample_training_inputs(
                gt, n_in, generator, cluster_prob=cfg.data.cluster_prob,
                cluster_size=cfg.data.cluster_size)
            return step_core(state, gt, inputs, radius, generator)
    else:
        def step(state: GANState, gt, inputs, radius, generator):
            return step_core(state, gt, inputs, radius, generator)
    return step
