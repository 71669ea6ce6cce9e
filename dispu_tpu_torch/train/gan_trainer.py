"""The GAN experiment loop (counterpart of ``train/gan_trainer.py``).

It shares the loop, the device-resident batches, the checkpoints and the
logs with the CD :class:`~dispu_tpu_torch.train.trainer.Trainer` through
``BaseTrainer``; only the state, the step and the log line differ.  A
checkpoint holds the whole :class:`~dispu_tpu_torch.train.gan_steps.
GANState` (both networks and both sets of Adam moments); the CLI's test
phase restores its generator half.  The fake pool, when
``fake_pool_size`` > 0, is built once and is not part of a checkpoint.
"""

from __future__ import annotations

import numpy as np

from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                             make_gan_train_step)
from dispu_tpu_torch.train.trainer import BaseTrainer
from dispu_tpu_torch.utils.visu import PointPool


class GANTrainer(BaseTrainer):
    epoch_metric_keys = (
        "total", "fine_cd", "d_loss", "g_gan", "uniform", "offset_mean",
        "d_gap", "d_var", "d_clip_frac",
    )

    def __init__(self, cfg, *args, mesh=None, **kwargs):
        if mesh is not None and cfg.train.fake_pool_size > 0:
            raise ValueError(
                "the fake pool is a host round trip, single-device only; "
                "run on one device or set --fake_pool_size 0")
        self._pool = None
        super().__init__(cfg, *args, mesh=mesh, **kwargs)
        if self.cfg.train.d_clip > 0:
            msg = (
                "WARNING: d_clip=%g reproduces the reference's collapsed "
                "critic (d_clip_frac -> 1.0, constant D output). Pass "
                "--d_clip 0 for a live adversarial term; watch "
                "d_gap/d_clip_frac in the log either way."
                % self.cfg.train.d_clip)
        elif self.cfg.train.gen_update > 1:
            msg = (
                "d_clip=0 balanced game: critic trains once per "
                "gen_update=%d generator steps (the reference declares "
                "--gen_update but never consumes it; pass --gen_update 1 "
                "for a critic update every step)."
                % self.cfg.train.gen_update)
        else:
            return
        print(msg, flush=True)
        self.logger.text(msg)

    def _fake_pool(self):
        """The history pool, built once (None when ``fake_pool_size`` is
        0), its draws seeded with ``TrainConfig.seed``."""
        size = self.cfg.train.fake_pool_size
        if size <= 0:
            return None
        if self._pool is None:
            self._pool = PointPool(
                size, rng=np.random.RandomState(self.cfg.train.seed))
        return self._pool

    def _make_step(self):
        return make_gan_train_step(self.cfg, device=self.device,
                                   impl=self.impl,
                                   fake_pool=self._fake_pool())

    def _make_state(self):
        return create_gan_state(self.cfg, seed=self.cfg.train.seed,
                                impl=self.impl, device=self.device)

    def _format_epoch(self, epoch, meters, minutes):
        return (
            "epoch %04d g_loss=%.9f fine_cd=%.9f d_loss=%.9f g_gan=%.9f "
            "uniform=%.9f d_gap=%.6f d_var=%.3e d_clip_frac=%.3f time=%.4f"
            % (epoch, meters["total"].avg, meters["fine_cd"].avg,
               meters["d_loss"].avg, meters["g_gan"].avg,
               meters["uniform"].avg, meters["d_gap"].avg,
               meters["d_var"].avg, meters["d_clip_frac"].avg, minutes)
        )
