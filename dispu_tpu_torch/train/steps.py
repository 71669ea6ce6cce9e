"""The CD train step and the eval step (counterpart of ``train/steps.py``).

One train step: the input draw (``random_input``) and augmentation on the
step's device, the epoch schedules, the generator forward in training mode
(batch-norm batch statistics, running statistics updated), ``pu_losses``,
the backward through the kernels' autograd rules, and the Adam update,
in place.  It returns the JAX package's metrics dict, as 0-d tensors on
the device (and ``lr``, ``weight_fine`` as floats), so a caller fetches
them only when it prints.

On the card the step runs under ``torch.use_deterministic_algorithms``:
PyTorch's CUDA scatter-adds (the backward of ``torch.gather``, the kNN and
Chamfer rules' ``scatter_add_``) otherwise add in an order that changes
from run to run, where the JAX package's are deterministic by design.
cuBLAS then needs ``CUBLAS_WORKSPACE_CONFIG``; the step sets it to
``:4096:8`` unless the environment already has it.
"""

from __future__ import annotations

import contextlib
import os

import torch

from dispu_tpu_torch import losses as L
from dispu_tpu_torch.config import ExperimentConfig, check_train_supported
from dispu_tpu_torch.data.augment import augment_batch, sample_training_inputs
from dispu_tpu_torch.inference import pin_f32, resolve_device
from dispu_tpu_torch.train.state import GeneratorState, adam_update


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms on a CUDA ``device`` for the block, the
    previous setting restored after it.  Uninitialized memory is not
    filled (nothing reads it; the fill would add a pass over every new
    tensor)."""
    if device.type != "cuda":
        yield
        return
    import torch.utils.deterministic as det

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        det.fill_uninitialized_memory = before[2]


def make_train_step(cfg: ExperimentConfig, device="cuda", impl: str = "auto"):
    """The CD-path train step on ``device`` ('cuda' by default; it raises
    without a card unless 'cpu' is passed).  ``impl`` routes the losses'
    kernels (the model's own routing is fixed when its state is made).

    Its signature follows the input mode:

    * ``random_input=True``: ``step(state, gt, radius, generator)``; the
      sparse input is a nonuniform draw from the dense ``gt`` patch;
    * ``random_input=False``: ``step(state, gt, inputs, radius,
      generator)``; the curated sparse patch is fed in.

    ``generator`` is a ``torch.Generator`` on the step's device.  Returns
    ``(state, metrics)``; the state is updated in place.
    """
    check_train_supported(cfg)
    dev = resolve_device(device)
    pin_f32()
    n_in = cfg.generator.num_points

    def step_core(state: GeneratorState, gt, inputs, radius, generator):
        if cfg.data.augment:
            inputs, gt_aug = augment_batch(
                inputs, gt, generator, jitter_sigma=cfg.data.jitter_sigma,
                jitter_max=cfg.data.jitter_max,
                scale_low=cfg.data.scale_low,
                scale_high=cfg.data.scale_high)
        else:
            gt_aug = gt
        weight_fine = L.weight_fine_schedule(
            state.epoch, cfg.loss.weight_fine_boundaries,
            cfg.loss.weight_fine_values)
        lr = L.lr_schedule(
            state.epoch, base_lr=cfg.train.base_lr_g,
            decay_step_epochs=cfg.train.decay_step_epochs,
            decay_rate=cfg.train.lr_decay_rate, clip=cfg.train.lr_clip)
        model = state.model.train()
        with deterministic(dev):
            model.zero_grad(set_to_none=True)
            coarse, fine = model(inputs)
            total, metrics = L.pu_losses(coarse, fine, gt_aug, radius,
                                         weight_fine, cfg.loss, impl=impl)
            total.backward()
            adam_update(state, lr, cfg.train)
        state.step += 1
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return state, dict(metrics, total=total.detach(), lr=lr)

    if cfg.data.random_input:
        def step(state: GeneratorState, gt, radius, generator):
            inputs = sample_training_inputs(
                gt, n_in, generator, cluster_prob=cfg.data.cluster_prob,
                cluster_size=cfg.data.cluster_size)
            return step_core(state, gt, inputs, radius, generator)
    else:
        def step(state: GeneratorState, gt, inputs, radius, generator):
            return step_core(state, gt, inputs, radius, generator)
    return step


def make_eval_step(cfg: ExperimentConfig, device="cuda", impl: str = "auto"):
    """``step(model, inputs, gt, radius) → (coarse, fine, metrics)``: the
    generator in inference mode and the evaluation metrics."""
    resolve_device(device)
    pin_f32()

    @torch.no_grad()
    def step(model, inputs, gt, radius):
        coarse, fine = model.eval()(inputs)
        off = torch.sqrt(torch.sum((fine - coarse) ** 2, dim=-1) + 1e-20)
        metrics = {
            "coarse_cd": cfg.loss.coarse_cd_w
            * L.chamfer(coarse, gt, radius, impl=impl),
            "fine_cd": cfg.loss.fine_cd_w
            * L.chamfer(fine, gt, radius, impl=impl),
            "fine_hd": cfg.loss.hd_w * L.hausdorff(fine, gt, radius,
                                                   impl=impl),
            "offset_mean": torch.mean(off),
        }
        return coarse, fine, metrics

    return step
