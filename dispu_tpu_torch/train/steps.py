"""The CD train step and the eval step (counterpart of ``train/steps.py``).

One train step: the input draw (``random_input``) and augmentation on the
step's device, the epoch schedules, the generator forward in training mode
(batch-norm batch statistics, running statistics updated), ``pu_losses``,
the backward through the kernels' autograd rules, and the Adam update,
in place (with ``remat`` the forward is recomputed in the backward,
:func:`generator_forward`).  Its spans (``utils.tracing``): ``train.step``
around ``train.draw`` (the draw, augmentation and schedules),
``train.forward``, ``train.losses``, ``train.backward`` and
``train.update`` (under a mesh the gradients' all-reduce, then Adam); the
GAN step adds ``train.critic`` and a second ``train.losses``, for the
logged ``uniform`` after the backward.  It returns the JAX package's metrics dict,
as 0-d tensors on the device (and ``lr``, ``weight_fine`` as floats), so
a caller fetches them only when it prints.

With a ``mesh`` (``parallel.mesh.make_mesh``) the step is data-parallel
and computes the single-device step's function of the global batch, as the
JAX package's sharded step does.  Every process is handed the whole global
batch and the same ``torch.Generator`` state: the input draw and the
augmentation run on the global batch in each, so the draws are the
single-device step's; each process then keeps its rows for the forward
and the backward (batch norm's moments over the global batch,
``nn.layers.synced_batch_stats``).  The parameters' gradients are
averaged in one flat all-reduce and Adam runs replicated.  Every metric
is the global one: the means averaged, the maxima (:data:`MAX_METRICS`)
reduced by their maximum.  The losses are means over equal-size local
batches, so the average of the local gradients is the global loss's; the
moments' all-reduce carries each process's loss back to every process's
rows.  At world size 1 every collective is an identity and the step is
the mesh-less one, bit for bit.

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
from dispu_tpu_torch.nn.layers import (computing_at, frozen_running_stats,
                                       synced_batch_stats)
from dispu_tpu_torch.parallel.mesh import (all_gather_rows, all_reduce_max_,
                                           all_reduce_mean_, local_rows,
                                           shard_batch)
from dispu_tpu_torch.train.state import GeneratorState, adam_update
from dispu_tpu_torch.utils.tracing import span

#: metrics that are a maximum over the batch; every other tensor metric is
#: a mean over it (floats, such as ``lr``, are the same in every process)
MAX_METRICS = frozenset({"coarse_hd", "fine_hd", "offset_max"})


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


def generator_forward(model: torch.nn.Module, inputs: torch.Tensor,
                      remat: bool):
    """``model(inputs)``; with ``remat`` (``TrainConfig.remat``, the JAX
    package's ``jax.checkpoint`` around the generator forward) under
    ``torch.utils.checkpoint`` (non-reentrant): the forward keeps no
    activation for the backward, which recomputes it.  The recompute runs
    inside ``backward()``, so the step's compute dtype, mesh and
    deterministic algorithms must still be in force there (the steps call
    ``backward()`` inside those blocks), and it leaves batch norm's
    running statistics alone (``nn.layers.frozen_running_stats``): the
    first run moved them once.  The kernels'
    forwards are deterministic, so the recompute saves the first run's
    tensors bit for bit and the step's result does not change; each
    kernel of the forward launches twice."""
    if not remat:
        return model(inputs)
    from torch.utils.checkpoint import checkpoint

    return checkpoint(model, inputs, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_running_stats(model)))


def reduce_grads_(module: torch.nn.Module, mesh) -> None:
    """Average ``module``'s parameter gradients over the mesh in one flat
    all-reduce (a missing gradient counts as zero, as Adam takes it)."""
    params = list(module.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_mean_([p.grad for p in params], mesh)


def global_metrics(metrics: dict, mesh) -> dict:
    """The global batch's metrics from each process's: the tensors of
    :data:`MAX_METRICS` by their maximum over the mesh, every other tensor
    by its mean, each kind stacked into one all-reduce; other values as
    they are."""
    out = dict(metrics)
    for reduce_, keys in (
            (all_reduce_mean_, [k for k, v in metrics.items()
                                if torch.is_tensor(v)
                                and k not in MAX_METRICS]),
            (all_reduce_max_, [k for k in metrics if k in MAX_METRICS])):
        if keys:
            stacked = torch.stack([metrics[k] for k in keys])
            reduce_([stacked], mesh)
            out.update(zip(keys, stacked.unbind()))
    return out


def make_train_step(cfg: ExperimentConfig, device="cuda", impl: str = "auto",
                    mesh=None):
    """The CD-path train step on ``device`` ('cuda' by default; it raises
    without a card unless 'cpu' is passed).  ``impl`` routes the losses'
    kernels (the model's own routing is fixed when its state is made).
    ``mesh``: data-parallel over this mesh (see the module docstring); the
    step is then handed the global batch in every process.

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

    def step_core(state: GeneratorState, gt, inputs, radius, generator):
        """The step; ``inputs`` None draws them from ``gt``."""
        if mesh is not None:
            local_rows(mesh, gt.shape[0])  # refuse before any draw
        with span("train.draw"):
            inputs, gt_aug, radius = draw_inputs(cfg, mesh, gt, inputs,
                                                 radius, generator)
            weight_fine = L.weight_fine_schedule(
                state.epoch, cfg.loss.weight_fine_boundaries,
                cfg.loss.weight_fine_values)
            lr = L.lr_schedule(
                state.epoch, base_lr=cfg.train.base_lr_g,
                decay_step_epochs=cfg.train.decay_step_epochs,
                decay_rate=cfg.train.lr_decay_rate, clip=cfg.train.lr_clip)
        model = state.model.train()
        with deterministic(dev), synced_batch_stats(model, mesh), \
                computing_at(model, cfg.train.compute_dtype):
            model.zero_grad(set_to_none=True)
            with span("train.forward"):
                coarse, fine = generator_forward(model, inputs,
                                                 cfg.train.remat)
            with span("train.losses"):
                total, metrics = L.pu_losses(coarse, fine, gt_aug, radius,
                                             weight_fine, cfg.loss,
                                             impl=impl)
            with span("train.backward"):
                total.backward()
            with span("train.update"):
                if mesh is not None:
                    reduce_grads_(model, mesh)
                adam_update(state, lr, cfg.train)
        state.step += 1
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics = dict(metrics, total=total.detach(), lr=lr)
        if mesh is not None:
            metrics = global_metrics(metrics, mesh)
        return state, metrics

    return signature_of(cfg, step_core)


def draw_inputs(cfg: ExperimentConfig, mesh, gt, inputs, radius, generator):
    """A step's inputs: ``inputs`` None draws them from the dense ``gt``
    (``random_input``); then the augmentation, and under a ``mesh`` this
    process's rows.  Returns (inputs, gt as augmented, radius)."""
    if inputs is None:
        inputs = sample_training_inputs(
            gt, cfg.generator.num_points, generator,
            cluster_prob=cfg.data.cluster_prob,
            cluster_size=cfg.data.cluster_size)
    if cfg.data.augment:
        inputs, gt = augment_batch(
            inputs, gt, generator, jitter_sigma=cfg.data.jitter_sigma,
            jitter_max=cfg.data.jitter_max, scale_low=cfg.data.scale_low,
            scale_high=cfg.data.scale_high)
    if mesh is not None:
        inputs, gt, radius = shard_batch(mesh, inputs, gt, radius)
    return inputs, gt, radius


def signature_of(cfg: ExperimentConfig, step_core):
    """The step that the input mode asks for, around ``step_core(state,
    gt, inputs, radius, generator)`` inside the span ``train.step``:
    ``step(state, gt, radius, generator)`` with ``random_input`` (inputs
    None: drawn), else ``step(state, gt, inputs, radius, generator)``."""
    if cfg.data.random_input:
        def step(state, gt, radius, generator):
            with span("train.step"):
                return step_core(state, gt, None, radius, generator)
    else:
        def step(state, gt, inputs, radius, generator):
            with span("train.step"):
                return step_core(state, gt, inputs, radius, generator)
    return step


def make_eval_step(cfg: ExperimentConfig, device="cuda", impl: str = "auto",
                   mesh=None):
    """``step(model, inputs, gt, radius) → (coarse, fine, metrics)``: the
    generator in inference mode, at ``cfg.train.compute_dtype`` (as the
    JAX package builds its eval model), and the evaluation metrics.  With a
    ``mesh`` each process runs its rows of the global batch it is handed;
    ``coarse`` and ``fine`` come back whole (gathered) and the metrics
    global, in every process."""
    resolve_device(device)
    pin_f32()

    @torch.no_grad()
    def step(model, inputs, gt, radius):
        if mesh is not None:
            inputs, gt, radius = shard_batch(mesh, inputs, gt, radius)
        with computing_at(model, cfg.train.compute_dtype):
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
        if mesh is not None:
            metrics = global_metrics(metrics, mesh)
            coarse, fine = (all_gather_rows(t, mesh).flatten(0, 1)
                            for t in (coarse, fine))
        return coarse, fine, metrics

    return step
