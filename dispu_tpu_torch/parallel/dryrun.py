"""The multi-process dry run of every mesh path, on the CPU (the twin of
``__graft_entry__.py``'s ``dryrun_multichip``).

    python -m dispu_tpu_torch.parallel.dryrun --n 4

starts N processes that join one gloo group (``file://`` in a temporary
directory), one thread each, and runs at tiny shapes, each path with the
mesh and again in one process without it: a CD step (with the training
input's draws and augmentation, and with batch norm in every layer), a
GAN step, the evaluation step, batch norm's global moments, sharded
evaluation, the mesh ``PatchUpsampler``'s ``upsample`` and
``upsample_many`` at 4× and 16×, the SPMD serving export (exported,
loaded and served by the same processes, bit-equal to the live mesh
path), the sharded bucketed merge and a ``Trainer`` epoch with its
checkpoint, whose processes start from different seeds.  Rank 0 prints one ``ok`` line for each with the
deviation from the one-process run; a
check that fails, or a process that fails or outlives the time limit,
fails the run.  Sizes that the process count does not divide are chosen
on purpose (clouds, patch counts, ``patch_batch``).

The module is also the worker that the tests spawn, with cases of their
own (:func:`spawn`'s ``cases``: a ``torch.save`` of a dict shaped as
:func:`default_cases`' result): each rank saves what it computed to
``<out>/rank<r>.pt``.  It imports torch and the port only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: one-process deviations that a rank-0 check accepts: metrics (relative,
#: with a floor of ``METRIC_FLOOR`` of the largest metric); the first
#: step's gradients and Adam moments (``GRAD_REL``, the second moments
#: twice that), each leaf within its share of the leaf's largest entry,
#: with a floor at that share of 1e-3 of the largest entry of all (the
#: tests' ``_assert_leaves``; ``cd_bn``, batch norm after every dense
#: layer, amplifies f32 round-off ten times more).  Later steps' are not
#: held: they are taken at parameters that Adam moved apart by ±lr where
#: a gradient was round-off (4.6e-4 of a leaf's largest seen at step 2);
#: batch norm's moments; sharded evaluation; the evaluation step's
#: points; each upsampled cloud's Chamfer distance (mean squared
#: nearest-neighbour distance both ways) to the one-process output; and
#: the share of a trained state's entries within ``TRAINED_ABS`` a step
#: (a few times lr·3e-3: Adam turns round-off gradients into ±lr steps)
METRIC_REL, METRIC_FLOOR = 1e-5, 2e-6
GRAD_REL = {"cd_bn": 2e-3}
GRAD_REL_DEFAULT = 1e-4
MOMENT_REL = 1e-6
EVAL_REL = 1e-5
POINTS_ABS = 1e-5
CLOUD_CHAMFER = 1e-6
TRAINED_ABS, TRAINED_SHARE = 1e-5, 0.99


# ------------------------------------------------------------------ cases


def tiny_experiment(**fields):
    """A tiny ``ExperimentConfig`` (the tests' sizes): 32-point inputs,
    k 8, batch 4; ``fields`` replace ``generator``, ``train`` and
    ``data`` fields, each a dict, or top-level ones."""
    from dispu_tpu_torch.config import (DataConfig, ExperimentConfig,
                                        GeneratorConfig, LossConfig,
                                        TrainConfig)

    parts = dict(generator=GeneratorConfig(num_points=32, knn=8,
                                           refine_nsample=8),
                 train=TrainConfig(batch_size=4),
                 data=DataConfig(num_point=32),
                 loss=LossConfig(repulsion_nsample=8, repulsion_radius=0.3))
    for name, value in fields.items():
        if isinstance(value, dict):
            value = dataclasses.replace(parts.get(name), **value)
        parts[name] = value
    return ExperimentConfig(**parts)


def default_cases(n: int) -> dict:
    """The dry run's own cases for ``n`` processes, from seeds: the port's
    seeded init, numpy clouds."""
    from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig
    from dispu_tpu_torch.train.gan_steps import create_gan_state
    from dispu_tpu_torch.train.state import create_generator_state

    rng = np.random.RandomState(0)
    b = 4 * n
    gt = (rng.randn(b, 128, 3) * 0.3).astype(np.float32)
    batch = tuple(map(torch.from_numpy, (gt, gt[:, ::4].copy(),
                                         np.ones(b, np.float32))))
    fed = dict(data=dict(random_input=False, augment=False),
               train=dict(batch_size=b))
    cd = tiny_experiment(**fed)
    gan = tiny_experiment(use_gan=True, **fed)
    bn = tiny_experiment(generator=dict(use_bn=True), **fed)
    drawn = tiny_experiment(train=dict(batch_size=b))
    inf = dict(patch_num_point=64, patch_batch=3)
    small = GeneratorConfig(num_points=64, knn=8, refine_nsample=8)
    x = (rng.randn(2 * n, 5, 6) * 2 + 1).astype(np.float32)
    return {
        "cd": dict(cfg=cd, state=create_generator_state(
            cd.generator, device="cpu").state_dict(), batch=batch),
        # one step: batch norm after every dense layer leaves its bias a
        # gradient of round-off alone, which Adam turns into ±lr steps
        "cd_bn": dict(cfg=bn, state=create_generator_state(
            bn.generator, device="cpu").state_dict(), batch=batch, steps=1),
        "cd_drawn": dict(cfg=drawn, state=create_generator_state(
            drawn.generator, device="cpu").state_dict(),
            batch=(batch[0], batch[2])),
        "cd_refused": dict(cfg=dataclasses.replace(
            cd, train=dataclasses.replace(cd.train, batch_size=b + 1))),
        "gan": dict(cfg=gan, state=create_gan_state(gan, device="cpu")
                    .state_dict(), batch=batch),
        "eval_step": dict(cfg=cd, state=create_generator_state(
            cd.generator, device="cpu").state_dict(), batch=batch),
        "bn": dict(x=x, w=rng.randn(*x.shape).astype(np.float32),
                   scale=rng.uniform(0.5, 1.5, 6).astype(np.float32),
                   bias=rng.randn(6).astype(np.float32),
                   mean=rng.randn(6).astype(np.float32),
                   var=rng.uniform(0.5, 1.5, 6).astype(np.float32)),
        "eval": dict(pairs=[(rng.randn(1003, 3).astype(np.float32),
                             rng.randn(777, 3).astype(np.float32))]),
        "serve": dict(gen_cfg=small, model=None,
                      clouds=rng.randn(2, 128, 3).astype(np.float32),
                      inf_cfgs={f"{r}x": InferenceConfig(final_ratio=r, **inf)
                                for r in (4, 16)}),
        "serve_export": dict(gen_cfg=small, model=None,
                             cloud=rng.randn(128, 3).astype(np.float32),
                             inf_cfg=InferenceConfig(**inf)),
        "merge": dict(points=rng.randn(2, 4099, 3).astype(np.float32),
                      npoint=1000, n_buckets=2 * n, bad_buckets=2 * n + 1),
        "trainer": dict(cfg=tiny_experiment(train=dict(
            batch_size=2 * n, epoch_per_save=1, steps_per_print=1,
            backup_sources=False)), patches=4 * n, epochs=1),
    }


# ---------------------------------------------------------------- runners


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def snapshot(model, mu, nu) -> dict:
    """Parameters, their gradients (a missing one as zeros), Adam's
    moments and the buffers of ``model``, as numpy."""
    params = dict(model.named_parameters())
    return dict(params=_numpy(params), mu=_numpy(mu), nu=_numpy(nu),
                buffers=_numpy(dict(model.named_buffers())),
                grads=_numpy({n: p.grad if p.grad is not None
                              else torch.zeros_like(p)
                              for n, p in params.items()}))


@contextlib.contextmanager
def _recorded_draws(draws: list):
    """Record the train steps' input draws and augmented batches (both
    steps draw through ``train.steps.draw_inputs``)."""
    from dispu_tpu_torch.train import steps

    modules = (steps,)
    saved = [(m, m.sample_training_inputs, m.augment_batch) for m in modules]

    def recording(fn, name):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            parts = out if isinstance(out, tuple) else (out,)
            draws.append((name, [t.detach().numpy().copy() for t in parts]))
            return out
        return call

    for m, sample, augment in saved:
        m.sample_training_inputs = recording(sample, "sample")
        m.augment_batch = recording(augment, "augment")
    try:
        yield
    finally:
        for m, sample, augment in saved:
            m.sample_training_inputs, m.augment_batch = sample, augment


def run_steps(mesh, spec: dict) -> dict:
    """``steps`` (2) train steps (GAN steps with ``cfg.use_gan``) from
    ``state`` on ``batch``: per step the metrics and snapshots of each
    network, and the draws."""
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step

    cfg = spec["cfg"]
    if cfg.use_gan:
        state = create_gan_state(cfg, device="cpu")
        step = make_gan_train_step(cfg, device="cpu", mesh=mesh)
    else:
        state = create_generator_state(cfg.generator, device="cpu")
        step = make_train_step(cfg, device="cpu", mesh=mesh)
    state.load_state_dict(spec["state"])
    disc0 = (_numpy(dict(state.disc.named_parameters())) if cfg.use_gan
             else {})
    generator = torch.Generator().manual_seed(spec.get("seed", 0))
    out, draws = [], []
    with _recorded_draws(draws):
        for _ in range(spec.get("steps", 2)):
            state, metrics = step(state, *spec["batch"], generator)
            gen = state.gen if cfg.use_gan else state
            snap = dict(metrics={k: float(v) for k, v in metrics.items()},
                        step=state.step, count=gen.count,
                        gen=snapshot(gen.model, gen.mu, gen.nu))
            if cfg.use_gan:
                snap.update(disc=snapshot(state.disc, state.d_mu,
                                           state.d_nu),
                            d_count=state.d_count)
            out.append(snap)
    return dict(steps=out, draws=draws, disc0=disc0)


def run_eval_step(mesh, spec: dict) -> dict:
    """The evaluation step (``train.steps.make_eval_step``) of ``state``'s
    generator on ``batch``: coarse and fine points and the metrics."""
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_eval_step

    cfg = spec["cfg"]
    state = create_generator_state(cfg.generator, device="cpu")
    state.load_state_dict(spec["state"])
    gt, inputs, radius = spec["batch"]
    coarse, fine, metrics = make_eval_step(cfg, device="cpu", mesh=mesh)(
        state.model, inputs, gt, radius)
    return dict(coarse=coarse.numpy(), fine=fine.numpy(),
                metrics={k: float(v) for k, v in metrics.items()})


def run_refusal(mesh, spec: dict) -> dict:
    """The CD step on a batch that the data axis does not divide."""
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step

    cfg = spec["cfg"]
    b, n = cfg.train.batch_size, cfg.generator.num_points
    state = create_generator_state(cfg.generator, device="cpu")
    gt = torch.zeros(b, 4 * n, 3)
    batch = ((gt, torch.ones(b)) if cfg.data.random_input
             else (gt, gt[:, :n], torch.ones(b)))
    try:
        make_train_step(cfg, device="cpu", mesh=mesh)(state, *batch,
                                                      torch.Generator())
    except ValueError as e:
        return dict(refused=str(e))
    return dict(refused=None)


def run_bn(mesh, spec: dict) -> dict:
    """One training forward and backward of a ``BatchNorm`` on this
    process's rows of ``x`` (loss: the sum of ``y·w`` over the global
    batch): the global ``y`` and ``x`` gradient, the summed parameter
    gradients and the running statistics."""
    from dispu_tpu_torch.nn.layers import BatchNorm, synced_batch_stats
    from dispu_tpu_torch.parallel.mesh import (all_gather_rows,
                                               all_reduce_sum_, shard_batch)

    x, w = torch.from_numpy(spec["x"]), torch.from_numpy(spec["w"])
    bn = BatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        for k in ("scale", "bias", "mean", "var"):
            getattr(bn, k).copy_(torch.from_numpy(spec[k]))
    if mesh is not None:
        x, w = shard_batch(mesh, x, w)
    x = x.clone().requires_grad_(True)
    with synced_batch_stats(bn, mesh):
        y = bn(x)
        torch.sum(y * w).backward()
    grads = [bn.scale.grad, bn.bias.grad]
    y, x_grad = y.detach(), x.grad
    if mesh is not None:
        all_reduce_sum_(grads, mesh)
        y, x_grad = (all_gather_rows(t, mesh).flatten(0, 1)
                     for t in (y, x_grad))
    return _numpy(dict(y=y, x_grad=x_grad, scale_grad=grads[0],
                       bias_grad=grads[1], mean=bn.mean, var=bn.var))


def run_eval(mesh, spec: dict) -> dict:
    """Each pair's (cd, hd), sharded, or with ``nn_distance`` in one
    process."""
    from dispu_tpu_torch.ops.chamfer import nn_distance
    from dispu_tpu_torch.parallel.sharded_eval import sharded_cd_hd

    out = []
    for pred, gt in spec["pairs"]:
        pred, gt = torch.from_numpy(pred), torch.from_numpy(gt)
        if mesh is None:
            fwd, _, bwd, _ = nn_distance(pred[None], gt[None])
            cd = torch.mean(fwd) + torch.mean(bwd)
            hd = torch.amax(fwd) + torch.amax(bwd)
        else:
            cd, hd = sharded_cd_hd(mesh, pred, gt)
        out.append((float(cd), float(hd)))
    return dict(pairs=out)


def run_serve(mesh, spec: dict) -> dict:
    """For each inference configuration: the upsampler's ``upsample`` of
    the first cloud and its ``upsample_many`` of all the clouds."""
    from dispu_tpu_torch.inference import PatchUpsampler

    clouds = spec["clouds"]
    out = {}
    for label, inf in spec["inf_cfgs"].items():
        up = PatchUpsampler(gen_cfg=spec["gen_cfg"], inf_cfg=inf,
                            device="cpu", mesh=mesh)
        if spec["model"] is not None:
            up.model.load_state_dict(spec["model"])
        out[f"{label}/upsample"] = up.upsample(clouds[0])
        out[f"{label}/many"] = up.upsample_many(clouds)
    return out


def run_serve_export(mesh, spec: dict) -> dict:
    """The upsampler exported (``serving.export_upsampler``, the SPMD form
    with the mesh) into ``<path>/mesh`` or ``<path>/plain``, loaded by
    these processes and served the cloud; with the live ``upsample``'s
    output and the manifest, and under a mesh the error that each process
    raised (None for none) when a second export into the same path fails
    in rank 0 alone (weights that do not fit the generator)."""
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.serving import ServedUpsampler, export_upsampler

    up = PatchUpsampler(gen_cfg=spec["gen_cfg"], inf_cfg=spec["inf_cfg"],
                        device="cpu", mesh=mesh)
    if spec["model"] is not None:
        up.model.load_state_dict(spec["model"])
    cloud = spec["cloud"]
    path = os.path.join(spec["path"], "plain" if mesh is None else "mesh")
    manifest = export_upsampler(up.model.state_dict(), [cloud.shape[0]],
                                path, gen_cfg=spec["gen_cfg"],
                                inf_cfg=spec["inf_cfg"], mesh=mesh,
                                device="cpu")
    out = dict(live=up.upsample(cloud), manifest=manifest,
               served=ServedUpsampler(path).upsample(cloud))
    if mesh is not None:
        try:
            export_upsampler({}, [cloud.shape[0]], path,
                             gen_cfg=spec["gen_cfg"], inf_cfg=spec["inf_cfg"],
                             mesh=mesh, device="cpu")
            out["failed_export"] = None
        except RuntimeError as e:
            out["failed_export"] = f"{type(e).__name__}: {e}"
    return out


def run_serve_load(mesh, spec: dict) -> dict:
    """An artifact that an earlier launch exported, loaded and served the
    cloud in this one (the mesh unused: the artifact names its group);
    with the model modules this process imported (none should be)."""
    from dispu_tpu_torch.serving import ServedUpsampler

    served = ServedUpsampler(spec["path"])
    out = served.upsample(spec["cloud"])
    model_code = ("dispu_tpu_torch.models", "dispu_tpu_torch.nn",
                  "dispu_tpu_torch.inference", "dispu_tpu_torch.convert")
    return dict(served=out, manifest=served.manifest,
                imported=sorted(m for m in sys.modules
                                if m.startswith(model_code)))


def run_merge(mesh, spec: dict) -> dict:
    """The bucketed merge's indices, and its refusal of a bucket count
    that the data axis does not divide."""
    from dispu_tpu_torch.ops.sampling import farthest_point_sample_bucketed

    pts = torch.from_numpy(spec["points"])
    out = dict(idx=farthest_point_sample_bucketed(
        spec["npoint"], pts, n_buckets=spec["n_buckets"], mesh=mesh).numpy())
    if mesh is not None:
        try:
            farthest_point_sample_bucketed(spec["npoint"], pts,
                                           n_buckets=spec["bad_buckets"],
                                           mesh=mesh)
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
    return out


def run_trainer(mesh, spec: dict, log_dir: str) -> dict:
    """A ``Trainer`` (``GANTrainer`` with ``use_gan``) over ``mesh`` for
    ``epochs`` on synthetic patches into ``log_dir``, each process other
    than rank 0 starting from a state of its own seed (the trainer's
    broadcast must replace it by rank 0's): what each process wrote, the
    log's line counts, whether the newest checkpoint restores the trained
    state bit for bit, whether every process's trained state is rank 0's
    bit for bit, and on rank 0 the share of its entries within ``TRAINED_ABS`` a step
    of a one-process trainer's."""
    import torch.distributed as dist

    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.parallel.mesh import broadcast_, data_rank
    from dispu_tpu_torch.train.gan_steps import create_gan_state
    from dispu_tpu_torch.train.gan_trainer import GANTrainer
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.trainer import Trainer, state_tensors
    from dispu_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                  restore_checkpoint)

    cfg = dataclasses.replace(spec["cfg"], log_dir=log_dir)

    def fresh(seed):
        return (create_gan_state(cfg, seed=seed, device="cpu")
                if cfg.use_gan else
                create_generator_state(cfg.generator, seed=seed,
                                       device="cpu"))

    def train(m, log):
        ds = PatchDataset(h5_path=os.path.join(log, "absent.h5"),
                          synthetic_patches_count=spec["patches"],
                          num_point=cfg.data.num_point, seed=1)
        cls = GANTrainer if cfg.use_gan else Trainer
        tr = cls(dataclasses.replace(cfg, log_dir=log), dataset=ds,
                 device="cpu", mesh=m)
        rank = 0 if m is None else data_rank(m)
        if rank:
            tr._make_state = lambda: fresh(cfg.train.seed + 1 + rank)
        return tr, tr.train(epochs=spec["epochs"])

    def flat(st):
        return torch.cat([t.reshape(-1).double()
                          for t in state_tensors(st.state_dict())])

    tr, state = train(mesh, log_dir)
    dist.barrier()
    mine = flat(state)
    rank0 = mine.clone()
    broadcast_([rank0], mesh)
    # whether every process holds rank 0's state
    replicated = torch.tensor([float(torch.equal(mine, rank0))])
    dist.all_reduce(replicated, op=dist.ReduceOp.MIN)
    near_plain = None
    if data_rank(mesh) == 0:
        want = flat(train(None, log_dir + "_plain")[1])
        near_plain = float(torch.mean((torch.abs(mine - want) <= (
            TRAINED_ABS * state.step)).double()))

    def lines(name):
        path = os.path.join(log_dir, name)
        return len(open(path).readlines()) if os.path.exists(path) else 0

    epoch, path = latest_checkpoint(log_dir)
    back = restore_checkpoint(path, fresh(9))
    same = all(torch.equal(a, b) for a, b in zip(
        state_tensors(state.state_dict()), state_tensors(back.state_dict())))
    return dict(writer=tr.writer, epoch=epoch, restored_equal=same,
                replicated=bool(replicated), near_plain=near_plain,
                digest=float(mine.sum()), files=sorted(os.listdir(log_dir)),
                log_lines=lines("log_train.txt"),
                scalar_lines=lines("scalars.jsonl"),
                steps=state.step)


RUNNERS = {"cd": run_steps, "cd_bn": run_steps, "cd_drawn": run_steps,
           "cd_bf16": run_steps, "cd_remat": run_steps,
           "gan": run_steps, "gan_remat": run_steps,
           "eval_step": run_eval_step,
           "cd_refused": run_refusal, "bn": run_bn,
           "eval": run_eval, "serve": run_serve, "merge": run_merge,
           "serve_export": run_serve_export, "serve_load": run_serve_load}

#: cases run with the mesh alone (no one-process run in rank 0)
MESH_ONLY = ("cd_refused", "serve_load")


# ----------------------------------------------------------------- checks


def _metric_dev(got: dict, want: dict) -> float:
    top = max(abs(v) for v in want.values())
    floor = max(METRIC_FLOOR * top, 1e-30)
    return max(abs(got[k] - want[k]) / max(abs(want[k]), floor)
               for k in want)


def _leaf_dev(got: dict, want: dict) -> float:
    """The largest deviation of a leaf as a share of the leaf's largest
    entry, floored at 1e-3 of the largest entry of all."""
    top = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - w).max())
               / max(float(np.abs(w).max()), 1e-3 * top, 1e-30)
               for k, w in want.items())


def _chamfer(a: np.ndarray, b: np.ndarray) -> float:
    d = np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
    return float(d.min(axis=1).mean() + d.min(axis=0).mean())


def summarize(name: str, mesh_out: dict, plain_out, n: int) -> str:
    """The ``ok`` line of one case against its one-process run; raises
    ``SystemExit`` when a check fails."""
    def require(ok, what):
        if not ok:
            raise SystemExit(f"dryrun({n}) {name}: check failed: {what}")

    if name in ("cd", "cd_bn", "cd_drawn", "gan"):
        devs, pdev, ldev = [], 0.0, 0.0
        rel = GRAD_REL.get(name, GRAD_REL_DEFAULT)
        for i, (got, want) in enumerate(zip(mesh_out["steps"],
                                            plain_out["steps"])):
            require(set(got["metrics"]) == set(want["metrics"]), "metrics")
            devs.append(_metric_dev(got["metrics"], want["metrics"]))
            for net in ("gen", "disc"):
                if net not in want:
                    continue
                g, w = got[net], want[net]
                pdev = max(pdev, max(float(np.abs(g["params"][k] - v).max())
                                     for k, v in w["params"].items()))
                for part, scale in ((("grads", 1), ("mu", 1), ("nu", 2))
                                    if i == 0 else ()):
                    d = _leaf_dev(g[part], w[part])
                    ldev = max(ldev, d / scale)
                    require(d <= scale * rel,
                            f"{net} {part} deviate {d:.2e} of their "
                            "leaves' largest")
        require(max(devs) <= METRIC_REL, f"metrics deviate {devs}")
        draws = len(mesh_out["draws"]) == len(plain_out["draws"]) and all(
            a[0] == b[0] and all(np.array_equal(x, y)
                                 for x, y in zip(a[1], b[1]))
            for a, b in zip(mesh_out["draws"], plain_out["draws"]))
        require(draws, "the input draws differ")
        return (f"ok {name}: {len(devs)} steps on {n} processes, metrics "
                f"max rel dev {max(devs):.2e} per step "
                f"{['%.2e' % d for d in devs]}, first gradients and Adam "
                f"moments {ldev:.2e} of their leaves' largest (bound "
                f"{rel:.0e}), "
                f"parameters max |d| {pdev:.2e}"
                + (f", {len(plain_out['draws'])} draws "
                                  "bit-equal" if plain_out["draws"] else ""))
    if name == "cd_refused":
        require(mesh_out["refused"] is not None, "no refusal")
        return f"ok {name}: {mesh_out['refused']}"
    if name == "bn":
        dev = max(float(np.abs(mesh_out[k] - plain_out[k]).max()
                        / np.abs(plain_out[k]).max()) for k in ("mean", "var"))
        gdev = max(float(np.abs(mesh_out[k] - plain_out[k]).max()
                         / np.abs(plain_out[k]).max())
                   for k in ("y", "x_grad", "scale_grad", "bias_grad"))
        require(dev <= MOMENT_REL, f"moments deviate {dev}")
        require(gdev <= METRIC_REL, f"output and gradients deviate {gdev}")
        return (f"ok {name}: global moments rel dev {dev:.2e}, output and "
                f"gradients {gdev:.2e}")
    if name == "eval_step":
        dev = _metric_dev(mesh_out["metrics"], plain_out["metrics"])
        pts = max(float(np.abs(mesh_out[k] - plain_out[k]).max())
                  for k in ("coarse", "fine"))
        require(dev <= METRIC_REL, f"metrics deviate {dev}")
        require(pts <= POINTS_ABS, f"points deviate {pts}")
        return (f"ok {name}: metrics max rel dev {dev:.2e}, gathered points "
                f"max |d| {pts:.2e}")
    if name == "eval":
        dev = max(abs(g - w) / abs(w) for gp, wp in zip(
            mesh_out["pairs"], plain_out["pairs"]) for g, w in zip(gp, wp))
        require(dev <= EVAL_REL, f"sharded cd/hd deviate {dev}")
        return f"ok {name}: sharded (cd, hd) rel dev {dev:.2e}"
    if name == "serve":
        parts = []
        for key, got in mesh_out.items():
            want = plain_out[key]
            require(got.shape == want.shape, f"{key} shape {got.shape}")
            cd = max(_chamfer(g, w) for g, w in zip(
                got.reshape(-1, *want.shape[-2:]),
                want.reshape(-1, *want.shape[-2:])))
            require(cd <= CLOUD_CHAMFER, f"{key} Chamfer {cd}")
            parts.append(f"{key} {cd:.1e}")
        return (f"ok {name}: Chamfer to the one-process output "
                + ", ".join(parts))
    if name == "serve_export":
        entry, plain = mesh_out["manifest"]["entries"][0], \
            plain_out["manifest"]["entries"][0]
        require(np.array_equal(mesh_out["served"], mesh_out["live"]),
                "the SPMD entry's output differs from the live mesh path")
        require(np.array_equal(plain_out["served"], plain_out["live"]),
                "the one-process entry's output differs from live")
        require(entry["nr_devices"] == n and plain["nr_devices"] == 1,
                f"nr_devices {entry['nr_devices']}, {plain['nr_devices']}")
        require("_c10d_functional::all_gather_into_tensor"
                in entry["collectives"], f"collectives {entry}")
        require(entry["kernels"] == plain["kernels"], "the entries' ops")
        require(mesh_out["failed_export"] is not None,
                "an export that failed in rank 0 returned")
        cd = _chamfer(mesh_out["served"], plain_out["served"])
        require(cd <= CLOUD_CHAMFER, f"SPMD against one process: {cd}")
        return (f"ok {name}: the SPMD entry (nr_devices {n}, "
                f"{entry['collectives']}, ops {entry['kernels']}) serves "
                f"bit-equal to the live mesh path; Chamfer to the "
                f"one-process entry {cd:.1e}")
    if name == "merge":
        require(np.array_equal(mesh_out["idx"], plain_out["idx"]),
                "sharded merge differs")
        require(mesh_out["refused"] is not None, "no refusal")
        return (f"ok {name}: {mesh_out['idx'].size} selections bit-equal; "
                f"{mesh_out['refused']}")
    if name == "trainer":
        require(mesh_out["restored_equal"], "restore differs")
        require(mesh_out["replicated"], "the processes' states differ")
        require(mesh_out["near_plain"] >= TRAINED_SHARE,
                f"{mesh_out['near_plain']} of the state near the "
                "one-process trainer's")
        # one scalar line a step (steps_per_print 1): one process wrote
        require(mesh_out["scalar_lines"] == mesh_out["steps"],
                f"{mesh_out['scalar_lines']} scalar lines for "
                f"{mesh_out['steps']} steps")
        return (f"ok {name}: processes started from their own seeds end "
                f"on rank 0's state bit for bit, {mesh_out['near_plain']:.4f}"
                f" of it within {TRAINED_ABS:.0e} a step of the one-process "
                f"trainer's; epoch {mesh_out['epoch']} checkpoint restores "
                f"bit-equal; {mesh_out['log_lines']} log and "
                f"{mesh_out['scalar_lines']} scalar lines")
    raise KeyError(name)


# ----------------------------------------------------------------- ranks


def rank_main(rank: int, n: int, init: str, out: str,
              cases_path=None) -> None:
    """One process of the run: join the group, run every case with the
    mesh (rank 0 also without), save ``<out>/rank<r>.pt``; rank 0 prints
    the ``ok`` lines of the dry run's own cases."""
    import torch.distributed as dist

    from dispu_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=n)
    try:
        mesh = make_mesh(device="cpu")
        cases = (default_cases(n) if cases_path is None
                 else torch.load(cases_path, weights_only=False))
        results = {}
        for name, spec in cases.items():
            t0 = time.perf_counter()
            if name == "trainer":
                log_dir = os.path.join(out, "trainer_log")
                results[name] = {"mesh": run_trainer(mesh, spec, log_dir)}
            else:
                if name == "serve_export" and not spec.get("path"):
                    spec = dict(spec, path=os.path.join(out, "export"))
                runner = RUNNERS[name]
                results[name] = {"mesh": runner(mesh, spec)}
                if rank == 0 and name not in MESH_ONLY:
                    results[name]["plain"] = runner(None, spec)
            results[name]["seconds"] = time.perf_counter() - t0
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
        if rank == 0 and cases_path is None:
            for name, res in results.items():
                print(f"{summarize(name, res['mesh'], res.get('plain'), n)}"
                      f"; {res['seconds']:.1f} s", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


class Ranks:
    """``n`` processes of :func:`rank_main` (``python -m`` this module),
    started at once; :meth:`join` waits for them.

    ``cases``: a path to a ``torch.save`` of cases, or None for
    :func:`default_cases`.  ``timeout`` counts from the start."""

    def __init__(self, n: int, out: str, cases=None,
                 timeout: float = 120.0):
        self.n, self.out, self.timeout = n, out, timeout
        self.deadline = time.monotonic() + timeout
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        self.logs, self.procs = [], []
        try:
            for r in range(n):
                log = open(os.path.join(out, f"rank{r}.log"), "w+")
                self.logs.append(log)
                cmd = [sys.executable, "-m",
                       "dispu_tpu_torch.parallel.dryrun", "--rank", str(r),
                       "--n", str(n), "--init",
                       os.path.join(out, "group_init"), "--out", out]
                if cases is not None:
                    cmd += ["--cases", str(cases)]
                self.procs.append(subprocess.Popen(
                    cmd, cwd=REPO, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        except BaseException:
            self.close()
            raise

    def join(self) -> list:
        """Each rank's results (``<out>/rank<r>.pt``), after copying rank
        0's output to this process's.  A rank that fails, or ranks still
        running at the deadline, kill every rank and raise
        ``RuntimeError`` with their output."""
        try:
            procs = self.procs
            while any(p.poll() is None for p in procs):
                if (any(p.returncode not in (None, 0) for p in procs)
                        or time.monotonic() > self.deadline):
                    break
                time.sleep(0.05)
            if any(p.poll() != 0 for p in procs):
                what = ("a rank failed" if any(
                    p.returncode not in (None, 0) for p in procs)
                    else f"timed out after {self.timeout:.0f} s")
                self._kill()
                text = []
                for r, log in enumerate(self.logs):
                    log.seek(0)
                    text.append(f"--- rank {r} (exit {procs[r].returncode})"
                                "\n" + log.read()[-4000:])
                raise RuntimeError(f"dry run of {self.n} processes: {what}"
                                   "\n" + "\n".join(text))
            self.logs[0].seek(0)
            sys.stdout.write(self.logs[0].read())
            return [torch.load(os.path.join(self.out, f"rank{r}.pt"),
                               weights_only=False) for r in range(self.n)]
        finally:
            self.close()

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def close(self) -> None:
        """Kill the ranks still running and close their logs."""
        self._kill()
        for log in self.logs:
            if not log.closed:
                log.close()


def spawn(n: int, out: str, cases=None, timeout: float = 120.0) -> list:
    """:class:`Ranks` of ``n`` processes, joined."""
    return Ranks(n, out, cases, timeout).join()


def dryrun_multichip(n: int, timeout: float = 120.0) -> list:
    """The dry run on ``n`` CPU processes (module docstring); returns each
    rank's results, after rank 0's ``ok`` lines."""
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out:
        return spawn(n, out, timeout=timeout)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=4, help="processes")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--rank", type=int, help="(a worker's own rank)")
    p.add_argument("--init", help="(a worker's group file)")
    p.add_argument("--out", help="(a worker's output directory)")
    p.add_argument("--cases", help="(a worker's cases file)")
    args = p.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.n, args.init, args.out, args.cases)
        return 0
    dryrun_multichip(args.n, timeout=args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
