"""The port's data-parallel paths against the JAX package's mesh functions,
on the CPU.

The port side runs in W = 2 gloo processes (``parallel.dryrun``'s worker,
spawned once for the module, each rank saving what it computed); the JAX
side runs here on ``make_mesh(num_devices=2)`` of the 8 virtual CPU
devices, while the ranks run.  Inputs are made with numpy, and the weights
are a perturbed JAX state or flax tree converted to the port: a CD step,
a CD step with batch norm in every layer (the gradient's 1/W against a
real global moment), a GAN step, the evaluation step, batch norm's global
moments, sharded evaluation, the mesh ``PatchUpsampler``'s ``upsample``
and ``upsample_many`` (against both of the JAX package's mesh paths, its
staged one and its single-program one), the sharded bucketed merge; each
against JAX and against the port's own one-process run.  Then the port
alone: the training input's draws, the refusals, a ``Trainer`` whose
files only rank 0 writes and whose processes start from different seeds,
the CLI under ``torch.distributed.run`` and the 4-process dry run.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import InferenceConfig as JInferenceConfig
from dispu_tpu.inference import PatchUpsampler as JPatchUpsampler
from dispu_tpu.models.generator import DisPUGenerator as JDisPUGenerator
from dispu_tpu.ops.sampling import \
    farthest_point_sample_bucketed as jbucketed
from dispu_tpu.parallel.mesh import make_mesh as jmake_mesh
from dispu_tpu.parallel.mesh import shard_batch as jshard_batch
from dispu_tpu.parallel.sharded_eval import sharded_cd_hd as jsharded_cd_hd
from dispu_tpu.models.discriminator import PatchDiscriminator as JDisc
from dispu_tpu.train.gan_steps import GANState as JGANState
from dispu_tpu.train.gan_steps import make_gan_train_step as jmake_gan
from dispu_tpu.train.state import GeneratorState as JGeneratorState
from dispu_tpu.train.state import adam_transform
from dispu_tpu.train.steps import make_eval_step as jmake_eval
from dispu_tpu.train.steps import make_train_step as jmake_step
from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig
from dispu_tpu_torch.convert import (_torch_key, from_flax_variables,
                                     from_jax_gan_state, from_jax_state)
from dispu_tpu_torch.inference import PatchUpsampler
from dispu_tpu_torch.parallel import dryrun
from dispu_tpu_torch.train.gan_steps import create_gan_state
from dispu_tpu_torch.train.state import create_generator_state
from test_torch_gan import _gan_cfgs, assert_gan_steps_match, jax_gan_snapshot
from test_torch_generator import perturbed_numpy_tree
from test_torch_stream import _assert_close_as_clouds, _assert_same_cloud_16x
from test_torch_train import (_assert_leaves, _cfgs, assert_steps_match,
                              jax_step_snapshot)

torch.set_num_threads(1)

W = 2
#: every spawn's limit: a hung collective costs one test, not the suite.
#: Alone the spawns end in 25-45 s; the limit leaves room for a loaded
#: machine, where all of them run beside the JAX side and other workers
SPAWN_TIMEOUT = 240.0
SMALL = dict(num_points=64, knn=8, refine_nsample=8)
INF = dict(patch_num_point=64, patch_batch=3)  # 3: rounded up to 4
EVAL_SIZES = [(1000, 800), (1003, 777)]


def _replicated(mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec()))


def _from_port(module, init, *args) -> dict:
    """The flax variables of ``init(key, *args)`` holding the values of the
    port's ``module`` (its seeded init): the tree's structure from
    ``jax.eval_shape``, so no JAX init is compiled."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    sd = module.state_dict()

    def walk(tree, prefix):
        out = {}
        for name, leaf in tree.items():
            path = prefix + (str(name),)
            if hasattr(leaf, "items"):
                out[name] = walk(leaf, path)
                continue
            key, transpose = _torch_key(path)
            arr = sd[key].numpy()
            out[name] = np.ascontiguousarray(arr.T if transpose else arr)
        return out

    return {coll: walk(tree, ()) for coll, tree in shapes.items()}


def _jax_gen_state(jcfg, tcfg, seed: int):
    """A perturbed JAX ``GeneratorState`` (from the port's seeded init)
    and the port's state converted back from it."""
    dummy = jnp.zeros((1, jcfg.generator.num_points, 3), jnp.float32)
    init = JDisPUGenerator(cfg=jcfg.generator).init
    tree = perturbed_numpy_tree(_from_port(
        create_generator_state(tcfg.generator, device="cpu").model,
        lambda key, x: init(key, x, train=False), dummy), seed)
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    js = JGeneratorState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           tree.get("batch_stats", {})),
        opt_state=adam_transform(jcfg.train).init(params),
        epoch=jnp.zeros((), jnp.float32), step=jnp.zeros((), jnp.int32))
    ts = create_generator_state(tcfg.generator, device="cpu")
    from_jax_state(ts, jax.device_get(js))
    return js, ts


def _batch():
    rng = np.random.RandomState(1)
    gt = rng.randn(4, 128, 3).astype(np.float32) * 0.3
    return gt, gt[:, ::4].copy(), np.ones(4, np.float32)


def _jax_steps(make, jcfg, js, batch, mesh, steps):
    """``steps`` JAX mesh steps from ``js`` on the sharded batch."""
    step = make(jcfg, mesh=mesh, donate=False)
    state = _replicated(mesh, js)
    sharded = jshard_batch(mesh, *batch)
    out = []
    for _ in range(steps):
        state, metrics = step(state, *sharded, jax.random.PRNGKey(0))
        out.append((jax.device_get(state), jax.device_get(metrics)))
    return out


def _cli_command(log_dir):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(W), "-m", "dispu_tpu_torch.cli",
            "--phase", "train", "--device", "cpu", "--synthetic", "8",
            "--batch_size", "4", "--epochs", "1", "--patch_num_point", "32",
            "--steps_per_print", "1", "--log_dir", str(log_dir)]


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The 4-process dry run and the CLI's training under
    ``torch.distributed.run``, started before ``world``'s JAX work so that
    they run beside it; their tests wait for them."""
    out = tmp_path_factory.mktemp("dryrun4")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dry = dryrun.Ranks(4, str(out), timeout=SPAWN_TIMEOUT)
    cli_log = open(out / "cli.log", "w+")
    cli = subprocess.Popen(
        _cli_command(out / "cli_run"), cwd=repo, stdout=cli_log,
        stderr=subprocess.STDOUT, start_new_session=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo))
    try:
        yield dict(dry=dry, cli=cli, cli_log=cli_log,
                   log_dir=out / "cli_run",
                   deadline=time.monotonic() + SPAWN_TIMEOUT)
    finally:
        dry.close()
        if cli.poll() is None:  # the launcher and its workers
            os.killpg(cli.pid, signal.SIGKILL)
            cli.wait()
        cli_log.close()


@pytest.fixture(scope="module")
def world(tmp_path_factory, background):
    """The W ranks' results and the JAX package's on the same inputs."""
    out = tmp_path_factory.mktemp("parallel")
    jmesh = jmake_mesh(num_devices=W)
    rng = np.random.RandomState(0)
    cases = {}

    # CD steps: two of the default generator, one with batch norm in
    # every layer (against the port alone)
    batch = _batch()
    for name, gen in (("cd", None), ("cd_bn", dict(use_bn=True))):
        jcfg, tcfg = _cfgs(gen, random_input=False, augment=False)
        js, ts = _jax_gen_state(jcfg, tcfg, 5)
        cases[name] = dict(cfg=tcfg, state=ts.state_dict(),
                           steps=1 if gen else 2,
                           batch=tuple(map(torch.from_numpy, batch)))
        if gen is None:
            jcd = (jcfg, js)
            cases["eval_step"] = dict(cfg=tcfg, state=ts.state_dict(),
                                      batch=cases[name]["batch"])
    # one CD step at bf16 compute, from the default step's state
    jbf, tbf = (dataclasses.replace(c, train=dataclasses.replace(
        c.train, compute_dtype="bfloat16"))
        for c in (jcd[0], cases["cd"]["cfg"]))
    cases["cd_bf16"] = dict(cfg=tbf, state=cases["cd"]["state"], steps=1,
                            batch=cases["cd"]["batch"])
    # the training input's draws and augmentation (the port's own init)
    _, tcfg = _cfgs()
    gt = rng.randn(4, 128, 3).astype(np.float32) * 0.3
    cases["cd_drawn"] = dict(
        cfg=tcfg, state=create_generator_state(tcfg.generator,
                                               device="cpu").state_dict(),
        batch=(torch.from_numpy(gt), torch.ones(4)))
    cases["cd_refused"] = dict(cfg=dataclasses.replace(
        tcfg, train=dataclasses.replace(tcfg.train, batch_size=5)))
    # a GAN step, on the CD steps' batch
    jgcfg, tgcfg = _gan_cfgs()
    jgen, _ = _jax_gen_state(jgcfg, tgcfg, 5)
    tg = create_gan_state(tgcfg, device="cpu")
    dummy = jnp.zeros((1, jgcfg.generator.num_out_points, 3), jnp.float32)
    d_params = jax.tree_util.tree_map(jnp.asarray, perturbed_numpy_tree(
        _from_port(tg.disc, JDisc(cfg=jgcfg.discriminator).init, dummy,
                   dummy), 6)["params"])
    jg = JGANState(gen=jgen, d_params=d_params,
                   d_opt_state=adam_transform(jgcfg.train).init(d_params))
    from_jax_gan_state(tg, jax.device_get(jg))
    cases["gan"] = dict(cfg=tgcfg, state=tg.state_dict(),
                        batch=cases["cd"]["batch"])
    disc0 = {n: p.detach().numpy().copy()
             for n, p in tg.disc.named_parameters()}
    # batch norm alone
    x = (rng.randn(2 * W, 10, 6, 5) * 2 + 1).astype(np.float32)
    cases["bn"] = dict(x=x, w=rng.randn(*x.shape).astype(np.float32),
                       scale=rng.uniform(0.5, 1.5, 5).astype(np.float32),
                       bias=rng.randn(5).astype(np.float32),
                       mean=rng.randn(5).astype(np.float32),
                       var=rng.uniform(0.5, 1.5, 5).astype(np.float32))
    # sharded evaluation
    cases["eval"] = dict(pairs=[(rng.randn(a, 3).astype(np.float32),
                                 rng.randn(b, 3).astype(np.float32))
                                for a, b in EVAL_SIZES])
    # serving, on a flax init converted
    init = JDisPUGenerator(cfg=JGeneratorConfig(**SMALL)).init
    model = PatchUpsampler(gen_cfg=GeneratorConfig(**SMALL),
                           device="cpu").model
    variables = perturbed_numpy_tree(_from_port(
        model, lambda key, x: init(key, x, train=False),
        jnp.zeros((1, 64, 3), jnp.float32)), 0, scale=0.05)
    from_flax_variables(model, variables)
    clouds = np.random.RandomState(256).randn(2, 128, 3).astype(np.float32)
    cases["serve"] = dict(
        gen_cfg=GeneratorConfig(**SMALL), model=model.state_dict(),
        clouds=clouds, inf_cfgs={f"{r}x": InferenceConfig(final_ratio=r,
                                                          **INF)
                                 for r in (4, 16)})
    # the SPMD serving export of the same upsampler at 4×
    inf4 = InferenceConfig(final_ratio=4, **INF)
    cases["serve_export"] = dict(
        gen_cfg=GeneratorConfig(**SMALL), model=model.state_dict(),
        cloud=clouds[0], inf_cfg=inf4, path=str(out / "export"))
    # the bucketed merge
    points = rng.randn(2, 3001, 3).astype(np.float32)
    cases["merge"] = dict(points=points, npoint=700, n_buckets=8,
                          bad_buckets=7)
    # a trainer epoch
    cases["trainer"] = dict(cfg=dryrun.tiny_experiment(train=dict(
        batch_size=4, epoch_per_save=1, steps_per_print=1,
        backup_sources=False)), patches=12, epochs=1)

    torch.save(cases, out / "cases.pt")
    ranks = dryrun.Ranks(W, str(out), cases=out / "cases.pt",
                         timeout=SPAWN_TIMEOUT)
    try:
        # the JAX package's mesh functions while the ranks run
        ref = {}
        ref["cd"] = [jax_step_snapshot(s, m) for s, m in _jax_steps(
            jmake_step, *jcd, batch, jmesh, 2)]
        ref["gan"] = [jax_gan_snapshot(s, m) for s, m in _jax_steps(
            jmake_gan, jgcfg, jg, batch, jmesh, 2)]
        ref["cd_bf16"] = [jax_step_snapshot(s, m) for s, m in _jax_steps(
            jmake_step, jbf, jcd[1], batch, jmesh, 1)]
        gt_, inputs_, radius_ = jshard_batch(jmesh, *batch)
        coarse, fine, metrics = jmake_eval(jcd[0], mesh=jmesh)(
            _replicated(jmesh, jcd[1].variables()), inputs_, gt_, radius_)
        ref["eval_step"] = dict(coarse=np.asarray(coarse),
                                fine=np.asarray(fine),
                                metrics={k: float(v)
                                         for k, v in metrics.items()})
        ref["eval"] = [tuple(float(v) for v in jsharded_cd_hd(
            jmesh, jnp.asarray(p), jnp.asarray(g)))
            for p, g in cases["eval"]["pairs"]]
        ref["merge"] = np.stack([np.asarray(jbucketed(
            700, jnp.asarray(pts), n_buckets=8, mesh=jmesh))
            for pts in points])
        # the JAX package's staged path at 4×; at 16× its fused path
        # stands for both (tests/test_inference.py pins the two equal)
        for r, modes in ((4, ("staged", "fused")), (16, ("fused",))):
            inf = JInferenceConfig(final_ratio=r, **INF)
            for mode in modes:
                jup = JPatchUpsampler(variables,
                                      gen_cfg=JGeneratorConfig(**SMALL),
                                      inf_cfg=inf, mesh=jmesh,
                                      mesh_fused=mode == "fused")
                ref[f"{r}x/{mode}"] = np.asarray(jup.upsample(clouds[0]))
            ref[f"{r}x/fused_many"] = np.asarray(jup.upsample_many(clouds))
        ref["16x/staged"] = ref["16x/fused"]
        ref["4x/one_device"] = np.asarray(JPatchUpsampler(
            variables, gen_cfg=JGeneratorConfig(**SMALL),
            inf_cfg=JInferenceConfig(final_ratio=4, **INF)).upsample(
            clouds[0]))
        ref["bn"] = _flax_bn(cases["bn"])
    except BaseException:
        ranks.close()
        raise
    results = ranks.join()
    return dict(ranks=results, ref=ref, cases=cases, disc0=disc0,
                gan_cfg=tgcfg)


def _flax_bn(spec):
    """flax's BatchNorm in training mode on the whole batch: y, the input
    gradient, the parameter gradients and the running statistics."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.95,
                       epsilon=1e-3)
    params = {"scale": spec["scale"], "bias": spec["bias"]}
    stats = {"mean": spec["mean"], "var": spec["var"]}

    def f(p, xx):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * spec["w"]), (y, upd["batch_stats"])

    (_, (y, new)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(spec["x"]))
    return dict(y=np.asarray(y), x_grad=np.asarray(gx),
                scale_grad=np.asarray(gp["scale"]),
                bias_grad=np.asarray(gp["bias"]),
                mean=np.asarray(new["mean"]), var=np.asarray(new["var"]))


def _mesh(world, name, rank=0):
    return world["ranks"][rank][name]["mesh"]


def _plain(world, name):
    return world["ranks"][0][name]["plain"]


# -------------------------------------------------------------- evaluation


@pytest.mark.parametrize("pair", range(len(EVAL_SIZES)),
                         ids=[f"{a}_{b}" for a, b in EVAL_SIZES])
@pytest.mark.parametrize("against", ["jax", "one_process"])
def test_sharded_cd_hd(world, pair, against):
    """Sharded (cd, hd) of clouds that W does not always divide, against
    the JAX package's ``sharded_cd_hd`` at the same W and against the
    port's one-process ``nn_distance``, to 1e-5 relative."""
    got = _mesh(world, "eval")["pairs"][pair]
    want = (world["ref"]["eval"][pair] if against == "jax"
            else _plain(world, "eval")["pairs"][pair])
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------------- train steps


def test_cd_bf16_mesh_step(world):
    """One CD step at bf16 compute on the mesh (W = 2), against the port's
    one-process bf16 step and the JAX package's mesh step at bf16.  At
    bf16 a weight's gradient is a bf16 product: one process rounds the
    sum over the whole batch once, the mesh rounds each half and
    averages the two in f32, so each gradient leaf is held to 1e-2 of
    its largest (seen 4.3e-3, one bf16 ulp), and the metrics, f32 sums of
    f32 losses, to 1e-5 (seen bit-equal).  Against JAX,
    ``test_torch_bf16``'s bounds for one step: metrics to 5e-2 relative
    (seen 1.1e-2), the whole gradient to 5e-2 in L2 norm (seen 2.8e-2).
    Every gradient and moment came back f32."""
    from test_torch_bf16 import _l2_rel
    from test_torch_train import _leaf_rels

    got = _mesh(world, "cd_bf16")["steps"][0]
    plain = _plain(world, "cd_bf16")["steps"][0]
    want = world["ref"]["cd_bf16"][0]
    for k, v in plain["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=5e-2, err_msg=k)
    assert max(_leaf_rels(got["gen"]["grads"],
                          plain["gen"]["grads"]).values()) <= 1e-2
    assert _l2_rel(got["gen"]["grads"], want["gen"]["grads"]) <= 5e-2
    assert all(v.dtype == np.float32 for part in ("grads", "mu", "nu")
               for v in got["gen"][part].values())


def test_cd_mesh_step_matches_jax(world):
    """Two CD steps on the mesh against the JAX package's mesh step, with
    ``test_torch_train.check_steps_match_jax``'s bounds: the average of
    the local gradients, through the refiner's weight net's batch norm
    with its moments summed over the mesh, is the global loss's."""
    assert_steps_match(_mesh(world, "cd")["steps"], world["ref"]["cd"])


@pytest.mark.parametrize("name", ["cd", "cd_drawn"])
def test_cd_mesh_step_matches_one_process(world, name):
    assert_steps_match(_mesh(world, name)["steps"],
                       _plain(world, name)["steps"])


#: one step with batch norm after every dense layer: each gradient leaf
#: within this share of its largest entry.  In f32 this configuration
#: amplifies round-off: the port's one-process step and the JAX package's
#: single-device step differ by up to 1e-3 of a leaf's largest (seen), the
#: mesh step and the one-process one by 1.9e-4.  A wrong 1/W would be
#: off by a factor of 2.  (Against the JAX package the 1/W is held by the
#: default generator's step, whose refiner carries batch norm.)
BN_GRAD_REL = 2e-3


def test_cd_bn_mesh_step_gradients(world):
    """A CD step with batch norm in every layer: the gradient through the
    moments' all-reduce and the 1/W average is the global loss's, against
    the port's one-process step, each leaf within ``BN_GRAD_REL`` of its
    largest entry, with ``_assert_leaves``' floor for the leaves whose
    gradient vanishes in exact arithmetic (a dense bias ahead of batch
    norm, which takes the mean out: round-off of the largest gradient);
    the metrics to 1e-5."""
    got = _mesh(world, "cd_bn")["steps"][0]
    want = _plain(world, "cd_bn")["steps"][0]
    for k in want["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-5, err_msg=k)
    _assert_leaves(got["gen"]["grads"], want["gen"]["grads"], BN_GRAD_REL,
                   "grad")


def test_mesh_step_draws_are_the_one_process_draws(world):
    """``random_input`` and ``augment``: every process draws on the global
    batch from the same generator, so the draws are the one-process
    step's, bit for bit."""
    got, want = _mesh(world, "cd_drawn")["draws"], _plain(
        world, "cd_drawn")["draws"]
    assert [n for n, _ in got] == [n for n, _ in want] == [
        "sample", "augment"] * 2
    for (_, a), (_, b) in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_gan_mesh_step_matches_jax(world):
    assert_gan_steps_match(_mesh(world, "gan")["steps"], world["ref"]["gan"],
                           world["gan_cfg"], world["disc0"])


def test_gan_mesh_step_matches_one_process(world):
    assert_gan_steps_match(_mesh(world, "gan")["steps"],
                           _plain(world, "gan")["steps"], world["gan_cfg"],
                           world["disc0"])


@pytest.mark.parametrize("against", ["jax", "one_process"])
def test_mesh_eval_step_matches(world, against):
    """The evaluation step on the mesh (each process's rows, the points
    gathered, the metrics global) against the JAX package's mesh
    ``make_eval_step`` and the port's one-process step, with
    ``test_torch_train.test_eval_step_matches_jax``'s bounds; the same in
    every process."""
    got = _mesh(world, "eval_step")
    want = (world["ref"]["eval_step"] if against == "jax"
            else _plain(world, "eval_step"))
    for k in ("coarse", "fine"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    other = _mesh(world, "eval_step", 1)
    assert other["metrics"] == got["metrics"]
    np.testing.assert_array_equal(other["fine"], got["fine"])


@pytest.mark.parametrize("name", ["cd", "cd_bn", "cd_drawn", "gan"])
def test_mesh_state_is_the_same_in_every_process(world, name):
    """Replicated state: every rank's parameters, moments, buffers and
    metrics are rank 0's, bit for bit."""
    for a, b in zip(_mesh(world, name, 0)["steps"],
                    _mesh(world, name, 1)["steps"]):
        assert a["metrics"] == b["metrics"]
        for net in ("gen", "disc"):
            for part in a.get(net, {}):
                for k, v in a[net][part].items():
                    np.testing.assert_array_equal(v, b[net][part][k])


def test_batch_that_the_mesh_does_not_divide_raises(world):
    assert "does not divide" in _mesh(world, "cd_refused")["refused"]


def test_batchnorm_global_moments_match_flax(world):
    """Batch norm on each process's rows, the moments summed over the mesh:
    flax's on the whole batch, the running statistics to 1e-6, the output
    and the gradients to ``test_batchnorm_training_matches_flax``'s
    bounds."""
    got, want = _mesh(world, "bn"), world["ref"]["bn"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["x_grad"], want["x_grad"], rtol=1e-4,
                               atol=1e-5)
    for k in ("scale_grad", "bias_grad"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------------- serving


#: the JAX package's mesh paths (its staged path, its single-program
#: ``mesh_fused`` one and that one's ``upsample_many``), each held against
#: the port's one mesh path: ``upsample``, or ``upsample_many`` for
#: ``fused_many``
SERVED = [f"{r}x/{m}" for r in (4, 16) for m in ("staged", "fused",
                                                 "fused_many")]
CALLS = [f"{r}x/{c}" for r in (4, 16) for c in ("upsample", "many")]


def _check(key):
    return _assert_close_as_clouds if key.startswith("4x") else \
        _assert_same_cloud_16x


def _assert_clouds(got, want, key):
    assert got.shape == want.shape
    for g, w in zip(got.reshape(-1, *want.shape[-2:]),
                    want.reshape(-1, *want.shape[-2:])):
        _check(key)(g, w)


@pytest.mark.parametrize("key", SERVED)
def test_mesh_upsampler_matches_jax(world, key):
    """The mesh upsampler's ``upsample`` against the JAX package's staged
    and fused mesh upsamplers, its ``upsample_many`` against the fused
    one's, with ``test_torch_inference``'s (4×) and ``test_torch_stream``'s
    (16×) bounds."""
    label, mode = key.split("/")
    call = "many" if mode == "fused_many" else "upsample"
    _assert_clouds(_mesh(world, "serve")[f"{label}/{call}"],
                   world["ref"][key], key)


@pytest.mark.parametrize("key", CALLS)
def test_mesh_upsampler_matches_one_process(world, key):
    _assert_clouds(_mesh(world, "serve")[key], _plain(world, "serve")[key],
                   key)


@pytest.mark.parametrize("against", ["jax", "one_process"])
def test_sharded_bucketed_merge_bit_equal(world, against):
    got = _mesh(world, "merge")["idx"]
    want = (world["ref"]["merge"] if against == "jax"
            else _plain(world, "merge")["idx"])
    np.testing.assert_array_equal(got, want)


def test_sharded_bucketed_merge_refuses_indivisible_buckets(world):
    assert "must be divisible by the data axis" in _mesh(world, "merge")[
        "refused"]


# ------------------------------------------------------ SPMD serving export


@pytest.fixture(scope="module")
def fresh_launch(world, tmp_path_factory):
    """A new launch of W processes that loads the SPMD artifact the
    ``world`` launch exported and serves its cloud (the one spawn of the
    export's tests)."""
    out = tmp_path_factory.mktemp("spmd_serve")
    spec = world["cases"]["serve_export"]
    torch.save({"serve_load": dict(path=os.path.join(spec["path"], "mesh"),
                                   cloud=spec["cloud"])}, out / "cases.pt")
    return dryrun.spawn(W, str(out), cases=out / "cases.pt",
                        timeout=SPAWN_TIMEOUT)


def _exported(world, rank=0):
    return world["ranks"][rank]["serve_export"]["mesh"]


def test_spmd_export_manifest(world):
    """Rank 0 wrote, both ranks return the same manifest: ``nr_devices``
    W, the default group, the functional all-gather and the mesh-less
    entry's kernel ops."""
    entry = _exported(world)["manifest"]["entries"][0]
    # rank 0's as written (tuples), rank 1's as read back (lists)
    assert _exported(world, 1)["manifest"] == json.loads(json.dumps(
        _exported(world)["manifest"]))
    assert (entry["n"], entry["nr_devices"], entry["group"]) == (128, W, "0")
    assert entry["collectives"] == [
        "_c10d_functional::all_gather_into_tensor",
        "_c10d_functional::wait_tensor"]
    plain = _plain(world, "serve_export")["manifest"]["entries"][0]
    assert (plain["nr_devices"], plain.get("group")) == (1, None)
    assert entry["kernels"] == plain["kernels"] == ["fps", "knn"]


@pytest.mark.parametrize("rank", range(W))
def test_spmd_export_serves_live_bits(world, rank):
    """Loaded by the processes that exported it, the entry returns the
    live mesh path's bits in every process."""
    got = _exported(world, rank)
    np.testing.assert_array_equal(got["served"], got["live"])
    np.testing.assert_array_equal(got["live"], _exported(world)["live"])


@pytest.mark.parametrize("rank", range(W))
def test_spmd_export_failing_in_rank0_raises_in_every_rank(world, rank):
    """A second export into the same path whose weights do not fit the
    generator fails in rank 0, which alone loads them; every rank raises,
    and none returns the manifest that the first export left there."""
    err = _exported(world, rank)["failed_export"]
    if rank == 0:
        assert err.startswith("RuntimeError: Error(s) in loading state_dict")
    else:
        assert err.startswith("RuntimeError: the export into ")
        assert "failed in the process that writes it" in err


@pytest.mark.parametrize("rank", range(W))
def test_spmd_artifact_serves_in_a_fresh_launch(world, fresh_launch, rank):
    """A new launch of W processes serves the live mesh path's bits, and
    imports none of the model code to do it."""
    got = fresh_launch[rank]["serve_load"]["mesh"]
    np.testing.assert_array_equal(got["served"], _exported(world)["live"])
    assert got["imported"] == []
    assert got["manifest"]["entries"][0]["nr_devices"] == W


def test_spmd_artifact_matches_jax_one_device(world, fresh_launch):
    """Against the JAX package's one-device ``upsample`` of the same flax
    variables, ``test_torch_inference.py::test_upsample_matches_jax``'s
    bounds: ≥ 99% of rows within 1e-3 and each set within 1e-3 of the
    other (f32 round-off of the patches can flip near-tied kNN and merge
    picks)."""
    got = fresh_launch[0]["serve_load"]["mesh"]["served"]
    want = world["ref"]["4x/one_device"]
    assert got.shape == want.shape == (512, 3)
    assert np.isfinite(got).all()
    assert (np.abs(got - want).max(axis=1) <= 1e-3).mean() >= 0.99
    d = np.sum((got[:, None, :] - want[None, :, :]) ** 2, axis=-1)
    assert np.sqrt(d.min(axis=1)).max() <= 1e-3
    assert np.sqrt(d.min(axis=0)).max() <= 1e-3


@pytest.mark.parametrize("group", ["none", "world_size_1"])
def test_spmd_artifact_refuses_another_world_size(world, tmp_path, group):
    """A W-process entry never serves in one process: without a process
    group, or in a group of one, loading raises naming both counts."""
    import torch.distributed as dist

    from dispu_tpu_torch.serving import ServedUpsampler

    path = os.path.join(world["cases"]["serve_export"]["path"], "mesh")
    if group == "none":
        with pytest.raises(ValueError, match=f"exported for {W} processes"
                           r".*\(0 processes\)"):
            ServedUpsampler(path)
        return
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/g",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match=f"exported for {W} processes"
                           ".*the default process group has 1"):
            ServedUpsampler(path)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------- trainer, launcher


def test_trainer_rank0_writes_and_every_rank_restores(world):
    """One epoch of 3 steps: rank 0 alone writes (one scalar line a step,
    one epoch line), both ranks restore the checkpoint bit-equal to their
    trained state, and the two states are the same."""
    a, b = _mesh(world, "trainer", 0), _mesh(world, "trainer", 1)
    assert a["replicated"] and b["replicated"]
    assert (a["writer"], b["writer"]) == (True, False)
    assert a["steps"] == b["steps"] == 3
    assert a["scalar_lines"] == 3 and a["log_lines"] == 1
    assert {"args.txt", "scalars.jsonl", "log_train.txt",
            "model-1.pt"} <= set(a["files"])
    assert a["restored_equal"] and b["restored_equal"]
    assert a["digest"] == b["digest"]


def test_trainer_broadcasts_rank0_state(world):
    """Rank 1's trainer starts from a state of another seed: the broadcast
    at the start makes rank 0's state every process's, so both end on the
    same state, and that state is the one-process trainer's from rank 0's
    start: ``dryrun.TRAINED_SHARE`` of its entries within 1e-5 a step (the
    rest: Adam's ±lr steps where a gradient was round-off).  Were rank 1
    to keep its own start, its parameters would differ by their init."""
    a, b = _mesh(world, "trainer", 0), _mesh(world, "trainer", 1)
    assert a["replicated"] and b["replicated"]
    assert a["digest"] == b["digest"]
    assert a["near_plain"] >= dryrun.TRAINED_SHARE


def test_torchrun_cli_trains_data_parallel(background):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    dispu_tpu_torch.cli --phase train --device cpu``: the trainers build
    their mesh from the launcher's environment, and only rank 0 writes
    (each step's scalars once)."""
    import json

    cli, log = background["cli"], background["log_dir"]
    try:
        cli.wait(timeout=max(1.0, background["deadline"] - time.monotonic()))
    except subprocess.TimeoutExpired:
        os.killpg(cli.pid, signal.SIGKILL)
        cli.wait()
    background["cli_log"].seek(0)
    output = background["cli_log"].read()[-6000:]
    assert cli.returncode == 0, output
    steps = [json.loads(ln)["step"]
             for ln in open(log / "scalars.jsonl").read().splitlines()]
    assert steps == [1, 2]
    epochs = [ln.split()[1] for ln in open(log / "log_train.txt")
              if ln.startswith("epoch")]
    assert epochs == ["0001"]
    assert (log / "model-1.pt").exists()


def test_dryrun_on_four_processes(background, capsys):
    """The dry run (``dryrun_multichip(4)``'s ranks): every mesh path on 4
    gloo processes at sizes that 4 does not divide (clouds of 1003 and 777
    points, ``patch_batch`` 3, 6 patches, 4099 merge candidates), each
    within its bound of the one-process run, the SPMD serving export
    served bit-equal to the live mesh path, and the refusals."""
    results = background["dry"].join()
    assert len(results) == 4
    lines = capsys.readouterr().out.splitlines()
    oks = [ln.split(":")[0] for ln in lines if ln.startswith("ok ")]
    assert oks == ["ok cd", "ok cd_bn", "ok cd_drawn", "ok cd_refused",
                   "ok gan", "ok eval_step", "ok bn", "ok eval", "ok serve",
                   "ok serve_export", "ok merge", "ok trainer"]
    background["results"] = results


def _four(background, name):
    results = background.get("results")
    if results is None:  # test_dryrun_on_four_processes did not join them
        results = background["dry"].join()
        background["results"] = results
    return results[0][name]


@pytest.mark.parametrize("name", ["cd", "cd_drawn", "gan"])
def test_four_process_steps_match_one_process(background, name):
    """The 4-process steps held as the 2-process ones are, against the
    one-process run: gradients, both Adam moments, the batch-norm
    statistics and the parameters, not only the metrics.  ``cd_drawn``'s
    second step is held on its metrics alone: it runs on parameters that
    Adam moved apart by ±lr where a step-1 gradient was round-off, which
    this case's draws turn into moments 4.6e-4 of a leaf's largest apart
    (seen)."""
    res = _four(background, name)
    got, want = res["mesh"]["steps"], res["plain"]["steps"]
    if name == "gan":
        cfg = dryrun.default_cases(4)["gan"]["cfg"]
        assert_gan_steps_match(got, want, cfg, res["mesh"]["disc0"])
        return
    if name == "cd_drawn":
        for k, v in want[1]["metrics"].items():
            np.testing.assert_allclose(got[1]["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
        got, want = got[:1], want[:1]
    assert_steps_match(got, want)


def test_four_process_bn_step_gradients(background):
    """``cd_bn`` on 4 processes: the first gradients within
    ``BN_GRAD_REL`` of each leaf's largest, as on 2."""
    res = _four(background, "cd_bn")
    _assert_leaves(res["mesh"]["steps"][0]["gen"]["grads"],
                   res["plain"]["steps"][0]["gen"]["grads"], BN_GRAD_REL,
                   "grad")
