"""The port's training with the turbo flags against the JAX package's, on
the CPU: the turbo gathers' backward rules, two CD steps of each setting
and the CLI (``test_torch_train_turbo_gan.py`` holds the GAN steps,
``remat`` and the turbo flags at bf16 compute the same way).

Each setting trains two CD steps and two GAN steps from one perturbed JAX
state carried over by ``convert.from_jax_state`` /
``from_jax_gan_state``, on 64-point patches (so that the backbone's
packed selection and fused gather gates, 64 ≤ n, are reached as well as
the refiner's), against the JAX package's jitted steps
(``make_train_step(jit_compile=False)``, ``make_gan_train_step``).

The generator's kNN selections are held fixed: the port's step records
the indices of its five selection sites (the dense blocks' feature kNN,
exact, packed or inside ``knn_group``, and the refiner's xyz kNN) and the
JAX step is traced with its two call sites returning them.  Without that,
near-ties between the two packages' distance round-off (distances equal
to ~1e-7, ``test_torch_neartie.py``) pick other neighbours in some
settings and move a step's metrics by up to 1e-4.  The selections
themselves are held elsewhere: the packed selection against
``knn_pallas(variant='packed', interpret=True)`` and ``knn_group``
against ``knn_group_pallas(interpret=True)`` in ``test_torch_turbo.py``.

Off the TPU the JAX package takes its composed paths (the exact kNN, the
bf16 one-hot gathers); the port takes its kernels' plain versions:
``knn_packed_torch`` and ``knn_group_torch``.  So under
``fused_grouping`` with ``fast_gather(_backbone)`` the port's gradient
is ``knn_group_pallas_diff``'s rule (an f32 scatter of the cotangent)
where the JAX package's is the bf16 one-hot's transpose; the rules
themselves are held below, each against its JAX form.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.config import DataConfig as JDataConfig
from dispu_tpu.config import ExperimentConfig as JExperimentConfig
from dispu_tpu.config import GeneratorConfig as JGeneratorConfig
from dispu_tpu.config import LossConfig as JLossConfig
from dispu_tpu.config import TrainConfig as JTrainConfig
from dispu_tpu.ops.pallas_kernels import knn_group_pallas_diff
from dispu_tpu.train.gan_steps import create_gan_state as jcreate_gan
from dispu_tpu.train.gan_steps import make_gan_train_step as jmake_gan
from dispu_tpu.train.state import create_generator_state as jcreate_state
from dispu_tpu.train.steps import make_train_step as jmake_step
from dispu_tpu_torch.config import (DataConfig, ExperimentConfig,
                                    GeneratorConfig, LossConfig, TrainConfig)
from dispu_tpu_torch.convert import from_jax_gan_state, from_jax_state
from dispu_tpu_torch.kernels import knn_group as tknn_group
from dispu_tpu_torch.kernels.knn_group import knn_group
from dispu_tpu_torch.ops.grouping import group_point
from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                             make_gan_train_step)
from dispu_tpu_torch.train.state import create_generator_state
from dispu_tpu_torch.train.steps import make_train_step
from dispu_tpu_torch.utils.checkpoint import current_key
from test_torch_gan import jax_gan_snapshot, port_gan_snapshot
from test_torch_generator import perturbed_numpy_tree
from test_torch_train import (_leaf_rels, jax_step_snapshot,
                              port_step_snapshot)

# the package's functions shadow their modules of the same names
jedgeconv = importlib.import_module("dispu_tpu.nn.edgeconv")
jgrouping = importlib.import_module("dispu_tpu.ops.grouping")
tedgeconv = importlib.import_module("dispu_tpu_torch.nn.edgeconv")
tgrouping = importlib.import_module("dispu_tpu_torch.ops.grouping")

torch.set_num_threads(1)

SMALL = dict(num_points=64, knn=8, refine_nsample=8)
TURBO = dict(fast_knn=True, fast_gather=True, fast_gather_backbone=True,
             fused_grouping=True, dense_impl="split")

# ------------------------------------------------------------ the rules


def _rng_arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 3).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("b,n,m,c,k", [(2, 256, 256, 48, 16),
                                       (2, 100, 37, 5, 7)])
def test_onehot_gather_gradient_is_jax_grad_bit_equal(b, n, m, c, k):
    """The turbo gather's gradient (``Bf16GatherFunction``): the cotangent
    rounded to bf16, summed in f32 into the table's rows, the sum rounded
    to bf16, which is the transpose of the JAX package's bf16 one-hot
    contraction as XLA computes it.  Bound: bit-equal, value and gradient,
    repeated indices included (a row gathered many times sums many
    cotangents)."""
    pts, g = _rng_arrays(0, (b, n, c), (b, m, k, c))
    idx = np.random.RandomState(1).randint(0, n, (b, m, k)).astype(np.int32)
    idx[:, :, 0] = 3  # one row gathered by every query

    def f(p):
        out = jgrouping.group_point(p, jnp.asarray(idx), impl="onehot")
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jgrad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(pts))
    tp = torch.from_numpy(pts).requires_grad_(True)
    out = group_point(tp, torch.from_numpy(idx), "onehot")
    torch.sum(out * torch.from_numpy(g)).backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tp.grad.numpy(), np.asarray(jgrad))
    # the plain gather's gradient (autograd's scatter of the f32
    # cotangent) is not it
    plain = torch.from_numpy(pts).requires_grad_(True)
    torch.sum(group_point(plain, torch.from_numpy(idx))
              * torch.from_numpy(g)).backward()
    assert not torch.equal(plain.grad, tp.grad)


def test_onehot_gather_gradient_at_bf16_compute():
    """At bf16 compute the table, the gathered rows and the cotangent are
    bf16; the gradient is still the f32 sum of the cotangents rounded once
    to bf16, as ``jax.grad`` of the bf16 contraction gives it.  Bound:
    bit-equal."""
    pts, g = _rng_arrays(2, (2, 64, 24), (2, 64, 8, 24))
    idx = np.random.RandomState(3).randint(0, 64, (2, 64, 8)).astype(np.int32)
    jp, jg = (jnp.asarray(a, jnp.bfloat16) for a in (pts, g))

    def f(p):
        return jnp.sum((jgrouping.group_point(p, jnp.asarray(idx),
                                              impl="onehot")
                        * jg).astype(jnp.float32))

    jgrad = np.asarray(jax.grad(f)(jp).astype(jnp.float32))
    tp = torch.from_numpy(pts).to(torch.bfloat16).requires_grad_(True)
    out = group_point(tp, torch.from_numpy(idx), "onehot")
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(tp.grad.float().numpy(), jgrad)


@pytest.mark.parametrize("mode", ["refiner", "backbone"])
def test_knn_group_turbo_rule_matches_jax_vjp(mode):
    """``KnnGroupFunction``'s backward in turbo mode (``exact=False``)
    against ``jax.vjp`` of ``knn_group_pallas_diff(interpret=True,
    exact=False)``, ``_knn_group_bwd``: the grouped features' cotangent
    scattered back in f32 with no bf16 rounding, the xyz's too, and the
    distances' ``2·g·(q − p)``.  The refiner's grouping (xyz and 32
    features) and the backbone's edge gather (one tensor as points,
    queries and features, ``drop_first`` with the duplicate bias).  The
    selections and the gathered rows are bit-equal, the distances within
    1e-6 of the largest (at c = 24 the kernel's products sum in another
    order); gradients within 1e-6 of each one's largest (the scatter-adds
    sum in other orders)."""
    b, n, k = 2, 128, 8
    if mode == "refiner":
        xyz, feats = _rng_arrays(4, (b, n, 3), (b, n, 32))
        bias, kw = None, dict(with_xyz=True, drop_first=False)
        args = [xyz, xyz, feats]
    else:
        (feats,) = _rng_arrays(5, (b, n, 24))
        feats[:, -4:] = feats[:, :4]  # duplicate rows, biased last
        dup = np.zeros((b, n), np.float32)
        dup[:, -4:] = 1e30
        bias, kw = dup, dict(with_xyz=False, drop_first=True)
        args = [feats, feats, feats]
    cot = _rng_arrays(6, (b, n, k), (b, n, k, 3), (b, n, k,
                                                    args[2].shape[-1]))

    def jfun(p, q, f):
        jb = None if bias is None else jnp.asarray(bias)
        d, i, gx, gf = knn_group_pallas_diff(k, p, q, f, jb, True, False,
                                             kw["with_xyz"],
                                             kw["drop_first"])
        return (d, gx, gf), i

    (jd, jgx, jgf), vjp, ji = jax.vjp(jfun, *map(jnp.asarray, args),
                                      has_aux=True)
    jcot = (jnp.asarray(cot[0]),
            jnp.asarray(cot[1]) if kw["with_xyz"] else None,
            jnp.asarray(cot[2]))
    jgrads = [np.asarray(t) for t in vjp(jcot)]

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    tbias = None if bias is None else torch.from_numpy(bias)
    d, i, gx, gf = knn_group(k, *leaves, tbias, exact=False, impl="torch",
                             **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(gf.detach().numpy(), np.asarray(jgf))
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=0,
                               atol=1e-6 * float(np.abs(jd).max()))
    loss = torch.sum(d * torch.from_numpy(cot[0])) + torch.sum(
        gf * torch.from_numpy(cot[2]))
    if kw["with_xyz"]:
        loss = loss + torch.sum(gx * torch.from_numpy(cot[1]))
    loss.backward()
    got = [t.grad.numpy() for t in leaves]
    if mode == "backbone":  # one tensor in the model: the three summed
        got, jgrads = [sum(got)], [sum(jgrads)]
    for g, w in zip(got, jgrads):
        assert float(np.abs(g - w).max()) <= 1e-6 * float(np.abs(w).max())


# ------------------------------------------------------------ the steps


def _cfgs(gen=None, train=None, use_gan=False):
    """(JAX, port) experiment configs on 64-point patches, the sparse
    inputs fed in, no augmentation (no random draws in a step)."""
    data = dict(num_point=64, random_input=False, augment=False)
    loss = dict(repulsion_nsample=8, repulsion_radius=0.3)
    g = dict(SMALL, **(gen or {}))
    tr = dict(dict(batch_size=4), **(train or {}))
    return (JExperimentConfig(generator=JGeneratorConfig(**g),
                              train=JTrainConfig(**tr),
                              data=JDataConfig(**data),
                              loss=JLossConfig(**loss), use_gan=use_gan),
            ExperimentConfig(generator=GeneratorConfig(**g),
                             train=TrainConfig(**tr), data=DataConfig(**data),
                             loss=LossConfig(**loss), use_gan=use_gan))


def _batch():
    rng = np.random.RandomState(1)
    gt = rng.randn(4, 256, 3).astype(np.float32) * 0.3
    return gt, gt[:, ::4].copy(), np.ones(4, np.float32)


class _Selections:
    """The port's generator selections in call order, and the JAX step
    traced with its call sites returning them.

    Port sites: ``edgeconv.knn_unique_indices`` (k + 1 columns),
    ``grouping.knn_indices`` and the ``knn_group`` kernel's indices (the
    backbone's with ``drop_first`` get a leading column, which the JAX
    package's composed path drops).  JAX sites: ``edgeconv.
    knn_unique_indices`` and ``grouping.knn_indices`` (the critic and the
    losses bind their own names and keep their selections)."""

    def __init__(self, monkeypatch):
        self.monkeypatch, self.recorded, self.queue = monkeypatch, [], []

    def record(self):
        """Patch the port's sites to record into a fresh list."""
        self.recorded = rec = []

        def keep(fn, kernel=False):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                if kernel:
                    idx = out[1].numpy()
                    if kwargs.get("drop_first"):
                        idx = np.concatenate(
                            [np.zeros_like(idx[..., :1]), idx], axis=-1)
                else:
                    idx = out.numpy()
                rec.append(idx.astype(np.int32))
                return out
            return call

        mp = self.monkeypatch
        mp.setattr(tedgeconv, "knn_unique_indices",
                   keep(tedgeconv.knn_unique_indices))
        mp.setattr(tgrouping, "knn_indices", keep(tgrouping.knn_indices))
        mp.setattr(tknn_group, "knn_group", keep(tknn_group.knn_group, True))

    def undo_port(self):
        self.monkeypatch.undo()

    def jax_step(self, raw_step):
        """``raw_step`` jitted with the selections as an argument."""
        queue = self.queue

        def site(*args, **kwargs):
            return queue.pop(0)

        @jax.jit
        def step(state, gt, inputs, radius, key, idxs):
            queue[:] = list(idxs)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jedgeconv, "knn_unique_indices", site)
                mp.setattr(jgrouping, "knn_indices", site)
                out = raw_step(state, gt, inputs, radius, key)
            assert not queue, "selections left over"
            return out

        return step


def _perturbed_jax_state(jcfg, use_gan):
    if not use_gan:
        js = jcreate_state(jax.random.PRNGKey(0), jcfg.generator, jcfg.train)
        tree = perturbed_numpy_tree({"params": js.params,
                                     "batch_stats": js.batch_stats}, 5)
        return js.replace(
            params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               tree["batch_stats"]))
    js = jcreate_gan(jax.random.PRNGKey(0), jcfg)
    gen = perturbed_numpy_tree({"params": js.gen.params,
                                "batch_stats": js.gen.batch_stats}, 5)
    crit = perturbed_numpy_tree({"params": js.d_params}, 6)
    return js.replace(
        gen=js.gen.replace(
            params=jax.tree_util.tree_map(jnp.asarray, gen["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               gen["batch_stats"])),
        d_params=jax.tree_util.tree_map(jnp.asarray, crit["params"]))


def run_pair(monkeypatch, gen=None, train=None, use_gan=False, steps=2):
    """``steps`` steps of the port and of the JAX package on one batch,
    each from the JAX package's state before it (the first a perturbed
    init) carried over to the port, and each JAX step on the port step's
    selections.  Each step starts from the JAX state because the port's
    own step leaves parameters ±lr away where a gradient was round-off
    (Adam's update is about sign(g)·lr there): on 64-point patches that
    moves a second step's metrics by up to 5e-3 in the bf16 settings and
    with batch norm, past what a step's own round-off does.  Returns
    (port snapshots, JAX snapshots)."""
    jcfg, tcfg = _cfgs(gen, train, use_gan)
    js = _perturbed_jax_state(jcfg, use_gan)
    if use_gan:
        ts = create_gan_state(tcfg, device="cpu")
        carry = from_jax_gan_state
        step = make_gan_train_step(tcfg, device="cpu")
        raw = jmake_gan(jcfg, jit_compile=False)
        snap, jsnap = port_gan_snapshot, jax_gan_snapshot
    else:
        ts = create_generator_state(tcfg.generator, device="cpu")
        carry = from_jax_state
        step = make_train_step(tcfg, device="cpu")
        raw = jmake_step(jcfg, jit_compile=False)
        snap, jsnap = port_step_snapshot, jax_step_snapshot
    sel = _Selections(monkeypatch)
    jstep = sel.jax_step(raw)
    batch = _batch()
    got, want = [], []
    for _ in range(steps):
        carry(ts, jax.device_get(js))
        sel.record()
        ts, tm = step(ts, *map(torch.from_numpy, batch), torch.Generator())
        sel.undo_port()
        got.append(snap(ts, tm))
        idxs = sel.recorded
        if tcfg.train.remat:  # the backward's recompute selects again
            half = len(idxs) // 2
            assert len(idxs) == 2 * half and all(
                np.array_equal(a, r) for a, r in zip(idxs[:half],
                                                     idxs[half:]))
            idxs = idxs[:half]
        js, jm = jstep(js, *map(jnp.asarray, batch), jax.random.PRNGKey(0),
                       [jnp.asarray(i) for i in idxs])
        want.append(jsnap(js, jm))
    return got, want


@dataclasses.dataclass(frozen=True)
class Bounds:
    """A pair's bounds, each a (step 1, step 2) pair where it has two:
    each metric relative to the larger of itself and ``metric_floor`` of
    the largest metric; step 1's generator gradients (CD: read from JAX's
    first moments, mu = 0.1·g after one step), both networks' moments (mu,
    nu: of each leaf's largest, floored at 1e-3 of the largest leaf's);
    batch-norm statistics absolute; parameters within ``param_lr`` · lr
    where both moments agree to 1e-3 relative, at least ``sure`` of them
    (Adam's update is about sign(g)·lr: noise where |g| is round-off)."""
    metric: tuple = (1e-5, 1e-5)
    metric_floor: float = 0.0
    grad: float = 1e-4
    mu: tuple = (1e-4, 2e-3)
    nu: tuple = (2e-4, 1e-3)
    bn: tuple = (1e-6, 1e-6)
    param_lr: float = 3e-3
    sure: float = 0.95


#: the exact-grade settings: ``test_torch_train.py``'s bounds at step 1
#: (seen: metrics 2.0e-6, gradients 5.5e-5, the packed selection's
#: step).  At step 2, from the JAX state after step 1, one leaf's first
#: moment moves up to 5.6e-4 of its largest (the default setting too, at
#: ``layer3.l0``): a max over the neighbours whose two largest entries lie
#: within round-off sends that gradient to the other neighbour in the two
#: packages; hence mu 2e-3, nu 1e-3 (seen 1.9e-4) there, and 95% of the
#: parameters sure (seen 0.969).
EXACT = Bounds()
#: the bf16 settings (``fast_gather``, ``fast_gather_backbone``,
#: ``fused_turbo``): a gathered value or a cotangent on a bf16 rounding
#: boundary rounds to either side when the two packages' f32 inputs differ
#: in the last bit, one bf16 ulp (2⁻⁸ = 3.9e-3 relative) of that entry;
#: under ``fused_turbo`` the port's backward is also ``knn_group``'s f32
#: scatter where the JAX package's CPU path transposes the bf16 one-hot
#: (``test_knn_group_turbo_rule_matches_jax_vjp`` holds the rule itself).
#: Seen: metrics 5.5e-6 and 9.3e-5, gradients 4.2e-3 (``fast_gather``, at
#: ``after_conv``'s bias), moments 4.2e-3 and 3.1e-3, 0.856 sure.
BF16 = Bounds(metric=(1e-4, 1e-3), grad=1e-2, mu=(1e-2, 1e-2),
              nu=(1e-2, 1e-2), sure=0.75)
#: with batch norm after every dense layer: ``test_torch_train.py``'s
#: ``use_bn`` bounds (gradients 1e-3 there, seen 4.4e-4, round-off by its
#: f64 check); here the part-split sums move them to 7.9e-4 (bound 2e-3);
#: statistics 2e-5 (seen 8.6e-6); moments 2e-3 (seen 8.5e-4); 0.83 sure.
BN = Bounds(grad=2e-3, mu=(2e-3, 2e-3), nu=(2e-3, 2e-3), bn=(2e-5, 2e-5),
            sure=0.75)


def _metric_rel(g, w, floor):
    top = max(abs(v) for v in w.values())
    return max(abs(g[k] - w[k]) / max(abs(w[k]), floor * top, 1e-30)
               for k in w)


def _adam_half(g, w, lr, i, b: Bounds):
    rel = dict(mu=max(_leaf_rels(g["mu"], w["mu"]).values()),
               nu=max(_leaf_rels(g["nu"], w["nu"]).values()))
    n_sure = n_all = 0
    param_err = 0.0
    for n, p in g["params"].items():
        sure = ((np.abs(g["mu"][n] - w["mu"][n]) <= 1e-3 * np.abs(w["mu"][n]))
                & (np.abs(g["nu"][n] - w["nu"][n])
                   <= 1e-3 * np.abs(w["nu"][n])))
        err = np.abs(p - w["params"][n])[sure]
        if err.size:
            param_err = max(param_err, float(err.max()) / lr)
        n_sure, n_all = n_sure + int(sure.sum()), n_all + sure.size
    ok = (rel["mu"] <= b.mu[i] and rel["nu"] <= b.nu[i]
          and param_err <= b.param_lr and n_sure >= b.sure * n_all)
    return ok, dict(rel, param_lr=param_err, sure=n_sure / n_all)


def assert_pair(got, want, b: Bounds, lr_d=None):
    """Hold a pair's snapshots to ``b``; the message carries every
    reading.  ``lr_d``: the critic's rate (a GAN pair)."""
    readings, ok = [], True
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"]
        assert set(g["metrics"]) == set(w["metrics"])
        r = dict(metric=_metric_rel(g["metrics"], w["metrics"],
                                    b.metric_floor))
        ok &= r["metric"] <= b.metric[i]
        if "grads" in w["gen"] and i == 0:  # mu = 0.1·g after one step
            r["grad"] = max(_leaf_rels(g["gen"]["grads"],
                                       w["gen"]["grads"]).values())
            ok &= r["grad"] <= b.grad
        good, r["gen"] = _adam_half(g["gen"], w["gen"], g["metrics"]["lr"],
                                    i, b)
        ok &= good
        if lr_d is not None:
            assert g["d_count"] == w["d_count"]
            good, r["disc"] = _adam_half(g["disc"], w["disc"], lr_d, i, b)
            ok &= good
        if w["gen"].get("buffers"):
            r["bn"] = max(float(np.abs(g["gen"]["buffers"][current_key(n)]
                                       - v).max())
                          for n, v in w["gen"]["buffers"].items())
            ok &= r["bn"] <= b.bn[i]
        readings.append(r)
    assert ok, f"readings {readings} against {b}"
    return readings


#: each setting with its bounds; fast_knn is held at the port's packed
#: selection (replayed into the JAX step), which its own test holds
#: against the JAX package's packed kernel
SETTINGS = {
    "fast_knn": (dict(fast_knn=True), EXACT),
    "fast_gather": (dict(fast_gather=True), BF16),
    "fast_gather_backbone": (dict(fast_gather_backbone=True), BF16),
    "fused_turbo": (dict(fused_grouping=True, fast_gather_backbone=True),
                    BF16),
    "split": (dict(dense_impl="split"), EXACT),
    "split_bn": (dict(dense_impl="split", use_bn=True), BN),
    "all": (TURBO, BF16),
}

#: the GAN metrics hold to their share of the largest metric, as
#: ``test_torch_gan.py``'s (the critic's gap and the repulsion lie near
#: zero)
GAN_FLOOR = 2e-6


@pytest.mark.parametrize("name", list(SETTINGS))
def test_cd_steps_match_jax(monkeypatch, name):
    """Two CD steps of each setting against the JAX package's, within the
    setting's :class:`Bounds` (module docstring: the selections
    replayed)."""
    gen, bounds = SETTINGS[name]
    assert_pair(*run_pair(monkeypatch, gen), bounds)


# -------------------------------------------------------------- the CLI


def test_cli_trains_with_the_split_dense_impl(tmp_path):
    """``python -m dispu_tpu_torch.cli --phase train --dense_impl split``
    on synthetic patches trains on the CPU and writes its checkpoint, whose
    generator is the part-split one (``dispu.py`` trains with it too);
    ``--turbo`` stays a serving flag."""
    from dispu_tpu_torch import cli
    from dispu_tpu_torch.utils.checkpoint import latest_checkpoint

    log = str(tmp_path / "log")
    argv = ["--phase", "train", "--dense_impl", "split", "--synthetic", "8",
            "--batch_size", "4", "--epochs", "1", "--device", "cpu",
            "--log_dir", log, "--patch_num_point", "64", "--turbo", "true"]
    cfg = cli.build_config(cli.parse_args(argv))
    assert cfg.generator.dense_impl == "split"
    assert not (cfg.generator.fast_knn or cfg.generator.fused_grouping)
    cli.main(argv)
    epoch, path = latest_checkpoint(log)
    assert epoch == 1
    saved = torch.load(path, weights_only=True)
    assert all(torch.isfinite(v).all() for v in saved["model"].values()
               if v.is_floating_point())
