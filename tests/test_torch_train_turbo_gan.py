"""The port's GAN training with the turbo flags, training with
``remat`` and with the turbo flags at bf16 compute, against the JAX
package's, on the CPU: ``test_torch_train_turbo.py``'s pairs (its
docstring says how the steps are paired and held), in a file of their own
so that the two halves run side by side.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dispu_tpu_torch.config import TrainConfig
from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                             make_gan_train_step)
from dispu_tpu_torch.train.state import create_generator_state
from dispu_tpu_torch.train.steps import make_train_step
from test_torch_gan import port_gan_snapshot
from test_torch_train import port_step_snapshot
from test_torch_train_turbo import (BN, EXACT, SETTINGS, TURBO, _batch,
                                    _cfgs, _metric_rel, assert_pair,
                                    run_pair)

torch.set_num_threads(1)

#: the GAN metrics hold to their share of the largest metric, as
#: ``test_torch_gan.py``'s (the critic's gap and the repulsion lie near
#: zero)
GAN_FLOOR = 2e-6


@pytest.mark.parametrize("name", list(SETTINGS))
def test_gan_steps_match_jax(monkeypatch, name):
    """Two GAN steps of each setting against the JAX package's, the CD
    pair's bounds for the generator and for the critic, the metrics
    floored at ``GAN_FLOOR`` of the largest."""
    gen, bounds = SETTINGS[name]
    bounds = dataclasses.replace(bounds, metric_floor=GAN_FLOOR)
    assert_pair(*run_pair(monkeypatch, gen, use_gan=True), bounds,
                lr_d=TrainConfig().base_lr_d)


# ----------------------------------------------------------------- remat


@pytest.mark.parametrize("name,gen,use_gan,bounds", [
    ("cd", {}, False, EXACT), ("gan", {}, True, EXACT),
    ("cd_bn", dict(use_bn=True), False, BN)],
    ids=["cd", "gan", "cd_bn"])
def test_remat_steps_match_jax(monkeypatch, name, gen, use_gan, bounds):
    """Two steps with ``remat`` in both packages (``jax.checkpoint``
    around the generator forward; ``torch.utils.checkpoint`` here), the
    setting's bounds; the total loss, as the JAX package's own remat test
    holds it against its plain step (``tests/test_train.py``), within
    1e-6 relative.  The port's recompute makes the forward's selections
    again, bit for bit (``run_pair`` checks them)."""
    if use_gan:
        bounds = dataclasses.replace(bounds, metric_floor=GAN_FLOOR)
    got, want = run_pair(monkeypatch, gen, dict(remat=True), use_gan)
    assert_pair(got, want, bounds,
                lr_d=TrainConfig().base_lr_d if use_gan else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["metrics"]["total"],
                                   w["metrics"]["total"], rtol=1e-6)


def _port_steps(tcfg, steps=2):
    """The snapshots of ``steps`` port steps from its seeded init on one
    batch."""
    if tcfg.use_gan:
        ts = create_gan_state(tcfg, seed=3, device="cpu")
        step, snap = make_gan_train_step(tcfg, device="cpu"), port_gan_snapshot
    else:
        ts = create_generator_state(tcfg.generator, seed=3, device="cpu")
        step, snap = make_train_step(tcfg, device="cpu"), port_step_snapshot
    out = []
    for _ in range(steps):
        ts, tm = step(ts, *map(torch.from_numpy, _batch()),
                      torch.Generator())
        out.append(snap(ts, tm))
    return out


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("gen,use_gan", [
    (dict(), False), (dict(), True), (dict(use_bn=True), False),
    (TURBO, False), (TURBO, True)],
    ids=["cd", "gan", "cd_bn", "cd_turbo", "gan_turbo"])
def test_remat_step_is_the_plain_step_bit_for_bit(gen, use_gan):
    """Two steps with ``remat`` and two without from one state: metrics,
    gradients, parameters, both moments and batch norm's running
    statistics bit-equal.  The recompute in the backward runs the same
    deterministic forward again, and leaves the running statistics alone,
    so they move once a step, as JAX's functional ``batch_stats`` do under
    ``jax.checkpoint``."""
    _, tcfg = _cfgs(gen, use_gan=use_gan)
    remat = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, remat=True))
    for i, (a, b) in enumerate(zip(_port_steps(remat), _port_steps(tcfg))):
        _equal_trees(a, b, f"step {i + 1}")
    if gen.get("use_bn"):  # the statistics did move
        assert any(not np.array_equal(v, 0.0) for v in
                   _port_steps(remat, 1)[0]["gen"]["buffers"].values())


# --------------------------------------------------------- bf16 compute


@pytest.mark.parametrize("use_gan", [False, True], ids=["cd", "gan"])
def test_bf16_turbo_step_matches_jax(monkeypatch, use_gan):
    """One step with every turbo flag at ``compute_dtype='bfloat16'``
    against the JAX package's, with ``test_torch_bf16.py``'s step bounds:
    each metric within 5e-2 relative (the critic's near-zero ones against
    1e-3 of the largest metric), the generator's first moments within 5e-2
    of JAX's in L2 norm; every tensor of the state f32."""
    train = dict(compute_dtype="bfloat16")
    got, want = run_pair(monkeypatch, TURBO, train, use_gan, steps=1)
    g, w = got[0], want[0]
    assert _metric_rel(g["metrics"], w["metrics"], 1e-3) <= 5e-2
    num = sum(float(np.sum((g["gen"]["mu"][k] - v) ** 2))
              for k, v in w["gen"]["mu"].items())
    den = sum(float(np.sum(v ** 2)) for v in w["gen"]["mu"].values())
    assert (num / den) ** 0.5 <= 5e-2
    for part in ("params", "mu", "nu"):
        assert all(v.dtype == np.float32 for v in g["gen"][part].values())


def test_remat_on_a_mesh_is_the_plain_mesh_step(tmp_path):
    """With a mesh the recompute in the backward runs batch norm's moment
    all-reduce again, inside ``backward()``: on two gloo processes a CD
    step (batch norm after every dense layer) and a GAN step with
    ``remat`` are bit-equal to the same mesh steps without it, in each
    process, metrics, gradients, moments and statistics."""
    from dispu_tpu_torch.parallel import dryrun
    from dispu_tpu_torch.train.state import create_generator_state

    rng = np.random.RandomState(0)
    gt = (rng.randn(4, 128, 3) * 0.3).astype(np.float32)
    batch = tuple(map(torch.from_numpy, (gt, gt[:, ::4].copy(),
                                         np.ones(4, np.float32))))
    fed = dict(data=dict(random_input=False, augment=False),
               train=dict(batch_size=4))
    cases = {}
    for name, kw in (("cd_bn", dict(generator=dict(use_bn=True))),
                     ("gan", dict(use_gan=True))):
        cfg = dryrun.tiny_experiment(**kw, **fed)
        state = (create_gan_state(cfg, device="cpu") if cfg.use_gan else
                 create_generator_state(cfg.generator, device="cpu"))
        for key, remat in ((name, False), (name.split("_")[0] + "_remat",
                                           True)):
            c = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, remat=remat))
            cases[key] = dict(cfg=c, state=state.state_dict(), batch=batch,
                              steps=1)
    torch.save(cases, tmp_path / "cases.pt")
    results = dryrun.Ranks(2, str(tmp_path), cases=tmp_path / "cases.pt",
                           timeout=120.0).join()
    for rank in results:
        for plain, remat in (("cd_bn", "cd_remat"), ("gan", "gan_remat")):
            a = rank[remat]["mesh"]["steps"][0]
            b = rank[plain]["mesh"]["steps"][0]
            assert a["metrics"] == b["metrics"]
            for net in ("gen", "disc"):
                if net in b:
                    for part in ("params", "grads", "mu", "nu", "buffers"):
                        for k, v in b[net][part].items():
                            np.testing.assert_array_equal(
                                a[net][part][k], v, err_msg=f"{net} {k}")
