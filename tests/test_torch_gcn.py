"""The port's DeepGCN blocks (``nn/gcn.py``) against the JAX package's, on
the CPU.

The first graph is a kNN over the input xyz and is bit-equal.  Later
graphs are kNN over computed features, where the two packages' distance
round-off may pick another neighbour at a near-tie (ROADMAP.md, queue 3):
there JAX's indices are recorded and replayed into the port, as
tests/test_torch_neartie.py does for the generator, and the outputs held
to 1e-5 of their largest entry (or 1e-5 below 1).  The stochastic
dilation's draw comes from ``jax.random`` there and from a
``torch.Generator`` here: JAX's own draw is fed to the port's selection
rule, and the port's draw is held to its contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispu_tpu.nn import gcn as jgcn
from dispu_tpu_torch.convert import from_flax_variables
from dispu_tpu_torch.nn import gcn as tgcn
from dispu_tpu_torch.nn.layers import init_weights
from test_torch_pointnet import (assert_outputs, cloud, compare, compare_f64,
                                 flax_variables)

torch.set_num_threads(1)


def _set_eps(variables, value=0.3):
    """GIN's eps starts at 0, where the (1 + eps) term is invisible."""
    for i, layer in enumerate(sorted(variables["params"])):
        if "eps" in variables["params"][layer]:
            variables["params"][layer]["eps"] = np.full(
                (1,), value + 0.1 * i, np.float32)


def _record_jax(monkeypatch, fn):
    """Run ``fn`` with the JAX package's ``knn_graph`` recording its
    indices; returns (fn's result, the recordings in call order)."""
    recorded = []

    def wrapped(x, k, _orig=jgcn.knn_graph):
        idx = _orig(x, k)
        recorded.append(np.asarray(idx))
        return idx

    monkeypatch.setattr(jgcn, "knn_graph", wrapped)
    out = fn()
    monkeypatch.undo()
    return out, recorded


def _replay_port(monkeypatch, recorded):
    """The port's ``knn_graph`` returns ``recorded`` in order; the first
    call (over the input xyz) must equal the port's own graph."""
    queue = list(recorded)

    def replay(x, k, impl="auto", _orig=tgcn.knn_graph):
        idx = queue.pop(0)
        assert idx.shape == (*x.shape[:-1], k)
        if len(queue) == len(recorded) - 1:
            np.testing.assert_array_equal(_orig(x, k, impl).numpy(), idx)
        return torch.from_numpy(np.array(idx))

    monkeypatch.setattr(tgcn, "knn_graph", replay)
    return queue


# ------------------------------------------------------------------ graphs


@pytest.mark.parametrize("k,dilation", [(4, 1), (4, 2), (4, 3), (16, 3)])
def test_dilated_knn_graph_over_xyz(k, dilation):
    x = cloud(0, 2, 96, 3)
    want = jgcn.dilated_knn_graph(jnp.asarray(x), k, dilation)
    got = tgcn.dilated_knn_graph(torch.from_numpy(x), k, dilation)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tgcn.knn_graph(torch.from_numpy(x), k).numpy(),
        np.asarray(jgcn.knn_graph(jnp.asarray(x), k)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_select_dilated_takes_jax_draw(seed):
    """JAX's drawn permutation and gate, fed to the port's selection rule,
    select what JAX's ``dilated_knn_graph`` selects."""
    k, d, eps = 4, 3, 0.5
    x = cloud(1, 2, 64, 3)
    rng = jax.random.PRNGKey(seed)
    want = jgcn.dilated_knn_graph(jnp.asarray(x), k, d, stochastic=True,
                                  epsilon=eps, rng=rng)
    k_choice, k_gate = jax.random.split(rng)
    perm = np.asarray(jax.random.permutation(k_choice, k * d)[:k])
    use_random = bool(jax.random.uniform(k_gate) < eps)
    idx = tgcn.knn_graph(torch.from_numpy(x), k * d)
    got = tgcn.select_dilated(idx, k, d, torch.tensor(perm), use_random)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_draw_contract():
    """The port's draw: k distinct indices of range(k·d), and the random
    subset taken with probability epsilon."""
    gen = torch.Generator().manual_seed(0)
    k, d, eps = 16, 3, 0.3
    taken = 0
    for _ in range(400):
        perm, use_random = tgcn.draw_dilation(k, d, eps, gen)
        assert perm.shape == (k,) and perm.dtype == torch.int64
        assert len(set(perm.tolist())) == k
        assert 0 <= int(perm.min()) and int(perm.max()) < k * d
        taken += use_random
    # binomial(400, 0.3): mean 120, sd 9.2
    assert 80 <= taken <= 160
    x = torch.from_numpy(cloud(2, 2, 80, 3))
    idx = tgcn.knn_graph(x, k * d)
    perm, _ = tgcn.draw_dilation(k, d, eps,
                                 torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(
        tgcn.select_dilated(idx, k, d, perm, True).numpy(),
        idx[..., perm].numpy())
    got = tgcn.dilated_knn_graph(x, k, d, stochastic=True, epsilon=1.0,
                                 generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(got.numpy(), idx[..., perm].numpy())


# ------------------------------------------------------------ vertex layers


JCONVS = {"edge": jgcn.EdgeConvLayer, "mr": jgcn.MaxRelativeConvLayer,
          "sage": jgcn.GraphSAGEConvLayer, "gin": jgcn.GINConvLayer}


@pytest.mark.parametrize("conv", ["edge", "mr", "sage", "gin"])
@pytest.mark.parametrize("use_bn", [False, True])
def test_vertex_layer(conv, use_bn):
    x = cloud(3, 2, 48, 10)
    idx = np.asarray(jgcn.knn_graph(jnp.asarray(x), 5))
    compare(JCONVS[conv]((12, 8), use_bn=use_bn),
            tgcn.CONVS[conv](10, (12, 8), use_bn=use_bn), [x, idx],
            edit=_set_eps)


@pytest.mark.parametrize("conv", ["edge", "mr", "sage", "gin"])
def test_vertex_layer_batch_norm_training_in_f64(conv):
    """Training-mode batch norm divides by the batch's spread, which
    magnifies f32 round-off (GraphSAGE's output 1.1e-5 from flax's in
    f32): held in f64 (``compare_f64``)."""
    x = cloud(3, 2, 48, 10)
    idx = np.asarray(jgcn.knn_graph(jnp.asarray(x), 5))
    compare_f64(lambda dtype: JCONVS[conv]((12, 8), use_bn=True,
                                           dtype=dtype),
                tgcn.CONVS[conv](10, (12, 8), use_bn=True), [x, idx],
                edit=_set_eps)


# ---------------------------------------------------------------- backbone


@pytest.mark.parametrize("conv", ["edge", "mr", "sage", "gin"])
@pytest.mark.parametrize("dilation", [True, False])
def test_gcn_backbone(monkeypatch, conv, dilation):
    x = cloud(4, 2, 64, 3)
    kw = dict(depth=3, growth_rate=8, k=4, conv=conv, dilation=dilation)
    jmod = jgcn.GCNBackbone(**kw)
    variables = flax_variables(jmod, [x], edit=_set_eps)
    want, recorded = _record_jax(
        monkeypatch, lambda: jmod.apply(variables, jnp.asarray(x)))
    dils = (1, 2, 3) if dilation else (1, 1, 1)
    assert [r.shape[-1] for r in recorded] == [4 * d for d in dils]
    tmod = from_flax_variables(tgcn.GCNBackbone(3, **kw), variables).eval()
    queue = _replay_port(monkeypatch, recorded)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert not queue
    assert got.shape == (2, 64, 3 + 3 * 8)
    assert_outputs(got, want)


@pytest.mark.parametrize("epsilon", [0.5, 1.0])
def test_gcn_backbone_stochastic(monkeypatch, epsilon):
    """Training with the stochastic dilation: JAX's draws (its rng split a
    layer, as ``GCNBackbone`` splits it) fed in through ``draw_dilation``,
    JAX's graphs replayed."""
    x = cloud(5, 2, 64, 3)
    kw = dict(depth=3, growth_rate=8, k=4, conv="edge", stochastic=True,
              epsilon=epsilon)
    jmod = jgcn.GCNBackbone(**kw)
    variables = flax_variables(jmod, [x])
    rng = jax.random.PRNGKey(7)
    want, recorded = _record_jax(
        monkeypatch, lambda: jmod.apply(variables, jnp.asarray(x),
                                        train=True, rng=rng))
    draws, key = [], rng
    for d in (1, 2, 3):
        key, sub = jax.random.split(key)
        if d > 1:
            k_choice, k_gate = jax.random.split(sub)
            draws.append((torch.from_numpy(np.asarray(
                jax.random.permutation(k_choice, 4 * d)[:4])),
                bool(jax.random.uniform(k_gate) < epsilon)))
    if epsilon == 1.0:
        assert all(use for _, use in draws)
    tmod = from_flax_variables(tgcn.GCNBackbone(3, **kw), variables).train()
    _replay_port(monkeypatch, recorded)
    monkeypatch.setattr(tgcn, "draw_dilation",
                        lambda k, d, eps, gen: draws.pop(0))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.Generator())
    assert not draws
    assert_outputs(got, want)


def test_gcn_backbone_refuses_unknown_conv():
    with pytest.raises(ValueError, match="conv"):
        tgcn.GCNBackbone(conv="gat")


def test_init_weights_resets_gin_eps():
    mod = tgcn.GCNBackbone(conv="gin")
    with torch.no_grad():
        for i in range(3):
            getattr(mod, f"layer{i}").eps.fill_(0.7)
    init_weights(mod, torch.Generator().manual_seed(0))
    assert all(getattr(mod, f"layer{i}").eps.item() == 0.0
               for i in range(3))
    assert tgcn.GINConvLayer(4, (8,), init_eps=0.25).eps.item() == 0.25
