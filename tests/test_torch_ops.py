"""The serving path's kernels as ``torch.library`` custom ops, and the
refiner's submodule rename, on the CPU.

Each of the nine ops passes ``torch.library.opcheck`` (its schema, its
fake form against its CPU form, and tracing through AOT dispatch with
dynamic shapes) on small inputs; on the CPU each op's result is bit-equal
to its plain version, which is what the op runs there.  A state dict or
checkpoint written under the refiner's old submodule name ``nonlocal``
restores bit-equal.  ``tests/test_torch_cuda.py`` runs the same op cases
on the card.  This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from dispu_tpu_torch import kernels
from dispu_tpu_torch.kernels.attention import attention_torch
from dispu_tpu_torch.kernels.fps import fps_torch
from dispu_tpu_torch.kernels.knn import (duplicate_rows_torch,
                                         knn_packed_torch, knn_torch)
from dispu_tpu_torch.kernels.knn_group import knn_group_torch
from dispu_tpu_torch.kernels.refine_block import refine_block_torch
from dispu_tpu_torch.kernels.refine_local import (LocalParams,
                                                  refine_local_torch)

torch.set_num_threads(1)

kernels.register_ops()


def _randn(seed, *shape):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _params(k, cf, c1=16, c2=8, c_out=16, seed=10):
    """LocalParams of k neighbours and cf-wide grouped rows."""
    shapes = [(cf, c1), (c1,), (c1, c2), (c2,), (3, k), (k,), (cf, c_out),
              (c_out,), (k, c2, c_out), (c_out,)]
    return [0.3 * _randn(seed + i, *s) for i, s in enumerate(shapes)]


def op_cases():
    """(id, op name, args) of each op on small inputs; ``refine_local`` at
    n = 128, a multiple of its tile."""
    pts, qs = _randn(0, 2, 40, 3), _randn(1, 2, 24, 3)
    bias = torch.where(_randn(2, 2, 40) > 1.0, 1e30, 0.0)
    feats = _randn(3, 2, 40, 5)
    return [
        ("knn", "knn", (6, pts, qs, None)),
        ("knn-bias", "knn", (6, pts, qs, bias)),
        ("knn_packed", "knn_packed", (6, pts, qs, None)),
        ("knn_packed-bias", "knn_packed", (6, pts, qs, bias)),
        ("knn_group-xyz", "knn_group",
         (5, pts, qs, feats, None, True, True, False)),
        ("knn_group-backbone", "knn_group",
         (5, pts, pts, feats, bias, True, False, True)),
        ("knn_group-turbo", "knn_group",
         (5, pts, qs, feats, None, False, True, False)),
        ("fps", "fps", (9, pts)),
        ("fps_chunked", "fps_chunked", (9, pts)),
        ("fps_bucketed", "fps_bucketed", (3, _randn(4, 6, 10, 3))),
        ("attention", "attention",
         (_randn(5, 2, 24, 8), _randn(6, 2, 40, 8), _randn(7, 2, 40, 12),
          8 ** -0.5)),
        ("refine_local", "refine_local",
         (_randn(8, 1, 128, 4, 9), _params(4, 9))),
        ("refine_block", "refine_block",
         (_randn(9, 1, 40, 3), _randn(11, 1, 40, 3), _params(4, 9))),
        ("duplicate_rows", "duplicate_rows",
         (torch.cat([pts, pts[:, :7]], dim=1),)),
    ]


CASES = op_cases()


def _plain(name, args):
    """What each op computes, by its plain version."""
    if name == "knn":
        return knn_torch(*args)
    if name == "knn_packed":
        return knn_packed_torch(*args)
    if name == "knn_group":
        d, idx, gxyz, gfeat = knn_group_torch(*args)
        return d, idx, torch.empty(0) if gxyz is None else gxyz, gfeat
    if name in ("fps", "fps_chunked", "fps_bucketed"):
        return fps_torch(*args)
    if name == "duplicate_rows":
        return duplicate_rows_torch(*args)
    if name == "attention":
        return attention_torch(*args, bf16_operands=True)
    if name == "refine_local":
        return refine_local_torch(args[0], LocalParams(*args[1]))
    return refine_block_torch(args[0], args[1], LocalParams(*args[2]))


def test_every_served_kernel_is_an_op():
    """The nine kernels, and the duplicate mask (plain torch on every
    device, an op so that an exported graph holds it as one node)."""
    assert sorted([*kernels.OPS, "duplicate_rows"]) == sorted(
        {name for _, name, _ in CASES})
    for name in [*kernels.OPS, "duplicate_rows"]:
        op = getattr(torch.ops.dispu_tpu_torch, name).default
        assert op._schema.name == f"dispu_tpu_torch::{name}"


@pytest.mark.parametrize("name,args", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_op_passes_opcheck(name, args):
    """Schema, fake form against the CPU form, and AOT dispatch (static
    and dynamic shapes): every check ``opcheck`` runs must succeed."""
    op = getattr(torch.ops.dispu_tpu_torch, name).default
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name,args", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_op_on_the_cpu_is_its_plain_version(name, args):
    """Bound: bit-equal, outputs and fake shapes alike."""
    op = getattr(torch.ops.dispu_tpu_torch, name).default
    got, want = op(*args), _plain(name, args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else [mode.from_tensor(t) for t in a]
                    if isinstance(a, list) else a for a in args])
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype) for f in fake] == \
        [(w.shape, w.dtype) for w in want]


def test_impl_cuda_on_a_cpu_tensor_raises_and_auto_takes_the_op():
    from dispu_tpu_torch.kernels.fps import fps
    from dispu_tpu_torch.kernels.knn import knn

    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        knn(4, _randn(0, 1, 16, 3), _randn(1, 1, 4, 3), impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        fps(4, _randn(0, 1, 16, 3), impl="cuda")
    # a CPU tensor takes the op (its CPU form is the plain version) where
    # the plain version is asked for, the kernel's wrapper where a kernel
    # is (which raises there, unless a test stands in for it)
    cpu, fns = torch.zeros(1), ("op", "kernel", "plain")
    assert kernels.forward_of(False, cpu, *fns) == "op"
    assert kernels.forward_of(True, cpu, *fns) == "kernel"


# ------------------------------------------- the refiner's renamed module


SMALL = dict(num_points=64, knn=8, refine_nsample=8)


def _old(key: str) -> str:
    return key.replace(".non_local.", ".nonlocal.")


def test_state_dict_under_the_old_nonlocal_key_restores_bit_equal(tmp_path):
    """A generator checkpoint whose refiner attention sits under
    ``nonlocal`` (its name before it became ``non_local``) restores every
    parameter, buffer and Adam moment bit for bit, through
    ``restore_checkpoint`` and through ``model.load_state_dict`` as the
    CLI restores weights."""
    from dispu_tpu_torch.config import GeneratorConfig
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                  restore_checkpoint)

    cfg = GeneratorConfig(**SMALL)
    saved = create_generator_state(cfg, seed=3, device="cpu")
    for moments in (saved.mu, saved.nu):
        for name, value in moments.items():
            value.copy_(_randn(len(name), *value.shape))
    want = saved.state_dict()
    assert any(".non_local." in k for k in want["model"])
    old = {**want, **{part: {_old(k): v for k, v in want[part].items()}
                      for part in ("model", "mu", "nu")}}
    assert any(".nonlocal." in k for k in old["model"])
    torch.save(old, tmp_path / "model-4.pt")

    state = create_generator_state(cfg, seed=9, device="cpu")
    restore_checkpoint(latest_checkpoint(str(tmp_path))[1], state)
    got = state.state_dict()
    for part in ("model", "mu", "nu"):
        assert sorted(got[part]) == sorted(want[part])
        for key, value in want[part].items():
            assert torch.equal(got[part][key], value), (part, key)

    model = create_generator_state(cfg, seed=11, device="cpu").model
    model.load_state_dict(old["model"])
    for key, value in model.state_dict().items():
        assert torch.equal(value, want["model"][key]), key
