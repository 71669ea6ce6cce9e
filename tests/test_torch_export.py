"""The port's serving export (``dispu_tpu_torch/serving.py``) at each
serving setting, through the CLI, and in a loader process without the
model code, on the CPU.

Entries of the port's seeded init at ``tests/test_serving.py``'s sizes:
16×, turbo (``cli.build_config`` of ``--turbo true``) and the fused
refiner settings, each bit-equal to the live ``upsample``.  The CLI's
``--phase export`` from a port checkpoint.  A fresh process with
``dispu_tpu_torch.models`` blocked loads and calls an entry.  The JAX
comparison is ``tests/test_torch_serving.py``'s; this file imports
neither JAX nor the JAX package.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dispu_tpu_torch import cli
from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig
from dispu_tpu_torch.inference import PatchUpsampler
from dispu_tpu_torch.serving import ServedUpsampler, export_upsampler

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(num_points=64, knn=8, refine_nsample=8)
INF = dict(final_ratio=4, patch_num_point=64, patch_batch=4)
GEN = GeneratorConfig(**SMALL)


def _cloud(n, seed=0):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


def _turbo():
    cfg = cli.build_config(cli.parse_args(
        ["--phase", "export", "--turbo", "true", "--patch_num_point", "64",
         "--patch_batch", "4"]))
    return dataclasses.replace(cfg.generator, **SMALL), cfg.inference


SETTINGS = {
    "16x": (GEN, InferenceConfig(**{**INF, "final_ratio": 16}),
            ["fps", "knn"]),
    "turbo": (*_turbo(), ["fps", "fps_bucketed", "knn", "knn_group"]),
    # the merge ranked by the counting rank over 4-bit codes
    "turbo_radix": (_turbo()[0], dataclasses.replace(
        _turbo()[1], merge_fps_rank="radix"),
        ["fps", "fps_bucketed", "knn", "knn_group"]),
    "fused": (dataclasses.replace(GEN, refine_local_impl="fused"),
              InferenceConfig(**INF), ["fps", "knn", "refine_local"]),
    "megafused": (dataclasses.replace(GEN, refine_local_impl="megafused"),
                  InferenceConfig(**INF), ["fps", "knn", "refine_block"]),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_entry_of_each_setting_is_bit_equal_to_live(setting, tmp_path):
    """Bound: bit-equal; the entry's graph calls the setting's ops."""
    gen_cfg, inf_cfg, ops = SETTINGS[setting]
    manifest = export_upsampler(None, sizes=[128], path=str(tmp_path),
                                gen_cfg=gen_cfg, inf_cfg=inf_cfg,
                                device="cpu")
    assert manifest["entries"][0]["kernels"] == ops
    pc = _cloud(128, seed=5)
    got = ServedUpsampler(str(tmp_path)).upsample(pc)
    want = PatchUpsampler(gen_cfg=gen_cfg, inf_cfg=inf_cfg,
                          device="cpu").upsample(pc)
    assert got.shape == (128 * inf_cfg.final_ratio, 3)
    np.testing.assert_array_equal(got, want)




@pytest.mark.parametrize("sizes_from", ["test_data", "export_sizes"])
def test_cli_export_phase(sizes_from, tmp_path):
    """``--phase export --device cpu`` restores the newest checkpoint and
    writes an artifact whose entries (the ``--test_data`` files' sizes, or
    ``--export_sizes``) return the bits of a live upsampler restored from
    the same checkpoint."""
    from dispu_tpu_torch.evaluation.meshio import write_xyz
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.utils.checkpoint import save_checkpoint

    log_dir, out = str(tmp_path / "log"), str(tmp_path / "artifact")
    argv = ["--phase", "export", "--device", "cpu", "--log_dir", log_dir,
            "--patch_num_point", "64", "--patch_batch", "4", "--test_data",
            str(tmp_path / "in" / "*.xyz"), "--out_folder", out]
    if sizes_from == "export_sizes":
        argv += ["--export_sizes", "150", "96"]
    cfg = cli.build_config(cli.parse_args(argv))
    state = create_generator_state(cfg.generator, seed=7, device="cpu")
    save_checkpoint(log_dir, state, 1)
    state = create_generator_state(cfg.generator, seed=8, device="cpu")
    save_checkpoint(log_dir, state, 2)  # the newest
    (tmp_path / "in").mkdir()
    write_xyz(str(tmp_path / "in" / "a.xyz"), _cloud(160))
    cli.main(argv)

    served = ServedUpsampler(out)
    sizes = [160] if sizes_from == "test_data" else [96, 150]
    assert served.sizes == sizes
    up = PatchUpsampler(gen_cfg=cfg.generator, inf_cfg=cfg.inference,
                        device="cpu")
    up.model.load_state_dict(state.model.state_dict())
    pc = _cloud(sizes[-1], seed=9)
    np.testing.assert_array_equal(served.upsample(pc), up.upsample(pc))


def test_cli_export_without_sizes_exits(tmp_path):
    with pytest.raises(SystemExit, match="no input sizes"):
        cli.main(["--phase", "export", "--device", "cpu", "--log_dir",
                  str(tmp_path), "--test_data", str(tmp_path / "*.xyz")])


def test_loader_imports_no_model_code(tmp_path):
    """A fresh process with ``dispu_tpu_torch.models`` (and ``nn``,
    ``inference``, ``convert``) blocked loads an entry and returns the
    parent's live bits; no module of ``jax``, ``flax`` or ``dispu_tpu`` is
    loaded there."""
    path = str(tmp_path / "artifact")
    inf_cfg = InferenceConfig(**INF)
    export_upsampler(None, [128], path, gen_cfg=GEN, inf_cfg=inf_cfg,
                     device="cpu")
    live = PatchUpsampler(gen_cfg=GEN, inf_cfg=inf_cfg, device="cpu")
    pc = _cloud(128, seed=4)
    np.save(tmp_path / "pc.npy", pc)
    blocked = ["dispu_tpu_torch.models", "dispu_tpu_torch.nn",
               "dispu_tpu_torch.inference", "dispu_tpu_torch.convert"]
    code = f"""
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np
from dispu_tpu_torch.serving import ServedUpsampler
out = ServedUpsampler({path!r}).upsample(np.load({str(tmp_path / 'pc.npy')!r}))
np.save({str(tmp_path / 'out.npy')!r}, out)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dispu_tpu'))
try:
    import dispu_tpu_torch.models
    bad.append('dispu_tpu_torch.models importable')
except ImportError:
    pass
print(bad)
sys.exit(1 if bad else 0)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  live.upsample(pc))
