"""The port stands alone: no JAX, no flax, nothing of dispu_tpu, and no
quiet fall back to the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from dispu_tpu_torch import GeneratorConfig, PatchUpsampler
from dispu_tpu_torch.inference import resolve_device

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "dispu_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dispu_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif (isinstance(node, ast.ImportFrom) and node.module
              and not node.level):
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py",
     REPO / "refine_sweep.py"]), ids=str)
def test_no_jax_flax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, dispu_tpu_torch, dispu_tpu_torch.inference, "
            "dispu_tpu_torch.kernels.knn, dispu_tpu_torch.kernels.fps, "
            "dispu_tpu_torch.kernels.fps_chunked, "
            "dispu_tpu_torch.kernels.attention, dispu_tpu_torch.time_fps, "
            "dispu_tpu_torch.serving, "
            "dispu_tpu_torch.kernels.query_ball, dispu_tpu_torch.losses, "
            "dispu_tpu_torch.train.trainer, dispu_tpu_torch.ops.chamfer, "
            "dispu_tpu_torch.kernels.knn_group, dispu_tpu_torch.cli, "
            "dispu_tpu_torch.kernels.fps_bucketed, "
            "dispu_tpu_torch.evaluation.meshio, "
            "dispu_tpu_torch.evaluation.metrics, "
            "dispu_tpu_torch.evaluation.report, "
            "dispu_tpu_torch.evaluate, dispu_tpu_torch.data.meshgen, "
            "dispu_tpu_torch.kernels.gather_rows, "
            "dispu_tpu_torch.models.discriminator, "
            "dispu_tpu_torch.train.gan_steps, "
            "dispu_tpu_torch.train.gan_trainer, "
            "dispu_tpu_torch.utils.visu, dispu_tpu_torch.parallel.mesh, "
            "dispu_tpu_torch.parallel.sharded_eval, "
            "dispu_tpu_torch.parallel.dryrun, dispu_tpu_torch.native, "
            "dispu_tpu_torch.utils.convert_tf_checkpoint, "
            "dispu_tpu_torch.utils.eulerangles, "
            "dispu_tpu_torch.utils.logging, dispu_tpu_torch.ops.emd, "
            "dispu_tpu_torch.ops.interpolate, dispu_tpu_torch.ops.patches, "
            "dispu_tpu_torch.ops.grouping, dispu_tpu_torch.nn.experimental; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device path is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PatchUpsampler(gen_cfg=GeneratorConfig(num_points=64, knn=8,
                                               refine_nsample=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails and prints no result (on any machine)."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
